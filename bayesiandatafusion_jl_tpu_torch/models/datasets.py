"""MovieLens-shaped synthetic ratings (numpy only).

Port of the synthetic branch of ``bayesiandatafusion_jl_tpu/models/
datasets.py``: the same generator, so the same seed gives the same data
(ML-10M shape: 71,567 users x 10,681 movies, 10,000,054 ratings).
"""
from __future__ import annotations

import numpy as np

from .data import IndexedDF

ML_SHAPES = {
    "100k": (943, 1682, 100_000),
    "1m": (6040, 3706, 1_000_209),
    "10m": (71567, 10681, 10_000_054),
}


def load_movielens(variant: str = "100k", seed: int = 0) -> IndexedDF:
    """Synthetic MovieLens-shaped ratings (no real-file loader yet)."""
    n_users, n_movies, nnz = ML_SHAPES[variant]
    return synthetic_ratings(n_users, n_movies, nnz, seed=seed)


def synthetic_ratings(n_users: int, n_movies: int, nnz: int,
                      rank: int = 32, noise: float = 0.6,
                      seed: int = 0) -> IndexedDF:
    """Rank-``rank`` ratings on the half-star grid 1..5 with power-law movie
    popularity and lognormal user activity; every (user, movie) cell at most
    once."""
    rng = np.random.default_rng(seed)
    movie_p = (1.0 / np.arange(1, n_movies + 1) ** 0.8)
    movie_p /= movie_p.sum()
    user_p = rng.lognormal(0.0, 1.0, n_users)
    user_p /= user_p.sum()
    movie_cdf = np.cumsum(movie_p)
    user_cdf = np.cumsum(user_p)

    def draw(n):  # inverse-CDF sampling
        u = np.searchsorted(user_cdf, rng.random(n)).astype(np.int64)
        m = np.searchsorted(movie_cdf, rng.random(n)).astype(np.int64)
        return np.unique(u * n_movies + m)

    target = nnz
    key = draw(int(target * 1.6) + 1024)
    while len(key) < target:  # rare: heavy-skew dedup fell short
        key = np.unique(np.concatenate([key, draw(target)]))
    sel = rng.permutation(len(key))[:target]
    u, m = key[sel] // n_movies, key[sel] % n_movies
    U = rng.standard_normal((n_users, rank)) / np.sqrt(rank)
    V = rng.standard_normal((n_movies, rank)) / np.sqrt(rank)
    vals = 3.5 + 1.1 * np.sum(U[u] * V[m], axis=1) \
        + noise * rng.standard_normal(target)
    vals = np.clip(np.round(vals * 2) / 2, 1.0, 5.0)
    idx = np.stack([u, m], axis=1)
    return IndexedDF(idx, vals, (n_users, n_movies))
