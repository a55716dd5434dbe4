"""MovieLens-shaped synthetic ratings (numpy only).

Port of the synthetic branch of ``bayesiandatafusion_jl_tpu/models/
datasets.py``: the same generator, so the same seed gives the same data
(ML-10M shape: 71,567 users x 10,681 movies, 10,000,054 ratings).
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

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


def _sorted_unique(a: np.ndarray) -> np.ndarray:
    """``np.unique(a)`` for a large integer array, by one sort and a
    neighbour compare: the same array, without ``np.unique``'s own path,
    which under numpy 2.3 has run two orders of magnitude slower than a
    sort on 10^8 int64 keys."""
    a = np.sort(a)
    if a.size:
        a = a[np.concatenate(([True], a[1:] != a[:-1]))]
    return a


def netflix_synthetic(n_users: int = 480_189, n_movies: int = 17_770,
                      nnz: int = 100_480_507, rank: int = 32, seed: int = 9,
                      chunk: int = 1_000_000) -> IndexedDF:
    """Netflix-prize-shaped synthetic ratings: integer stars 1..5 from a
    rank-``rank`` model, every (user, movie) cell at most once, ``nnz``
    cells drawn uniformly.

    The JAX bench's generator (``bench.py:353-370``, the ``netflix``
    family): the same calls in the same order, so the same seed gives the
    same bytes (``_sorted_unique`` stands for ``np.unique``, with the same
    result).  The factor products U[i1] . V[i2] are summed ``chunk``
    observations at a time, on up to 8 threads (numpy releases the GIL in
    the gathers and the sums), each row the same products and sum as in
    one pass, so the host never holds the two [nnz, rank] gathers whole
    (2 x 12.9 GB in float32 at full size); ``chunk=None`` takes one pass.
    """
    n1, n2, r = n_users, n_movies, rank
    rng = np.random.default_rng(seed)
    key = _sorted_unique(rng.integers(0, n1 * n2, int(nnz * 1.02),
                                      dtype=np.int64))
    key = rng.permutation(key)[:nnz] if key.size > nnz else key
    nnz = key.size
    i1 = (key // n2).astype(np.int32)
    i2 = (key % n2).astype(np.int32)
    del key
    U = rng.standard_normal((n1, r), dtype=np.float32) / np.sqrt(r)
    V = rng.standard_normal((n2, r), dtype=np.float32) / np.sqrt(r)
    step = nnz if chunk is None else max(1, int(chunk))

    def part(a):
        return np.einsum("nk,nk->n", U[i1[a:a + step]], V[i2[a:a + step]])
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        score = np.concatenate(list(pool.map(part, range(0, nnz, step))))
    del U, V
    score = score * np.sqrt(r) * 0.9 + 0.55 * rng.standard_normal(
        nnz, dtype=np.float32)
    vals = np.clip(np.rint(3.6 + 1.1 * score), 1.0, 5.0).astype(np.float32)
    del score
    return IndexedDF(np.stack([i1, i2], 1), vals, (n1, n2))
