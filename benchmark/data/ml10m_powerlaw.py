"""MovieLens-shaped ratings made on the device from a seed.

The distribution of the port's host generator ``synthetic_ratings``: movie
popularity falling as a power law of the movie's rank, lognormal user
activity, every (user, movie) cell at most once, and half-star values on
1..5 from a rank-``rank`` model with Gaussian noise.  The bytes differ from
the host generator's; the shapes and distributions are the same.
"""
from __future__ import annotations

import math

import torch

# observations whose model values are summed at once (bounds the gathers)
CHUNK = 4_000_000


def generate(p: dict, g: torch.Generator, device):
    """(idx [nnz, 2] int64, vals [nnz] float64, shape) from the
    configuration's ``data`` parameters ``p`` and the generator ``g``."""
    n_u, n_m, nnz = int(p["n_users"]), int(p["n_movies"]), int(p["nnz"])
    rank = int(p["rank"])
    f64 = torch.float64
    movie_p = 1.0 / torch.arange(1, n_m + 1, dtype=f64,
                                 device=device) ** float(p["popularity_exp"])
    user_p = torch.exp(float(p["activity_sigma"]) * torch.randn(
        n_u, generator=g, dtype=f64, device=device))
    movie_cdf = torch.cumsum(movie_p / movie_p.sum(), 0)
    user_cdf = torch.cumsum(user_p / user_p.sum(), 0)

    def draw(n):            # inverse-CDF sampling of n (user, movie) keys
        u = torch.searchsorted(user_cdf, torch.rand(
            n, generator=g, dtype=f64, device=device)).clamp_(max=n_u - 1)
        m = torch.searchsorted(movie_cdf, torch.rand(
            n, generator=g, dtype=f64, device=device)).clamp_(max=n_m - 1)
        return torch.unique(u * n_m + m)

    key = draw(int(nnz * float(p["oversample"])) + 1024)
    while key.numel() < nnz:        # rare: the dedup fell short
        key = torch.unique(torch.cat([key, draw(nnz)]))
    key = key[torch.randperm(key.numel(), generator=g,
                             device=device)[:nnz]]
    u, m = key // n_m, key % n_m
    del key
    U = torch.randn((n_u, rank), generator=g, device=device) / math.sqrt(rank)
    V = torch.randn((n_m, rank), generator=g, device=device) / math.sqrt(rank)
    score = torch.empty(nnz, dtype=f64, device=device)
    for a in range(0, nnz, CHUNK):
        b = min(nnz, a + CHUNK)
        score[a:b] = (U[u[a:b]] * V[m[a:b]]).sum(1).to(f64)
    del U, V
    noise = torch.randn(nnz, generator=g, dtype=f64, device=device)
    vals = (float(p["offset"]) + float(p["gain"]) * score
            + float(p["noise"]) * noise)
    step = float(p["step"])
    vals = torch.clamp(torch.round(vals / step) * step, float(p["lo"]),
                       float(p["hi"]))
    return torch.stack([u, m], 1), vals, (n_u, n_m)
