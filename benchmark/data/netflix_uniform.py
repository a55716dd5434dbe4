"""Netflix-Prize-shaped ratings made on the device from a seed.

The distribution of the port's host generator ``netflix_synthetic`` (the
JAX bench's ``netflix`` family): cells drawn uniformly, every cell at most
once, integer stars 1..5 from a rank-``rank`` model with Gaussian noise.
The bytes differ from the host generator's; the shapes and distributions
are the same.
"""
from __future__ import annotations

import math

import torch

# observations whose model values are summed at once (bounds the gathers)
CHUNK = 8_000_000


def generate(p: dict, g: torch.Generator, device):
    """(idx [nnz, 2] int64, vals [nnz] float64, shape) from the
    configuration's ``data`` parameters ``p`` and the generator ``g``."""
    n1, n2, nnz = int(p["n_users"]), int(p["n_movies"]), int(p["nnz"])
    r = int(p["rank"])
    key = torch.unique(torch.randint(0, n1 * n2,
                                     (int(nnz * float(p["oversample"])),),
                                     generator=g, dtype=torch.int64,
                                     device=device))
    if key.numel() > nnz:
        key = key[torch.randperm(key.numel(), generator=g,
                                 device=device)[:nnz]]
    nnz = key.numel()
    i1, i2 = key // n2, key % n2
    del key
    U = torch.randn((n1, r), generator=g, device=device) / math.sqrt(r)
    V = torch.randn((n2, r), generator=g, device=device) / math.sqrt(r)
    score = torch.empty(nnz, dtype=torch.float32, device=device)
    for a in range(0, nnz, CHUNK):
        b = min(nnz, a + CHUNK)
        score[a:b] = (U[i1[a:b]] * V[i2[a:b]]).sum(1)
    del U, V
    score = score * (math.sqrt(r) * float(p["gain_score"])) + float(
        p["noise"]) * torch.randn(nnz, generator=g, device=device)
    vals = torch.clamp(torch.round(float(p["offset"])
                                   + float(p["gain"]) * score),
                       float(p["lo"]), float(p["hi"]))
    return torch.stack([i1, i2], 1), vals.to(torch.float64), (n1, n2)
