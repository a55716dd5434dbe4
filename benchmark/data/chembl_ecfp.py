"""ChEMBL-IC50-shaped activities with ECFP-like compound features, made on
the device from a seed.

The distribution of the port's host generator ``synthetic_chembl``: each
compound holds Poisson(``feat_per_compound``) binary features drawn
uniformly from ``n_features`` (each at most once); the compounds' latent
rows are ``feat_frac`` of their variance from the features (X beta,
beta ~ N(0, 1), each column scaled to unit deviation) and the rest noise;
compound popularity falls as a power law of its rank (``popularity_exp``),
targets are drawn uniformly, each (compound, target) cell at most once;
the values are log10(IC50 nM) = offset + gain (u . v) / sqrt(rank) +
obs_noise N(0, 1).  The bytes differ from the host generator's; the shapes
and distributions are the same.
"""
from __future__ import annotations

import math

import torch


def generate(p: dict, g: torch.Generator, device):
    """(idx [nnz, 2] int64, vals [nnz] float64, shape, features) from the
    configuration's ``data`` parameters ``p`` and the generator ``g``;
    ``features`` is (rows, cols) int64 of the binary compound features,
    sorted by (row, col)."""
    n, n_t, n_f = int(p["n_compounds"]), int(p["n_targets"]), \
        int(p["n_features"])
    nnz, rank = int(p["nnz"]), int(p["rank"])
    f64 = torch.float64
    per = torch.poisson(torch.full((n,), float(p["feat_per_compound"]),
                                   dtype=f64, device=device), generator=g)
    fr = torch.repeat_interleave(torch.arange(n, device=device),
                                 per.to(torch.int64))
    fc = torch.randint(0, n_f, (fr.numel(),), generator=g, device=device)
    fkey = torch.unique(fr * n_f + fc)
    fr, fc = fkey // n_f, fkey % n_f
    del fkey
    beta = torch.randn((n_f, rank), generator=g, dtype=f64, device=device)
    # X beta row by row, a fixed-order segment sum: the same bits every run
    Uf = torch.segment_reduce(beta[fc], "sum",
                              lengths=torch.bincount(fr, minlength=n),
                              unsafe=True)
    del beta
    Uf = Uf / (Uf.std(dim=0, unbiased=False, keepdim=True) + 1e-12)
    frac = float(p["feat_frac"])
    Uc = math.sqrt(frac) * Uf + math.sqrt(1.0 - frac) * torch.randn(
        (n, rank), generator=g, dtype=f64, device=device)
    Ut = torch.randn((n_t, rank), generator=g, dtype=f64, device=device)
    comp_p = 1.0 / torch.arange(1, n + 1, dtype=f64,
                                device=device) ** float(p["popularity_exp"])
    comp_cdf = torch.cumsum(comp_p / comp_p.sum(), 0)

    def draw(m):            # m (compound, target) keys, deduplicated
        c = torch.searchsorted(comp_cdf, torch.rand(
            m, generator=g, dtype=f64, device=device)).clamp_(max=n - 1)
        t = torch.randint(0, n_t, (m,), generator=g, device=device)
        return torch.unique(c * n_t + t)

    key = draw(int(nnz * float(p["oversample"])))
    while key.numel() < nnz:        # rare: the dedup fell short
        key = torch.unique(torch.cat([key, draw(nnz)]))
    key = key[torch.randperm(key.numel(), generator=g,
                             device=device)[:nnz]]
    c, t = key // n_t, key % n_t
    del key
    score = (Uc[c] * Ut[t]).sum(1) / math.sqrt(rank)
    vals = (float(p["offset"]) + float(p["gain"]) * score
            + float(p["obs_noise"]) * torch.randn(nnz, generator=g,
                                                  dtype=f64, device=device))
    return torch.stack([c, t], 1), vals, (n, n_t), (fr, fc)
