"""Roundings and tables that the reference's Gramian paths share: each
works out again, from the raw ratings and the partner rows, a precision
that a configuration states.  Plain PyTorch; nothing of the program."""
from __future__ import annotations

import math

import torch

F64 = torch.float64
INV127 = torch.tensor(1.0 / 127.0, dtype=torch.float32).item()
TINY = torch.finfo(torch.float32).tiny


def tri_pairs(K: int, device):
    """The packed upper triangle's (row, col) pairs, row-major."""
    iu, ju = torch.triu_indices(K, K, device=device)
    return iu, ju


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 mantissa bits (to nearest, ties
    away from zero, as the tensor cores convert), returned as float32."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    b = (b + 0x1000) & ~0x1FFF
    return b.view(torch.float32)


def quantized_table(V: torch.Tensor, levels: int):
    """[u_i u_j | u] of the float32 rows V, quantized per column to
    +-``levels``: (codes [n, C + K] float64, scales [C + K] float64).
    Products, scales and the quotients are float32 operations; codes round
    half to even."""
    K = V.shape[1]
    iu, ju = tri_pairs(K, V.device)
    V32 = V.to(torch.float32)
    T = torch.cat([V32[:, iu] * V32[:, ju], V32], 1)
    inv = (INV127 if levels == 127
           else torch.tensor(1.0 / levels, dtype=torch.float32).item())
    s = torch.clamp_min(T.abs().amax(dim=0) * inv, TINY)
    codes = torch.clamp(torch.round(T / s), -levels, levels)
    return codes.to(F64), s.to(F64)


def value_codes(data, levels: int):
    """The centered cell values (as the program stores them, float32) as
    codes on one static scale max|w| / ``levels``: (codes float64 in the
    observations' order, scale).  Kept on ``data`` once worked out."""
    key = ("codes", levels)
    if key not in data.cache:
        c32 = data.centered.to(torch.float32)
        s = torch.tensor((float(c32.abs().max()) / float(levels)) or 1.0,
                         dtype=torch.float32)
        codes = torch.clamp(torch.round(c32 / s.to(c32.device)), -levels,
                            levels)
        data.cache[key] = (codes.to(F64), float(s))
    return data.cache[key]


def value_rounded(data, dtype: torch.dtype) -> torch.Tensor:
    """The centered cell values rounded to ``dtype`` (through float32, as
    the program stores them), in float64.  Kept on ``data``."""
    key = ("rounded", dtype)
    if key not in data.cache:
        data.cache[key] = data.centered.to(torch.float32).to(dtype).to(F64)
    return data.cache[key]


def add_ridge(P: torch.Tensor, data, f: int, s: torch.Tensor, alpha: float,
              K: int) -> torch.Tensor:
    """The int8 paths' PD ridge on the packed diagonal: alpha *
    mean(scale of the product columns) * sqrt(K) / 2 * sqrt(degree)."""
    iu, ju = tri_pairs(K, P.device)
    diag = torch.nonzero(iu == ju)[:, 0]
    step = alpha * float(s.mean()) * math.sqrt(K) / 2.0
    P[:, diag] += (torch.sqrt(data.modes[f]["deg"]) * step)[:, None]
    return P
