"""The int8 pair (the program's K7 table and K6): each focus row's
Gramian and right-hand side are exact sums over its observations of the
partner table [u_i u_j | u] quantized per column to int8 codes (scale
max|col| / 127), with the cell values as int8 codes on one static scale
max|w| / 127, and the PD ridge on the diagonal.  The control takes int4
(+-7) for both."""
from __future__ import annotations

import torch

from benchmark.reference import common


def gramian(data, f: int, V: torch.Tensor, alpha: float, quant: str):
    """Focus mode ``f``'s alpha-scaled precision (packed [n_f, C]) and
    right-hand side [n_f, K] against the partner rows V (float32)."""
    K = V.shape[1]
    C = K * (K + 1) // 2
    levels = 7 if quant == "control" else 127
    codes, s = common.quantized_table(V, levels)
    P = torch.sparse.mm(data.csr(f, None), codes[:, :C].contiguous()) * (
        alpha * s[:C])
    w, ws = common.value_codes(data, levels)
    b = torch.sparse.mm(data.csr(f, w), codes[:, C:].contiguous()) * (
        alpha * ws * s[C:])
    return common.add_ridge(P, data, f, s[:C], alpha, K), b
