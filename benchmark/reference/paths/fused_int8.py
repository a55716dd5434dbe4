"""The fused s8 store (the program's K7 table and K8a): the int8 pair's
quantized partner table and ridge, with the cell values exact.  The
control takes an int4 (+-7) table."""
from __future__ import annotations

import torch

from benchmark.reference import common


def gramian(data, f: int, V: torch.Tensor, alpha: float, quant: str):
    """Focus mode ``f``'s alpha-scaled precision (packed [n_f, C]) and
    right-hand side [n_f, K] against the partner rows V (float32)."""
    K = V.shape[1]
    C = K * (K + 1) // 2
    codes, s = common.quantized_table(V, 7 if quant == "control" else 127)
    P = torch.sparse.mm(data.csr(f, None), codes[:, :C].contiguous()) * (
        alpha * s[:C])
    b = torch.sparse.mm(data.csr(f, data.centered),
                        codes[:, C:].contiguous()) * (alpha * s[C:])
    return common.add_ridge(P, data, f, s[:C], alpha, K), b
