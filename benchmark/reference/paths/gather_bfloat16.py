"""The gather path with bfloat16 operands (the program's gather, bmm and
segment sums): the partner rows and the centered values rounded to
bfloat16, their products and sums exact.  The control takes float8
e4m3."""
from __future__ import annotations

import torch

from benchmark.reference import common


def gramian(data, f: int, V: torch.Tensor, alpha: float, quant: str):
    """Focus mode ``f``'s alpha-scaled precision (packed [n_f, C]) and
    right-hand side [n_f, K] against the partner rows V (float32)."""
    low = torch.float8_e4m3fn if quant == "control" else torch.bfloat16
    Vq = V.to(torch.float32).to(low).to(common.F64)
    iu, ju = common.tri_pairs(V.shape[1], V.device)
    P = torch.sparse.mm(data.csr(f, None), Vq[:, iu] * Vq[:, ju]) * alpha
    b = torch.sparse.mm(data.csr(f, common.value_rounded(data, low)),
                        Vq) * alpha
    return P, b
