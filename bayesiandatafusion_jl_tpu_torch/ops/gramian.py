"""Test-tuple prediction (port of ``ops/gramian.py`` ``predict_tuples``)."""
from __future__ import annotations

from typing import Sequence

import torch


def predict_tuples(factors: Sequence[torch.Tensor], idx: torch.Tensor,
                   mean_value: float) -> torch.Tensor:
    """pred = mean_r + sum_k prod_d U_d[i_d, k] for idx [n, D]."""
    prod = factors[0][idx[:, 0]]
    for d in range(1, len(factors)):
        prod = prod * factors[d][idx[:, d]]
    return mean_value + prod.sum(dim=1)
