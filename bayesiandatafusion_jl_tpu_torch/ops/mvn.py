"""Batched Cholesky factorize-and-sample, plain torch (port of
``ops/mvn.py`` ``chol_sample``): the reference the packed sampler
(ops/chol_packed.py) is checked against."""
from __future__ import annotations

import torch
from torch.linalg import solve_triangular


def chol_sample(P: torch.Tensor, b: torch.Tensor, xi: torch.Tensor,
                jitter: float = 0.0) -> torch.Tensor:
    """u ~ N(P^-1 b, P^-1) batched over leading dims; P [..., K, K],
    b/xi [..., K]."""
    K = P.shape[-1]
    if jitter:
        P = P + jitter * torch.eye(K, dtype=P.dtype, device=P.device)
    L = torch.linalg.cholesky(P)
    y = solve_triangular(L, b[..., None], upper=False)
    mu = solve_triangular(L.mT, y, upper=True)
    u = solve_triangular(L.mT, xi[..., None], upper=True)
    return (mu + u)[..., 0]
