"""Batched Cholesky factorize-and-sample on a full P (port of ``ops/mvn.py``
``chol_sample``, ``chol_sample_dispatch`` and ``chol_solve``).
``chol_sample`` is plain torch: the reference the blocked sampler
(ops/chol_blocked.py) is checked against, and the sampler above K = 128."""
from __future__ import annotations

from typing import Optional

import torch
from torch.linalg import solve_triangular

from .chol_blocked import chol_sample_blocked
from .chol_full import (K3_MAX_K, K4_MAX_K, chol_sample_full,
                        chol_sample_full_tiled)

# the widest K the blocked kernel path takes (the JAX package's Pallas
# samplers stop there too: ``use_pallas_chol``)
BLOCKED_MAX_K = 128


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


def chol_solve(P: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """P^-1 b by Cholesky, batched; b [..., K] or [..., K, M] (JAX
    ``mvn.chol_solve`` :93).  No host read of the factorization's flag: a
    P that is not positive definite gives NaN, as in the JAX package."""
    L, _ = torch.linalg.cholesky_ex(P)
    vec = b.ndim == P.ndim - 1
    bb = b[..., None] if vec else b
    y = solve_triangular(L, bb, upper=False)
    x = solve_triangular(L.mT, y, upper=True)
    return x[..., 0] if vec else x


def chol_sample_dispatch(P: torch.Tensor, b: torch.Tensor, xi: torch.Tensor,
                         Lambda: Optional[torch.Tensor] = None,
                         jitter: float = 0.0) -> torch.Tensor:
    """The full-P sampler across K (JAX ``mvn.chol_sample_dispatch`` :64),
    for P [B, K, K] and b/xi [B, K], with P' = P + Lambda (+ jitter I) when
    Lambda is given, else P (+ jitter I):

    - K <= 32: ``chol_sample_full`` (the K3 kernel on CUDA), Lambda added
      in registers;
    - 32 < K <= 96: ``chol_sample_full_tiled`` (K4), Lambda added on load;
    - 96 < K <= 128: ``chol_sample_blocked`` (the K5 kernel on CUDA);
    - K > 128: ``chol_sample`` on torch.linalg, as the JAX package leaves
      that range to XLA.

    Above K = 96, Lambda is added to P IN PLACE: the caller hands over a
    fresh P, and this saves a [B, K, K] copy (4.7 GB at K = 128 and
    B = 71,567)."""
    K = P.shape[-1]
    if K <= K3_MAX_K:
        return chol_sample_full(P, b, xi, Lambda, jitter)
    if K <= K4_MAX_K:
        return chol_sample_full_tiled(P, b, xi, Lambda, jitter)
    if Lambda is not None:
        P += Lambda
    if K <= BLOCKED_MAX_K:
        return chol_sample_blocked(P, b, xi, jitter)
    return chol_sample(P, b, xi, jitter)
