"""Batched Cholesky factorize-and-sample on a full P (port of ``ops/mvn.py``
``chol_sample`` and ``chol_sample_dispatch``).  ``chol_sample`` is plain
torch: the reference the packed samplers (ops/chol_packed.py) are checked
against, and the sampler above K = 128."""
from __future__ import annotations

import torch
from torch.linalg import solve_triangular

from .chol_blocked import chol_sample_blocked
from .chol_packed import K2_MAX_K

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


def chol_sample_dispatch(P: torch.Tensor, b: torch.Tensor, xi: torch.Tensor,
                         Lambda: torch.Tensor, jitter: float = 0.0
                         ) -> torch.Tensor:
    """The full-P sampler across K, for P [B, K, K] and b/xi [B, K], with
    P' = P + Lambda (+ jitter I).  Lambda is added to P IN PLACE: the caller
    hands over a fresh P, and this saves a [B, K, K] copy (4.7 GB at K=128
    and B=71,567).

    - 96 < K <= 128: ``chol_sample_blocked`` (the K5 kernel on CUDA);
    - K > 128: ``chol_sample`` on torch.linalg, as the JAX package leaves
      that range to XLA;
    - K <= 96: not ported — the full-P kernels K3/K4 serve only the gather
      path (ROADMAP M6); the engine takes the packed branch there.
    """
    K = P.shape[-1]
    if K <= K2_MAX_K:
        raise NotImplementedError(
            f"not ported yet: the full-P sampler for K={K} <= "
            f"{K2_MAX_K} (ROADMAP K3/K4, gather path M6)")
    P += Lambda
    if K <= BLOCKED_MAX_K:
        return chol_sample_blocked(P, b, xi, jitter)
    return chol_sample(P, b, xi, jitter)
