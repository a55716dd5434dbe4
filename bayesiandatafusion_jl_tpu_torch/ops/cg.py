"""Blocked conjugate gradients for the link matrix beta.

Port of ``bayesiandatafusion_jl_tpu/ops/cg.py`` ``block_cg`` (:23-87):
``(X'X + lambda I) B = RHS`` with K right-hand sides at once, matrix-free
(``matvec(V) = X'(X V) + lambda V``), K simultaneous vector recurrences
sharing each matvec, warm-started from the previous sweep's beta.

The JAX package tests convergence inside a ``while_loop`` on the device.
Here the test is read back to the host once an iteration (one float), so
the loop stops at the same iteration as JAX's: the first whose recursive
residual is below ``tol`` for every column, or ``maxiter``.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch


def block_cg(matvec: Callable[[torch.Tensor], torch.Tensor],
             rhs: torch.Tensor,        # [F, K]
             x0: torch.Tensor,         # [F, K] warm start
             tol: float = 1e-6,
             maxiter: int = 200,
             precond_diag: Optional[torch.Tensor] = None,   # [F] Jacobi
             precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
             ) -> Tuple[torch.Tensor, int, torch.Tensor]:
    """Solve A x = rhs for SPD A, K columns at once.

    Returns ``(x, n_iters, true_resid_rel)``: ``true_resid_rel`` is the
    largest over the columns of ``||rhs - A x|| / ||rhs||``, recomputed at
    exit by one more matvec (the loop tests the recursive residual, which
    drifts from the true one in float32).  ``precond`` (e.g. Nystrom,
    ops/precond.py) applies M^-1; else ``precond_diag`` gives Jacobi's."""
    dtype = rhs.dtype
    rhs_nrm2 = torch.clamp_min(torch.sum(rhs * rhs, dim=0), 1e-30)   # [K]
    tol2 = float(torch.tensor(tol * tol, dtype=dtype))   # JAX's, rounded
    minv = (None if precond_diag is None
            else (1.0 / precond_diag)[:, None].to(dtype))

    def prec(r):
        if precond is not None:
            return precond(r)
        return r if minv is None else r * minv

    x = x0
    r = rhs - matvec(x0)
    p = prec(r)
    rz = torch.sum(r * p, dim=0)
    it = 0
    while it < maxiter and float(
            torch.max(torch.sum(r * r, dim=0) / rhs_nrm2)) > tol2:
        Ap = matvec(p)
        denom = torch.sum(p * Ap, dim=0)
        safe = denom > 0
        a = torch.where(safe, rz / torch.where(safe, denom, 1.0), 0.0)
        x = x + a * p
        r = r - a * Ap
        z = prec(r)
        rz_new = torch.sum(r * z, dim=0)
        pos = rz > 0
        b = torch.where(pos, rz_new / torch.where(pos, rz, 1.0), 0.0)
        p = z + b * p
        rz = rz_new
        it += 1
    r_true = rhs - matvec(x)
    resid = torch.sqrt(torch.max(torch.sum(r_true * r_true, dim=0)
                                 / rhs_nrm2))
    return x, it, resid
