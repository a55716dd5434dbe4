"""Dual (Woodbury) exact solver for the link-matrix draw.

Port of ``bayesiandatafusion_jl_tpu/ops/dual.py``.  When an entity has
fewer instances than features (N < F), the Woodbury identity

    (X'X + lam I)^-1 = (I - X'(XX' + lam I)^-1 X) / lam

moves the solve to the N x N dual Gramian G = XX', which is the same every
sweep (only lambda_beta changes).  One eigendecomposition G = Q diag(d) Q',
made once when the engine is built, turns each sweep's beta draw into a
few matmuls and a diagonal scale (``dual_solve_g``).

The eigendecomposition runs on the engine's device (``torch.linalg.eigh``),
in float64 for a float64 engine or N <= 2048, else in float32; the JAX
package runs it on the host.  The solve is a function of G alone: Q
diag(1/(d + lam)) Q' does not depend on the eigenvectors' signs or on the
basis chosen inside a repeated eigenvalue.  In float32 the eigenbasis
carries a backward error ~eps * kappa; ``dual_refine`` steps of
refinement against the exact stored G bring the solve back below CG's
float32 floor.  Every product here must run in full float32 (no TF32; the
engines pin it, ``models/engine.full_float32``): the final ``rhs - X' z``
cancels almost completely along the data directions, so matmul rounding
is amplified by ~||X'X|| / lam.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..utils import spans
from ..utils.spans import timed


def build_dual_gram(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                    shape: Tuple[int, int]) -> np.ndarray:
    """G = X X' (float64, host) from COO features."""
    import scipy.sparse as sp
    X = sp.coo_matrix((np.asarray(vals, np.float64), (rows, cols)),
                      shape=shape).tocsr()
    return np.asarray((X @ X.T).todense())


def dual_eig(G: np.ndarray, dtype, device) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """(Q [N, N], d [N]) of the dual Gramian, in ``dtype`` (a numpy
    dtype) on ``device``; d clipped at 0 (G is PSD; rounding can give tiny
    negatives).  Computed in float64 for a float64 ``dtype`` or N <= 2048,
    else in float32."""
    f64 = np.dtype(dtype) == np.float64 or G.shape[0] <= 2048
    Gt = torch.from_numpy(np.asarray(G, np.float64 if f64 else np.float32))
    w, Q = torch.linalg.eigh(Gt.to(device))
    del Gt
    tdt = getattr(torch, np.dtype(dtype).name)
    return Q.to(tdt), torch.clamp_min(w, 0.0).to(tdt)


def dual_eig_cached(rows, cols, vals, shape, dtype, cache_dir, device,
                    timings: Optional[dict] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, np.ndarray]:
    """(Q, d) on ``device`` and G (float64, host).  With ``cache_dir``,
    (Q, d) are stored under a content hash of the COO features and the
    dtype, and a later build on the same features loads them instead of
    decomposing again.  G is rebuilt every time (a sparse product).
    ``timings`` gets the seconds of the G build ("gram") and of the
    decomposition or the load ("eigh")."""
    timings = {} if timings is None else timings
    with timed("bdf.build.gram") as t:
        G = build_dual_gram(rows, cols, vals, shape)
    timings["gram"] = t.seconds
    with timed("bdf.build.eigh") as t:
        Q, d = _eig_or_load(G, rows, cols, vals, shape, dtype, cache_dir,
                            device)
        if Q.is_cuda:
            torch.cuda.synchronize(Q.device)
    timings["eigh"] = t.seconds
    return Q, d, G


def _eig_or_load(G, rows, cols, vals, shape, dtype, cache_dir, device):
    if not cache_dir:
        return dual_eig(G, dtype, device)
    import hashlib
    import os
    h = hashlib.sha1()
    for a in (np.asarray(rows), np.asarray(cols),
              np.asarray(vals, np.float64),
              np.asarray(shape, np.int64),
              np.frombuffer(np.dtype(dtype).str.encode(), np.uint8)):
        h.update(np.ascontiguousarray(a).tobytes())
    path = os.path.join(cache_dir, f"dualeig_{h.hexdigest()[:16]}.npz")
    if os.path.exists(path):
        z = np.load(path)
        return (torch.from_numpy(z["Q"]).to(device),
                torch.from_numpy(z["d"]).to(device))
    Q, d = dual_eig(G, dtype, device)
    os.makedirs(cache_dir, exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, Q=Q.cpu().numpy(), d=d.cpu().numpy())
    os.replace(tmp, path)
    return Q, d


def _same(t):
    return t


def _apply_inv(Q, d, lam, t, reduce=_same):
    """(G + lam I)^-1 t on the eigenbasis; ``reduce`` sums Q't over the
    ranks that each hold some of Q's rows."""
    return Q @ (reduce(Q.mT @ t) / (d + lam)[:, None])


def dual_solve(Q: torch.Tensor, d: torch.Tensor, lam, rhs: torch.Tensor,
               spmm_fwd: Callable[[torch.Tensor], torch.Tensor],
               spmm_t: Callable[[torch.Tensor], torch.Tensor]
               ) -> torch.Tensor:
    """(X'X + lam I)^-1 rhs on the cached dual eigendecomposition.
    ``dual_solve.calls`` counts the dual solves, of this form and of
    ``dual_solve_g``."""
    dual_solve.calls += 1
    return (rhs - spmm_t(_apply_inv(Q, d, lam, spmm_fwd(rhs)))) / lam


def dual_solve_g(Q: torch.Tensor, d: torch.Tensor, G: torch.Tensor, lam,
                 rhs: torch.Tensor,
                 spmm_fwd: Callable[[torch.Tensor], torch.Tensor],
                 spmm_t: Callable[[torch.Tensor], torch.Tensor],
                 n_refine: int, reduce: Callable = _same,
                 gather: Callable = _same
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(beta, uhat) with the refinement in the N-space dual system: solve
    (G + lam) z = X rhs on the eigenbasis, refine z ``n_refine`` times
    against the exact G, then

        beta = (rhs - X' z) / lam,   uhat = X beta = z

    (X (X'X + lam)^-1 = (XX' + lam)^-1 X), so uhat costs no X pass.

    Row-sharded (the sharded engine, JAX sharded.py:1454-1477): Q, G,
    ``spmm_fwd``'s output and z hold one rank's rows, ``reduce`` sums Q't
    over the ranks (``spmm_t`` sums its own), and ``gather`` assembles
    every rank's z for the product with G's rows [n_loc, n_pad]."""
    dual_solve.calls += 1
    t0 = spmm_fwd(rhs)                       # [N, K]
    z = _apply_inv(Q, d, lam, t0, reduce)
    for _ in range(n_refine):
        z = z + _apply_inv(Q, d, lam, t0 - G @ gather(z) - lam * z, reduce)
    return (rhs - spmm_t(z)) / lam, z


dual_solve.calls = 0
spans.counter(dual_solve, "calls")


def use_dual(beta_solver, n: int, num_features: int, itemsize: int,
             budget_gb: float) -> bool:
    """The solver choice (``MacauConfig.beta_solver``): "dual" forces it,
    "cg" forbids it; None picks it when N < F, F >= 4096 and Q and G fit
    ``dual_budget_gb``."""
    if beta_solver == "dual":
        return True
    if beta_solver is not None:
        return False
    return (n < num_features and num_features >= 4096
            and 2 * n * n * itemsize <= budget_gb * 1e9)
