"""Nystrom preconditioner for the beta CG solve.

Port of ``bayesiandatafusion_jl_tpu/ops/precond.py``: ``build_nystrom``
(:22-41, host numpy and scipy, once per engine), ``resolve_nystrom_rank``
(:44-55) and ``nystrom_apply`` (:58-64) in torch.  A randomized rank-r
Nystrom approximation of X'X (Frangella, Tropp and Udell, 2021) deflates
the head of the spectrum; it changes CG's iterates, not its solution.
lambda enters only at apply time, so one factorization serves every sweep.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def build_nystrom(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                  shape: Tuple[int, int], rank: int,
                  seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Rank-``rank`` Nystrom factorization of A = X'X: (U [F, r] with
    orthonormal columns, d [r] eigenvalue estimates, descending), float64."""
    import scipy.sparse as sp
    from scipy.linalg import solve_triangular
    X = sp.coo_matrix((vals, (rows, cols)), shape=shape).tocsr()
    F = shape[1]
    rng = np.random.default_rng(seed)
    Om = rng.standard_normal((F, rank))
    Y = X.T @ (X @ Om)                            # [F, r] sketch
    # shift for numerical positive definiteness (Frangella et al. alg. 3)
    nu = np.sqrt(F) * np.finfo(np.float64).eps * np.linalg.norm(Y, "fro")
    Ynu = Y + nu * Om
    C = np.linalg.cholesky(Om.T @ Ynu)
    B = solve_triangular(C, Ynu.T, lower=True).T  # [F, r]
    U, s, _ = np.linalg.svd(B, full_matrices=False)
    d = np.maximum(s * s - nu, 0.0)
    return U, d


def resolve_nystrom_rank(cfg_rank, num_features: int) -> int:
    """``MacauConfig.cg_nystrom_rank``: None = auto (1024 for F >= 16384,
    512 for F >= 8192, else off), 0 = off, an int = that rank.  The engine
    also skips the build when F < 4 x the rank."""
    if cfg_rank is not None:
        return int(cfg_rank)
    if num_features >= 16384:
        return 1024
    return 512 if num_features >= 8192 else 0


def nystrom_apply(U: torch.Tensor, d: torch.Tensor, lam,
                  r: torch.Tensor) -> torch.Tensor:
    """P^-1 r for P = U (D + lam I) U' / (d_min + lam) + (I - U U')."""
    t = U.mT @ r                                   # [rank, K]
    head = U @ (t / (d + lam)[:, None])
    return (d[-1] + lam) * head + (r - U @ t)
