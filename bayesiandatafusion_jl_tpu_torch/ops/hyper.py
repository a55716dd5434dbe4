"""Hyperparameter draws (port of ``ops/hyper.py``): the Normal-Wishart
prior of each entity, the link-matrix precision lambda_beta of an entity
with side features and the noise precision alpha of a relation.

Wishart sampling by the Bartlett decomposition on K x K matrices; every
random number comes from the sweep's randoms dict (utils/rng.py).  Float32
products here run in full float32: the engine turns TF32 off for CUDA
matmuls.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch.linalg import solve_triangular


def bartlett_wishart(chi2: torch.Tensor, normals: torch.Tensor,
                     M_lower: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lambda ~ Wishart(W, nu) with W = (M M^T)^-1; chi2 [K] are the
    chi-square draws with dfs nu - i, normals [K, K] (strict lower used).
    Returns (Lambda, BA) with BA BA^T = Lambda."""
    A = torch.tril(normals, -1) + torch.diag(torch.sqrt(chi2))
    BA = solve_triangular(M_lower.mT, A, upper=True)   # M^-T A
    return BA @ BA.mT, BA


def normal_wishart_update(S: torch.Tensor, b0: float, nu0: float,
                          chi2: torch.Tensor, tri_normals: torch.Tensor,
                          mu_normals: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Normal-Wishart conditional draw from the residual rows S [N, K]
    (mu0 = 0, W0 = I).  Returns (mu, Lambda)."""
    N = S.shape[0]
    Sbar = S.mean(dim=0)
    Sc = S - Sbar
    scatter = Sc.mT @ Sc
    return normal_wishart_from_moments(N, Sbar, scatter, b0, nu0, chi2,
                                       tri_normals, mu_normals)


def normal_wishart_from_moments(N: int, Sbar: torch.Tensor,
                                scatter: torch.Tensor, b0: float,
                                nu0: float, chi2: torch.Tensor,
                                tri_normals: torch.Tensor,
                                mu_normals: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same draw from the sufficient statistics (Sbar, scatter)."""
    K = Sbar.shape[0]
    b_star = b0 + N
    mu_star = (N * Sbar) / b_star
    Winv_star = (torch.eye(K, dtype=Sbar.dtype, device=Sbar.device)
                 + scatter + (b0 * N / b_star) * torch.outer(Sbar, Sbar))
    # W* = (M M^T)^-1; cholesky_ex does not read its error flag back to
    # the host, so the sweep never waits for the device here (a non-PD
    # input gives NaN, as in the JAX package)
    M, _ = torch.linalg.cholesky_ex(Winv_star)
    Lambda, _ = bartlett_wishart(chi2, tri_normals, M)
    # mu ~ N(mu*, (b* Lambda)^-1): (BA)^-T x = M (A^-T x)
    A = torch.tril(tri_normals, -1) + torch.diag(torch.sqrt(chi2))
    w = solve_triangular(A.mT, mu_normals[:, None], upper=True)
    # a host scalar: a device tensor made here would sync the stream
    b_sqrt = torch.sqrt(torch.tensor(b_star, dtype=Sbar.dtype))
    mu = mu_star + (M @ w)[:, 0] / b_sqrt
    return mu, Lambda


def sample_lambda_beta(beta: torch.Tensor, Lambda: torch.Tensor,
                       g: torch.Tensor, nu_beta: float,
                       lambda_beta_mean: float) -> torch.Tensor:
    """lambda_beta | beta, Lambda ~ Gamma((nu + F K)/2, rate = (nu / mean +
    tr(beta' beta Lambda)) / 2), from the pre-drawn standard Gamma((nu +
    F K)/2) variate ``g`` (JAX ``ops/hyper.sample_lambda_beta`` :94)."""
    tr = torch.einsum("fk,fl,kl->", beta, beta, Lambda)
    return g / ((nu_beta / lambda_beta_mean + tr) / 2.0)


def sample_alpha(sse: torch.Tensor, n_obs: int, g: torch.Tensor, a0: float,
                 b0: float) -> torch.Tensor:
    """alpha | residuals ~ Gamma(a0 + n_obs/2, rate = b0 + SSE/2), from the
    pre-drawn standard Gamma(a0 + n_obs/2) variate ``g`` (JAX
    ``ops/hyper.sample_alpha`` :105)."""
    return g / (b0 + sse / 2.0)
