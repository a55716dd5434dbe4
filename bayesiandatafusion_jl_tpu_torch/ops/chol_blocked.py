"""Blocked Cholesky sampler for 96 < K <= 128: u ~ N(P^-1 b, P^-1) per row
on a full P [B, K, K], by a panel recursion whose diagonal panels are
factored and inverted by a kernel.

Port of ``bayesiandatafusion_jl_tpu/ops/pallas_chol.py`` :389-522:
``chol_inv`` is ``chol_inv_pallas`` :424 (TPU kernel
``_chol_inv_slab_kernel`` :389), ``chol_sample_blocked`` is :452.
``chol_inv`` launches ``csrc/chol_inv.cu`` (K5) for tensors on a CUDA
device and runs the plain version, ``chol_inv_plain``, for tensors on the
CPU.  The rest of the recursion is batched matrix products, which the JAX
package runs outside Pallas at Precision.HIGHEST; here they are torch
matmuls in full precision (the engines pin it for their windows,
``models/engine.full_float32``).
"""
from __future__ import annotations

import torch
from torch.linalg import solve_triangular

from .. import kernels
from ..utils import spans

# the K range of the kernel (panel width)
K5_MAX_K = 64


def chol_inv_plain(P: torch.Tensor) -> torch.Tensor:
    """The plain torch version: W = cholesky(P)^-1 for P [B, K, K], by a
    batched Cholesky and a triangular solve against the identity."""
    chol_inv_plain.calls += 1
    K = P.shape[-1]
    L = torch.linalg.cholesky(P)
    eye = torch.eye(K, dtype=P.dtype, device=P.device).expand_as(P)
    return solve_triangular(L, eye, upper=False)


chol_inv_plain.calls = 0
spans.counter(chol_inv_plain, "calls")


def chol_inv(P: torch.Tensor) -> torch.Tensor:
    """W = cholesky(P)^-1, lower triangular with exact zeros above the
    diagonal, batched: P [B, K, K] symmetric positive definite -> W.

    CPU tensors run the plain version; CUDA tensors launch the kernel (K5,
    K <= 64, float32/float64) on the current stream (``chol_inv.launches``
    counts launches) or raise — no fallback.  The kernel reads P through
    its strides: a view with unit inner stride, such as a diagonal panel
    ``P[:, :64, :64]`` of a contiguous [B, 128, 128], is read in place."""
    if P.dim() != 3 or P.shape[1] != P.shape[2]:
        raise ValueError(f"P must be [B, K, K], got {tuple(P.shape)}")
    if P.device.type == "cpu":
        return chol_inv_plain(P)
    if P.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {P.device}")
    B, K, _ = P.shape
    if P.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"chol_inv kernel takes float32/float64, got "
                        f"{P.dtype}")
    if not 1 <= K <= K5_MAX_K:
        raise ValueError(f"chol_inv kernel takes K <= {K5_MAX_K}, got {K}")
    bs, ld, inner = P.stride()
    if K > 1 and (inner != 1 or ld < K):
        raise ValueError(f"chol_inv kernel reads rows of unit stride that "
                         f"do not overlap, got strides {P.stride()}")
    W = torch.empty((B, K, K), dtype=P.dtype, device=P.device)
    lib = kernels.load()
    fn = (lib.bdf_chol_inv_f32 if P.dtype == torch.float32
          else lib.bdf_chol_inv_f64)
    stream = torch.cuda.current_stream(P.device).cuda_stream
    with torch.cuda.device(P.device):
        rc = fn(P.data_ptr(), max(ld, K), bs, W.data_ptr(), B, K, stream)
    if rc != 0:
        raise RuntimeError(f"chol_inv kernel launch failed: CUDA error {rc}")
    chol_inv.launches += 1
    return W


chol_inv.launches = 0
spans.counter(chol_inv, "launches")


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched A @ x for A [B, n, n], x [B, n]."""
    return (A @ x[..., None])[..., 0]


def chol_sample_blocked(P: torch.Tensor, b: torch.Tensor, xi: torch.Tensor,
                        jitter: float = 0.0, block: int = 64
                        ) -> torch.Tensor:
    """Sample u [B, K] ~ N(P^-1 b, P^-1) by the blocked right-looking
    Cholesky with ``block``-wide panels; P [B, K, K], b and xi [B, K]:

        W_jj = chol_inv(P_jj - sum_{k<j} L_jk L_jk^T)       (= L_jj^-1)
        L_ij = (P_ij - sum_{k<j} L_ik L_jk^T) W_jj^T         (i > j)
        y_i  = W_ii (b_i - sum_{k<i} L_ik y_k)               (forward)
        u_i  = W_ii^T (y_i + xi_i - sum_{k>i} L_ki^T u_k)    (backward)

    K is padded up to a multiple of ``block`` with an identity diagonal
    (zero-coupled, so the padded components sample to exactly zero)."""
    B, K, _ = P.shape
    dtype, dev = P.dtype, P.device
    if jitter:
        P = P + jitter * torch.eye(K, dtype=dtype, device=dev)
    padk = (-K) % block
    if padk:
        Kp = K + padk
        Pp = torch.zeros((B, Kp, Kp), dtype=dtype, device=dev)
        Pp[:, :K, :K] = P
        Pp[:, K:, K:] = torch.eye(padk, dtype=dtype, device=dev)
        P = Pp
        b = torch.cat([b, b.new_zeros((B, padk))], dim=1)
        xi = torch.cat([xi, xi.new_zeros((B, padk))], dim=1)
    nb = P.shape[1] // block

    def blk(i, j):
        return P[:, i * block:(i + 1) * block, j * block:(j + 1) * block]

    L = {}   # off-diagonal panels (i > j)
    W = {}   # inverted diagonal factors
    for j in range(nb):
        with spans.span("bdf.panels"):
            S = blk(j, j)
            for k in range(j):
                S = S - L[j, k] @ L[j, k].mT
        with spans.span("bdf.k5"):
            W[j] = chol_inv(S)   # the first panel is read in place
        with spans.span("bdf.panels"):
            for i in range(j + 1, nb):
                Sij = blk(i, j)
                for k in range(j):
                    Sij = Sij - L[i, k] @ L[j, k].mT
                L[i, j] = Sij @ W[j].mT

    with spans.span("bdf.solves"):
        bs = [b[:, i * block:(i + 1) * block] for i in range(nb)]
        xs = [xi[:, i * block:(i + 1) * block] for i in range(nb)]
        y = [None] * nb
        for i in range(nb):
            s = bs[i]
            for k in range(i):
                s = s - _mv(L[i, k], y[k])
            y[i] = _mv(W[i], s)
        u = [None] * nb
        for i in range(nb - 1, -1, -1):
            s = y[i] + xs[i]
            for k in range(i + 1, nb):
                s = s - _mv(L[k, i].mT, u[k])
            u[i] = _mv(W[i].mT, s)
        return torch.cat(u, dim=1)[:, :K]
