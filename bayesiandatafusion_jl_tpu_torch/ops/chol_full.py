"""Full-P Cholesky samplers of the gather path: u ~ N(P'^-1 b, P'^-1) per
row, for P [B, K, K] as ``ops/gramian.assemble_precision`` emits it.

Port of ``bayesiandatafusion_jl_tpu/ops/pallas_chol.py``:

- ``chol_sample_full`` (K <= 32): ``csrc/chol_sample_full.cu`` (K3), port
  of ``chol_sample_pallas`` :525 (TPU kernels ``_chol_sample_kernel`` :29
  and ``_chol_sample_lam_kernel`` :36), P' = (P + jitter I) + Lambda,
  with Lambda added in registers when given;
- ``chol_sample_full_tiled`` (32 < K <= 96): ``csrc/chol_sample_full_slab.cu``
  (K4), port of ``chol_sample_pallas_tiled`` :119 (TPU kernel
  ``_chol_sample_slab_kernel`` :77), P' = (P + Lambda) + jitter I, with
  Lambda added on load (the JAX package adds it before the kernel).

u = L^-T (L^-1 b + xi) for L = chol(P').  Both launch their CUDA kernel for
tensors on a CUDA device and run the one plain version,
``chol_sample_full_plain``, for tensors on the CPU.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.linalg import solve_triangular

from .. import kernels

# the K range of each kernel
K3_MAX_K = 32
K4_MAX_K = 96


def chol_sample_full_plain(P: torch.Tensor, b: torch.Tensor,
                           xi: torch.Tensor,
                           Lambda: Optional[torch.Tensor] = None,
                           jitter: float = 0.0) -> torch.Tensor:
    """The plain torch version of both full-P samplers, for any K: add
    Lambda (when given) and jitter I, batched Cholesky and two triangular
    solves.  Runs on any device; returns u [B, K]."""
    chol_sample_full_plain.calls += 1
    K = P.shape[-1]
    if Lambda is not None:
        P = P + Lambda.to(P.dtype)
    if jitter:
        P = P + jitter * torch.eye(K, dtype=P.dtype, device=P.device)
    L = torch.linalg.cholesky(P)
    y = solve_triangular(L, b[..., None], upper=False)
    u = solve_triangular(L.mT, y + xi[..., None], upper=True)
    return u[..., 0]


chol_sample_full_plain.calls = 0


def _launch(name, k_min, k_max, P, b, xi, Lambda, jitter):
    """Check the operands and launch kernel ``bdf_{name}_{f32|f64}`` on the
    current stream; returns u [B, K].  Raises on what the kernel does not
    take and on a failed launch — there is no fallback."""
    if P.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {P.device}")
    if P.dim() != 3 or P.shape[1] != P.shape[2]:
        raise ValueError(f"P must be [B, K, K], got {tuple(P.shape)}")
    B, K, _ = P.shape
    dtype = P.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name} kernel takes float32/float64, got {dtype}")
    if not k_min <= K <= k_max:
        raise ValueError(f"{name} kernel takes {k_min} <= K <= {k_max}, "
                         f"got {K}")
    ops = [("P", P, (B, K, K)), ("b", b, (B, K)), ("xi", xi, (B, K))]
    if Lambda is not None:
        ops.append(("Lambda", Lambda, (K, K)))
    for arg, t, shape in ops:
        if t.device != P.device:
            raise ValueError(f"{arg} is on {t.device}, P on {P.device}")
        if t.dtype != dtype:
            raise TypeError(f"{arg} is {t.dtype}, P is {dtype}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{arg} must be contiguous {list(shape)}, got "
                             f"{tuple(t.shape)}")
    u = torch.empty((B, K), dtype=dtype, device=P.device)
    lib = kernels.load()
    suffix = "f32" if dtype == torch.float32 else "f64"
    fn = getattr(lib, f"bdf_{name}_{suffix}")
    stream = torch.cuda.current_stream(P.device).cuda_stream
    lam = None if Lambda is None else Lambda.data_ptr()
    with torch.cuda.device(P.device):
        rc = fn(P.data_ptr(), lam, float(jitter), b.data_ptr(),
                xi.data_ptr(), u.data_ptr(), B, K, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    return u


def chol_sample_full(P: torch.Tensor, b: torch.Tensor, xi: torch.Tensor,
                     Lambda: Optional[torch.Tensor] = None,
                     jitter: float = 0.0) -> torch.Tensor:
    """Sample u [B, K] from full precision rows P [B, K, K], K <= 32 (K3),
    b and xi [B, K], Lambda [K, K] or None; all contiguous on the kernel
    path.

    CPU tensors run the plain version; CUDA tensors launch the kernel on
    the current stream (``chol_sample_full.launches`` counts launches) or
    raise — there is no fallback."""
    if P.device.type == "cpu":
        return chol_sample_full_plain(P, b, xi, Lambda, jitter)
    u = _launch("chol_sample_full", 1, K3_MAX_K, P, b, xi, Lambda, jitter)
    chol_sample_full.launches += 1
    return u


chol_sample_full.launches = 0


def chol_sample_full_tiled(P: torch.Tensor, b: torch.Tensor,
                           xi: torch.Tensor,
                           Lambda: Optional[torch.Tensor] = None,
                           jitter: float = 0.0) -> torch.Tensor:
    """The same draw for 32 < K <= 96 (K4, the full-P column-slab kernel).
    Operands and the CPU/CUDA split as in ``chol_sample_full``;
    ``chol_sample_full_tiled.launches`` counts launches."""
    if P.device.type == "cpu":
        return chol_sample_full_plain(P, b, xi, Lambda, jitter)
    u = _launch("chol_sample_full_slab", K3_MAX_K + 1, K4_MAX_K, P, b, xi,
                Lambda, jitter)
    chol_sample_full_tiled.launches += 1
    return u


chol_sample_full_tiled.launches = 0
