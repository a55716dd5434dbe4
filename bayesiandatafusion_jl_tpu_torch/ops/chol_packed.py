"""Packed-triangle Cholesky samplers: u ~ N(P'^-1 b, P'^-1) per row.

Port of ``bayesiandatafusion_jl_tpu/ops/pallas_chol.py`` :192-386.
P' = unpack(Pp) + Lambda (+ jitter I), with Pp the K(K+1)/2 upper triangle
of each row's precision in ``np.triu_indices`` order, and
u = L^-T (L^-1 b + xi) for L = chol(P').  Two kernels cover the K ladder:

- ``chol_sample_packed`` (K <= 32): ``csrc/chol_sample_packed.cu`` (K1),
  port of ``chol_sample_packed`` :192 (TPU kernel
  ``_chol_sample_packed_kernel`` :178);
- ``chol_sample_packed_tiled`` (32 < K <= 96):
  ``csrc/chol_sample_packed_slab.cu`` (K2), port of
  ``chol_sample_packed_tiled`` :315 (TPU kernel
  ``_chol_sample_packed_slab_kernel`` :269).

Both launch their CUDA kernel for tensors on a CUDA device and run the one
plain version, ``chol_sample_packed_plain``, for tensors on the CPU.
"""
from __future__ import annotations

from typing import List

import torch
from torch.linalg import solve_triangular

from .. import kernels
from ..utils import spans
from .dense_gram import tri_maps

# the K range of each kernel
K1_MAX_K = 32
K2_MAX_K = 96


def tri_offsets(K: int) -> List[int]:
    """off[j] = packed index of the diagonal (j, j) in ``np.triu_indices``
    order.  The upper triangle row by row is the lower triangle column by
    column, so packed[off[j] + (k - j)] = L-column entry (k, j) for k >= j:
    every column slab of the Cholesky recurrence is a contiguous range."""
    return [j * K - j * (j - 1) // 2 for j in range(K)]


def _unpack_layout(Pp, b, K, transposed):
    """(B, C) after checking Pp/b against K and the layout."""
    C = K * (K + 1) // 2
    if Pp.dim() != 2 or b.dim() != 2:
        raise ValueError("Pp and b must be 2-D")
    B = Pp.shape[1] if transposed else Pp.shape[0]
    want_p = (C, B) if transposed else (B, C)
    want_b = (K, B) if transposed else (B, K)
    if tuple(Pp.shape) != want_p or tuple(b.shape) != want_b:
        raise ValueError(f"Pp {tuple(Pp.shape)} / b {tuple(b.shape)} do "
                         f"not match K={K} (want {want_p} / {want_b})")
    return B, C


def chol_sample_packed_plain(Pp: torch.Tensor, b: torch.Tensor,
                             xi: torch.Tensor, Lambda: torch.Tensor,
                             jitter: float = 0.0,
                             transposed: bool = True) -> torch.Tensor:
    """The plain torch version of both packed samplers, for any K: unpack
    through the ``tri_maps`` index, add Lambda + jitter I, batched Cholesky
    and two triangular solves.  Runs on any device; returns u [B, K]."""
    chol_sample_packed_plain.calls += 1
    K = Lambda.shape[0]
    B, _ = _unpack_layout(Pp, b, K, transposed)
    if transposed:
        Pp, b = Pp.mT, b.mT                      # [B, C], [B, K]
    _, _, expand = tri_maps(K)
    lam = Lambda.to(Pp.dtype)
    if jitter:
        lam = lam + jitter * torch.eye(K, dtype=Pp.dtype, device=Pp.device)
    idx = torch.as_tensor(expand, dtype=torch.long, device=Pp.device)
    P = Pp[:, idx].reshape(B, K, K) + lam
    L = torch.linalg.cholesky(P)
    y = solve_triangular(L, b[..., None], upper=False)
    u = solve_triangular(L.mT, y + xi[..., None], upper=True)
    return u[..., 0]


chol_sample_packed_plain.calls = 0
spans.counter(chol_sample_packed_plain, "calls")


def _launch(name, k_min, k_max, Pp, b, xi, Lambda, jitter, transposed):
    """Check the operands and launch kernel ``bdf_{name}_{f32|f64}`` on the
    current stream; returns u [B, K].  Raises on what the kernel does not
    take and on a failed launch — there is no fallback."""
    K = Lambda.shape[0]
    B, _ = _unpack_layout(Pp, b, K, transposed)
    if Pp.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {Pp.device}")
    dtype = Pp.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name} kernel takes float32/float64, got {dtype}")
    if not k_min <= K <= k_max:
        raise ValueError(f"{name} kernel takes {k_min} <= K <= {k_max}, "
                         f"got {K}")
    for arg, t in (("b", b), ("xi", xi), ("Lambda", Lambda)):
        if t.device != Pp.device:
            raise ValueError(f"{arg} is on {t.device}, Pp on {Pp.device}")
        if t.dtype != dtype:
            raise TypeError(f"{arg} is {t.dtype}, Pp is {dtype}")
    if tuple(xi.shape) != (B, K) or not xi.is_contiguous():
        raise ValueError(f"xi must be contiguous [{B}, {K}]")
    if tuple(Lambda.shape) != (K, K) or not Lambda.is_contiguous():
        raise ValueError(f"Lambda must be contiguous [{K}, {K}]")
    p_sc, p_sr = ((Pp.stride(0), Pp.stride(1)) if transposed
                  else (Pp.stride(1), Pp.stride(0)))
    b_sk, b_sr = ((b.stride(0), b.stride(1)) if transposed
                  else (b.stride(1), b.stride(0)))
    u = torch.empty((B, K), dtype=dtype, device=Pp.device)
    lib = kernels.load()
    suffix = "f32" if dtype == torch.float32 else "f64"
    fn = getattr(lib, f"bdf_{name}_{suffix}")
    stream = torch.cuda.current_stream(Pp.device).cuda_stream
    with torch.cuda.device(Pp.device):
        rc = fn(Pp.data_ptr(), p_sc, p_sr, Lambda.data_ptr(), float(jitter),
                b.data_ptr(), b_sk, b_sr, xi.data_ptr(), u.data_ptr(), B, K,
                stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    return u


def chol_sample_packed(Pp: torch.Tensor, b: torch.Tensor, xi: torch.Tensor,
                       Lambda: torch.Tensor, jitter: float = 0.0,
                       transposed: bool = True) -> torch.Tensor:
    """Sample u [B, K] from packed precision rows, K <= 32 (K1).

    ``transposed=True`` (the engine's layout): Pp [K(K+1)/2, B] and
    b [K, B], as the Gramian emits them; ``False``: Pp [B, C], b [B, K].
    Pp and b may be strided views (the kernel takes both strides); xi
    [B, K] and Lambda [K, K] must be contiguous on the kernel path.

    CPU tensors run the plain version; CUDA tensors launch the kernel on
    the current stream (``chol_sample_packed.launches`` counts launches)
    or raise — there is no fallback.
    """
    if Pp.device.type == "cpu":
        return chol_sample_packed_plain(Pp, b, xi, Lambda, jitter,
                                        transposed)
    u = _launch("chol_sample_packed", 1, K1_MAX_K, Pp, b, xi, Lambda,
                jitter, transposed)
    chol_sample_packed.launches += 1
    return u


chol_sample_packed.launches = 0
spans.counter(chol_sample_packed, "launches")


def chol_sample_packed_tiled(Pp: torch.Tensor, b: torch.Tensor,
                             xi: torch.Tensor, Lambda: torch.Tensor,
                             jitter: float = 0.0,
                             transposed: bool = True) -> torch.Tensor:
    """The same draw for 32 < K <= 96 (K2, the packed column-slab kernel).
    Layouts, strides and the CPU/CUDA split as in ``chol_sample_packed``;
    ``chol_sample_packed_tiled.launches`` counts launches."""
    if Pp.device.type == "cpu":
        return chol_sample_packed_plain(Pp, b, xi, Lambda, jitter,
                                        transposed)
    u = _launch("chol_sample_packed_slab", K1_MAX_K + 1, K2_MAX_K, Pp, b,
                xi, Lambda, jitter, transposed)
    chol_sample_packed_tiled.launches += 1
    return u


chol_sample_packed_tiled.launches = 0
spans.counter(chol_sample_packed_tiled, "launches")


def chol_sample_packed_dispatch(Pp: torch.Tensor, b: torch.Tensor,
                                xi: torch.Tensor, Lambda: torch.Tensor,
                                jitter: float = 0.0,
                                transposed: bool = True) -> torch.Tensor:
    """The packed sampler across the K ladder: K1 for K <= 32, K2 for
    32 < K <= 96; larger K has no packed sampler (the engine takes the
    full-P branch there)."""
    K = Lambda.shape[0]
    if K <= K1_MAX_K:
        return chol_sample_packed(Pp, b, xi, Lambda, jitter, transposed)
    if K <= K2_MAX_K:
        return chol_sample_packed_tiled(Pp, b, xi, Lambda, jitter,
                                        transposed)
    raise ValueError(f"no packed sampler for K={K} > {K2_MAX_K}")
