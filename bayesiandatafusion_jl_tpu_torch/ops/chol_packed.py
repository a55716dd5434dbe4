"""Packed-triangle Cholesky sampler: u ~ N(P'^-1 b, P'^-1) per row.

Port of ``bayesiandatafusion_jl_tpu/ops/pallas_chol.py``
``chol_sample_packed`` (:192, TPU kernel ``_chol_sample_packed_kernel``
:178).  P' = unpack(Pp) + Lambda (+ jitter I), with Pp the K(K+1)/2 upper
triangle of each row's precision in ``np.triu_indices`` order, and
u = L^-T (L^-1 b + xi) for L = chol(P').  K <= 32.

``chol_sample_packed`` launches the CUDA kernel
(``csrc/chol_sample_packed.cu``) for tensors on a CUDA device and runs the
plain version, ``chol_sample_packed_plain``, for tensors on the CPU.
"""
from __future__ import annotations

import torch
from torch.linalg import solve_triangular

from .. import kernels
from .dense_gram import tri_maps

MAX_K = 32


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
    """The plain torch version: unpack through the ``tri_maps`` index, add
    Lambda + jitter I, batched Cholesky and two triangular solves.
    Runs on any device; returns u [B, K]."""
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


def chol_sample_packed(Pp: torch.Tensor, b: torch.Tensor, xi: torch.Tensor,
                       Lambda: torch.Tensor, jitter: float = 0.0,
                       transposed: bool = True) -> torch.Tensor:
    """Sample u [B, K] from packed precision rows.

    ``transposed=True`` (the engine's layout): Pp [K(K+1)/2, B] and
    b [K, B], as the Gramian emits them; ``False``: Pp [B, C], b [B, K].
    Pp and b may be strided views (the kernel takes both strides); xi
    [B, K] and Lambda [K, K] must be contiguous on the kernel path.

    CPU tensors run the plain version; CUDA tensors launch the kernel on
    the current stream (``chol_sample_packed.launches`` counts launches)
    or raise — there is no fallback.
    """
    K = Lambda.shape[0]
    B, _ = _unpack_layout(Pp, b, K, transposed)
    if Pp.device.type == "cpu":
        return chol_sample_packed_plain(Pp, b, xi, Lambda, jitter,
                                        transposed)
    if Pp.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {Pp.device}")
    dtype = Pp.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"chol_sample_packed kernel takes float32/float64, "
                        f"got {dtype}")
    if not 1 <= K <= MAX_K:
        raise ValueError(f"chol_sample_packed kernel takes K <= {MAX_K}, "
                         f"got {K}")
    for name, t in (("b", b), ("xi", xi), ("Lambda", Lambda)):
        if t.device != Pp.device:
            raise ValueError(f"{name} is on {t.device}, Pp on {Pp.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, Pp is {dtype}")
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
    fn = (lib.bdf_chol_sample_packed_f32 if dtype == torch.float32
          else lib.bdf_chol_sample_packed_f64)
    stream = torch.cuda.current_stream(Pp.device).cuda_stream
    with torch.cuda.device(Pp.device):
        rc = fn(Pp.data_ptr(), p_sc, p_sr, Lambda.data_ptr(), float(jitter),
                b.data_ptr(), b_sk, b_sr, xi.data_ptr(), u.data_ptr(), B, K,
                stream)
    if rc != 0:
        raise RuntimeError(f"chol_sample_packed kernel launch failed: CUDA "
                           f"error {rc}")
    chol_sample_packed.launches += 1
    return u


chol_sample_packed.launches = 0
