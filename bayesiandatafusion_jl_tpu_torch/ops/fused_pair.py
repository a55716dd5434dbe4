"""The fused masked-pair contraction (K8): both Gramian orientations of the
fused sparse regime from one stored int8 value array V8.

Port of the s8 ``flip_out`` variants of ``bayesiandatafusion_jl_tpu/ops/
pallas_fused.py`` ``fused_pair_pallas`` :345 (TPU kernels
``_kern_focus_rows_i8_t`` :127, ``_kern_focus_cols_i8_t`` :158 and the
dequantizing ``_kern_focus_rows_i8_tq`` :182, ``_kern_focus_cols_i8_tq``
:218), the CUDA kernel ``csrc/fused_pair_i8.cu``.  With V8 [n0, n1] (0 =
unobserved) and YZ8T [C + K, n_contract] the quantized partner table (K7's
layout; its last K rows are the quantized factors Z8T), for focus mode f
(0: V8's rows, contracting n1; 1: V8's columns, contracting n0):

    PM = (V8_f != 0) @ YZ8T.T      exact int32, [C + K, n_focus] transposed
    BV =  V8_f       @ Z8T.T       exact int32, [K, n_focus] transposed

raw, or through the dequant epilogue ``dq=(syz, sz)`` (float32 scales,
alpha already folded in): Pt = PM[:C] * syz[:C], PMm = PM[C:] * syz[C:],
BVf = BV * sz, float32.  The int32 sums are exact under the caller's
``fused_int8_ok`` bound, so the kernel and the plain version agree bit for
bit in both epilogues.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import kernels


def _mm_i32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 a @ b for int8 a [m, k], b [k, n]: ``torch._int_mm`` on
    CUDA (zero-padded to the shapes it takes: m > 16, k and n multiples of
    8), an int64 matmul on the CPU."""
    if not a.is_cuda:
        return (a.to(torch.int64) @ b.to(torch.int64)).to(torch.int32)
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = max(m, 17), -(-k // 8) * 8, -(-n // 8) * 8
    if (mp, kp) != (m, k):
        a = torch.nn.functional.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b = torch.nn.functional.pad(b, (0, np_ - n, 0, kp - k))
    return torch._int_mm(a, b)[:m, :n]


def _epilogue(PM, BV, C, dq):
    if dq is None:
        return PM, BV
    syz, sz = dq
    PMf = PM.to(torch.float32) * syz[:, None]
    return (PMf[:C].contiguous(), PMf[C:].contiguous(),
            BV.to(torch.float32) * sz[:, None])


def fused_pair_plain(V8: torch.Tensor, YZ8T: torch.Tensor, focus_axis: int,
                     K: int, n_focus: int,
                     dq: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                     chunk: int = 16_384):
    """The plain torch version, ``chunk`` V8 rows at a time (the 0/1 mask
    exists one chunk at a time, never whole).  Runs on any device; returns
    (PM [C + K, n_focus], BV [K, n_focus]) int32, or with ``dq`` (Pt
    [C, n_focus], PMm [K, n_focus], BVf [K, n_focus]) float32."""
    fused_pair_plain.calls += 1
    CK = YZ8T.shape[0]
    C = CK - K
    Z8T = YZ8T[C:]
    n0 = V8.shape[0]
    if focus_axis == 0:
        PM = torch.empty((CK, n_focus), dtype=torch.int32, device=V8.device)
        BV = torch.empty((K, n_focus), dtype=torch.int32, device=V8.device)
        for r0 in range(0, n_focus, chunk):
            v = V8[r0:min(r0 + chunk, n_focus)]
            m8 = (v != 0).to(torch.int8)
            PM[:, r0:r0 + chunk] = _mm_i32(m8, YZ8T.mT).mT
            BV[:, r0:r0 + chunk] = _mm_i32(v, Z8T.mT).mT
    else:
        PMn = torch.zeros((n_focus, CK), dtype=torch.int32, device=V8.device)
        BVn = torch.zeros((n_focus, K), dtype=torch.int32, device=V8.device)
        for r0 in range(0, n0, chunk):
            v = V8[r0:r0 + chunk, :n_focus].mT.contiguous()
            m8 = (v != 0).to(torch.int8)
            yz = YZ8T[:, r0:r0 + chunk].contiguous()
            PMn += _mm_i32(m8, yz.mT)
            BVn += _mm_i32(v, yz[C:].mT)
        PM, BV = PMn.mT.contiguous(), BVn.mT.contiguous()
    return _epilogue(PM, BV, C, dq)


fused_pair_plain.calls = 0


def fused_pair_contract(V8: torch.Tensor, YZ8T: torch.Tensor,
                        focus_axis: int, K: int, n_focus: int,
                        dq: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """The contraction of focus mode ``focus_axis`` for its first
    ``n_focus`` rows: V8 [n0, n1] int8 (both multiples of 16 on the kernel
    path), YZ8T [C + K, n_contract] int8 with n_contract = V8's other
    extent; outputs as ``fused_pair_plain``.

    CPU tensors run the plain version; CUDA tensors launch the kernel on
    the current stream (``fused_pair_contract.launches`` counts launches)
    or raise — there is no fallback."""
    if V8.device.type == "cpu":
        return fused_pair_plain(V8, YZ8T, focus_axis, K, n_focus, dq)
    if V8.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {V8.device}")
    if focus_axis not in (0, 1):
        raise ValueError(f"focus_axis must be 0 or 1, got {focus_axis}")
    n0, n1 = V8.shape
    CK = YZ8T.shape[0]
    C = CK - K
    n_contract = (n1, n0)[focus_axis]
    if V8.dtype != torch.int8 or YZ8T.dtype != torch.int8:
        raise TypeError("V8 and YZ8T must be int8")
    if n0 % 16 or n1 % 16 or not V8.is_contiguous():
        raise ValueError(f"V8 must be contiguous with both extents multiples "
                         f"of 16, got {tuple(V8.shape)}")
    if (C != K * (K + 1) // 2 or tuple(YZ8T.shape) != (CK, n_contract)
            or not YZ8T.is_contiguous()):
        raise ValueError(f"YZ8T must be contiguous [{K * (K + 1) // 2 + K}, "
                         f"{n_contract}] for K={K}, got {tuple(YZ8T.shape)}")
    if not 0 <= n_focus <= (n0, n1)[focus_axis]:
        raise ValueError(f"n_focus={n_focus} outside the stored extent")
    dev = V8.device
    f32, i32 = torch.float32, torch.int32
    if dq is None:
        outs = (torch.empty((CK, n_focus), dtype=i32, device=dev),
                torch.empty((K, n_focus), dtype=i32, device=dev))
        ptrs = [o.data_ptr() for o in outs] + [None] * 5
    else:
        syz, sz = (t.to(f32).contiguous() for t in dq)
        if tuple(syz.shape) != (CK,) or tuple(sz.shape) != (K,):
            raise ValueError("dq scales must be [C + K] and [K]")
        outs = (torch.empty((C, n_focus), dtype=f32, device=dev),
                torch.empty((K, n_focus), dtype=f32, device=dev),
                torch.empty((K, n_focus), dtype=f32, device=dev))
        ptrs = [None, None, syz.data_ptr(), sz.data_ptr()] + [
            o.data_ptr() for o in outs]
    lib = kernels.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.bdf_fused_pair_i8(V8.data_ptr(), n0, n1, focus_axis,
                                   YZ8T.data_ptr(), C, K, n_focus,
                                   int(dq is not None), *ptrs, stream)
    if rc != 0:
        raise RuntimeError(f"fused pair kernel launch failed: CUDA error {rc}")
    fused_pair_contract.launches += 1
    return outs


fused_pair_contract.launches = 0
