"""The int8 pair contraction (K6): both Gramian orientations of the int8
pair path from one stored pair (M8, W8).

Port of ``bayesiandatafusion_jl_tpu/ops/pallas_pair.py``
``pair_contract_pallas`` :137 (TPU kernels ``_kern_pair_rows_tq`` :75 and
``_kern_pair_cols_tq`` :105): the CUDA kernel ``pair_contract_kernel`` of
``csrc/fused_pair_i8.cu``, K8a's TMA ring and ``wgmma`` with one box of
M8 or W8 a stage.
With M8 [n0, n1] the int8 observation counts, W8 [n0, n1] the statically
quantized centered values (pad cells 0) and YZ8T [C + K, n_contract] the
quantized partner table [Ypack | U] transposed (K7's layout; its last K
rows are the factors' codes), for focus mode f (0: the rows, contracting
n1; 1: the columns, contracting n0):

    PM[c, i] = sum_p M8_f[i, p] YZ8T[c, p]        [C, n_focus]
    BV[k, i] = sum_p W8_f[i, p] YZ8T[C + k, p]    [K, n_focus]

exact int32 sums (``int8_pair_ok`` bounds them below 2^31), in the packed
sampler's layout: raw, or through the dequant epilogue ``dq=(syz, sz)``
(float32 scales, alpha already folded in): Pt = PM * syz[:, None] and
b = BV * sz[:, None], float32.  Kernel and plain version agree bit for bit
in both epilogues.  The TPU kernel also computes the K "count" columns
(table rows C .. C+K-1 against M8) and slices them away; neither
version here computes them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import kernels
from ..utils import spans
from .fused_pair import int8_matmul


def _epilogue(PM, BV, dq):
    if dq is None:
        return PM, BV
    syz, sz = dq
    return (PM.to(torch.float32) * syz[:, None],
            BV.to(torch.float32) * sz[:, None])


def pair_contract_plain(M8: torch.Tensor, W8: torch.Tensor,
                        YZ8T: torch.Tensor, focus_axis: int, K: int,
                        n_focus: int,
                        dq: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                        chunk: int = 16_384):
    """The plain torch version, ``chunk`` focus rows at a time: the int8
    products on ``torch._int_mm`` on CUDA and an int64 matmul on the CPU
    (``fused_pair.int8_matmul``).  Runs on any device; returns (PM [C,
    n_focus], BV [K, n_focus]) int32 or, with ``dq``, (Pt, b) float32 of
    the same shapes."""
    pair_contract_plain.calls += 1
    C = YZ8T.shape[0] - K
    Y8, Z8 = YZ8T[:C], YZ8T[C:]
    dev = M8.device
    PM = torch.empty((C, n_focus), dtype=torch.int32, device=dev)
    BV = torch.empty((K, n_focus), dtype=torch.int32, device=dev)
    for r0 in range(0, n_focus, chunk):
        r1 = min(r0 + chunk, n_focus)
        if focus_axis == 0:
            m, w = M8[r0:r1].mT, W8[r0:r1].mT
        else:
            m, w = M8[:, r0:r1], W8[:, r0:r1]
        PM[:, r0:r1] = int8_matmul(Y8, m)
        BV[:, r0:r1] = int8_matmul(Z8, w)
    return _epilogue(PM, BV, dq)


pair_contract_plain.calls = 0
spans.counter(pair_contract_plain, "calls")


def pair_contract(M8: torch.Tensor, W8: torch.Tensor, YZ8T: torch.Tensor,
                  focus_axis: int, K: int, n_focus: int,
                  dq: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """The contraction of focus mode ``focus_axis`` for its first
    ``n_focus`` rows: M8 and W8 [n0, n1] int8 (on the kernel path both
    extents multiples of 16 and every base 16-byte aligned, as the
    kernel's TMA maps need), YZ8T [C + K, n_contract] int8 with n_contract
    the store's other extent, ``dq`` the scales (syz [C], sz [K]); outputs
    as ``pair_contract_plain``.

    CPU tensors run the plain version; CUDA tensors launch the kernel on
    the current stream or raise — there is no fallback.
    ``pair_contract.launches`` counts the launches."""
    if M8.device.type == "cpu":
        return pair_contract_plain(M8, W8, YZ8T, focus_axis, K, n_focus, dq)
    if M8.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {M8.device}")
    if focus_axis not in (0, 1):
        raise ValueError(f"focus_axis must be 0 or 1, got {focus_axis}")
    n0, n1 = M8.shape
    C = YZ8T.shape[0] - K
    n_contract = (n1, n0)[focus_axis]
    for name, t in (("M8", M8), ("W8", W8)):
        if (t.dtype != torch.int8 or tuple(t.shape) != (n0, n1)
                or not t.is_contiguous() or t.device != M8.device):
            raise ValueError(f"{name} must be contiguous int8 [{n0}, {n1}] "
                             f"on {M8.device}")
    if n0 % 16 or n1 % 16:
        raise ValueError(f"the pair's extents must be multiples of 16, got "
                         f"{(n0, n1)}")
    if (YZ8T.dtype != torch.int8 or C != K * (K + 1) // 2
            or tuple(YZ8T.shape) != (C + K, n_contract)
            or not YZ8T.is_contiguous() or YZ8T.device != M8.device):
        raise ValueError(f"YZ8T must be contiguous int8 "
                         f"[{K * (K + 1) // 2 + K}, {n_contract}] for K={K}, "
                         f"got {YZ8T.dtype} {tuple(YZ8T.shape)}")
    if any(t.data_ptr() % 16 for t in (M8, W8, YZ8T)):
        raise ValueError("M8, W8 and YZ8T must start on 16-byte boundaries")
    if not 0 <= n_focus <= (n0, n1)[focus_axis]:
        raise ValueError(f"n_focus={n_focus} outside the stored extent")
    dev = M8.device
    if dq is None:
        outs = (torch.empty((C, n_focus), dtype=torch.int32, device=dev),
                torch.empty((K, n_focus), dtype=torch.int32, device=dev))
        ptrs = [o.data_ptr() for o in outs] + [None] * 4
    else:
        syz, sz = (t.to(torch.float32).contiguous() for t in dq)
        if tuple(syz.shape) != (C,) or tuple(sz.shape) != (K,):
            raise ValueError("dq scales must be [C] and [K]")
        outs = (torch.empty((C, n_focus), dtype=torch.float32, device=dev),
                torch.empty((K, n_focus), dtype=torch.float32, device=dev))
        ptrs = [None, None, syz.data_ptr(), sz.data_ptr()] + [
            o.data_ptr() for o in outs]
    lib = kernels.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.bdf_pair_contract_i8(M8.data_ptr(), W8.data_ptr(), n0, n1,
                                      focus_axis, YZ8T.data_ptr(), C, K,
                                      n_focus, int(dq is not None), *ptrs,
                                      stream)
    if rc != 0:
        raise RuntimeError(f"pair contraction kernel launch failed: CUDA "
                           f"error {rc}")
    pair_contract.launches += 1
    return outs


pair_contract.launches = 0
spans.counter(pair_contract, "launches")
