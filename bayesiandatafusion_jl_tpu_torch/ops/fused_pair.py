"""The fused masked-pair contraction (K8): both Gramian orientations of the
fused sparse regime from one stored int8 value array V8.

Port of ``bayesiandatafusion_jl_tpu/ops/pallas_fused.py``
``fused_pair_pallas`` :345, all ten TPU kernel bodies, as two CUDA sources:

- ``csrc/fused_pair_i8.cu``, int8 operands: the ``flip_out`` kernels
  ``_kern_focus_rows_i8_t`` :127, ``_kern_focus_cols_i8_t`` :158 and the
  dequantizing ``_kern_focus_rows_i8_tq`` :182, ``_kern_focus_cols_i8_tq``
  :218 (K8a), and the natural layout ``_kern_focus_rows_i8`` :83,
  ``_kern_focus_cols_i8`` :106 (K8b);
- ``csrc/fused_pair_f.cu``, float operands: ``flip_out``
  ``_kern_focus_rows_t`` :252, ``_kern_focus_cols_t`` :280 (K8c) and the
  natural layout ``_kern_focus_rows`` :303, ``_kern_focus_cols`` :322 (K8d).

With V8 [n0, n1] (0 = unobserved) and YZT [C + K, n_contract] the partner
table transposed (contiguous along the contraction; its last K rows are
the factors ZT), for focus mode f (0: V8's rows, contracting n1; 1: V8's
columns, contracting n0):

    PM = (V8_f != 0) @ YZT.T      [n_focus, C + K]
    BV =  V8_f       @ ZT.T       [n_focus, K]

in the natural layout, or transposed ([C + K, n_focus], [K, n_focus]: the
packed sampler's layout) with ``flip_out``.

An int8 table (K7's codes) gives exact int32 sums, raw or, with
``flip_out``, through the dequant epilogue ``dq=(syz, sz)`` (float32 scales,
alpha already folded in): Pt = PM[:C] * syz[:C], PMm = PM[C:] * syz[C:],
BVf = BV * sz, float32.  The int32 sums are exact under the caller's
``fused_int8_ok`` bound, so the kernel and the plain version agree bit for
bit in every epilogue.

A float table (bfloat16, float32 or float64) casts the 0/1 mask and the
codes to its type (codes up to 127 are exact in bfloat16) and accumulates
in float32 (float64 for a float64 table); kernel and plain version differ
by the order of the sums.  On the card a bfloat16 table runs on the
tensor cores (``wgmma``); a float32 table too, as its three exact bfloat16
pieces (``split_f32``: t = h + m + l, 8 significant bits each), every
product exact in float32, three times the bfloat16 table's tensor work;
a float64 table runs on the float64 FMA units (the parity seam: float64
sums, on no planned configuration).  The plain version takes the float32
table itself.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import kernels
from ..utils import spans


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 a @ b for int8 a [m, k], b [k, n], for the plain
    versions of K6 and K8: ``torch._int_mm`` on CUDA, an int64 matmul on
    the CPU.  On CUDA the operands are zero-padded to the shapes it takes
    (m > 16, k and n multiples of 8) and handed over in the layout cuBLAS's
    int8 GEMM takes: a row-major, b column-major (a copy where b is not)."""
    if not a.is_cuda:
        return (a.to(torch.int64) @ b.to(torch.int64)).to(torch.int32)
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = max(m, 17), -(-k // 8) * 8, -(-n // 8) * 8
    if (mp, kp) != (m, k):
        a = torch.nn.functional.pad(a, (0, kp - k, 0, mp - m))
    bt = b.mT
    if (kp, np_) != (k, n):
        bt = torch.nn.functional.pad(bt, (0, kp - k, 0, np_ - n))
    return torch._int_mm(a.contiguous(), bt.contiguous().mT)[:m, :n]


def _epilogue(PM, BV, C, dq):
    if dq is None:
        return PM, BV
    syz, sz = dq
    PMf = PM.to(torch.float32) * syz[:, None]
    return (PMf[:C].contiguous(), PMf[C:].contiguous(),
            BV.to(torch.float32) * sz[:, None])


def _acc_dtype(table_dtype: torch.dtype) -> torch.dtype:
    """The dtype of the sums for a partner table of ``table_dtype``."""
    if table_dtype == torch.int8:
        return torch.int32
    if table_dtype in (torch.bfloat16, torch.float32):
        return torch.float32
    if table_dtype == torch.float64:
        return torch.float64
    raise TypeError(f"no fused contraction for a {table_dtype} partner table")


def fused_pair_plain(V8: torch.Tensor, YZT: torch.Tensor, focus_axis: int,
                     K: int, n_focus: int,
                     dq: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                     chunk: int = 16_384, flip_out: bool = True):
    """The plain torch version, ``chunk`` V8 rows at a time (the 0/1 mask
    exists one chunk at a time, never whole).  Runs on any device; returns
    (PM, BV) in ``_acc_dtype`` of the table — [C + K, n_focus] and
    [K, n_focus] with ``flip_out``, else [n_focus, C + K] and [n_focus, K]
    — or with ``dq`` (Pt [C, n_focus], PMm [K, n_focus], BVf [K, n_focus])
    float32.  A bfloat16 table is widened to float32 before the products
    (torch's bfloat16 matmul rounds its output to bfloat16)."""
    fused_pair_plain.calls += 1
    acc = _acc_dtype(YZT.dtype)
    if dq is not None and not (flip_out and acc == torch.int32):
        raise ValueError("the dq epilogue is a flip_out int8 option")
    CK = YZT.shape[0]
    C = CK - K
    n0 = V8.shape[0]
    dev = V8.device
    if acc == torch.int32:
        def operands(v):
            return (v != 0).to(torch.int8), v
        mm = int8_matmul
    else:
        YZT = YZT.to(acc)

        def operands(v):
            return (v != 0).to(acc), v.to(acc)
        mm = torch.matmul
    if focus_axis == 0:
        shapes = ((CK, n_focus), (K, n_focus)) if flip_out else (
            (n_focus, CK), (n_focus, K))
        PM, BV = (torch.empty(s, dtype=acc, device=dev) for s in shapes)
        for r0 in range(0, n_focus, chunk):
            m, v = operands(V8[r0:min(r0 + chunk, n_focus)])
            pm, bv = mm(m, YZT.mT), mm(v, YZT[C:].mT)
            if flip_out:
                PM[:, r0:r0 + chunk], BV[:, r0:r0 + chunk] = pm.mT, bv.mT
            else:
                PM[r0:r0 + chunk], BV[r0:r0 + chunk] = pm, bv
    else:
        PM = torch.zeros((n_focus, CK), dtype=acc, device=dev)
        BV = torch.zeros((n_focus, K), dtype=acc, device=dev)
        for r0 in range(0, n0, chunk):
            m, v = operands(V8[r0:r0 + chunk, :n_focus].mT.contiguous())
            yz = YZT[:, r0:r0 + chunk].contiguous()
            PM += mm(m, yz.mT)
            BV += mm(v, yz[C:].mT)
        if flip_out:
            PM, BV = PM.mT.contiguous(), BV.mT.contiguous()
    return _epilogue(PM, BV, C, dq)


fused_pair_plain.calls = 0
spans.counter(fused_pair_plain, "calls")

def split_f32_plain(T: torch.Tensor) -> torch.Tensor:
    """The three bfloat16 pieces [3, *T.shape] of the float32 ``T``, with
    h + m + l == T exactly wherever |T| >= 2^-110 (or T is 0): h is T with
    its low 16 bits cleared, m the same of T - h, l = T - h - m; each
    piece's bfloat16 is its high 16 bits (the kernel's arithmetic, so the
    two agree bit for bit)."""
    def high(x):
        return (x.view(torch.int32) & -65536).view(torch.float32)
    h = high(T)
    r = T - h
    m = high(r)
    return torch.stack([h, m, high(r - m)]).to(torch.bfloat16)


def split_f32(T: torch.Tensor) -> torch.Tensor:
    """``split_f32_plain`` of a contiguous float32 ``T``, whose element
    count is a multiple of 4 on the kernel path: the plain version on the
    CPU, the kernel (``csrc/fused_pair_f.cu`` ``split_f32_kernel``) on the
    current stream on CUDA, or raise.  ``split_f32.launches`` counts its
    launches."""
    if T.device.type == "cpu":
        return split_f32_plain(T)
    if T.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {T.device}")
    if (T.dtype != torch.float32 or not T.is_contiguous()
            or T.numel() % 4):
        raise ValueError(f"split_f32 takes a contiguous float32 tensor of "
                         f"4k elements, got {T.dtype} {tuple(T.shape)}")
    out = torch.empty((3, *T.shape), dtype=torch.bfloat16, device=T.device)
    lib = kernels.load()
    with torch.cuda.device(T.device):
        rc = lib.bdf_split_f32(T.data_ptr(), T.numel(), out.data_ptr(),
                               torch.cuda.current_stream(T.device)
                               .cuda_stream)
    if rc != 0:
        raise RuntimeError(f"split_f32 launch failed: CUDA error {rc}")
    split_f32.launches += 1
    return out


split_f32.launches = 0
spans.counter(split_f32, "launches")

# the kernel's code for each float table dtype (csrc/fused_pair_f.cu): a
# float32 table goes in as its pieces (split_f32)
_F_DTYPE = {torch.bfloat16: 0, torch.float32: 1, torch.float64: 2}


def fused_pair_contract(V8: torch.Tensor, YZT: torch.Tensor,
                        focus_axis: int, K: int, n_focus: int,
                        dq: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                        flip_out: bool = True):
    """The contraction of focus mode ``focus_axis`` for its first
    ``n_focus`` rows: V8 [n0, n1] int8 (both multiples of 16 on the kernel
    path), YZT [C + K, n_contract] int8, bfloat16, float32 or float64 with
    n_contract = V8's other extent; outputs as ``fused_pair_plain``.

    CPU tensors run the plain version; CUDA tensors launch the kernel on
    the current stream or raise — there is no fallback.  A float32 table
    is split into its bfloat16 pieces first (``split_f32``, counted
    there).
    ``fused_pair_contract.launches`` counts all launches, and
    ``launches_i8_flip`` (K8a), ``launches_i8_nat`` (K8b), ``launches_f_flip``
    (K8c) and ``launches_f_nat`` (K8d) each variant's; of the last two,
    ``launches_f32_flip`` and ``launches_f32_nat`` those on a float32
    table."""
    if V8.device.type == "cpu":
        return fused_pair_plain(V8, YZT, focus_axis, K, n_focus, dq,
                                flip_out=flip_out)
    if V8.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {V8.device}")
    if focus_axis not in (0, 1):
        raise ValueError(f"focus_axis must be 0 or 1, got {focus_axis}")
    n0, n1 = V8.shape
    CK = YZT.shape[0]
    C = CK - K
    n_contract = (n1, n0)[focus_axis]
    acc = _acc_dtype(YZT.dtype)
    int8 = acc == torch.int32
    if V8.dtype != torch.int8:
        raise TypeError("V8 must be int8")
    if dq is not None and not (flip_out and int8):
        raise ValueError("the dq epilogue is a flip_out int8 option")
    if n0 % 16 or n1 % 16 or not V8.is_contiguous():
        raise ValueError(f"V8 must be contiguous with both extents multiples "
                         f"of 16, got {tuple(V8.shape)}")
    if (C != K * (K + 1) // 2 or tuple(YZT.shape) != (CK, n_contract)
            or not YZT.is_contiguous() or YZT.device != V8.device):
        raise ValueError(f"YZT must be contiguous [{K * (K + 1) // 2 + K}, "
                         f"{n_contract}] for K={K}, got {tuple(YZT.shape)}")
    if not 0 <= n_focus <= (n0, n1)[focus_axis]:
        raise ValueError(f"n_focus={n_focus} outside the stored extent")
    dev = V8.device
    f32 = torch.float32

    def out(rows):
        shape = (rows, n_focus) if flip_out else (n_focus, rows)
        return torch.empty(shape, dtype=f32 if dq is not None else acc,
                           device=dev)
    lib = kernels.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if not int8:
        outs = (out(CK), out(K))
        table = split_f32(YZT) if YZT.dtype == torch.float32 else YZT
        with torch.cuda.device(dev):
            rc = lib.bdf_fused_pair_f(V8.data_ptr(), n0, n1, focus_axis,
                                      table.data_ptr(), _F_DTYPE[YZT.dtype],
                                      C, K, n_focus, int(not flip_out),
                                      outs[0].data_ptr(), outs[1].data_ptr(),
                                      stream)
        variant = "launches_f_flip" if flip_out else "launches_f_nat"
        if table is not YZT:
            fused_pair_contract.launches_f32_flip += flip_out
            fused_pair_contract.launches_f32_nat += not flip_out
    else:
        if dq is None:
            outs = (out(CK), out(K))
            ptrs = [o.data_ptr() for o in outs] + [None] * 5
        else:
            syz, sz = (t.to(f32).contiguous() for t in dq)
            if tuple(syz.shape) != (CK,) or tuple(sz.shape) != (K,):
                raise ValueError("dq scales must be [C + K] and [K]")
            outs = (out(C), out(K), out(K))
            ptrs = [None, None, syz.data_ptr(), sz.data_ptr()] + [
                o.data_ptr() for o in outs]
        # the kernel's epilogue code: 0 raw, 1 dq, 2 raw in the natural layout
        epilogue = 1 if dq is not None else 0 if flip_out else 2
        with torch.cuda.device(dev):
            rc = lib.bdf_fused_pair_i8(V8.data_ptr(), n0, n1, focus_axis,
                                       YZT.data_ptr(), C, K, n_focus,
                                       epilogue, *ptrs, stream)
        variant = "launches_i8_flip" if flip_out else "launches_i8_nat"
    if rc != 0:
        raise RuntimeError(f"fused pair kernel launch failed: CUDA error {rc}")
    fused_pair_contract.launches += 1
    setattr(fused_pair_contract, variant,
            getattr(fused_pair_contract, variant) + 1)
    return outs


fused_pair_contract.launches = 0
fused_pair_contract.launches_i8_flip = 0
fused_pair_contract.launches_i8_nat = 0
fused_pair_contract.launches_f_flip = 0
fused_pair_contract.launches_f_nat = 0
fused_pair_contract.launches_f32_flip = 0
fused_pair_contract.launches_f32_nat = 0
spans.counter(fused_pair_contract, "launches", "launches_i8_flip",
              "launches_i8_nat", "launches_f_flip", "launches_f_nat",
              "launches_f32_flip", "launches_f32_nat")
