"""The fused path's per-sweep partner quantization (K7): the packed-triangle
table [Ypack | U] of the partner factors, quantized per column to int8.

Port of ``bayesiandatafusion_jl_tpu/ops/pallas_ytab.py``
``ytab_quantize_pallas`` :125 (TPU kernels ``_kern_colmax`` :81 and
``_kern_quant`` :99), the CUDA kernel ``csrc/ytab_quantize.cu``.  For U
[n, K] and the table T = [U[:, iu] * U[:, ju] | U] ([n, C + K], C =
K(K+1)/2 in ``np.triu_indices`` order) it returns the codes
clip(rint(T / s), +-127) as int8 and the scales s = max(max_{p < n_valid}
|T[p]| / 127, tiny) — ``_quantize_cols`` of the JAX package, bit for bit.

The codes come transposed, YZ8T [C + K, out_rows]: contiguous along the
partner rows, the contraction axis of the fused contraction (K8), which
takes both its int8 operands that way.  Rows past n are zeros.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import kernels
from ..utils import spans
from . import dense_gram as dg

# the kernel's K range: the largest rank the engine runs (its quant block
# stages K + 1 factor columns of a 128-row tile in shared memory)
K7_MAX_K = 128
# copies of the column maxima the kernel merges its blocks into
# (``COPIES`` in csrc/ytab_quantize.cu)
COLMAX_COPIES = 8


def _out_rows(n: int, out_rows: Optional[int]) -> int:
    if out_rows is not None and out_rows < n:
        raise ValueError(f"out_rows={out_rows} < n={n}")
    return n if out_rows is None else int(out_rows)


def ytab_quantize_plain(U: torch.Tensor, n_valid: Optional[int] = None,
                        out_rows: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain torch version: the float32 table made whole, per-column
    scales over its first ``n_valid`` rows, ``q8``.  Runs on any device;
    returns (YZ8T [C + K, out_rows] int8, s [C + K] float32)."""
    ytab_quantize_plain.calls += 1
    n, K = U.shape
    iu, ju, _ = dg.tri_maps(K)
    Uf = U.to(torch.float32)
    T = torch.cat([Uf[:, torch.from_numpy(iu).long().to(U.device)]
                   * Uf[:, torch.from_numpy(ju).long().to(U.device)], Uf], 1)
    nv = n if n_valid is None else n_valid
    s = torch.clamp_min(T[:nv].abs().amax(dim=0) * dg.INV127,
                        dg.TINY)
    out = torch.zeros((T.shape[1], _out_rows(n, out_rows)), dtype=torch.int8,
                      device=U.device)
    out[:, :n] = dg.q8(T, s).mT
    return out, s


ytab_quantize_plain.calls = 0
spans.counter(ytab_quantize_plain, "calls")


def ytab_quantize(U: torch.Tensor, n_valid: Optional[int] = None,
                  out_rows: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(YZ8T [C + K, out_rows] int8, s [C + K] float32) of the partner
    factors U [n, K] (cast to float32 first), K <= 128.

    CPU tensors run the plain version; CUDA tensors launch the two passes
    of the kernel on the current stream (``ytab_quantize.launches`` counts
    calls) or raise — there is no fallback.  On the kernel path the codes
    are allocated with a row length rounded up to 16; a multiple of 16
    ``out_rows`` gives a contiguous tensor."""
    if U.device.type == "cpu":
        return ytab_quantize_plain(U, n_valid, out_rows)
    if U.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {U.device}")
    if U.dim() != 2:
        raise ValueError(f"U must be [n, K], got {tuple(U.shape)}")
    n, K = U.shape
    if not 1 <= K <= K7_MAX_K:
        raise ValueError(f"ytab kernel takes 1 <= K <= {K7_MAX_K}, got {K}")
    nv = n if n_valid is None else int(n_valid)
    if not 0 <= nv <= n:
        raise ValueError(f"n_valid={nv} outside [0, {n}]")
    rows = _out_rows(n, out_rows)
    ld = -(-rows // 16) * 16
    CK = K * (K + 1) // 2 + K
    Uf = U.to(torch.float32).contiguous()
    out = torch.empty((CK, ld), dtype=torch.int8, device=U.device)
    s = torch.empty(CK, dtype=torch.float32, device=U.device)
    # the kernel's scratch: COLMAX_COPIES copies of the column maxima
    colmax = torch.empty(COLMAX_COPIES * CK, dtype=torch.int32,
                         device=U.device)
    lib = kernels.load()
    stream = torch.cuda.current_stream(U.device).cuda_stream
    with torch.cuda.device(U.device):
        rc = lib.bdf_ytab_quantize(Uf.data_ptr(), n, nv, K, dg.INV127,
                                   colmax.data_ptr(), s.data_ptr(),
                                   out.data_ptr(), ld, stream)
    if rc != 0:
        raise RuntimeError(f"ytab kernel launch failed: CUDA error {rc}")
    ytab_quantize.launches += 1
    return (out if ld == rows else out[:, :rows]), s


ytab_quantize.launches = 0
spans.counter(ytab_quantize, "launches")
