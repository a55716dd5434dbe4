"""Dense int8 pair Gramian for 2-ary relations.

Port of the s8 pair path of ``bayesiandatafusion_jl_tpu/ops/dense_gram.py``:
the host side (``int8_pair_ok`` :1073, and the store that
``build_dense_pair`` :263 and ``quantize_dense_pair`` :1114 make, built
over the observed cells only) and the per-sweep side (``_tri_maps``,
``_quantize_cols``, ``_floor_scale``, ``_q8`` and the s8 branch of
``dense_gram_contrib`` :1319-1430 for arity 2: packed in the transposed
[C, N] layout, or unpacked to [N, K, K]).

Per sweep and per focus mode, with the stored int8 observation counts M8
and statically quantized centered values W8 (both [N_focus, N_partner]),

    P[c, n] = sum_p M8[n, p] Y8[c, p] * sY[c] * alpha  (+ PD ridge on c = (i, i))
    b[k, n] = sum_p W8[n, p] U8[k, p] * sU[k] * w_scale * alpha

where Y = U[:, iu] * U[:, ju] is the partners' packed triangle table and
Y8/U8 are its and U's per-row int8 quantizations.  The int8 x int8 ->
int32 products are exact (``int8_pair_ok`` bounds them below 2^31) and run
on ``torch._int_mm``, as the JAX package leaves them to an XLA einsum.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

INV127 = float(np.float32(1.0 / 127.0))
_TINY = float(np.finfo(np.float32).tiny)
# the stored pair's dims are padded to this multiple: torch._int_mm on CUDA
# needs the contraction and output widths to be multiples of 8; the pad
# cells are exact zeros, so every output on the pad extent is 0
STORE_ALIGN = 16


def tri_maps(K: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(iu, ju, expand): the packed upper triangle's (row, col) pairs in
    ``np.triu_indices`` order, and the packed index of every flat [K*K]
    position (symmetric lookup)."""
    iu, ju = np.triu_indices(K)
    tri_of = np.zeros((K, K), np.int32)
    tri_of[iu, ju] = np.arange(len(iu), dtype=np.int32)
    tri_of = np.maximum(tri_of, tri_of.T)
    return iu.astype(np.int32), ju.astype(np.int32), tri_of.reshape(-1)


# ---------------------------------------------------------------------------
# host side (numpy)
# ---------------------------------------------------------------------------

def int8_pair_ok(idx: np.ndarray, shape: Sequence[int]) -> bool:
    """int8 eligibility from the observation index alone: every cell's
    multiplicity fits int8, and no int32 dot along the contracted (largest
    partner) axis can overflow 127 * 127 * fiber length."""
    arity = idx.shape[1]
    dims = [int(s) for s in shape]

    def max_mult(cols):
        if not cols:
            return idx.shape[0]
        lin = np.zeros(idx.shape[0], np.int64)
        for d in cols:
            lin = lin * dims[d] + idx[:, d].astype(np.int64)
        if lin.size == 0:
            return 0
        _, c = np.unique(lin, return_counts=True)
        return int(c.max())

    if max_mult(list(range(arity))) > 127:
        return False
    deg_cap = (2**31) / (127.0 * 127.0)
    for mode in range(arity):
        parts = [d for d in range(arity) if d != mode]
        big = parts[int(np.argmax([dims[d] for d in parts]))]
        if max_mult([d for d in range(arity) if d != big]) >= deg_cap:
            return False
    return True


def _w_scale(w_max: float) -> float:
    return (w_max / 127.0) or 1.0


def _quantize_values(W: np.ndarray, w_scale: float) -> np.ndarray:
    """clip(rint(W / w_scale), +-127) in W's dtype (round half to even)."""
    q = np.rint(W / np.asarray(w_scale, W.dtype))
    return np.clip(q, -127, 127).astype(np.int8)


def build_int8_pair(idx: np.ndarray, centered: np.ndarray,
                    shape: Sequence[int], store_dtype, device
                    ) -> Dict[str, object]:
    """The stored int8 pair of one 2-ary relation, on ``device``.

    Returns ``{"M8": [M0, M1], "W8": [W0, W1], "deg": [d0, d1],
    "w_scale": float, "shape": (N0, N1)}`` where M{f}/W{f} hold the pair
    with focus mode f's axis leading — [N_f, N_partner], padded to
    STORE_ALIGN, partner axis contiguous (the contraction axis of both of
    f's products) — d{f} the observation count of every (padded) focus row,
    for the PD ridge, and ``shape`` the true (unpadded) extents.

    The JAX package accumulates dense [N0, N1] host arrays (counts, and
    centered values in ``store_dtype``'s accumulator) and quantizes W on one
    static scale max|W| / 127.  Here the same sums are taken over the
    observed cells only — ``np.add.at`` adds each cell's values in order of
    appearance, as the dense accumulation does — and the cells' codes are
    scattered into zeroed device arrays, so the bytes are the same.
    """
    n = [int(s) for s in shape]
    pad = [-(-s // STORE_ALIGN) * STORE_ALIGN for s in n]
    acc = np.float64 if np.dtype(store_dtype) == np.float64 else np.float32
    lin = idx[:, 0].astype(np.int64) * n[1] + idx[:, 1].astype(np.int64)
    cells, inv = np.unique(lin, return_inverse=True)
    count = np.bincount(inv, minlength=cells.size)
    if count.max(initial=0) > 127:
        raise ValueError("observation counts exceed int8 "
                         "(int8_pair_ok not consulted)")
    wsum = np.zeros(cells.size, acc)
    np.add.at(wsum, inv, np.asarray(centered, acc))
    w_scale = _w_scale(float(np.abs(wsum).max(initial=0.0)))
    codes = [torch.from_numpy(a).to(device) for a in
             (count.astype(np.int8), _quantize_values(wsum, w_scale))]
    rows = [torch.from_numpy(a).to(device)
            for a in (cells // n[1], cells % n[1])]
    M8, W8 = [], []
    for f in range(2):
        for out, v in zip((M8, W8), codes):
            t = torch.zeros((pad[f], pad[1 - f]), dtype=torch.int8,
                            device=device)
            t[rows[f], rows[1 - f]] = v
            out.append(t)
    deg = [torch.from_numpy(np.bincount(idx[:, f], minlength=pad[f])
                            .astype(np.float32)).to(device)
           for f in range(2)]
    return {"M8": M8, "W8": W8, "deg": deg, "w_scale": float(w_scale),
            "shape": tuple(n)}


def tri_index(K: int, device) -> Tuple[torch.Tensor, ...]:
    """(iu, ju, diag, expand) as index tensors on ``device``: ``tri_maps``'
    triangle pairs and expand index, and the packed positions of the K
    diagonal entries."""
    iu, ju, expand = tri_maps(K)
    dc = np.nonzero(iu == ju)[0]
    return tuple(torch.from_numpy(a.astype(np.int64)).to(device)
                 for a in (iu, ju, dc, expand))


# ---------------------------------------------------------------------------
# per sweep (torch)
# ---------------------------------------------------------------------------

def q8(A: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 quantization of A against scales s (broadcast):
    clip(round_half_even(A / s), +-127)."""
    return torch.clamp(torch.round(A / s), -127.0, 127.0).to(torch.int8)


def quantize_rows(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 quantization of a float32 table A [R, n]: scales
    s = max(max_p |A[r, p]| / 127, tiny) and codes round(A / s)."""
    s = torch.clamp_min(A.abs().amax(dim=1) * INV127, _TINY)
    return q8(A, s[:, None]), s


def ridge_step(s: torch.Tensor, K: int) -> torch.Tensor:
    """The PD ridge's float32 step mean(s) * sqrt(K) / 2 from the row
    scales s, with 1/len(s) and sqrt(K)/2 folded into one float32 factor
    as XLA folds them in the JAX engine's compiled sweep."""
    c = (torch.tensor(1.0 / s.numel(), dtype=torch.float32)
         * torch.tensor(0.5 * float(np.sqrt(K)), dtype=torch.float32))
    return s.sum() * c


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 a @ b for int8 a [m, k], b [k, n] (``torch._int_mm``;
    on CUDA it needs m > 16, so a short ``a`` is zero-padded)."""
    m = a.shape[0]
    if a.is_cuda and m <= 16:
        a = torch.cat([a, a.new_zeros((24 - m, a.shape[1]))])
        return torch._int_mm(a, b)[:m]
    return torch._int_mm(a, b)


def _dequant(S: torch.Tensor, s: torch.Tensor, extra: float,
             alpha: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """S [R, n] int32 -> out_dtype, times the per-row scale: the float32
    product s * extra cast to out_dtype, then times alpha."""
    scale = (s * torch.tensor(extra, dtype=torch.float32)).to(out_dtype)
    scale = scale * alpha.to(out_dtype)
    return S.to(out_dtype) * scale[:, None]


def dense_gram_contrib(pair: Dict[str, object], tri, partner: torch.Tensor,
                       mode: int, alpha: torch.Tensor,
                       out_dtype: torch.dtype, packed: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One focus mode's alpha-folded contribution.  ``packed=True``, the
    packed samplers' layout: P [K(K+1)/2, N_f_stored] (packed triangle, PD
    ridge included) and b [K, N_f_stored]; columns past the true N_f are
    zero.  ``packed=False``, the full-P sampler's: P [N_f, K, K] and
    b [N_f, K], pads stripped, P expanded through ``tri_maps``' index (the
    same numbers as the packed layout; JAX dense_gram.py:1418-1430).

    ``pair`` is ``build_int8_pair``'s store, ``tri`` = ``tri_index(K)``,
    ``partner`` the other entity's factors [N_partner, K].  The partners
    are cast to float32 before the table and the quantization whatever
    ``out_dtype`` is, as in the JAX package.
    """
    Mf, Wf = pair["M8"][mode], pair["W8"][mode]
    n_pp = Mf.shape[1]
    K = partner.shape[1]
    iu, ju, dc, expand = tri
    U = partner.to(torch.float32)
    if U.shape[0] < n_pp:
        U = torch.cat([U, U.new_zeros((n_pp - U.shape[0], K))])
    UT = U.mT.contiguous()                            # [K, n_pp]
    Y8, sY = quantize_rows(UT[iu] * UT[ju])           # [C, n_pp]
    U8, sU = quantize_rows(UT)
    alpha = alpha.to(out_dtype)
    P = _dequant(int8_matmul(Y8, Mf.mT), sY, 1.0, alpha, out_dtype)
    # PD safety ridge (JAX dense_gram.py:1391-1414): ~1.7 sigma of the
    # per-row quantization noise, mean(sY) * sqrt(K) / 2 * alpha * sqrt(deg),
    # on the diagonal entries
    step = ridge_step(sY, K).to(out_dtype) * alpha
    rdeg = torch.sqrt(pair["deg"][mode]).to(out_dtype)
    P[dc] += (rdeg * step)[None, :]
    b = _dequant(int8_matmul(U8, Wf.mT), sU, pair["w_scale"], alpha,
                 out_dtype)
    if packed:
        return P, b
    n = pair["shape"][mode]
    Pt = P[:, :n].mT.contiguous()                     # [n, C]
    del P     # free the packed copy before the expand allocates [n, K*K]
    return Pt[:, expand].view(n, K, K), b[:, :n].mT
