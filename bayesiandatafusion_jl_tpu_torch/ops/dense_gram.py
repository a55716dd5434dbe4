"""Dense Gramians: the int8 pair and the float pair of a relation of any
arity, and the fused single array of a 2-ary one.

Port of the dense paths of ``bayesiandatafusion_jl_tpu/ops/dense_gram.py``.

The planner (JAX :47-239): ``estimate_times``, ``plan_dense_modes`` and
``plan_fused_rels`` decide, from relation statistics and a byte budget,
which (relation, mode) contracts against a dense store and which rides the
gather path, on constants measured on the card.

The pairs: the host side (``int8_pair_ok`` :1073, and the stores that
``build_dense_pair`` :263 and ``quantize_dense_pair`` :1114 make, built
over the observed cells only) and the per-sweep side
(``dense_gram_contrib`` :1236).  One stored pair per relation, M the
observation counts and W the sums of the centered values; arity 2 keeps
[N0, N1] and contracts it along either axis; arity 3 and up keeps its
modes in ``store_order`` (the largest first, the second largest last, the
rest between).  The outputs are packed in the transposed [C, N] layout
(C = K(K+1)/2) or unpacked to [N, K, K].

The int8 pair (the s8 branch, :1319-1430): M8 the counts, W8 the values
quantized on one static scale w_scale = max|W| / 127.  Per sweep and per
focus mode f of a 2-ary relation, against the partner factors' table
quantized per row (``fused_quantize``: K7 up to K = 128, torch ops above),

    P[c, n] = sum_p M8_f[n, p] Y8[c, p] * sY[c] * alpha  (+ PD ridge on c = (i, i))
    b[k, n] = sum_p W8_f[n, p] U8[k, p] * sU[k] * w_scale * alpha

where Y = U[:, iu] * U[:, ju] is the partners' packed triangle table and
Y8/U8 are its and U's per-row int8 quantizations.  The int8 x int8 ->
int32 products are exact (``int8_pair_ok`` bounds them below 2^31) and run
on K6 (``ops/pair_contract.py``), which reads the one store along either
axis, with the dequant in its epilogue (float32) or after it (float64).
At arity 3 and up that is the first of two steps: the largest partner (the
first or the last store axis) contracted on K6 with the store read as a 2-D
array, then the dequantized sums reduced against the other partners'
float tables in one einsum (the Hadamard context factorizes:
(z o w)(z o w)^T = zz^T o ww^T, and the packed triangle commutes with it).

The float pair (the float branch, :1431-1463): M and W in the store dtype
(bfloat16 under ``gram_dtype="bfloat16"``, else the compute dtype), and per
sweep P = M_f Ypack and b = W_f U with the tables in the same dtype, on
``torch.matmul`` (and ``torch.einsum`` for the smaller partners of a
tensor) as the JAX package leaves them to an XLA einsum, alpha multiplied
in afterwards.

The fused sparse regime (the second half of this file, JAX :336-1070):
one stored int8 array V8 of value codes e, v = s (e + m) at the observed
cells and 0 elsewhere, from which both modes' Gramians are contracted with
the observation mask derived on the fly (K8, ``ops/fused_pair.py``):

    P = (V8 != 0) @ Ypack,   b = s (V8 @ U) + (s m - mean) ((V8 != 0) @ U)

against the per-sweep quantized partner table (K7, ``ops/ytab.py``;
``fused_gram_contrib_i8``, exact int32 sums) or, for a relation off the s8
path, against the float table (``fused_gram_contrib``).  Half the int8
pair's bytes, and no value quantization: the encoding is exact (or within
``dense_fused_tol``), and what it cannot hold (a cell's second
observation, the zero-code level) is left to the gather path as a
residual (``fused_pair_plan``'s keep mask).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.spans import span
from . import fused_pair
from .pair_contract import pair_contract

INV127 = float(np.float32(1.0 / 127.0))
TINY = float(np.finfo(np.float32).tiny)
# the int8 stores' extents are padded to this multiple: K6 and K8 load
# 16-byte rows of the store and of the partner table along the
# contraction; the pad cells are exact zeros, so they add nothing
STORE_ALIGN = 16
# elements of one widened slice of a bfloat16 float pair (256 MB in float32)
_WIDEN_ELEMS = 1 << 26


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
# the planner (host side): which Gramian path each (relation, mode) takes
# ---------------------------------------------------------------------------

# The planner's machine constants, measured on one NVIDIA H100 80GB HBM3 at
# a 700 W limit by chip_smoke.py, which prints them as each run measures
# them (PERF.md §6).  They only steer the choice between paths that give
# the same numbers.  The JAX package's are a TPU's: its one matmul rate
# (``_MXU_FLOPS`` 3e14) stands here for the two pair paths and its fused
# one (``_BF16_FLOPS`` 1.1e14) for the three fused rates, because on the
# card each path runs at a rate of its own.  The rates are the ones that
# make ``estimate_times`` give the kernel's measured time of one mode.
_GATHER_S_PER_OBS = 1.2e-9    # the gather path's sweep outside the sampler
                              # per observation and mode (ML-10M, K = 32)
_PAIR_I8_OPS = 8.3e14         # K6 on the int8 pair (ML-10M, K = 32)
_PAIR_FLOAT_FLOPS = 4.2e13    # the float32 pair's torch.matmul (ditto)
_FUSED_S8_OPS = 7.0e14        # K8a, the fused store's s8 kernel (Netflix)
_FUSED_FLOAT_FLOPS = 3.9e14   # K8c with a bfloat16 table (Netflix)
_FUSED_F32_FLOPS = 1.8e14     # K8c with a float32 table, its three
                              # bfloat16 pieces (Netflix)
_HBM_BPS = 3.35e12            # the card's memory rate (data sheet)
# below this many observations a relation stays on the gather path unless
# a flag forces a dense one (the JAX package's floor, kept so that small
# problems take the same path in both packages)
_AUTO_MIN_NNZ = 50_000


class DenseModePlan:
    """How one (relation, mode) contracts against a dense store (JAX
    ``DenseModePlan`` :61).

    kind: "canonical" — the relation's one stored pair, shared by its modes
          "copy"      — a focus-leading copy of the pair for this mode (a
                        sharded engine: each mode's pair sharded by its own
                        focus axis; ``plan_dense_modes(per_mode_pairs=True)``)
          "fused"     — the relation's fused store (``plan_fused_rels``)
    """

    def __init__(self, kind: str, n_focus: int,
                 partner_counts: Tuple[int, ...]):
        self.kind = kind
        self.n_focus = n_focus
        self.partner_counts = partner_counts


def estimate_times(n_focus: int, np_comb: int, nnz: int, K: int,
                   itemsize: int, mxu_rate: Optional[float] = None
                   ) -> Tuple[float, float]:
    """(dense_seconds, gather_seconds) of one mode's update (JAX
    ``estimate_times`` :78).  The dense contraction touches every cell once
    against the K(K+1)/2-column packed triangle at ``mxu_rate`` (None: the
    pair's, K6's for an int8 store and the float matmul's otherwise), or
    streams M once if that is slower, then streams W once more.  The gather
    path costs ``_GATHER_S_PER_OBS`` an observation at K = 32, scaled by
    (K / 32)^2 above it."""
    if mxu_rate is None:
        mxu_rate = _PAIR_I8_OPS if itemsize == 1 else _PAIR_FLOAT_FLOPS
    flops = 2.0 * n_focus * np_comb * (K * (K + 1) // 2)
    bytes_mw = n_focus * np_comb * itemsize                # each of M, W
    dense = (max(flops / mxu_rate, bytes_mw / _HBM_BPS)
             + bytes_mw / _HBM_BPS)
    gather = nnz * _GATHER_S_PER_OBS * max(1.0, (K / 32.0) ** 2)
    return dense, gather


def _declined(what: str, need: float, budget_bytes: float) -> None:
    """The stderr line of a dense store the budget declines (no silent
    caps: the relation's modes then ride the much slower gather path)."""
    import sys
    print(f"# dense_gram: {what} declined by budget ({need / 1e9:.2f} GB > "
          f"{budget_bytes / 1e9:.2f} GB) — gather path", file=sys.stderr)


def plan_dense_modes(shapes: Sequence[Tuple[int, ...]], nnzs: Sequence[int],
                     K: int, dense_gram: Optional[bool], budget_bytes: float,
                     itemsize, per_mode_pairs: bool = False):
    """Which (relation, mode) pairs run dense (JAX ``plan_dense_modes``
    :101), from relation statistics alone: true extents, observation
    counts, K, the pair's itemsize (an int, or one per relation: 1 for an
    int8 pair) and the byte budget.

    ``dense_gram=False`` plans nothing; True every mode of every relation
    with observations; None those whose dense time is predicted below 0.7
    x the gather path's (``estimate_times``), from ``_AUTO_MIN_NNZ``
    observations.  The candidates are taken greedily by predicted saving
    while their stores fit ``budget_bytes``: the pair (M and W) charged
    once per relation ("canonical"), or once per mode with
    ``per_mode_pairs`` ("copy", for a sharded engine).  A declined mode
    prints a line on stderr.

    Returns (plans: {(ri, mode): DenseModePlan}, the set of relations
    that store the canonical pair, the list of (ri, mode) that store a
    copy)."""
    plans: Dict[Tuple[int, int], DenseModePlan] = {}
    canonical: set = set()
    copies = []
    if dense_gram is False:
        return plans, canonical, copies

    def its_of(ri):
        return itemsize if np.isscalar(itemsize) else itemsize[ri]
    spent = 0.0
    cands = []
    for ri, shape in enumerate(shapes):
        nnz = nnzs[ri]
        if nnz == 0 or (dense_gram is None and nnz < _AUTO_MIN_NNZ):
            continue
        its = its_of(ri)
        total = int(np.prod([int(s) for s in shape], dtype=np.int64))
        for mode in range(len(shape)):
            n_focus = int(shape[mode])
            dense_t, gather_t = estimate_times(n_focus, total // n_focus,
                                               nnz, K, its)
            if dense_gram is None and dense_t > 0.7 * gather_t:
                continue
            cands.append((gather_t - dense_t, ri, mode, total))
    # greedy by predicted saving (stable on ties), within the budget
    cands.sort(key=lambda c: -c[0])
    for _, ri, mode, total in cands:
        pair_bytes = 2.0 * total * its_of(ri)           # M + W
        need = pair_bytes if (per_mode_pairs or ri not in canonical) else 0.0
        if spent + need > budget_bytes:
            _declined(f"relation {ri} mode {mode}", spent + need,
                      budget_bytes)
            continue
        spent += need
        if per_mode_pairs:
            copies.append((ri, mode))
        else:
            canonical.add(ri)
        shape = shapes[ri]
        plans[(ri, mode)] = DenseModePlan(
            "copy" if per_mode_pairs else "canonical", int(shape[mode]),
            tuple(int(s) for d, s in enumerate(shape) if d != mode))
    return plans, canonical, copies


def plan_fused_rels(shapes: Sequence[Tuple[int, ...]], nnzs: Sequence[int],
                    K: int, dense_gram: Optional[bool],
                    dense_fused: Optional[bool], fused_enc: Sequence,
                    pair_itemsize: Sequence[int], budget_bytes: float):
    """The relations that take the fused single-array store (JAX
    ``plan_fused_rels`` :183), from relation statistics alone.

    ``dense_fused=True`` takes every 2-ary relation with an encoding
    (``fused_enc[ri]``, ``fused_pair_plan``'s (s, m), or None); None takes
    one from ``_AUTO_MIN_NNZ`` observations whose pair (at
    ``pair_itemsize``) does not fit ``budget_bytes`` and whose dense
    contraction is predicted below 0.7 x the gather path's in both modes
    (K8a's rate where the pair would be int8, K8c's with a float32 table
    where it would be float32, K8c's bfloat16 one otherwise); False, or
    ``dense_gram=False``, takes none.  Each store (one byte a cell) must
    fit what is left of the budget, else a line on stderr.  The
    encoding and the itemsize are read only where the rule needs them, so
    ``fused_enc`` and ``pair_itemsize`` may compute them on demand.

    Returns ({ri: (s, m)}, the bytes the stores take)."""
    out = {}
    spent = 0.0
    if dense_fused is False or dense_gram is False:
        return out, spent
    for ri, shape in enumerate(shapes):
        nnz = nnzs[ri]
        if len(shape) != 2 or (dense_fused is None
                               and nnz < _AUTO_MIN_NNZ):
            continue
        total = float(int(shape[0]) * int(shape[1]))
        if dense_fused is None:
            its = pair_itemsize[ri]
            if 2.0 * total * its <= budget_bytes:
                continue                # the pair fits: it is the faster
            rate = (_FUSED_S8_OPS if its == 1 else _FUSED_F32_FLOPS
                    if its == 4 else _FUSED_FLOAT_FLOPS)
            if not all(d < 0.7 * g for d, g in (
                    estimate_times(int(shape[m]), int(shape[1 - m]), nnz, K,
                                   1, mxu_rate=rate) for m in range(2))):
                continue
        enc = fused_enc[ri]
        if enc is None:
            continue
        if spent + total > budget_bytes:
            _declined(f"relation {ri} fused path", spent + total,
                      budget_bytes)
            continue
        out[ri] = enc
        spent += total
    return out, spent


# ---------------------------------------------------------------------------
# host side (numpy)
# ---------------------------------------------------------------------------

# The constants of the dense-versus-bucketed choice of the side features'
# operand (the JAX package's ``use_dense_feat`` rule; its values, 7e11 and
# 6.2e-9, are a TPU's), measured on one NVIDIA H100 80GB HBM3 at a 700 W
# limit by chip_smoke.py (``print_feat_readout``) at ChEMBL's shape (15,000
# x 32,000 binary, 600,534 stored, K = 32): the rate that makes
# n f itemsize / rate one pass of the dense float32 X (the rule's itemsize
# is the JAX operand's, 1 byte there), and one bucketed pass a stored
# feature.  On the card the bucketed matvec wins at that shape (1.37 ms
# against 2.35 ms for the two passes, PERF.md §6).
_FEAT_HBM_BPS = 4.1e11
_SPMM_S_PER_NNZ = 1.14e-9


def feat_itemsize(is_binary: bool, gram_dtype: Optional[str],
                  dtype) -> int:
    """The bytes per cell of the JAX package's dense feature operand, which
    its ``use_dense_feat`` decides on: int8 for binary features under
    ``gram_dtype="bfloat16"``, else the compute dtype's."""
    if is_binary and gram_dtype == "bfloat16":
        return 1
    return np.dtype(dtype).itemsize


def use_dense_feat(n: int, f: int, nnz: int, itemsize: int,
                   dense_gram: Optional[bool]) -> bool:
    """A dense [N, F] feature operand for the beta products, instead of
    the bucketed sparse matvec (JAX ``dense_gram.use_dense_feat`` :242)?
    Never under ``dense_gram=False`` or above 2 GB at ``itemsize``; always
    under True; under None when two streams of the dense operand are
    predicted faster than 0.7 x two bucketed passes (from 50,000 nnz)."""
    bytes_x = float(n) * f * itemsize
    if dense_gram is False or bytes_x > 2e9:
        return False
    if dense_gram is None:
        if nnz < _AUTO_MIN_NNZ:
            return False
        return (2.0 * bytes_x / _FEAT_HBM_BPS
                < 0.7 * 2.0 * nnz * _SPMM_S_PER_NNZ)
    return True


def int8_pair_ok(idx: np.ndarray, shape: Sequence[int]) -> bool:
    """int8 eligibility from the observation index alone: every cell's
    multiplicity fits int8, and no int32 dot along the contracted (largest
    partner) axis can overflow 127 * 127 * fiber length."""
    arity = idx.shape[1]
    dims = [int(s) for s in shape]
    seen = {}

    def max_mult(cols):
        if not cols:
            return idx.shape[0]
        if len(cols) == 1:          # one column: a count, not a sort
            return int(np.bincount(idx[:, cols[0]]).max(initial=0))
        if tuple(cols) not in seen:     # two focus modes share a column set
            lin = np.zeros(idx.shape[0], np.int64)
            for d in cols:
                lin = lin * dims[d] + idx[:, d].astype(np.int64)
            seen[tuple(cols)] = (0 if lin.size == 0 else int(
                np.unique(lin, return_counts=True)[1].max()))
        return seen[tuple(cols)]

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


def store_order(shape: Sequence[int]) -> Tuple[int, ...]:
    """The relation's modes in the order its pair store keeps them.

    Arity 2: as they are.  Arity >= 3: the largest extent first (``a``,
    the first of the largest), the largest of the others last (``b``), the
    rest between in mode order.  The s8 contraction's first step takes the
    largest partner of the focus mode (``int8_pair_ok`` and JAX
    ``dense_gram_contrib`` :1340-1346, by true extents, first on ties):
    ``b`` for focus ``a``, ``a`` for every other focus.  So it is always
    the trailing or the leading store axis, and the store read as a 2-D
    array [(a, ...), b] or [a, (..., b)] hands it to K6 as mode 0 or 1."""
    dims = [int(d) for d in shape]
    if len(dims) == 2:
        return (0, 1)
    a = int(np.argmax(dims))
    rest = [d for d in range(len(dims)) if d != a]
    b = rest[int(np.argmax([dims[d] for d in rest]))]
    return (a, *[d for d in rest if d != b], b)


def big_partner(shape: Sequence[int], mode: int) -> int:
    """The partner mode that the s8 contraction's first step takes for
    focus ``mode``: the largest, the first of the largest on ties."""
    parts = [d for d in range(len(shape)) if d != mode]
    return parts[int(np.argmax([int(shape[d]) for d in parts]))]


def _observed_cells(idx: np.ndarray, centered: np.ndarray,
                    order: Sequence[int], extents: Sequence[int], acc):
    """(cells, count, wsum) over the observed cells of a relation, each
    cell once: its flat index in a store whose axes are the modes
    ``order`` with ``extents``, its observation count and the sum of its
    centered values in ``acc``, added in order of appearance
    (``np.add.at``), as the JAX package's dense accumulation adds them."""
    lin = np.zeros(idx.shape[0], np.int64)
    for d, n in zip(order, extents):
        lin = lin * int(n) + idx[:, d].astype(np.int64)
    cells, inv = np.unique(lin, return_inverse=True)
    count = np.bincount(inv, minlength=cells.size)
    wsum = np.zeros(cells.size, acc)
    np.add.at(wsum, inv, np.asarray(centered, acc))
    return cells, count, wsum


def _scatter(extents, cells, values, dtype, device) -> torch.Tensor:
    """A zeroed array of ``extents`` on ``device`` with ``values`` (cast to
    ``dtype`` there) at the flat indices ``cells``."""
    t = torch.zeros(tuple(int(n) for n in extents), dtype=dtype,
                    device=device)
    t.view(-1)[torch.from_numpy(cells).to(device)] = \
        torch.from_numpy(values).to(device).to(dtype)
    return t


def build_int8_pair(idx: np.ndarray, centered: np.ndarray,
                    shape: Sequence[int], store_dtype, device,
                    order: Optional[Sequence[int]] = None,
                    w_scale: Optional[float] = None) -> Dict[str, object]:
    """The stored int8 pair of one relation, on ``device``.

    Returns ``{"M8": M8, "W8": W8, "deg": [d_0, ...], "w_scale": float,
    "shape": (N_0, ...), "order": store_order(shape)}``: the counts and the
    quantized values, one array each with the modes in ``order`` (arity 2:
    [N0p, N1p]; arity 3 and up: [N_a p, ..., N_b p]), the first and the last
    extent padded to STORE_ALIGN with zero cells, stored once (K6
    contracts along either end); d_f the observation count of every
    (stored) row of mode f, for the PD ridge; ``shape`` the true extents in
    mode order.

    The JAX package accumulates dense host arrays (counts, and centered
    values in ``store_dtype``'s accumulator) and quantizes W on one static
    scale max|W| / 127.  Here the same sums are taken over the observed
    cells only and the cells' codes are scattered into zeroed device
    arrays, so the bytes are the same.

    ``order`` overrides ``store_order(shape)`` and ``w_scale`` the scale
    of these observations' cells: a sharded engine stores one rank's rows
    of a relation, focus first, on the scale of the whole relation
    (``pair_w_scale``), as the JAX package quantizes the whole pair before
    cutting it into slabs (sharded.py:361-365).
    """
    n = [int(s) for s in shape]
    order = store_order(n) if order is None else tuple(order)
    extents = [n[d] for d in order]
    extents[0] = -(-extents[0] // STORE_ALIGN) * STORE_ALIGN
    extents[-1] = -(-extents[-1] // STORE_ALIGN) * STORE_ALIGN
    stored = dict(zip(order, extents))
    acc = np.float64 if np.dtype(store_dtype) == np.float64 else np.float32
    cells, count, wsum = _observed_cells(idx, centered, order, extents, acc)
    if count.max(initial=0) > 127:
        raise ValueError("observation counts exceed int8 "
                         "(int8_pair_ok not consulted)")
    if w_scale is None:
        w_scale = _w_scale(float(np.abs(wsum).max(initial=0.0)))
    M8 = _scatter(extents, cells, count.astype(np.int8), torch.int8, device)
    W8 = _scatter(extents, cells, _quantize_values(wsum, w_scale),
                  torch.int8, device)
    deg = [torch.from_numpy(np.bincount(idx[:, f], minlength=stored[f])
                            .astype(np.float32)).to(device)
           for f in range(len(n))]
    return {"M8": M8, "W8": W8, "deg": deg, "w_scale": float(w_scale),
            "shape": tuple(n), "order": order}


def pair_w_scale(idx: np.ndarray, centered: np.ndarray,
                 store_dtype) -> float:
    """The int8 pair's value scale max|W| / 127 over every observed cell
    of a relation (``build_int8_pair``'s, whatever rows a store holds)."""
    acc = np.float64 if np.dtype(store_dtype) == np.float64 else np.float32
    order = range(idx.shape[1])
    extents = [int(idx[:, d].max(initial=0)) + 1 for d in order]
    _, _, wsum = _observed_cells(idx, centered, order, extents, acc)
    return _w_scale(float(np.abs(wsum).max(initial=0.0)))


def build_dense_pair(idx: np.ndarray, centered: np.ndarray,
                     shape: Sequence[int], store_dtype: torch.dtype, device,
                     order: Optional[Sequence[int]] = None
                     ) -> Dict[str, object]:
    """The stored float pair of one relation, on ``device`` (JAX
    ``build_dense_pair`` :263 and the engine's store, engine.py:109-112,
    :257-259): ``{"M": M, "W": W, "shape": (N_0, ...), "order": ...}``, the
    observation counts and the centered value sums in ``store_dtype``
    (bfloat16 under ``gram_dtype="bfloat16"``, else the compute dtype),
    with the modes in ``store_order`` and no padding.  The sums are taken
    over the observed cells in the JAX package's accumulator (float64 for
    a float64 store, else float32), in order of appearance, then scattered
    into zeroed device arrays and cast there.  ``order`` overrides
    ``store_order(shape)``, as for ``build_int8_pair``."""
    n = [int(s) for s in shape]
    order = store_order(n) if order is None else tuple(order)
    extents = [n[d] for d in order]
    acc = np.float64 if store_dtype == torch.float64 else np.float32
    cells, count, wsum = _observed_cells(idx, centered, order, extents, acc)
    return {"M": _scatter(extents, cells, count.astype(acc), store_dtype,
                          device),
            "W": _scatter(extents, cells, wsum, store_dtype, device),
            "shape": tuple(n), "order": order}


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
    s = torch.clamp_min(A.abs().amax(dim=1) * INV127, TINY)
    return q8(A, s[:, None]), s


def ridge_step(s: torch.Tensor, K: int) -> torch.Tensor:
    """The PD ridge's float32 step mean(s) * sqrt(K) / 2 from the row
    scales s, with 1/len(s) and sqrt(K)/2 folded into one float32 factor
    as XLA folds them in the JAX engine's compiled sweep."""
    c = (torch.tensor(1.0 / s.numel(), dtype=torch.float32)
         * torch.tensor(0.5 * float(np.sqrt(K)), dtype=torch.float32))
    return s.sum() * c


def _dq_scale(s: torch.Tensor, extra: float, alpha: torch.Tensor,
              out_dtype: torch.dtype) -> torch.Tensor:
    """The per-row dequant scale: the float32 product s * extra cast to
    out_dtype, then times alpha (JAX dense_gram.py:1356-1359)."""
    scale = (s * torch.tensor(extra, dtype=torch.float32)).to(out_dtype)
    return scale * alpha.to(out_dtype)


def _contract_dq(M8, W8, YZ8T, mode, K, n, sY, sU, w_scale, alpha,
                 out_dtype):
    """K6's contraction of focus ``mode`` (its first ``n`` rows),
    dequantized with the alpha-folded scales: in K6's epilogue in float32,
    after its raw int32 sums otherwise.  Returns ([C, n], [K, n])."""
    syz = _dq_scale(sY, 1.0, alpha, out_dtype)
    sz = _dq_scale(sU, w_scale, alpha, out_dtype)
    if out_dtype == torch.float32:
        return pair_contract(M8, W8, YZ8T, mode, K, n, dq=(syz, sz))
    PM, BV = pair_contract(M8, W8, YZ8T, mode, K, n)
    return PM.to(out_dtype) * syz[:, None], BV.to(out_dtype) * sz[:, None]


def _pair_ridge(P: torch.Tensor, pair: Dict[str, object], sY: torch.Tensor,
                mode: int, K: int, dc: torch.Tensor, alpha: torch.Tensor,
                out_dtype: torch.dtype) -> None:
    """The PD safety ridge in place on the diagonal entries ``dc`` of P
    [C, n] (JAX dense_gram.py:1391-1414): ~1.7 sigma of the per-row
    quantization noise, mean(sY) * sqrt(K) / 2 * alpha * sqrt(deg)."""
    n = pair["shape"][mode]
    step = ridge_step(sY, K).to(out_dtype) * alpha
    rdeg = torch.sqrt(pair["deg"][mode][:n]).to(out_dtype)
    P[dc] += (rdeg * step)[None, :]


def _step1_view(A: torch.Tensor, order: Sequence[int], big: int):
    """The store A (modes ``order``) as the 2-D array whose one axis is the
    ``big`` partner's: (view, the focus axis of that view, the store axes
    of its focus side).  ``big`` is the last store axis ([(rest), big],
    focus axis 0) or the first ([big, (rest)], focus axis 1)."""
    if big == order[-1]:
        return A.view(-1, A.shape[-1]), 0, list(range(A.dim() - 1))
    if big != order[0]:
        raise ValueError(f"mode {big} is at neither end of the store "
                         f"order {tuple(order)}")
    return A.view(A.shape[0], -1), 1, list(range(1, A.dim()))


def _step2(S: torch.Tensor, axes: Sequence[int], extents: Sequence[int],
           order: Sequence[int], true: Sequence[int], focus: int,
           tables: Dict[int, torch.Tensor]) -> torch.Tensor:
    """The second step of an arity >= 3 contraction: S [R, prod(extents)]
    is the first step's output over the store ``axes`` (their stored
    ``extents``), each reduced against its mode's table [N_d, R] but the
    focus mode's, which is kept: [R, N_focus].  Extents padded past the
    true count (``true``, by mode) are cut first."""
    R = S.shape[0]
    S = S.view(R, *extents)
    letters = "abcdefgh"
    idx = [slice(None)]
    spec_in, spec_out, ops = "z", "", []
    for ax, ext in zip(axes, extents):
        d = order[ax]
        idx.append(slice(0, true[d]) if ext != true[d] else slice(None))
        spec_in += letters[ax]
        if d == focus:
            spec_out = letters[ax]
        else:
            ops.append((letters[ax] + "z", tables[d]))
    S = S[tuple(idx)]
    spec = ",".join([spec_in] + [sp for sp, _ in ops]) + "->z" + spec_out
    return torch.einsum(spec, S, *[t for _, t in ops]).contiguous()


def _tensor_int8_contrib(pair, tri, partners, mode, alpha, out_dtype,
                         op_dtype):
    """(P [C, n], b [K, n]) of focus ``mode`` from an arity >= 3 int8
    store, alpha folded in, the ridge added (JAX dense_gram.py:1320-1414):
    step 1 contracts the largest partner exactly in int32 on K6 against
    its quantized table, the store read as 2-D (``_step1_view``), and
    dequantizes (K6's epilogue in float32, after it otherwise); step 2
    reduces the other partners, one or more, against their float tables in
    one ``torch.einsum`` (as the JAX package's XLA einsum does), the tables
    made from the float32 factors and rounded to ``op_dtype`` as the
    dequantized sums are, and summed in ``out_dtype``."""
    M8, W8, order = pair["M8"], pair["W8"], pair["order"]
    true = pair["shape"]
    K = partners[0].shape[1]
    C = K * (K + 1) // 2
    iu, ju = tri[:2]
    factor = {d: U for d, U in zip(
        [d for d in range(len(true)) if d != mode], partners)}
    big = big_partner(true, mode)
    M2, k6_mode, axes = _step1_view(M8, order, big)
    W2 = W8.view(M2.shape)
    extents = [M8.shape[ax] for ax in axes]
    n_focus = int(np.prod(extents))
    if k6_mode == 0:
        # the focus side leads: only the true rows of its first axis
        n_focus = n_focus // extents[0] * true[order[0]]
        extents[0] = true[order[0]]
    with span("bdf.ytab"):
        YZ8T, _, s_yz, sU = fused_quantize(factor[big],
                                           pad_rows=M2.shape[1 - k6_mode],
                                           tri=tri)
    sY = s_yz[:C]

    def rounded(t):
        return t if op_dtype == out_dtype else t.to(op_dtype).to(out_dtype)
    with span("bdf.contract"):
        SP, Sb = _contract_dq(M2, W2, YZ8T, k6_mode, K, n_focus, sY, sU,
                              pair["w_scale"], alpha, out_dtype)
        del YZ8T
        small = {d: U.to(torch.float32) for d, U in factor.items()
                 if d != big}
        P = _step2(rounded(SP), axes, extents, order, true, mode,
                   {d: rounded(Uf[:, iu] * Uf[:, ju]).to(out_dtype)
                    for d, Uf in small.items()})
        del SP
        b = _step2(rounded(Sb), axes, extents, order, true, mode,
                   {d: rounded(Uf).to(out_dtype) for d, Uf in small.items()})
        _pair_ridge(P, pair, sY, mode, K, tri[2], alpha, out_dtype)
    return P, b


def int8_pair_contrib(pair: Dict[str, object], tri,
                      partners: Sequence[torch.Tensor], mode: int,
                      alpha: torch.Tensor, out_dtype: torch.dtype,
                      packed: bool = True, op_dtype: torch.dtype = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One focus mode's alpha-folded contribution from ``build_int8_pair``'s
    store (JAX dense_gram.py:1319-1430).  ``packed=True``, the packed
    samplers' layout: P [K(K+1)/2, N_f] (packed triangle, PD ridge
    included) and b [K, N_f].  ``packed=False``, the full-P sampler's: P
    [N_f, K, K], freshly allocated, and b [N_f, K].  N_f is the true focus
    count.

    ``tri`` = ``tri_index(K)``, ``partners`` the other modes' factors
    [N_d, K] in mode order, cast to float32 before the tables and their
    quantization whatever ``out_dtype`` is, as the JAX package does.
    Arity 2 is one contraction on K6; arity 3 and up two steps
    (``_tensor_int8_contrib``), the second with its operands rounded to
    ``op_dtype`` (the JAX package's ``gram_dtype``; default
    ``out_dtype``)."""
    arity = len(pair["shape"])
    n = pair["shape"][mode]
    K = partners[0].shape[1]
    C = K * (K + 1) // 2
    expand = tri[3]
    alpha = alpha.to(out_dtype)
    if arity > 2:
        P, b = _tensor_int8_contrib(pair, tri, partners, mode, alpha,
                                    out_dtype, op_dtype or out_dtype)
    else:
        M8, W8 = pair["M8"], pair["W8"]
        with span("bdf.ytab"):
            YZ8T, _, s_yz, sU = fused_quantize(partners[0],
                                               pad_rows=M8.shape[1 - mode],
                                               tri=tri)
        sY = s_yz[:C]
        with span("bdf.contract"):
            P, b = _contract_dq(M8, W8, YZ8T, mode, K, n, sY, sU,
                                pair["w_scale"], alpha, out_dtype)
            del YZ8T
            _pair_ridge(P, pair, sY, mode, K, tri[2], alpha, out_dtype)
    if packed:
        return P, b
    with span("bdf.expand"):
        Pt = P.mT.contiguous()                        # [n, C]
        del P  # free the packed copy before the expand allocates [n, K*K]
        return Pt[:, expand].view(n, K, K), b.mT


def _contract(T: torch.Tensor, A: torch.Tensor, mode: int,
              acc_dtype: torch.dtype) -> torch.Tensor:
    """T [R, N_partner] against a 2-D stored float array A [N0, N1] along
    mode ``mode``'s partner axis: [R, N_focus] in ``acc_dtype``.  A store
    of another dtype (bfloat16) is widened with its table to ``acc_dtype``
    a slice of focus rows at a time: the products of bfloat16 values are
    exact there, and the sums in ``acc_dtype`` are the JAX einsum's
    (``preferred_element_type``); torch's bfloat16 matmul would round its
    output to bfloat16."""
    if A.dtype == acc_dtype:
        return T @ (A.mT if mode == 0 else A)
    n_focus, n_part = A.shape[mode], A.shape[1 - mode]
    Tw = T.to(acc_dtype)
    out = torch.empty((T.shape[0], n_focus), dtype=acc_dtype,
                      device=A.device)
    step = max(1, _WIDEN_ELEMS // max(n_part, 1))
    for r0 in range(0, n_focus, step):
        r1 = min(r0 + step, n_focus)
        blk = (A[r0:r1].mT if mode == 0 else A[:, r0:r1]).to(acc_dtype)
        out[:, r0:r1] = Tw @ blk
    return out


def float_pair_contrib(pair: Dict[str, object], tri,
                       partners: Sequence[torch.Tensor], mode: int,
                       alpha: torch.Tensor, out_dtype: torch.dtype,
                       packed: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One focus mode's alpha-folded contribution from ``build_dense_pair``'s
    store (JAX dense_gram.py:1431-1463), in ``int8_pair_contrib``'s
    layouts, without a ridge: the partners cast to the store dtype, the
    packed triangle tables made (and rounded) in it, the sums in
    ``out_dtype``, alpha multiplied in afterwards.  At arity >= 3 the
    largest partner is contracted first on ``torch.matmul`` (the store as
    2-D, ``_step1_view``) and the others by ``torch.einsum``, as the JAX
    package leaves its multi-operand einsum to XLA.  Unpacked, the packed
    triangle is expanded to [N_f, K, K]; the products are the same exact
    U_i U_j as the full K^2 table's, which the JAX package takes on small
    stores for a TPU latency trade-off."""
    M, W, order = pair["M"], pair["W"], pair["order"]
    true = pair["shape"]
    K = partners[0].shape[1]
    iu, ju, _, expand = tri
    factor = {d: U.to(M.dtype).mT for d, U in zip(
        [d for d in range(len(true)) if d != mode], partners)}  # [K, N_d]
    alpha = alpha.to(out_dtype)
    with span("bdf.contract"):
        if len(true) == 2:
            UT = factor[1 - mode]
            b = _contract(UT, W, mode, out_dtype)             # [K, n]
            P = _contract(UT[iu] * UT[ju], M, mode, out_dtype)
        else:
            big = big_partner(true, mode)
            M2, k2_mode, axes = _step1_view(M, order, big)
            W2 = W.view(M2.shape)
            extents = [M.shape[ax] for ax in axes]
            UT = factor[big]
            small = {d: t for d, t in factor.items() if d != big}
            b = _step2(_contract(UT, W2, k2_mode, out_dtype), axes, extents,
                       order, true, mode,
                       {d: t.mT.to(out_dtype) for d, t in small.items()})
            P = _step2(_contract(UT[iu] * UT[ju], M2, k2_mode, out_dtype),
                       axes, extents, order, true, mode,
                       {d: (t[iu] * t[ju]).mT.to(out_dtype)
                        for d, t in small.items()})
        b *= alpha
        P *= alpha
    if packed:
        return P, b
    with span("bdf.expand"):
        return _expand(P.mT, expand, K), b.mT


# ---------------------------------------------------------------------------
# the fused sparse regime: host side (numpy)
# ---------------------------------------------------------------------------

def fused_pair_encode(idx: np.ndarray, vals: np.ndarray,
                      shape: Sequence[int]) -> Optional[Tuple[float, int]]:
    """The strict fused encoding (JAX :336): ``(s, m)`` such that every
    observed value is v = s (e + m) with e a nonzero int8 and no residual
    (no duplicate cell, no value on the zero-code level), else None."""
    plan = fused_pair_plan(idx, vals, shape, tol=None)
    if plan is None or not plan[2].all():
        return None
    return plan[0], plan[1]


def fused_pair_plan(idx: np.ndarray, vals: np.ndarray,
                    shape: Sequence[int], tol: Optional[float] = None):
    """The fused path's planner (JAX :371): ``None`` or ``(s, m, keep)``.

    ``s`` is the step of an exact value grid of at most 255 levels or,
    with ``tol``, the coarsest-first uniform grid whose rounding error
    s/2 <= tol leaves a free shift level; ``m`` the shift (an unused level
    first, else the least-populated one); ``keep`` marks the observations
    V8 holds, the first encodable one per (i, j) cell.  The rest
    (duplicates, the zero-code level) would ride the gather path as an
    exact-valued residual.  Decided from (idx, vals, shape, tol) alone."""
    if idx.shape[1] != 2 or idx.shape[0] == 0:
        return None
    v64 = np.asarray(vals, np.float64)
    d = np.unique(v64)
    s = None
    if d.size <= 255:
        # exact grid: every value an integer multiple of the step
        se = float(np.min(np.diff(d))) if d.size > 1 else (
            abs(float(d[0])) if d[0] != 0 else 1.0)
        if np.isfinite(se) and se > 0:
            q = d / se
            qd = np.rint(q)
            if (np.max(np.abs(q - qd)) <= 1e-9
                    and np.max(np.abs(qd * se - d))
                    <= 1e-9 * max(1.0, float(np.abs(d).max()))
                    and qd.max() - qd.min() <= 254):
                s = se
    if s is None:
        if tol is None or not np.isfinite(tol) or tol <= 0:
            return None
        # uniform grids within tol, finest first; the first with an unused
        # level in its feasible shift window has no zero-code residual
        rng_v = float(d[-1] - d[0])
        if rng_v <= 0:
            s = abs(float(d[0])) if d[0] != 0 else 1.0
            if s / 2.0 > tol:
                return None
        else:
            l_min = max(2, int(np.ceil(rng_v / (2.0 * tol))))
            if l_min > 253:
                return None
            cand = sorted({max(l_min, int(253 * f))
                           for f in (1.0, 0.97, 0.93, 0.88, 0.82, 0.75,
                                     0.65, 0.5, 0.35, 0.2)},
                          reverse=True)
            cand = [L for L in cand if L >= l_min]
            s = rng_v / cand[0]
            for L in cand:
                sc = rng_v / L
                qc = np.rint(d / sc).astype(np.int64)
                lo_c, hi_c = int(qc.min()), int(qc.max())
                if hi_c - lo_c > 254:
                    continue
                w_lo, w_hi = hi_c - 127, lo_c + 127
                if w_lo > w_hi:
                    continue
                window = np.arange(w_lo, w_hi + 1)
                if (~np.isin(window, qc)).any():
                    s = sc
                    break
    qi = np.rint(d / s).astype(np.int64)
    lo, hi = int(qi.min()), int(qi.max())
    if hi - lo > 254:
        return None
    used = set(int(x) for x in qi)
    # shift: an unused level first, then the smallest |e| range
    best_free, best_used = None, None
    for m in range(lo - 1, hi + 2):
        emax = max(abs(lo - m), abs(hi - m))
        if emax > 127:
            continue
        if m in used:
            if best_used is None or emax < best_used[1]:
                best_used = (m, emax)
        elif best_free is None or emax < best_free[1]:
            best_free = (m, emax)
    if best_free is None and best_used is not None:
        # every feasible level is used: the least-populated one (lowest m
        # on ties) becomes the zero-code residual
        w_lo, w_hi = max(hi - 127, lo), min(lo + 127, hi)
        full = np.bincount(np.rint(v64 / s).astype(np.int64) - lo,
                           minlength=hi - lo + 1)
        counts = full[w_lo - lo:w_hi - lo + 1]
        best_used = (w_lo + int(np.argmin(counts)), 0)
    best = best_free if best_free is not None else best_used
    if best is None:
        return None
    m = best[0]
    q_obs = np.rint(v64 / s).astype(np.int64)
    encodable = q_obs != m
    keep = np.zeros(idx.shape[0], bool)
    pos = np.nonzero(encodable)[0]
    if pos.size:
        lin = (idx[pos, 0].astype(np.int64) * int(shape[1])
               + idx[pos, 1])
        keep[pos[_first_per_key(lin, int(shape[0]) * int(shape[1]))]] = True
    if not keep.any():
        return None
    return float(s), int(m), keep


def _first_per_key(key: np.ndarray, key_bound: int) -> np.ndarray:
    """The position of the first occurrence of every distinct value of
    ``key`` (non-negative int64 below ``key_bound``), by position:
    ``np.sort(np.unique(key, return_index=True)[1])``.

    One plain sort of (key, position) packed into one int64, then a
    neighbour compare, where the bits allow (8.5e9 cells x 1.0e8
    observations at the Netflix shape take 61): much cheaper at 10^8 keys
    than the stable argsort of ``np.unique(return_index=True)``."""
    n = key.shape[0]
    bits = max(int(n - 1).bit_length(), 1)
    if int(key_bound).bit_length() + bits > 62:
        return np.sort(np.unique(key, return_index=True)[1])
    comp = (key << bits) | np.arange(n, dtype=np.int64)
    comp.sort()
    cell = comp >> bits
    first = np.ones(n, bool)
    np.not_equal(cell[1:], cell[:-1], out=first[1:])
    return np.sort(comp[first] & ((1 << bits) - 1))


def encode_fused_values(vals: np.ndarray, s: float, m: int) -> np.ndarray:
    """int8 codes e = rint(v / s) - m (JAX :507)."""
    return (np.rint(np.asarray(vals, np.float64) / s) - m).astype(np.int8)


def fused_code_bound(vals: np.ndarray, s: float, m: int) -> int:
    """max |e| over the stored codes (JAX :745)."""
    if len(vals) == 0:
        return 1
    e = np.rint(np.asarray(vals, np.float64) / s) - m
    return int(np.max(np.abs(e)))


def fused_abs_codes(vals: np.ndarray, s: float, m: int) -> np.ndarray:
    """|e| over the stored codes, the weights of the per-fiber bound
    (JAX :783)."""
    return np.abs(np.rint(np.asarray(vals, np.float64) / s) - m)


def fused_int8_ok(emax: int, shape: Sequence[int],
                  idx: Optional[np.ndarray] = None,
                  abs_codes: Optional[np.ndarray] = None) -> bool:
    """No int32 sum of the s8 contraction can overflow (JAX :753).  One
    output sums over one observed fiber with |partner code| <= 127, so
    with (idx, abs_codes) the exact bound is 127 * the largest per-fiber
    sum of |e| along either axis; without them, the dense worst case
    127 * emax * (max extent + 8192)."""
    if idx is not None and abs_codes is not None and idx.shape[0]:
        worst = 1.0
        for ax in range(idx.shape[1]):
            worst = max(worst, float(np.bincount(
                idx[:, ax], weights=np.asarray(abs_codes, np.float64))
                .max()))
        return 127.0 * worst < 2.0 ** 31 * 0.95
    n_c = max(int(d) for d in shape) + 8192
    return 127.0 * max(emax, 1) * n_c < 2.0 ** 31 * 0.95


def build_fused_store(idx: np.ndarray, vals: np.ndarray,
                      shape: Sequence[int], s: float, m: int, device
                      ) -> Dict[str, object]:
    """The fused path's device store (JAX ``build_fused_values_device``
    :527 and the engine's ridge degrees, engine.py:180-194).

    Returns ``{"V8": [n0p, n1p] int8, "deg": [d0, d1], "shape": (n0, n1),
    "scale": s, "shift": m}``: the codes scattered from the observations
    into one zeroed array on the device (one orientation only: K8
    contracts along either axis), its extents rounded up to STORE_ALIGN
    (K8 loads 16-byte rows; pad cells are 0 = unobserved), and d{f} the
    float32 observation count of every stored row of mode f, for the PD
    ridge.  The observations must hold one nonzero code per cell: the ones
    ``fused_pair_plan`` keeps (the rest is the gather-path residual and
    counts neither in V8 nor in the degrees, JAX engine :172-194)."""
    n = [int(d) for d in shape]
    pad = [-(-d // STORE_ALIGN) * STORE_ALIGN for d in n]
    V8 = torch.zeros(pad, dtype=torch.int8, device=device)
    ij = torch.from_numpy(np.ascontiguousarray(idx, np.int32)).to(device)
    lin = ij[:, 0].to(torch.int64) * pad[1] + ij[:, 1]
    del ij
    V8.view(-1)[lin] = torch.from_numpy(
        encode_fused_values(vals, s, m)).to(device)
    del lin
    deg = [torch.from_numpy(np.bincount(idx[:, f], minlength=pad[f])
                            .astype(np.float32)).to(device)
           for f in range(2)]
    return {"V8": V8, "deg": deg, "shape": tuple(n), "scale": float(s),
            "shift": int(m)}


# ---------------------------------------------------------------------------
# the fused sparse regime: per sweep (torch)
# ---------------------------------------------------------------------------

def quantize_table_t(partner: torch.Tensor, n_rows: int, tri
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The quantized partner table by torch ops, in K7's layout: (YZ8T
    [C + K, n_rows] int8, s [C + K] float32) of the float32 table
    [Ypack | U], per table column as ``quantize_rows`` does it (above
    K7's K = 128).  ``tri`` = ``tri_index(K)``."""
    iu, ju = tri[:2]
    n, K = partner.shape
    C = len(iu)
    UT = partner.new_zeros((K, n_rows), dtype=torch.float32)
    UT[:, :n] = partner.to(torch.float32).mT
    YZ8T = torch.empty((C + K, n_rows), dtype=torch.int8,
                       device=partner.device)
    s = torch.empty(C + K, dtype=torch.float32, device=partner.device)
    YZ8T[:C], s[:C] = quantize_rows(UT[iu] * UT[ju])
    YZ8T[C:], s[C:] = quantize_rows(UT)
    return YZ8T, s


def fused_quantize(partner: torch.Tensor, pad_rows: Optional[int] = None,
                   tri=None):
    """The partner operands of one fused contraction (JAX :788): (YZ8T
    [C + K, pad_rows] int8, Z8T [K, pad_rows] int8 (a view of YZ8T's last
    K rows), s_yz [C + K], s_z [K] float32), ``_quantize_cols`` of the
    packed-triangle table and of the factors, transposed, with rows past
    the partner count zero.

    K7 up to its K = 128 (``ops/ytab.ytab_quantize``; the JAX gates,
    K <= 64 and 2e8 table cells, are a TPU compile cap and fusion
    trade-off, and the kernel equals the plain quantization, the JAX
    package's XLA ``_quantize_cols``, bit for bit).  Above it, on either
    device, torch ops make and quantize the table (``quantize_table_t``;
    ``tri`` = ``tri_index(K)`` saves rebuilding the index): the same codes
    and scales."""
    from . import ytab      # imported here: ytab uses this module's helpers
    K = partner.shape[-1]
    C = K * (K + 1) // 2
    if K <= ytab.K7_MAX_K:
        YZ8T, s_yz = ytab.ytab_quantize(partner, out_rows=pad_rows)
    else:
        YZ8T, s_yz = quantize_table_t(
            partner, partner.shape[0] if pad_rows is None else pad_rows,
            tri_index(K, partner.device) if tri is None else tri)
    return YZ8T, YZ8T[C:], s_yz, s_yz[C:]


def fused_pair_contract_i8(V8: torch.Tensor, YZ8T: torch.Tensor,
                           focus_axis: int, K: int, n_focus: int,
                           dq: Optional[Tuple[torch.Tensor, ...]] = None,
                           flip_out: bool = True):
    """The raw fused contraction (JAX :834): exact int32 PM and BV in the
    kernel layout ([C + K, n_focus], [K, n_focus]; ``flip_out``), there
    also through K8's dequant epilogue ``dq``, or in the natural layout
    ([n_focus, C + K], [n_focus, K]).  YZ8T spans V8's contraction extent
    (``fused_quantize``'s ``pad_rows``)."""
    n_contract = V8.shape[1 - focus_axis]
    if YZ8T.shape[1] != n_contract:
        raise ValueError(f"YZ8T spans {YZ8T.shape[1]} partner rows, V8's "
                         f"contraction extent is {n_contract}")
    return fused_pair.fused_pair_contract(V8, YZ8T, focus_axis, K, n_focus,
                                          dq, flip_out=flip_out)


def _add_ridge(Pt: torch.Tensor, s_tri: torch.Tensor, K: int,
               deg: torch.Tensor, dc: torch.Tensor,
               natural: bool = False) -> None:
    """The PD safety ridge in place on the packed diagonal entries of Pt
    ([C, n], or [n, C] with ``natural``; JAX :950-955, :965-969): float32
    step mean(s_tri) * sqrt(K) / 2 times sqrt(deg), cast to Pt's dtype."""
    step = ridge_step(s_tri, K)
    ridge = (torch.sqrt(deg.to(torch.float32)) * step).to(Pt.dtype)
    if natural:
        Pt[:, dc] += ridge[:, None]
    else:
        Pt[dc] += ridge[None, :]


def _b_consts(scale, shift, mean, dtype, device):
    """(s, s m - mean) on ``device``: a host tensor copied without a stream
    sync (a blocking upload would make every sweep wait for the device)."""
    c = torch.tensor([scale, scale * shift - mean], dtype=dtype)
    c = c.to(device, non_blocking=True)
    return c[0], c[1]


def fused_finish_i8(PM: torch.Tensor, BV: torch.Tensor, s_yz: torch.Tensor,
                    s_z: torch.Tensor, K: int, out_dtype: torch.dtype,
                    scale: float, shift: int, mean: float,
                    dc: torch.Tensor, ridge_deg: torch.Tensor,
                    pre_transposed: bool = True,
                    alpha: Optional[torch.Tensor] = None):
    """Dequantize and center the raw int32 sums (JAX :904): b = s BVf +
    (s m - mean) PMf[C:], the ridge on P's packed diagonal.
    ``pre_transposed``: the kernel layout in and out, Pt [C, n] and b
    [K, n]; else the natural one, Pt [n, C] (a view of the dequantized
    [n, C + K] sums) and b [n, K].  ``alpha`` folds the relation's
    precision into the float32 dequant scales, as the JAX package does in
    float32; without it the (float64) caller multiplies afterwards."""
    if alpha is not None:
        af = alpha.to(torch.float32)
        s_yz, s_z = s_yz * af, s_z * af
    c1, c0 = _b_consts(scale, shift, mean, out_dtype, PM.device)
    if pre_transposed:
        C = PM.shape[0] - K
        PMf = PM.to(out_dtype) * s_yz.to(out_dtype)[:, None]
        BVf = BV.to(out_dtype) * s_z.to(out_dtype)[:, None]
        b = c1 * BVf + c0 * PMf[C:]
        Pt = PMf[:C]
    else:
        C = PM.shape[1] - K
        PMf = PM.to(out_dtype) * s_yz.to(out_dtype)
        BVf = BV.to(out_dtype) * s_z.to(out_dtype)
        b = c1 * BVf + c0 * PMf[:, C:]
        Pt = PMf[:, :C]
    _add_ridge(Pt, s_yz[:C], K, ridge_deg, dc, natural=not pre_transposed)
    return Pt, b


def _expand(Pt: torch.Tensor, expand: torch.Tensor, K: int) -> torch.Tensor:
    """[n, C] packed triangles -> [n, K, K] through ``tri_maps``' index."""
    return Pt.index_select(1, expand).view(Pt.shape[0], K, K)


def fused_gram_contrib_i8(store: Dict[str, object], tri,
                          partner: torch.Tensor, mode: int,
                          alpha: torch.Tensor, out_dtype: torch.dtype,
                          mean: float, packed: bool = True
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One focus mode's alpha-folded fused s8 contribution (JAX :978).
    ``packed`` (with the JAX ``transposed``): the packed samplers'
    transposed layout, P [C, n_f] (PD ridge included) and b [K, n_f], n_f
    the true focus count.  Else the full-P sampler's, P [n_f, K, K] and b
    [n_f, K], from K8's natural layout.  ``store`` is
    ``build_fused_store``'s, ``tri`` = ``tri_index(K)``, ``partner`` the
    other entity's factors [N_partner, K].

    Packed, float32 takes K8's dequant epilogue with the alpha-folded
    scales (:1008-1049).  Otherwise the raw int32 sums go through the
    finish: in float32 with alpha folded into its scales, in float64
    followed by the alpha multiply (:1050-1070), as in the JAX package."""
    V8 = store["V8"]
    n_f = store["shape"][mode]
    K = partner.shape[1]
    C = K * (K + 1) // 2
    dc, expand = tri[2], tri[3]
    deg = store["deg"][mode][:n_f]
    scale, shift = store["scale"], store["shift"]
    with span("bdf.ytab"):
        YZ8T, _, s_yz, s_z = fused_quantize(
            partner, pad_rows=V8.shape[1 - mode], tri=tri)
    f64 = out_dtype == torch.float64
    with span("bdf.contract"):
        if packed and out_dtype == torch.float32:
            af = alpha.to(torch.float32)
            syz_e, sz_e = s_yz * af, s_z * af
            Pt, PMm, BVf = fused_pair_contract_i8(V8, YZ8T, mode, K, n_f,
                                                  dq=(syz_e, sz_e))
            c1, c0 = _b_consts(scale, shift, mean, out_dtype, V8.device)
            b = c1 * BVf + c0 * PMm
            _add_ridge(Pt, syz_e[:C], K, deg, dc)
            return Pt, b
        PM, BV = fused_pair_contract_i8(V8, YZ8T, mode, K, n_f,
                                        flip_out=packed)
        del YZ8T
        Pt, b = fused_finish_i8(PM, BV, s_yz, s_z, K, out_dtype, scale,
                                shift, mean, dc, deg, pre_transposed=packed,
                                alpha=None if f64 else alpha)
        del PM, BV  # the int32 sums, before the expand allocates [n, K*K]
        if f64:
            alpha = alpha.to(out_dtype)
            Pt, b = alpha * Pt, alpha * b
    if packed:
        return Pt, b
    with span("bdf.expand"):
        return _expand(Pt, expand, K), b


def fused_table(partner: torch.Tensor, op_dtype: torch.dtype, n_rows: int,
                tri) -> torch.Tensor:
    """The float fused path's partner table YZT = [Ypack | U] transposed,
    [C + K, n_rows] in ``op_dtype`` (JAX :612-614): the factors are cast to
    ``op_dtype`` first and the triangle products U[:, i] U[:, j] are taken
    (and rounded) in it, the two places where the JAX package rounds.
    Columns past the partner count are zero."""
    iu, ju = tri[:2]
    n, K = partner.shape
    UT = partner.new_zeros((K, n_rows), dtype=op_dtype)
    UT[:, :n] = partner.to(op_dtype).mT
    return torch.cat([UT[iu] * UT[ju], UT])


def fused_gram_contrib(store: Dict[str, object], tri, partner: torch.Tensor,
                       mode: int, out_dtype: torch.dtype,
                       op_dtype: torch.dtype, mean: float,
                       packed: bool = False, transposed: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One focus mode's fused contribution with float operands (JAX :574),
    for a relation off the s8 path: P = (V8 != 0) @ Ypack and the centered
    b = s (V8 @ U) + (s m - mean) ((V8 != 0) @ U), with the table in
    ``op_dtype`` and float32 sums (float64 for a float64 table), cast to
    ``out_dtype``.  No ridge and no alpha: the caller multiplies.

    ``packed`` and ``transposed``: P [C, n_f] and b [K, n_f] from K8's
    ``flip_out`` layout; ``packed`` alone: P [n_f, C] and b [n_f, K];
    neither: P [n_f, K, K].  P is a view of the kernel's fresh output where
    it is packed, so the caller may scale it in place."""
    if transposed and not packed:
        raise ValueError("transposed requires packed=True")
    V8 = store["V8"]
    n_f = store["shape"][mode]
    K = partner.shape[1]
    C = K * (K + 1) // 2
    with span("bdf.ytab"):
        YZT = fused_table(partner, op_dtype, V8.shape[1 - mode], tri)
    with span("bdf.contract"):
        PM, BV = fused_pair.fused_pair_contract(V8, YZT, mode, K, n_f,
                                                flip_out=transposed)
        del YZT
        PM, BV = PM.to(out_dtype), BV.to(out_dtype)
        c1, c0 = _b_consts(store["scale"], store["shift"], mean, out_dtype,
                           V8.device)
        if transposed:
            return PM[:C], c1 * BV + c0 * PM[C:]
        Pt, b = PM[:, :C], c1 * BV + c0 * PM[:, C:]
    if packed:
        return Pt, b
    with span("bdf.expand"):
        return _expand(Pt, tri[3], K), b
