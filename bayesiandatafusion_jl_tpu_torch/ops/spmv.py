"""Bucketed sparse matvec of the side-information matrix.

Port of ``bayesiandatafusion_jl_tpu/ops/spmv.py``: ``build_bucketed_matvec``
(:24-50) builds, for X @ V (by row) and X' @ U (by column), the degree
bucketed layout of ``ops/layout.build_mode_layout``; ``bucketed_spmm``
(:53) gathers each bucket's partner rows, sums them over the bucket's
fixed width against the stored values, and writes each output row.

The JAX package reduces the bucket rows with a segment sum.  Here each
output row is written by an index copy, in levels: level 0 holds the
first bucket row of every output row, level l its (l+1)-th (a row whose
degree exceeds the widest bucket is cut into several pieces).  Each level
names every output row at most once, so no two writes meet and the result
is the same from run to run on the card (no scatter add).  Padding rows
(all-zero values) are left out.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .layout import build_mode_layout


def build_bucketed_matvec(rows: np.ndarray, cols: np.ndarray,
                          shape: Tuple[int, int], vals: np.ndarray = None,
                          widths=(8, 16, 32, 64, 128, 256, 512, 1024, 2048),
                          row_pad: int = 8, dtype=np.float32,
                          device="cpu") -> Dict[str, dict]:
    """The layouts of both directions, on ``device``: ``out["fwd"]`` for
    X @ V ([F, K] -> [N, K]) and ``out["t"]`` for X' @ U ([N, K] ->
    [F, K]).  Each is ``{"buckets": [{"part" [rows, W] int32, "w" [rows, W]
    in ``dtype``}], "levels": [(out_rows int64, bucket_rows int64)]}``:
    ``bucket_rows`` index the buckets' rows concatenated in order.
    ``vals=None`` is a binary X (the weights are the mask)."""
    idx = np.stack([np.asarray(rows, np.int64),
                    np.asarray(cols, np.int64)], axis=1)
    w = np.ones(idx.shape[0]) if vals is None else np.asarray(vals,
                                                              np.float64)
    out = {}
    for key, mode, n in (("fwd", 0, shape[0]), ("t", 1, shape[1])):
        ml = build_mode_layout(idx, w, mode, n, widths=widths,
                               row_pad=row_pad, dtype=dtype)
        inst = [b.inst.astype(np.int64) for b in ml.buckets]
        real = [b.mask.any(axis=1) for b in ml.buckets]
        out[key] = {
            "buckets": [{"part": torch.from_numpy(b.part[0]).to(device),
                         "w": torch.from_numpy(b.val).to(device)}
                        for b in ml.buckets],
            "levels": [(torch.from_numpy(o).to(device),
                        torch.from_numpy(r).to(device))
                       for o, r in _levels(inst, real)]}
    return out


def _levels(inst: Sequence[np.ndarray], real: Sequence[np.ndarray]
            ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """(output rows, concatenated bucket rows) of each level: the l-th
    real bucket row of each output row, in concatenation order."""
    if not inst:
        return []
    cat = np.concatenate(inst)
    pos = np.nonzero(np.concatenate(real))[0]
    tgt = cat[pos]
    order = np.argsort(tgt, kind="stable")
    st = tgt[order]
    first = np.r_[True, st[1:] != st[:-1]]
    start = np.maximum.accumulate(np.where(first, np.arange(len(st)), 0))
    level = np.empty(len(st), np.int64)
    level[order] = np.arange(len(st)) - start
    return [(tgt[level == lv], pos[level == lv])
            for lv in range(int(level.max()) + 1 if len(st) else 0)]


def bucketed_spmm(mv: dict, n_out: int, v: torch.Tensor) -> torch.Tensor:
    """y[i] = sum_j x_ij v[j] for one direction's layout ``mv`` (from
    ``build_bucketed_matvec``): v [n_in, K] -> y [n_out, K]."""
    K = v.shape[1]
    y = torch.zeros((n_out, K), dtype=v.dtype, device=v.device)
    if not mv["buckets"]:
        return y
    parts = []
    for ba in mv["buckets"]:
        part, w = ba["part"], ba["w"]
        z = v.index_select(0, part.reshape(-1)).view(*part.shape, K)
        parts.append(torch.bmm(w.to(v.dtype)[:, None, :], z)[:, 0])
    rows = torch.cat(parts)
    for lv, (out_rows, bucket_rows) in enumerate(mv["levels"]):
        piece = rows.index_select(0, bucket_rows)
        if lv:
            piece = y.index_select(0, out_rows) + piece
        y.index_copy_(0, out_rows, piece)
    return y
