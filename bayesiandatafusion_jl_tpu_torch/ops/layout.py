"""Degree-bucketed observation layout for the gather path (numpy only).

Port of ``bayesiandatafusion_jl_tpu/ops/layout.py``: ``Bucket``,
``ModeLayout``, ``build_mode_layout`` and its NumPy builder
``_build_mode_layout_numpy`` :150-227, which this module copies, so the
layout equals the JAX package's bit for bit (same piece order, same
observation order, same padding).  The JAX package's C++ builder
(``native/layout.cpp``) produces the same layout faster; it is not ported
yet (ROADMAP M6).

For one (relation, mode), the observations are grouped by focus instance
and packed into fixed-width blocks ("buckets").  An instance whose degree
exceeds the widest bucket is cut into several pieces ("chunks") of that
width, each a row of its own; their Gramians add into the same instance.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np


@dataclasses.dataclass
class Bucket:
    """One fixed-width block of packed observations for a (relation, mode).

    Row r contributes to instance ``inst[r]`` of the focus mode;
    ``part[d][r, w]`` indexes the d-th other mode's factor matrix (other
    modes in relation order).  Padding entries have mask 0, val 0 and
    part 0 (a valid row, zeroed by the mask).
    """

    width: int
    inst: np.ndarray          # [rows] int32
    part: List[np.ndarray]    # (arity-1) x [rows, width] int32
    val: np.ndarray           # [rows, width] float, centered, 0-padded
    mask: np.ndarray          # [rows, width] float, 1 for real entries

    @property
    def n_rows(self) -> int:
        return int(self.inst.shape[0])


@dataclasses.dataclass
class ModeLayout:
    """All buckets for one (relation, mode) pair."""

    buckets: List[Bucket]
    n_instances: int
    arity: int
    nnz: int

    @property
    def padded_nnz(self) -> int:
        return sum(b.n_rows * b.width for b in self.buckets)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def build_mode_layout(
    idx: np.ndarray,            # [nnz, D] observation indices
    centered_vals: np.ndarray,  # [nnz] float (v - mean_r)
    mode: int,
    n_instances: int,
    widths: Sequence[int] = (8, 32, 128, 512, 2048),
    row_pad: int = 8,
    dtype=np.float32,
) -> ModeLayout:
    """Pack one relation's observations for sampling ``mode``'s entity:
    CSR by focus instance (stable sort), each instance's run cut into
    pieces of the widest width, each piece in the narrowest bucket that
    holds it, each bucket's rows padded to a multiple of ``row_pad``."""
    idx = np.asarray(idx, np.int32)
    nnz, D = idx.shape
    widths = sorted(set(int(w) for w in widths))
    wmax = widths[-1]
    other_modes = [d for d in range(D) if d != mode]

    order = np.argsort(idx[:, mode], kind="stable")
    sidx = idx[order]
    svals = np.asarray(centered_vals, np.float64)[order]
    deg = np.bincount(idx[:, mode], minlength=n_instances).astype(np.int64)

    # each instance's run splits into floor(deg / wmax) full pieces plus
    # one remainder piece
    n_full = deg // wmax
    rem = deg - n_full * wmax
    n_pieces_per_inst = n_full + (rem > 0)
    total_pieces = int(n_pieces_per_inst.sum())
    if total_pieces == 0:
        return ModeLayout(buckets=[], n_instances=n_instances, arity=D,
                          nnz=nnz)
    piece_inst = np.repeat(np.arange(n_instances, dtype=np.int64),
                           n_pieces_per_inst)
    piece_len = np.full(total_pieces, wmax, np.int64)
    last_piece_of_inst = (np.cumsum(n_pieces_per_inst) - 1)[
        n_pieces_per_inst > 0]
    rem_nz = rem[n_pieces_per_inst > 0]
    piece_len[last_piece_of_inst] = np.where(rem_nz > 0, rem_nz, wmax)
    piece_off = np.concatenate([[0], np.cumsum(piece_len)[:-1]])
    # bucket class: the smallest width >= piece length
    piece_cls = np.searchsorted(np.asarray(widths, np.int64), piece_len)

    # per observation: its piece and its position within it
    obs_piece = np.repeat(np.arange(total_pieces), piece_len)
    obs_pos = np.arange(nnz, dtype=np.int64) - piece_off[obs_piece]

    buckets: List[Bucket] = []
    for ci, w in enumerate(widths):
        psel = piece_cls == ci
        n_p = int(psel.sum())
        if n_p == 0:
            continue
        n_rows = _round_up(n_p, row_pad)
        row_of_piece = np.full(total_pieces, -1, np.int64)
        row_of_piece[psel] = np.arange(n_p)
        osel = psel[obs_piece]
        r = row_of_piece[obs_piece[osel]]
        c = obs_pos[osel]
        inst = np.zeros(n_rows, np.int32)
        inst[:n_p] = piece_inst[psel]
        part = []
        for d in other_modes:
            a = np.zeros((n_rows, w), np.int32)
            a[r, c] = sidx[osel, d]
            part.append(a)
        val = np.zeros((n_rows, w), dtype)
        val[r, c] = svals[osel]
        mask = np.zeros((n_rows, w), dtype)
        mask[r, c] = 1.0
        buckets.append(Bucket(width=w, inst=inst, part=part, val=val,
                              mask=mask))

    return ModeLayout(buckets=buckets, n_instances=n_instances, arity=D,
                      nnz=nnz)
