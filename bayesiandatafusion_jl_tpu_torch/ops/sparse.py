"""Sparse feature matrices (side information).

Port of the host half of ``bayesiandatafusion_jl_tpu/ops/sparse.py``:
``SparseBinMatrix`` (:28-137), numpy only, and the COO products ``spmm`` /
``spmm_t`` (:139, :145) in torch.  The engine's feature products run on
``ops/spmv.bucketed_spmm`` or a dense [N, F] operand, not on these two.
The file readers and writers (:161-263) are ROADMAP M10.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class SparseBinMatrix:
    """Sparse feature matrix in COO form (host side, numpy int32).

    ``rows`` / ``cols`` are 0-based int32, sorted by (row, col).
    ``vals=None`` means every stored value is 1 (binary fingerprints); a
    float array gives a real-valued sparse matrix."""

    rows: np.ndarray  # [nnz] int32
    cols: np.ndarray  # [nnz] int32
    shape: Tuple[int, int]
    vals: Optional[np.ndarray] = None  # [nnz] float64, or None = binary

    def __post_init__(self):
        self.rows = np.asarray(self.rows, np.int32)
        self.cols = np.asarray(self.cols, np.int32)
        if self.vals is not None:
            self.vals = np.asarray(self.vals, np.float64).ravel()
            if self.vals.shape[0] != self.rows.shape[0]:
                raise ValueError("vals length != nnz")
        order = np.lexsort((self.cols, self.rows))
        if not np.all(order == np.arange(len(order))):
            self.rows = self.rows[order]
            self.cols = self.cols[order]
            if self.vals is not None:
                self.vals = self.vals[order]

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    @property
    def is_binary(self) -> bool:
        return self.vals is None

    def values(self) -> np.ndarray:
        """The stored values (ones when binary)."""
        return (np.ones(self.nnz, np.float64) if self.vals is None
                else self.vals)

    @classmethod
    def from_scipy(cls, m) -> "SparseBinMatrix":
        coo = m.tocoo()
        data = np.asarray(coo.data, np.float64)
        vals = None if np.all(data == 1.0) else data
        return cls(coo.row.astype(np.int32), coo.col.astype(np.int32),
                   (int(coo.shape[0]), int(coo.shape[1])), vals)

    @classmethod
    def from_dense(cls, m: np.ndarray) -> "SparseBinMatrix":
        m = np.asarray(m)
        r, c = np.nonzero(m)
        data = np.asarray(m[r, c], np.float64)
        vals = None if np.all(data == 1.0) else data
        return cls(r.astype(np.int32), c.astype(np.int32), tuple(m.shape),
                   vals)

    def to_dense(self) -> np.ndarray:
        d = np.zeros(self.shape, np.float64)
        d[self.rows, self.cols] = self.values()
        return d

    def matmul(self, v: np.ndarray) -> np.ndarray:
        """X @ v  (v: [F] or [F, K])."""
        out = np.zeros((self.shape[0],) + v.shape[1:], v.dtype)
        vc = v[self.cols]
        if self.vals is not None:
            vc = vc * self.vals.reshape((-1,) + (1,) * (v.ndim - 1))
        np.add.at(out, self.rows, vc)
        return out

    def t_matmul(self, v: np.ndarray) -> np.ndarray:
        """X.T @ v  (v: [N] or [N, K])."""
        out = np.zeros((self.shape[1],) + v.shape[1:], v.dtype)
        vr = v[self.rows]
        if self.vals is not None:
            vr = vr * self.vals.reshape((-1,) + (1,) * (v.ndim - 1))
        np.add.at(out, self.cols, vr)
        return out

    def gram(self) -> np.ndarray:
        """Dense X'X, float64 (for small F)."""
        F = self.shape[1]
        g = np.zeros((F, F), np.float64)
        vals = self.values()
        starts = np.searchsorted(self.rows, np.arange(self.shape[0]))
        ends = np.searchsorted(self.rows, np.arange(self.shape[0]) + 1)
        for s, e in zip(starts, ends):
            idx = self.cols[s:e]
            g[np.ix_(idx, idx)] += np.outer(vals[s:e], vals[s:e])
        return g

    def col_sq_sums(self) -> np.ndarray:
        """diag(X'X): each column's sum of squared values."""
        if self.vals is None:
            return np.bincount(self.cols, minlength=self.shape[1]).astype(
                np.float64)
        return np.bincount(self.cols, weights=self.vals ** 2,
                           minlength=self.shape[1])


def spmm(rows: torch.Tensor, cols: torch.Tensor, n_rows: int,
         v: torch.Tensor) -> torch.Tensor:
    """y = X @ v for binary COO X: v [F, K] -> y [n_rows, K].  A scatter
    add: on CUDA its float sums change order from run to run."""
    out = torch.zeros((n_rows, v.shape[1]), dtype=v.dtype, device=v.device)
    return out.index_add_(0, rows.long(), v.index_select(0, cols.long()))


def spmm_t(rows: torch.Tensor, cols: torch.Tensor, n_cols: int,
           u: torch.Tensor) -> torch.Tensor:
    """y = X.T @ u for binary COO X: u [N, K] -> y [n_cols, K]."""
    return spmm(cols, rows, n_cols, u)
