"""Sparse feature matrices (side information).

Port of the host half of ``bayesiandatafusion_jl_tpu/ops/sparse.py``:
``SparseBinMatrix`` (:28-137), numpy only, and the COO products ``spmm`` /
``spmm_t`` (:139, :145) in torch.  The engine's feature products run on
``ops/spmv.bucketed_spmm`` or a dense [N, F] operand, not on these two.
Then the file readers and writers (:161-263), so a file written by either
package is the same bytes: SBM1 by the native library (the port's copy of
the JAX package's ``native/layout.cpp``, ``native/``), the others by the
JAX package's pure-Python branch:

- SBM1 (``write_sparse_binary`` / ``read_sparse_binary``): the magic
  ``b"SBM1"``, nrow, ncol and nnz as little-endian int64, then the 0-based
  rows and the cols as little-endian int32 (a binary matrix);
- SBF1 (``write_sparse_float64`` / ``read_sparse_float64``): the same
  header after ``b"SBF1"``, rows, cols, then the values as little-endian
  float64;
- MatrixMarket coordinate text (``read_matrix_market`` /
  ``write_matrix_market``): 1-based, ``pattern`` and ``symmetric`` read.
"""
from __future__ import annotations

import dataclasses
import os
import struct
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


_MAGIC = b"SBM1"


def write_sparse_binary(path: str, m: SparseBinMatrix) -> None:
    """``m``'s pattern as an SBM1 file (its values, if any, are not kept),
    by the native library (JAX ``write_sparse_binary`` :164)."""
    import ctypes

    from .. import native
    p32 = ctypes.POINTER(ctypes.c_int32)
    rows = np.ascontiguousarray(m.rows, np.int32)
    cols = np.ascontiguousarray(m.cols, np.int32)
    if native.lib().bdf_write_sbm(
            os.fsencode(path), m.shape[0], m.shape[1], m.nnz,
            rows.ctypes.data_as(p32), cols.ctypes.data_as(p32)) != 0:
        raise OSError(f"{path}: could not write the SBM1 file")


def read_sparse_binary(path: str) -> SparseBinMatrix:
    """An SBM1 file as a binary ``SparseBinMatrix``, by the native library
    (JAX ``read_sparse_binary`` :181)."""
    import ctypes

    from .. import native
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    L = native.lib()
    shape = np.zeros(2, np.int64)
    p64 = ctypes.POINTER(ctypes.c_int64)
    nnz = L.bdf_read_sbm_header(os.fsencode(path),
                                shape.ctypes.data_as(p64))
    if nnz < 0:
        raise ValueError(f"{path}: not an SBM1 file")
    rows = np.empty(nnz, np.int32)
    cols = np.empty(nnz, np.int32)
    p32 = ctypes.POINTER(ctypes.c_int32)
    if L.bdf_read_sbm(os.fsencode(path), nnz, rows.ctypes.data_as(p32),
                      cols.ctypes.data_as(p32)) != 0:
        raise ValueError(f"{path}: truncated SBM1 file")
    return SparseBinMatrix(rows, cols, (int(shape[0]), int(shape[1])))


def _write_sparse_binary_plain(path: str, m: SparseBinMatrix) -> None:
    """``write_sparse_binary`` in Python (the JAX package's pure-Python
    branch): the plain version the tests hold the native writer to."""
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<qqq", m.shape[0], m.shape[1], m.nnz))
        f.write(m.rows.astype("<i4").tobytes())
        f.write(m.cols.astype("<i4").tobytes())


def _read_sparse_binary_plain(path: str) -> SparseBinMatrix:
    """``read_sparse_binary`` in Python: the native reader's plain
    version."""
    with open(path, "rb") as f:
        if f.read(4) != _MAGIC:
            raise ValueError(f"{path}: not an SBM1 file")
        nrow, ncol, nnz = struct.unpack("<qqq", f.read(24))
        rows = np.frombuffer(f.read(4 * nnz), "<i4").copy()
        cols = np.frombuffer(f.read(4 * nnz), "<i4").copy()
    if rows.size != nnz or cols.size != nnz:
        raise ValueError(f"{path}: truncated SBM1 file")
    return SparseBinMatrix(rows, cols, (int(nrow), int(ncol)))


def read_matrix_market(path: str):
    """A MatrixMarket coordinate file as (rows, cols, vals, shape), 0-based;
    a ``pattern`` matrix gets vals = 1.0, a ``symmetric`` one its mirrored
    off-diagonal entries after the stored ones."""
    with open(path) as f:
        header = f.readline()
        if not header.startswith("%%MatrixMarket"):
            raise ValueError(f"{path}: not a MatrixMarket file")
        parts = header.split()
        if "coordinate" not in parts:
            raise ValueError("only coordinate (sparse) format supported")
        pattern = "pattern" in parts
        symmetric = "symmetric" in parts
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        nrow, ncol, nnz = (int(x) for x in line.split())
        rows = np.empty(nnz, np.int64)
        cols = np.empty(nnz, np.int64)
        vals = np.ones(nnz, np.float64)
        for i in range(nnz):
            toks = f.readline().split()
            rows[i] = int(toks[0]) - 1
            cols[i] = int(toks[1]) - 1
            if not pattern and len(toks) > 2:
                vals[i] = float(toks[2])
    if symmetric:
        off = rows != cols
        rows = np.concatenate([rows, cols[off]])
        cols = np.concatenate([cols, rows[:nnz][off]])
        vals = np.concatenate([vals, vals[off]])
    return rows, cols, vals, (nrow, ncol)


def write_matrix_market(path: str, rows, cols, vals, shape) -> None:
    """A real general coordinate MatrixMarket file, values to 17 digits."""
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"{shape[0]} {shape[1]} {len(vals)}\n")
        for r, c, v in zip(rows, cols, vals):
            f.write(f"{int(r) + 1} {int(c) + 1} {v:.17g}\n")


def write_sparse_float64(path: str, rows: np.ndarray, cols: np.ndarray,
                         vals: np.ndarray, shape: Tuple[int, int]) -> None:
    """A real sparse matrix as an SBF1 file."""
    with open(path, "wb") as f:
        f.write(b"SBF1")
        f.write(struct.pack("<qqq", shape[0], shape[1], len(vals)))
        f.write(np.asarray(rows, "<i4").tobytes())
        f.write(np.asarray(cols, "<i4").tobytes())
        f.write(np.asarray(vals, "<f8").tobytes())


def read_sparse_float64(path: str):
    """An SBF1 file as (rows, cols, vals, shape)."""
    with open(path, "rb") as f:
        if f.read(4) != b"SBF1":
            raise ValueError(f"{path}: not an SBF1 file")
        nrow, ncol, nnz = struct.unpack("<qqq", f.read(24))
        rows = np.frombuffer(f.read(4 * nnz), "<i4").copy()
        cols = np.frombuffer(f.read(4 * nnz), "<i4").copy()
        vals = np.frombuffer(f.read(8 * nnz), "<f8").copy()
    return rows, cols, vals, (int(nrow), int(ncol))
