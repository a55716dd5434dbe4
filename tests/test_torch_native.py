"""The port's native host builder (``native/layout.cpp``, built at first use)
against the NumPy builders: the port's plain version and the JAX package's.

Layouts bit for bit (instance, partner indices, the values' float32 bits,
the mask) at arity 2 to 4 on skewed degrees (instances cut into pieces of
the widest width), empty instances and every ``row_pad``; SBM1 files byte
for byte whichever package writes them; a source that does not compile
raises with the compiler's output."""
import os
import shutil

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from bayesiandatafusion_jl_tpu.ops import layout as jax_layout
from bayesiandatafusion_jl_tpu.ops import sparse as jsp
from bayesiandatafusion_jl_tpu_torch import native
from bayesiandatafusion_jl_tpu_torch.ops import layout as tl
from bayesiandatafusion_jl_tpu_torch.ops import sparse as tsp


def _assert_same(a, b):
    assert (a.n_instances, a.arity, a.nnz) == (b.n_instances, b.arity,
                                               b.nnz)
    assert len(a.buckets) == len(b.buckets)
    for x, y in zip(a.buckets, b.buckets):
        assert x.width == y.width and x.val.dtype == y.val.dtype
        np.testing.assert_array_equal(x.inst, y.inst)
        assert len(x.part) == len(y.part)
        for p, q in zip(x.part, y.part):
            np.testing.assert_array_equal(p, q)
        np.testing.assert_array_equal(x.val.view(np.int32),
                                      y.val.view(np.int32))
        np.testing.assert_array_equal(x.mask, y.mask)


def _skewed(dims, nnz, seed, hot=0, empty=()):
    """Random observations of a relation of extents ``dims``: ``hot`` of
    them on instance 3 of every mode (a head instance, cut into pieces),
    none on the instances ``empty`` of every mode."""
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.integers(0, n, nnz) for n in dims], 1)
    idx[:hot] = 3
    for e in empty:
        idx[idx == e] = (e + 1) % min(dims)
    return idx.astype(np.int32), rng.standard_normal(nnz) * 3.7


@pytest.mark.parametrize("row_pad", [1, 2, 3, 8, 16])
@pytest.mark.parametrize("dims", [(50, 40), (30, 20, 6), (12, 9, 5, 4)])
def test_native_layout_equals_numpy(dims, row_pad):
    """Every mode of a relation with a hot instance (900 observations
    across widths up to 128: 7 full pieces and a remainder) and empty
    instances: the native layout equals the port's NumPy builder and the
    JAX package's, bit for bit."""
    idx, vals = _skewed(dims, 6_000, sum(dims) + row_pad, hot=900,
                        empty=(0, 1))
    widths = (2, 8, 32, 128)
    for mode in range(len(dims)):
        args = (idx, vals, mode, dims[mode])
        got = tl.build_mode_layout(*args, widths=widths, row_pad=row_pad)
        plain = tl.build_mode_layout(*args, widths=widths, row_pad=row_pad,
                                     use_native=False)
        want = jax_layout._build_mode_layout_numpy(*args, widths, row_pad,
                                                   np.float32)
        _assert_same(got, plain)
        _assert_same(got, want)
        assert got.padded_nnz == want.padded_nnz


@settings(max_examples=40, deadline=None)
@given(dims=st.lists(st.integers(1, 60), min_size=2, max_size=4),
       nnz=st.integers(0, 3_000), hot=st.integers(0, 700),
       widths=st.lists(st.integers(1, 300), min_size=1, max_size=6),
       row_pad=st.integers(1, 16), seed=st.integers(0, 2**16))
def test_native_layout_equals_numpy_random(dims, nnz, hot, widths, row_pad,
                                           seed):
    """Random extents, counts, width ladders (unsorted, repeated) and
    padding, no observation at all included."""
    idx, vals = _skewed(dims, nnz, seed, hot=min(hot, nnz) if min(dims) > 3
                        else 0)
    for mode in range(len(dims)):
        args = (idx, vals, mode, dims[mode], widths, row_pad)
        _assert_same(tl.build_mode_layout(*args),
                     tl.build_mode_layout(*args, use_native=False))


def test_native_layout_dtypes_and_errors():
    """float64 layouts take the NumPy builder; an index outside the mode's
    extent raises."""
    idx, vals = _skewed((20, 10), 300, 0)
    a = tl.build_mode_layout(idx, vals, 0, 20, dtype=np.float64)
    _assert_same(a, jax_layout._build_mode_layout_numpy(
        idx, vals, 0, 20, (8, 32, 128, 512, 2048), 8, np.float64))
    with pytest.raises(ValueError, match="outside"):
        tl.build_mode_layout(idx, vals, 0, 19)


@pytest.mark.parametrize("nnz", [0, 1, 5_000])
def test_native_sbm1_bytes(tmp_path, nnz):
    """An SBM1 file written by the native writer has the bytes of the
    port's Python writer and the JAX package's; the native reader reads
    each package's file back to the same matrix."""
    rng = np.random.default_rng(nnz)
    rows = np.sort(rng.integers(0, 700, nnz)).astype(np.int32)
    cols = rng.integers(0, 300, nnz).astype(np.int32)
    paths = {k: str(tmp_path / k) for k in ("native", "plain", "jax")}
    m0 = tsp.SparseBinMatrix(rows, cols, (700, 300))   # sorted by (row, col)
    tsp.write_sparse_binary(paths["native"], m0)
    tsp._write_sparse_binary_plain(paths["plain"], m0)
    jsp.write_sparse_binary(paths["jax"],
                            jsp.SparseBinMatrix(rows, cols, (700, 300)))
    data = {k: open(p, "rb").read() for k, p in paths.items()}
    assert data["native"] == data["plain"] == data["jax"]
    assert len(data["native"]) == 28 + 8 * nnz
    for p in paths.values():
        for reader in (tsp.read_sparse_binary, tsp._read_sparse_binary_plain):
            m = reader(p)
            assert m.shape == (700, 300) and m.vals is None
            np.testing.assert_array_equal(m.rows, m0.rows)
            np.testing.assert_array_equal(m.cols, m0.cols)


def test_native_sbm1_refuses(tmp_path):
    """A missing file, another format and a truncated SBM1 file raise."""
    with pytest.raises(FileNotFoundError):
        tsp.read_sparse_binary(str(tmp_path / "none"))
    path = tmp_path / "x"
    path.write_bytes(b"SBX1" + bytes(24))
    with pytest.raises(ValueError, match="not an SBM1"):
        tsp.read_sparse_binary(str(path))
    path.write_bytes(b"SBM1" + np.array([4, 4, 3], "<i8").tobytes()
                     + bytes(8))
    with pytest.raises(ValueError, match="truncated"):
        tsp.read_sparse_binary(str(path))


def test_native_broken_source_raises(tmp_path):
    """A source that does not compile raises with the compiler's output,
    and leaves no library behind; the good source builds, and a library
    newer than its source is reused."""
    src = tmp_path / "layout.cpp"
    src.write_text(open(native.SOURCE).read() + "\nint broken(\n")
    out = tmp_path / "lib.so"
    with pytest.raises(RuntimeError, match="did not compile"):
        native.build(str(src), str(out))
    assert not out.exists() and os.listdir(tmp_path) == ["layout.cpp"]
    shutil.copy(native.SOURCE, src)
    assert native.build(str(src), str(out)) == str(out)
    mtime = out.stat().st_mtime_ns
    native.build(str(src), str(out))
    assert out.stat().st_mtime_ns == mtime
