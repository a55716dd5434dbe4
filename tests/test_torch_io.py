"""The port's sparse file formats (``ops/sparse.py``) against the JAX
package's: each of SBM1 (binary pattern), SBF1 (float64 values) and the
MatrixMarket text, written by one package, reads in the other, and the
two packages write the same bytes."""
import numpy as np
import pytest

from bayesiandatafusion_jl_tpu.ops import sparse as jsp
import bayesiandatafusion_jl_tpu_torch as bt
from bayesiandatafusion_jl_tpu_torch.ops import sparse as tsp


def _coo(seed=0, shape=(37, 53), density=0.2):
    rng = np.random.default_rng(seed)
    mask = rng.random(shape) < density
    rows, cols = np.nonzero(mask)
    return (rows.astype(np.int32), cols.astype(np.int32),
            rng.standard_normal(rows.size), shape)


def _write(pkg, fmt, path, coo):
    rows, cols, vals, shape = coo
    if fmt == "sbm":
        pkg.write_sparse_binary(path, pkg.SparseBinMatrix(rows, cols, shape))
    elif fmt == "sbf":
        pkg.write_sparse_float64(path, rows, cols, vals, shape)
    else:
        pkg.write_matrix_market(path, rows, cols, vals, shape)


def _read(pkg, fmt, path):
    """(rows, cols, vals or None, shape) from either package's reader."""
    if fmt == "sbm":
        m = pkg.read_sparse_binary(path)
        return m.rows, m.cols, None, tuple(m.shape)
    if fmt == "sbf":
        r, c, v, shape = pkg.read_sparse_float64(path)
    else:
        r, c, v, shape = pkg.read_matrix_market(path)
    return r, c, v, tuple(shape)


@pytest.mark.parametrize("fmt", ["sbm", "sbf", "mm"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_format_crosses_packages(tmp_path, fmt, writer):
    """A file written by ``writer`` reads the same in both packages, equal
    to what was written; and the other package writes the same bytes."""
    pkgs = {"jax": jsp, "port": bt}
    coo = _coo(seed=len(fmt))
    path = str(tmp_path / f"{writer}.{fmt}")
    _write(pkgs[writer], fmt, path, coo)
    for reader in pkgs.values():
        r, c, v, shape = _read(reader, fmt, path)
        np.testing.assert_array_equal(r, coo[0])
        np.testing.assert_array_equal(c, coo[1])
        assert shape == coo[3]
        if v is not None:
            np.testing.assert_array_equal(v, coo[2])
    other = "port" if writer == "jax" else "jax"
    path2 = str(tmp_path / f"{other}.{fmt}")
    _write(pkgs[other], fmt, path2, coo)
    with open(path, "rb") as a, open(path2, "rb") as b:
        assert a.read() == b.read()


def test_matrix_market_pattern_and_symmetric(tmp_path):
    """A pattern file (values 1.0) and a symmetric one (off-diagonal
    entries mirrored after the stored ones) read alike in both packages."""
    pat = tmp_path / "pat.mtx"
    pat.write_text("%%MatrixMarket matrix coordinate pattern general\n"
                   "% a comment\n3 4 3\n1 1\n2 4\n3 2\n")
    sym = tmp_path / "sym.mtx"
    sym.write_text("%%MatrixMarket matrix coordinate real symmetric\n"
                   "3 3 3\n1 1 2.5\n2 1 -1\n3 2 0.25\n")
    for path in (pat, sym):
        got = tsp.read_matrix_market(str(path))
        want = jsp.read_matrix_market(str(path))
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g, w)
        assert got[3] == want[3]
    r, c, v, _ = tsp.read_matrix_market(str(sym))
    assert list(zip(r, c, v)) == [(0, 0, 2.5), (1, 0, -1.0), (2, 1, 0.25),
                                  (0, 1, -1.0), (1, 2, 0.25)]
    assert tsp.read_matrix_market(str(pat))[2].tolist() == [1.0] * 3


@pytest.mark.parametrize("fmt, reader", [
    ("sbm", tsp.read_sparse_binary), ("sbf", tsp.read_sparse_float64),
    ("mm", tsp.read_matrix_market)])
def test_readers_refuse_other_files(tmp_path, fmt, reader):
    """Each reader raises on a file of another format."""
    path = tmp_path / "x"
    path.write_bytes(b"SBX1" + bytes(24))
    with pytest.raises(ValueError):
        reader(str(path))
