"""The port's MovieLens file branch (``models/datasets.py``:
``_parse_movielens_file``, ``find_real_ratings``, ``load_movielens`` with
a path) and ``IndexedDF.size`` against the JAX package's, on files the
tests write under ``tmp_path``: the same IndexedDF bit for bit (idx,
vals, shape, dtypes) and the same stderr line."""
import os
import tempfile

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import bayesiandatafusion_jl_tpu as bdf
from bayesiandatafusion_jl_tpu.models import datasets as jds
from bayesiandatafusion_jl_tpu_torch.models import datasets as tds
from bayesiandatafusion_jl_tpu_torch.models.data import IndexedDF


def assert_same_df(a, b):
    """Two IndexedDFs equal bit for bit: idx, vals (NaN bits included),
    shape and dtypes."""
    assert a.idx.dtype == b.idx.dtype and a.vals.dtype == b.vals.dtype
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.idx, b.idx)
    np.testing.assert_array_equal(a.vals.view(np.int64),
                                  b.vals.view(np.int64))


def parse_both(path, capfd):
    """Each package's parse of ``path`` and the stderr each printed."""
    want = jds._parse_movielens_file(path)
    want_err = capfd.readouterr().err
    got = tds._parse_movielens_file(path)
    got_err = capfd.readouterr().err
    return got, got_err, want, want_err


# Each layout a MovieLens-family file may come in, and lines a file may
# carry that are not data
FILES = {
    "ml10m_colons": "1::122::5::838985046\n1::185::4.5::838983525\n"
                    "7::122::3::838983392\n",
    "ml100k_tabs": "196\t242\t3\t881250949\n186\t302\t3\t891717742\n"
                   "22\t377\t1\t878887116\n196\t377\t4\t881250950\n",
    "csv_header": "userId,movieId,rating,timestamp\n1,2,3.5,1112486027\n"
                  "1,29,3.5,1112484676\n5,2,4.0,1112484819\n",
    "whitespace": "1 2 3.5\n4   5\t\n6 7 1\n  8 2 2.5  \n",
    "mixed": "1::2::3\n4\t5\t1.5\n6,7,2\n8 9 4.5\n1::9::5::12\n",
    "blank_and_malformed": "\n   \n1::2\n,\n1,2\nabc def ghi\n\t\n"
                           "3::4::5\n:: ::\n5,6,x\n3.0,4,5\n",
    "crlf": "1::2::3::99\r\n4::5::2.5::98\r\n\r\n7,8,1\r\n",
    "gappy_ids": "1001::30::4\n17::30::2\n1001::9000::1.5\n42::7::3\n"
                 "17::9000::5\n",
    "timestamps_extra_columns": "1\t2\t3\t881250949\textra\tmore\n"
                                "2\t3\t4.5\t881250950\tx\n",
    "nan_and_exponents": "1,2,nan\n3,4,1e3\n5,6,-2.5E-1\n7,8,inf\n"
                         "9,1, 4.5 \n2,3,NaN\n",
    "whitespace_header": "user item rating timestamp\n1 2 3 4\n",
    "int_fields_reject_floats": "1.0,2,3\n1,2.5,3\n1,2,3.5\n",
    "negative_and_signed_ids": "-1::5::3\n+2::5::4\n-1::-5::1\n",
    "separator_priority": "1::2::3::4\t5\n6\t7\t2.5\t8,9\n"
                          "10,11,1.5,12 13\n1::2\t3::4\n",
}


@pytest.mark.parametrize("name", sorted(FILES))
def test_parse_matches_jax(tmp_path, capfd, name):
    p = tmp_path / "ratings.dat"
    p.write_bytes(FILES[name].encode())
    got, got_err, want, want_err = parse_both(str(p), capfd)
    assert_same_df(got, want)
    assert got_err == want_err
    if name in ("csv_header", "blank_and_malformed", "whitespace_header"):
        assert got_err.startswith(f"# parse {p}: skipped ")


# the tokens of random ratings lines: ids, values, separators, headers
_TOKENS = st.sampled_from(
    ["1", "2", "7", "10", "42", "999", "-3", "0", "3.5", "4.0", "1e2",
     "nan", "inf", "x", "user", "::", ":", "\t", ",", " ", "  ", "\r", ""])
_LINES = st.lists(st.lists(_TOKENS, max_size=9).map("".join), max_size=25)


@settings(max_examples=60, deadline=None)
@given(lines=_LINES)
def test_parse_random_lines_matches_jax(lines):
    """Random lines from ids, values, separators and junk: both parsers
    give the same IndexedDF, or both raise ValueError."""
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "u.data")
        with open(p, "w", newline="") as f:
            f.write("\n".join(lines))
        try:
            want = jds._parse_movielens_file(p)
        except ValueError:
            with pytest.raises(ValueError, match="no ratings parsed"):
                tds._parse_movielens_file(p)
            return
        assert_same_df(tds._parse_movielens_file(p), want)


@pytest.mark.parametrize("text", ["", "\n\n  \n", "user,item,rating\n1,2\n"])
def test_parse_without_data_raises(tmp_path, text):
    p = tmp_path / "ratings.csv"
    p.write_text(text)
    for pkg in (jds, tds):
        with pytest.raises(ValueError, match="no ratings parsed"):
            pkg._parse_movielens_file(str(p))


# (files to make under the cache directory, the path find_real_ratings
# must return relative to it; None: no file, "missing": no directory)
FIND_CASES = {
    "no_directory": ("missing", [], None),
    "empty_directory": ("dir", [], None),
    "top_level": ("dir", ["ratings.csv", "ml-100k/u.data"], "ratings.csv"),
    "one_level_down": ("dir", ["ml-10M100K/ratings.dat"],
                       "ml-10M100K/ratings.dat"),
    "name_priority": ("dir", ["u.data", "ratings.txt", "ratings.dat"],
                      "ratings.dat"),
    "sorted_subdirectories": ("dir", ["b/ratings.dat", "a/u.data",
                                      "c/ratings.dat"], "a/u.data"),
    "priority_within_subdirectory": ("dir", ["a/ratings.txt", "a/u.data"],
                                     "a/u.data"),
    "not_a_file": ("dir", ["ratings.dat/x", "notes.txt", "z/ratings.csv"],
                   "z/ratings.csv"),
    "two_levels_down": ("dir", ["a/b/ratings.dat", "a/other.dat"], None),
}


@pytest.mark.parametrize("name", sorted(FIND_CASES))
def test_find_real_ratings_matches_jax(tmp_path, name):
    kind, files, want = FIND_CASES[name]
    cache = tmp_path / "cache"
    if kind == "dir":
        cache.mkdir()
    for rel in files:
        f = cache / rel
        f.parent.mkdir(parents=True, exist_ok=True)
        f.write_text("1::2::3\n")
    got = tds.find_real_ratings(str(cache))
    assert got == jds.find_real_ratings(str(cache))
    assert got == (None if want is None else str(cache / want))


def test_find_real_ratings_default_directory_matches_jax():
    """Both look in the repository's .cache/ when given no directory."""
    assert tds.find_real_ratings() == jds.find_real_ratings()


def test_load_movielens_reads_a_positional_path(tmp_path):
    p = tmp_path / "u.data"
    p.write_text(FILES["ml100k_tabs"])
    got = tds.load_movielens("100k", str(p))
    assert_same_df(got, jds.load_movielens("100k", str(p)))
    assert got.shape == (3, 3) and got.nnz == 4
    assert_same_df(tds.load_movielens(path=str(p)), got)


def test_load_movielens_missing_path_falls_back_to_the_generator(tmp_path):
    missing = str(tmp_path / "none" / "ratings.dat")
    got = tds.load_movielens("100k", missing)
    assert_same_df(got, jds.load_movielens("100k", missing))
    assert_same_df(got, tds.synthetic_ratings(943, 1682, 100_000, seed=0))


def test_load_movielens_seed_by_keyword():
    got = tds.load_movielens("100k", seed=3)
    assert_same_df(got, jds.load_movielens("100k", seed=3))
    assert not np.array_equal(got.vals, tds.load_movielens("100k").vals)


def test_indexed_df_size_matches_jax():
    rng = np.random.default_rng(4)
    idx = np.stack([rng.integers(0, n, 50) for n in (9, 8, 5)], axis=1)
    vals = rng.standard_normal(50)
    got = IndexedDF(idx, vals, (9, 8, 5))
    want = bdf.IndexedDF(idx, vals, (9, 8, 5))
    assert got.size() == want.size() == (9, 8, 5)
    assert [got.size(m) for m in range(3)] == [want.size(m)
                                              for m in range(3)] == [9, 8, 5]


@pytest.mark.parametrize("sep", ["::", "\t"])
def test_chip_smoke_writes_ratings_as_movielens(tmp_path, sep):
    """``chip_smoke.write_ratings`` (a few lines a chunk) writes the text
    a line-by-line formatter writes: "3" and "3.5", no padding."""
    import chip_smoke
    rng = np.random.default_rng(6)
    n = 50
    u, m = rng.integers(0, 10 ** 6, n), rng.integers(0, 300, n)
    u[:3], m[:3] = (0, 9, 10), (1, 99, 100)
    v = rng.integers(1, 11, n) / 2.0
    t = rng.integers(0, 2 * 10 ** 9, n)
    p = tmp_path / "ratings.dat"
    chip_smoke.write_ratings(str(p), u, m, v, t, sep, chunk=7)
    assert p.read_text() == "".join(
        f"{a}{sep}{b}{sep}{c:g}{sep}{d}\n" for a, b, c, d in zip(u, m, v, t))


@pytest.mark.parametrize("variant", ["10m", "100k"])
def test_chip_smoke_ratings_file_round_trip(tmp_path, variant):
    """``chip_smoke.ratings_file_round_trip``: a generator's ratings, with
    one user's taken out, written in the MovieLens layout of ``variant``,
    found one level down and parsed back, equal ``densified`` (the users
    without a rating dropped) in the port and in the JAX package."""
    import chip_smoke
    df = tds.synthetic_ratings(300, 200, 5_000, seed=2)
    keep = df.idx[:, 0] != 3
    df = IndexedDF(df.idx[keep], df.vals[keep], df.shape)
    got = chip_smoke.ratings_file_round_trip(df, variant, str(tmp_path))
    rated = np.unique(df.idx[:, 0]).size
    assert rated < 300 and got.shape == (rated, 200)
    sub, name, _, _ = chip_smoke.RATINGS_FILES[variant]
    assert_same_df(got, jds._parse_movielens_file(
        str(tmp_path / sub / name)))
    assert_same_df(got, chip_smoke.densified(df))
