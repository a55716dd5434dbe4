"""Data sets (numpy only).

Port of ``bayesiandatafusion_jl_tpu/models/datasets.py``: the MovieLens
ratings-file parser and its landing pad under the repository's
``.cache/`` (``find_real_ratings``), the MovieLens-shaped synthetic ratings
(ML-10M shape: 71,567 users x 10,681 movies, 10,000,054 ratings) and the
ChEMBL-shaped Macau problem with side features; and the JAX bench's
generators (``bench.py``: the Netflix-shaped ratings, the 3-way tensors
and the fusion graph).  The same generators, so the same seed gives the
same data; the same parser, so the same file gives the same IndexedDF.
"""
from __future__ import annotations

import os
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from .data import IndexedDF

ML_SHAPES = {
    "100k": (943, 1682, 100_000),
    "1m": (6040, 3706, 1_000_209),
    "10m": (71567, 10681, 10_000_054),
}


# the file names that count as a real ratings file, checked in .cache/ and
# one directory below it (ml-100k/u.data, ml-10M100K/ratings.dat, ...)
_REAL_RATINGS_NAMES = ("ratings.dat", "u.data", "ratings.csv",
                       "ratings.txt")


def find_real_ratings(cache_dir: Optional[str] = None) -> Optional[str]:
    """Path of a real MovieLens-family ratings file, or None: the first of
    ``_REAL_RATINGS_NAMES`` at the top of ``cache_dir`` (default: the
    repository's ``.cache/``), else in its subdirectories, in sorted
    order, one level down."""
    if cache_dir is None:
        cache_dir = os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))), ".cache")
    if not os.path.isdir(cache_dir):
        return None
    for name in _REAL_RATINGS_NAMES:
        p = os.path.join(cache_dir, name)
        if os.path.isfile(p):
            return p
    for sub in sorted(os.listdir(cache_dir)):
        d = os.path.join(cache_dir, sub)
        if not os.path.isdir(d):
            continue
        for name in _REAL_RATINGS_NAMES:
            p = os.path.join(d, name)
            if os.path.isfile(p):
                return p
    return None


def load_movielens(variant: str = "100k", path: Optional[str] = None,
                   seed: int = 0) -> IndexedDF:
    """MovieLens ratings (user x movie): the file at ``path`` where it
    exists (``_parse_movielens_file``), else the synthetic ratings of
    ``variant``'s shape from ``seed``."""
    if path is not None and os.path.exists(path):
        return _parse_movielens_file(path)
    n_users, n_movies, nnz = ML_SHAPES[variant]
    return synthetic_ratings(n_users, n_movies, nnz, seed=seed)


def _parse_movielens_file(path: str) -> IndexedDF:
    """A MovieLens-family ratings file as an IndexedDF.

    Each line's separator is read from the line itself (``::``, else a
    tab, else a comma, else whitespace); blank lines are skipped; a line
    with fewer than three fields, or whose first three do not read as
    int, int, float (a header), is skipped and counted on stderr; extra
    columns (timestamps) are ignored.  The user and movie ids, of any
    base and with gaps, are densified in sorted order by ``np.unique``."""
    users: list = []
    movies: list = []
    vals: list = []
    bad = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if "::" in line:
                parts = line.split("::")
            elif "\t" in line:
                parts = line.split("\t")
            elif "," in line:
                parts = line.split(",")
            else:
                parts = line.split()
            if len(parts) < 3:
                bad += 1
                continue
            try:
                u = int(parts[0])
                m = int(parts[1])
                v = float(parts[2])
            except ValueError:
                bad += 1
                continue
            users.append(u)
            movies.append(m)
            vals.append(v)
    if bad:
        print(f"# parse {path}: skipped {bad} non-data lines",
              file=sys.stderr)
    if not users:
        raise ValueError(f"no ratings parsed from {path}")
    _, u_arr = np.unique(np.asarray(users, np.int64), return_inverse=True)
    _, m_arr = np.unique(np.asarray(movies, np.int64), return_inverse=True)
    idx = np.stack([u_arr, m_arr], axis=1)
    return IndexedDF(idx, np.asarray(vals, np.float64),
                     (int(u_arr.max()) + 1, int(m_arr.max()) + 1))


def synthetic_ratings(n_users: int, n_movies: int, nnz: int,
                      rank: int = 32, noise: float = 0.6,
                      seed: int = 0) -> IndexedDF:
    """Rank-``rank`` ratings on the half-star grid 1..5 with power-law movie
    popularity and lognormal user activity; every (user, movie) cell at most
    once."""
    rng = np.random.default_rng(seed)
    movie_p = (1.0 / np.arange(1, n_movies + 1) ** 0.8)
    movie_p /= movie_p.sum()
    user_p = rng.lognormal(0.0, 1.0, n_users)
    user_p /= user_p.sum()
    movie_cdf = np.cumsum(movie_p)
    user_cdf = np.cumsum(user_p)

    def draw(n):  # inverse-CDF sampling
        u = np.searchsorted(user_cdf, rng.random(n)).astype(np.int64)
        m = np.searchsorted(movie_cdf, rng.random(n)).astype(np.int64)
        return np.unique(u * n_movies + m)

    target = nnz
    key = draw(int(target * 1.6) + 1024)
    while len(key) < target:  # rare: heavy-skew dedup fell short
        key = np.unique(np.concatenate([key, draw(target)]))
    sel = rng.permutation(len(key))[:target]
    u, m = key[sel] // n_movies, key[sel] % n_movies
    U = rng.standard_normal((n_users, rank)) / np.sqrt(rank)
    V = rng.standard_normal((n_movies, rank)) / np.sqrt(rank)
    vals = 3.5 + 1.1 * np.sum(U[u] * V[m], axis=1) \
        + noise * rng.standard_normal(target)
    vals = np.clip(np.round(vals * 2) / 2, 1.0, 5.0)
    idx = np.stack([u, m], axis=1)
    return IndexedDF(idx, vals, (n_users, n_movies))


def _sorted_unique(a: np.ndarray) -> np.ndarray:
    """``np.unique(a)`` for a large integer array, by one sort and a
    neighbour compare: the same array, without ``np.unique``'s own path,
    which under numpy 2.3 has run two orders of magnitude slower than a
    sort on 10^8 int64 keys."""
    a = np.sort(a)
    if a.size:
        a = a[np.concatenate(([True], a[1:] != a[:-1]))]
    return a


# The generators sum the factor products PRODUCT_CHUNK observations at a
# time on up to PRODUCT_THREADS threads (numpy releases the GIL in the
# gathers and the sums), so the host never holds every gathered row at once
PRODUCT_CHUNK = 1_000_000
PRODUCT_THREADS = 8


def _chunked(part, n: int, chunk) -> np.ndarray:
    """``part(slice(0, n))`` computed ``chunk`` rows at a time (None: one
    slice) on the thread pool and concatenated.  ``part`` computes each
    row from that row's inputs alone, so the result is the one pass's."""
    step = max(1, n if chunk is None else int(chunk))
    with ThreadPoolExecutor(min(PRODUCT_THREADS, os.cpu_count() or 1)) as pool:
        parts = list(pool.map(lambda a: part(slice(a, a + step)),
                              range(0, n, step)))
    return np.concatenate(parts) if parts else np.zeros(0)


def netflix_synthetic(n_users: int = 480_189, n_movies: int = 17_770,
                      nnz: int = 100_480_507, rank: int = 32, seed: int = 9,
                      chunk: int = PRODUCT_CHUNK) -> IndexedDF:
    """Netflix-prize-shaped synthetic ratings: integer stars 1..5 from a
    rank-``rank`` model, every (user, movie) cell at most once, ``nnz``
    cells drawn uniformly.

    The JAX bench's generator (``bench.py:353-370``, the ``netflix``
    family): the same calls in the same order, so the same seed gives the
    same bytes (``_sorted_unique`` stands for ``np.unique``, with the same
    result).  The factor products U[i1] . V[i2] are summed ``chunk``
    observations at a time (``_chunked``), so the host never holds the two
    [nnz, rank] gathers whole (2 x 12.9 GB in float32 at full size);
    ``chunk=None`` takes one pass.
    """
    n1, n2, r = n_users, n_movies, rank
    rng = np.random.default_rng(seed)
    key = _sorted_unique(rng.integers(0, n1 * n2, int(nnz * 1.02),
                                      dtype=np.int64))
    key = rng.permutation(key)[:nnz] if key.size > nnz else key
    nnz = key.size
    i1 = (key // n2).astype(np.int32)
    i2 = (key % n2).astype(np.int32)
    del key
    U = rng.standard_normal((n1, r), dtype=np.float32) / np.sqrt(r)
    V = rng.standard_normal((n2, r), dtype=np.float32) / np.sqrt(r)
    score = _chunked(lambda s: np.einsum("nk,nk->n", U[i1[s]], V[i2[s]]),
                     nnz, chunk)
    del U, V
    score = score * np.sqrt(r) * 0.9 + 0.55 * rng.standard_normal(
        nnz, dtype=np.float32)
    vals = np.clip(np.rint(3.6 + 1.1 * score), 1.0, 5.0).astype(np.float32)
    del score
    return IndexedDF(np.stack([i1, i2], 1), vals, (n1, n2))


def tensor_synthetic(shape=(30_000, 2_000, 16), nnz: int = 5_000_000,
                     rank: int = 32, seed: int = 5) -> IndexedDF:
    """A 3-way tensor relation (compound x target x context): values
    sqrt(rank) sum_k U1 U2 U3 + 0.4 N(0, 1) from Gaussian factors of scale
    1/sqrt(rank), ``nnz`` distinct cells drawn uniformly (sorted).

    The JAX bench's ``tensor`` generator (``bench.py:200-211``, seed 5):
    the same calls in the same order, so the same seed gives the same
    data; the products are summed a chunk of observations at a time
    (``_chunked``)."""
    n1, n2, n3 = (int(n) for n in shape)
    r = rank
    rng = np.random.default_rng(seed)
    key = _sorted_unique(rng.integers(0, n1 * n2 * n3,
                                      int(nnz * 1.15)))[:nnz]
    i1 = (key // (n2 * n3)).astype(np.int32)
    i2 = ((key // n3) % n2).astype(np.int32)
    i3 = (key % n3).astype(np.int32)
    del key
    Us = [rng.standard_normal((n, r)) / np.sqrt(r) for n in (n1, n2, n3)]
    score = _chunked(lambda s: np.sum(Us[0][i1[s]] * Us[1][i2[s]]
                                      * Us[2][i3[s]], axis=1), len(i1),
                     PRODUCT_CHUNK)
    vals = score * np.sqrt(r) + 0.4 * rng.standard_normal(len(i1))
    return IndexedDF(np.stack([i1, i2, i3], 1), vals, (n1, n2, n3))


def tensor_big_synthetic(shape=(200_000, 20_000, 8), nnz: int = 30_000_000,
                         rank: int = 32, seed: int = 8) -> IndexedDF:
    """``tensor_synthetic``'s model at the JAX bench's ``tensor_big`` size
    (``bench.py:244-262``, seed 8), its generator: keys oversampled 1.05x,
    float32 factors, one einsum per observation.  The same calls in the
    same order, so the same seed gives the same data; the bench gathers
    all the products at once (3 x 7.7 GB at this size), this a chunk of
    observations at a time (``_chunked``)."""
    n1, n2, n3 = (int(n) for n in shape)
    r = rank
    rng = np.random.default_rng(seed)
    key = _sorted_unique(rng.integers(0, n1 * n2 * n3, int(nnz * 1.05),
                                      dtype=np.int64))[:nnz]
    i1 = (key // (n2 * n3)).astype(np.int32)
    i2 = ((key // n3) % n2).astype(np.int32)
    i3 = (key % n3).astype(np.int32)
    del key
    Us = [rng.standard_normal((n, r)).astype(np.float32) / np.sqrt(r)
          for n in (n1, n2, n3)]
    score = _chunked(lambda s: np.einsum("nk,nk,nk->n", Us[0][i1[s]],
                                         Us[1][i2[s]], Us[2][i3[s]]),
                     len(i1), PRODUCT_CHUNK)
    vals = score * np.sqrt(r) + 0.4 * rng.standard_normal(
        len(i1)).astype(np.float32)
    return IndexedDF(np.stack([i1, i2, i3], 1), vals, (n1, n2, n3))


def fusion_synthetic(n_compounds: int = 50_000,
                     partners=(("ic50", "target", 500, 5_000_000),
                               ("assay", "assay", 3_000, 4_000_000),
                               ("pathway", "pathway", 800, 1_000_000)),
                     rank: int = 32, seed: int = 6):
    """A fusion graph: one compound entity shared by 2-ary relations, one
    per ``partners`` entry (relation name, partner entity name, partner
    count, nnz), values sqrt(rank) Uc . V + 0.4 N(0, 1), the cells of each
    drawn uniformly (sorted).  Returns the RelationData (no test split).

    The JAX bench's ``fusion`` generator (``bench.py:294-316``, seed 6):
    the same calls in the same order, so the same seed gives the same
    data."""
    from .data import Entity, RelationData
    nc, r = n_compounds, rank
    rng = np.random.default_rng(seed)
    compound = Entity("compound", count=nc)
    rd = RelationData()
    Uc = rng.standard_normal((nc, r)) / np.sqrt(r)
    for name, ename, n2, nnz in partners:
        key = _sorted_unique(rng.integers(0, nc * n2,
                                          int(nnz * 1.15)))[:nnz]
        i1, i2 = key // n2, key % n2
        V = rng.standard_normal((n2, r)) / np.sqrt(r)
        score = _chunked(lambda s: np.sum(Uc[i1[s]] * V[i2[s]], axis=1),
                         len(i1), PRODUCT_CHUNK)
        vals = score * np.sqrt(r) + 0.4 * rng.standard_normal(len(i1))
        rd.add_relation(IndexedDF(np.stack([i1, i2], 1), vals, (nc, n2)),
                        name, [compound, Entity(ename, count=n2)])
    return rd


# the activity cut of the ChEMBL IC50 data (active <=> log10(IC50 nM) <
# log10(200)), the reference README's convention
CLASS_CUT_IC50 = float(np.log10(200))


def synthetic_chembl(n_compounds: int = 15_000, n_targets: int = 346,
                     n_features: int = 32_000, nnz: int = 300_000,
                     feat_per_compound: int = 40, rank: int = 16,
                     feat_frac: float = 0.85, obs_noise: float = 0.25,
                     seed: int = 0):
    """ChEMBL-IC50-shaped Macau problem: compound x target activities on
    the log10(IC50 nM) scale (``class_cut=CLASS_CUT_IC50``) with sparse
    binary fingerprint-like compound features that drive the latents
    (``feat_frac`` of each latent dimension's variance), and power-law
    compound degrees.  Returns the RelationData (no test split).

    The JAX package's ``models/datasets.synthetic_chembl`` (:167-230): the
    same calls in the same order, so the same seed gives the same data."""
    from ..ops.sparse import SparseBinMatrix
    from .data import RelationData
    rng = np.random.default_rng(seed)
    fr = np.repeat(np.arange(n_compounds),
                   rng.poisson(feat_per_compound, n_compounds))
    fc = rng.integers(0, n_features, len(fr))
    feat_key = np.unique(fr.astype(np.int64) * n_features + fc)
    fr, fc = feat_key // n_features, feat_key % n_features
    F = SparseBinMatrix(fr.astype(np.int32), fc.astype(np.int32),
                        (n_compounds, n_features))
    beta = rng.standard_normal((n_features, rank))
    Uf = F.matmul(beta)
    Uf /= Uf.std(axis=0, keepdims=True) + 1e-12
    Uc = (np.sqrt(feat_frac) * Uf
          + np.sqrt(1.0 - feat_frac) * rng.standard_normal(
              (n_compounds, rank)))
    Ut = rng.standard_normal((n_targets, rank))
    comp_p = 1.0 / np.arange(1, n_compounds + 1) ** 0.7
    comp_p /= comp_p.sum()
    comp_cdf = np.cumsum(comp_p)
    c = np.searchsorted(comp_cdf, rng.random(int(nnz * 1.6)))
    c = rng.permutation(c)
    t = rng.integers(0, n_targets, len(c))
    key = np.unique(c.astype(np.int64) * n_targets + t)
    key = rng.permutation(key)[:nnz]
    c, t = key // n_targets, key % n_targets
    lic50 = 2.2 + 0.8 * np.sum(Uc[c] * Ut[t], axis=1) / np.sqrt(rank) \
        + obs_noise * rng.standard_normal(len(c))
    df = IndexedDF(np.stack([c, t], axis=1), lic50,
                   (n_compounds, n_targets))
    return RelationData.from_matrix(df, feat1=F,
                                    names=("compound", "target"),
                                    relation_name="ic50",
                                    class_cut=CLASS_CUT_IC50)
