"""The beta draw's operations and the side-information data layer of the
port against the JAX package and numpy (float64 on the CPU): the sparse
feature matrix, the bucketed matvec, block CG, the Nystrom factors, the
dual solve and its cached eigendecomposition, the lambda_beta draw, the
Cholesky solve, the dense-operand and solver choices, the AUC (ties
included) and the ChEMBL generator."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import bayesiandatafusion_jl_tpu as bdf
from bayesiandatafusion_jl_tpu.models import datasets as jax_datasets
from bayesiandatafusion_jl_tpu.models import engine as jax_engine
from bayesiandatafusion_jl_tpu.ops import cg as jax_cg
from bayesiandatafusion_jl_tpu.ops import dense_gram as jax_dg
from bayesiandatafusion_jl_tpu.ops import dual as jax_dual
from bayesiandatafusion_jl_tpu.ops import hyper as jax_hyper
from bayesiandatafusion_jl_tpu.ops import mvn as jax_mvn
from bayesiandatafusion_jl_tpu.ops import precond as jax_precond
from bayesiandatafusion_jl_tpu.ops import sparse as jax_sparse
from bayesiandatafusion_jl_tpu.utils.config import MacauConfig
import bayesiandatafusion_jl_tpu_torch as bt
from bayesiandatafusion_jl_tpu_torch.models import datasets
from bayesiandatafusion_jl_tpu_torch.models import engine
from bayesiandatafusion_jl_tpu_torch.ops import (cg, dual, hyper, mvn,
                                                 precond, sparse, spmv)
from bayesiandatafusion_jl_tpu_torch.ops import dense_gram as dg


def _coo(seed, n=40, f=23, density=0.2, real=False):
    rng = np.random.default_rng(seed)
    mask = rng.random((n, f)) < density
    X = (rng.standard_normal((n, f)) * mask) if real else mask * 1.0
    return X


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float64))


@pytest.mark.parametrize("real", [False, True])
def test_sparse_matrix_matches_jax(real):
    """``SparseBinMatrix`` from a dense array and from scipy, and its host
    products, Gramian and column sums, equal the JAX package's."""
    X = _coo(1, real=real)
    a = sparse.SparseBinMatrix.from_dense(X)
    b = jax_sparse.SparseBinMatrix.from_dense(X)
    assert a.is_binary == (not real) == b.is_binary
    c = sparse.SparseBinMatrix.from_scipy(sp.csr_matrix(X))
    for m in (a, c):
        np.testing.assert_array_equal(m.rows, b.rows)
        np.testing.assert_array_equal(m.cols, b.cols)
        np.testing.assert_array_equal(m.values(), b.values())
    v = np.random.default_rng(2).standard_normal((X.shape[1], 3))
    u = np.random.default_rng(3).standard_normal((X.shape[0], 3))
    np.testing.assert_array_equal(a.matmul(v), b.matmul(v))
    np.testing.assert_array_equal(a.t_matmul(u), b.t_matmul(u))
    np.testing.assert_array_equal(a.gram(), b.gram())
    np.testing.assert_array_equal(a.col_sq_sums(), b.col_sq_sums())
    np.testing.assert_array_equal(a.to_dense(), X)
    np.testing.assert_allclose(a.gram(), X.T @ X, atol=1e-12)
    if not real:
        y = sparse.spmm(torch.from_numpy(a.rows), torch.from_numpy(a.cols),
                        X.shape[0], _t(v))
        np.testing.assert_allclose(y.numpy(), X @ v, atol=1e-12)
        yt = sparse.spmm_t(torch.from_numpy(a.rows),
                           torch.from_numpy(a.cols), X.shape[1], _t(u))
        np.testing.assert_allclose(yt.numpy(), X.T @ u, atol=1e-12)


@pytest.mark.parametrize("widths", [(8, 16, 32), (2, 4)])
@pytest.mark.parametrize("real", [False, True])
def test_bucketed_spmm_matches_matmul(real, widths):
    """X @ V and X' @ U on the bucketed layouts equal the dense products;
    with widths (2, 4) most rows are cut into several pieces (the index
    copy's later levels).  Two calls give the same bits."""
    X = _coo(4, n=30, f=50, density=0.3, real=real)
    F = sparse.SparseBinMatrix.from_dense(X)
    mv = spmv.build_bucketed_matvec(F.rows, F.cols, F.shape, vals=F.vals,
                                    widths=widths, dtype=np.float64)
    assert len(mv["t"]["levels"]) > (1 if widths == (2, 4) else 0)
    rng = np.random.default_rng(5)
    V, U = rng.standard_normal((50, 4)), rng.standard_normal((30, 4))
    y = spmv.bucketed_spmm(mv["fwd"], 30, _t(V))
    yt = spmv.bucketed_spmm(mv["t"], 50, _t(U))
    np.testing.assert_allclose(y.numpy(), X @ V, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(yt.numpy(), X.T @ U, rtol=1e-12, atol=1e-12)
    assert torch.equal(y, spmv.bucketed_spmm(mv["fwd"], 30, _t(V)))
    # no stored value: every output row reads 0
    empty = spmv.build_bucketed_matvec(np.zeros(0, np.int32),
                                       np.zeros(0, np.int32), (3, 2))
    assert torch.equal(spmv.bucketed_spmm(empty["fwd"], 3, torch.ones(2, 4)),
                       torch.zeros(3, 4))


def _spd_problem(seed, f=23, k=3, nys=False):
    X = _coo(seed, n=40, f=f, density=0.25, real=True)
    lam = 0.7
    A = X.T @ X + lam * np.eye(f)
    rhs = np.random.default_rng(seed + 1).standard_normal((f, k))
    return X, lam, A, rhs


@pytest.mark.parametrize("prec", ["none", "jacobi", "nystrom"])
def test_block_cg_matches_jax_and_solve(prec):
    """``block_cg`` against ``numpy.linalg.solve`` (to the tolerance) and
    the JAX ``block_cg`` on the same operator: the same iteration count,
    iterates; the exit-time true residual at the rounding floor; and at
    maxiter the residual where it stopped."""
    X, lam, A, rhs = _spd_problem(6)
    kw_t, kw_j = {}, {}
    if prec == "jacobi":
        diag = (X * X).sum(0) + lam
        kw_t["precond_diag"], kw_j["precond_diag"] = _t(diag), jnp.asarray(
            diag)
    elif prec == "nystrom":
        F = sparse.SparseBinMatrix.from_dense(X)
        Un, dn = precond.build_nystrom(F.rows, F.cols, F.values(), F.shape,
                                       5, seed=3)
        Uj, dj = jax_precond.build_nystrom(F.rows, F.cols, F.values(),
                                           F.shape, 5, seed=3)
        np.testing.assert_array_equal(Un, Uj)
        np.testing.assert_array_equal(dn, dj)
        kw_t["precond"] = lambda r: precond.nystrom_apply(_t(Un), _t(dn),
                                                          lam, r)
        kw_j["precond"] = lambda r: jax_precond.nystrom_apply(
            jnp.asarray(Uj), jnp.asarray(dj), lam, r)
    At = _t(A)
    x0 = torch.zeros(23, 3, dtype=torch.float64)
    x, it, res = cg.block_cg(lambda v: At @ v, _t(rhs), x0, tol=1e-10,
                             maxiter=200, **kw_t)
    xj, itj, resj = jax_cg.block_cg(lambda v: jnp.asarray(A) @ v,
                                    jnp.asarray(rhs), jnp.zeros((23, 3)),
                                    tol=1e-10, maxiter=200, **kw_j)
    assert it == int(itj) and 0 < it < 200
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-9,
                               atol=1e-12)
    # both true residuals at the rounding floor
    assert float(res) < 1e-11 and float(resj) < 1e-11
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(A, rhs),
                               rtol=1e-7, atol=1e-9)
    _, it2, res2 = cg.block_cg(lambda v: At @ v, _t(rhs), x0, tol=1e-10,
                               maxiter=2)
    assert it2 == 2 and float(res2) > 1e-6


@pytest.mark.parametrize("n_refine", [0, 1])
def test_dual_solve_matches_solve(n_refine):
    """``dual_solve_g`` and ``dual_solve`` on the port's eigendecomposition
    (N = 17 < F = 31) against ``numpy.linalg.solve`` and the JAX
    ``dual_solve_g``; uhat = X beta."""
    X = _coo(7, n=17, f=31, density=0.3, real=True)
    F = sparse.SparseBinMatrix.from_dense(X)
    lam = 0.4
    rhs = np.random.default_rng(8).standard_normal((31, 3))
    Q, d, G = dual.dual_eig_cached(F.rows, F.cols, F.values(), F.shape,
                                   np.float64, None, "cpu")
    np.testing.assert_allclose(G, X @ X.T, atol=1e-12)
    Xt = _t(X)
    fwd, t = (lambda v: Xt @ v), (lambda v: Xt.mT @ v)
    beta, uhat = dual.dual_solve_g(Q, d, _t(G), lam, _t(rhs), fwd, t,
                                   n_refine)
    want = np.linalg.solve(X.T @ X + lam * np.eye(31), rhs)
    np.testing.assert_allclose(beta.numpy(), want, rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(uhat.numpy(), X @ want, rtol=1e-9,
                               atol=1e-11)
    np.testing.assert_allclose(
        dual.dual_solve(Q, d, lam, _t(rhs), fwd, t).numpy(), want,
        rtol=1e-9, atol=1e-11)
    Qj, dj = jax_dual.dual_eig(G, np.float64)
    Xj = jnp.asarray(X)
    bj, zj = jax_dual.dual_solve_g(
        jnp.asarray(Qj), jnp.asarray(dj), jnp.asarray(G), lam,
        jnp.asarray(rhs), lambda v: Xj @ v, lambda v: Xj.T @ v, n_refine)
    np.testing.assert_allclose(beta.numpy(), np.asarray(bj), rtol=1e-9,
                               atol=1e-11)
    np.testing.assert_allclose(d.numpy(), dj, rtol=1e-10, atol=1e-10)


def test_dual_eig_cache_roundtrip(tmp_path):
    """The second build on the same features loads the stored (Q, d)
    bit for bit; other values give another file."""
    rng = np.random.default_rng(7)
    rows, cols = np.nonzero(rng.random((12, 20)) < 0.3)
    vals = rng.random(rows.shape[0])
    times = {}
    a = dual.dual_eig_cached(rows, cols, vals, (12, 20), np.float64,
                             str(tmp_path), "cpu", timings=times)
    assert set(times) == {"gram", "eigh"}
    assert len(list(tmp_path.glob("dualeig_*.npz"))) == 1
    b = dual.dual_eig_cached(rows, cols, vals, (12, 20), np.float64,
                             str(tmp_path), "cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    dual.dual_eig_cached(rows, cols, vals + 1.0, (12, 20), np.float64,
                         str(tmp_path), "cpu")
    assert len(list(tmp_path.glob("dualeig_*.npz"))) == 2
    # float32 above N = 2048 only: at N = 12 the decomposition is float64
    Q32, d32 = dual.dual_eig(a[2], np.float32, "cpu")
    assert Q32.dtype == torch.float32
    np.testing.assert_allclose(d32.numpy(), a[1].numpy(), rtol=1e-6,
                               atol=1e-6)


def test_choices_match_jax(monkeypatch):
    """``use_dual``, ``resolve_nystrom_rank``, ``use_dense_feat`` (at the
    JAX package's operand size, ``feat_itemsize``, and with its constants
    set into the port's module: the port's are the card's) and the
    config's M8 defaults equal the JAX package's, the ChEMBL bench shape
    included."""
    monkeypatch.setattr(dg, "_FEAT_HBM_BPS", jax_dg._HBM_BPS)
    monkeypatch.setattr(dg, "_SPMM_S_PER_NNZ", jax_dg._SPMM_S_PER_NNZ)
    for args in [(None, 15_000, 32_000, 4, 4.0), (None, 15_000, 32_000, 8,
                                                   4.0),
                 (None, 5_000, 4_000, 4, 4.0), ("cg", 10, 5_000, 4, 4.0),
                 ("dual", 50, 20, 8, 4.0), (None, 40_000, 4_096, 4, 4.0)]:
        assert dual.use_dual(*args) == jax_dual.use_dual(*args), args
    for r, f in [(None, 32_000), (None, 9_000), (None, 4_096), (0, 32_000),
                 (64, 100)]:
        assert (precond.resolve_nystrom_rank(r, f)
                == jax_precond.resolve_nystrom_rank(r, f))
    for binary in (True, False):
        for gd in (None, "bfloat16"):
            for dt in (np.float32, np.float64):
                it = dg.feat_itemsize(binary, gd, dt)
                want = (1 if binary and gd == "bfloat16"
                        else np.dtype(dt).itemsize)
                assert it == want
                for n, f, nnz in [(15_000, 32_000, 598_000),
                                  (100, 50, 1_000), (15_000, 4_096, 600_000),
                                  (60_000, 32_000, 60_000)]:
                    for mode in (None, True, False):
                        assert dg.use_dense_feat(n, f, nnz, it, mode) == \
                            jax_dg.use_dense_feat(n, f, nnz, it, mode)
    assert dg.use_dense_feat(15_000, 32_000, 598_000, 1, None)
    jax_f = {f.name: f.default for f in dataclasses.fields(MacauConfig)}
    for name in ("lambda_beta", "sample_lambda_beta", "nu_beta",
                 "lambda_beta_mean", "use_ff", "ff_threshold",
                 "beta_solver", "dual_budget_gb", "dual_cache_dir",
                 "dual_refine", "cg_tol", "cg_maxiter", "cg_nystrom_rank"):
        assert getattr(bt.MacauConfig(), name) == jax_f[name], name


def test_use_dense_feat_card_constants():
    """On the card's constants the ChEMBL bench shape (15,000 x 32,000
    binary, ~600,000 stored) takes the bucketed matvec, which the card
    runs faster there (PERF.md §6), where the TPU's took the dense X; a
    dense enough X still takes the dense operand, and the flags decide
    alone as before."""
    assert not dg.use_dense_feat(15_000, 32_000, 600_534, 1, None)
    assert dg.use_dense_feat(15_000, 4_096, 30_000_000, 1, None)
    assert dg.use_dense_feat(15_000, 32_000, 600_534, 1, True)
    assert not dg.use_dense_feat(15_000, 32_000, 60_000_000, 1, False)
    assert not dg.use_dense_feat(100, 50, 1_000, 4, None)


def test_sample_lambda_beta_and_chol_solve_match_jax():
    """The lambda_beta draw and the batched Cholesky solve equal the JAX
    package's on the same inputs."""
    rng = np.random.default_rng(9)
    beta = rng.standard_normal((11, 4))
    A = rng.standard_normal((4, 4))
    Lam = A @ A.T + 4 * np.eye(4)
    got = hyper.sample_lambda_beta(_t(beta), _t(Lam), torch.tensor(3.5),
                                   1e-3, 1.5)
    want = jax_hyper.sample_lambda_beta(jnp.asarray(beta), jnp.asarray(Lam),
                                        jnp.asarray(3.5), 1e-3, 1.5)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-13)
    B = rng.standard_normal((3, 4, 4))
    P = B @ B.transpose(0, 2, 1) + 4 * np.eye(4)
    for b in (rng.standard_normal((3, 4)), rng.standard_normal((3, 4, 2))):
        np.testing.assert_allclose(
            mvn.chol_solve(_t(P), _t(b)).numpy(),
            np.asarray(jax_mvn.chol_solve(jnp.asarray(P), jnp.asarray(b))),
            rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("case", ["ties", "all_tied", "no_ties",
                                  "one_class"])
def test_auc_matches_jax(case):
    """``auc_device`` and the host ``_auc`` against the JAX package's, on
    scores with tie groups (midranks), all tied, none tied, and one class
    only (the host AUC is NaN, the device one 0, as in JAX)."""
    rng = np.random.default_rng(10)
    n = 61
    if case == "ties":
        scores = rng.integers(0, 6, n).astype(np.float64)
    elif case == "all_tied":
        scores = np.full(n, 0.25)
    else:
        scores = rng.standard_normal(n)
    labels = rng.random(n) < 0.4
    if case == "one_class":
        labels[:] = True
    host = engine._auc(labels, scores)
    want = jax_engine._auc(labels, scores)
    dev = float(engine.auc_device(torch.from_numpy(labels.astype(
        np.float64)), _t(scores)))
    want_dev = float(jax_engine.auc_device(
        jnp.asarray(labels.astype(np.float64)), jnp.asarray(scores)))
    if case == "one_class":
        assert np.isnan(host) and np.isnan(want)
    else:
        assert host == want
        np.testing.assert_allclose(dev, host, rtol=1e-14)
    np.testing.assert_allclose(dev, want_dev, rtol=1e-14)


def test_synthetic_chembl_matches_jax():
    """The ChEMBL generator at a small size: the same features, relation,
    entities and class_cut as the JAX package's for the same seed."""
    kw = dict(n_compounds=300, n_targets=20, n_features=500, nnz=2_000,
              feat_per_compound=12, seed=3)
    rt = datasets.synthetic_chembl(**kw)
    rj = jax_datasets.synthetic_chembl(**kw)
    assert datasets.CLASS_CUT_IC50 == jax_datasets.CLASS_CUT_IC50
    Ft, Fj = rt.entities[0].F, rj.entities[0].F
    np.testing.assert_array_equal(Ft.rows, Fj.rows)
    np.testing.assert_array_equal(Ft.cols, Fj.cols)
    assert Ft.is_binary and Fj.is_binary and Ft.shape == Fj.shape
    dt, dj = rt.relations[0].data, rj.relations[0].data
    np.testing.assert_array_equal(dt.idx, dj.idx)
    np.testing.assert_array_equal(dt.vals, dj.vals)
    assert rt.relations[0].class_cut == rj.relations[0].class_cut
    assert [(e.name, e.count, e.num_features) for e in rt.entities] == [
        (e.name, e.count, e.num_features) for e in rj.entities]


def test_entity_features_api():
    """``Entity(F=...)`` takes a dense array, a scipy matrix or a
    ``SparseBinMatrix``, sets the count, checks it, and carries a
    per-entity lambda_beta override as the JAX package does."""
    X = _coo(11, n=6, f=4, real=True)
    for F in (X, sp.coo_matrix(X), bt.SparseBinMatrix.from_dense(X)):
        e = bt.Entity("compound", F=F)
        assert e.count == 6 and e.num_features == 4 and e.has_features
        np.testing.assert_array_equal(e.F.to_dense(), X)
    with pytest.raises(ValueError, match="feature rows"):
        bt.Entity("compound", count=5, F=X)
    assert not bt.Entity("target", count=3).has_features
    e = bt.Entity("compound", F=X)
    e.model.lambda_beta = 7.0
    ej = bdf.Entity("compound", F=X)
    ej.model.lambda_beta = 7.0
    from bayesiandatafusion_jl_tpu.models.data import \
        resolved_lambda_beta as jax_rlb
    from bayesiandatafusion_jl_tpu_torch.models.data import \
        resolved_lambda_beta
    assert resolved_lambda_beta(e, bt.MacauConfig()) == jax_rlb(
        ej, MacauConfig()) == 7.0
    assert isinstance(e.model, bt.EntityModel)
