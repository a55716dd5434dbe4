"""Side information on every sampler branch of the port, and in a fusion
graph, against the JAX engine (float64, injected randoms, 3 sweeps to
1e-8, or 1e-6 with CG): the row-dependent prior mean Lambda (mu + uhat_i)
enters the packed branch (K1 at K = 8 on the int8 pair, the JAX side's
Pallas kernels in interpret mode; K2 at K = 36 on the float pair), the
full-P branch on the gather path ("segment": K3 at K = 8, K4 at K = 36;
"planned" at K = 8) and the dense-only full-P branch above K = 96 (the
blocked sampler at K = 100)."""
import functools

import numpy as np
import pytest
from jax.experimental import pallas as pl

from bayesiandatafusion_jl_tpu_torch.models import engine as torch_engine_mod
from bayesiandatafusion_jl_tpu_torch.ops import chol_packed, dense_gram, mvn
from _torch_side_cases import (CG_TOL, DIRECT_TOL, engines, features,
                               fusion_engines, matrix, run_both)
from _torch_xla_order import xla_cpu_ridge_step


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(orig, interpret=True))


@pytest.fixture
def xla_cpu_ridge(monkeypatch):
    """The port's ridge step summed in the JAX engine's (XLA:CPU) order."""
    monkeypatch.setattr(dense_gram, "ridge_step", xla_cpu_ridge_step)


@pytest.fixture
def port_branches(monkeypatch):
    """The port's sampler calls by name, in order: its packed and full-P
    dispatches, the planned accumulation and the kernels' wrappers (K1,
    K2, K3, K4, the blocked sampler)."""
    seen = []
    for mod, name, tag in (
            (torch_engine_mod, "chol_sample_packed_dispatch", "packed"),
            (torch_engine_mod, "chol_sample_dispatch", "full"),
            (torch_engine_mod, "assemble_precision_planned", "planned"),
            (chol_packed, "chol_sample_packed", "K1"),
            (chol_packed, "chol_sample_packed_tiled", "K2"),
            (mvn, "chol_sample_full", "K3"),
            (mvn, "chol_sample_full_tiled", "K4"),
            (mvn, "chol_sample_blocked", "blocked")):
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, _tag=tag, **kw):
            seen.append(_tag)
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, wrapped)
    return seen


def _counts(seen):
    return {t: seen.count(t) for t in set(seen)}


def test_packed_k1_int8_pair_matches_jax(interpret_pallas, xla_cpu_ridge,
                                         port_branches):
    """K = 8, the int8 pair (the ChEMBL path's): both engines keep P
    packed, the prior term (mu + uhat) Lambda added in the transposed
    [K, n] layout; the compound entity on the dual solve (F = 30 > N)."""
    rng = np.random.default_rng(50)
    F = features(rng, 22, 30)
    ej, et = engines(matrix(rng), feat1=F, K=8, pallas="on",
                     dense_gram=True, dense_int8=True, use_ff=False,
                     beta_solver="dual")
    assert et.problem.pair_i8s == [True]
    assert [es.solver for es in et.problem.entity_specs] == ["dual", "cg"]
    run_both(ej, et, tol=DIRECT_TOL)
    assert _counts(port_branches) == {"packed": 6, "K1": 6}


def test_packed_k2_matches_jax(port_branches):
    """K = 36 on the float pair, the compound entity on CG (JAX's XLA
    sampler, pallas="off"): the port's K2 branch."""
    rng = np.random.default_rng(51)
    F = features(rng, 22, 13, "real")
    ej, et = engines(matrix(rng), feat1=F, K=36, dense_gram=True,
                     use_ff=False, cg_tol=1e-12)
    run_both(ej, et, tol=CG_TOL)
    assert _counts(port_branches) == {"packed": 6, "K2": 6}


@pytest.mark.parametrize("K, accumulation, kernel", [
    (8, "segment", "K3"), (36, "segment", "K4"), (8, "planned", "K3")])
def test_gather_full_matches_jax(port_branches, K, accumulation, kernel):
    """The gather path (dense_gram=False): P full, the prior term through
    ``assemble_precision`` (Lambda left to the sampler) or
    ``assemble_precision_planned`` (Lambda in P), and the bucketed feature
    matvec; the compound entity on FF with real-valued features."""
    rng = np.random.default_rng(52 + K)
    F = features(rng, 22, 9, "real")
    ej, et = engines(matrix(rng), feat1=F, K=K, dense_gram=False,
                     accumulation=accumulation)
    assert et.problem.kinds == ["gather"]
    assert "mv" in et.problem.feat["e0"]
    run_both(ej, et, tol=DIRECT_TOL)
    want = {"full": 6, kernel: 6}
    if accumulation == "planned":
        want["planned"] = 6
    assert _counts(port_branches) == want


def test_dense_only_blocked_matches_jax(port_branches):
    """K = 100 on the float pair: the full-P branch with the dense
    contributions alone (the prior term the first b), the blocked sampler;
    the compound entity on the dual solve."""
    rng = np.random.default_rng(53)
    F = features(rng, 22, 30)
    ej, et = engines(matrix(rng), feat1=F, K=100, dense_gram=True,
                     use_ff=False, beta_solver="dual")
    run_both(ej, et, tol=DIRECT_TOL)
    assert _counts(port_branches) == {"full": 6, "blocked": 6}


@pytest.mark.parametrize("solver", ["ff", "dual"])
def test_fusion_graph_with_features_matches_jax(solver):
    """Two relations sharing a compound entity with side features (one
    relation with a class_cut, the other with a sampled alpha)."""
    opts = (dict(use_ff=False, beta_solver="dual") if solver == "dual"
            else {})
    ej, et = fusion_engines(**opts)
    assert et.problem.entity_specs[0].solver == solver
    run_both(ej, et, tol=DIRECT_TOL)
