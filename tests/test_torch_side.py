"""Side information (Macau) on the port against the JAX engine, float64 on
the CPU with injected randoms: the beta draw by each solver (FF, dual, CG
with Jacobi or Nystrom), binary and real-valued features, the dense and
the bucketed feature operand, features on both entities, lambda_beta
fixed or sampled, a sampled alpha, the class_cut AUC, and a state carried
across from the JAX engine mid-chain.  U, mu, Lambda, beta, uhat,
lambda_beta, alpha and the metrics agree over 3 sweeps to 1e-8 (FF, dual)
or 1e-6 (CG at cg_tol=1e-12), the tolerances of test_oracle_equiv.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bayesiandatafusion_jl_tpu.models.engine import _auc as jax_auc
from bayesiandatafusion_jl_tpu.utils.rng import draw_all_numpy
from bayesiandatafusion_jl_tpu_torch.utils.convert import state_to_numpy
from _torch_side_cases import (CG_TOL, DIRECT_TOL, engines, features,
                               matrix, run_both)

_SOLVERS = {"ff": (13, dict(use_ff=True), DIRECT_TOL),
            "cg": (13, dict(use_ff=False, cg_tol=1e-12), CG_TOL),
            # N = 22 < F = 30: the dual system is the smaller one
            "dual": (30, dict(use_ff=False, beta_solver="dual"), DIRECT_TOL)}


@pytest.mark.parametrize("kind", ["binary", "real"])
@pytest.mark.parametrize("solver", ["ff", "cg", "dual"])
def test_beta_solver_matches_jax(solver, kind):
    """Each solver on binary and on real-valued features, the bucketed
    feature operand, lambda_beta sampled: both engines resolve the same
    solver and agree over 3 sweeps."""
    nf, opts, tol = _SOLVERS[solver]
    rng = np.random.default_rng(40 + len(solver) + len(kind))
    F = features(rng, 22, nf, kind)
    ej, et = engines(matrix(rng), feat1=F, **opts)
    assert et.problem.entity_specs[0].solver == solver
    assert et.problem.entity_specs[1].solver == "cg"      # no features
    assert (et.problem.feat["e0"].get("mv") is not None
            and "dense_X" not in et.problem.feat["e0"])
    assert et.problem.entity_specs[0].feat_nnz == np.count_nonzero(F)
    run_both(ej, et, tol=tol)


@pytest.mark.parametrize("solver", ["cg", "dual"])
def test_dense_x_matches_jax(solver):
    """dense_gram=True: both engines keep the dense [N, F] X for the beta
    products (``use_dense_feat``), the port in float64."""
    nf, opts, tol = _SOLVERS[solver]
    rng = np.random.default_rng(35)
    F = features(rng, 22, nf)
    ej, et = engines(matrix(rng), feat1=F, dense_gram=True, **opts)
    assert "dense_X" in ej.problem.arrays["feat"]["e0"]
    X = et.problem.feat["e0"]["dense_X"]
    np.testing.assert_array_equal(X.numpy(), F)
    run_both(ej, et, tol=tol)


def test_nystrom_cg_matches_jax():
    """CG with the Nystrom preconditioner (rank 3, F = 13 >= 4 x 3): the
    same factors (same seed), the same iterations and draws."""
    rng = np.random.default_rng(36)
    F = features(rng, 22, 13, "real")
    ej, et = engines(matrix(rng), feat1=F, use_ff=False, cg_tol=1e-12,
                     cg_nystrom_rank=3)
    feat = et.problem.feat["e0"]
    assert feat["nys_U"].shape == (13, 3)
    np.testing.assert_allclose(feat["nys_U"].numpy(),
                               ej.problem.arrays["feat"]["e0"]["nys_U"],
                               rtol=1e-12, atol=1e-12)
    run_both(ej, et, tol=CG_TOL)


def test_features_on_both_entities_match_jax():
    """Both entities with features, the first on FF (real-valued, F = 9
    <= ff_threshold), the second (17 rows, 25 features) kept off FF by its
    own ``use_ff`` and on the dual solve; lambda_beta fixed (no ``lb_g``
    draw) and alpha sampled."""
    rng = np.random.default_rng(37)
    F1 = features(rng, 22, 9, "real")
    F2 = features(rng, 17, 25)
    ej, et = engines(matrix(rng), feat1=F1, feat2=F2, beta_solver="dual",
                     sample_lambda_beta=False, alpha_sample=True,
                     lambda_beta=2.5, ent_use_ff=(None, False))
    assert [es.solver for es in et.problem.entity_specs] == ["ff", "dual"]
    assert not any(k.endswith("lb_g") for k in et.problem.random_spec)
    _, st = run_both(ej, et)
    assert all(float(e["lambda_beta"]) == 2.5 for e in st["ent"])


def test_state_from_jax_midchain_matches():
    """A JAX state with beta, lambda_beta and uhat after 2 sweeps, carried
    across by ``utils/convert``: the next sweep of both engines agrees."""
    rng = np.random.default_rng(38)
    F = features(rng, 22, 30)
    ej, et = engines(matrix(rng), feat1=F, use_ff=False, beta_solver="dual")
    state_j = ej.init_state(jax.random.fold_in(jax.random.key(5), 0))
    r = np.random.default_rng(3)
    for s in range(2):
        randoms = draw_all_numpy(r, ej.problem.random_spec, np.float64)
        state_j, _ = ej._sweep_randoms_jit(
            ej.problem.arrays, state_j,
            {k: jnp.asarray(v) for k, v in randoms.items()}, 1.0)
    assert float(jnp.linalg.norm(state_j["ent"][0]["beta"])) > 0
    run_both(ej, et, n_sweeps=1, state_j=state_j)


def test_results_auc_matches_jax():
    """After 3 sweeps, the port's results carry the JAX engine's RMSE, AUC
    and accuracy of the posterior mean, and the per-sweep AUC metric is the
    host AUC of the running posterior mean."""
    rng = np.random.default_rng(39)
    F = features(rng, 22, 13)
    ej, et = engines(matrix(rng), feat1=F, use_ff=True)
    sj, st = run_both(ej, et)
    rj = ej._results(sj, [])
    rt = et._results(st, [])
    for key in ("RMSE", "AUC", "accuracy"):
        np.testing.assert_allclose(rt[key], rj[key], rtol=1e-8)
    pr = state_to_numpy(st)["pred"]["r0"]
    pmean = pr["sum"] / pr["n"]
    obs = rt["predictions"]["obs"] < 0.0
    assert rt["AUC"] == jax_auc(obs, -pmean)
