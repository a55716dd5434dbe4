"""Shared cases of the side-information parity tests: the JAX engine and
the port's on the same small Macau problem, stepped with the same injected
randoms (``draw_all_numpy``), and the checks of each sweep's state."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import bayesiandatafusion_jl_tpu as bdf
from bayesiandatafusion_jl_tpu.models.engine import MacauEngine
from bayesiandatafusion_jl_tpu.utils.config import MacauConfig
from bayesiandatafusion_jl_tpu.utils.rng import draw_all_numpy
import bayesiandatafusion_jl_tpu_torch as bt
from bayesiandatafusion_jl_tpu_torch.utils import rng as trng
from bayesiandatafusion_jl_tpu_torch.utils.convert import (state_from_numpy,
                                                           state_to_numpy)

# the solvers' tolerances of tests/test_oracle_equiv.py: FF and dual are
# direct solves, CG stops at cg_tol
DIRECT_TOL, CG_TOL = 1e-8, 1e-6


def features(rng, n, f, kind="binary", density=0.3):
    """A dense [n, f] feature array: 0/1 cells, or N(0, 1) values at the
    stored cells ("real")."""
    mask = rng.random((n, f)) < density
    if kind == "binary":
        return mask.astype(np.float64)
    return rng.standard_normal((n, f)) * mask


def matrix(rng, n1=22, n2=17, density=0.5):
    """(idx, vals, shape) of one small N(0, 1)-valued relation."""
    R = rng.standard_normal((n1, n2))
    mask = rng.random((n1, n2)) < density
    idx = np.stack(np.nonzero(mask), 1)
    return idx, R[mask], (n1, n2)


def engines(rel, feat1=None, feat2=None, K=3, n_test=40, class_cut=0.0,
            pallas="off", seed=13, alpha_sample=False,
            ent_use_ff=(None, None), **opts):
    """Both engines on one relation (idx, vals, shape) with the entities'
    side features (and their own ``use_ff``, ``ent_use_ff``), a test split
    and a ``class_cut``; the port's on the CPU.  ``opts`` go into both
    configs."""
    idx, vals, shape = rel
    rds = []
    for pkg in (bdf, bt):
        rd = pkg.RelationData.from_matrix(pkg.IndexedDF(idx, vals, shape),
                                          feat1=feat1, feat2=feat2,
                                          class_cut=class_cut)
        rd.assign_to_test(0, n_test, seed=7)
        for e, ff in zip(rd.entities, ent_use_ff):
            e.use_ff = ff
        if alpha_sample:
            rd.set_precision(0, 2.0, sample=True)
        rds.append(rd)
    return build(*rds, K=K, pallas=pallas, seed=seed, **opts)


def fusion_engines(K=3, pallas="off", seed=17, **opts):
    """Both engines on a two-relation graph whose shared compound entity
    (22 rows) has real-valued side features: compound x target (17) with
    a test split and a class_cut, compound x assay (9) with a sampled
    alpha."""
    rng = np.random.default_rng(21)
    F = features(rng, 22, 13, "real")
    r0, r1 = matrix(rng), matrix(rng, 22, 9, 0.6)
    rds = []
    for pkg in (bdf, bt):
        comp = pkg.Entity("compound", F=F)
        rd = pkg.RelationData()
        rd.add_relation(pkg.IndexedDF(*r0), "ic50",
                        [comp, pkg.Entity("target", count=17)],
                        class_cut=0.0)
        rd.add_relation(pkg.IndexedDF(*r1), "assay",
                        [comp, pkg.Entity("assay", count=9)])
        rd.assign_to_test("ic50", 40, seed=7)
        rd.set_precision("assay", 3.0, sample=True)
        rds.append(rd)
    return build(*rds, K=K, pallas=pallas, seed=seed, **opts)


def build(rd_j, rd_t, K, pallas, seed, **opts):
    common = dict(num_latent=K, dtype="float64", seed=seed, verbose=False,
                  **opts)
    ej = MacauEngine(rd_j, MacauConfig(pallas=pallas, **common))
    et = bt.MacauEngine(rd_t, bt.MacauConfig(**common), device="cpu")
    assert [es.solver for es in et.problem.entity_specs] == [
        es.solver for es in ej.problem.entity_specs]
    assert [es.use_ff for es in et.problem.entity_specs] == [
        es.use_ff for es in ej.problem.entity_specs]
    return ej, et


def run_both(ej, et, n_sweeps=3, tol=DIRECT_TOL, state_j=None):
    """``n_sweeps`` sweeps of both engines from the JAX engine's initial
    state (or ``state_j``), carried across by ``utils/convert``, with the
    same randoms; after each, every entity's U, mu, Lambda (and beta, uhat
    and lambda_beta where it has features), every alpha, the prediction
    sums and the metrics agree to ``tol``.  Returns the final states."""
    if state_j is None:
        state_j = ej.init_state(jax.random.fold_in(jax.random.key(5), 0))
    state_t = state_from_numpy(jax.device_get(state_j), "cpu",
                               torch.float64)
    spec = ej.problem.random_spec
    assert et.problem.random_spec == {
        k: trng.DrawSpec(v.kind, v.shape, v.gamma_a)
        for k, v in spec.items()}
    rng = np.random.default_rng(999)
    for s in range(n_sweeps):
        randoms = draw_all_numpy(rng, spec, np.float64)
        acc = 1.0 if s >= 1 else 0.0
        state_j, mj = ej._sweep_randoms_jit(
            ej.problem.arrays, state_j,
            {k: jnp.asarray(v) for k, v in randoms.items()}, acc)
        state_t, mt = et._sweep_with_randoms(
            state_t, {k: torch.from_numpy(v) for k, v in randoms.items()},
            acc)
        check_states(jax.device_get(state_j), state_to_numpy(state_t),
                     tol, f"sweep {s}")
        mj = {k: float(v) for k, v in mj.items()}
        mt = {k: float(v) for k, v in mt.items()}
        assert set(mt) == set(mj), (sorted(mt), sorted(mj))
        for k in mj:
            if k.endswith("cg_iters"):
                # at cg_tol=1e-12 the stopping test compares a residual
                # at the rounding floor, which the two engines' sums can
                # put on either side: one iteration apart at most (equal
                # on equal inputs: test_torch_beta_ops.py)
                assert abs(mt[k] - mj[k]) <= 1, (k, mt[k], mj[k])
            elif not k.endswith("cg_resid"):
                np.testing.assert_allclose(mt[k], mj[k], rtol=tol, atol=tol,
                                           err_msg=f"{k} sweep {s}")
    return state_j, state_t


def check_states(sj, st, tol, where):
    assert [sorted(e) for e in st["ent"]] == [sorted(e) for e in sj["ent"]]
    for ei, (ej_, et_) in enumerate(zip(sj["ent"], st["ent"])):
        for key in ej_:
            np.testing.assert_allclose(
                et_[key], ej_[key], rtol=tol, atol=tol,
                err_msg=f"{key} {where} entity {ei}")
    for ri, (rj, rt) in enumerate(zip(sj["rel"], st["rel"])):
        np.testing.assert_allclose(rt["alpha"], rj["alpha"], rtol=tol,
                                   err_msg=f"alpha {where} relation {ri}")
    for key in sj["pred"]:
        for part in ("sum", "sum2"):
            np.testing.assert_allclose(st["pred"][key][part],
                                       sj["pred"][key][part], rtol=tol,
                                       atol=tol, err_msg=f"{key} {where}")
