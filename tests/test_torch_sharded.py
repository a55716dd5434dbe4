"""The port's sharded engine (``parallel/sharded.py``) against the JAX
package's single-device engine, on gloo at world sizes 2 and 4.

Each case of ``_torch_sharded_worker.CASES`` runs three float64 sweeps of
the JAX ``MacauEngine`` (its samplers in XLA, ``pallas="off"``; the int8
pair case with its Pallas kernels in interpret mode) from its own initial
state and numpy randoms; the same state (a checkpoint file) and randoms
go to one launch of worker processes per world size, which run every case
through the sharded engine's injection seam.  U in original order, mu,
Lambda, beta, lambda_beta, alpha, the prediction sums and the last sweep's
metrics must agree to 1e-8 (the contract of tests/test_oracle_equiv.py).
The structural cases hold the port's ``ShardedProblem`` (built for each
rank without a process group) to the JAX ``ShardedProblem`` at 4 devices,
and its ``flops_per_sweep`` at 2 and 4.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl

import bayesiandatafusion_jl_tpu as bdf
from bayesiandatafusion_jl_tpu.models.engine import MacauEngine
from bayesiandatafusion_jl_tpu.utils.config import MacauConfig
from bayesiandatafusion_jl_tpu.utils.rng import draw_all_numpy
import _torch_sharded_worker as wk
from test_torch_planner import jax_constants

WORLDS = (2, 4)
TOL = 1e-8


def _jax_case(name, in_dir):
    """Three sweeps of the JAX engine on case ``name``; its initial state
    and randoms written to ``in_dir`` for the workers.  Returns the final
    state (numpy) and the last sweep's metrics."""
    rd, opts = wk.build_case(name, bdf)
    pallas = "on" if name == "int8_pair" else "off"
    ej = MacauEngine(rd, MacauConfig(pallas=pallas, **opts))
    state = ej.init_state(jax.random.fold_in(jax.random.key(5), 0))
    leaves = jax.tree_util.tree_leaves(jax.device_get(state))
    np.savez(os.path.join(in_dir, f"{name}.init.npz"), sweep=0,
             n_leaves=len(leaves),
             **{f"leaf{i}": np.asarray(a) for i, a in enumerate(leaves)})
    rng = np.random.default_rng(999)
    saved = {}
    for s in range(wk.SWEEPS):
        randoms = draw_all_numpy(rng, ej.problem.random_spec, np.float64)
        saved.update({f"s{s}/{k}": v for k, v in randoms.items()})
        state, m = ej._sweep_randoms_jit(
            ej.problem.arrays, state,
            {k: jnp.asarray(v) for k, v in randoms.items()},
            1.0 if s >= 1 else 0.0)
    np.savez(os.path.join(in_dir, f"{name}.randoms.npz"), **saved)
    return jax.device_get(state), {k: float(v) for k, v in m.items()}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """{case: (JAX final state, metrics)} and the workers' input folder."""
    in_dir = str(tmp_path_factory.mktemp("sharded_in"))
    orig = pl.pallas_call
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", functools.partial(orig, interpret=True))
        runs = {name: _jax_case(name, in_dir) for name in wk.CASES}
    return runs, in_dir


@pytest.fixture(scope="module")
def launches(jax_runs, tmp_path_factory):
    """{world: output folder}: one launch of worker processes a world
    size, every case in it (and, at world 2, the driver checks)."""
    _, in_dir = jax_runs
    out = {}
    for world in WORLDS:
        d = str(tmp_path_factory.mktemp(f"sharded_w{world}"))
        names = wk.CASES + (("driver",) if world == 2 else ())
        try:
            wk.launch(world, in_dir, d, names)
        except Exception:
            errs = [open(os.path.join(d, f)).read() for f in os.listdir(d)
                    if f.startswith("error")]
            raise AssertionError(f"world {world} failed: {errs}")
        out[world] = d
    return out


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", wk.CASES)
def test_sharded_matches_jax_engine(jax_runs, launches, world, name):
    """Three sweeps from one state and one set of randoms: the sharded
    engine at ``world`` ranks equals the JAX single-device engine to 1e-8
    in float64."""
    runs, _ = jax_runs
    sj, mj = runs[name]
    z = np.load(os.path.join(launches[world], f"{name}.w{world}.npz"))
    for ei, ent in enumerate(sj["ent"]):
        for key in ("U", "mu", "Lambda", "beta", "lambda_beta"):
            if key in ent:
                np.testing.assert_allclose(
                    z[f"e{ei}.{key}"], ent[key], rtol=TOL, atol=TOL,
                    err_msg=f"{name} world {world} e{ei}.{key}")
    for ri, rel in enumerate(sj["rel"]):
        np.testing.assert_allclose(z[f"r{ri}.alpha"], rel["alpha"],
                                   rtol=TOL, atol=TOL)
    for key, pr in sj["pred"].items():
        np.testing.assert_allclose(z[f"{key}.pred_sum"], pr["sum"],
                                   rtol=TOL, atol=TOL)
    for k, v in mj.items():
        if k.endswith(("rmse_sample", "rmse_avg", "auc", "alpha", "unorm",
                       "betanorm", "lambda_beta")):
            np.testing.assert_allclose(z[f"m/{k}"], v, rtol=TOL, atol=TOL,
                                       err_msg=f"{name} metric {k}")
    # the branch the case is there for
    want = {"int8_pair": "pair", "float_pair": "pair", "tensor_int8": "pair",
            "fused_s8_residual": "fused"}.get(name, "gather")
    assert z["kinds"][0] == want
    if name == "head_split":
        assert z["exchange_blocks"] == 2 and z["n_head"].tolist() == [8, 8]
    if name == "macau_dual":
        assert "m/r0.auc" in z.files
    solver = {"macau_ff": "ff", "macau_dual": "dual",
              "macau_nystrom": "cg"}.get(name)
    if solver is not None:
        assert z["solvers"][0] == solver
    if name == "fused_s8_residual":
        assert z["residual_nnzs"][0] > 0


@pytest.fixture(scope="module")
def driver(launches):
    return np.load(os.path.join(launches[2], "driver.w2.npz")), launches[2]


def test_sharded_resume_bitwise(driver):
    """At world 2, a chain resumed from its sweep-3 checkpoint (written by
    rank 0, read by every rank) ends in the same state, bit for bit, as
    the chain without interruption; the posterior samples were dumped."""
    z, d = driver
    assert z["kinds"].tolist() == ["fused"]
    assert int(z["resume_sweep"]) == 3 and bool(z["resume_equal"])
    assert sorted(f for f in os.listdir(d) if f.startswith("drv-sample")) \
        == [f"drv-sample{i:04d}.npz" for i in range(3)]


def test_sharded_windows_bitwise(driver):
    """At world 2, windows of 3 sweeps give the one-sweep windows' state
    bit for bit."""
    assert bool(driver[0]["windows_equal"])


def test_sharded_run_matches_world1(driver):
    """At world 2, ``run()``'s RMSE and predictions (original order) equal
    the same chain's at world 1 (a one-rank group) to 1e-8."""
    z, _ = driver
    np.testing.assert_allclose(z["rmse"], z["rmse_w1"], rtol=TOL)
    np.testing.assert_allclose(z["pred"], z["pred_w1"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(z["stdev"], z["stdev_w1"], rtol=TOL,
                               atol=TOL)
    assert np.isfinite(z["rmse"]) and z["idx"].shape[0] == z["pred"].shape[0]


def _problems(name, world=4):
    """The JAX ShardedProblem at ``world`` devices (pads by the device
    count: ``pallas="off"``) and the port's for each rank, on case
    ``name``'s graph."""
    from bayesiandatafusion_jl_tpu.parallel.sharded import \
        ShardedProblem as JaxProblem
    import bayesiandatafusion_jl_tpu_torch as bt
    import torch
    from bayesiandatafusion_jl_tpu_torch.parallel.sharded import \
        ShardedProblem
    rd_j, opts = wk.build_case(name, bdf)
    pj = JaxProblem(rd_j, MacauConfig(pallas="off", **opts), world)
    rd_t, _ = wk.build_case(name, bt)
    pts = [ShardedProblem(rd_t, bt.MacauConfig(**opts), world, r,
                          torch.device("cpu")) for r in range(world)]
    return pj, pts


def test_instance_permutation_matches_jax():
    """The hash partition is the JAX package's, bit for bit."""
    from bayesiandatafusion_jl_tpu.parallel.mesh import \
        instance_permutation as jax_perm
    from bayesiandatafusion_jl_tpu_torch.parallel.mesh import \
        instance_permutation
    for n, ei in ((1, 0), (53, 0), (37, 1), (10_681, 1), (480_189, 0),
                  (7, 5)):
        np.testing.assert_array_equal(instance_permutation(n, ei),
                                      jax_perm(n, ei))


@pytest.mark.parametrize("name", ["head_split", "int8_pair",
                                  "fused_s8_residual", "tensor_alpha",
                                  "macau_dual"])
def test_sharded_problem_matches_jax(name):
    """Every rank's problem equals the JAX ShardedProblem's at 4 devices:
    the permutations, n_pad, n_loc, n_head and the head positions, the
    exchange depth, the dense plans (kind, focus count, partner counts;
    the planner's constants set to the JAX package's, as in
    tests/test_torch_planner.py) and the fused relations' encodings."""
    with jax_constants():
        pj, pts = _problems(name)
    for pt in pts:
        assert pt.exchange_blocks == pj.exchange_blocks
        for ei, mj in enumerate(pj.ent_meta):
            mt = pt.ent_meta[ei]
            assert (mt.n, mt.n_pad, mt.n_loc, mt.n_head) == (
                mj.n, mj.n_pad, mj.n_loc, mj.n_head)
            np.testing.assert_array_equal(pt.perms[ei], pj.perms[ei])
            np.testing.assert_array_equal(pt.head_pos[ei], pj.head_pos[ei])
        assert {k: (v.kind, v.n_focus, tuple(v.partner_counts))
                for k, v in pt.dense_plans.items()} == {
            k: (v.kind, v.n_focus, tuple(v.partner_counts))
            for k, v in pj.dense_plans.items()}
        assert {ri: tuple(v[:2]) for ri, v in pt.plan.fused.items()} == {
            ri: tuple(v) for ri, v in pj.fused_rels.items()}
        assert pt.fused_i8s == [pj.fused_i8.get(ri, False)
                                for ri in range(len(pj.rel_specs))]
    if name == "head_split":
        assert [m.n_head for m in pj.ent_meta] == [8, 8]
    if name in ("int8_pair", "fused_s8_residual"):
        assert pj.dense_plans


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["head_split", "int8_pair",
                                  "fused_s8_residual", "tensor_alpha",
                                  "macau_dual"])
def test_sharded_flops_per_sweep_matches_jax(name, world):
    """Every rank's ``flops_per_sweep`` equals the JAX ShardedProblem's at
    ``world`` devices: dense and fused modes over the padded extents,
    gather modes over the observations, the beta solvers' products."""
    with jax_constants():
        pj, pts = _problems(name, world)
    want = pj.flops_per_sweep()
    assert want > 0
    for pt in pts:
        assert pt.flops_per_sweep() == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("cfg_value, deg, n_dev", [
    (None, [1, 2, 3], 4), (7, [1, 2, 3], 4), ("auto", [1, 2, 3], 1),
    ("auto", [], 4), ("auto", [0, 0], 4), ("auto", [10, 3000, 5], 4),
    ("auto", [10, 2000, 5], 4), ("auto", [9000] + [10] * 500, 2),
    ("auto", [4000] * 8, 8), (np.int64(12), [1], 2)])
def test_resolve_head_split_matches_jax(cfg_value, deg, n_dev):
    from bayesiandatafusion_jl_tpu.parallel.sharded import \
        resolve_head_split as jax_fn
    from bayesiandatafusion_jl_tpu_torch.parallel.sharded import \
        resolve_head_split
    d = np.asarray(deg, np.int64)
    assert resolve_head_split(cfg_value, d, n_dev) == jax_fn(cfg_value, d,
                                                             n_dev)


@pytest.mark.parametrize("cfg_value, n_dev, min_n_loc", [
    (None, 1, 100_000), (None, 2, 4096), (None, 2, 4095), (None, 8, 10),
    (0, 4, 10), (3, 1, 1), (2, 4, 100_000)])
def test_resolve_exchange_blocks_matches_jax(cfg_value, n_dev, min_n_loc):
    from bayesiandatafusion_jl_tpu.parallel.sharded import \
        resolve_exchange_blocks as jax_fn
    from bayesiandatafusion_jl_tpu_torch.parallel.sharded import \
        resolve_exchange_blocks
    assert resolve_exchange_blocks(cfg_value, n_dev, min_n_loc) == jax_fn(
        cfg_value, n_dev, min_n_loc)


def test_sharded_engine_needs_card_and_group():
    """The sharded engine runs on the card unless asked for the CPU, and
    never without a process group (no fall back to one device)."""
    import torch
    import torch.distributed as dist

    import bayesiandatafusion_jl_tpu_torch as bt
    from bayesiandatafusion_jl_tpu_torch.parallel.sharded import \
        ShardedMacauEngine
    assert not dist.is_initialized()
    rd, opts = wk.build_case("bpmf_gather", bt)
    cfg = bt.MacauConfig(**opts)
    with pytest.raises(RuntimeError, match="process group"):
        ShardedMacauEngine(rd, cfg, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ShardedMacauEngine(rd, cfg)
