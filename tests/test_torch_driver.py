"""The port's driver loop (``MacauEngine.run``) against the JAX package's
(``GibbsDriverMixin.run``) on the CPU in float64: the whole loop with its
jsonl log, checkpoints, posterior-sample dumps and gated metric reads, both
engines fed the same numpy randoms for each sweep (the JAX one through a
test-local ``_do_sweep``, the port through ``draw``), on the int8 pair,
the gather path, the fused path with a residual and two entities with side
features (FF and the dual solve); the log lines, checkpoint leaves and
sample files to 1e-8.  Then the port alone: resume from a checkpoint and
windows of sweeps (``sweeps_per_dispatch``) bit for bit, the fetched-sweep
pattern of ``metrics_every``, the window ends (``_chunk_limit``), the
trace, ``predictions_frame`` and ``predict_out_of_matrix``; checkpoint
and sample files read across the two packages; ``flops_per_sweep``."""
import glob
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import bayesiandatafusion_jl_tpu as bdf
from bayesiandatafusion_jl_tpu.models.engine import (CompiledProblem,
                                                     MacauEngine)
from bayesiandatafusion_jl_tpu.models.engine import \
    predict_out_of_matrix as jax_predict_out_of_matrix
from bayesiandatafusion_jl_tpu.models.engine import \
    predictions_frame as jax_predictions_frame
from bayesiandatafusion_jl_tpu.utils.config import MacauConfig
from bayesiandatafusion_jl_tpu.utils.rng import draw_all_numpy
import bayesiandatafusion_jl_tpu_torch as bt
from bayesiandatafusion_jl_tpu_torch.models.engine import _leaves
from bayesiandatafusion_jl_tpu_torch.ops import dense_gram as tdg
from bayesiandatafusion_jl_tpu_torch.utils import rng as trng
from bayesiandatafusion_jl_tpu_torch.utils.convert import (state_from_numpy,
                                                           state_to_numpy)
from chip_smoke import equal_states
from _torch_side_cases import features, matrix
from _torch_xla_order import xla_cpu_ridge_step

TOL = 1e-8
BURNIN, PSAMPLES = 3, 4


@pytest.fixture
def jax_kernels(monkeypatch):
    """The JAX engine's Pallas kernels in interpret mode, and the port's
    ridge step summed in the JAX engine's (XLA:CPU) order."""
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    monkeypatch.setattr(tdg, "ridge_step", xla_cpu_ridge_step)


def _randoms(spec, s, draw):
    """Sweep ``s``'s (0-based) randoms, the same numbers in either
    package's ``draw_all_numpy``."""
    return draw(np.random.default_rng([999, s]), spec, np.float64)


class JaxInjected(MacauEngine):
    """The JAX engine, each sweep fed ``_randoms`` of its index."""

    def _do_sweep(self, state, skey, accumulate, tag=None, **_):
        r = _randoms(self.problem.random_spec, tag, draw_all_numpy)
        return self._sweep_randoms_jit(
            self.problem.arrays, state,
            {k: jnp.asarray(v) for k, v in r.items()}, accumulate)


class PortInjected(bt.MacauEngine):
    """The port's engine, each sweep fed ``_randoms`` of its index."""

    def draw(self, sweep, seed=None):
        r = _randoms(self.problem.random_spec, sweep - 1,
                     trng.draw_all_numpy)
        return {k: torch.from_numpy(v).to(self.device) for k, v in r.items()}


def _graph(pkg, path):
    """The path's RelationData in ``pkg`` (the JAX package or the port):
    half-star ratings 60 x 45 (with 9 cells rated twice for the fused
    residual), or a relation whose two entities carry features (22 x 9
    real-valued ones, FF; 17 x 25 binary ones, kept off FF: the dual solve)
    with a class_cut."""
    rng = np.random.default_rng(3)
    if path == "features":
        rel = matrix(rng)
        rd = pkg.RelationData.from_matrix(
            pkg.IndexedDF(*rel), feat1=features(rng, 22, 9, "real"),
            feat2=features(rng, 17, 25), class_cut=0.0)
        rd.entities[1].use_ff = False
        rd.assign_to_test(0, 40, seed=7)
        return rd
    n0, n1 = 60, 45
    mask = rng.random((n0, n1)) < 0.5
    R = np.clip(np.round((3 + rng.standard_normal((n0, n1))) * 2) / 2, 1, 5)
    idx, vals = np.stack(np.nonzero(mask), 1), R[mask]
    if path == "fused_residual":
        idx = np.concatenate([idx, idx[:9]])
        vals = np.concatenate([vals, rng.integers(2, 11, 9) * 0.5])
    rd = pkg.RelationData.from_indexed_df(pkg.IndexedDF(idx, vals, (n0, n1)))
    rd.assign_to_test(0, 120, seed=7)
    return rd


# path -> (K, the options of both engines, the JAX engine's Pallas mode)
PATHS = {
    "pair": (8, dict(dense_gram=True, dense_int8=True, clamp=(1.0, 5.0)),
             "on"),
    "gather": (8, dict(dense_gram=False, clamp=(1.0, 5.0)), "on"),
    "planned": (8, dict(dense_gram=False, accumulation="planned",
                        clamp=(1.0, 5.0)), "on"),
    "fused_residual": (8, dict(dense_fused=True, dense_int8=True,
                               clamp=(1.0, 5.0)), "on"),
    "features": (3, dict(beta_solver="dual"), "off"),
}


def _config(pkg_config, path, **driver):
    K, opts, _ = PATHS[path]
    return pkg_config(num_latent=K, dtype="float64", seed=5, verbose=False,
                      burnin=BURNIN, psamples=PSAMPLES, **opts, **driver)


def _port(path, cls=bt.MacauEngine, **driver):
    return cls(_graph(bt, path), _config(bt.MacauConfig, path, **driver),
               device="cpu")


def _jax(path, cls=MacauEngine, pallas=None, **driver):
    return cls(_graph(bdf, path), _config(
        MacauConfig, path, pallas=pallas or PATHS[path][2], **driver))


def _files(tmp_path, tag):
    """The driver's output options, each under ``tmp_path`` with ``tag``."""
    return dict(log_file=str(tmp_path / f"{tag}.jsonl"),
                checkpoint_every=3,
                checkpoint_path=str(tmp_path / f"{tag}_ck.npz"),
                output_prefix=str(tmp_path / tag))


@pytest.mark.parametrize("path", ["pair", "gather", "fused_residual",
                                  "features"])
def test_run_matches_jax(jax_kernels, tmp_path, path):
    """The whole loop on both engines from the same state with the same
    randoms, metrics_every=3, a jsonl log, a checkpoint every 3 sweeps and
    the posterior samples (the port in windows of 4): the same history key
    pattern, the log lines (without "time"), the checkpoint's sweep and
    leaves and the sample files agree to 1e-8."""
    ej = _jax(path, JaxInjected, metrics_every=3, **_files(tmp_path, "jax"))
    et = _port(path, PortInjected, metrics_every=3, sweeps_per_dispatch=4,
               **_files(tmp_path, "port"))
    state_j = ej.init_state(jax.random.fold_in(jax.random.key(5), 0))
    state_t = state_from_numpy(jax.device_get(state_j), "cpu", torch.float64)
    rj = ej.run(state=state_j)          # donates state_j
    rt = et.run(state=state_t)
    assert [sorted(h) for h in rt["history"]] == \
        [sorted(h) for h in rj["history"]]
    lines = {}
    for tag in ("jax", "port"):
        with open(tmp_path / f"{tag}.jsonl") as f:
            lines[tag] = [json.loads(line) for line in f]
    assert len(lines["port"]) == len(lines["jax"]) == BURNIN + PSAMPLES
    for lj, lt in zip(lines["jax"], lines["port"]):
        lj.pop("time"), lt.pop("time")
        assert sorted(lt) == sorted(lj)
        assert (lt.pop("sweep"), lt.pop("phase")) == (lj.pop("sweep"),
                                                      lj.pop("phase"))
        for k in lj:
            np.testing.assert_allclose(lt[k], lj[k], rtol=TOL, atol=TOL,
                                       err_msg=k)
    zj = np.load(tmp_path / "jax_ck.npz")
    zt = np.load(tmp_path / "port_ck.npz")
    assert int(zt["sweep"]) == int(zj["sweep"]) == 6
    assert int(zt["n_leaves"]) == int(zj["n_leaves"])
    for i in range(int(zj["n_leaves"])):
        assert zt[f"leaf{i}"].shape == zj[f"leaf{i}"].shape
        np.testing.assert_allclose(zt[f"leaf{i}"], zj[f"leaf{i}"],
                                   rtol=TOL, atol=TOL, err_msg=f"leaf{i}")
    fj = sorted(glob.glob(str(tmp_path / "jax-sample*.npz")))
    ft = sorted(glob.glob(str(tmp_path / "port-sample*.npz")))
    assert [os.path.basename(f)[4:] for f in ft] == \
        [os.path.basename(f)[3:] for f in fj]
    assert len(ft) == PSAMPLES
    for a, b in zip(fj, ft):
        sj, st = np.load(a), np.load(b)
        assert sorted(st.files) == sorted(sj.files)
        for k in sj.files:
            np.testing.assert_allclose(st[k], sj[k], rtol=TOL, atol=TOL,
                                       err_msg=f"{b} {k}")


@pytest.mark.parametrize("path", sorted(PATHS))
def test_checkpoint_resume_exact(tmp_path, path):
    """The JAX package's ``test_checkpoint_resume_exact`` on the port: 4
    sweeps, ``save_state``, ``load_state`` and ``run(sweep_offset=4)``
    give the run without interruption's state, every leaf bit for bit,
    and its RMSE."""
    eng = _port(path)
    full = eng.run()
    st = eng.init_state()
    for s in range(4):
        st, _ = eng._sweep(st, s, 1.0 if s >= BURNIN else 0.0)
    ck = str(tmp_path / "ckpt.npz")
    eng.save_state(ck, st, 4)
    st2, sweep = eng.load_state(ck)
    assert sweep == 4 and equal_states(st2, st)
    resumed = eng.run(state=st2, sweep_offset=sweep)
    assert equal_states(resumed["state"], full["state"])
    assert resumed["RMSE"] == full["RMSE"]
    assert len(resumed["history"]) == BURNIN + PSAMPLES - 4


@pytest.mark.parametrize("path", ["pair", "gather", "fused_residual",
                                  "features"])
def test_sweeps_per_dispatch_bit_identical(tmp_path, path):
    """Windows of 4 and 11 sweeps give the one-sweep windows' state bit
    for bit and the same history key pattern (metrics_every=4); with
    checkpoints every 3 sweeps, windows of 8 still write each on its sweep
    (the last after sweep 6), and it equals the one-sweep run's."""
    def run(spd, tag=None):
        files = {} if tag is None else dict(
            checkpoint_every=3, checkpoint_path=str(tmp_path / f"{tag}.npz"))
        return _port(path, metrics_every=4, sweeps_per_dispatch=spd,
                     **files).run()

    base = run(1)
    pattern = [("r0.rmse_avg" in h) for h in base["history"]]
    assert pattern == [False, False, False, True, False, False, True]
    for spd in (4, 11):
        res = run(spd)
        assert equal_states(res["state"], base["state"]), spd
        assert [("r0.rmse_avg" in h) for h in res["history"]] == pattern
    ck1, ck8 = run(1, "ck1"), run(8, "ck8")
    assert equal_states(ck8["state"], base["state"])
    eng = _port(path)
    s1, n1 = eng.load_state(str(tmp_path / "ck1.npz"))
    s8, n8 = eng.load_state(str(tmp_path / "ck8.npz"))
    assert n1 == n8 == 6 and equal_states(s1, s8)


@pytest.mark.parametrize("spd", [1, 4])
def test_metrics_every_batches_fetches(spd):
    """metrics_every=3 over 7 sweeps: the port reads the metrics of the
    same sweeps as the JAX run (every third and the last) and keeps only
    "time" for the others, in windows of one sweep or of four."""
    cfg = dict(num_latent=3, burnin=3, psamples=4, verbose=False,
               dtype="float32", metrics_every=3)
    rj = MacauEngine(_graph(bdf, "pair"), MacauConfig(**cfg)).run()
    rt = bt.MacauEngine(_graph(bt, "pair"), bt.MacauConfig(
        **cfg, sweeps_per_dispatch=spd), device="cpu").run()
    keys = [sorted(h) for h in rt["history"]]
    assert keys == [sorted(h) for h in rj["history"]]
    fetched = [i for i, h in enumerate(rt["history"]) if "r0.rmse_avg" in h]
    assert fetched == [2, 5, 6]
    assert all(k == ["time"] for i, k in enumerate(keys) if i not in fetched)
    assert np.isfinite(rt["RMSE"])


@pytest.mark.parametrize("opts", [
    dict(), dict(trace_dir="t"), dict(checkpoint_every=3,
                                      checkpoint_path="c"),
    dict(checkpoint_every=4, checkpoint_path=None),
    dict(output_prefix="o"), dict(output_prefix="o", burnin=0),
    dict(trace_dir="t", checkpoint_every=2, checkpoint_path="c",
         output_prefix="o")])
def test_chunk_limit_matches_jax(opts):
    """Where a window must end (checkpoints, sample dumps, the traced
    sweep), from every start sweep of 12: the port's ``_chunk_limit``
    equals the JAX driver's."""
    base = {"burnin": 5, "psamples": 7, **opts}
    total = 12
    jstub = types.SimpleNamespace(config=MacauConfig(**base))
    tstub = types.SimpleNamespace(config=bt.MacauConfig(**base))
    for s in range(total):
        assert (bt.MacauEngine._chunk_limit(tstub, s, total)
                == MacauEngine._chunk_limit(jstub, s, total)), s


def test_trace_writes_and_leaves_results(tmp_path):
    """trace_dir on the CPU: sweep 3 of 7 runs alone under torch.profiler
    and its Chrome trace lands in the directory; the state equals the
    untraced run's, and so do the history keys but the traced sweep's,
    whose metrics are read."""
    plain = _port("pair", metrics_every=4).run()
    traced = _port("pair", metrics_every=4, sweeps_per_dispatch=4,
                   trace_dir=str(tmp_path / "trace")).run()
    files = os.listdir(tmp_path / "trace")
    assert files == ["sweep0003.pt.trace.json"]
    with open(tmp_path / "trace" / files[0]) as f:
        assert json.load(f)["traceEvents"]
    assert equal_states(traced["state"], plain["state"])
    keys = [sorted(h) for h in traced["history"]]
    assert keys[2] == sorted(plain["history"][-1])      # traced: fetched
    assert keys[:2] + keys[3:] == [sorted(h) for h in plain["history"]][:2] \
        + [sorted(h) for h in plain["history"]][3:]


def test_predictions_frame_roundtrip():
    """The JAX package's ``test_predictions_frame_roundtrip`` on the port,
    and the JAX ``predictions_frame`` of the port's result gives the same
    table."""
    df = _graph(bt, "pair").relations[0].data
    rd = bt.RelationData.from_indexed_df(df)
    rd.assign_to_test(0, 50)
    res = bt.macau(rd, num_latent=3, burnin=5, psamples=5, verbose=False,
                   dtype="float32", device="cpu")
    frame = bt.predictions_frame(res)
    assert list(frame.columns) == ["idx0", "idx1", "obs", "pred", "stdev"]
    assert len(frame) == 50
    np.testing.assert_allclose(frame["pred"].to_numpy(),
                               res["predictions"]["pred"])
    frame2 = bt.predictions_frame(res, relation="rel")
    np.testing.assert_array_equal(frame2.to_numpy(), frame.to_numpy())
    np.testing.assert_array_equal(jax_predictions_frame(res).to_numpy(),
                                  frame.to_numpy())


def test_predict_out_of_matrix(tmp_path):
    """The JAX package's ``test_predict_out_of_matrix`` on the port: new
    compounds scored from the posterior samples saved under
    ``output_prefix`` track the side-information-driven truth; and the
    JAX ``predict_out_of_matrix`` on the port's sample files gives the
    same predictions."""
    rng = np.random.default_rng(10)
    n1, n2, k, f = 60, 30, 3, 12
    feat_all = (rng.random((n1 + 10, f)) < 0.4).astype(np.float64)
    W = rng.standard_normal((f, k))
    U_all = feat_all @ W
    V = rng.standard_normal((n2, k))
    R_train = U_all[:n1] @ V.T + 0.05 * rng.standard_normal((n1, n2))
    mask = rng.random((n1, n2)) < 0.7
    df = bt.IndexedDF(np.stack(np.nonzero(mask), 1), R_train[mask],
                      (n1, n2))
    rd = bt.RelationData.from_matrix(df, feat1=feat_all[:n1])
    rd.assign_to_test(0, 100, seed=1)
    prefix = str(tmp_path / "oom")
    mean_r = float(rd.relations[0].data.vals.mean())
    bt.macau(rd, num_latent=k, burnin=30, psamples=10, verbose=False,
             dtype="float64", use_ff=True, seed=3, output_prefix=prefix,
             device="cpu")
    assert len(glob.glob(prefix + "-sample*.npz")) == 10
    x_new = feat_all[n1:]
    preds = bt.predict_out_of_matrix(prefix, x_new, relation_mean=mean_r)
    assert preds.shape == (10, n2)
    truth = U_all[n1:] @ V.T
    resid = preds - truth
    assert np.sqrt(np.mean(resid ** 2)) < 0.5 * truth.std()
    np.testing.assert_allclose(
        jax_predict_out_of_matrix(prefix, x_new, relation_mean=mean_r),
        preds, rtol=1e-12, atol=1e-12)
    with pytest.raises(FileNotFoundError):
        bt.predict_out_of_matrix(str(tmp_path / "none"), x_new)


@pytest.mark.parametrize("path", ["pair", "features"])
def test_checkpoints_cross_packages(tmp_path, path):
    """A JAX ``save_state`` file loads in the port, and the port's in the
    JAX ``load_state``, equal to the state saved (the same leaves in the
    same order, the same sweep)."""
    ej, et = _jax(path, pallas="off"), _port(path)
    sj = ej.init_state(jax.random.fold_in(jax.random.key(5), 0))
    r = _randoms(ej.problem.random_spec, 0, draw_all_numpy)
    sj, _ = ej._sweep_randoms_jit(ej.problem.arrays, sj,
                                  {k: jnp.asarray(v) for k, v in r.items()},
                                  1.0)
    sj = jax.device_get(sj)
    ej.save_state(str(tmp_path / "jax.npz"), sj, 7)
    st, sweep = et.load_state(str(tmp_path / "jax.npz"))
    assert sweep == 7
    assert equal_states(st, state_from_numpy(sj, "cpu", torch.float64))
    et.save_state(str(tmp_path / "port.npz"), st, 8)
    back, sweep = ej.load_state(str(tmp_path / "port.npz"))
    assert sweep == 8
    flat_j = jax.tree_util.tree_leaves(sj)
    flat_b = jax.tree_util.tree_leaves(jax.device_get(back))
    assert len(flat_b) == len(flat_j)
    for a, b in zip(flat_j, flat_b):
        np.testing.assert_array_equal(b, a)
    assert [a.shape for a in _leaves(state_to_numpy(st))] \
        == [a.shape for a in flat_j]


def _tensor(pkg):
    rng = np.random.default_rng(4)
    shape = (9, 8, 5)
    idx = np.unique(np.stack([rng.integers(0, n, 150) for n in shape], 1),
                    axis=0)
    return pkg.RelationData.from_indexed_df(
        pkg.IndexedDF(idx, rng.standard_normal(len(idx)), shape))


def _side(pkg, **ent):
    rng = np.random.default_rng(6)
    rd = pkg.RelationData.from_matrix(pkg.IndexedDF(*matrix(rng)),
                                      feat1=features(rng, 22, 30))
    for k, v in ent.items():
        setattr(rd.entities[0], k, v)
    return rd


# case -> (the graph in a package, options of both configs)
FLOPS_CASES = {
    "pair": (lambda p: _graph(p, "pair"), dict(dense_gram=True)),
    "gather": (lambda p: _graph(p, "pair"), dict(dense_gram=False)),
    "fused": (lambda p: _graph(p, "fused_residual"),
              dict(dense_fused=True, dense_int8=True)),
    "arity3_pair": (_tensor, dict(dense_gram=True)),
    "arity3_gather": (_tensor, dict(dense_gram=False)),
    "ff": (_side, dict(use_ff=True, dense_gram=True)),
    "dual": (_side, dict(use_ff=False, beta_solver="dual", dual_refine=2,
                         dense_gram=True)),
    "cg": (_side, dict(use_ff=False, beta_solver="cg", dense_gram=False)),
}


@pytest.mark.parametrize("case", sorted(FLOPS_CASES))
def test_flops_per_sweep_matches_jax(case):
    """``CompiledProblem.flops_per_sweep`` equals the JAX package's on
    plans both engines take alike: the pair, the gather path, the fused
    path (its residual not counted), a (9, 8, 5) tensor dense and on the
    gather path, and an entity with features on FF, the dual solve and
    CG."""
    build, opts = FLOPS_CASES[case]
    cfg = dict(num_latent=6, dtype="float64", **opts)
    want = CompiledProblem(build(bdf), MacauConfig(**cfg)).flops_per_sweep()
    got = bt.CompiledProblem(build(bt), bt.MacauConfig(**cfg),
                             torch.device("cpu")).flops_per_sweep()
    assert got == want > 0
