"""The port's Gibbs sweep against the JAX engine (int8 pair path, packed
Pallas sampler in interpret mode), with injected randoms."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import bayesiandatafusion_jl_tpu as bdf
from bayesiandatafusion_jl_tpu.models.datasets import \
    synthetic_ratings as jax_synthetic_ratings
from bayesiandatafusion_jl_tpu.models.engine import MacauEngine
from bayesiandatafusion_jl_tpu.ops.hyper import \
    normal_wishart_update as jax_nw_update
from bayesiandatafusion_jl_tpu.utils.config import MacauConfig
from bayesiandatafusion_jl_tpu.utils.rng import draw_all_numpy
import bayesiandatafusion_jl_tpu_torch as bt
from bayesiandatafusion_jl_tpu_torch.models.datasets import synthetic_ratings
from bayesiandatafusion_jl_tpu_torch.ops import dense_gram as tdg
from bayesiandatafusion_jl_tpu_torch.ops.hyper import normal_wishart_update
from bayesiandatafusion_jl_tpu_torch.utils import rng as trng
from bayesiandatafusion_jl_tpu_torch.utils.config import UNPORTED_FIELDS
from bayesiandatafusion_jl_tpu_torch.utils.convert import (state_from_numpy,
                                                           state_to_numpy)
from _torch_xla_order import xla_cpu_ridge_step


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(orig, interpret=True))


@pytest.fixture
def xla_cpu_ridge(monkeypatch):
    """The port's ridge step summed in the JAX engine's (XLA:CPU) order."""
    monkeypatch.setattr(tdg, "ridge_step", xla_cpu_ridge_step)


def _engines(idx, vals, shape, n_test, dtype, K, seed=5):
    """The JAX and the port's engine on the same data and test split."""
    rd_j = bdf.RelationData.from_indexed_df(bdf.IndexedDF(idx, vals, shape))
    rd_t = bt.RelationData.from_indexed_df(bt.IndexedDF(idx, vals, shape))
    rd_j.assign_to_test(0, n_test, seed=7)
    rd_t.assign_to_test(0, n_test, seed=7)
    common = dict(num_latent=K, dtype=dtype, seed=seed, verbose=False,
                  clamp=(1.0, 5.0))
    ej = MacauEngine(rd_j, MacauConfig(pallas="on", dense_gram=True,
                                       dense_int8=True, **common))
    et = bt.MacauEngine(rd_t, bt.MacauConfig(dense_int8=True, **common))
    return ej, et


def _run_both(ej, et, n_sweeps, dtype, check=None):
    state_j = ej.init_state(jax.random.fold_in(jax.random.key(5), 0))
    state_t = state_from_numpy(jax.device_get(state_j), "cpu",
                               getattr(torch, dtype))
    spec = ej.problem.random_spec
    assert et.problem.random_spec == {
        k: trng.DrawSpec(v.kind, v.shape, v.gamma_a)
        for k, v in spec.items()}
    rng = np.random.default_rng(999)
    for s in range(n_sweeps):
        randoms = draw_all_numpy(rng, spec, np.dtype(dtype))
        acc = 1.0 if s >= 1 else 0.0
        state_j, mj = ej._sweep_randoms_jit(
            ej.problem.arrays, state_j,
            {k: jnp.asarray(v) for k, v in randoms.items()}, acc)
        state_t, mt = et._sweep_with_randoms(
            state_t, {k: torch.from_numpy(v) for k, v in randoms.items()},
            acc)
        if check is not None:
            check(s, jax.device_get(state_j), state_to_numpy(state_t),
                  {k: float(v) for k, v in mj.items()},
                  {k: float(v) for k, v in mt.items()})
    return state_j, state_t, mj, mt


def test_slice_f64_matches_jax_engine(interpret_pallas, xla_cpu_ridge):
    """U, mu, Lambda after every sweep and the sample RMSE agree to 1e-8
    (the contract of tests/test_oracle_equiv.py) in float64."""
    rng = np.random.default_rng(0)
    n0, n1 = 60, 45
    mask = rng.random((n0, n1)) < 0.5
    R = np.clip(np.round((3 + rng.standard_normal((n0, n1))) * 2) / 2, 1, 5)
    idx = np.stack(np.nonzero(mask), 1)
    ej, et = _engines(idx, R[mask], (n0, n1), 120, "float64", K=8)

    def check(s, sj, st, mj, mt):
        for ei in range(2):
            for key in ("U", "mu", "Lambda"):
                np.testing.assert_allclose(
                    st["ent"][ei][key], sj["ent"][ei][key], rtol=1e-8,
                    atol=1e-8, err_msg=f"{key} sweep {s} entity {ei}")
        np.testing.assert_allclose(mt["r0.rmse_sample"],
                                   mj["r0.rmse_sample"], rtol=1e-8)
        np.testing.assert_allclose(st["pred"]["r0"]["sum"],
                                   sj["pred"]["r0"]["sum"], rtol=1e-8,
                                   atol=1e-8)

    _run_both(ej, et, 3, "float64", check)


def test_slice_f32_chain_matches_jax_engine(interpret_pallas):
    """float32 over 20 sweeps of synthetic ratings: the chains drift apart
    by rounding, so only the posterior-mean RMSE is held, to 1e-2."""
    df = jax_synthetic_ratings(300, 200, 12_000, seed=1)
    dft = synthetic_ratings(300, 200, 12_000, seed=1)
    np.testing.assert_array_equal(dft.idx, df.idx)
    np.testing.assert_array_equal(dft.vals, df.vals)
    ej, et = _engines(df.idx, df.vals, df.shape, 1_000, "float32", K=8)
    _, _, mj, mt = _run_both(ej, et, 20, "float32")
    rj, rt = float(mj["r0.rmse_avg"]), float(mt["r0.rmse_avg"])
    assert np.isfinite(rt) and abs(rt - rj) < 1e-2, (rt, rj)


def test_normal_wishart_update_matches_jax():
    rng = np.random.default_rng(3)
    N, K, b0, nu0 = 50, 6, 2.0, 6.0
    S = rng.standard_normal((N, K)) + 0.3
    chi2 = 2 * rng.gamma([(nu0 + N - i) / 2 for i in range(K)])
    tri, mun = rng.standard_normal((K, K)), rng.standard_normal(K)
    mu_j, lam_j = jax_nw_update(*(jnp.asarray(a) for a in (S,)), b0, nu0,
                                jnp.asarray(chi2), jnp.asarray(tri),
                                jnp.asarray(mun))
    mu_t, lam_t = normal_wishart_update(
        torch.from_numpy(S), b0, nu0, torch.from_numpy(chi2),
        torch.from_numpy(tri), torch.from_numpy(mun))
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(lam_t.numpy(), np.asarray(lam_j), rtol=1e-10,
                               atol=1e-10)


def test_draw_all_streams():
    """Device draws: the spec's shapes and dtype, one stream per (seed,
    sweep, name), standard-normal and standard-gamma moments."""
    spec = trng.build_random_spec([4000, 300], 4, 4.0)
    a = trng.draw_all(3, 1, spec, torch.float64, "cpu")
    b = trng.draw_all(3, 1, spec, torch.float64, "cpu")
    c = trng.draw_all(3, 2, spec, torch.float64, "cpu")
    for name, d in spec.items():
        assert tuple(a[name].shape) == d.shape
        assert a[name].dtype == torch.float64
        assert torch.equal(a[name], b[name])
        assert not torch.equal(a[name], c[name])
    xi = a["e0.xi"]
    assert abs(float(xi.mean())) < 0.02 and abs(float(xi.std()) - 1) < 0.02
    g = torch.stack([trng.draw_all(3, s, spec, torch.float64, "cpu")
                     ["e1.nw_g"] for s in range(200)])
    shape_a = torch.tensor(spec["e1.nw_g"].gamma_a, dtype=torch.float64)
    np.testing.assert_allclose(g.mean(0).numpy(), shape_a.numpy(),
                               rtol=0.05)


def test_state_roundtrip():
    st = {"ent": [{"U": np.arange(6.0).reshape(3, 2)}],
          "rel": [{"alpha": np.float64(2.5)}], "pred": {}}
    t = state_from_numpy(st, "cpu", torch.float32)
    assert t["ent"][0]["U"].dtype == torch.float32
    back = state_to_numpy(t)
    np.testing.assert_array_equal(back["ent"][0]["U"], st["ent"][0]["U"])
    assert back["rel"][0]["alpha"] == 2.5


def test_macau_runs_and_reports():
    df = synthetic_ratings(120, 80, 3_000, seed=2)
    rd = bt.RelationData.from_indexed_df(df)
    rd.assign_to_test(0, 300, seed=7)
    seen = []
    eng = bt.MacauEngine(rd, bt.MacauConfig(num_latent=4, burnin=3,
                                            psamples=3, clamp=(1, 5),
                                            verbose=False))
    res = eng.run(callback=lambda s, phase, m, dt: seen.append(phase))
    assert seen == ["burnin"] * 3 + ["sample"] * 3
    assert 0.3 < res["RMSE"] < 1.5
    p = res["predictions"]
    assert p["pred"].shape == (300,) and np.all(p["stdev"] >= 0)
    assert np.all((p["pred"] >= 1) & (p["pred"] <= 5))
    out = eng.benchmark(2, repeats=2)
    assert len(out["ms_per_sweep"]) == 2
    assert np.isfinite(out["rmse_at_sweeps"])


@pytest.mark.parametrize("kwargs, item", [
    (dict(alpha_sample=True), "M7"),
    (dict(dense_gram=False), "M6"),
    (dict(accumulation="planned"), "M6"),
    (dict(dense_int8=False), "M3"),
    (dict(dense_fused=True), "M9"),
    (dict(checkpoint_every=5, checkpoint_path="ck.npz"), "M10"),
    (dict(output_prefix="out"), "M10"),
    (dict(log_file="log.jsonl"), "M10"),
    (dict(num_latent=40), "K2"),
])
def test_unported_options_raise(kwargs, item):
    """An option outside the slice raises, naming its ROADMAP item, when
    the config is made (options the port has no field for, dense_int8) or
    when the engine sees it with the data (alpha sampling, K)."""
    df = synthetic_ratings(30, 20, 200, seed=0)
    rd = bt.RelationData.from_indexed_df(df)
    with pytest.raises(NotImplementedError, match=item):
        bt.MacauEngine(rd, bt.MacauConfig(
            **{"num_latent": 4, "verbose": False, **kwargs}))


@pytest.mark.parametrize("kwargs, item", [
    (dict(exchange_blocks=4), "M11"),
    (dict(use_ff=True), "M8"),
    (dict(sweeps_per_dispatch=8), "M4"),
])
def test_unported_macau_kwargs_raise(kwargs, item):
    """The JAX config's fields the port lacks raise, naming their item,
    through macau() and through MacauConfig alike."""
    rd = bt.RelationData.from_indexed_df(synthetic_ratings(30, 20, 200))
    with pytest.raises(NotImplementedError, match=item):
        bt.macau(rd, num_latent=4, verbose=False, **kwargs)
    with pytest.raises(NotImplementedError, match=item):
        bt.MacauConfig(num_latent=4, **kwargs)


def test_config_fields_cover_jax_config():
    """Every JAX config field is ported, listed as unported, or one of the
    TPU layout knobs the port has no use for."""
    jax_f = {f.name for f in dataclasses.fields(MacauConfig)}
    port_f = {f.name for f in dataclasses.fields(bt.MacauConfig)}
    tpu_only = {"pallas", "gram_dtype", "dense_gram_budget_gb",
                "bucket_widths", "row_pad"}
    assert port_f <= jax_f
    assert not set(UNPORTED_FIELDS) & port_f
    assert jax_f == port_f | set(UNPORTED_FIELDS) | tpu_only


def test_unported_data_raises():
    with pytest.raises(NotImplementedError, match="M8"):
        bt.Entity("compound", F=np.eye(3))
    rng = np.random.default_rng(0)
    idx = np.stack([rng.integers(0, n, 50) for n in (5, 4, 3)], 1)
    rd = bt.RelationData.from_indexed_df(
        bt.IndexedDF(np.unique(idx, axis=0), np.ones(len(np.unique(
            idx, axis=0))), (5, 4, 3)))
    with pytest.raises(NotImplementedError, match="M7"):
        bt.MacauEngine(rd, bt.MacauConfig(num_latent=3, verbose=False))
