"""The port's Gibbs sweep against the JAX engine (the int8 pair path, the
bucketed gather path and the fused path with its residual, float and
K > 96 variants; Pallas kernels in interpret mode), with injected randoms,
across the K ladder."""
import dataclasses
import functools
import inspect
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import bayesiandatafusion_jl_tpu as bdf
from bayesiandatafusion_jl_tpu.models import engine as jax_engine_mod
from bayesiandatafusion_jl_tpu.models.datasets import \
    synthetic_ratings as jax_synthetic_ratings
from bayesiandatafusion_jl_tpu.models.engine import MacauEngine
from bayesiandatafusion_jl_tpu.ops import dense_gram as jax_dense_gram
from bayesiandatafusion_jl_tpu.ops import gramian as jax_gramian
from bayesiandatafusion_jl_tpu.ops import pallas_chol as jax_pallas_chol
from bayesiandatafusion_jl_tpu.ops.hyper import \
    normal_wishart_update as jax_nw_update
from bayesiandatafusion_jl_tpu.utils.config import MacauConfig
from bayesiandatafusion_jl_tpu.utils.rng import draw_all_numpy
import bayesiandatafusion_jl_tpu_torch as bt
from bayesiandatafusion_jl_tpu_torch.models import engine as torch_engine_mod
from bayesiandatafusion_jl_tpu_torch.models.datasets import synthetic_ratings
from bayesiandatafusion_jl_tpu_torch.ops import (chol_blocked, chol_full,
                                                 chol_packed, fused_pair,
                                                 mvn, ytab)
from bayesiandatafusion_jl_tpu_torch.ops import dense_gram as tdg
from bayesiandatafusion_jl_tpu_torch.ops.hyper import normal_wishart_update
from bayesiandatafusion_jl_tpu_torch.utils import rng as trng
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


@pytest.fixture
def branches(monkeypatch):
    """Records which sampler each engine's sweep called, as (engine, name)
    pairs: the JAX engine's packed dispatch and its K2 kernel function (at
    trace time) and its full-P dispatch; the port's packed dispatch, its K2
    wrapper and its full-P dispatch."""
    return _spies(monkeypatch, [
        (jax_pallas_chol, "chol_sample_packed_dispatch", ("jax", "packed")),
        (jax_pallas_chol, "chol_sample_packed_tiled", ("jax", "K2")),
        (jax_engine_mod, "chol_sample_dispatch", ("jax", "full")),
        (torch_engine_mod, "chol_sample_packed_dispatch",
         ("port", "packed")),
        (chol_packed, "chol_sample_packed_tiled", ("port", "K2")),
        (torch_engine_mod, "chol_sample_dispatch", ("port", "full"))])


def _spies(monkeypatch, targets):
    """Record (engine, name) for each call of each (module, attr, tag)."""
    seen = []
    for mod, name, tag in targets:
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, _tag=tag, **kw):
            seen.append(_tag)
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, wrapped)
    return seen


@pytest.fixture
def gather_branches(monkeypatch):
    """Records the non-packed branch of each engine: its accumulation
    ("segment" or "planned"; the port's one ``assemble_precision`` by its
    ``fuse_lambda``: Lambda left to the sampler or in P), its full-P
    dispatch and the sampler it chose (JAX: its K3 kernel function, at
    trace time; the port: its K3 and K4 wrappers)."""
    seen = _spies(monkeypatch, [
        (jax_engine_mod, "assemble_precision", ("jax", "segment")),
        (jax_engine_mod, "assemble_precision_planned", ("jax", "planned")),
        (jax_engine_mod, "chol_sample_dispatch", ("jax", "full")),
        (jax_pallas_chol, "chol_sample_pallas", ("jax", "K3")),
        (torch_engine_mod, "chol_sample_dispatch", ("port", "full")),
        (mvn, "chol_sample_full", ("port", "K3")),
        (mvn, "chol_sample_full_tiled", ("port", "K4"))])
    assemble = torch_engine_mod.assemble_precision

    def labelled(*a, **kw):
        seen.append(("port", "segment" if kw["fuse_lambda"] else "planned"))
        return assemble(*a, **kw)
    monkeypatch.setattr(torch_engine_mod, "assemble_precision", labelled)
    return seen


@pytest.fixture
def fused_branches(monkeypatch):
    """Records the fused branches of each engine: its fused contribution
    (s8 "fused", float "fused_float"), the JAX engine's masked-pair kernel
    function (at trace time), the residual's accumulation (packed
    "residual", through ``assemble_precision`` "segment") and each engine's
    packed and full-P dispatch."""
    from bayesiandatafusion_jl_tpu.ops import pallas_fused
    return _spies(monkeypatch, [
        (jax_dense_gram, "fused_gram_contrib_i8", ("jax", "fused")),
        (jax_dense_gram, "fused_gram_contrib", ("jax", "fused_float")),
        (pallas_fused, "fused_pair_pallas", ("jax", "K8")),
        (jax_gramian, "packed_bucket_accum", ("jax", "residual")),
        (jax_engine_mod, "assemble_precision", ("jax", "segment")),
        (jax_pallas_chol, "chol_sample_packed_dispatch", ("jax", "packed")),
        (jax_engine_mod, "chol_sample_dispatch", ("jax", "full")),
        (tdg, "fused_gram_contrib_i8", ("port", "fused")),
        (tdg, "fused_gram_contrib", ("port", "fused_float")),
        (torch_engine_mod, "packed_bucket_accum", ("port", "residual")),
        (torch_engine_mod, "assemble_precision", ("port", "segment")),
        (torch_engine_mod, "chol_sample_packed_dispatch",
         ("port", "packed")),
        (torch_engine_mod, "chol_sample_dispatch", ("port", "full"))])


def _engines(idx, vals, shape, n_test, dtype, K, seed=5, pallas="on",
             **opts):
    """The JAX and the port's engine on the same data and test split, the
    port's on the CPU.  ``opts`` go into both configs; the default is the
    int8 pair path."""
    rd_j = bdf.RelationData.from_indexed_df(bdf.IndexedDF(idx, vals, shape))
    rd_t = bt.RelationData.from_indexed_df(bt.IndexedDF(idx, vals, shape))
    rd_j.assign_to_test(0, n_test, seed=7)
    rd_t.assign_to_test(0, n_test, seed=7)
    common = dict(num_latent=K, dtype=dtype, seed=seed, verbose=False,
                  clamp=(1.0, 5.0),
                  **{"dense_gram": True, "dense_int8": True, **opts})
    ej = MacauEngine(rd_j, MacauConfig(pallas=pallas, **common))
    et = bt.MacauEngine(rd_t, bt.MacauConfig(**common), device="cpu")
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


def _small_ratings(residual=None):
    """(idx, vals, shape) of one small ratings matrix on the half-star
    grid.  ``residual`` makes the fused planner leave some observations to
    the gather path: "duplicates" rates 9 cells a second time;
    "zero_level" puts the values on a 255-level grid with every level
    used, so that one level gets the zero code."""
    rng = np.random.default_rng(0)
    n0, n1 = 60, 45
    mask = rng.random((n0, n1)) < 0.5
    R = np.clip(np.round((3 + rng.standard_normal((n0, n1))) * 2) / 2, 1, 5)
    idx, vals = np.stack(np.nonzero(mask), 1), R[mask]
    if residual == "duplicates":
        idx = np.concatenate([idx, idx[:9]])
        vals = np.concatenate([vals, rng.integers(2, 11, 9) * 0.5])
    elif residual == "zero_level":
        vals = 1.0 + (rng.permutation(len(vals)) % 255) * (4.0 / 256)
    return idx, vals, (n0, n1)


def _f64_engines(K, pallas="on", residual=None, **opts):
    """Both engines in float64 on one small ratings matrix."""
    idx, vals, shape = _small_ratings(residual)
    return _engines(idx, vals, shape, 120, "float64", K=K, pallas=pallas,
                    **opts)


def _check_f64(s, sj, st, mj, mt):
    """U, mu, Lambda after every sweep, the sample RMSE and the prediction
    sums agree to 1e-8 (the contract of tests/test_oracle_equiv.py)."""
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


def test_slice_f64_matches_jax_engine(interpret_pallas, xla_cpu_ridge):
    """U, mu, Lambda after every sweep and the sample RMSE agree to 1e-8
    (the contract of tests/test_oracle_equiv.py) in float64."""
    ej, et = _f64_engines(K=8)
    _run_both(ej, et, 3, "float64", _check_f64)


def test_slab_f64_matches_jax_engine(interpret_pallas, xla_cpu_ridge,
                                     branches):
    """K=36: both engines keep P packed and sample with the column-slab
    sampler (K2; the JAX one in interpret mode), 3 float64 sweeps to 1e-8.
    The JAX kernel is traced once per entity, in its jitted sweep."""
    ej, et = _f64_engines(K=36)
    _run_both(ej, et, 3, "float64", _check_f64)
    assert set(branches) == {("jax", "packed"), ("jax", "K2"),
                             ("port", "packed"), ("port", "K2")}
    assert branches.count(("port", "K2")) == 6
    assert branches.count(("jax", "K2")) == 2


def test_blocked_f64_matches_jax_engine(xla_cpu_ridge, branches):
    """K=100: both engines take the full-P branch (the JAX one with its XLA
    reference sampler, pallas="off"); the port's runs the blocked sampler,
    two 64-wide panels per entity.  3 float64 sweeps to 1e-8."""
    ej, et = _f64_engines(K=100, pallas="off")
    before = chol_blocked.chol_inv_plain.calls
    _run_both(ej, et, 3, "float64", _check_f64)
    assert set(branches) == {("jax", "full"), ("port", "full")}
    assert branches.count(("port", "full")) == 6
    assert chol_blocked.chol_inv_plain.calls == before + 12


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


@pytest.mark.parametrize("accumulation", ["segment", "planned"])
def test_gather_f64_matches_jax_engine(interpret_pallas, gather_branches,
                                       accumulation):
    """dense_gram=False, K=8: both engines take the non-packed branch and
    sample with K3 (the JAX one in interpret mode, traced once per entity);
    "segment" hands Lambda to the sampler, "planned" puts it in P.  U, mu
    and Lambda agree to 1e-8 after each of 3 float64 sweeps."""
    ej, et = _f64_engines(K=8, dense_gram=False, accumulation=accumulation)
    assert et.problem.kinds[0] == "gather" and not ej.problem.dense_plans
    _run_both(ej, et, 3, "float64", _check_f64)
    assert set(gather_branches) == {
        ("jax", accumulation), ("jax", "full"), ("jax", "K3"),
        ("port", accumulation), ("port", "full"), ("port", "K3")}
    assert gather_branches.count(("port", "K3")) == 6
    assert gather_branches.count(("jax", "K3")) == 2


def test_gather_k4_f64_matches_jax_engine(gather_branches):
    """dense_gram=False, K=36: the port samples with K4 (plain version),
    Lambda added on load; the JAX engine with its XLA reference sampler
    (pallas="off": its K4 kernel costs ~25 s a trace in interpret mode,
    and tests/test_torch_chol_full.py holds the two kernels' plain
    versions together), Lambda in P.  3 float64 sweeps to 1e-8."""
    ej, et = _f64_engines(K=36, pallas="off", dense_gram=False)
    _run_both(ej, et, 3, "float64", _check_f64)
    assert set(gather_branches) == {
        ("jax", "segment"), ("jax", "full"),
        ("port", "segment"), ("port", "full"), ("port", "K4")}
    assert gather_branches.count(("port", "K4")) == 6


def test_gather_f32_chain_matches_jax_engine(interpret_pallas):
    """The gather path in float32 with gram_dtype="bfloat16" over 20
    sweeps of synthetic ratings: only the posterior-mean RMSE is held, to
    1e-2, as the chains drift apart by rounding."""
    df = jax_synthetic_ratings(300, 200, 12_000, seed=1)
    ej, et = _engines(df.idx, df.vals, df.shape, 1_000, "float32", K=8,
                      dense_gram=False, gram_dtype="bfloat16",
                      bucket_widths=(8, 16, 32, 64, 128))
    before = chol_full.chol_sample_full_plain.calls
    _, _, mj, mt = _run_both(ej, et, 20, "float32")
    assert chol_full.chol_sample_full_plain.calls == before + 40
    rj, rt = float(mj["r0.rmse_avg"]), float(mt["r0.rmse_avg"])
    assert np.isfinite(rt) and abs(rt - rj) < 1e-2, (rt, rj)


@pytest.mark.parametrize("K", [8, 36])
def test_fused_f64_matches_jax_engine(interpret_pallas, xla_cpu_ridge,
                                      fused_branches, K):
    """dense_fused=True: both engines store one int8 value array and take
    the fused packed branch, one s8 contribution per entity (the JAX
    engine's masked-pair kernel in interpret mode on its block-padded
    store; the port's K7 and K8 plain versions), then the packed sampler
    (K1 at K=8, K2 at K=36).  U, mu and Lambda agree to 1e-8 after each
    of 3 float64 sweeps."""
    ej, et = _f64_engines(K=K, dense_fused=True)
    assert ej.problem.fused_i8.get(0) and not ej.problem.fused_keep
    assert et.problem.kinds == ["fused"]
    calls = (ytab.ytab_quantize_plain.calls,
             fused_pair.fused_pair_plain.calls)
    _run_both(ej, et, 3, "float64", _check_f64)
    assert set(fused_branches) == {("jax", "fused"), ("jax", "K8"),
                                   ("jax", "packed"), ("port", "fused"),
                                   ("port", "packed")}
    assert fused_branches.count(("port", "fused")) == 6
    assert fused_branches.count(("jax", "fused")) == 2
    assert (ytab.ytab_quantize_plain.calls,
            fused_pair.fused_pair_plain.calls) == (calls[0] + 6,
                                                   calls[1] + 6)


def _fused_counts():
    return (ytab.ytab_quantize_plain.calls, fused_pair.fused_pair_plain.calls)


@pytest.mark.parametrize("residual", ["duplicates", "zero_level"])
def test_fused_residual_f64_matches_jax_engine(interpret_pallas,
                                               xla_cpu_ridge, fused_branches,
                                               residual):
    """A fused relation with a gather-path residual, K=8: cells rated
    twice, or a value grid whose every level is used (one level takes the
    zero code).  Both engines keep the first encodable observation per
    cell in V8 (ridge degrees and the int32 bound from those alone), give
    the rest bucket layouts with exact centered values, and add them to
    the fused s8 contribution in the packed layout.  3 float64 sweeps to
    1e-8."""
    ej, et = _f64_engines(K=8, residual=residual, dense_fused=True)
    keep = ej.problem.fused_keep[0]
    assert et.problem.residual_nnzs[0] == int((~keep).sum()) > 0
    assert et.problem.fused_i8s[0] and ej.problem.fused_i8[0]
    np.testing.assert_array_equal(
        et.problem.stores[0]["deg"][0].numpy()[:60],
        np.asarray(ej.problem.arrays["dense"]["r0"]["deg_m0"])[:60])
    calls = _fused_counts()
    _run_both(ej, et, 3, "float64", _check_f64)
    assert set(fused_branches) == {
        ("jax", "fused"), ("jax", "K8"), ("jax", "residual"),
        ("jax", "packed"), ("port", "fused"), ("port", "residual"),
        ("port", "packed")}
    assert fused_branches.count(("port", "residual")) == 6
    assert _fused_counts() == (calls[0] + 6, calls[1] + 6)


@pytest.mark.parametrize("K, declined", [(8, False), (36, False), (8, True)])
def test_fused_float_f64_matches_jax_engine(monkeypatch, fused_branches, K,
                                            declined):
    """The fused path off the s8 kernels: ``dense_int8=False``, or a
    relation that fails the int32 bound ``fused_int8_ok`` (``declined``:
    the bound patched to refuse in both packages).  Both engines take the
    float contribution, the table in the compute dtype, alpha multiplied
    in afterwards; the JAX engine with pallas="off" (its float kernels
    give float32 sums, the XLA fallback float64), so it samples from the
    full P where the port keeps P packed (K1 at K=8, K2 at K=36).  3
    float64 sweeps to 1e-8."""
    if declined:
        monkeypatch.setattr(jax_dense_gram, "fused_int8_ok",
                            lambda *a, **k: False)
        monkeypatch.setattr(tdg, "fused_int8_ok", lambda *a, **k: False)
    ej, et = _f64_engines(K=K, pallas="off", dense_fused=True,
                          dense_int8=declined)
    assert ej.problem.fused_rels and not ej.problem.fused_i8[0]
    assert et.problem.kinds[0] == "fused" and not et.problem.fused_i8s[0]
    calls = _fused_counts()
    _run_both(ej, et, 3, "float64", _check_f64)
    assert set(fused_branches) == {
        ("jax", "fused_float"), ("jax", "segment"), ("jax", "full"),
        ("port", "fused_float"), ("port", "packed")}
    assert fused_branches.count(("port", "fused_float")) == 6
    assert _fused_counts() == (calls[0], calls[1] + 6)


@pytest.mark.parametrize("int8, residual", [(True, None), (False, None),
                                            (True, "duplicates")])
def test_fused_k100_f64_matches_jax_engine(xla_cpu_ridge, fused_branches,
                                           int8, residual):
    """The fused path at K=100, above the packed samplers: both engines
    take the natural-layout contribution (s8: raw int32 sums, the finish
    with the ridge on the diagonal columns, the alpha multiply; float: the
    compute-dtype table), expand it to [n, K, K] and sample from the full
    P (the JAX engine with pallas="off", the port with the blocked
    sampler); duplicates come in through ``assemble_precision``.  3 float64
    sweeps to 1e-8."""
    ej, et = _f64_engines(K=100, pallas="off", residual=residual,
                          dense_fused=True, dense_int8=int8)
    assert et.problem.fused_i8s[0] == int8 == ej.problem.fused_i8[0]
    assert (et.problem.residual_nnzs[0] > 0) == (residual is not None)
    calls = _fused_counts()
    inv = chol_blocked.chol_inv_plain.calls
    _run_both(ej, et, 3, "float64", _check_f64)
    kind = "fused" if int8 else "fused_float"
    want = {("jax", kind), ("jax", "segment"), ("jax", "full"),
            ("port", kind), ("port", "full")}
    if residual:
        want.add(("port", "segment"))
    assert set(fused_branches) == want
    assert fused_branches.count(("port", "segment")) == (6 if residual else 0)
    # the s8 table at K=100 is K7's: its plain version on the CPU, once a
    # mode a sweep
    assert _fused_counts() == (calls[0] + (6 if int8 else 0), calls[1] + 6)
    assert chol_blocked.chol_inv_plain.calls == inv + 12


@pytest.mark.parametrize("variant", ["float_bf16", "duplicates"])
def test_fused_f32_variants_match_s8_chain(variant):
    """float32 chains of 20 sweeps on the same ratings and randoms: the
    float fused path with a bfloat16 table, and the s8 path with every
    11th observation rated again (a gather-path residual with a bfloat16
    gather), against the plain s8 fused chain.  They round differently
    (and the second sees more data), so only the posterior-mean RMSE is
    held, to 3e-2."""
    df = synthetic_ratings(300, 200, 12_000, seed=1)
    rmse = {}
    for name in ("s8", variant):
        idx, vals = df.idx, df.vals
        opts = dict(dense_int8=True)
        if name == "float_bf16":
            opts = dict(dense_int8=False, gram_dtype="bfloat16")
        elif name == "duplicates":
            idx = np.concatenate([idx, idx[::11]])
            vals = np.concatenate([vals, vals[::11]])
            opts = dict(dense_int8=True, gram_dtype="bfloat16")
        rd = bt.RelationData.from_indexed_df(
            bt.IndexedDF(idx, vals, df.shape))
        rd.assign_to_test(0, np.arange(0, 12_000, 12))
        eng = bt.MacauEngine(rd, bt.MacauConfig(
            num_latent=8, dtype="float32", seed=5, verbose=False,
            clamp=(1.0, 5.0), dense_fused=True, **opts), device="cpu")
        prob = eng.problem
        assert prob.kinds[0] == "fused"
        assert prob.fused_i8s[0] == (name != "float_bf16")
        assert (prob.residual_nnzs[0] > 0) == (name == "duplicates")
        state = eng.init_state()
        rng = np.random.default_rng(999)
        for s in range(20):
            randoms = trng.draw_all_numpy(rng, prob.random_spec,
                                          np.dtype("float32"))
            state, m = eng._sweep_with_randoms(
                state, {k: torch.from_numpy(v) for k, v in randoms.items()},
                1.0 if s >= 10 else 0.0)
        rmse[name] = float(m["r0.rmse_avg"])
    assert np.isfinite(rmse[variant]) and \
        abs(rmse[variant] - rmse["s8"]) < 3e-2, rmse


def test_fused_f32_chain_matches_pair_chain():
    """The fused path in float32 against the int8 pair on the same ratings
    and randoms, 20 sweeps: the two quantize the data differently (exact
    codes against a per-relation value scale), so only the posterior-mean
    RMSE is held, to 3e-2."""
    df = synthetic_ratings(300, 200, 12_000, seed=1)
    rmse = {}
    for fused in (False, True):
        rd = bt.RelationData.from_indexed_df(df)
        rd.assign_to_test(0, 1_000, seed=7)
        eng = bt.MacauEngine(rd, bt.MacauConfig(
            num_latent=8, dtype="float32", seed=5, verbose=False,
            clamp=(1.0, 5.0), dense_gram=True, dense_fused=fused,
            dense_int8=True), device="cpu")
        assert (eng.problem.kinds[0] == "fused") == fused
        state = eng.init_state()
        rng = np.random.default_rng(999)
        for s in range(20):
            randoms = trng.draw_all_numpy(rng, eng.problem.random_spec,
                                          np.dtype("float32"))
            state, m = eng._sweep_with_randoms(
                state, {k: torch.from_numpy(v) for k, v in randoms.items()},
                1.0 if s >= 10 else 0.0)
        rmse[fused] = float(m["r0.rmse_avg"])
    assert np.isfinite(rmse[True]) and abs(rmse[True] - rmse[False]) < 3e-2, \
        rmse


def test_gather_macau_runs_and_reports():
    """macau() on the gather path, on the CPU: dense_int8 is not read
    there, so dense_int8=False is accepted; the layout is recorded."""
    df = synthetic_ratings(120, 80, 3_000, seed=2)
    rd = bt.RelationData.from_indexed_df(df)
    rd.assign_to_test(0, 300, seed=7)
    res = bt.macau(rd, num_latent=4, burnin=3, psamples=3, clamp=(1, 5),
                   verbose=False, device="cpu", dense_gram=False,
                   dense_int8=False, accumulation="planned", row_pad=1)
    assert 0.3 < res["RMSE"] < 1.5
    eng = bt.MacauEngine(rd, bt.MacauConfig(num_latent=4, verbose=False,
                                            dense_gram=False), device="cpu")
    prob = eng.problem
    assert prob.kinds == ["gather"]
    assert sorted(prob.dest_maps) == ["e0", "e1"]
    assert sum(prob.padded_nnz) >= 2 * (df.nnz - 300)
    assert all(ba["inst"].dtype == torch.int32
               for ba in prob.layouts["r0m0"])


def test_engine_default_device_is_cuda(monkeypatch):
    """MacauEngine and macau run on the card unless the caller asks for
    the CPU; without a card the default raises instead of falling back."""
    for fn in (bt.MacauEngine.__init__, bt.macau):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rd = bt.RelationData.from_indexed_df(synthetic_ratings(30, 20, 200))
    cfg = bt.MacauConfig(num_latent=4, burnin=1, psamples=1, verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bt.MacauEngine(rd, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bt.macau(rd, config=cfg)
    assert bt.MacauEngine(rd, cfg, device="cpu").device.type == "cpu"
    assert "history" in bt.macau(rd, config=cfg, device="cpu")


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
                                            verbose=False, dense_gram=True,
                                            dense_int8=True),
                         device="cpu")
    assert eng.problem.pair_i8s[0]
    res = eng.run(callback=lambda s, phase, m, dt: seen.append(phase))
    assert seen == ["burnin"] * 3 + ["sample"] * 3
    assert 0.3 < res["RMSE"] < 1.5
    p = res["predictions"]
    assert p["pred"].shape == (300,) and np.all(p["stdev"] >= 0)
    assert np.all((p["pred"] >= 1) & (p["pred"] <= 5))
    out = eng.benchmark(2, repeats=2)
    assert len(out["ms_per_sweep"]) == 2
    assert np.isfinite(out["rmse_at_sweeps"])


@pytest.mark.parametrize("field, value", [("exchange_blocks", 4),
                                          ("head_split_degree", 2)])
def test_sharded_options_accepted(field, value):
    """The sharded engine's options are fields with the JAX package's
    defaults, taken by MacauConfig and by macau(**kwargs) alike."""
    assert getattr(bt.MacauConfig(), field) == getattr(MacauConfig(), field)
    assert getattr(bt.MacauConfig(**{field: value}), field) == value
    rd = bt.RelationData.from_indexed_df(synthetic_ratings(30, 20, 200))
    rd.assign_to_test(0, 20, seed=7)
    res = bt.macau(rd, num_latent=4, burnin=1, psamples=1, verbose=False,
                   device="cpu", **{field: value})
    assert np.isfinite(res["RMSE"])


@pytest.mark.parametrize("kwargs", [dict(exchange_blocks=3),
                                    dict(head_split_degree=2)])
def test_sharded_options_leave_single_chain(kwargs):
    """The single-device engine ignores the sharded engine's options: its
    chain is the same, bit for bit, with them set."""
    rd = bt.RelationData.from_indexed_df(synthetic_ratings(40, 30, 500))
    rd.assign_to_test(0, 50, seed=7)
    opts = dict(num_latent=4, burnin=2, psamples=2, verbose=False,
                dtype="float64")
    a = bt.MacauEngine(rd, bt.MacauConfig(**opts), device="cpu").run()
    b = bt.MacauEngine(rd, bt.MacauConfig(**opts, **kwargs),
                       device="cpu").run()
    for x, y in zip(torch_engine_mod._leaves(a["state"]),
                    torch_engine_mod._leaves(b["state"])):
        assert torch.equal(x, y)


def test_head_split_bogus_raises():
    """An unknown head_split_degree raises ValueError where the JAX
    package's does: when the sharded problem resolves it."""
    from bayesiandatafusion_jl_tpu.parallel.sharded import \
        resolve_head_split as jax_resolve
    from bayesiandatafusion_jl_tpu_torch.parallel.sharded import (
        ShardedProblem, resolve_head_split)
    deg = np.array([1, 5, 3000])
    for fn in (jax_resolve, resolve_head_split):
        with pytest.raises(ValueError, match="head_split_degree"):
            fn("bogus", deg, 2)
    rd = bt.RelationData.from_indexed_df(synthetic_ratings(30, 20, 200))
    with pytest.raises(ValueError, match="head_split_degree"):
        ShardedProblem(rd, bt.MacauConfig(num_latent=4,
                                          head_split_degree="bogus"),
                       2, 0, torch.device("cpu"))


def test_config_fields_cover_jax_config():
    """Every JAX config field is ported, or the TPU-only knob the port
    has no use for; the gather path's and the
    fused path's fields keep the JAX defaults and validation; the dense
    stores' budget is a field, with the card's default."""
    jax_f = {f.name for f in dataclasses.fields(MacauConfig)}
    port_f = {f.name for f in dataclasses.fields(bt.MacauConfig)}
    tpu_only = {"pallas"}
    assert "dense_gram_budget_gb" in port_f
    gather = {"dense_gram", "accumulation", "gram_dtype", "bucket_widths",
              "row_pad"}
    fused = {"dense_fused", "dense_fused_tol"}
    assert gather | fused <= port_f
    for name in gather | fused:
        assert getattr(bt.MacauConfig(), name) == getattr(MacauConfig(),
                                                          name), name
    # dense_int8=False selects the float fused kernels with dense_fused,
    # the float pair without it
    cfg = bt.MacauConfig(dense_int8=False, dense_fused=True)
    assert cfg.dense_int8 is False and cfg.dense_fused is True
    assert bt.MacauConfig(dense_int8=False).dense_gram is None
    with pytest.raises(ValueError, match="accumulation"):
        bt.MacauConfig(accumulation="window")
    with pytest.raises(ValueError, match="gram_dtype"):
        bt.MacauConfig(gram_dtype="float16")
    assert port_f <= jax_f
    assert jax_f == port_f | tpu_only


def test_unported_data_raises():
    """The int8 pair of a relation of arity 4 (M12, ported): the (5, 4, 3,
    2) relation that raised before runs on the int8 pair in both engines,
    3 float64 sweeps to 1e-8 (the JAX samplers in XLA)."""
    rng = np.random.default_rng(0)
    idx = np.unique(np.stack([rng.integers(0, n, 80) for n in (5, 4, 3, 2)],
                             1), axis=0)
    vals = rng.standard_normal(len(idx))
    ej, et = _engines(idx, vals, (5, 4, 3, 2), 8, "float64", K=3,
                      pallas="off")
    assert et.problem.kinds == ["pair"] and et.problem.pair_i8s == [True]
    assert len(et.problem.dense_plans) == 4
    _run_both(ej, et, 3, "float64")


@pytest.mark.parametrize("metrics", [
    # two relations, the second without a test split and with a sampled
    # alpha; |U| fetched for one entity of three
    {"r0.rmse_avg": 0.81234, "r0.rmse_sample": 0.9, "r1.alpha": 4.987,
     "e0.unorm": 12.34, "time": 0.0123},
    # every field the reference's line knows: AUC, both alphas, every
    # norm, the side-information and CG fields
    {"r0.rmse_avg": 0.5, "r0.rmse_sample": 0.55, "r0.auc": 0.734,
     "r0.alpha": 2.0, "r1.rmse_avg": 1.25, "r1.rmse_sample": 1.5,
     "r1.alpha": 0.125, "e0.unorm": 1.0, "e1.unorm": 2.5, "e2.unorm": 3.0,
     "e1.betanorm": 0.25, "e1.lambda_beta": 4.5, "e2.cg_iters": 7.0,
     "time": 1.5}])
def test_verbose_line_matches_jax(capsys, metrics):
    """The port's verbose line is the reference's, character for
    character, on one metrics dict (ROADMAP F10)."""
    specs = [types.SimpleNamespace(name=n) for n in ("ratings", "assay")]
    stub = types.SimpleNamespace(problem=types.SimpleNamespace(
        rel_specs=specs, entity_specs=[None] * 3))
    MacauEngine._print_sweep(stub, 4, "burnin", metrics)
    want = capsys.readouterr().out
    bt.MacauEngine._print_sweep(stub, 4, "burnin", metrics)
    got = capsys.readouterr().out
    assert "a1=4.99" in want or "a1=0.12" in want
    assert got == want
