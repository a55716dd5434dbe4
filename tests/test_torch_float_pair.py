"""The float dense pair (``dense_int8=False``, or a relation that fails
``int8_pair_ok``) against the JAX package: the store, its Gramian
(``float_pair_contrib``) against the float branch of JAX
``dense_gram_contrib``, and the engine in float64; and the port's config
defaults against the JAX package's."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayesiandatafusion_jl_tpu as bdf
from bayesiandatafusion_jl_tpu.models import engine as jax_engine_mod
from bayesiandatafusion_jl_tpu.ops import dense_gram as jdg
from bayesiandatafusion_jl_tpu.utils.config import MacauConfig
import bayesiandatafusion_jl_tpu_torch as bt
from bayesiandatafusion_jl_tpu_torch.models.datasets import synthetic_ratings
from bayesiandatafusion_jl_tpu_torch.ops import chol_blocked, pair_contract
from bayesiandatafusion_jl_tpu_torch.ops import dense_gram as tdg
from bayesiandatafusion_jl_tpu_torch.utils import rng as trng
from test_torch_engine import (_check_f64, _f64_engines, _run_both, _spies,
                               interpret_pallas)

FLOAT_PAIR = dict(dense_int8=False, dense_gram=True, dense_fused=False)


def _relation(n0, n1, density, seed, dup=0):
    rng = np.random.default_rng(seed)
    idx = np.stack(np.nonzero(rng.random((n0, n1)) < density), 1)
    if dup:
        idx = np.concatenate([idx, idx[rng.choice(len(idx), dup)]])
    vals = np.round(rng.uniform(1, 5, len(idx)) * 2) / 2
    return idx, vals - vals.mean()


@pytest.mark.parametrize("store", ["float64", "float32", "bfloat16"])
def test_float_pair_build_matches_jax(store):
    """The build over the observed cells gives the JAX engine's stored
    pair bitwise, with repeated cells: M and W in the store dtype (the
    sums in float64 for a float64 store, else float32, then cast)."""
    n0, n1 = 37, 23
    idx, cen = _relation(n0, n1, 0.4, 3, dup=30)
    acc = np.float64 if store == "float64" else np.float32
    M, W = jdg.build_dense_pair(idx, cen, (n0, n1), acc)
    pair = tdg.build_dense_pair(idx, cen, (n0, n1), getattr(torch, store),
                                "cpu")
    assert pair["shape"] == (n0, n1)
    for got, want in ((pair["M"], M), (pair["W"], W)):
        assert got.dtype == getattr(torch, store)
        want = np.asarray(jnp.asarray(want, getattr(jnp, store)))
        np.testing.assert_array_equal(got.float().numpy(),
                                      want.astype(np.float32))
        if store == "float64":
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("packed", [True, False])
def test_float_contrib_f64_matches_jax(mode, packed):
    """The float branch in float64 against the JAX package's, alpha
    folded: packed (the transposed [C, n] layout) and unpacked ([n, K, K]).
    Unpacked, the port always expands the packed triangle; on (6, 5200)
    the JAX package does too in mode 0 (5200 partners, over its TPU rule's
    5143) and takes the full K^2 table in mode 1: the same products.  The
    sums are taken in another order: 1e-12."""
    n0, n1, K = 6, 5200, 5
    idx, cen = _relation(n0, n1, 0.05, 8)
    M, W = jdg.build_dense_pair(idx, cen, (n0, n1), np.float64)
    partner = np.random.default_rng(2).standard_normal(((n1, n0)[mode], K))
    Pj, bj = jdg.dense_gram_contrib(
        jnp.asarray(M), jnp.asarray(W), [jnp.asarray(partner)], mode,
        (n0, n1), jnp.float64, jnp.float64, packed=packed,
        transposed=packed, alpha=jnp.asarray(1.7, jnp.float64))
    pair = tdg.build_dense_pair(idx, cen, (n0, n1), torch.float64, "cpu")
    P, b = tdg.float_pair_contrib(
        pair, tdg.tri_index(K, "cpu"), [torch.from_numpy(partner)], mode,
        torch.tensor(1.7, dtype=torch.float64), torch.float64, packed=packed)
    n_f = (n0, n1)[mode]
    assert tuple(P.shape) == ((K * (K + 1) // 2, n_f) if packed
                              else (n_f, K, K))
    np.testing.assert_allclose(P.numpy(), np.asarray(Pj), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(b.numpy(), np.asarray(bj), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("widen_elems", [None, 200])
def test_float_contrib_bf16_matches_jax(monkeypatch, mode, widen_elems):
    """A bfloat16 store and table (``gram_dtype="bfloat16"``) with float32
    sums, against the JAX package's bfloat16 einsums with float32
    accumulation: the same exact products, summed in another order (1e-5
    of the largest sum).  With ``widen_elems`` the store is widened to
    float32 a few focus rows at a time (the last slice shorter), as a
    store larger than one slice is on the card."""
    if widen_elems is not None:
        monkeypatch.setattr(tdg, "_WIDEN_ELEMS", widen_elems)
    n0, n1, K = 70, 45, 6
    idx, cen = _relation(n0, n1, 0.5, 12, dup=10)
    M, W = jdg.build_dense_pair(idx, cen, (n0, n1), np.float32)
    partner = np.random.default_rng(3).standard_normal(
        ((n1, n0)[mode], K)).astype(np.float32)
    Pj, bj = jdg.dense_gram_contrib(
        jnp.asarray(M, jnp.bfloat16), jnp.asarray(W, jnp.bfloat16),
        [jnp.asarray(partner)], mode, (n0, n1), jnp.float32, jnp.bfloat16,
        packed=True, transposed=True, alpha=jnp.asarray(2.0, jnp.float32))
    pair = tdg.build_dense_pair(idx, cen, (n0, n1), torch.bfloat16, "cpu")
    P, b = tdg.float_pair_contrib(
        pair, tdg.tri_index(K, "cpu"), [torch.from_numpy(partner)], mode,
        torch.tensor(2.0), torch.float32)
    assert P.dtype == b.dtype == torch.float32
    for got, want in ((P, Pj), (b, bj)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


@pytest.fixture
def pair_branches(monkeypatch):
    """Records each engine's dense contribution by kind ("float" or "s8";
    the JAX engine's at trace time) and each engine's packed and full-P
    sampler dispatch."""
    from bayesiandatafusion_jl_tpu.ops import pallas_chol as jax_pallas_chol
    from bayesiandatafusion_jl_tpu_torch.models import \
        engine as torch_engine_mod
    seen = _spies(monkeypatch, [
        (tdg, "float_pair_contrib", ("port", "float")),
        (tdg, "int8_pair_contrib", ("port", "s8")),
        (jax_pallas_chol, "chol_sample_packed_dispatch", ("jax", "packed")),
        (jax_engine_mod, "chol_sample_dispatch", ("jax", "full")),
        (torch_engine_mod, "chol_sample_packed_dispatch",
         ("port", "packed")),
        (torch_engine_mod, "chol_sample_dispatch", ("port", "full"))])
    orig = jax_engine_mod.dense_gram_contrib

    def jax_contrib(*a, **kw):
        seen.append(("jax", "s8" if kw.get("w_scale") is not None
                     else "float"))
        return orig(*a, **kw)
    monkeypatch.setattr(jax_engine_mod, "dense_gram_contrib", jax_contrib)
    return seen


def _float_pair_run(K, pallas, branches, **opts):
    ej, et = _f64_engines(K=K, pallas=pallas, **{**FLOAT_PAIR, **opts})
    assert 0 not in ej.problem.dense_w_scale and ej.problem.dense_plans
    assert not et.problem.pair_i8s[0]
    assert et.problem.stores[0]["M"].dtype == torch.float64
    calls = (pair_contract.pair_contract_plain.calls,
             chol_blocked.chol_inv_plain.calls)
    _run_both(ej, et, 3, "float64", _check_f64)
    assert branches.count(("port", "float")) == 6
    assert branches.count(("jax", "float")) == 2
    return (pair_contract.pair_contract_plain.calls - calls[0],
            chol_blocked.chol_inv_plain.calls - calls[1])


@pytest.mark.parametrize("K", [8, 36])
def test_float_pair_f64_matches_jax_engine(interpret_pallas, pair_branches,
                                           K):
    """``dense_int8=False``: both engines store the float pair and take the
    packed branch with the float contribution (the JAX engine's sampler in
    interpret mode; the port's K1 at K=8 and K2 at K=36 plain versions).
    U, mu and Lambda agree to 1e-8 after each of 3 float64 sweeps, and K6
    does not run."""
    calls = _float_pair_run(K, "on", pair_branches)
    assert calls == (0, 0)
    assert set(pair_branches) == {("jax", "float"), ("jax", "packed"),
                                  ("port", "float"), ("port", "packed")}


def test_float_pair_k100_f64_matches_jax_engine(pair_branches):
    """K=100: both engines unpack the float contribution to [n, K, K] (the
    port by expanding the packed triangle, the JAX package from the full
    K^2 table on 60 x 45) and sample from the full P (the JAX engine with pallas="off", the port with the blocked
    sampler).  3 float64 sweeps to 1e-8."""
    calls = _float_pair_run(100, "off", pair_branches)
    assert calls == (0, 12)
    assert set(pair_branches) == {("jax", "float"), ("jax", "full"),
                                  ("port", "float"), ("port", "full")}


def test_int8_ineligible_takes_float_pair(monkeypatch, interpret_pallas,
                                          pair_branches):
    """``dense_int8=True`` on a relation that fails ``int8_pair_ok`` (the
    check patched to refuse in both packages): both engines store the
    float pair instead, as the JAX engine does.  K=8, 3 float64 sweeps to
    1e-8."""
    monkeypatch.setattr(jdg, "int8_pair_ok", lambda *a, **k: False)
    monkeypatch.setattr(tdg, "int8_pair_ok", lambda *a, **k: False)
    calls = _float_pair_run(8, "on", pair_branches, dense_int8=True)
    assert calls == (0, 0)


@pytest.mark.parametrize("gram_dtype", [None, "bfloat16"])
def test_float_pair_f32_chain_matches_int8_pair(gram_dtype):
    """float32 chains of 20 sweeps on the same ratings and randoms: the
    float pair (float32 or bfloat16 store) against the int8 pair.  They
    round differently, so only the posterior-mean RMSE is held, to
    3e-2."""
    df = synthetic_ratings(300, 200, 12_000, seed=1)
    rmse = {}
    for int8 in (True, False):
        rd = bt.RelationData.from_indexed_df(df)
        rd.assign_to_test(0, 1_000, seed=7)
        eng = bt.MacauEngine(rd, bt.MacauConfig(
            num_latent=8, dtype="float32", seed=5, verbose=False,
            clamp=(1.0, 5.0), dense_gram=True, dense_int8=int8,
            gram_dtype=None if int8 else gram_dtype), device="cpu")
        assert eng.problem.pair_i8s[0] == int8
        state = eng.init_state()
        rng = np.random.default_rng(999)
        for s in range(20):
            randoms = trng.draw_all_numpy(rng, eng.problem.random_spec,
                                          np.dtype("float32"))
            state, m = eng._sweep_with_randoms(
                state, {k: torch.from_numpy(v) for k, v in randoms.items()},
                1.0 if s >= 10 else 0.0)
        rmse[int8] = float(m["r0.rmse_avg"])
    assert np.isfinite(rmse[False]) and abs(rmse[False] - rmse[True]) < 3e-2, \
        rmse


def test_config_defaults_match_jax():
    """Every field both MacauConfigs have has the same default (ROADMAP
    F6: ``dense_int8`` was True in the port) but the dense stores' budget,
    which is the card's, so a call with default settings takes the same
    path in both packages: on 200 observations, under the planner's floor,
    the gather path."""
    jax_cfg, port_cfg = MacauConfig(), bt.MacauConfig()
    common = ({f.name for f in dataclasses.fields(MacauConfig)}
              & {f.name for f in dataclasses.fields(bt.MacauConfig)})
    assert "dense_int8" in common and len(common) >= 20
    for name in sorted(common - {"dense_gram_budget_gb"}):
        assert getattr(port_cfg, name) == getattr(jax_cfg, name), name
    df = synthetic_ratings(30, 20, 200)
    eng = bt.MacauEngine(bt.RelationData.from_indexed_df(df),
                         bt.MacauConfig(num_latent=4, verbose=False),
                         device="cpu")
    ej = jax_engine_mod.MacauEngine(bdf.RelationData.from_indexed_df(
        bdf.IndexedDF(df.idx, df.vals, df.shape)),
        MacauConfig(num_latent=4, verbose=False))
    assert not ej.problem.dense_plans and not eng.problem.dense_plans
    assert not eng.problem.pair_i8s[0] and eng.problem.kinds[0] == "gather"
