"""The port's int8 pair Gramian against the JAX package's s8 branch of
``dense_gram_contrib`` and its host-side pair build."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayesiandatafusion_jl_tpu as bdf
from bayesiandatafusion_jl_tpu.models.engine import MacauEngine
from bayesiandatafusion_jl_tpu.ops import dense_gram as jdg
from bayesiandatafusion_jl_tpu.utils.config import MacauConfig
import bayesiandatafusion_jl_tpu_torch as bt
from bayesiandatafusion_jl_tpu_torch.models.engine import \
    MacauEngine as TorchEngine
from bayesiandatafusion_jl_tpu_torch.ops import dense_gram as tdg
from bayesiandatafusion_jl_tpu_torch.utils.config import \
    MacauConfig as TorchConfig
from _torch_xla_order import xla_cpu_ridge_step


@pytest.fixture
def xla_cpu_ridge(monkeypatch):
    """The port's ridge step summed in the JAX engine's (XLA:CPU) order."""
    monkeypatch.setattr(tdg, "ridge_step", xla_cpu_ridge_step)


def _relation(n0, n1, density, seed, dup=0):
    """idx/vals of a random 2-ary relation; ``dup`` observations repeat
    cells already present."""
    rng = np.random.default_rng(seed)
    mask = rng.random((n0, n1)) < density
    idx = np.stack(np.nonzero(mask), 1)
    if dup:
        idx = np.concatenate([idx, idx[rng.choice(len(idx), dup)]])
    vals = np.round(rng.uniform(1, 5, len(idx)) * 2) / 2
    return idx, vals


def _pair(n0, n1, density, seed, dtype, dup=0):
    idx, vals = _relation(n0, n1, density, seed, dup)
    cen = vals - vals.mean()
    return idx, cen, tdg.build_int8_pair(idx, cen, (n0, n1), dtype, "cpu")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("dup", [0, 40])
def test_int8_pair_build_matches_jax(dtype, dup):
    """The build over the observed cells gives the JAX package's dense
    store bitwise, with and without repeated cells: M8, W8 and w_scale;
    the per-focus copies are transposes, zero-padded."""
    n0, n1 = 37, 23
    idx, cen, pair = _pair(n0, n1, 0.4, 3, dtype, dup)
    M, W = jdg.build_dense_pair(idx, cen, (n0, n1), dtype)
    M8, W8, w_scale = jdg.quantize_dense_pair(M, W)
    assert pair["w_scale"] == w_scale
    for f in range(2):
        Mf, Wf = pair["M8"][f].numpy(), pair["W8"][f].numpy()
        assert Mf.shape[0] % tdg.STORE_ALIGN == 0
        assert Mf.shape[1] % tdg.STORE_ALIGN == 0
        want_m, want_w = (M8, W8) if f == 0 else (M8.T, W8.T)
        np.testing.assert_array_equal(Mf[:want_m.shape[0], :want_m.shape[1]],
                                      want_m)
        np.testing.assert_array_equal(Wf[:want_w.shape[0], :want_w.shape[1]],
                                      want_w)
        assert not Mf[want_m.shape[0]:].any()
        assert not Mf[:, want_m.shape[1]:].any()
        deg = np.bincount(idx[:, f], minlength=Mf.shape[0])
        np.testing.assert_array_equal(pair["deg"][f].numpy(), deg)


@pytest.mark.parametrize("mode", [0, 1])
def test_int8_contraction_sums_bitwise(mode):
    """The int32 sums of the quantized products equal the JAX einsum's."""
    n0, n1, K = 41, 30, 5
    idx, cen, pair = _pair(n0, n1, 0.5, 4, np.float32)
    M8 = pair["M8"][0][:n0, :n1].numpy()
    n_p = (n1, n0)[mode]
    rng = np.random.default_rng(1)
    A8 = rng.integers(-127, 128, (n_p, K + 3)).astype(np.int8)
    spec = "ab,bz->za" if mode == 0 else "ab,az->zb"
    want = np.asarray(jnp.einsum(spec, jnp.asarray(M8), jnp.asarray(A8),
                                 preferred_element_type=jnp.int32))
    Mf = pair["M8"][mode]
    A8p = np.zeros((Mf.shape[1], K + 3), np.int8)
    A8p[:n_p] = A8
    got = tdg.int8_matmul(torch.from_numpy(A8p.T.copy()), Mf.mT).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got[:, :(n0, n1)[mode]], want)
    assert not got[:, (n0, n1)[mode]:].any()


@pytest.mark.parametrize("mode", [0, 1])
def test_dense_gram_contrib_matches_jax(mode, xla_cpu_ridge):
    """P and b after dequantization, alpha fold and PD ridge, float64:
    elementwise arithmetic on exact int32 sums, equal scales and the same
    float32 ridge mean, so bitwise equal."""
    n0, n1, K = 41, 30, 6
    idx, cen, pair = _pair(n0, n1, 0.5, 5, np.float64)
    rng = np.random.default_rng(2)
    partner = rng.standard_normal(((n1, n0)[mode], K))
    alpha = 3.7
    M, W = jdg.build_dense_pair(idx, cen, (n0, n1), np.float64)
    M8, W8, w_scale = jdg.quantize_dense_pair(M, W)
    deg = np.bincount(idx[:, mode], minlength=(n0, n1)[mode])
    # compiled, as the JAX engine's sweep runs it
    Pj, bj = jax.jit(functools.partial(
        jdg.dense_gram_contrib, focus_axis=mode, dims=(n0, n1),
        out_dtype=jnp.float64, op_dtype=jnp.float64, packed=True,
        transposed=True, w_scale=w_scale))(
        jnp.asarray(M8), jnp.asarray(W8), [jnp.asarray(partner)],
        ridge_deg=jnp.asarray(deg, jnp.float32),
        alpha=jnp.asarray(alpha, jnp.float64))
    Pj, bj = np.asarray(Pj), np.asarray(bj)
    Pt, bt_ = tdg.dense_gram_contrib(
        pair, tdg.tri_index(K, "cpu"), torch.from_numpy(partner), mode,
        torch.tensor(alpha, dtype=torch.float64), torch.float64)
    n_f = (n0, n1)[mode]
    Pt, bt_ = Pt.numpy(), bt_.numpy()
    assert Pt.dtype == bt_.dtype == np.float64
    assert not Pt[:, n_f:].any() and not bt_[:, n_f:].any()
    np.testing.assert_array_equal(bt_[:, :n_f], bj)
    np.testing.assert_array_equal(Pt[:, :n_f], Pj)


@pytest.mark.parametrize("mode", [0, 1])
def test_dense_gram_contrib_unpacked_matches_jax(mode, xla_cpu_ridge):
    """The unpacked output the full-P branch (K > 96) consumes: P [n, K, K]
    and b [n, K] with the pads stripped, bitwise equal to the JAX
    package's packed=False, batch-leading output (float64)."""
    n0, n1, K = 41, 30, 6
    idx, cen, pair = _pair(n0, n1, 0.5, 5, np.float64)
    rng = np.random.default_rng(3)
    partner = rng.standard_normal(((n1, n0)[mode], K))
    M, W = jdg.build_dense_pair(idx, cen, (n0, n1), np.float64)
    M8, W8, w_scale = jdg.quantize_dense_pair(M, W)
    deg = np.bincount(idx[:, mode], minlength=(n0, n1)[mode])
    Pj, bj = jax.jit(functools.partial(
        jdg.dense_gram_contrib, focus_axis=mode, dims=(n0, n1),
        out_dtype=jnp.float64, op_dtype=jnp.float64, packed=False,
        w_scale=w_scale))(
        jnp.asarray(M8), jnp.asarray(W8), [jnp.asarray(partner)],
        ridge_deg=jnp.asarray(deg, jnp.float32),
        alpha=jnp.asarray(2.5, jnp.float64))
    Pt, bt_ = tdg.dense_gram_contrib(
        pair, tdg.tri_index(K, "cpu"), torch.from_numpy(partner), mode,
        torch.tensor(2.5, dtype=torch.float64), torch.float64, packed=False)
    n_f = (n0, n1)[mode]
    assert tuple(Pt.shape) == (n_f, K, K) and tuple(bt_.shape) == (n_f, K)
    np.testing.assert_array_equal(bt_.numpy(), np.asarray(bj))
    np.testing.assert_array_equal(Pt.numpy(), np.asarray(Pj))


@pytest.mark.parametrize("K", [1, 6, 8, 32, 46])
def test_ridge_step_matches_jax(K):
    """The ridge's float32 step mean(s) * sqrt(K) / 2 over the C = K(K+1)/2
    row scales: the port's equals the compiled JAX expression's to float32
    rounding, and the XLA:CPU-order sum the parity tests patch in equals it
    bit for bit."""
    C = K * (K + 1) // 2
    rng = np.random.default_rng(K)
    s = (rng.random(C) * 10 ** rng.uniform(-3, 0, C)).astype(np.float32)
    want = np.float32(jax.jit(
        lambda v: jnp.mean(v) * (0.5 * float(np.sqrt(K))))(jnp.asarray(s)))
    got = tdg.ridge_step(torch.from_numpy(s), K)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)
    emu = xla_cpu_ridge_step(torch.from_numpy(s), K)
    assert emu.dtype == torch.float32 and emu.item() == want


def test_engine_store_and_split_match_jax():
    """The port's engine stores the JAX engine's int8 pair, ridge degrees
    and test split bitwise for the same data and seed."""
    rng = np.random.default_rng(11)
    n0, n1 = 60, 45
    mask = rng.random((n0, n1)) < 0.5
    R = rng.standard_normal((n0, n1))
    idx = np.stack(np.nonzero(mask), 1)
    rd_j = bdf.RelationData.from_indexed_df(bdf.IndexedDF(idx, R[mask],
                                                          (n0, n1)))
    rd_t = bt.RelationData.from_indexed_df(bt.IndexedDF(idx, R[mask],
                                                        (n0, n1)))
    rd_j.assign_to_test(0, 150, seed=7)
    rd_t.assign_to_test(0, 150, seed=7)
    ej = MacauEngine(rd_j, MacauConfig(num_latent=4, dtype="float64",
                                       dense_gram=True, dense_int8=True,
                                       verbose=False))
    et = TorchEngine(rd_t, TorchConfig(num_latent=4, dtype="float64",
                                       verbose=False), device="cpu")
    np.testing.assert_array_equal(rd_t.relations[0].test_idx,
                                  rd_j.relations[0].test_idx)
    np.testing.assert_array_equal(et.problem.test["r0"]["vals"].numpy(),
                                  np.asarray(ej.problem.arrays["test"]["r0"]
                                             ["vals"]))
    assert et.problem.pair["w_scale"] == ej.problem.dense_w_scale[0]
    st = ej.problem.arrays["dense"]["r0"]
    pair = et.problem.pair
    np.testing.assert_array_equal(pair["M8"][0][:n0, :n1].numpy(),
                                  np.asarray(st["M"]))
    np.testing.assert_array_equal(pair["W8"][0][:n0, :n1].numpy(),
                                  np.asarray(st["W"]))
    for f in range(2):
        n_f = (n0, n1)[f]
        np.testing.assert_array_equal(pair["deg"][f][:n_f].numpy(),
                                      np.asarray(st[f"deg_m{f}"]))
    assert et.problem.rel_specs[0].mean_value == \
        ej.problem.rel_specs[0].mean_value
