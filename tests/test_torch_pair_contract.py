"""The int8 pair contraction (K6): its plain version against the JAX
package's ``pair_contract_pallas`` (interpret mode) and an int64 matmul,
and the one-store int8 pair Gramian (``int8_pair_contrib``) against the
JAX package's s8 branch of ``dense_gram_contrib``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from bayesiandatafusion_jl_tpu.ops import dense_gram as jdg
from bayesiandatafusion_jl_tpu_torch.ops import dense_gram as tdg
from bayesiandatafusion_jl_tpu_torch.ops import pair_contract as tpc
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


def _pad16(n):
    return -(-n // 16) * 16


def _random_pair(true, K, seed):
    """A random stored pair on the true extents ``true`` (the store padded
    to multiples of 16, pad cells 0), a random int8 table YZ8T [C + K,
    stored partner extent] per focus mode (pad rows 0) and random float32
    scales."""
    rng = np.random.default_rng(seed)
    C = K * (K + 1) // 2
    stored = [_pad16(d) for d in true]
    M8 = np.zeros(stored, np.int8)
    W8 = np.zeros(stored, np.int8)
    obs = rng.random(true) < 0.4
    M8[:true[0], :true[1]] = obs * rng.integers(1, 4, true)
    W8[:true[0], :true[1]] = obs * rng.integers(-127, 128, true)
    tables = []
    for mode in range(2):
        t = np.zeros((C + K, stored[1 - mode]), np.int8)
        t[:, :true[1 - mode]] = rng.integers(-127, 128,
                                             (C + K, true[1 - mode]))
        tables.append(t)
    s_yz = rng.uniform(0.5, 2.0, C + K).astype(np.float32)
    s_z = rng.uniform(0.5, 2.0, K).astype(np.float32)
    return M8, W8, tables, s_yz, s_z


@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("true, K", [((64, 256), 4), ((64, 256), 8),
                                     ((37, 83), 8)])
def test_pair_contract_plain_matches_pallas(interpret_pallas, true, K,
                                            mode):
    """The dq epilogue of the plain version equals the JAX kernel's output
    (interpret mode) bit for bit, both orientations: exact int32 sums and
    one float32 scale multiply.  The JAX kernel takes extents that are
    multiples of its blocks, so the ragged (37, 83) store (stored
    (48, 96) here) is zero-padded further for it; pads add nothing."""
    from bayesiandatafusion_jl_tpu.ops.pallas_pair import \
        pair_contract_pallas
    C = K * (K + 1) // 2
    M8, W8, tables, s_yz, s_z = _random_pair(true, K, seed=K + 5 * mode)
    jshape = (-(-M8.shape[0] // 64) * 64, -(-M8.shape[1] // 256) * 256)
    jM8, jW8 = (np.zeros(jshape, np.int8) for _ in range(2))
    jM8[:M8.shape[0], :M8.shape[1]] = M8
    jW8[:W8.shape[0], :W8.shape[1]] = W8
    YZ8 = np.zeros((jshape[1 - mode], C + K), np.int8)
    YZ8[:tables[mode].shape[1]] = tables[mode].T
    Pj, bj = pair_contract_pallas(
        jnp.asarray(jM8), jnp.asarray(jW8), jnp.asarray(YZ8),
        jnp.asarray(YZ8[:, C:]), jnp.asarray(s_yz), jnp.asarray(s_z), mode)
    n_f = true[mode]
    Pt, b = tpc.pair_contract(
        torch.from_numpy(M8), torch.from_numpy(W8),
        torch.from_numpy(tables[mode]), mode, K, n_f,
        dq=(torch.from_numpy(s_yz[:C]), torch.from_numpy(s_z)))
    assert Pt.dtype == b.dtype == torch.float32
    assert tuple(Pt.shape) == (C, n_f) and tuple(b.shape) == (K, n_f)
    np.testing.assert_array_equal(Pt.numpy(), np.asarray(Pj)[:, :n_f])
    np.testing.assert_array_equal(b.numpy(), np.asarray(bj)[:, :n_f])


@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("true, K, n_focus", [((37, 83), 4, None),
                                              ((300, 47), 33, None),
                                              ((129, 257), 12, 100)])
def test_pair_contract_raw_matches_int64_matmul(true, K, n_focus, mode):
    """The raw epilogue: exact int32 PM [C, n_focus] and BV [K, n_focus]
    against an int64 numpy matmul of the stored pair, for the first
    ``n_focus`` focus rows (all by default), with a chunk smaller than the
    focus extent; the CPU wrapper counts one plain call and no launch."""
    C = K * (K + 1) // 2
    M8, W8, tables, _, _ = _random_pair(true, K, seed=K)
    n_f = true[mode] if n_focus is None else n_focus
    T = tables[mode].astype(np.int64)
    Mf, Wf = (a.astype(np.int64) if mode == 1 else a.astype(np.int64).T
              for a in (M8, W8))
    calls, launches = (tpc.pair_contract_plain.calls,
                       tpc.pair_contract.launches)
    PM, BV = tpc.pair_contract(torch.from_numpy(M8), torch.from_numpy(W8),
                               torch.from_numpy(tables[mode]), mode, K, n_f)
    assert (tpc.pair_contract_plain.calls,
            tpc.pair_contract.launches) == (calls + 1, launches)
    assert PM.dtype == BV.dtype == torch.int32
    np.testing.assert_array_equal(PM.numpy(), (T[:C] @ Mf)[:, :n_f])
    np.testing.assert_array_equal(BV.numpy(), (T[C:] @ Wf)[:, :n_f])
    PMc, BVc = tpc.pair_contract_plain(
        torch.from_numpy(M8), torch.from_numpy(W8),
        torch.from_numpy(tables[mode]), mode, K, n_f, chunk=40)
    assert torch.equal(PMc, PM) and torch.equal(BVc, BV)


def _relation(n0, n1, density, seed):
    rng = np.random.default_rng(seed)
    idx = np.stack(np.nonzero(rng.random((n0, n1)) < density), 1)
    vals = np.round(rng.uniform(1, 5, len(idx)) * 2) / 2
    return idx, vals - vals.mean()


def _jax_s8(idx, cen, shape, partner, mode, K, alpha, dtype, packed,
            jit=True):
    """The JAX package's s8 branch, compiled as the engine runs it (or
    op by op, ``jit=False``)."""
    M, W = jdg.build_dense_pair(idx, cen, shape, dtype)
    M8, W8, w_scale = jdg.quantize_dense_pair(M, W)
    deg = np.bincount(idx[:, mode], minlength=shape[mode])
    jt = jnp.float64 if dtype == np.float64 else jnp.float32
    fn = functools.partial(
        jdg.dense_gram_contrib, focus_axis=mode, dims=shape, out_dtype=jt,
        op_dtype=jt, packed=packed, transposed=packed, w_scale=w_scale)
    P, b = (jax.jit(fn) if jit else fn)(
        jnp.asarray(M8), jnp.asarray(W8), [jnp.asarray(partner, jt)],
        ridge_deg=jnp.asarray(deg, jnp.float32),
        alpha=jnp.asarray(alpha, jt))
    return np.asarray(P), np.asarray(b)


@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("K", [4, 8])
def test_dense_gram_contrib_f32_one_store_matches_jax(xla_cpu_ridge, K,
                                                      mode):
    """float32, the card's arithmetic: the one stored pair through K6's
    dequant epilogue (its plain version), alpha folded into the float32
    scales, against the JAX package's s8 branch run op by op: b and P off
    the diagonal bit for bit, the diagonal (the ridge's float32 mean, summed
    in another order op by op) to 1e-6.  Compiled, XLA:CPU reassociates the
    float32 scale products and moves b by an ulp: held to 1e-6."""
    n0, n1 = 53, 38
    idx, cen = _relation(n0, n1, 0.5, 6 + K)
    rng = np.random.default_rng(K)
    partner = rng.standard_normal(((n1, n0)[mode], K)).astype(np.float32)
    Pj, bj = _jax_s8(idx, cen, (n0, n1), partner, mode, K, 2.5, np.float32,
                     True, jit=False)
    Pc, bc = _jax_s8(idx, cen, (n0, n1), partner, mode, K, 2.5, np.float32,
                     True)
    pair = tdg.build_int8_pair(idx, cen, (n0, n1), np.float32, "cpu")
    assert tuple(pair["M8"].shape) == tuple(pair["W8"].shape) == (64, 48)
    calls = tpc.pair_contract_plain.calls
    P, b = tdg.int8_pair_contrib(
        pair, tdg.tri_index(K, "cpu"), [torch.from_numpy(partner)], mode,
        torch.tensor(2.5), torch.float32)
    assert tpc.pair_contract_plain.calls == calls + 1
    assert P.dtype == b.dtype == torch.float32
    np.testing.assert_array_equal(b.numpy(), bj)
    diag = np.nonzero(tdg.tri_maps(K)[0] == tdg.tri_maps(K)[1])[0]
    off = np.setdiff1d(np.arange(P.shape[0]), diag)
    np.testing.assert_array_equal(P.numpy()[off], Pj[off])
    np.testing.assert_allclose(P.numpy()[diag], Pj[diag], rtol=1e-6)
    np.testing.assert_allclose(b.numpy(), bc, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(P.numpy(), Pc, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", [0, 1])
def test_dense_gram_contrib_k100_one_store_matches_jax(xla_cpu_ridge, mode):
    """K = 100, the full-P layout: the table quantized by K7's plain
    version, K6's raw sums dequantized in float64, the ridge, the expand
    to [n, K, K]; bit for bit against the JAX package's s8 branch
    (packed=False)."""
    n0, n1, K = 29, 21, 100
    idx, cen = _relation(n0, n1, 0.5, 9)
    partner = np.random.default_rng(4).standard_normal(((n1, n0)[mode], K))
    Pj, bj = _jax_s8(idx, cen, (n0, n1), partner, mode, K, 1.5, np.float64,
                     False)
    pair = tdg.build_int8_pair(idx, cen, (n0, n1), np.float64, "cpu")
    P, b = tdg.int8_pair_contrib(
        pair, tdg.tri_index(K, "cpu"), [torch.from_numpy(partner)], mode,
        torch.tensor(1.5, dtype=torch.float64), torch.float64, packed=False)
    assert tuple(P.shape) == (n0, n1)[mode:mode + 1] + (K, K)
    np.testing.assert_array_equal(b.numpy(), bj)
    np.testing.assert_array_equal(P.numpy(), Pj)
