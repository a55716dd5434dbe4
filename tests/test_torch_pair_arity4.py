"""The int8 pair at arity 4 and up against the JAX package's s8 branch.

The store keeps the modes in ``store_order`` (the largest first, the
second largest last, the rest between); each focus mode's first step is
K6's contraction of its largest partner on the store read as a matrix,
exact in int32; the second step reduces the two or more small partners in
one float einsum.  Op by op on (5, 4, 3, 2) and a 5-ary tensor, every
mode, packed and unpacked, at the arity-3 case's tolerances; then the
engine on the (5, 4, 3, 2) tensor, 3 float64 sweeps to 1e-8."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayesiandatafusion_jl_tpu as bdf
from bayesiandatafusion_jl_tpu.models.engine import MacauEngine
from bayesiandatafusion_jl_tpu.ops import dense_gram as jdg
from bayesiandatafusion_jl_tpu.utils.config import MacauConfig
import bayesiandatafusion_jl_tpu_torch as bt
from bayesiandatafusion_jl_tpu_torch.ops import dense_gram as tdg
from bayesiandatafusion_jl_tpu_torch.ops import pair_contract as tpc
from _torch_xla_order import xla_cpu_ridge_step
from test_torch_graph import _run_both


@pytest.fixture
def xla_cpu_ridge(monkeypatch):
    """The port's ridge step summed in the JAX engine's (XLA:CPU) order."""
    monkeypatch.setattr(tdg, "ridge_step", xla_cpu_ridge_step)


def _tensor(shape, seed, density=0.4):
    rng = np.random.default_rng(seed)
    mask = rng.random(shape) < density
    idx = np.stack(np.nonzero(mask), 1)
    vals = rng.standard_normal(len(idx))
    return idx, vals - vals.mean(), rng


@pytest.mark.parametrize("shape, order", [((5, 4, 3, 2), (0, 2, 3, 1)),
                                          ((3, 7, 2, 5, 2), (1, 0, 2, 4, 3))])
def test_store_order_generalizes(shape, order):
    """The largest extent first, the largest of the others last, the rest
    between in mode order; every focus mode's largest partner sits at an
    end of the store."""
    assert tdg.store_order(shape) == order
    for mode in range(len(shape)):
        big = tdg.big_partner(shape, mode)
        assert big == (order[-1] if mode == order[0] else order[0])


@pytest.mark.parametrize("shape", [(5, 4, 3, 2), (3, 7, 2, 5, 2)])
@pytest.mark.parametrize("layout", ["packed", "unpacked"])
def test_int8_arity4_contrib_matches_jax(shape, layout):
    """The store equals JAX's quantized pair permuted to ``store_order``,
    with the same ``w_scale``; each mode's first step equals an int64
    einsum of JAX's codes against JAX's quantized table of the largest
    partner; the whole contribution (float64, alpha 2.5, the ridge) equals
    the JAX s8 branch: b and P off its diagonal to 1e-12 of the largest
    entry, the diagonal (a float32 ridge step XLA sums in its own order)
    to float32 precision."""
    D, K = len(shape), 3
    idx, cen, rng = _tensor(shape, 4)
    M, W = jdg.build_dense_pair(idx, cen.copy(), shape, np.float64)
    M8, W8, w_scale = jdg.quantize_dense_pair(M, W)
    pair = tdg.build_int8_pair(idx, cen, shape, np.float64, "cpu")
    order = pair["order"]
    assert pair["w_scale"] == w_scale
    store = pair["M8"].numpy()[tuple(slice(0, shape[d]) for d in order)]
    np.testing.assert_array_equal(store,
                                  np.transpose(M8.reshape(shape), order))
    Us = [rng.standard_normal((n, K)) for n in shape]
    tri = tdg.tri_index(K, "cpu")
    iu, ju, _ = jdg._tri_maps(K)
    letters = "abcde"[:D]
    for mode in range(D):
        parts = [d for d in range(D) if d != mode]
        big = tdg.big_partner(shape, mode)
        Uf = np.asarray(Us[big], np.float32)
        Y8, _ = jdg._quantize_cols(jnp.asarray(Uf[:, iu] * Uf[:, ju]))
        rem = [d for d in range(D) if d != big]
        want = np.einsum(
            f"{letters},{letters[big]}z->{''.join(letters[d] for d in rem)}z",
            M8.reshape(shape).astype(np.int64), np.asarray(Y8, np.int64))
        M2, k6_mode, axes = tdg._step1_view(pair["M8"], order, big)
        YZ8T = tdg.fused_quantize(torch.from_numpy(Us[big]),
                                  pad_rows=M2.shape[1 - k6_mode], tri=tri)[0]
        PM, _ = tpc.pair_contract_plain(M2, pair["W8"].view(M2.shape), YZ8T,
                                        k6_mode, K, M2.shape[k6_mode])
        modes = [order[ax] for ax in axes]
        got = PM.numpy().reshape((-1,) + tuple(pair["M8"].shape[ax]
                                               for ax in axes))
        got = got[(slice(None),) + tuple(slice(0, shape[d]) for d in modes)]
        perm = [1 + modes.index(d) for d in rem] + [0]
        np.testing.assert_array_equal(np.transpose(got, perm), want)
        packed = layout == "packed"
        Pj, bj = jdg.dense_gram_contrib(
            jnp.asarray(M8), jnp.asarray(W8),
            [jnp.asarray(Us[d]) for d in parts], mode, shape, jnp.float64,
            jnp.float64, packed=packed, transposed=packed, w_scale=w_scale,
            ridge_deg=jnp.asarray(np.bincount(idx[:, mode],
                                              minlength=shape[mode]),
                                  jnp.float32),
            alpha=jnp.asarray(2.5))
        Pt, b = tdg.int8_pair_contrib(
            pair, tri, [torch.from_numpy(Us[d]) for d in parts], mode,
            torch.tensor(2.5, dtype=torch.float64), torch.float64,
            packed=packed)
        Pj, bj = np.asarray(Pj), np.asarray(bj)
        assert Pt.shape == Pj.shape and b.shape == bj.shape
        np.testing.assert_allclose(b.numpy(), bj, rtol=0,
                                   atol=1e-12 * np.abs(bj).max())
        diag = np.zeros(Pj.shape, bool)
        if packed:
            diag[iu == ju] = True
        else:
            diag[:, np.arange(K), np.arange(K)] = True
        np.testing.assert_allclose(Pt.numpy()[~diag], Pj[~diag], rtol=0,
                                   atol=1e-12 * np.abs(Pj).max())
        np.testing.assert_allclose(Pt.numpy()[diag], Pj[diag], rtol=1e-6)


@pytest.mark.parametrize("K", [3, 8])
def test_int8_arity4_engine_matches_jax(xla_cpu_ridge, K):
    """The (5, 4, 3, 2) tensor on the int8 pair (``dense_gram=True``,
    ``dense_int8=True``) in both engines: one store [5, 3, 2, 4] for all
    four modes, P packed; 3 float64 sweeps to 1e-8."""
    def graph(pkg):
        idx, vals, _ = _tensor((5, 4, 3, 2), 9, density=0.7)
        rd = pkg.RelationData.from_indexed_df(
            pkg.IndexedDF(idx, vals, (5, 4, 3, 2)))
        rd.assign_to_test(0, 10, seed=7)
        return rd
    common = dict(num_latent=K, dtype="float64", seed=5, verbose=False,
                  dense_gram=True, dense_int8=True)
    ej = MacauEngine(graph(bdf), MacauConfig(pallas="off", **common))
    et = bt.MacauEngine(graph(bt), bt.MacauConfig(**common), device="cpu")
    prob = et.problem
    assert prob.kinds == ["pair"] and prob.pair_i8s == [True]
    assert prob.stores[0]["order"] == (0, 2, 3, 1)
    assert tuple(prob.stores[0]["M8"].shape) == (16, 3, 2, 16)
    assert len(prob.dense_plans) == 4 and not prob.layouts
    _run_both(ej, et)
