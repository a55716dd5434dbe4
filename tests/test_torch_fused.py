"""The port's fused sparse regime against the JAX package: the host planner
and encoding (numpy, bit for bit), the quantized partner table (K7's plain
version against ``ytab_quantize_pallas``), the masked-pair contraction (K8's
plain version against ``fused_pair_pallas``: int8 and float operands, the
``flip_out`` and the natural layout), both in interpret mode, the per-mode
contributions ``fused_gram_contrib_i8`` (packed and expanded) and
``fused_gram_contrib`` (float), and the Netflix-shaped generator."""
import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from bayesiandatafusion_jl_tpu.ops import dense_gram as jdg
from bayesiandatafusion_jl_tpu.ops.pallas_fused import fused_pair_pallas
from bayesiandatafusion_jl_tpu.ops.pallas_ytab import ytab_quantize_pallas
from bayesiandatafusion_jl_tpu_torch.models.datasets import netflix_synthetic
from bayesiandatafusion_jl_tpu_torch.ops import dense_gram as tdg
from bayesiandatafusion_jl_tpu_torch.ops import fused_pair, ytab
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


def _coo(rng, n0, n1, nnz):
    lin = rng.choice(n0 * n1, size=nnz, replace=False)
    return np.stack([lin // n1, lin % n1], 1).astype(np.int64)


# ---------------------------------------------------------------------------
# host side: the planner and the encoding, bit for bit
# ---------------------------------------------------------------------------

def _case(name):
    """(idx, vals, shape, tol) of one planner case (tests/test_fused_dense.py
    :28-152)."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    idx = _coo(rng, 30, 30, 255)
    if name == "stars":
        return idx, rng.integers(1, 6, 255).astype(np.float64), None
    if name == "half_stars":
        return idx, rng.integers(1, 11, 255) * 0.5, None
    if name == "binary":
        return idx, rng.integers(0, 2, 255).astype(np.float64), None
    if name == "duplicates":
        vals = rng.integers(1, 6, 255).astype(np.float64)
        return (np.concatenate([idx, idx[:7]]),
                np.concatenate([vals, rng.integers(1, 6, 7).astype(float)]),
                None)
    if name == "zero_code_level":
        return idx, np.arange(255, dtype=np.float64), None
    if name == "continuous":
        return idx, rng.standard_normal(255), None
    if name == "tol_grid":
        return idx, rng.standard_normal(255), 0.05
    if name == "tol_too_fine":
        return idx, rng.standard_normal(255) * 1000.0, 0.05
    if name == "wide_grid":
        return idx, rng.choice([0.0, 1.0, 1000.0], 255), None
    raise KeyError(name)


PLAN_CASES = ["stars", "half_stars", "binary", "duplicates",
              "zero_code_level", "continuous", "tol_grid", "tol_too_fine",
              "wide_grid"]


@pytest.mark.parametrize("name", PLAN_CASES)
def test_fused_pair_plan_matches_jax(name):
    """fused_pair_plan and fused_pair_encode give the JAX package's (s, m)
    and keep mask, or its None; the codes, their bound and |codes| too."""
    idx, vals, tol = _case(name)
    shape = (30, 30)
    want = jdg.fused_pair_plan(idx, vals, shape, tol=tol)
    got = tdg.fused_pair_plan(idx, vals, shape, tol=tol)
    assert tdg.fused_pair_encode(idx, vals, shape) == \
        jdg.fused_pair_encode(idx, vals, shape)
    if want is None:
        assert got is None
        return
    assert got[:2] == want[:2]
    np.testing.assert_array_equal(got[2], want[2])
    s, m = got[:2]
    np.testing.assert_array_equal(tdg.encode_fused_values(vals, s, m),
                                  jdg.encode_fused_values(vals, s, m))
    assert tdg.fused_code_bound(vals, s, m) == \
        jdg.fused_code_bound(vals, s, m)
    np.testing.assert_array_equal(tdg.fused_abs_codes(vals, s, m),
                                  jdg.fused_abs_codes(vals, s, m))


def test_fused_plan_residual_cases():
    """The residual cases: the duplicates and the one zero-code level
    observation are left out of keep, every kept code is nonzero."""
    for name, n_out in (("duplicates", 7), ("zero_code_level", 1)):
        idx, vals, tol = _case(name)
        s, m, keep = tdg.fused_pair_plan(idx, vals, (30, 30), tol=tol)
        assert (~keep).sum() == n_out
        assert (tdg.encode_fused_values(vals[keep], s, m) != 0).all()


@pytest.mark.parametrize("key_bound", [900, 2 ** 61])
def test_first_per_key_equals_unique(key_bound):
    """The planner's first observation per cell: one sort of (key,
    position) packed into an int64 where the bits allow, ``np.unique``
    where they do not; both give ``np.unique(return_index=True)``'s
    positions."""
    key = np.random.default_rng(3).integers(0, 900, 5_000)
    want = np.sort(np.unique(key, return_index=True)[1])
    np.testing.assert_array_equal(tdg._first_per_key(key, key_bound), want)


def test_fused_int8_ok_matches_jax():
    """The dense worst case declines Netflix's shape at |e| = 127, the
    per-fiber bound admits sparse data and declines a hot fiber — as in
    the JAX package."""
    shape = (480_189, 17_770)
    rng = np.random.default_rng(8)
    idx = _coo(rng, 500, 400, 5_000)
    codes = rng.integers(1, 128, 5_000).astype(np.float64)
    hot = np.stack([np.zeros(200_000, np.int64),
                    np.arange(200_000) % 400], 1)
    for args, kw in (((127, shape), {}), ((5, shape), {}),
                     ((127, shape), dict(idx=idx, abs_codes=codes)),
                     ((127, shape), dict(idx=hot, abs_codes=np.full(
                         200_000, 127.0)))):
        assert tdg.fused_int8_ok(*args, **kw) == \
            jdg.fused_int8_ok(*args, **kw)
    assert not tdg.fused_int8_ok(127, shape)
    assert tdg.fused_int8_ok(127, shape, idx=idx, abs_codes=codes)


def test_plan_fused_rels():
    """True takes the encodable 2-ary relations within the budget; None
    (under the floor, or where the pair fits) and False keep the pair, as
    does dense_gram=False; a store past the budget is declined."""
    shapes, enc = [(5, 4), (5, 4), (5, 4, 3)], [(0.5, 1), None, (1.0, 0)]
    nnzs, its = [20, 20, 60], [1, 1, 1]
    assert tdg.plan_fused_rels(shapes, nnzs, 8, None, True, enc, its,
                               1e9) == ({0: (0.5, 1)}, 20.0)
    for dg_, df_ in ((None, None), (None, False), (False, True)):
        assert tdg.plan_fused_rels(shapes, nnzs, 8, dg_, df_, enc, its,
                                   1e9) == ({}, 0.0)
    assert tdg.plan_fused_rels(shapes, nnzs, 8, None, True, enc, its,
                               10.0) == ({}, 0.0)


def test_build_fused_store_matches_jax():
    """The device store: V8 equals the JAX host build on the true extents,
    zero-padded to a multiple of 16, and the ridge degrees count each
    mode's observations."""
    rng = np.random.default_rng(9)
    n0, n1 = 701, 37
    idx = _coo(rng, n0, n1, 4000)
    vals = rng.integers(1, 6, 4000).astype(np.float64)
    s, m = tdg.fused_pair_encode(idx, vals, (n0, n1))
    st = tdg.build_fused_store(idx, vals, (n0, n1), s, m, "cpu")
    V8 = st["V8"].numpy()
    assert V8.shape == (704, 48) and st["shape"] == (n0, n1)
    np.testing.assert_array_equal(
        V8[:n0, :n1], jdg.build_fused_values(idx, vals, (n0, n1), s, m))
    assert not V8[n0:].any() and not V8[:, n1:].any()
    for f in range(2):
        np.testing.assert_array_equal(
            st["deg"][f].numpy(),
            np.bincount(idx[:, f], minlength=V8.shape[f]))


# ---------------------------------------------------------------------------
# K7: the quantized partner table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K, n, n_valid", [(4, 37, None), (8, 40, 29),
                                           (32, 130, None), (32, 130, 100),
                                           (36, 70, 61)])
def test_ytab_plain_matches_pallas(interpret_pallas, K, n, n_valid):
    """K7's plain version equals ytab_quantize_pallas (interpret mode) bit
    for bit, transposed: codes, scales, n_valid and the out_rows pad."""
    rng = np.random.default_rng(91 + K)
    U = rng.standard_normal((n, K)).astype(np.float32)
    want8, want_s = ytab_quantize_pallas(jnp.asarray(U), n_valid,
                                         out_rows=n + 37)
    got8, got_s = ytab.ytab_quantize(torch.from_numpy(U), n_valid,
                                     out_rows=n + 37)
    assert got8.dtype == torch.int8 and tuple(got8.shape) == (
        K * (K + 1) // 2 + K, n + 37)
    np.testing.assert_array_equal(got8.numpy().T, np.asarray(want8))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    # and _quantize_cols of the XLA path, the JAX engine's quantization
    yz, _, s_yz, _ = jdg.fused_quantize(jnp.asarray(U), n_valid)
    np.testing.assert_array_equal(got8.numpy()[:, :n].T, np.asarray(yz))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(s_yz))


@pytest.mark.parametrize("K, n, n_valid", [(65, 37, None), (97, 40, 29),
                                           (128, 33, 30)])
def test_ytab_plain_matches_jax_xla_above_64(K, n, n_valid):
    """Above the JAX kernel's K = 64, K7's plain version equals the JAX
    package's XLA quantization (``fused_quantize``: ``_quantize_cols`` of
    the packed triangle and of the factors) bit for bit, transposed, with
    n_valid and an out_rows pad: the function K7 computes up to K = 128."""
    rng = np.random.default_rng(7 + K)
    U = rng.standard_normal((n, K)).astype(np.float32)
    got8, got_s = ytab.ytab_quantize(torch.from_numpy(U), n_valid,
                                     out_rows=n + 19)
    yz, _, s_yz, _ = jdg.fused_quantize(jnp.asarray(U), n_valid)
    assert got8.dtype == torch.int8 and tuple(got8.shape) == (
        K * (K + 1) // 2 + K, n + 19)
    np.testing.assert_array_equal(got8.numpy()[:, :n].T, np.asarray(yz))
    assert not got8[:, n:].any()
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(s_yz))


@pytest.mark.parametrize("K, k7", [(128, True), (129, False)])
def test_fused_quantize_routes_by_k(monkeypatch, K, k7):
    """``fused_quantize`` quantizes the table on K7 (here its plain
    version, on the CPU) up to K = 128 and by torch ops
    (``quantize_table_t``) above, by K alone: the same codes either way."""
    table_t, orig = [], tdg.quantize_table_t

    def counting(*a):
        table_t.append(a)
        return orig(*a)
    monkeypatch.setattr(tdg, "quantize_table_t", counting)
    calls = ytab.ytab_quantize_plain.calls
    U = torch.from_numpy(np.random.default_rng(K).standard_normal(
        (5, K)).astype(np.float32))
    YZ8T, _, s_yz, _ = tdg.fused_quantize(U, pad_rows=16)
    assert ytab.ytab_quantize_plain.calls - calls == (1 if k7 else 0)
    assert len(table_t) == (0 if k7 else 1)
    want8, want_s = ytab.ytab_quantize_plain(U, out_rows=16)
    assert torch.equal(YZ8T, want8) and torch.equal(s_yz, want_s)


def test_fused_quantize_views():
    """fused_quantize: Z8T and s_z are YZ8T's and s_yz's last K rows."""
    U = torch.from_numpy(np.random.default_rng(2).standard_normal((21, 6)))
    YZ8T, Z8T, s_yz, s_z = tdg.fused_quantize(U, pad_rows=32)
    assert tuple(YZ8T.shape) == (27, 32) and not YZ8T[:, 21:].any()
    assert torch.equal(Z8T, YZ8T[21:]) and torch.equal(s_z, s_yz[21:])


# ---------------------------------------------------------------------------
# K8: the masked-pair contraction
# ---------------------------------------------------------------------------

def _contract_inputs(n0, n1, true, K, focus_axis, seed):
    """V8 [n0, n1] with codes on the true extent only, a random int8 table
    YZ8 [n_contract, C + K] and float32 dequant scales."""
    rng = np.random.default_rng(seed)
    V8 = np.zeros((n0, n1), np.int8)
    t0, t1 = true
    V8[:t0, :t1] = np.where(rng.random((t0, t1)) < 0.15,
                            rng.integers(-5, 6, (t0, t1)), 0)
    C = K * (K + 1) // 2
    nc = (n1, n0)[focus_axis]
    YZ8 = rng.integers(-127, 128, (nc, C + K)).astype(np.int8)
    syz = rng.uniform(0.5, 2.0, C + K).astype(np.float32)
    sz = rng.uniform(0.5, 2.0, K).astype(np.float32)
    return V8, YZ8, syz, sz


@pytest.mark.parametrize("focus_axis", [0, 1])
@pytest.mark.parametrize("n0, n1, true", [(64, 256, (64, 256)),
                                          (48, 384, (37, 371))])
def test_fused_pair_plain_matches_pallas(interpret_pallas, focus_axis, n0,
                                         n1, true):
    """K8's plain version equals fused_pair_pallas (interpret mode, the s8
    flip_out kernels) bit for bit: raw int32 PM and BV, and the dq
    epilogue's Pt, PMm and BVf; on a zero-padded store the port writes the
    true focus extent."""
    K = 5
    C = K * (K + 1) // 2
    V8, YZ8, syz, sz = _contract_inputs(n0, n1, true, K, focus_axis,
                                        31 + focus_axis + n0)
    nf = true[focus_axis]
    jv, jyz, jz = (jnp.asarray(a) for a in (V8, YZ8, YZ8[:, C:]))
    PMj, BVj = fused_pair_pallas(jv, jyz, jz, focus_axis, flip_out=True)
    dqj = fused_pair_pallas(jv, jyz, jz, focus_axis, flip_out=True,
                            dq=(jnp.asarray(syz), jnp.asarray(sz)))
    tv, tyz = torch.from_numpy(V8), torch.from_numpy(YZ8.T.copy())
    before = fused_pair.fused_pair_plain.calls
    PM, BV = fused_pair.fused_pair_contract(tv, tyz, focus_axis, K, nf)
    assert PM.dtype == BV.dtype == torch.int32
    np.testing.assert_array_equal(PM.numpy(), np.asarray(PMj)[:, :nf])
    np.testing.assert_array_equal(BV.numpy(), np.asarray(BVj)[:, :nf])
    dq = fused_pair.fused_pair_plain(
        tv, tyz, focus_axis, K, nf,
        dq=(torch.from_numpy(syz), torch.from_numpy(sz)), chunk=7)
    for got, want in zip(dq, dqj):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:, :nf])
    assert fused_pair.fused_pair_plain.calls == before + 2


@pytest.mark.parametrize("focus_axis", [0, 1])
@pytest.mark.parametrize("n0, n1, true", [(64, 256, (64, 256)),
                                          (48, 384, (37, 371))])
def test_fused_pair_natural_matches_pallas(interpret_pallas, focus_axis, n0,
                                           n1, true):
    """K8b: the plain version's natural layout equals fused_pair_pallas
    (interpret mode, the s8 kernels without flip_out) bit for bit, raw
    int32 PM [n_focus, C + K] and BV [n_focus, K]; on a zero-padded store
    the port writes the true focus extent."""
    K = 5
    C = K * (K + 1) // 2
    V8, YZ8, _, _ = _contract_inputs(n0, n1, true, K, focus_axis,
                                     77 + focus_axis + n0)
    nf = true[focus_axis]
    PMj, BVj = fused_pair_pallas(jnp.asarray(V8), jnp.asarray(YZ8),
                                 jnp.asarray(YZ8[:, C:]), focus_axis)
    PM, BV = fused_pair.fused_pair_contract(
        torch.from_numpy(V8), torch.from_numpy(YZ8.T.copy()), focus_axis, K,
        nf, flip_out=False)
    assert PM.dtype == BV.dtype == torch.int32
    assert tuple(PM.shape) == (nf, C + K) and tuple(BV.shape) == (nf, K)
    np.testing.assert_array_equal(PM.numpy(), np.asarray(PMj)[:nf])
    np.testing.assert_array_equal(BV.numpy(), np.asarray(BVj)[:nf])
    with pytest.raises(ValueError, match="dq epilogue"):
        fused_pair.fused_pair_contract(
            torch.from_numpy(V8), torch.from_numpy(YZ8.T.copy()), focus_axis,
            K, nf, dq=(torch.ones(C + K), torch.ones(K)), flip_out=False)


FLOAT_TOL = {"float64": 1e-10, "float32": 1e-5, "bfloat16": 1e-5}


@pytest.mark.parametrize("flip_out", [True, False])
@pytest.mark.parametrize("focus_axis", [0, 1])
@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
def test_fused_pair_float_matches_pallas(interpret_pallas, dtype, focus_axis,
                                         flip_out):
    """K8c (flip_out) and K8d (natural): the plain version on a float
    table against fused_pair_pallas (interpret mode, the float kernels) on
    the same table, the mask and the codes cast to its type: float32 and
    bfloat16 to 1e-5 of the largest sum (the order of the float32 sums
    only: the bfloat16 table is rounded once, before both).  The TPU
    kernels give float32 sums for a float64 table too, so the float64 case
    is held to 1e-10 against a float64 numpy product and to float32
    rounding against the kernel."""
    K = 5
    C = K * (K + 1) // 2
    n0, n1, true = 48, 384, (37, 371)
    V8, _, _, _ = _contract_inputs(n0, n1, true, K, focus_axis,
                                   5 + focus_axis)
    rng = np.random.default_rng(12)
    nc = (n1, n0)[focus_axis]
    nf = true[focus_axis]
    YZ = rng.standard_normal((nc, C + K)).astype(
        np.float64 if dtype == "float64" else np.float32)
    jyz = jnp.asarray(YZ, dtype=jnp.dtype(dtype))
    tyz = torch.from_numpy(YZ).to(getattr(torch, dtype))
    np.testing.assert_array_equal(np.asarray(jyz.astype(jnp.float32)),
                                  tyz.float().numpy())
    want = fused_pair_pallas(jnp.asarray(V8), jyz, jyz[:, C:], focus_axis,
                             flip_out=flip_out)
    before = fused_pair.fused_pair_plain.calls
    got = fused_pair.fused_pair_contract(
        torch.from_numpy(V8), tyz.mT.contiguous(), focus_axis, K, nf,
        flip_out=flip_out)
    assert fused_pair.fused_pair_plain.calls == before + 1
    Vf = (V8 if focus_axis == 0 else V8.T).astype(np.float64)
    table = tyz.double().numpy()
    exact = ((Vf != 0) @ table, Vf @ table[:, C:])
    for g, w, e in zip(got, want, exact):
        assert g.dtype == (torch.float64 if dtype == "float64"
                           else torch.float32)
        w = np.asarray(w, np.float64)
        g = g.double().numpy()
        if flip_out:
            g, w = g.T, w.T
        assert g.shape == (nf, e.shape[1])
        top = np.abs(e).max()
        np.testing.assert_allclose(g, e[:nf], rtol=0,
                                   atol=FLOAT_TOL[dtype] * top)
        np.testing.assert_allclose(
            g, w[:nf], rtol=0,
            atol=(1e-6 if dtype == "float64" else FLOAT_TOL[dtype]) * top)


# (stored focus extent, contraction extent, true focus, true contraction, K):
# the shapes at which tests/test_torch_gpu.py holds K8a/K8b's ring to this
# plain version
RING_EDGES = {
    "contraction 16": (64, 16, 64, 16, 5),
    "one step short of a stage": (48, 112, 41, 100, 5),
    "focus below the stored extent": (272, 64, 129, 60, 8),
    "K = 96": (32, 64, 30, 60, 96),
    "codes at the int8 bound": (16, 126_464, 16, 126_464, 8),
}


@pytest.mark.parametrize("focus_axis", [0, 1])
@pytest.mark.parametrize("case", sorted(RING_EDGES))
def test_fused_pair_plain_exact_at_ring_edges(focus_axis, case):
    """The int8 plain version, the GPU kernels' reference, equals int64
    numpy sums at the ring's edge shapes, raw and natural, and its dq
    epilogue is one float32 conversion and multiply of them; at the int8
    bound (every cell +-127, ``fused_int8_ok`` true) BV[0, 0] reaches
    127^2 * 126,464 = 2,039,737,856 without wrapping."""
    nfs, nc, tf, tc, K = RING_EDGES[case]
    C = K * (K + 1) // 2
    rng = np.random.default_rng(len(case) + focus_axis)
    bound = case == "codes at the int8 bound"
    if bound:
        vf = np.where(rng.random((tf, tc)) < 0.5, -127, 127)
    else:
        vf = np.where(rng.random((tf, tc)) < 0.3,
                      rng.integers(-127, 128, (tf, tc)), 0)
    Vf = np.zeros((nfs, nc), np.int8)          # [focus, contraction]
    Vf[:tf, :tc] = vf
    V8 = Vf if focus_axis == 0 else Vf.T.copy()
    if bound:
        s0, s1 = (V8.shape[0], V8.shape[1])
        idx = np.stack(np.nonzero(np.ones((s0, s1), bool)), 1)
        assert tdg.fused_int8_ok(127, (s0, s1), idx,
                                 np.abs(V8.astype(np.int64)).ravel())
    YZ8T = rng.integers(-127, 128, (C + K, nc)).astype(np.int8)
    YZ8T[:, tc:] = 0
    if bound:
        YZ8T[C] = Vf[0]
    syz = rng.uniform(0.5, 2.0, C + K).astype(np.float32)
    sz = rng.uniform(0.5, 2.0, K).astype(np.float32)
    nf = tf
    m = (Vf[:nf] != 0).astype(np.int64)
    PMx = m @ YZ8T.T.astype(np.int64)
    BVx = Vf[:nf].astype(np.int64) @ YZ8T[C:].T.astype(np.int64)
    assert np.abs(PMx).max() < 2 ** 31 and np.abs(BVx).max() < 2 ** 31
    if bound:
        assert BVx[0, 0] == 127 * 127 * tc
    tv, tyz = torch.from_numpy(V8), torch.from_numpy(YZ8T)
    PM, BV = fused_pair.fused_pair_contract(tv, tyz, focus_axis, K, nf)
    np.testing.assert_array_equal(PM.numpy(), PMx.T)
    np.testing.assert_array_equal(BV.numpy(), BVx.T)
    PMn, BVn = fused_pair.fused_pair_contract(tv, tyz, focus_axis, K, nf,
                                              flip_out=False)
    np.testing.assert_array_equal(PMn.numpy(), PMx)
    np.testing.assert_array_equal(BVn.numpy(), BVx)
    Pt, PMm, BVf = fused_pair.fused_pair_contract(
        tv, tyz, focus_axis, K, nf,
        dq=(torch.from_numpy(syz), torch.from_numpy(sz)))
    PMf = PMx.T.astype(np.int32).astype(np.float32) * syz[:, None]
    np.testing.assert_array_equal(Pt.numpy(), PMf[:C])
    np.testing.assert_array_equal(PMm.numpy(), PMf[C:])
    np.testing.assert_array_equal(
        BVf.numpy(), BVx.T.astype(np.int32).astype(np.float32) * sz[:, None])


@pytest.mark.parametrize("focus_axis", [0, 1])
def test_fused_pair_contract_i8_takes_the_stored_extent(focus_axis):
    """fused_pair_contract_i8 takes a partner table as long as V8's
    contraction extent (``fused_quantize`` pads it there) and gives the
    plain version's sums; a shorter table raises instead of being padded."""
    K = 5
    V8, YZ8, _, _ = _contract_inputs(48, 384, (37, 371), K, focus_axis, 3)
    tv, tyz = torch.from_numpy(V8), torch.from_numpy(YZ8.T.copy())
    nf = (37, 371)[focus_axis]
    got = tdg.fused_pair_contract_i8(tv, tyz, focus_axis, K, nf)
    want = fused_pair.fused_pair_plain(tv, tyz, focus_axis, K, nf)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    true_c = (371, 37)[focus_axis]
    with pytest.raises(ValueError, match="contraction extent"):
        tdg.fused_pair_contract_i8(tv, tyz[:, :true_c].contiguous(),
                                   focus_axis, K, nf)


# ---------------------------------------------------------------------------
# one mode's contribution
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("focus_axis", [0, 1])
def test_fused_gram_contrib_matches_jax(interpret_pallas, xla_cpu_ridge,
                                        dtype, focus_axis):
    """fused_gram_contrib_i8 in the packed, transposed layout with the PD
    ridge and alpha, against the JAX package's as its engine calls it
    (compiled, Pallas kernels in interpret mode, a store padded to the
    kernel's blocks): float32 through the dq epilogue, float64 through the
    raw sums, the finish and the alpha multiply.  The int32 sums and the
    scales are equal, so float64 is bitwise, and so are float32's
    off-diagonal rows of P; in float32 XLA contracts the ridge add and b's
    two products and sum into fused multiply-adds, which round once where
    the port rounds twice (a few float32 ulps)."""
    rng = np.random.default_rng(67 + focus_axis)
    n0, n1, K = 58, 230, 5
    idx = _coo(rng, n0, n1, 900)
    vals = rng.integers(1, 6, 900).astype(np.float64)
    mean = float(vals.mean())
    s, m = tdg.fused_pair_encode(idx, vals, (n0, n1))
    V8j = np.zeros((64, 256), np.int8)
    V8j[:n0, :n1] = jdg.build_fused_values(idx, vals, (n0, n1), s, m)
    n_f, n_p = (n0, n1)[focus_axis], (n1, n0)[focus_axis]
    U = rng.standard_normal((n_p, K))
    if dtype == "float32":
        U = U.astype(np.float32)
    deg = np.zeros(V8j.shape[focus_axis], np.float32)
    deg[:n_f] = np.bincount(idx[:, focus_axis], minlength=n_f)
    alpha = 2.5
    jdt = jnp.dtype(dtype)
    Pj, bj = jax.jit(functools.partial(
        jdg.fused_gram_contrib_i8, focus_axis=focus_axis, out_dtype=jdt,
        scale=s, shift=m, mean=mean, packed=True, transposed=True,
        dims=(n0, n1), use_pallas=True, keep_pad=True))(
        jnp.asarray(V8j), jnp.asarray(U), ridge_deg=jnp.asarray(deg),
        alpha=jnp.asarray(alpha, jdt))
    Pj, bj = np.asarray(Pj)[:, :n_f], np.asarray(bj)[:, :n_f]
    store = tdg.build_fused_store(idx, vals, (n0, n1), s, m, "cpu")
    tdt = getattr(torch, dtype)
    Pt, bt_ = tdg.fused_gram_contrib_i8(
        store, tdg.tri_index(K, "cpu"), torch.from_numpy(U), focus_axis,
        torch.tensor(alpha, dtype=tdt), tdt, mean)
    assert Pt.dtype == bt_.dtype == tdt
    assert tuple(Pt.shape) == (K * (K + 1) // 2, n_f)
    if dtype == "float64":
        np.testing.assert_array_equal(Pt.numpy(), Pj)
        np.testing.assert_array_equal(bt_.numpy(), bj)
        return
    off = np.ones(len(Pt), bool)
    off[tdg.tri_index(K, "cpu")[2].numpy()] = False
    np.testing.assert_array_equal(Pt.numpy()[off], Pj[off])
    np.testing.assert_allclose(Pt.numpy(), Pj, rtol=1e-6)
    np.testing.assert_allclose(bt_.numpy(), bj, rtol=1e-6,
                               atol=1e-6 * np.abs(bj).max())


def _contrib_problem(focus_axis, dtype):
    """A small star-rated relation with its exact encoding, the JAX
    package's V8 padded to (64, 256), partner factors and ridge degrees
    over the padded focus extent."""
    rng = np.random.default_rng(67 + focus_axis)
    n0, n1, K = 58, 230, 5
    idx = _coo(rng, n0, n1, 900)
    vals = rng.integers(1, 6, 900).astype(np.float64)
    s, m = tdg.fused_pair_encode(idx, vals, (n0, n1))
    V8j = np.zeros((64, 256), np.int8)
    V8j[:n0, :n1] = jdg.build_fused_values(idx, vals, (n0, n1), s, m)
    n_f, n_p = (n0, n1)[focus_axis], (n1, n0)[focus_axis]
    U = rng.standard_normal((n_p, K)).astype(dtype)
    deg = np.zeros(V8j.shape[focus_axis], np.float32)
    deg[:n_f] = np.bincount(idx[:, focus_axis], minlength=n_f)
    store = tdg.build_fused_store(idx, vals, (n0, n1), s, m, "cpu")
    return dict(idx=idx, vals=vals, mean=float(vals.mean()), s=s, m=m,
                V8j=V8j, U=U, deg=deg, store=store, dims=(n0, n1), n_f=n_f,
                K=K)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("focus_axis", [0, 1])
def test_fused_gram_contrib_i8_unpacked_matches_jax(xla_cpu_ridge, dtype,
                                                    focus_axis):
    """fused_gram_contrib_i8 with ``packed=False`` (the K > 96 branch): the
    natural-layout int32 sums, the finish with the ridge on the diagonal
    columns and the expand to [n, K, K], against the JAX package's
    (compiled, its XLA contraction; the store padded past ``dims``).
    float64, with the alpha multiply after the finish, has P bitwise (the
    ridge included); float32, with alpha folded into the dequant scales, is
    bitwise off the diagonal.  b's two products and sum, and in float32 the
    ridge add, XLA contracts into fused multiply-adds, which round once
    where the port rounds twice: a few ulps."""
    p = _contrib_problem(focus_axis, dtype)
    K, n_f = p["K"], p["n_f"]
    alpha = 2.5
    jdt = jnp.dtype(dtype)
    Pj, bj = jax.jit(functools.partial(
        jdg.fused_gram_contrib_i8, focus_axis=focus_axis, out_dtype=jdt,
        scale=p["s"], shift=p["m"], mean=p["mean"], packed=False,
        dims=p["dims"], use_pallas=False))(
        jnp.asarray(p["V8j"]), jnp.asarray(p["U"]),
        ridge_deg=jnp.asarray(p["deg"]), alpha=jnp.asarray(alpha, jdt))
    Pj, bj = np.asarray(Pj), np.asarray(bj)
    tdt = getattr(torch, dtype)
    before = fused_pair.fused_pair_plain.calls
    Pt, bt_ = tdg.fused_gram_contrib_i8(
        p["store"], tdg.tri_index(K, "cpu"), torch.from_numpy(p["U"]),
        focus_axis, torch.tensor(alpha, dtype=tdt), tdt, p["mean"],
        packed=False)
    assert fused_pair.fused_pair_plain.calls == before + 1
    assert Pt.dtype == bt_.dtype == tdt
    assert tuple(Pt.shape) == (n_f, K, K) and tuple(bt_.shape) == (n_f, K)
    assert Pj.shape == (n_f, K, K)
    if dtype == "float64":
        np.testing.assert_array_equal(Pt.numpy(), Pj)
        np.testing.assert_allclose(bt_.numpy(), bj, rtol=1e-13,
                                   atol=1e-13 * np.abs(bj).max())
        return
    off = ~np.eye(K, dtype=bool)
    np.testing.assert_array_equal(Pt.numpy()[:, off], Pj[:, off])
    np.testing.assert_allclose(Pt.numpy(), Pj, rtol=1e-6)
    np.testing.assert_allclose(bt_.numpy(), bj, rtol=1e-6,
                               atol=1e-6 * np.abs(bj).max())


@pytest.mark.parametrize("layout", ["full", "packed", "transposed"])
@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
@pytest.mark.parametrize("focus_axis", [0, 1])
def test_fused_gram_contrib_float_matches_jax(focus_axis, dtype, layout):
    """fused_gram_contrib, the float contribution of a relation off the s8
    path, against the JAX package's (its XLA contraction; the store padded
    past ``dims``), in the three output layouts: the table built in the
    operand dtype (factors cast, then the triangle products rounded in
    it), no ridge and no alpha.  float64 to 1e-10, float32 and a bfloat16
    table (float32 sums and output) to 1e-5 of the largest entry: the
    order of the sums only, which needs the table rounded at the same two
    places."""
    out = "float64" if dtype == "float64" else "float32"
    p = _contrib_problem(focus_axis, out)
    K, n_f = p["K"], p["n_f"]
    packed, transposed = layout != "full", layout == "transposed"
    Pj, bj = jdg.fused_gram_contrib(
        jnp.asarray(p["V8j"]), jnp.asarray(p["U"]), focus_axis,
        jnp.dtype(out), jnp.dtype(dtype), p["s"], p["m"], p["mean"],
        packed=packed, transposed=transposed, dims=p["dims"])
    Pt, bt_ = tdg.fused_gram_contrib(
        p["store"], tdg.tri_index(K, "cpu"), torch.from_numpy(p["U"]),
        focus_axis, getattr(torch, out), getattr(torch, dtype), p["mean"],
        packed=packed, transposed=transposed)
    C = K * (K + 1) // 2
    want = {"full": ((n_f, K, K), (n_f, K)), "packed": ((n_f, C), (n_f, K)),
            "transposed": ((C, n_f), (K, n_f))}[layout]
    assert (tuple(Pt.shape), tuple(bt_.shape)) == want
    assert Pt.dtype == bt_.dtype == getattr(torch, out)
    for got, ref in ((Pt, Pj), (bt_, bj)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=FLOAT_TOL[dtype] * np.abs(ref).max())
    # the bfloat16 table is not the float32 one: its rounding shows
    if dtype == "bfloat16":
        P32, _ = tdg.fused_gram_contrib(
            p["store"], tdg.tri_index(K, "cpu"), torch.from_numpy(p["U"]),
            focus_axis, torch.float32, torch.float32, p["mean"],
            packed=packed, transposed=transposed)
        assert float((P32 - Pt).abs().max()) > 1e-3


@pytest.mark.parametrize("K, n, pad", [(6, 21, 32), (100, 40, 48)])
def test_quantize_table_t_matches_k7_plain(K, n, pad):
    """Above K7's K = 128 the table is quantized by torch ops in the
    transposed layout (``quantize_table_t``): the same codes and scales as
    K7's plain version gives at any K."""
    U = torch.from_numpy(np.random.default_rng(4 + K).standard_normal(
        (n, K)).astype(np.float32))
    want8, want_s = ytab.ytab_quantize(U, out_rows=pad)
    got8, got_s = tdg.quantize_table_t(U, pad, tdg.tri_index(K, "cpu"))
    assert got8.dtype == torch.int8 and got8.is_contiguous()
    assert torch.equal(got8, want8) and torch.equal(got_s, want_s)


# ---------------------------------------------------------------------------
# the Netflix-shaped generator
# ---------------------------------------------------------------------------

SMOKE = (4_800, 1_700, 1_000_000)


@pytest.fixture(scope="module")
def smoke_netflix():
    return netflix_synthetic(*SMOKE)


def test_netflix_synthetic_deterministic(smoke_netflix):
    again = netflix_synthetic(*SMOKE)
    np.testing.assert_array_equal(again.idx, smoke_netflix.idx)
    np.testing.assert_array_equal(again.vals, smoke_netflix.vals)
    other = netflix_synthetic(*SMOKE, seed=10)
    assert not np.array_equal(other.vals[:1000], smoke_netflix.vals[:1000])


def test_netflix_synthetic_cells_and_values(smoke_netflix):
    """Every cell at most once, stars 1..5, the smoke shape, and an exact
    fused encoding with no residual."""
    df = smoke_netflix
    assert df.shape == SMOKE[:2] and 0.9 * SMOKE[2] < df.nnz <= SMOKE[2]
    lin = df.idx[:, 0].astype(np.int64) * SMOKE[1] + df.idx[:, 1]
    assert np.unique(lin).size == df.nnz
    assert set(np.unique(df.vals)) == {1.0, 2.0, 3.0, 4.0, 5.0}
    s, m, keep = tdg.fused_pair_plan(df.idx, df.vals, df.shape)
    assert (s, m) == (1.0, 0) and keep.all()


@pytest.mark.parametrize("chunk", [None, 77_777])
def test_netflix_synthetic_chunks_equal_one_pass(smoke_netflix, chunk):
    """The chunked score gives the same bytes as one pass (and the default
    chunk, the fixture's)."""
    df = netflix_synthetic(*SMOKE, chunk=chunk)
    np.testing.assert_array_equal(df.idx, smoke_netflix.idx)
    np.testing.assert_array_equal(df.vals, smoke_netflix.vals)


def test_netflix_synthetic_equals_bench_sequence(smoke_netflix):
    """The port's generator gives the bytes of the JAX bench's own sequence
    (bench.py:353-370, replayed here as written: ``np.unique`` and one
    einsum over the whole gathers)."""
    n1, n2, nnz = SMOKE
    r = 32
    rng = np.random.default_rng(9)
    key = np.unique(rng.integers(0, n1 * n2, int(nnz * 1.02),
                                 dtype=np.int64))
    key = rng.permutation(key)[:nnz] if key.size > nnz else key
    nnz = key.size
    i1 = (key // n2).astype(np.int32)
    i2 = (key % n2).astype(np.int32)
    del key
    U = rng.standard_normal((n1, r), dtype=np.float32) / np.sqrt(r)
    V = rng.standard_normal((n2, r), dtype=np.float32) / np.sqrt(r)
    score = np.einsum("nk,nk->n", U[i1], V[i2])
    del U, V
    score = score * np.sqrt(r) * 0.9 + 0.55 * rng.standard_normal(
        nnz, dtype=np.float32)
    vals = np.clip(np.rint(3.6 + 1.1 * score), 1.0,
                   5.0).astype(np.float32)
    idx = np.stack([i1, i2], 1)
    assert smoke_netflix.idx.tobytes() == idx.tobytes()
    assert smoke_netflix.vals.tobytes() == vals.astype(np.float64).tobytes()


# an excerpt of the kernel library's build log (nvcc -Xptxas -v): two
# kernels, one with a C75xx note, as ptxas prints them
_PTXAS_LOG = """\
ptxas info    : (C7513) Potential Performance Loss: wgmma.mma_async \
instructions are serialized due to non wgmma instructions defining input \
registers of a wgmma between start and end of the pipeline stage in the \
function '_ZN4ring22fused_pair_bf16_kernelILi1ELb0EEEv'
ptxas info    : Compiling entry function \
'_ZN4ring22fused_pair_bf16_kernelILi1ELb0EEEv' for 'sm_90a'
ptxas info    : Function properties for \
_ZN4ring22fused_pair_bf16_kernelILi1ELb0EEEv
    88 bytes stack frame, 88 bytes spill stores, 152 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers, 88 bytes cumulative \
stack size
ptxas info    : Compiling entry function \
'_ZN4ring22fused_pair_bf16_kernelILi0ELb0EEEv' for 'sm_90a'
ptxas info    : Function properties for \
_ZN4ring22fused_pair_bf16_kernelILi0ELb0EEEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers
"""


@pytest.mark.parametrize("focus", [0, 1])
def test_ptxas_lines_pick_one_kernel(focus):
    """``kernels.ptxas_lines``, which chip_smoke.py prints beside K8c/K8d:
    one kernel's registers and spills, and its C75xx note if it has one,
    none of the other kernel's."""
    from bayesiandatafusion_jl_tpu_torch import kernels
    lines = kernels.ptxas_lines(
        _PTXAS_LOG, f"fused_pair_bf16_kernelILi{focus}ELb0E")
    spill = ("88 bytes spill stores" if focus else "0 bytes spill stores")
    assert [ln for ln in lines if "spill" in ln] == [
        f"{88 if focus else 0} bytes stack frame, {spill}, "
        f"{152 if focus else 0} bytes spill loads"]
    assert sum("Used 168 registers" in ln for ln in lines) == 1
    assert sum("C7513" in ln for ln in lines) == focus
    assert len(lines) == 2 + focus
