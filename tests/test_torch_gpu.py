"""Tests of the port that need a CUDA card (marker ``gpu``; they skip
without one).  This file imports neither jax nor the JAX package, so on the
GPU host it runs without the JAX test setup:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

import bayesiandatafusion_jl_tpu_torch as bt
from bayesiandatafusion_jl_tpu_torch.models.datasets import synthetic_ratings
from bayesiandatafusion_jl_tpu_torch.ops import (chol_blocked, chol_full,
                                                 chol_packed, dense_gram,
                                                 fused_pair, pair_contract,
                                                 ytab)
from bayesiandatafusion_jl_tpu_torch.utils.convert import (state_from_numpy,
                                                           state_to_numpy)
from bayesiandatafusion_jl_tpu_torch.utils.rng import draw_all_numpy
from _torch_gather_bucket import NETFLIX_LADDER, gather_bucket
from _torch_xla_order import xla_cpu_ridge_step

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# K1's and K3's edges: K = 1, 2 (one or two rows of the half-warp's 16
# lanes), 17 (the first row past the lanes' first rows), 31, 32; B = 1, one
# more than a block's 8 rows, a partial last block, the ML-10M user count
_REG_EDGES = [(K, B) for K in (1, 2, 17, 31, 32)
              for B in (1, 9, 1_003, 71_567)]
# K2's and K4's panel edges: K = 33 and 40 (padded to two panels), 63, 64,
# 65 (the first K of three panels), 95, 96; B as above (one K2 group is 8
# rows in float32, 4 in float64)
_SLAB_EDGES = [(K, B) for K in (33, 40, 63, 64, 65, 95, 96)
               for B in (1, 9, 1_003, 71_567)]


@pytest.mark.parametrize("K, B", [(32, 10_681), (8, 1_000), (40, 1_000),
                                  (64, 10_681), (96, 4_000)] + _REG_EDGES
                         + _SLAB_EDGES)
def test_chol_kernel_matches_plain(cuda, K, B):
    """The packed sampler's kernel for K (K1 up to 32, K2 above) against
    its plain version (the check chip_smoke.py runs), on a strided [C, B]
    view, float32 and float64."""
    import chip_smoke
    r = chip_smoke.check_chol_kernel(K, B, timing=False)
    assert r["ok"], r


@pytest.mark.parametrize("lam", [True, False])
@pytest.mark.parametrize("K, B", [(32, 10_681), (8, 1_000), (64, 10_681),
                                  (96, 4_000), (40, 1_000), (33, 77)]
                         + _REG_EDGES + _SLAB_EDGES)
def test_full_kernel_matches_plain(cuda, K, B, lam):
    """The gather path's full-P sampler kernel for K (K3 up to 32, K4
    above), with and without Lambda, against its plain version."""
    import chip_smoke
    r = chip_smoke.check_full_kernel(K, B, lam=lam, timing=False)
    assert r["ok"], r


# K5's edges: K = 1, 17, 31, 32 (one panel), 33, 40, 63, 64 (two); B as
# above (a block is 8 float32 or 4 float64 panels)
_INV_EDGES = [(K, B) for K in (1, 17, 31, 32, 33, 40, 63, 64)
              for B in (1, 9, 1_003, 71_567)]


@pytest.mark.parametrize("K, B", [(64, 10_681), (64, 1_000), (20, 333)]
                         + _INV_EDGES)
def test_chol_inv_kernel_matches_plain(cuda, K, B):
    """K5 against its plain version, float32 and float64, W exactly zero
    above the diagonal."""
    import chip_smoke
    r = chip_smoke.check_chol_inv(K, B, timing=False)
    assert r["ok"], r


@pytest.mark.parametrize("K, B, ld", [(64, 1_003, 128), (64, 71_567, 128),
                                      (33, 1_003, 128), (17, 9, 40)])
def test_chol_inv_kernel_reads_a_panel_in_place(cuda, K, B, ld):
    """K5 on the panel view P[:, :K, :K] of a contiguous [B, ld, ld]."""
    import chip_smoke
    r = chip_smoke.check_chol_inv(K, B, timing=False, ld=ld)
    assert r["ok"], r


def test_chol_inv_kernel_raises_on_layouts_it_cannot_read(cuda):
    """No fallback: a P whose rows are not of unit stride, or overlap,
    raises; no plain call runs."""
    P = torch.eye(8, dtype=torch.float32, device="cuda").expand(3, 8, 8)
    before = (chol_blocked.chol_inv.launches,
              chol_blocked.chol_inv_plain.calls)
    with pytest.raises(ValueError):
        chol_blocked.chol_inv(P.mT.contiguous().mT)      # column-major
    with pytest.raises(ValueError):
        chol_blocked.chol_inv(torch.eye(16, device="cuda").as_strided(
            (3, 8, 8), (64, 4, 1)))                      # rows overlap
    assert (chol_blocked.chol_inv.launches,
            chol_blocked.chol_inv_plain.calls) == before
    W = chol_blocked.chol_inv(P)                         # batch stride 0
    assert torch.equal(W, P)


@pytest.mark.parametrize("K, B", [(128, 4_000), (100, 1_000), (97, 1_003),
                                  (128, 9)])
def test_blocked_sampler_matches_plain(cuda, K, B):
    """The blocked sampler on K5 against chol_sample on torch.linalg."""
    import chip_smoke
    r = chip_smoke.check_blocked(K, B, timing=False)
    assert r["ok"], r


# K7's edges: K = 1, either side of a 32-column warp row and of a 4-column
# quad (31, 32, 33, 63, 64, 65, 127), the packed samplers' limit (96, 97)
# and the largest (128); n = 1, a few rows, ML-10M's entity counts
_YTAB_EDGES = [(n, K, None) for K in (1, 31, 32, 33, 63, 64, 65, 96, 97,
                                       127, 128)
               for n in (1, 500, 10_681, 71_567)]


@pytest.mark.parametrize("n, K, n_valid", [(17_770, 32, None),
                                            (1_001, 36, 900), (333, 8, None),
                                            (4_000, 96, 3_999),
                                            (71_567, 64, None),
                                            (71_567, 128, 70_001),
                                            (500, 128, 1)] + _YTAB_EDGES)
def test_ytab_kernel_matches_plain(cuda, n, K, n_valid):
    """K7 against its plain version, codes and scales bit for bit."""
    import chip_smoke
    r = chip_smoke.check_ytab(n, K, n_valid, timing=False)
    assert r["ok"], r


@pytest.mark.parametrize("n, K, n_valid, seed", [
    (500, 1, None, 0), (2_000, 8, 1_900, 1), (10_681, 32, None, 2),
    (17_770, 33, 17_000, 3), (10_681, 64, None, 4), (4_001, 97, 4_000, 5),
    (71_567, 128, 70_001, 6), (1_000, 128, None, 7)])
def test_ytab_kernel_matches_plain_adversarial(cuda, n, K, n_valid, seed):
    """K7 against its plain version on ``chip_smoke.adversarial_factors``:
    quotients T / s on the half-integers and up to two ulps either side,
    at the +-127 clip edge and (rows past n_valid) beyond it, column
    scales from the FLT_MIN floor to 2^60, all-zero columns; codes and
    scales bit for bit."""
    import chip_smoke
    r = chip_smoke.check_ytab(n, K, n_valid, timing=False, seed=seed,
                              adversarial=True)
    assert r["ok"], r


# The int8 ring's edges (csrc/fused_pair_i8.cu: 128-byte stages, 4 of
# them, 128-row focus tiles, 256-column tiles of 64-column chunks): a
# contraction of 16 bytes (mode 0 of the first, mode 1 of the second), one
# 16-byte step short of a stage, two full rings; the value columns start
# inside a column tile (K = 8 at column 64, K = 32 at 576, K = 96 at
# 4,800; K = 96 is the largest K8a); focus extents below the stored ones;
# a long contraction over few focus tiles, fewer tiles than SMs (mode 1 of
# the first, mode 0 of the second).
RING_EDGES = [((300, 16), 8), ((16, 300), 8), ((1_000, 112), 32),
              ((112, 1_000), 32), ((1_024, 1_024), 96), ((1_000, 777), 8),
              ((4_096, 300), 32), ((300, 4_096), 32)]


@pytest.mark.parametrize("focus", [0, 1])
@pytest.mark.parametrize("true, K", [((1_000, 777), 32), ((300, 2_000), 8),
                                     ((129, 257), 36), ((64, 48), 64),
                                     ((2_048, 640), 96)] + RING_EDGES)
def test_fused_pair_kernel_matches_plain(cuda, true, K, focus):
    """K8 against its plain version on ragged stores, raw int32 and the
    dq epilogue, bit for bit, at the int8 ring's edges too."""
    import chip_smoke
    V8 = chip_smoke.random_store(true, seed=K)
    r = chip_smoke.check_fused_pair(V8, true, K, focus, timing=False)
    assert r["ok"], r


VARIANT_TABLES = [("int8", False), ("bfloat16", True), ("bfloat16", False),
                  ("float32", True), ("float32", False), ("float64", True),
                  ("float64", False)]
VARIANT_STORES = [((1_000, 777), 32), ((300, 2_000), 8), ((129, 257), 36),
                  ((640, 2_048), 100), ((2_048, 640), 128)]


@pytest.mark.parametrize("focus", [0, 1])
@pytest.mark.parametrize("true, K, table, flip_out", [
    (true, K, table, flip) for true, K in VARIANT_STORES
    for table, flip in VARIANT_TABLES] + [
    (true, K, table, flip) for true, K in RING_EDGES + [
        ((1_024, 1_024), 128), ((300, 16), 100)]
    for table, flip in (("int8", False), ("bfloat16", True),
                        ("bfloat16", False))])
def test_fused_pair_variants_match_plain(cuda, true, K, table, flip_out,
                                         focus):
    """K8b (int8 table, natural layout) bit for bit against its plain
    version; K8c (float table, flip_out) and K8d (natural) within
    chip_smoke.FLOAT_TOL of the largest sum against the plain version on
    the same table in float64 (the rounding of the float32 sums); on
    ragged stores, up to K = 128, and for K8b, K8c and K8d in bfloat16 at
    the rings' edges too (both rings take 128-element stages, 4 of them,
    and 128-row focus tiles)."""
    import chip_smoke
    V8 = chip_smoke.random_store(true, seed=K)
    r = chip_smoke.check_fused_variant(V8, true, K, focus, table, flip_out,
                                       timing=False)
    assert r["ok"], r


@pytest.mark.parametrize("focus", [0, 1])
@pytest.mark.parametrize("epilogue", ["raw", "dq", "natural"])
def test_fused_pair_int8_at_its_bound(cuda, focus, epilogue):
    """K8a/K8b at fused_int8_ok's bound: a fully observed [126464, 16]
    store of codes +-127 (every fiber of mode 1 at 127 * 126,464 = 16.06M
    absolute code mass) against a table of +-127 codes whose first value
    row matches the signs of focus column 0, so BV[0, 0] is 127^2 *
    126,464 = 2,039,737,856, within 0.02% of the bound.  Bit for bit
    against the plain version, raw, dq and natural; n_focus one past a
    128-row tile in mode 0."""
    K = 8
    C = K * (K + 1) // 2
    n0, n1 = 126_464, 16
    rng = np.random.default_rng(11)
    v = np.where(rng.random((n0, n1)) < 0.5, -127, 127).astype(np.int8)
    idx = np.stack(np.nonzero(np.ones((n0, n1), bool)), 1)
    assert dense_gram.fused_int8_ok(127, (n0, n1), idx,
                                    np.abs(v.astype(np.int64)).ravel())
    n_contract = (n1, n0)[focus]
    yz = np.where(rng.random((C + K, n_contract)) < 0.5, -127,
                  127).astype(np.int8)
    yz[C] = v[0] if focus == 0 else v[:, 0]
    V8 = torch.from_numpy(v).to(cuda)
    YZT = torch.from_numpy(yz).to(cuda)
    nf = (129, n1)[focus]
    dq = (torch.from_numpy(rng.random(C + K, np.float32) + 0.5).to(cuda),
          torch.from_numpy(rng.random(K, np.float32) + 0.5).to(cuda))
    kw = {"raw": {}, "dq": {"dq": dq}, "natural": {"flip_out": False}}
    got = fused_pair.fused_pair_contract(V8, YZT, focus, K, nf,
                                         **kw[epilogue])
    want = fused_pair.fused_pair_plain(V8, YZT, focus, K, nf, **kw[epilogue])
    torch.cuda.synchronize()
    if epilogue != "dq":
        assert int(want[1][0, 0]) == 127 * 127 * n_contract
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("flip_out", [True, False])
def test_fused_pair_bf16_promotion(cuda, flip_out):
    """K8c/K8d's float32 sums over a long one-sign contraction: a fully
    observed [131072, 16] store of codes 1..127 in mode 1 against a
    positive bfloat16 table, so every sum has 131,072 terms of one sign.
    One wgmma chain over them truncates low by ~1e-3 of the largest sum;
    the kernel's partial sums, promoted into float32 totals every 1,024
    elements, stay within chip_smoke.FLOAT_TOL of the float64 sums."""
    import chip_smoke
    K = 8
    C = K * (K + 1) // 2
    n0, n1 = 131_072, 16
    rng = np.random.default_rng(12)
    V8 = torch.from_numpy(rng.integers(1, 128, (n0, n1), dtype=np.int8)).to(
        cuda)
    u = rng.standard_normal((C + K, n0)).astype(np.float32)
    YZT = torch.from_numpy(u * u).to(cuda).to(torch.bfloat16)
    got = fused_pair.fused_pair_contract(V8, YZT, 1, K, n1,
                                         flip_out=flip_out)
    want = fused_pair.fused_pair_plain(V8, YZT.double(), 1, K, n1,
                                       flip_out=flip_out)
    torch.cuda.synchronize()
    big = max(b.abs().max().item() for b in want)
    err = max((a.double() - b).abs().max().item() for a, b in zip(got, want))
    assert all(bool(torch.isfinite(a).all()) for a in got)
    assert err <= chip_smoke.FLOAT_TOL["bfloat16"] * big, (err, big)


# K8c/K8d with a float32 table (its three bfloat16 pieces on the ring,
# one 64-column chunk a tile): stores whose extents are multiples of 16
# but not of 64 or 128 (a partial last focus tile, contraction stage and
# chunk), K = 1 and 3 (one chunk of mask and one of values), 32 (nine mask
# chunks, a ragged one) and 100 (80 mask chunks, two value chunks)
F32_STORES = [(330, 200), (200, 1_035)]


@pytest.mark.parametrize("flip_out", [True, False])
@pytest.mark.parametrize("focus", [0, 1])
@pytest.mark.parametrize("K", [1, 3, 32, 100])
@pytest.mark.parametrize("true", F32_STORES)
def test_fused_pair_f32_matches_plain(cuda, true, K, focus, flip_out):
    """A float32 table launches the split and the three-piece ring once
    each, and the sums are within chip_smoke.FLOAT_TOL["float32"] of the
    largest float64 sum of the same table, in both modes and layouts."""
    import chip_smoke
    V8 = chip_smoke.random_store(true, seed=K + 7)
    assert all(d % 16 == 0 and d % 64 for d in V8.shape)
    contract = fused_pair.fused_pair_contract
    layouts = (("launches_f_flip", "launches_f32_flip") if flip_out
               else ("launches_f_nat", "launches_f32_nat"))

    def counts():
        return (fused_pair.split_f32.launches,
                *(getattr(contract, a) for a in layouts))
    before = counts()
    r = chip_smoke.check_fused_variant(V8, true, K, focus, "float32",
                                       flip_out, timing=False)
    assert r["ok"], r
    assert tuple(a - b for a, b in zip(counts(), before)) == (1, 1, 1)


@pytest.mark.parametrize("flip_out", [True, False])
def test_fused_pair_f32_one_sign_netflix_length(cuda, flip_out):
    """The three-piece ring's float32 sums over Netflix's 480,189-element
    contraction with every term of one sign (codes 1..127 in mode 1 of a
    [480192, 16] store, the last 3 rows unobserved, against a positive
    float32 table): truncation in the accumulator would bias them low;
    they stay within chip_smoke.FLOAT_TOL["float32"] of the largest
    float64 sum."""
    import chip_smoke
    K = 8
    C = K * (K + 1) // 2
    n0, n1, true0 = 480_192, 16, 480_189
    rng = np.random.default_rng(13)
    v = rng.integers(1, 128, (n0, n1), dtype=np.int8)
    v[true0:] = 0
    V8 = torch.from_numpy(v).to(cuda)
    u = rng.standard_normal((C + K, n0)).astype(np.float32)
    YZT = torch.from_numpy(u * u).to(cuda)
    got = fused_pair.fused_pair_contract(V8, YZT, 1, K, n1,
                                         flip_out=flip_out)
    want = fused_pair.fused_pair_plain(V8, YZT.double(), 1, K, n1,
                                       flip_out=flip_out)
    torch.cuda.synchronize()
    big = max(b.abs().max().item() for b in want)
    err = max((a.double() - b).abs().max().item() for a, b in zip(got, want))
    assert all(bool(torch.isfinite(a).all()) for a in got)
    assert err <= chip_smoke.FLOAT_TOL["float32"] * big, (err, big)


@pytest.mark.parametrize("flip_out", [True, False])
@pytest.mark.parametrize("focus", [0, 1])
def test_fused_pair_f64_runs_the_fma_kernel(cuda, focus, flip_out):
    """A float64 table still launches the float64 FMA kernel (the parity
    seam; no split, no ring) and gives float64 sums within
    chip_smoke.FLOAT_TOL["float64"] of the largest plain float64 sum."""
    import chip_smoke
    from torch.profiler import ProfilerActivity, profile
    true, K = (1_000, 777), 32
    V8 = chip_smoke.random_store(true, seed=5)
    contract = fused_pair.fused_pair_contract

    def f32_counts():
        return (fused_pair.split_f32.launches, contract.launches_f32_flip,
                contract.launches_f32_nat)
    before = f32_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        r = chip_smoke.check_fused_variant(V8, true, K, focus, "float64",
                                           flip_out, timing=False)
        torch.cuda.synchronize()
    assert r["ok"], r
    assert f32_counts() == before
    names = {e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA}
    assert any("fused_pair_fma_kernel<double" in n for n in names), names
    assert not any("f32x3" in n or "bf16_kernel" in n for n in names)


def test_split_f32_kernel_matches_plain(cuda):
    """The split kernel against its plain version bit for bit on random
    float32 bit patterns (|t| >= 2^-110 or 0), edge values and both
    signs; the pieces sum to the table exactly; a count of elements that
    is not a multiple of 4 is refused."""
    rng = np.random.default_rng(21)
    words = rng.integers(0, 2 ** 32, 1 << 20, dtype=np.uint64)
    t = words.astype(np.uint32).view(np.float32)
    t = t[np.isfinite(t) & ((np.abs(t) >= 2.0 ** -110) | (t == 0))]
    edges = np.float32([0.0, -0.0, 1.0, -1.0, np.finfo(np.float32).max,
                        -np.finfo(np.float32).max, 2.0 ** -110, np.pi])
    t = np.concatenate([edges, t])[:len(t) // 4 * 4]
    T = torch.from_numpy(t).to(cuda).view(-1, 4)
    before = fused_pair.split_f32.launches
    got = fused_pair.split_f32(T)
    want = fused_pair.split_f32_plain(T)
    torch.cuda.synchronize()
    assert fused_pair.split_f32.launches == before + 1
    assert got.shape == (3, *T.shape) and got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert torch.equal(got[2].double() + got[1].double() + got[0].double(),
                       T.double())
    with pytest.raises(ValueError, match="4k elements"):
        fused_pair.split_f32(T.reshape(-1)[:7])


# K6's column tiles (csrc/fused_pair_i8.cu: pairs of 64-column chunks, the
# mask chunks [0, C rounded up to 64) against M8, then the value chunks
# against W8): the mask pairs odd in number (one tile holds the last mask
# pair and the first value pair) with the last mask pair lone (K = 4, 8,
# 32, 33, 64, 96, 128) or full (K = 15, 160), or even (K = 16, 48, 100, no
# tile mixes the kinds); the value pairs one lone chunk (K <= 64), one full
# pair (K = 96, 100, 128), or a full pair and a lone chunk (K = 160)
PAIR_TILES = [((300, 200), 16), ((1_000, 480), 48), ((257, 1_000), 100),
              ((200, 300), 160), ((129, 4_096), 64)]


@pytest.mark.parametrize("focus", [0, 1])
@pytest.mark.parametrize("true, K", [((1_000, 777), 32), ((300, 2_000), 8),
                                     ((129, 257), 33), ((64, 48), 4),
                                     ((200, 300), 15), ((2_048, 640), 96),
                                     ((640, 2_048), 128)]
                         + PAIR_TILES + RING_EDGES)
def test_pair_contract_kernel_matches_plain(cuda, true, K, focus):
    """K6 against its plain version on ragged stores, raw int32 and the
    dq epilogue, bit for bit, up to K = 160: every kind of column tile
    and the ring's edges (K6 runs on K8a's ring)."""
    import chip_smoke
    pair = chip_smoke.random_pair(true, seed=K)
    r = chip_smoke.check_pair_contract(pair, K, focus, timing=False)
    assert r["ok"], r


@pytest.mark.parametrize("focus", [0, 1])
@pytest.mark.parametrize("epilogue", ["raw", "dq"])
def test_pair_contract_int8_at_its_bound(cuda, focus, epilogue):
    """K6 at int8_pair_ok's bound: a fully observed [133136, 16] pair (one
    count a cell, W8 codes +-127), so every fiber of mode 1 is 133,136
    long, just under 2^31 / 127^2 = 133,144.6, and int8_pair_ok still
    accepts it; the first value row of the table matches the signs of
    focus column 0, so BV[0, 0] is 127^2 * 133,136 = 2,147,350,544, within
    0.007% of 2^31.  Bit for bit against the plain version, raw and dq;
    n_focus one past a 128-row tile in mode 0."""
    K = 8
    C = K * (K + 1) // 2
    n0, n1 = 133_136, 16
    rng = np.random.default_rng(13)
    idx = np.stack(np.nonzero(np.ones((n0, n1), bool)), 1)
    assert dense_gram.int8_pair_ok(idx, (n0, n1))
    w = np.where(rng.random((n0, n1)) < 0.5, -127, 127).astype(np.int8)
    n_contract = (n1, n0)[focus]
    yz = rng.integers(-127, 128, (C + K, n_contract)).astype(np.int8)
    yz[C] = w[0] if focus == 0 else w[:, 0]
    M8 = torch.ones((n0, n1), dtype=torch.int8, device=cuda)
    W8 = torch.from_numpy(w).to(cuda)
    YZ8T = torch.from_numpy(yz).to(cuda)
    nf = (129, n1)[focus]
    dq = None if epilogue == "raw" else (
        torch.from_numpy(rng.random(C, np.float32) + 0.5).to(cuda),
        torch.from_numpy(rng.random(K, np.float32) + 0.5).to(cuda))
    got = pair_contract.pair_contract(M8, W8, YZ8T, focus, K, nf, dq=dq)
    want = pair_contract.pair_contract_plain(M8, W8, YZ8T, focus, K, nf,
                                             dq=dq)
    torch.cuda.synchronize()
    if epilogue == "raw":
        assert int(want[1][0, 0]) == 127 * 127 * n_contract
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_pair_contract_tensor_views(cuda):
    """K6 on the two 2-D views of an arity-3 int8 store (the tensor path's
    first step, ``chip_smoke.tensor_pair_views``): [(a, c), b] in mode 0
    with n_focus = 300 * 7 rows of the 304 * 7 stored, and [a, (c, b)] in
    mode 1, bit for bit against the plain version, raw and dq."""
    import chip_smoke
    rng = np.random.default_rng(14)
    shape = (300, 7, 200)
    cells = rng.choice(np.prod(shape), 30_000, replace=False)
    idx = np.stack(np.unravel_index(cells, shape), 1)
    vals = rng.standard_normal(len(idx)).astype(np.float32)
    pair = dense_gram.build_int8_pair(idx, vals, shape, np.float32, cuda)
    assert pair["M8"].shape == (304, 7, 208)
    for view, focus in chip_smoke.tensor_pair_views(pair):
        r = chip_smoke.check_pair_contract(view, 32, focus, timing=False)
        assert r["ok"], r
    assert r["shape"] == (300, 7 * 208)


def test_int8_contraction_exact(cuda):
    import chip_smoke
    assert all(chip_smoke.check_int8_contraction())


@pytest.mark.parametrize("K, kernel, per_sweep", [
    (8, chol_packed.chol_sample_packed, 2),
    (36, chol_packed.chol_sample_packed_tiled, 2),
    (100, chol_blocked.chol_inv, 4)])
def test_engine_cuda_matches_cpu(cuda, monkeypatch, K, kernel, per_sweep):
    """The int8 pair, three float64 sweeps with injected randoms on the
    card and on the CPU, through K1 (K=8), K2 (K=36) and K5 (K=100, two
    panels per entity).  On the card K6 contracts each mode (twice a
    sweep), K7 quantizes the table (at every K, up to 128), and neither
    K6's plain version nor ``torch._int_mm`` runs.  The int8 products are exact and
    the rest is float64 rounding, once the PD ridge's float32 mean is
    summed in one fixed order on both devices (torch's own sum rounds
    differently on each, which moves the chain by ~1e-9)."""
    monkeypatch.setattr(dense_gram, "ridge_step", xla_cpu_ridge_step)
    int_mm_calls = []
    int_mm = torch._int_mm

    def counting_int_mm(*a, **kw):
        int_mm_calls.append(a[0].device.type)
        return int_mm(*a, **kw)
    monkeypatch.setattr(torch, "_int_mm", counting_int_mm)
    df = synthetic_ratings(300, 200, 12_000, seed=3)
    engines = {}
    for dev in ("cpu", "cuda"):
        rd = bt.RelationData.from_indexed_df(df)
        rd.assign_to_test(0, 1_000, seed=7)
        cfg = bt.MacauConfig(num_latent=K, dtype="float64", verbose=False,
                             clamp=(1.0, 5.0), seed=4, dense_gram=True,
                             dense_int8=True)
        engines[dev] = bt.MacauEngine(rd, cfg, device=dev)
        assert engines[dev].problem.pair_i8s[0]
    st = engines["cpu"].init_state()
    states = {"cpu": st, "cuda": state_from_numpy(state_to_numpy(st), cuda,
                                                  torch.float64)}
    rng = np.random.default_rng(1)
    launches = (kernel.launches, pair_contract.pair_contract.launches,
                ytab.ytab_quantize.launches)
    plain = {}
    for s in range(3):
        randoms = draw_all_numpy(rng, engines["cpu"].problem.random_spec)
        for dev in ("cpu", "cuda"):
            r = {k: torch.from_numpy(v).to(dev) for k, v in randoms.items()}
            c0 = pair_contract.pair_contract_plain.calls
            states[dev], _ = engines[dev]._sweep_with_randoms(
                states[dev], r, 1.0)
            plain[dev] = pair_contract.pair_contract_plain.calls - c0
    assert (kernel.launches, pair_contract.pair_contract.launches,
            ytab.ytab_quantize.launches) == (
        launches[0] + 3 * per_sweep, launches[1] + 6,
        launches[2] + 6)
    assert plain == {"cpu": 2, "cuda": 0}
    assert "cuda" not in int_mm_calls
    a, b = state_to_numpy(states["cpu"]), state_to_numpy(states["cuda"])
    for ei in range(2):
        for key in ("U", "mu", "Lambda"):
            np.testing.assert_allclose(b["ent"][ei][key], a["ent"][ei][key],
                                       rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("K, kernel, per_sweep", [
    (8, chol_packed.chol_sample_packed, 2),
    (36, chol_packed.chol_sample_packed_tiled, 2),
    (100, chol_blocked.chol_inv, 4)])
def test_float_pair_engine_cuda_matches_cpu(cuda, K, kernel, per_sweep):
    """The float pair (``dense_gram=True``, ``dense_int8=False``), three
    float64 sweeps with injected randoms on the card and on the CPU: the
    products on ``torch.matmul`` in float64, the sampler through K1 (K=8), K2
    (K=36) or K5 (K=100, two panels per entity), no K6 and no K7; the
    chains agree to float64 rounding (the sums in another order)."""
    df = synthetic_ratings(300, 200, 12_000, seed=3)
    engines = {}
    for dev in ("cpu", "cuda"):
        rd = bt.RelationData.from_indexed_df(df)
        rd.assign_to_test(0, 1_000, seed=7)
        cfg = bt.MacauConfig(num_latent=K, dtype="float64", verbose=False,
                             clamp=(1.0, 5.0), seed=4, dense_gram=True)
        engines[dev] = bt.MacauEngine(rd, cfg, device=dev)
        assert not engines[dev].problem.pair_i8s[0]
        assert engines[dev].problem.stores[0]["M"].dtype == torch.float64
    st = engines["cpu"].init_state()
    states = {"cpu": st, "cuda": state_from_numpy(state_to_numpy(st), cuda,
                                                  torch.float64)}
    rng = np.random.default_rng(1)
    launches = kernel.launches
    counts = (pair_contract.pair_contract.launches,
              ytab.ytab_quantize.launches)
    for s in range(3):
        randoms = draw_all_numpy(rng, engines["cpu"].problem.random_spec)
        for dev in ("cpu", "cuda"):
            r = {k: torch.from_numpy(v).to(dev) for k, v in randoms.items()}
            states[dev], _ = engines[dev]._sweep_with_randoms(
                states[dev], r, 1.0)
    assert kernel.launches == launches + 3 * per_sweep
    assert (pair_contract.pair_contract.launches,
            ytab.ytab_quantize.launches) == counts
    a, b = state_to_numpy(states["cpu"]), state_to_numpy(states["cuda"])
    for ei in range(2):
        for key in ("U", "mu", "Lambda"):
            np.testing.assert_allclose(b["ent"][ei][key], a["ent"][ei][key],
                                       rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("store, K, packed", [
    ("bfloat16", 8, True), ("bfloat16", 36, True), ("bfloat16", 100, False),
    ("float32", 36, True)])
def test_float_pair_contrib_cuda_matches_cpu(cuda, monkeypatch, store, K,
                                             packed, mode):
    """The float pair's contribution in float32 from a bfloat16 store
    (``gram_dtype="bfloat16"``, widened to float32 a few focus rows at a
    time) or a float32 one, on the card and on the CPU: the same products
    summed in another order, 1e-5 of the largest sum."""
    monkeypatch.setattr(dense_gram, "_WIDEN_ELEMS", 4_000)
    df = synthetic_ratings(300, 200, 12_000, seed=3)
    centered = df.vals - df.vals.mean()
    partner = np.random.default_rng(K).standard_normal(
        (df.shape[1 - mode], K)).astype(np.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        pair = dense_gram.build_dense_pair(df.idx, centered, df.shape,
                                           getattr(torch, store), dev)
        out[dev] = dense_gram.float_pair_contrib(
            pair, dense_gram.tri_index(K, dev),
            [torch.from_numpy(partner).to(dev)], mode,
            torch.tensor(2.0, device=dev), torch.float32, packed=packed)
    for got, want in zip(out["cuda"], out["cpu"]):
        assert got.dtype == want.dtype == torch.float32
        assert got.shape == want.shape
        want = want.numpy()
        np.testing.assert_allclose(got.cpu().numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("K", [8, 36])
def test_fused_engine_cuda_matches_cpu(cuda, monkeypatch, K):
    """The fused path (dense_fused=True), three float64 sweeps with
    injected randoms on the card and on the CPU: K7 and K8 launch twice a
    sweep on the card and their plain versions run only for the CPU
    engine; the int32 sums are exact, so the chains agree to float64
    rounding (the ridge's float32 mean summed in one fixed order)."""
    monkeypatch.setattr(dense_gram, "ridge_step", xla_cpu_ridge_step)
    df = synthetic_ratings(300, 200, 12_000, seed=3)
    engines = {}
    for dev in ("cpu", "cuda"):
        rd = bt.RelationData.from_indexed_df(df)
        rd.assign_to_test(0, 1_000, seed=7)
        cfg = bt.MacauConfig(num_latent=K, dtype="float64", verbose=False,
                             clamp=(1.0, 5.0), seed=4, dense_fused=True,
                             dense_int8=True)
        engines[dev] = bt.MacauEngine(rd, cfg, device=dev)
        assert engines[dev].problem.kinds[0] == "fused"
    st = engines["cpu"].init_state()
    states = {"cpu": st, "cuda": state_from_numpy(state_to_numpy(st), cuda,
                                                  torch.float64)}
    rng = np.random.default_rng(1)
    counts = (ytab.ytab_quantize.launches,
              fused_pair.fused_pair_contract.launches,
              ytab.ytab_quantize_plain.calls,
              fused_pair.fused_pair_plain.calls)
    for s in range(3):
        randoms = draw_all_numpy(rng, engines["cpu"].problem.random_spec)
        for dev in ("cpu", "cuda"):
            r = {k: torch.from_numpy(v).to(dev) for k, v in randoms.items()}
            states[dev], _ = engines[dev]._sweep_with_randoms(
                states[dev], r, 1.0)
    assert (ytab.ytab_quantize.launches,
            fused_pair.fused_pair_contract.launches,
            ytab.ytab_quantize_plain.calls,
            fused_pair.fused_pair_plain.calls) == tuple(
        c + 6 for c in counts)
    a, b = state_to_numpy(states["cpu"]), state_to_numpy(states["cuda"])
    for ei in range(2):
        for key in ("U", "mu", "Lambda"):
            np.testing.assert_allclose(b["ent"][ei][key], a["ent"][ei][key],
                                       rtol=1e-9, atol=1e-9)


FUSED_CASES = {
    # name: (K, options, duplicates, fused_pair_contract's counter,
    #        K7 launches a sweep)
    "residual": (8, dict(), True, "launches_i8_flip", 2),
    "float": (8, dict(dense_int8=False), False, "launches_f_flip", 0),
    "float_slab": (36, dict(dense_int8=False), False, "launches_f_flip", 0),
    "k100": (100, dict(), False, "launches_i8_nat", 2),
    "k100_float": (100, dict(dense_int8=False), False, "launches_f_nat", 0),
    "k100_residual": (100, dict(), True, "launches_i8_nat", 2),
}


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_fused_variants_engine_cuda_matches_cpu(cuda, monkeypatch, case):
    """The rest of the fused path, three float64 sweeps with injected
    randoms on the card and on the CPU: a duplicate-cell residual (packed
    at K=8, through assemble_precision at K=100), the float kernels
    (``dense_int8=False``, a float64 table) and K=100 (the natural-layout
    kernels and the blocked sampler).  The card launches its K8 variant
    twice a sweep (and K7 on the s8 path) and runs no plain version;
    the chains agree to float64 rounding."""
    K, opts, dup, variant, k7 = FUSED_CASES[case]
    monkeypatch.setattr(dense_gram, "ridge_step", xla_cpu_ridge_step)
    df = synthetic_ratings(300, 200, 12_000, seed=3)
    if dup:
        df = bt.IndexedDF(np.concatenate([df.idx, df.idx[::40]]),
                          np.concatenate([df.vals, df.vals[::40][::-1]]),
                          df.shape)
    engines = {}
    for dev in ("cpu", "cuda"):
        rd = bt.RelationData.from_indexed_df(df)
        rd.assign_to_test(0, 1_000, seed=7)
        cfg = bt.MacauConfig(num_latent=K, dtype="float64", verbose=False,
                             clamp=(1.0, 5.0), seed=4, dense_fused=True,
                             **{"dense_int8": True, **opts})
        engines[dev] = bt.MacauEngine(rd, cfg, device=dev)
        prob = engines[dev].problem
        assert prob.kinds[0] == "fused"
        assert prob.fused_i8s[0] == opts.get("dense_int8", True)
        assert (prob.residual_nnzs[0] > 0) == dup
    st = engines["cpu"].init_state()
    states = {"cpu": st, "cuda": state_from_numpy(state_to_numpy(st), cuda,
                                                  torch.float64)}
    rng = np.random.default_rng(1)
    contract = fused_pair.fused_pair_contract

    def counts():
        return (getattr(contract, variant), contract.launches,
                ytab.ytab_quantize.launches, ytab.ytab_quantize_plain.calls,
                fused_pair.fused_pair_plain.calls)
    plain = {}
    before = counts()
    for s in range(3):
        randoms = draw_all_numpy(rng, engines["cpu"].problem.random_spec)
        for dev in ("cpu", "cuda"):
            r = {k: torch.from_numpy(v).to(dev) for k, v in randoms.items()}
            c0 = counts()[3:]
            states[dev], _ = engines[dev]._sweep_with_randoms(
                states[dev], r, 1.0)
            plain[dev] = tuple(a - b for a, b in zip(counts()[3:], c0))
    assert plain["cuda"] == (0, 0)
    after = counts()
    assert tuple(a - b for a, b in zip(after[:3], before[:3])) == (
        6, 6, 3 * k7)
    a, b = state_to_numpy(states["cpu"]), state_to_numpy(states["cuda"])
    for ei in range(2):
        for key in ("U", "mu", "Lambda"):
            np.testing.assert_allclose(b["ent"][ei][key], a["ent"][ei][key],
                                       rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("K, accumulation, kernel", [
    (8, "segment", chol_full.chol_sample_full),
    (8, "planned", chol_full.chol_sample_full),
    (36, "segment", chol_full.chol_sample_full_tiled)])
def test_gather_engine_cuda_matches_cpu(cuda, K, accumulation, kernel):
    """The gather path (dense_gram=False, a narrow width ladder so that
    heavy users are chunked), three float64 sweeps with injected randoms
    on the card and on the CPU, through K3 (K=8) and K4 (K=36): two
    launches a sweep, and the chains agree to float64 rounding (the
    segment sums add in the same order on both, the products and the
    samplers round differently)."""
    df = synthetic_ratings(300, 200, 12_000, seed=3)
    engines = {}
    for dev in ("cpu", "cuda"):
        rd = bt.RelationData.from_indexed_df(df)
        rd.assign_to_test(0, 1_000, seed=7)
        cfg = bt.MacauConfig(num_latent=K, dtype="float64", verbose=False,
                             clamp=(1.0, 5.0), seed=4, dense_gram=False,
                             accumulation=accumulation,
                             bucket_widths=(8, 16, 32, 64))
        engines[dev] = bt.MacauEngine(rd, cfg, device=dev)
    st = engines["cpu"].init_state()
    states = {"cpu": st, "cuda": state_from_numpy(state_to_numpy(st), cuda,
                                                  torch.float64)}
    rng = np.random.default_rng(1)
    launches = kernel.launches
    for s in range(3):
        randoms = draw_all_numpy(rng, engines["cpu"].problem.random_spec)
        for dev in ("cpu", "cuda"):
            r = {k: torch.from_numpy(v).to(dev) for k, v in randoms.items()}
            states[dev], _ = engines[dev]._sweep_with_randoms(
                states[dev], r, 1.0)
    assert kernel.launches == launches + 6
    a, b = state_to_numpy(states["cpu"]), state_to_numpy(states["cuda"])
    for ei in range(2):
        for key in ("U", "mu", "Lambda"):
            np.testing.assert_allclose(b["ent"][ei][key], a["ent"][ei][key],
                                       rtol=1e-9, atol=1e-9)


def test_benchmark_on_cuda(cuda):
    df = synthetic_ratings(2_000, 1_500, 60_000, seed=2)
    rd = bt.RelationData.from_indexed_df(df)
    rd.assign_to_test(0, 5_000, seed=7)
    eng = bt.MacauEngine(rd, bt.MacauConfig(num_latent=16, burnin=5,
                                            psamples=0, clamp=(1, 5),
                                            verbose=False, dense_gram=True,
                                            dense_int8=True),
                         device="cuda")
    launches = pair_contract.pair_contract.launches
    out = eng.benchmark(5, repeats=2)
    assert pair_contract.pair_contract.launches == launches + 2 * 15
    assert all(np.isfinite(out["ms_per_sweep"]))
    assert 0.5 < out["metrics"]["r0.rmse_avg"] < 1.5


def test_gather_benchmark_on_default_device(cuda):
    """With no device argument the engine runs on the card: the gather
    path with a bfloat16 gather through benchmark()."""
    df = synthetic_ratings(2_000, 1_500, 60_000, seed=2)
    rd = bt.RelationData.from_indexed_df(df)
    rd.assign_to_test(0, 5_000, seed=7)
    launches = chol_full.chol_sample_full.launches
    eng = bt.MacauEngine(rd, bt.MacauConfig(
        num_latent=16, burnin=5, psamples=0, clamp=(1, 5), verbose=False,
        dense_gram=False, gram_dtype="bfloat16"))
    assert eng.device.type == "cuda"
    out = eng.benchmark(5, repeats=2)
    assert chol_full.chol_sample_full.launches == launches + 2 * 15
    assert all(np.isfinite(out["ms_per_sweep"]))
    assert 0.5 < out["metrics"]["r0.rmse_avg"] < 1.5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K", [8, 32, 64, 128, 36, 9])
@pytest.mark.parametrize("n_table, n_obs, hot, gap", [
    (1_000, 20_000, 5_000, 2), (130, 3_000, 0, 0), (5_000, 0, 0, 0)])
def test_windowed_expand_kernel_matches_plain(cuda, K, dtype, n_table, n_obs,
                                              hot, gap):
    """K9 against its plain version, bit for bit, on ragged plans: a table
    that is not a multiple of 128 rows, a hot window over several blocks,
    empty windows, a plan without observations; rows of 16, 8, 4 and 2
    bytes' multiples (K = 36 and 9 in bfloat16 take the narrower
    vectors)."""
    import chip_smoke
    part = chip_smoke.ragged_parts(n_table, n_obs, K, hot=hot, gap=gap)
    r = chip_smoke.check_windowed_expand(part, n_table, K, dtype,
                                         timing=False)
    assert r["ok"], r


def test_windowed_expand_raises(cuda):
    """The wrapper refuses what the kernel does not take, on the card,
    with no fallback."""
    from bayesiandatafusion_jl_tpu_torch.ops import gather_expand
    lanes = torch.zeros(1024, dtype=torch.int32, device=cuda)
    wmap = torch.zeros(1, dtype=torch.int32, device=cuda)
    for U, L in ((torch.zeros((10, 129), device=cuda), lanes),
                 (torch.zeros((10, 8), dtype=torch.float64, device=cuda),
                  lanes),
                 (torch.zeros((10, 8), device=cuda), lanes.long()),
                 (torch.zeros((10, 8), device=cuda), lanes[:512])):
        with pytest.raises(ValueError):
            gather_expand.windowed_expand(U, L, wmap)



# (K, arity) of the gather-Gramian kernel's checks: every K it takes, both
# arities
_GATHER_GRAM_KA = [(16, 2), (32, 2), (48, 2), (64, 2), (16, 3), (32, 3),
                   (64, 3)]


@pytest.mark.parametrize("W", NETFLIX_LADDER)
@pytest.mark.parametrize("K, arity", _GATHER_GRAM_KA)
def test_gather_gram_kernel_matches_plain(cuda, K, arity, W):
    """The gather-Gramian kernel against its plain version (on the CPU) at
    every width of the Netflix ladder, on full rows (chunked instances),
    partly filled rows and padding rows, with alpha 2.75, written into a
    slice of a larger buffer.

    Both sum the same exact products (bf16 values, their products exact in
    float32) in float32, in two orders: each lies within (W - 1) u sum|p|
    of the exact sum (u = 2^-24 rounding to nearest; the tensor cores'
    adds truncate, u = 2^-23), then one rounding of the alpha product
    each.  So |kernel - plain| <= alpha (3 W 2^-24 sum|p| + 2^-23 |P|),
    elementwise, sum|p| from the bf16 operands in float64.  P is symmetric
    bit for bit, and a second launch gives the same bits."""
    from bayesiandatafusion_jl_tpu_torch.ops import gramian
    rows = max(24, 120_000 // W)
    tables, parts, val, mask = gather_bucket(W, K, arity, rows, 1_000 * K + W)
    alpha = torch.tensor(2.75, device=cuda)
    Pp, bp = gramian.gather_gram_plain(tables, parts, val, mask, alpha=2.75)
    dev = [[t.to(cuda) for t in ts] for ts in (tables, parts)]
    P_cat = torch.full((rows + 8, K * K), float("nan"), device=cuda)
    b_cat = torch.full((rows + 8, K), float("nan"), device=cuda)
    out = (P_cat[4:4 + rows], b_cat[4:4 + rows])
    launches, calls = gramian.gather_gram.launches, \
        gramian.gather_gram_plain.calls
    gramian.gather_gram([t.to(torch.bfloat16) for t in dev[0]], dev[1],
                        val.to(cuda), mask.to(cuda), alpha=alpha, out=out)
    again = gramian.gather_gram([t.to(torch.bfloat16) for t in dev[0]],
                                dev[1], val.to(cuda), mask.to(cuda),
                                alpha=alpha)
    torch.cuda.synchronize()
    assert gramian.gather_gram.launches == launches + 2
    assert gramian.gather_gram_plain.calls == calls
    assert bool(P_cat[:4].isnan().all()) and bool(P_cat[-4:].isnan().all())
    P, b = out[0].view(rows, K, K), out[1]
    assert torch.equal(P, P.mT)
    assert torch.equal(P, again[0]) and torch.equal(b, again[1])
    z = tables[0].to(torch.bfloat16)[parts[0].long()]
    if arity == 3:
        z = z * tables[1].to(torch.bfloat16)[parts[1].long()]
    zm = (z * mask[..., None].to(torch.bfloat16)).double()
    v = val.to(torch.bfloat16).double()
    exact = zm.mT @ zm
    sum_p = zm.abs().mT @ zm.abs()
    sum_b = (zm.abs().mT @ v.abs()[..., None])[..., 0]
    u = 2.0 ** -24
    tol_P = 2.75 * (3 * W * u * sum_p + 2 * u * exact.abs())
    tol_b = 2.75 * (3 * W * u * sum_b
                    + 2 * u * (zm.mT @ v[..., None])[..., 0].abs())
    assert bool(((P.cpu().double() - Pp.double()).abs() <= tol_P).all())
    assert bool(((b.cpu().double() - bp.double()).abs() <= tol_b).all())


def test_gather_gram_raises(cuda):
    """The wrapper refuses what the kernel does not take, on the card,
    with no fallback."""
    from bayesiandatafusion_jl_tpu_torch.ops import gramian
    tables, parts, val, mask = gather_bucket(16, 32, 2, 10, 0)
    U = tables[0].to(cuda, torch.bfloat16)
    p, v, m = parts[0].to(cuda), val.to(cuda), mask.to(cuda)
    bad = [([U[:, :8].contiguous()], [p], v, m),          # K = 8
           ([U.float()], [p], v, m),                      # float32 table
           ([U], [p.long()], v, m),                       # int64 indices
           ([U], [p], v.double(), m),                     # float64 values
           ([U], [p[:, :8]], v, m),                       # shapes differ
           ([U], [p.mT.contiguous().mT], v, m),           # not contiguous
           ([U, U, U], [p, p, p], v, m),                  # arity 4
           ([U], [p, p], v, m)]                           # parts != tables
    for args in bad:
        with pytest.raises(ValueError):
            gramian.gather_gram(*args, alpha=1.0)


@pytest.mark.parametrize("W", [8, 160, 2048])
@pytest.mark.parametrize("K, arity", [(K, a) for K in (16, 32, 48, 64)
                                      for a in (2, 3)])
def test_gather_gram_dest_moves_the_rows(cuda, K, arity, W):
    """The kernel with a destination map: each output row the bits of the
    kernel's row without it, moved by ``index_copy_``; rows whose
    destination is outside the output stored nowhere, every other output
    row untouched."""
    from bayesiandatafusion_jl_tpu_torch.ops import gramian
    rows = max(24, 60_000 // W)
    tables, parts, val, mask = gather_bucket(W, K, arity, rows, 77 * K + W)
    args = ([t.to(cuda, torch.bfloat16) for t in tables],
            [p.to(cuda) for p in parts], val.to(cuda), mask.to(cuda))
    alpha = torch.tensor(1.25, device=cuda)
    P, b = gramian.gather_gram(*args, alpha=alpha)
    n_out = rows + 37
    g = torch.Generator().manual_seed(W)
    dest = torch.randperm(n_out, generator=g)[:rows].to(torch.int32)
    dest[::7] = -1
    dest[3] = n_out
    d = dest.to(cuda)
    out = (torch.full((n_out, K * K), -3.0, device=cuda),
           torch.full((n_out, K), -3.0, device=cuda))
    launches = gramian.gather_gram.launches
    gramian.gather_gram(*args, alpha=alpha, out=out, dest=d)
    torch.cuda.synchronize()
    assert gramian.gather_gram.launches == launches + 1
    keep = ((dest >= 0) & (dest < n_out)).to(cuda)
    want_P = torch.full_like(out[0], -3.0).index_copy_(
        0, d[keep].long(), P.reshape(rows, K * K)[keep])
    want_b = torch.full_like(out[1], -3.0).index_copy_(0, d[keep].long(),
                                                       b[keep])
    assert torch.equal(out[0].view(torch.int32), want_P.view(torch.int32))
    assert torch.equal(out[1].view(torch.int32), want_b.view(torch.int32))


def test_gather_gram_dest_past_32_bit_offsets(cuda):
    """Destinations whose offsets pass 2^31 floats (Netflix's rows x K*K
    at K = 64): the rows at the output's last index and near it carry the
    kernel's bits."""
    from bayesiandatafusion_jl_tpu_torch.ops import gramian
    K, rows, n_out = 64, 40, 530_000          # 2.17e9 floats of P
    tables, parts, val, mask = gather_bucket(32, K, 2, rows, 5)
    args = ([t.to(cuda, torch.bfloat16) for t in tables],
            [p.to(cuda) for p in parts], val.to(cuda), mask.to(cuda))
    P, b = gramian.gather_gram(*args, alpha=0.5)
    dest = torch.arange(n_out - rows, n_out, dtype=torch.int32,
                        device=cuda).flip(0)
    dest[1] = 0
    out = (torch.empty((n_out, K * K), device=cuda),
           torch.empty((n_out, K), device=cuda))
    gramian.gather_gram(*args, alpha=0.5, out=out, dest=dest)
    torch.cuda.synchronize()
    d = dest.long()
    assert torch.equal(out[0][d].view(torch.int32),
                       P.reshape(rows, K * K).view(torch.int32))
    assert torch.equal(out[1][d].view(torch.int32), b.view(torch.int32))
    del out


@pytest.mark.parametrize("K, gram_dtype", [(32, None), (128, "bfloat16"),
                                           (36, "bfloat16")])
def test_gather_gram_dest_torch_code_on_cuda(cuda, K, gram_dtype):
    """The torch code on the card (a float32 gather; K the kernel does not
    take) with a destination map: its rows, moved."""
    from bayesiandatafusion_jl_tpu_torch.ops import gramian
    rows = 40
    tables, parts, val, mask = gather_bucket(24, K, 2, rows, K)
    gd = getattr(torch, gram_dtype) if gram_dtype else None
    args = ([t.to(cuda) for t in tables], [p.to(cuda) for p in parts],
            val.to(cuda), mask.to(cuda))
    P, b = gramian.bucket_gramian(*args, gram_dtype=gd, alpha=2.0)
    n_out = 64
    dest = torch.randperm(n_out, device=cuda)[:rows].to(torch.int32)
    out = (torch.full((n_out, K * K), -3.0, device=cuda),
           torch.full((n_out, K), -3.0, device=cuda))
    launches = gramian.gather_gram.launches
    gramian.bucket_gramian(*args, gram_dtype=gd, alpha=2.0, out=out,
                           dest=dest)
    assert gramian.gather_gram.launches == launches
    d = dest.long()
    assert torch.equal(out[0][d].view(torch.int32),
                       P.reshape(rows, K * K).view(torch.int32))
    assert torch.equal(out[1][d].view(torch.int32), b.view(torch.int32))
    rest = torch.ones(n_out, dtype=torch.bool, device=cuda)
    rest[d] = False
    assert bool((out[0][rest] == -3.0).all())


def test_gather_gram_dest_engine_chain(cuda):
    """A bf16 gather engine on the card ("segment"): every bucket through
    the kernel into its map's destinations, the same bits twice; one sweep
    from the chain's end with the same randoms under "planned" (Lambda in
    P, through the same maps) ends within float32 rounding of the sums'
    order."""
    from bayesiandatafusion_jl_tpu_torch.utils import spans
    rd = bt.RelationData.from_indexed_df(
        synthetic_ratings(2_000, 1_500, 60_000, seed=2))
    rd.assign_to_test(0, 5_000, seed=7)

    def engine(accumulation):
        return bt.MacauEngine(rd, bt.MacauConfig(
            num_latent=32, burnin=4, psamples=4, verbose=False,
            dense_gram=False, gram_dtype="bfloat16", accumulation=accumulation,
            bucket_widths=(8, 12, 16, 32, 64)), device="cuda")
    eng = engine("segment")
    prob = eng.problem
    assert sorted(prob.dest_maps) == ["e0", "e1"]
    R = sum(len(ba["inst"]) for v in prob.layouts.values() for ba in v)
    n_buckets = sum(len(v) for v in prob.layouts.values())
    with spans.recording() as rec:
        a = eng.run()
    b = eng.run()
    c = rec.counters
    assert c["gather_gram.launches"] == 8 * n_buckets
    assert c["gather_gram_plain.calls"] == 0
    assert (c["assemble_precision.direct_rows"]
            + c["assemble_precision.overflow_rows"]) == 8 * R
    assert c["assemble_precision.overflow_rows"] > 0
    for x, y in zip(a["state"]["ent"], b["state"]["ent"]):
        assert torch.equal(x["U"], y["U"])
    randoms = eng.draw(9)
    seg, _ = eng._sweep_with_randoms(a["state"], randoms, 0.0)
    planned = engine("planned")
    assert sorted(planned.problem.dest_maps) == ["e0", "e1"]
    pl, _ = planned._sweep_with_randoms(a["state"], randoms, 0.0)
    for x, y in zip(pl["ent"], seg["ent"]):
        scale = float(y["U"].abs().max())
        assert float((x["U"] - y["U"]).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("graph, K", [("matrix", 32), ("tensor", 16)])
def test_gather_engine_bf16_runs_the_kernel(cuda, graph, K):
    """A small bf16 gather engine on the card (dense_gram=False, a narrow
    ladder so that heavy rows are chunked; a matrix at K = 32 and a 3-way
    tensor at K = 16): every bucket of every sweep through the
    gather-Gramian kernel, none through its plain version, and the chain
    sane."""
    from bayesiandatafusion_jl_tpu_torch.ops import gramian
    if graph == "matrix":
        rd = bt.RelationData.from_indexed_df(
            synthetic_ratings(2_000, 1_500, 60_000, seed=2))
        rd.assign_to_test(0, 5_000, seed=7)
    else:
        rd = _tensor_graph()
    eng = bt.MacauEngine(rd, bt.MacauConfig(
        num_latent=K, burnin=4, psamples=4, verbose=False,
        dense_gram=False, gram_dtype="bfloat16",
        bucket_widths=(8, 12, 16, 32, 64)), device="cuda")
    n_buckets = sum(len(v) for v in eng.problem.layouts.values())
    launches, calls = gramian.gather_gram.launches, \
        gramian.gather_gram_plain.calls
    res = eng.run()
    assert gramian.gather_gram.launches == launches + 8 * n_buckets
    assert gramian.gather_gram_plain.calls == calls
    assert np.isfinite(res["RMSE"]) and res["RMSE"] < 2.0


def _tensor_graph():
    from bayesiandatafusion_jl_tpu_torch.models.datasets import \
        tensor_synthetic
    rd = bt.RelationData.from_indexed_df(
        tensor_synthetic((60, 40, 8), 4_000, 8, seed=5))
    rd.assign_to_test(0, 300, seed=7)
    return rd


def _fusion_graph(alpha_sample=False):
    from bayesiandatafusion_jl_tpu_torch.models.datasets import \
        fusion_synthetic
    rd = fusion_synthetic(400, (("ic50", "target", 50, 6_000),
                                ("assay", "assay", 60, 4_000),
                                ("pathway", "pathway", 30, 2_000)), rank=8)
    rd.assign_to_test("ic50", 300, seed=7)
    for rel in rd.relations:
        rd.set_precision(rel, 5.0, sample=alpha_sample)
    return rd


def _symmetric_graph():
    rng = np.random.default_rng(6)
    n = 50
    mask = rng.random((n, n)) < 0.3
    mask[7, :] = mask[:, 7] = False
    idx = np.stack(np.nonzero(mask), 1)
    e = bt.Entity("drug", count=n)
    rd = bt.RelationData()
    rd.add_relation(bt.IndexedDF(idx, rng.standard_normal(len(idx)),
                                 (n, n)), "interaction", [e, e])
    rd.assign_to_test(0, 40, seed=1)
    return rd


GRAPH_CASES = {
    # name: (graph, options, kernel launches a sweep on the card)
    "tensor_int8": (_tensor_graph, dict(dense_gram=True, dense_int8=True),
                    {"K1": 3, "K6": 3, "K7": 3}),
    "tensor_float": (_tensor_graph, dict(dense_gram=True), {"K1": 3}),
    "tensor_gather": (_tensor_graph, dict(dense_gram=False), {"K3": 3}),
    "fusion_int8": (_fusion_graph, dict(dense_gram=True, dense_int8=True),
                    {"K1": 4, "K6": 6, "K7": 6}),
    "fusion_alpha": (lambda: _fusion_graph(True),
                     dict(dense_gram=True, dense_int8=True),
                     {"K1": 4, "K6": 6, "K7": 6}),
    "symmetric_int8": (_symmetric_graph,
                       dict(dense_gram=True, dense_int8=True),
                       {"K1": 1, "K6": 2, "K7": 2}),
}


@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_graph_engine_cuda_matches_cpu(cuda, monkeypatch, case):
    """Graphs on the card against the CPU, three float64 sweeps with
    injected randoms: the tensor (int8 pair at arity 3: K6 for each mode's
    first step and K7 for its table; the float pair; the gather path on
    K3), the fusion graph (three int8 pairs on one entity, alphas fixed or
    sampled) and a symmetric relation.  The card launches the kernels
    listed and runs no plain version and no ``torch._int_mm``; U, mu,
    Lambda and alpha agree to float64 rounding (the ridge's float32 mean
    summed in one fixed order on both devices)."""
    import chip_smoke
    graph, opts, per_sweep = GRAPH_CASES[case]
    monkeypatch.setattr(dense_gram, "ridge_step", xla_cpu_ridge_step)
    engines = {}
    for dev in ("cpu", "cuda"):
        cfg = bt.MacauConfig(num_latent=8, dtype="float64", verbose=False,
                             seed=4, **opts)
        engines[dev] = bt.MacauEngine(graph(), cfg, device=dev)
    st = engines["cpu"].init_state()
    states = {"cpu": st, "cuda": state_from_numpy(state_to_numpy(st), cuda,
                                                  torch.float64)}
    rng = np.random.default_rng(1)
    total = {}
    for s in range(3):
        randoms = draw_all_numpy(rng, engines["cpu"].problem.random_spec)
        states["cpu"], _ = engines["cpu"]._sweep_with_randoms(
            states["cpu"], {k: torch.from_numpy(v)
                            for k, v in randoms.items()}, 1.0)
        r = {k: torch.from_numpy(v).to(cuda) for k, v in randoms.items()}
        (states["cuda"], _), counts = chip_smoke.counted(
            lambda: engines["cuda"]._sweep_with_randoms(states["cuda"], r,
                                                        1.0))
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    assert total == {k: 3 * per_sweep.get(k, 0) for k in total}
    a, b = state_to_numpy(states["cpu"]), state_to_numpy(states["cuda"])
    for ei in range(len(a["ent"])):
        for key in ("U", "mu", "Lambda"):
            np.testing.assert_allclose(b["ent"][ei][key], a["ent"][ei][key],
                                       rtol=1e-9, atol=1e-9)
    for ra, rb in zip(a["rel"], b["rel"]):
        np.testing.assert_allclose(rb["alpha"], ra["alpha"], rtol=1e-9)


def _side_problem(n=600, f=1_500, seed=0):
    """A binary [n, f] feature matrix (about 12 features a row), float64
    on the host, and its ``SparseBinMatrix``."""
    rng = np.random.default_rng(seed)
    X = (rng.random((n, f)) < 12.0 / f).astype(np.float64)
    return X, bt.SparseBinMatrix.from_dense(X)


@pytest.mark.parametrize("widths", [(8, 16, 32, 64), (2, 4)])
def test_bucketed_spmm_on_cuda(cuda, widths):
    """The bucketed feature matvec on the card, float32, against float64
    products on the host, both directions; two calls give the same bits
    (no scatter add on the card)."""
    from bayesiandatafusion_jl_tpu_torch.ops.spmv import (
        bucketed_spmm, build_bucketed_matvec)
    X, F = _side_problem()
    mv = build_bucketed_matvec(F.rows, F.cols, F.shape, widths=widths,
                               device=cuda)
    rng = np.random.default_rng(1)
    V, U = rng.standard_normal((1_500, 32)), rng.standard_normal((600, 32))
    for d, n_out, v, want in (("fwd", 600, V, X @ V),
                              ("t", 1_500, U, X.T @ U)):
        vt = torch.from_numpy(v).to(cuda, torch.float32)
        y = bucketed_spmm(mv[d], n_out, vt)
        np.testing.assert_allclose(y.cpu().numpy(), want, rtol=1e-5,
                                   atol=1e-4)
        assert torch.equal(y, bucketed_spmm(mv[d], n_out, vt))


@pytest.mark.parametrize("nystrom", [False, True])
def test_block_cg_on_cuda(cuda, nystrom):
    """``block_cg`` on the card in float32 (Jacobi or Nystrom) against a
    float64 ``numpy.linalg.solve``: the true residual below 1e-4 and the
    solution to 1e-3 of its norm."""
    from bayesiandatafusion_jl_tpu_torch.ops.cg import block_cg
    from bayesiandatafusion_jl_tpu_torch.ops.precond import (build_nystrom,
                                                             nystrom_apply)
    X, F = _side_problem()
    lam = 1.5
    rhs = np.random.default_rng(2).standard_normal((1_500, 32))
    Xt = torch.from_numpy(X).to(cuda, torch.float32)
    kw = {"precond_diag": torch.from_numpy(
        F.col_sq_sums() + lam).to(cuda, torch.float32)}
    if nystrom:
        Un, dn = build_nystrom(F.rows, F.cols, F.values(), F.shape, 64)
        Ut, dt = (torch.from_numpy(a).to(cuda, torch.float32)
                  for a in (Un, dn))
        kw = {"precond": lambda r: nystrom_apply(Ut, dt, lam, r)}
    beta, it, resid = block_cg(lambda v: Xt.mT @ (Xt @ v) + lam * v,
                               torch.from_numpy(rhs).to(cuda, torch.float32),
                               torch.zeros(1_500, 32, device=cuda), tol=1e-5,
                               maxiter=200, **kw)
    want = np.linalg.solve(X.T @ X + lam * np.eye(1_500), rhs)
    assert 0 < it < 200 and float(resid) < 1e-4
    err = np.abs(beta.cpu().numpy() - want).max() / np.abs(want).max()
    assert err < 1e-3, err


def test_dual_solve_on_cuda(cuda):
    """The dual solve on the card at N = 3,000 < F = 6,000 (the
    eigendecomposition in float32, N > 2048) with one refinement: the
    true relative residual below 1e-5 against float64 products, uhat =
    X beta, and the solution to 1e-4 of a float64 solve."""
    from bayesiandatafusion_jl_tpu_torch.ops.dual import (dual_eig_cached,
                                                          dual_solve_g)
    X, F = _side_problem(3_000, 6_000, seed=3)
    lam = 1.0
    rhs = np.random.default_rng(4).standard_normal((6_000, 16))
    Q, d, G = dual_eig_cached(F.rows, F.cols, F.values(), F.shape,
                              np.float32, None, cuda)
    assert Q.dtype == torch.float32 and Q.device.type == "cuda"
    Xt = torch.from_numpy(X).to(cuda, torch.float32)
    beta, uhat = dual_solve_g(Q, d, torch.from_numpy(G).to(cuda,
                                                           torch.float32),
                              lam, torch.from_numpy(rhs).to(cuda,
                                                           torch.float32),
                              lambda v: Xt @ v, lambda v: Xt.mT @ v, 1)
    b = beta.cpu().numpy().astype(np.float64)
    r = rhs - (X.T @ (X @ b) + lam * b)
    rel = np.linalg.norm(r, axis=0) / np.linalg.norm(rhs, axis=0)
    assert rel.max() < 1e-5, rel.max()
    np.testing.assert_allclose(uhat.cpu().numpy(), X @ b, rtol=1e-4,
                               atol=1e-4)
    want = np.linalg.solve(X.T @ X + lam * np.eye(6_000), rhs)
    assert np.abs(b - want).max() < 1e-4 * np.abs(want).max()


# solver -> (options, per-sweep kernel launches on the card, tolerance)
SIDE_CASES = {
    "dual": (dict(beta_solver="dual", use_ff=False, dense_int8=True,
                  dense_gram=True), {"K1": 2, "K6": 2, "K7": 2}, 1e-8),
    "cg": (dict(beta_solver="cg", use_ff=False, cg_tol=1e-10,
                dense_int8=True, dense_gram=True),
           {"K1": 2, "K6": 2, "K7": 2}, 1e-6),
    "ff": (dict(use_ff=True, dense_int8=True, dense_gram=True),
           {"K1": 2, "K6": 2, "K7": 2}, 1e-8),
    "cg_sparse": (dict(beta_solver="cg", use_ff=False, cg_tol=1e-10,
                       cg_nystrom_rank=0, dense_gram=False),
                  {"K3": 2}, 1e-6)}


@pytest.mark.parametrize("case", sorted(SIDE_CASES))
def test_side_engine_cuda_matches_cpu(cuda, monkeypatch, case):
    """The ChEMBL-shaped Macau problem at a small size (300 compounds with
    500 binary features, 20 targets), K = 8, float64: three sweeps with
    injected randoms on the card and on the CPU.  The beta draw by each
    solver (the dense X, or the bucketed matvec under dense_gram=False),
    lambda_beta sampled; the card launches the path's kernels (K1, K6 and
    K7 on the int8 pair, K3 on the gather path) and no plain version.
    U, mu, Lambda, beta, uhat and lambda_beta agree to 1e-8 (1e-6 with
    CG), and so does the AUC."""
    import chip_smoke
    from bayesiandatafusion_jl_tpu_torch.models.datasets import \
        synthetic_chembl
    opts, per_sweep, tol = SIDE_CASES[case]
    monkeypatch.setattr(dense_gram, "ridge_step", xla_cpu_ridge_step)
    engines = {}
    for dev in ("cpu", "cuda"):
        rd = synthetic_chembl(n_compounds=300, n_targets=20, n_features=500,
                              nnz=3_000, feat_per_compound=12, seed=3)
        rd.assign_to_test(0, 300, seed=7)
        cfg = bt.MacauConfig(num_latent=8, dtype="float64", verbose=False,
                             seed=4, **opts)
        engines[dev] = bt.MacauEngine(rd, cfg, device=dev)
    spec = engines["cpu"].problem.entity_specs[0]
    assert spec.solver == case.split("_")[0]
    assert ("dense_X" in engines["cuda"].problem.feat["e0"]) == (
        case != "cg_sparse")
    st = engines["cpu"].init_state()
    states = {"cpu": st, "cuda": state_from_numpy(state_to_numpy(st), cuda,
                                                  torch.float64)}
    rng = np.random.default_rng(1)
    total = {}
    for s in range(3):
        randoms = draw_all_numpy(rng, engines["cpu"].problem.random_spec)
        states["cpu"], mc = engines["cpu"]._sweep_with_randoms(
            states["cpu"], {k: torch.from_numpy(v)
                            for k, v in randoms.items()}, 1.0)
        r = {k: torch.from_numpy(v).to(cuda) for k, v in randoms.items()}
        (states["cuda"], mg), counts = chip_smoke.counted(
            lambda: engines["cuda"]._sweep_with_randoms(states["cuda"], r,
                                                        1.0))
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        np.testing.assert_allclose(float(mg["r0.auc"]), float(mc["r0.auc"]),
                                   rtol=tol)
    assert total == {k: 3 * per_sweep.get(k, 0) for k in total}
    a, b = state_to_numpy(states["cpu"]), state_to_numpy(states["cuda"])
    for ei in range(2):
        for key in a["ent"][ei]:
            np.testing.assert_allclose(b["ent"][ei][key], a["ent"][ei][key],
                                       rtol=tol, atol=tol, err_msg=key)


# the driver's paths on the card: (data, options); heavy users are chunked
# by the narrow ladder and rated cells are duplicated for the residual, so
# that a scatter add's order would show
def _driver_data(dup=False):
    df = synthetic_ratings(2_000, 1_500, 60_000, seed=3)
    if dup:
        df = bt.IndexedDF(np.concatenate([df.idx, df.idx[::7]]),
                          np.concatenate([df.vals, df.vals[::7][::-1]]),
                          df.shape)
    return df


DRIVER_CASES = {
    "pair": dict(dense_gram=True, dense_int8=True),
    "gather_segment": dict(dense_gram=False, bucket_widths=(8, 16, 32, 64)),
    "gather_planned": dict(dense_gram=False, accumulation="planned",
                           bucket_widths=(8, 16, 32, 64)),
    "fused_residual": dict(dense_fused=True, dense_int8=True,
                           bucket_widths=(8, 16, 32, 64)),
    "features": dict(dense_int8=True, beta_solver="dual", use_ff=False),
}


def _driver_engine(case, **driver):
    if case == "features":
        from bayesiandatafusion_jl_tpu_torch.models.datasets import \
            synthetic_chembl
        rd = synthetic_chembl(n_compounds=300, n_targets=20, n_features=500,
                              nnz=3_000, feat_per_compound=12, seed=3)
        rd.assign_to_test(0, 300, seed=7)
        clamp = None
    else:
        rd = bt.RelationData.from_indexed_df(
            _driver_data(dup=case == "fused_residual"))
        rd.assign_to_test(0, 5_000, seed=7)
        clamp = (1.0, 5.0)
    cfg = bt.MacauConfig(num_latent=16, burnin=3, psamples=4, clamp=clamp,
                         verbose=False, seed=11,
                         **DRIVER_CASES[case], **driver)
    eng = bt.MacauEngine(rd, cfg, device="cuda")
    if case == "fused_residual":
        assert eng.problem.residual_nnzs[0] > 0
    return eng


@pytest.mark.parametrize("case", sorted(DRIVER_CASES))
def test_driver_resume_and_windows_on_cuda(cuda, tmp_path, case):
    """On the card, float32: a run from its sweep-4 checkpoint
    (``load_state``, ``run(sweep_offset=4)``) and a run in windows of 4
    sweeps each equal the run without interruption in one-sweep windows,
    every state leaf bit for bit."""
    import chip_smoke
    full = _driver_engine(case).run()
    ck = str(tmp_path / "ck.npz")
    eng = _driver_engine(case, checkpoint_every=4, checkpoint_path=ck,
                         sweeps_per_dispatch=4, metrics_every=5)
    windowed = eng.run()
    assert chip_smoke.equal_states(windowed["state"], full["state"])
    st, sweep = eng.load_state(ck)
    assert sweep == 4 and st["ent"][0]["U"].device.type == "cuda"
    resumed = eng.run(state=st, sweep_offset=sweep)
    assert chip_smoke.equal_states(resumed["state"], full["state"])
    assert resumed["RMSE"] == full["RMSE"]


@pytest.mark.parametrize("case", ["gather_segment", "gather_planned",
                                  "fused_residual"])
def test_same_seed_runs_bitwise_on_cuda(cuda, case):
    """Two runs of one seed give the same U, bit for bit, on the paths
    that sum gather rows into instances (the destination map's overflow
    under both accumulations, the fused path's residual)."""
    eng = _driver_engine(case)
    a = eng.run()["state"]
    b = eng.run()["state"]
    assert all(torch.equal(x["U"], y["U"])
               for x, y in zip(a["ent"], b["ent"]))


@pytest.mark.parametrize("case", sorted(DRIVER_CASES))
def test_window_waits_for_nothing_on_cuda(cuda, case):
    """A window of 4 sweeps dispatched with CUDA sync debugging set to raise:
    no sweep of the pair, gather, fused-residual or dual-solve path waits
    for the device (the metrics stay on it until the window's end)."""
    eng = _driver_engine(case)
    state = eng.init_state()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, mstack = eng._window(state, eng.config.seed, 0, 4)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(mstack) == 4
    assert all(np.isfinite(v) for m in eng._fetch(mstack) for v in m.values())


def test_native_layout_equals_numpy_at_ml10m(cuda):
    """The native layout builder on the card's host against the NumPy
    builder at ML-10M (71,567 x 10,681, 9.9M training ratings, the bench's
    25-width ladder), both modes, bit for bit; the native build is the
    faster."""
    import time

    import chip_smoke
    from bayesiandatafusion_jl_tpu_torch.models.datasets import \
        load_movielens
    from bayesiandatafusion_jl_tpu_torch.ops import layout
    rd = bt.RelationData.from_indexed_df(load_movielens("10m", seed=0))
    rd.assign_to_test(0, 100_000, seed=7)
    data = rd.relations[0].data
    cen = data.vals - data.vals.mean()
    for mode in range(2):
        args = (data.idx, cen, mode, data.shape[mode],
                chip_smoke.BENCH_WIDTHS, 8)
        t0 = time.perf_counter()
        got = layout.build_mode_layout(*args)
        t1 = time.perf_counter()
        want = layout.build_mode_layout(*args, use_native=False)
        t2 = time.perf_counter()
        assert t1 - t0 < t2 - t1
        assert len(got.buckets) == len(want.buckets) > 10
        for x, y in zip(got.buckets, want.buckets):
            assert x.width == y.width
            np.testing.assert_array_equal(x.inst, y.inst)
            np.testing.assert_array_equal(x.part[0], y.part[0])
            np.testing.assert_array_equal(x.val.view(np.int32),
                                          y.val.view(np.int32))
            np.testing.assert_array_equal(x.mask, y.mask)


@pytest.mark.parametrize("out_dtype, tol", [(torch.float32, 1e-5),
                                            (torch.float64, 1e-12)])
def test_int8_arity4_contrib_cuda_matches_plain(cuda, out_dtype, tol):
    """The int8 pair at arity 4 (300 x 40 x 20 x 6, K = 32): every focus
    mode's contribution on the card (K7 for the largest partner's table,
    K6 on the store read as a matrix, the two small partners in one
    einsum) against the CPU's plain versions on the same store and
    factors, packed and unpacked, to ``tol`` of the largest entry; one K6
    and one K7 launch a contribution."""
    shape, K = (300, 40, 20, 6), 32
    rng = np.random.default_rng(19)
    cells = rng.choice(np.prod(shape), 40_000, replace=False)
    idx = np.stack(np.unravel_index(cells, shape), 1)
    cen = rng.standard_normal(len(idx))
    pairs = {dev: dense_gram.build_int8_pair(idx, cen, shape, np.float32,
                                             dev) for dev in ("cpu", cuda)}
    assert pairs[cuda]["order"] == (0, 2, 3, 1)
    assert torch.equal(pairs[cuda]["M8"].cpu(), pairs["cpu"]["M8"])
    Us = [rng.standard_normal((n, K)) for n in shape]
    alpha = 1.7
    for mode in range(4):
        for packed in (True, False):
            out = {}
            for dev in ("cpu", cuda):
                parts = [torch.from_numpy(Us[d]).to(dev, torch.float32)
                         for d in range(4) if d != mode]
                before = (pair_contract.pair_contract.launches,
                          ytab.ytab_quantize.launches)
                out[dev] = dense_gram.int8_pair_contrib(
                    pairs[dev], dense_gram.tri_index(K, dev), parts, mode,
                    torch.tensor(alpha, device=dev), out_dtype,
                    packed=packed)
                if dev == cuda:
                    assert (pair_contract.pair_contract.launches,
                            ytab.ytab_quantize.launches) == (
                                before[0] + 1, before[1] + 1)
            for g, w in zip(out[cuda], out["cpu"]):
                w = w.double()
                assert g.shape == w.shape
                assert float((g.cpu().double() - w).abs().max()) <= (
                    tol * float(w.abs().max()))


def test_planner_choices_at_bench_shapes(cuda):
    """``plan_gramians`` on the ``tensor`` and ``chembl`` data as bench.py
    builds them, with its Gramian options as written (dense_int8=True,
    gram_dtype="bfloat16", default dense_gram, dense_fused and budget):
    every mode on the int8 pair; the engine built on the card stores what
    the plan says and contracts every mode on K6."""
    import chip_smoke
    from bayesiandatafusion_jl_tpu_torch.models.datasets import (
        synthetic_chembl, tensor_synthetic)
    from bayesiandatafusion_jl_tpu_torch.models.engine import plan_gramians
    tensor = bt.RelationData.from_indexed_df(tensor_synthetic())
    tensor.assign_to_test(0, 100_000, seed=7)
    chembl = synthetic_chembl(**chip_smoke.CHEMBL_DATA)
    chembl.assign_to_test(0, chip_smoke.CHEMBL_TEST, seed=7)
    for rd in (tensor, chembl):
        cfg = bt.MacauConfig(num_latent=32, verbose=False, dtype="float32",
                             seed=42, dense_int8=True, gram_dtype="bfloat16")
        plan = plan_gramians(rd, cfg)
        arity = rd.relations[0].arity
        assert set(plan.dense_plans) == {(0, m) for m in range(arity)}
        assert plan.pair_i8 == {0: True} and not plan.fused
    eng = bt.MacauEngine(chembl, cfg, device=cuda)
    assert eng.problem.kinds == ["pair"] and eng.problem.pair_i8s == [True]
    (_, _), counts = chip_smoke.counted(lambda: eng._sweep(
        eng.init_state(), 0, 0.0))
    assert counts["K6"] == 2 and counts["plain_pair"] == 0


@pytest.fixture(scope="module")
def nccl(tmp_path_factory):
    """An NCCL process group of world size 1 in this process."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist
    from bayesiandatafusion_jl_tpu_torch.parallel.mesh import \
        initialize_distributed
    rdv = tmp_path_factory.mktemp("nccl") / "rendezvous"
    initialize_distributed(f"file://{rdv}", 1, 0, device="cuda")
    yield dist.get_backend()
    dist.destroy_process_group()


SHARDED_CASES = dict(DRIVER_CASES, gather_head=dict(
    dense_gram=False, bucket_widths=(8, 16, 32, 64), head_split_degree=60,
    exchange_blocks=2))


def _sharded_pair(case):
    """The single-device engine of ``case`` and the sharded engine on the
    same data and config."""
    from bayesiandatafusion_jl_tpu_torch.parallel.sharded import \
        ShardedMacauEngine
    single = _driver_engine("gather_segment" if case == "gather_head"
                            else case)
    if case == "gather_head":
        import dataclasses
        single.config = dataclasses.replace(single.config,
                                            **SHARDED_CASES[case])
    if case == "features":
        from bayesiandatafusion_jl_tpu_torch.models.datasets import \
            synthetic_chembl
        data = synthetic_chembl(n_compounds=300, n_targets=20,
                                n_features=500, nnz=3_000,
                                feat_per_compound=12, seed=3)
        data.assign_to_test(0, 300, seed=7)
    else:
        data = bt.RelationData.from_indexed_df(
            _driver_data(dup=case == "fused_residual"))
        data.assign_to_test(0, 5_000, seed=7)
    return single, ShardedMacauEngine(data, single.config, device="cuda")


@pytest.mark.parametrize("case", sorted(SHARDED_CASES))
def test_sharded_world1_matches_single_on_cuda(cuda, nccl, case):
    """The sharded engine on an NCCL group of one rank, float32 on the
    card: one sweep from the single-device engine's state and randoms
    gives its U (original order) within chip_smoke's SHARDED_SWEEP_TOL of
    its largest entry (within SHARDED_FIXED_TOL with the hyper draws
    fixed), mu and Lambda within 1e-3 (the float sums add in another
    order); the path's store and head split are the ones the case is
    for."""
    import chip_smoke
    assert nccl == "nccl"
    single, eng = _sharded_pair(case)
    assert eng.problem.kinds == single.problem.kinds
    if case == "gather_head":
        assert max(m.n_head for m in eng.problem.ent_meta) > 0
        assert eng.problem.exchange_blocks == 2
    for fixed, tol in ((False, chip_smoke.SHARDED_SWEEP_TOL),
                       (True, chip_smoke.SHARDED_FIXED_TOL)):
        err = chip_smoke.one_sweep_error(single, eng, fixed)
        assert max(err) <= tol, (fixed, err)
    state = single.init_state()
    randoms = single.draw(1)
    s1, m1 = single._sweep_with_randoms(state, randoms, 0.0)
    ss, ms = eng._sweep_with_randoms(eng.shard_state(state), randoms, 0.0)
    got = eng.unshard_state(ss)
    for ei in range(len(s1["ent"])):
        for key in ("U", "mu", "Lambda"):
            a, b = s1["ent"][ei][key], got["ent"][ei][key]
            scale = float(a.abs().max())
            assert float((a - b).abs().max()) <= 1e-3 * scale, (ei, key)
    assert abs(float(ms["r0.rmse_sample"]) - float(m1["r0.rmse_sample"])) \
        <= 1e-3


@pytest.mark.parametrize("case", ["pair", "fused_residual", "gather_head"])
def test_sharded_resume_and_windows_on_cuda(cuda, nccl, tmp_path, case):
    """At world size 1 on NCCL: a run from its sweep-4 checkpoint and a
    run in windows of 4 sweeps each equal the run without interruption,
    bit for bit."""
    import dataclasses

    import chip_smoke
    _, eng = _sharded_pair(case)
    base = eng.config
    full = eng.run()
    ck = str(tmp_path / "ck.npz")
    eng.config = dataclasses.replace(base, checkpoint_every=4,
                                     checkpoint_path=ck,
                                     sweeps_per_dispatch=4)
    windowed = eng.run()
    assert chip_smoke.equal_states(windowed["state"], full["state"])
    st, sweep = eng.load_state(ck)
    assert sweep == 4
    resumed = eng.run(state=st, sweep_offset=sweep)
    assert chip_smoke.equal_states(resumed["state"], full["state"])
    assert resumed["RMSE"] == full["RMSE"]


def test_long_chain_gate(cuda):
    """tests/test_longchain.py on the card (``chip_smoke.run_long_chain_gate``):
    200 sweeps of the int8 pair in float32 (K6, K7, K1) against 200 of the
    float64 gather path (K3) on 943 x 1,682: the posterior-mean RMSE, the
    mean of the last four rmse_sample readings and the mean prediction
    stdev within the JAX gate's bounds, each chain's kernels counted."""
    import chip_smoke
    launches = {}

    def tally(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    got = chip_smoke.run_long_chain_gate(tally)
    assert set(got) == {"rmse", "tail", "stdev"}
    assert all(launches[k] == 400 for k in ("K1", "K3", "K6", "K7"))


def _tf32_on(api):
    """Turn TF32 on for float32 matmuls by one of PyTorch's switches."""
    if api == "set_float32_matmul_precision":
        torch.set_float32_matmul_precision("high")
    elif api == "allow_tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
    else:
        torch.backends.cuda.matmul.fp32_precision = "tf32"


@pytest.mark.parametrize("api", ["allow_tf32", "fp32_precision",
                                 "set_float32_matmul_precision"])
def test_tf32_after_the_build_leaves_a_macau_sweep_bitwise(cuda, api):
    """TF32 turned on after the build (by each of PyTorch's switches): one
    float32 Macau window (the int8 pair, the dual solve on the dense X,
    lambda_beta sampled) gives the bits it gives with TF32 off,
    and the caller's setting is on again after it; the same sweep outside
    the engine's window, with TF32 on, does not."""
    from bayesiandatafusion_jl_tpu_torch.models.datasets import \
        synthetic_chembl
    import chip_smoke
    rd = synthetic_chembl(n_compounds=2_000, n_targets=60, n_features=6_000,
                          nnz=30_000, seed=3)
    rd.assign_to_test(0, 2_000, seed=7)
    eng = bt.MacauEngine(rd, bt.MacauConfig(
        num_latent=32, burnin=1, psamples=1, verbose=False, seed=5,
        dense_gram=True, dense_int8=True, gram_dtype="bfloat16",
        use_ff=False))
    assert eng.problem.entity_specs[0].solver == "dual"
    state = eng.init_state()

    def window():
        st, ms = eng._window(state, 5, 0, 1)
        eng._fetch(ms)
        return st
    off = window()
    assert chip_smoke.equal_states(window(), off)
    try:
        _tf32_on(api)
        on = window()
        assert torch.backends.cuda.matmul.fp32_precision == "tf32"
        bare, _ = eng._sweep_with_randoms(state, eng.draw(1, 5), 0.0)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert chip_smoke.equal_states(on, off)
    assert not chip_smoke.equal_states(bare, off)


@pytest.mark.parametrize("dense_gram", [False, True])
def test_graph_replay_gives_the_eager_bits(cuda, dense_gram):
    """A Macau chain (the gather path and the bucketed matvec, or the int8
    pair and the dense X; the dual solve, lambda_beta sampled, the AUC of
    a class cut) with its short phases replayed from CUDA
    graphs (the beta draw, both Normal-Wishart draws, the AUC) gives the
    bits and metrics of the same chain run eagerly, window by window, and
    the beta draw's counters advance as they do eagerly."""
    from bayesiandatafusion_jl_tpu_torch.models.datasets import \
        synthetic_chembl
    from bayesiandatafusion_jl_tpu_torch.utils import spans
    import chip_smoke
    rd = synthetic_chembl(n_compounds=2_000, n_targets=60, n_features=6_000,
                          nnz=30_000, seed=3)
    rd.assign_to_test(0, 2_000, seed=7)

    def engine(graphs):
        eng = bt.MacauEngine(rd, bt.MacauConfig(
            num_latent=32, burnin=2, psamples=1, verbose=False, seed=5,
            dense_gram=dense_gram, dense_int8=True, gram_dtype="bfloat16",
            use_ff=False))
        eng.graphs.enabled = graphs
        return eng
    on, off = engine(True), engine(False)
    assert on.problem.entity_specs[0].solver == "dual"
    s_on, s_off = on.init_state(), off.init_state()
    for start in (0, 2, 4):
        with spans.recording() as r_on:
            s_on, m_on = on._window(s_on, 5, start, 2)
            m_on = on._fetch(m_on)
        with spans.recording() as r_off:
            s_off, m_off = off._window(s_off, 5, start, 2)
            m_off = off._fetch(m_off)
        assert chip_smoke.equal_states(s_on, s_off), start
        assert m_on == m_off, start
        for c in ("bucketed_spmm.calls", "dual_solve.calls"):
            assert r_on.counters[c] == r_off.counters[c], (start, c)
    assert r_on.counters["dual_solve.calls"] == 2
    assert on.graphs.captured() == 4 and off.graphs.captured() == 0
    # an engine without a dual beta draw keeps them off
    rd_b = synthetic_chembl(n_compounds=2_000, n_targets=60,
                            n_features=6_000, nnz=30_000, seed=3)
    eng = bt.MacauEngine(bt.RelationData.from_indexed_df(
        rd_b.relations[0].data), bt.MacauConfig(
            num_latent=32, burnin=1, psamples=1, verbose=False, seed=5,
            dense_gram=dense_gram, dense_int8=True))
    assert not eng.graphs.enabled
