"""The port's gather-path Gramian (ops/gramian.py) against the JAX
package's: per-bucket Gramians (one pass and row-chunked), the assembly
through the destination map with and without Lambda (against JAX's segment
sum and its planned assembly), the packed accumulation of the fused path's
residual and the accumulation plan, in float64 to 1e-12; the bfloat16
gather against JAX's bfloat16 contraction at float32 tolerance."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesiandatafusion_jl_tpu.ops import gramian as jgr
from bayesiandatafusion_jl_tpu.ops.layout import \
    build_mode_layout as jax_build_mode_layout
from bayesiandatafusion_jl_tpu_torch.ops import gramian as tgr
from bayesiandatafusion_jl_tpu_torch.ops.layout import build_mode_layout

K = 6
SHAPE = (40, 90)
WIDTHS = (4, 8, 16, 32)


def _problem(dtype, mode=0, seed=0):
    """A layout of one random relation with a head instance (chunked) and
    an empty one, partner factors, Lambda and mu, made with numpy."""
    rng = np.random.default_rng(seed)
    mask = rng.random(SHAPE) < 0.15
    mask[1, :70] = True                  # head: 70 > widest bucket (32)
    mask[3] = False                      # empty instance
    idx = np.stack(np.nonzero(mask), 1)
    vals = rng.standard_normal(len(idx))
    ml = build_mode_layout(idx, vals, mode, SHAPE[mode], widths=WIDTHS,
                           row_pad=8, dtype=dtype)
    U = rng.standard_normal((SHAPE[1 - mode], K)).astype(dtype)
    A = rng.standard_normal((K, K))
    Lam = (A @ A.T / K + np.eye(K)).astype(dtype)
    mu = rng.standard_normal(K).astype(dtype)
    return idx, vals, ml, U, Lam, mu


def _contribs(ml, U, alpha, lib):
    """(alpha, [U], bucket) per bucket, as jax or torch arrays."""
    if lib == "jax":
        return [(jnp.asarray(alpha, U.dtype), [jnp.asarray(U)],
                 {"inst": jnp.asarray(b.inst),
                  "part": [jnp.asarray(p) for p in b.part],
                  "val": jnp.asarray(b.val), "mask": jnp.asarray(b.mask)})
                for b in ml.buckets]
    return [(torch.tensor(alpha, dtype=torch.from_numpy(U).dtype),
             [torch.from_numpy(U)],
             {"inst": torch.from_numpy(b.inst),
              "part": [torch.from_numpy(p) for p in b.part],
              "val": torch.from_numpy(b.val),
              "mask": torch.from_numpy(b.mask)})
            for b in ml.buckets]


def _dest_map(ml, n):
    """The destination map of one layout's buckets (``build_dest_map``),
    its arrays as tensors."""
    dm = tgr.build_dest_map([b.inst for b in ml.buckets], n)
    for k in ("dest", "ov_inst", "ov_len", "empty"):
        dm[k] = torch.from_numpy(dm[k])
    return dm


def test_layout_input_matches_jax():
    idx, vals, ml, *_ = _problem(np.float64)
    want = jax_build_mode_layout(idx, vals, 0, SHAPE[0], widths=WIDTHS,
                                 row_pad=8, dtype=np.float64)
    assert [b.inst.tobytes() for b in ml.buckets] == \
        [b.inst.tobytes() for b in want.buckets]


@pytest.mark.parametrize("chunked", [False, True])
def test_bucket_gramian_matches_jax(chunked):
    """Every bucket's P [rows, K, K] and b [rows, K]; with a tiny budget
    every bucket runs row-chunked and gives the one-pass bits."""
    _, _, ml, U, _, _ = _problem(np.float64)
    assert max(b.width for b in ml.buckets) == 32
    for b in ml.buckets:
        Pj, bj = jgr.bucket_gramian(
            [jnp.asarray(U)], [jnp.asarray(p) for p in b.part],
            jnp.asarray(b.val), jnp.asarray(b.mask))
        args = ([torch.from_numpy(U)], [torch.from_numpy(p) for p in b.part],
                torch.from_numpy(b.val), torch.from_numpy(b.mask))
        Pt, bt = tgr.bucket_gramian(
            *args, max_gather_bytes=(b.width * K * 8 * 3 if chunked
                                     else None))
        np.testing.assert_allclose(Pt.numpy(), np.asarray(Pj), rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-12,
                                   atol=1e-12)
        if chunked:
            P1, b1 = tgr.bucket_gramian(*args)
            assert torch.equal(Pt, P1) and torch.equal(bt, b1)


@pytest.mark.parametrize("fuse_lambda", [False, True])
@pytest.mark.parametrize("mode", [0, 1])
def test_assemble_precision_matches_jax(mode, fuse_lambda):
    _, _, ml, U, Lam, mu = _problem(np.float64, mode=mode, seed=mode)
    n = SHAPE[mode]
    prior = np.broadcast_to(mu, (n, K))
    Pj, bj = jgr.assemble_precision(
        jnp.asarray(Lam), jnp.asarray(prior), _contribs(ml, U, 2.5, "jax"),
        n, fuse_lambda=fuse_lambda)
    Pt, bt = tgr.assemble_precision(
        torch.from_numpy(Lam), torch.from_numpy(mu),
        _contribs(ml, U, 2.5, "torch"), n, fuse_lambda=fuse_lambda,
        dest_map=_dest_map(ml, n))
    assert tuple(Pt.shape) == (n, K, K) and tuple(bt.shape) == (n, K)
    np.testing.assert_allclose(Pt.numpy(), np.asarray(Pj), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("mode", [0, 1])
def test_packed_bucket_accum_matches_jax(monkeypatch, mode, chunked):
    """The packed accumulation (Pp [n, C], b [n, K], alpha-scaled) against
    JAX's, in one pass and with a budget so small that every bucket runs
    in row chunks (both packages then chunk; the segment sums add in
    another order, float64 rounding).  The transposed layout and the
    in-place ``out`` accumulators give the same sums."""
    _, _, ml, U, _, _ = _problem(np.float64, mode=mode, seed=7 + mode)
    n = SHAPE[mode]
    if chunked:
        monkeypatch.setattr(jgr, "_PACKED_CHUNK_BYTES", 2_000)
        monkeypatch.setattr(tgr, "_PACKED_CHUNK_BYTES", 2_000)
    Pj, bj = jgr.packed_bucket_accum(_contribs(ml, U, 2.5, "jax"), n, K)
    contribs = _contribs(ml, U, 2.5, "torch")
    calls = []
    orig = tgr.bucket_gramian
    monkeypatch.setattr(tgr, "bucket_gramian",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    Pt, bt = tgr.packed_bucket_accum(contribs, n, K)
    assert (len(calls) > len(contribs)) == chunked
    C = K * (K + 1) // 2
    assert tuple(Pt.shape) == (n, C) and tuple(bt.shape) == (n, K)
    np.testing.assert_allclose(Pt.numpy(), np.asarray(Pj), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-12,
                               atol=1e-12)
    base = (torch.full((C, n), 3.0, dtype=torch.float64),
            torch.full((K, n), -1.0, dtype=torch.float64))
    PT, bT = tgr.packed_bucket_accum(contribs, n, K, transposed=True,
                                     out=base)
    assert PT is base[0] and bT is base[1]
    np.testing.assert_allclose(PT.numpy().T - 3.0, Pt.numpy(), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(bT.numpy().T + 1.0, bt.numpy(), rtol=1e-12,
                               atol=1e-12)
    assert tgr.packed_bucket_accum([], n, K) == (None, None)


def test_packed_bucket_accum_bf16_matches_jax():
    """gram_dtype bfloat16 in float32: the residual's partners and values
    gathered in bf16, contracted with float32 accumulation on both sides;
    only the order of the float32 sums differs."""
    _, _, ml, U, _, _ = _problem(np.float32, seed=5)
    n = SHAPE[0]
    Pj, bj = jgr.packed_bucket_accum(_contribs(ml, U, 2.5, "jax"), n, K,
                                     gram_dtype=jnp.bfloat16)
    Pt, bt = tgr.packed_bucket_accum(_contribs(ml, U, 2.5, "torch"), n, K,
                                     gram_dtype=torch.bfloat16)
    assert Pt.dtype == torch.float32 and np.asarray(Pj).dtype == np.float32
    np.testing.assert_allclose(Pt.numpy(), np.asarray(Pj), rtol=2e-6,
                               atol=2e-5)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=2e-6,
                               atol=2e-5)


@pytest.mark.parametrize("mode", [0, 1])
def test_plan_accumulation_equal(mode):
    _, _, ml, *_ = _problem(np.float64, mode=mode)
    insts = [b.inst for b in ml.buckets]
    got = tgr.plan_accumulation(insts, SHAPE[mode])
    want = jgr.plan_accumulation(insts, SHAPE[mode])
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("mode", [0, 1])
def test_assemble_precision_planned_matches_jax(mode):
    """The assembly with Lambda in P (``fuse_lambda=False``, what "planned"
    takes) against JAX's planned assembly, and against JAX's segment sum
    with Lambda, to rounding."""
    _, _, ml, U, Lam, mu = _problem(np.float64, mode=mode, seed=3)
    n = SHAPE[mode]
    plan = tgr.plan_accumulation([b.inst for b in ml.buckets], n)
    prior = jnp.asarray(np.broadcast_to(mu, (n, K)))
    Pj, bj = jgr.assemble_precision_planned(
        jnp.asarray(Lam), prior, _contribs(ml, U, 2.5, "jax"), n,
        {k: jnp.asarray(v) for k, v in plan.items()})
    Pt, bt = tgr.assemble_precision(
        torch.from_numpy(Lam), torch.from_numpy(mu),
        _contribs(ml, U, 2.5, "torch"), n, fuse_lambda=False,
        dest_map=_dest_map(ml, n))
    np.testing.assert_allclose(Pt.numpy(), np.asarray(Pj), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-12,
                               atol=1e-12)
    Ps, bs = jgr.assemble_precision(
        jnp.asarray(Lam), prior, _contribs(ml, U, 2.5, "jax"), n)
    np.testing.assert_allclose(Pt.numpy(), np.asarray(Ps), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bs), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("fuse_lambda", [False, True])
def test_assemble_precision_needs_the_map(fuse_lambda):
    """Bucket rows without their destination map raise; with no buckets
    there is nothing to map: P is Lambda (or zeros with ``fuse_lambda``)
    and b the prior term, as JAX's assembly of no contributions."""
    _, _, ml, U, Lam, mu = _problem(np.float64)
    n = SHAPE[0]
    with pytest.raises(ValueError, match="destination map"):
        tgr.assemble_precision(torch.from_numpy(Lam), torch.from_numpy(mu),
                               _contribs(ml, U, 2.5, "torch"), n,
                               fuse_lambda=fuse_lambda)
    Pj, bj = jgr.assemble_precision(
        jnp.asarray(Lam), jnp.asarray(np.broadcast_to(mu, (n, K))), [], n,
        fuse_lambda=fuse_lambda)
    Pt, bt = tgr.assemble_precision(torch.from_numpy(Lam),
                                    torch.from_numpy(mu), [], n,
                                    fuse_lambda=fuse_lambda)
    assert Pt.is_contiguous() and bt.is_contiguous()
    np.testing.assert_array_equal(Pt.numpy(), np.asarray(Pj))
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-12,
                               atol=1e-12)


def test_bf16_gram_dtype_matches_jax():
    """gram_dtype bfloat16 in float32: partners and values gathered in
    bf16, contracted with float32 accumulation and output on both sides.
    The products are exact, so only the order of the float32 sums
    differs."""
    _, _, ml, U, Lam, mu = _problem(np.float32, seed=5)
    n = SHAPE[0]
    Pj, bj = jgr.assemble_precision(
        jnp.asarray(Lam), jnp.asarray(np.broadcast_to(mu, (n, K))),
        _contribs(ml, U, 2.5, "jax"), n, gram_dtype=jnp.bfloat16)
    dm = _dest_map(ml, n)
    Pt, bt = tgr.assemble_precision(
        torch.from_numpy(Lam), torch.from_numpy(mu),
        _contribs(ml, U, 2.5, "torch"), n, gram_dtype=torch.bfloat16,
        dest_map=dm)
    assert Pt.dtype == torch.float32 and np.asarray(Pj).dtype == np.float32
    np.testing.assert_allclose(Pt.numpy(), np.asarray(Pj), rtol=2e-6,
                               atol=2e-5)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=2e-6,
                               atol=2e-5)
    # and it is not the float32 gather: bf16 rounding is far above that
    P32, _ = tgr.assemble_precision(
        torch.from_numpy(Lam), torch.from_numpy(mu),
        _contribs(ml, U, 2.5, "torch"), n, dest_map=dm)
    assert float((P32 - Pt).abs().max()) > 1e-3
