"""The gather path's destination map (``ops/gramian.build_dest_map``) and
the assembly through it (``assemble_precision(..., dest_map=...)``), on the
CPU: the map on random layouts (every row once, each instance's first row
at the instance, the other rows in overflow slots by instance and layout
order, instance 0 and the padding, the empty instances, several relations
for one entity); the mapped assembly against a float64 sum of the same
rows; the torch code's ``dest`` against its rows without it; and a small
gather engine's chain under both accumulations.  The kernel's ``dest``
runs only on the card (``tests/test_torch_gpu.py -k gather_gram_dest``).
Jax-free."""
import numpy as np
import pytest
import torch

import bayesiandatafusion_jl_tpu_torch as bt
from bayesiandatafusion_jl_tpu_torch.models.datasets import (
    fusion_synthetic, synthetic_ratings)
from bayesiandatafusion_jl_tpu_torch.ops import gramian as tgr
from bayesiandatafusion_jl_tpu_torch.ops.layout import build_mode_layout
from bayesiandatafusion_jl_tpu_torch.utils import spans
from _torch_gather_bucket import gather_bucket

N = 40               # the focus entity's instances
K = 8
WIDTHS = (4, 8, 16, 32)


def _relation(rng, shape, mode, head=True, inst0=True):
    """(idx, vals) of one random relation whose ``mode`` is the focus
    entity: ~15% of its cells, instance 1 with 70 observations (three
    chunks of the widest bucket, 32), instance 3 with none, instance 0
    with some or none."""
    mask = rng.random(shape) < 0.15
    sel = [slice(None)] * len(shape)
    for i, on in ((1, head), (3, False), (0, inst0)):
        sel[mode] = i
        if i == 1 and on:
            flat = mask[tuple(sel)].reshape(-1)
            flat[:70] = True
            mask[tuple(sel)] = flat.reshape(mask[tuple(sel)].shape)
        elif not on:
            mask[tuple(sel)] = False
    idx = np.stack(np.nonzero(mask), 1)
    return idx, rng.standard_normal(len(idx))


# the focus entity's relations: (shape, focus mode) each, and whether
# instance 0 has observations
CASES = {
    "one": ([((N, 90), 0)], True),
    "no_inst0": ([((N, 90), 0)], False),
    "two_relations": ([((N, 90), 0), ((60, N), 1)], True),
    "tensor": ([((N, 12, 9), 0)], True),
}


def _layouts(case, seed=0):
    """[(ModeLayout, partner shapes)] of the case's relations, float32."""
    rels, inst0 = CASES[case]
    rng = np.random.default_rng(seed)
    out = []
    for shape, mode in rels:
        idx, vals = _relation(rng, shape, mode, inst0=inst0)
        ml = build_mode_layout(idx, vals, mode, shape[mode], widths=WIDTHS,
                               row_pad=8, dtype=np.float32)
        out.append((ml, [s for d, s in enumerate(shape) if d != mode]))
    return out


def _insts(layouts):
    return [b.inst for ml, _ in layouts for b in ml.buckets]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", sorted(CASES))
def test_dest_map_on_random_layouts(case, seed):
    layouts = _layouts(case, seed)
    insts = _insts(layouts)
    cat = np.concatenate(insts)
    masks = np.concatenate([b.mask.any(1) for ml, _ in layouts
                            for b in ml.buckets])
    R = len(cat)
    dm = tgr.build_dest_map(insts, N, "bdf.e0.overflow")
    d, n_ov = dm["dest"], dm["overflow_rows"]
    assert d.dtype == np.int32 and d.shape == (R,)
    # every row mapped exactly once: to distinct instances, or to the
    # overflow's slots, which it fills
    assert len(np.unique(d)) == R
    assert np.array_equal(np.sort(d[d >= N]), N + np.arange(n_ov))
    assert dm["direct_rows"] + n_ov == R
    assert dm["direct_rows"] == int((d < N).sum())
    # each instance's first row at the instance (instance 0's rows, the
    # buckets' padding among them, all through the overflow)
    for u in np.unique(cat):
        rows = np.nonzero(cat == u)[0]
        if u == 0:
            assert (d[rows] >= N).all()
            continue
        assert d[rows[0]] == u and (d[rows[1:]] >= N).all()
    assert (d[~masks] >= N).all() and (cat[~masks] == 0).all()
    assert (~masks).any()                      # the layouts pad
    # the overflow slots: by instance, each instance's in layout order
    by_slot = np.argsort(d)[N - len(dm["empty"]):]
    assert len(by_slot) == n_ov and (d[by_slot] >= N).all()
    ov = cat[by_slot]
    assert (np.diff(ov) >= 0).all()
    for u in np.unique(ov):
        assert (np.diff(by_slot[ov == u]) > 0).all()
    u, c = np.unique(ov, return_counts=True)
    assert np.array_equal(dm["ov_inst"], u) and np.array_equal(
        dm["ov_len"], c)
    # the head (instance 1) has three chunks in every relation
    n_rel = len(CASES[case][0])
    assert dm["ov_len"][list(u).index(1)] == 2 * n_rel
    # the instances no first row reaches: 0, the empty 3, the unobserved
    reached = set(d[d < N].tolist())
    assert dm["empty"].tolist() == [i for i in range(N) if i not in reached]
    assert {0, 3} <= set(dm["empty"].tolist())
    assert dm["span"] == "bdf.e0.overflow"


def _contribs(layouts, gen, alpha=2.5):
    """(alpha, partner tables, bucket tensors) per bucket, float32."""
    tables = {}
    out = []
    for ml, pshape in layouts:
        parts = [tables.setdefault(
            (id(ml), d), torch.randn((n, K), generator=gen))
            for d, n in enumerate(pshape)]
        for b in ml.buckets:
            out.append((torch.tensor(alpha), parts, {
                "inst": torch.from_numpy(b.inst),
                "part": [torch.from_numpy(p) for p in b.part],
                "val": torch.from_numpy(b.val),
                "mask": torch.from_numpy(b.mask)}))
    return out


def _device_map(insts):
    dm = tgr.build_dest_map(insts, N)
    for k in ("dest", "ov_inst", "ov_len", "empty"):
        dm[k] = torch.from_numpy(dm[k])
    return dm


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("fuse_lambda", [False, True])
@pytest.mark.parametrize("gram_dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("case", ["one", "two_relations", "tensor"])
def test_assemble_precision_with_and_without_the_map(case, gram_dtype,
                                                     fuse_lambda):
    """The mapped assembly against the plain sum of the same rows (each
    bucket's ``bucket_gramian``, summed by ``index_add_`` in float64):
    instances of one row get that row's bits (plus Lambda and the prior
    term in float32); the others are within float32's rounding of their
    sum, m u sum|row| for m rows; the same bits twice; the counters: every
    row once."""
    layouts = _layouts(case)
    gen = torch.Generator().manual_seed(3)
    contribs = _contribs(layouts, gen)
    A = torch.randn((K, K), generator=gen)
    Lam = A @ A.T / K + torch.eye(K)
    mu = torch.randn((N, K), generator=gen)
    kw = dict(gram_dtype=gram_dtype, fuse_lambda=fuse_lambda)
    insts = _insts(layouts)
    dm = _device_map(insts)
    before = spans.counts()
    P1, b1 = tgr.assemble_precision(Lam, mu, contribs, N, dest_map=dm, **kw)
    after = spans.counts()
    P2, b2 = tgr.assemble_precision(Lam, mu, contribs, N, dest_map=dm, **kw)
    assert P1.shape == (N, K, K) and b1.shape == (N, K)
    assert P1.is_contiguous() and b1.is_contiguous()
    assert torch.equal(_bits(P1), _bits(P2)) and torch.equal(_bits(b1),
                                                             _bits(b2))
    R = sum(len(a) for a in insts)
    assert (after["assemble_precision.direct_rows"]
            - before["assemble_precision.direct_rows"]
            + after["assemble_precision.overflow_rows"]
            - before["assemble_precision.overflow_rows"]) == R
    # the rows, bucket by bucket, and their sums in float64
    rows = [tgr.bucket_gramian(parts, ba["part"], ba["val"], ba["mask"],
                               gram_dtype=gram_dtype, alpha=alpha)
            for alpha, parts, ba in contribs]
    P_cat = torch.cat([P.reshape(-1, K * K) for P, _ in rows])
    b_cat = torch.cat([b for _, b in rows])
    cat = torch.from_numpy(np.concatenate(insts)).long()
    P_ref = torch.zeros((N, K * K), dtype=torch.float64).index_add_(
        0, cat, P_cat.double()).view(N, K, K)
    b_ref = torch.zeros((N, K), dtype=torch.float64).index_add_(
        0, cat, b_cat.double()) + (mu @ Lam).double()
    if not fuse_lambda:
        P_ref = P_ref + Lam.double()
    count = torch.bincount(cat, minlength=N)
    single = (count == 1)
    single[0] = False
    # with two relations every instance has a row in each
    assert (int(single.sum()) == 0 if case == "two_relations"
            else int(single.sum()) > 10)
    assert bool((count > 1).any())
    pos = torch.nonzero(single[cat])[:, 0]   # the one-row instances' rows
    one = cat[pos]
    P_one = P_cat[pos].view(-1, K, K)
    if not fuse_lambda:
        P_one = P_one + Lam
    assert torch.equal(P1[one], P_one)
    assert torch.equal(b1[one], b_cat[pos] + (mu @ Lam)[one])
    # the rounding bound of each instance's sum, from its rows' magnitudes
    absP = torch.zeros((N, K * K), dtype=torch.float64).index_add_(
        0, cat, P_cat.double().abs()).view(N, K, K)
    absb = torch.zeros((N, K), dtype=torch.float64).index_add_(
        0, cat, b_cat.double().abs())
    m = count.double().clamp_min(1)
    u = 2.0 ** -24
    extra_P = 0.0 if fuse_lambda else Lam.double().abs()
    tol_P = 2 * m[:, None, None] * u * (absP + extra_P) + 1e-30
    tol_b = 2 * m[:, None] * u * (absb + (mu @ Lam).double().abs()) + 1e-30
    assert bool(((P1.double() - P_ref).abs() <= tol_P).all())
    assert bool(((b1.double() - b_ref).abs() <= tol_b).all())


@pytest.mark.parametrize("path", ["torch_f32", "torch_bf16", "plain"])
@pytest.mark.parametrize("arity", [2, 3])
def test_bucket_gramian_dest_moves_the_rows(path, arity):
    """The torch code with ``dest``: each row's bits where ``dest`` sends
    it, rows with a destination outside the output stored nowhere, the
    other output rows untouched."""
    rows, W = 24, 12
    tables, parts, val, mask = gather_bucket(W, 32, arity, rows, 7)
    gd = None if path == "torch_f32" else torch.bfloat16
    n_out = 50
    g = torch.Generator().manual_seed(1)
    dest = torch.randperm(n_out, generator=g)[:rows].to(torch.int32)
    dest[3], dest[10] = -1, n_out          # stored nowhere
    if path == "plain":
        P, b = tgr.gather_gram_plain(tables, parts, val, mask, alpha=0.75)
    else:
        P, b = tgr.bucket_gramian(tables, parts, val, mask, gram_dtype=gd,
                                  alpha=0.75)
    out = (torch.full((n_out, 32 * 32), -3.0), torch.full((n_out, 32), -3.0))
    if path == "plain":
        got = tgr.gather_gram(tables, parts, val, mask, alpha=0.75, out=out,
                              dest=dest)
    else:
        got = tgr.bucket_gramian(tables, parts, val, mask, gram_dtype=gd,
                                 alpha=0.75, out=out, dest=dest)
    assert got[0] is out[0] and got[1] is out[1]
    keep = (dest >= 0) & (dest < n_out)
    want_P = torch.full_like(out[0], -3.0)
    want_b = torch.full_like(out[1], -3.0)
    want_P[dest[keep].long()] = P.reshape(rows, -1)[keep]
    want_b[dest[keep].long()] = b[keep]
    assert torch.equal(_bits(out[0]), _bits(want_P))
    assert torch.equal(_bits(out[1]), _bits(want_b))


def _chain(graph, dtype, accumulation="segment"):
    if graph == "matrix":
        rd = bt.RelationData.from_indexed_df(
            synthetic_ratings(300, 200, 12_000, seed=4))
        rd.assign_to_test(0, 1_000, seed=7)
    else:
        rd = fusion_synthetic(300, (("ic50", "target", 40, 6_000),
                                    ("assay", "assay", 60, 4_000)),
                              rank=4)
        rd.assign_to_test("ic50", 500, seed=7)
    return bt.MacauEngine(rd, bt.MacauConfig(
        num_latent=K, burnin=6, psamples=6, verbose=False, dtype=dtype,
        dense_gram=False, accumulation=accumulation,
        bucket_widths=(8, 16, 32), seed=3), device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("graph", ["matrix", "fusion"])
def test_gather_chain_with_and_without_the_maps(graph, dtype):
    """A small gather engine ("segment"): every entity with buckets has a
    map; two runs give the same bits; every row goes through the map once
    a sweep, the overflow span sits in the buckets' span; one sweep from
    the chain's end with the same randoms under "planned" (Lambda in P,
    through the same maps) ends within the rounding of the sums' order."""
    eng = _chain(graph, dtype)
    prob = eng.problem
    n_ent = len(prob.entity_specs)
    assert sorted(prob.dest_maps) == [f"e{i}" for i in range(n_ent)]
    with spans.recording() as rec:
        a = eng.run()
    b = eng.run()
    for x, y in zip(a["state"]["ent"], b["state"]["ent"]):
        assert torch.equal(x["U"], y["U"])
    c = rec.counters
    R = sum(len(ba["inst"]) for v in prob.layouts.values() for ba in v)
    assert (c["assemble_precision.direct_rows"]
            + c["assemble_precision.overflow_rows"]) == 12 * R
    names = [s.name for s in rec.spans]
    ov = [s for s in rec.spans if s.name.endswith(".overflow")]
    assert ov and all(names[s.parent].endswith(".buckets") for s in ov)
    randoms = eng.draw(13)
    seg, _ = eng._sweep_with_randoms(a["state"], randoms, 0.0)
    planned = _chain(graph, dtype, accumulation="planned")
    assert sorted(planned.problem.dest_maps) == sorted(prob.dest_maps)
    with spans.recording() as rec2:
        pl, _ = planned._sweep_with_randoms(a["state"], randoms, 0.0)
    c2 = rec2.counters
    assert (c2["assemble_precision.direct_rows"]
            + c2["assemble_precision.overflow_rows"]) == R
    tol = 1e-12 if dtype == "float64" else 1e-5
    for x, y in zip(pl["ent"], seg["ent"]):
        scale = float(y["U"].abs().max())
        assert float((x["U"] - y["U"]).abs().max()) <= tol * scale
