"""The gather-Gramian kernel's plain version (``ops/gramian.gather_gram``
on CPU tensors) against the torch code ``bucket_gramian`` ran before the
kernel, bit for bit, and the dispatch rule of ``bucket_gramian``: which
path it takes for each device, dtype, K and arity.  The kernel itself runs
only on the card (``tests/test_torch_gpu.py -k gather_gram``)."""
import pytest
import torch

from bayesiandatafusion_jl_tpu_torch.ops import gramian as tgr
from _torch_gather_bucket import gather_bucket

bf16, f32, f64 = torch.bfloat16, torch.float32, torch.float64


def _reference_gramian(partner_factors, part, val, mask, alpha):
    """``bucket_gramian``'s bf16 block and ``_gramian_rows``' alpha product
    as they were before the kernel: (alpha P [rows, K*K], alpha b)."""
    partner_factors = [U.to(bf16) for U in partner_factors]
    K = partner_factors[0].shape[-1]

    def fetch(U, p):
        return U.index_select(0, p.reshape(-1)).view(*p.shape, K)

    z = fetch(partner_factors[0], part[0])
    for U, p in zip(partner_factors[1:], part[1:]):
        z = z * fetch(U, p)
    zm = z * mask[..., None].to(z.dtype)
    v = val.to(z.dtype)
    zm, v = zm.to(val.dtype), v.to(val.dtype)
    P = torch.bmm(zm.mT, zm)
    b = torch.bmm(zm.mT, v[..., None])[..., 0]
    rows = P.shape[0]
    return (torch.mul(P.view(rows, K * K), alpha),
            torch.mul(b, alpha))


# ("plain", K, arity, W, alpha): the plain version at the kernel's K, both
# arities, a narrow, an odd and a chunking-width bucket, alpha a tensor or
# a number
PLAIN = [("plain", K, arity, W, alpha)
         for K in (16, 32, 64) for arity in (2, 3)
         for W, alpha in ((8, 5.0), (12, "tensor"), (40, 0.37))]
# ("dispatch", device, gram_dtype, val dtype, K, arity, kernel?)
DISPATCH = [
    ("dispatch", "cuda", bf16, f32, 32, 2, True),
    ("dispatch", "cuda", bf16, f32, 16, 3, True),
    ("dispatch", "cuda", bf16, f32, 64, 2, True),
    ("dispatch", "cuda", bf16, f32, 48, 3, True),
    ("dispatch", "cpu", bf16, f32, 32, 2, False),
    ("dispatch", "cuda", None, f32, 32, 2, False),
    ("dispatch", "cuda", None, f64, 32, 2, False),
    ("dispatch", "cuda", bf16, f64, 32, 2, False),
    ("dispatch", "cuda", bf16, f32, 8, 2, False),
    ("dispatch", "cuda", bf16, f32, 36, 2, False),
    ("dispatch", "cuda", bf16, f32, 128, 2, False),
    ("dispatch", "cuda", bf16, f32, 32, 4, False),
]
# ("chunks", rows, W, K, gathered bytes a slot, chunks): the packed
# accumulation's row chunks of a bucket, sized by the torch code's [rows,
# W, K] gather block (64 bytes a slot at K = 32 in bfloat16) or, for the
# kernel (0), by the [rows, K, K] Gramian block alone
CHUNKS = [("chunks", 100_000, 2048, 32, 64, 27),
          ("chunks", 100_000, 2048, 32, 0, 1),
          ("chunks", 460_000, 8, 32, 64, 4),
          ("chunks", 460_000, 8, 32, 0, 4),
          ("packed", 40, 256, 32, None, 2)]


@pytest.mark.parametrize("case", PLAIN + DISPATCH + CHUNKS, ids=str)
def test_gather_gram_plain_and_dispatch(case, monkeypatch):
    """``plain``: ``gather_gram`` on CPU tensors runs its plain version
    (counted, no launch), which writes into ``out`` slices the same bits as
    the bf16 block and alpha product of the code before the kernel, and
    ``bucket_gramian`` on the CPU gives them too.  ``dispatch``: the rule
    picks the kernel only for a bfloat16 gather of float32 values on a
    CUDA device at K in {16, 32, 48, 64} and arity 2 or 3, and on the CPU
    ``bucket_gramian`` never calls the kernel's wrapper.  ``chunks``: the
    row chunks ``packed_chunk_rows`` gives.  ``packed``:
    ``packed_bucket_accum`` with the rule taking the kernel (its plain
    version here) sizes its chunks by the Gramian block alone, and sums
    to what the torch code's chunks sum to."""
    if case[0] == "chunks":
        _, rows, W, K, gather_bytes, want = case
        cr = tgr.packed_chunk_rows(rows, W, K, 4, gather_bytes)
        assert -(-rows // cr) == want
        return
    if case[0] == "packed":
        _, rows, W, K, _, want = case
        tables, parts, val, mask = gather_bucket(W, K, 2, rows, 3)
        ba = {"inst": torch.arange(rows, dtype=torch.int32) % 7,
              "part": parts, "val": val, "mask": mask}
        monkeypatch.setattr(tgr, "_PACKED_CHUNK_BYTES", rows * K * K * 2)
        Pt, bt = tgr.packed_bucket_accum([(2.0, tables, ba)], 7, K,
                                         gram_dtype=bf16)
        monkeypatch.setattr(tgr, "gather_gram_takes", lambda *a: True)
        calls = tgr.gather_gram_plain.calls
        Pk, bk = tgr.packed_bucket_accum([(2.0, tables, ba)], 7, K,
                                         gram_dtype=bf16)
        assert tgr.gather_gram_plain.calls == calls + want
        torch.testing.assert_close(Pk, Pt, rtol=1e-6, atol=1e-4)
        torch.testing.assert_close(bk, bt, rtol=1e-6, atol=1e-4)
        return
    if case[0] == "dispatch":
        _, dev, gd, vd, K, arity, want = case
        assert tgr.gather_gram_takes(dev, gd, vd, K, arity) is want
        if dev == "cpu":
            tables, parts, val, mask = gather_bucket(12, K, arity, 20, 1)
            monkeypatch.setattr(tgr, "gather_gram", None)
            P, b = tgr.bucket_gramian(tables, parts, val, mask,
                                      gram_dtype=gd, alpha=2.0)
            Pw, bw = _reference_gramian(tables, parts, val, mask, 2.0)
            assert torch.equal(P.view(Pw.shape), Pw)
            assert torch.equal(b, bw)
        return
    _, K, arity, W, alpha = case
    rows = 37
    tables, parts, val, mask = gather_bucket(W, K, arity, rows, K + W)
    if alpha == "tensor":
        alpha = torch.tensor(2.75, dtype=f32)
    Pw, bw = _reference_gramian(tables, parts, val, mask, alpha)
    calls, launches = tgr.gather_gram_plain.calls, tgr.gather_gram.launches
    P_cat = torch.full((rows + 5, K * K), float("nan"))
    b_cat = torch.full((rows + 5, K), float("nan"))
    out = (P_cat[2:2 + rows], b_cat[2:2 + rows])
    got = tgr.gather_gram(tables, parts, val, mask, alpha=alpha, out=out)
    assert got[0] is out[0] and got[1] is out[1]
    assert tgr.gather_gram_plain.calls == calls + 1
    assert tgr.gather_gram.launches == launches
    assert torch.equal(out[0], Pw) and torch.equal(out[1], bw)
    assert bool(P_cat[:2].isnan().all()) and bool(P_cat[-3:].isnan().all())
    P, b = tgr.bucket_gramian(tables, parts, val, mask, gram_dtype=bf16,
                              alpha=alpha)
    assert P.shape == (rows, K, K)
    assert torch.equal(P.view(rows, K * K), Pw) and torch.equal(b, bw)
