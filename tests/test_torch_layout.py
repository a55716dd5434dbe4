"""The port's bucketed layout (ops/layout.py) equals the JAX package's
``build_mode_layout`` array for array, bit for bit: the same buckets, piece
order, observation order and padding."""
import numpy as np
import pytest

from bayesiandatafusion_jl_tpu.ops.layout import \
    build_mode_layout as jax_build_mode_layout
from bayesiandatafusion_jl_tpu_torch.ops.layout import build_mode_layout


def _assert_same(a, b):
    assert (a.n_instances, a.arity, a.nnz, a.padded_nnz) == \
        (b.n_instances, b.arity, b.nnz, b.padded_nnz)
    assert [x.width for x in a.buckets] == [x.width for x in b.buckets]
    for ba, bb in zip(a.buckets, b.buckets):
        for name in ("inst", "val", "mask"):
            x, y = getattr(ba, name), getattr(bb, name)
            assert x.dtype == y.dtype and x.shape == y.shape, name
            assert x.tobytes() == y.tobytes(), name
        assert len(ba.part) == len(bb.part)
        for x, y in zip(ba.part, bb.part):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def _ratings(seed, shape, density, head=0, empty=()):
    """A random 2-ary relation; instance 0 of mode 0 gets ``head`` extra
    observations, and the mode-0 instances in ``empty`` none."""
    rng = np.random.default_rng(seed)
    mask = rng.random(shape) < density
    mask[0, :head] = True
    for i in empty:
        mask[i] = False
    idx = np.stack(np.nonzero(mask), 1)
    idx = idx[rng.permutation(len(idx))]          # unsorted input
    return idx, rng.standard_normal(len(idx))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("row_pad", [1, 8])
@pytest.mark.parametrize("mode", [0, 1])
def test_layout_matches_jax(mode, row_pad, dtype):
    """Both modes, row_pad 1 and 8, float32 and float64; instance 0 has
    more observations than the widest bucket (chunked into several rows)
    and four instances have none."""
    shape = (50, 300)
    idx, vals = _ratings(3, shape, 0.08, head=260, empty=(5, 6, 7, 40))
    widths = (4, 8, 16, 32, 64)
    got = build_mode_layout(idx, vals, mode, shape[mode], widths=widths,
                            row_pad=row_pad, dtype=dtype)
    want = jax_build_mode_layout(idx, vals, mode, shape[mode],
                                 widths=widths, row_pad=row_pad, dtype=dtype)
    _assert_same(got, want)
    if mode == 0:
        head_rows = sum(int((b.inst == 0).sum()) for b in got.buckets
                        if b.width == 64)
        assert head_rows >= 4          # 260+ observations over width 64
    assert all(b.n_rows % row_pad == 0 for b in got.buckets)


def test_layout_bench_ladder_matches_jax():
    """The bench's 25-step width ladder on skewed synthetic ratings, and a
    relation with no observations at all."""
    from bayesiandatafusion_jl_tpu_torch.models.datasets import \
        synthetic_ratings
    df = synthetic_ratings(400, 300, 20_000, seed=4)
    widths = (8, 12, 16, 20, 24, 28, 32, 40, 48, 56, 64, 80, 96, 112, 128,
              160, 192, 224, 256, 320, 384, 512, 768, 1024, 2048)
    for mode in (0, 1):
        got = build_mode_layout(df.idx, df.vals - 3.0, mode, df.shape[mode],
                                widths=widths, row_pad=8)
        want = jax_build_mode_layout(df.idx, df.vals - 3.0, mode,
                                     df.shape[mode], widths=widths,
                                     row_pad=8)
        _assert_same(got, want)
    empty = build_mode_layout(np.zeros((0, 2), np.int32), np.zeros(0), 0, 5)
    assert empty.buckets == [] and empty.padded_nnz == 0
