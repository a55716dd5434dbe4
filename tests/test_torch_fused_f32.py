"""A float32 partner table on the fused path, as the card runs it: its
three exact bfloat16 pieces (``ops/fused_pair.split_f32``; h + m + l == t
for every float32 t with |t| >= 2^-110 or t = 0), the contraction of each
piece (K8c/K8d's plain version on a bfloat16 table) and the three sums added
smallest first, against the plain version on the float32 table itself and
against the JAX package's ``fused_pair_pallas`` on it (interpret mode)."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.experimental import pallas as pl

from bayesiandatafusion_jl_tpu.ops.pallas_fused import fused_pair_pallas
from bayesiandatafusion_jl_tpu_torch.ops import fused_pair

# the float32 sums against float64 sums of the same table, relative to the
# largest sum (chip_smoke.FLOAT_TOL["float32"])
F32_TOL = 1e-5
TINY = 2.0 ** -110          # the pieces are exact from here up
F32_MAX = float(np.finfo(np.float32).max)


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(orig, interpret=True))


def _exact(pieces):
    """h + m + l in float64 (exact: three 8-bit significands)."""
    return pieces[2].double() + pieces[1].double() + pieces[0].double()


def _bits(words):
    return np.asarray(words, np.uint32).view(np.float32)


# values where one piece or more is zero, the largest and smallest exact
# magnitudes, the bfloat16 range's edge (a rounded h overflows past it),
# every bit set, and the powers of two between
EDGES = {
    "zeros": [0.0, -0.0],
    "ones": [1.0, -1.0, 1.0 + 2.0 ** -23, -(1.0 + 2.0 ** -23), 1.0 + 2 ** -7],
    "largest": [F32_MAX, -F32_MAX, 2.0 ** 127, -(2.0 ** 127)],
    "bf16_edge": _bits([0x7F7F0000, 0x7F7F7FFF, 0x7F7F8000, 0xFF7FFFFF]),
    "smallest": [TINY, -TINY, TINY * (2 - 2 ** -23), -TINY * 3],
    "all_bits": _bits([0x3FFFFFFF, 0xBFFFFFFF, 0x00FFFFFF + 0x0C000000,
                       0x7F7FFFFF, 0x0C7FFFFF]),
    "powers": [2.0 ** e * s for e in range(-110, 128, 7) for s in (1, -1)],
    "pieces_zero": _bits([0x40490000, 0x40490FDB, 0x40490F00, 0xC0490001]),
}


@pytest.mark.parametrize("name", sorted(EDGES))
def test_split_f32_is_exact_on_edges(name):
    """h + m + l == t in float64, bit for bit, on edge values of both
    signs; three bfloat16 pieces, h carrying t's sign and exponent."""
    t = torch.tensor(np.asarray(EDGES[name], np.float32))
    pieces = fused_pair.split_f32(t)
    assert pieces.dtype == torch.bfloat16
    assert tuple(pieces.shape) == (3, t.numel())
    assert torch.equal(_exact(pieces), t.double())
    assert torch.equal(pieces[0].float(),
                       (t.view(torch.int32) & -65536).view(torch.float32))


@settings(max_examples=200, deadline=None)
@given(words=st.lists(st.integers(0, 2 ** 32 - 1), min_size=1,
                      max_size=64))
def test_split_f32_is_exact_on_random_bits(words):
    """Any finite float32 pattern with |t| >= 2^-110 splits exactly."""
    t = _bits(words)
    t = t[np.isfinite(t) & ((np.abs(t) >= TINY) | (t == 0))]
    t = torch.from_numpy(t.copy())
    assert torch.equal(_exact(fused_pair.split_f32(t)), t.double())


def test_split_f32_below_the_range_loses_under_1e_33():
    """Below 2^-110 the last piece runs out of bfloat16's exponent range:
    the loss is under 1e-33 in absolute value (float32 subnormals too)."""
    rng = np.random.default_rng(3)
    t = (rng.uniform(1, 2, 4_096) * np.exp2(rng.integers(-149, -110, 4_096))
         * rng.choice([-1, 1], 4_096)).astype(np.float32)
    t = torch.from_numpy(t)
    err = (_exact(fused_pair.split_f32(t)) - t.double()).abs().max().item()
    assert 0 < err < 1e-33


def _inputs(n0, n1, true, K, focus_axis, seed, one_sign=False):
    """V8 [n0, n1] (codes -5..5 on 15% of the true extent, zero padding)
    and a float32 table YZT [C + K, n_contract] with spread exponents."""
    rng = np.random.default_rng(seed)
    V8 = np.zeros((n0, n1), np.int8)
    t0, t1 = true
    V8[:t0, :t1] = np.where(rng.random((t0, t1)) < 0.15,
                            rng.integers(-5, 6, (t0, t1)), 0)
    C = K * (K + 1) // 2
    nc = (n1, n0)[focus_axis]
    yz = rng.standard_normal((C + K, nc)) * np.exp2(rng.integers(-6, 7,
                                                                 (C + K, nc)))
    if one_sign:
        yz = np.abs(yz)
    return torch.from_numpy(V8), torch.from_numpy(yz.astype(np.float32))


def _by_pieces(V8, YZT, focus_axis, K, nf, flip_out):
    """The plain contraction of each bfloat16 piece, the three sums added
    smallest first (l, then m, then h)."""
    h, m, l = fused_pair.split_f32(YZT)
    outs = [fused_pair.fused_pair_plain(V8, p.contiguous(), focus_axis, K,
                                        nf, flip_out=flip_out)
            for p in (l, m, h)]
    return tuple((a + b) + c for a, b, c in zip(*outs))


@pytest.mark.parametrize("flip_out", [True, False])
@pytest.mark.parametrize("focus_axis", [0, 1])
@pytest.mark.parametrize("K, one_sign", [(3, False), (8, True), (20, False)])
def test_pieces_match_the_float32_table(K, one_sign, focus_axis, flip_out):
    """The pieces' sums (float32, smallest first) against the plain
    version on the float32 table and against float64 sums of it: within
    F32_TOL of the largest sum, in both layouts and modes."""
    n0, n1, true = 96, 400, (83, 389)
    V8, YZT = _inputs(n0, n1, true, K, focus_axis, 40 + K + focus_axis,
                      one_sign)
    nf = true[focus_axis]
    got = _by_pieces(V8, YZT, focus_axis, K, nf, flip_out)
    f32 = fused_pair.fused_pair_plain(V8, YZT, focus_axis, K, nf,
                                      flip_out=flip_out)
    f64 = fused_pair.fused_pair_plain(V8, YZT.double(), focus_axis, K, nf,
                                      flip_out=flip_out)
    for g, w, e in zip(got, f32, f64):
        assert g.dtype == w.dtype == torch.float32
        assert g.shape == w.shape == e.shape
        top = e.abs().max().item()
        assert (g.double() - e).abs().max().item() <= F32_TOL * top
        assert (g - w).abs().max().item() <= F32_TOL * top


@pytest.mark.parametrize("flip_out", [True, False])
@pytest.mark.parametrize("focus_axis", [0, 1])
def test_pieces_match_pallas(interpret_pallas, focus_axis, flip_out):
    """The pieces' sums against ``fused_pair_pallas`` (interpret mode, the
    float kernels) on the float32 table, the mask and the codes cast to
    float32: within F32_TOL of the largest sum, K = 5."""
    K = 5
    C = K * (K + 1) // 2
    n0, n1, true = 48, 384, (37, 371)
    V8, YZT = _inputs(n0, n1, true, K, focus_axis, 9 + focus_axis)
    nf = true[focus_axis]
    yz = YZT.numpy().T.copy()
    want = fused_pair_pallas(jnp.asarray(V8.numpy()), jnp.asarray(yz),
                             jnp.asarray(yz[:, C:]), focus_axis,
                             flip_out=flip_out)
    got = _by_pieces(V8, YZT, focus_axis, K, nf, flip_out)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float64)
        w = w[:, :nf] if flip_out else w[:nf]
        assert g.shape == w.shape
        top = np.abs(w).max()
        np.testing.assert_allclose(g.double().numpy(), w, rtol=0,
                                   atol=F32_TOL * top)
