"""K9, the windowed expand: the port's host plan (``build_window_plan``)
and plain version against the JAX package's, bit for bit; the JAX kernel
runs in interpret mode, as tests/test_pallas.py:351 runs it."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from bayesiandatafusion_jl_tpu.ops import pallas_gather as jpg
from bayesiandatafusion_jl_tpu_torch.ops import gather_expand as tge


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(orig, interpret=True))


def _parts(n_table, n_obs, seed, hot=0):
    """Sorted partner ids; the first ``hot`` of them in window 0, which then
    spans several 1024-slot blocks."""
    rng = np.random.default_rng(seed)
    part = rng.integers(0, n_table, n_obs)
    part[:hot] = rng.integers(0, min(128, n_table), hot)
    return np.sort(part).astype(np.int32)


PLANS = {"hot": (512, 5000, 2500), "ragged": (1000, 3001, 0),
         "sparse": (5000, 40, 0), "one": (129, 1, 0), "empty": (300, 0, 0),
         "dense": (256, 9000, 0)}


@pytest.mark.parametrize("case", sorted(PLANS))
def test_window_plan_matches_jax(case):
    """lanes, wmap and slot_of_obs equal the JAX plan's, dtypes included:
    hot windows over several blocks, windows with no observation, a table
    that is not a multiple of 128 rows, no observation at all."""
    n_table, n_obs, hot = PLANS[case]
    part = _parts(n_table, n_obs, 31, hot)
    want = jpg.build_window_plan(part, n_table)
    got = tge.build_window_plan(part, n_table)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="sorted"):
        tge.build_window_plan(np.array([3, 1], np.int32), 10)


@pytest.mark.parametrize("K, dtype", [(8, "float32"), (16, "bfloat16")])
def test_expand_plain_matches_jax_kernel(interpret_pallas, K, dtype):
    """The plain version (on the CPU, through the wrapper) equals the JAX
    kernel's output transposed, bit for bit, and every observation's slot
    holds its partner's row (the plan's hot window spans 3 blocks)."""
    n_table, n_obs = 512, 5000
    part = _parts(n_table, n_obs, 31, 2500)
    lanes, wmap, slot_of = tge.build_window_plan(part, n_table)
    U = np.random.default_rng(K).standard_normal((n_table, K))
    Ut = torch.from_numpy(U).to(getattr(torch, dtype))
    want = np.asarray(jpg.windowed_expand(
        jnp.asarray(Ut.float().numpy().T, getattr(jnp, dtype)),
        jnp.asarray(lanes), jnp.asarray(wmap)).astype(jnp.float32))
    calls = tge.windowed_expand_plain.calls
    got = tge.windowed_expand(Ut, torch.from_numpy(lanes),
                              torch.from_numpy(wmap))
    assert tge.windowed_expand_plain.calls == calls + 1
    assert got.dtype == Ut.dtype and got.shape == (len(wmap) * 1024, K)
    np.testing.assert_array_equal(got.float().numpy(), want.T)
    assert torch.equal(got[torch.from_numpy(slot_of)],
                       Ut[torch.from_numpy(part).long()])


def test_expand_plain_pads_the_table():
    """Rows past a table that is not a multiple of 128 rows read as zeros,
    as from the JAX kernel's zero-padded table; a device without a kernel
    raises."""
    U = torch.arange(1, 301, dtype=torch.float32)[:, None].repeat(1, 4)
    lanes = torch.arange(1024, dtype=torch.int32) % 128
    out = tge.windowed_expand(U, lanes, torch.tensor([2], dtype=torch.int32))
    assert torch.equal(out[:44, 0], torch.arange(257, 301,
                                                 dtype=torch.float32))
    assert not out[44:128].any()
    with pytest.raises(RuntimeError, match="no kernel"):
        tge.windowed_expand(U.to("meta"), lanes.to("meta"),
                            torch.tensor([2], dtype=torch.int32))
