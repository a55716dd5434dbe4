"""The port's blocked full-P sampler (K5 and its panel recursion) and the
full-P dispatch against the JAX package.

The JAX side runs its Pallas kernel in interpret mode on the CPU, as
tests/test_pallas.py does; the port runs its plain torch version (the CUDA
kernel has no CPU mode).  The kernel itself is checked against the plain
version on the card by tests/test_torch_gpu.py and chip_smoke.py.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from bayesiandatafusion_jl_tpu.ops.pallas_chol import (chol_inv_pallas,
                                                       chol_sample_blocked
                                                       as jax_blocked)
from bayesiandatafusion_jl_tpu_torch.ops import chol_blocked, mvn


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(orig, interpret=True))


def _spd(B, K, seed, ridge=2.0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, K, K)) * 0.3
    return A @ A.transpose(0, 2, 1) + ridge * np.eye(K), rng


def test_chol_inv_plain_matches_jax_kernel(interpret_pallas):
    """K=8 with the TPU tile 8 (B=19 pads to 24): W = L^-1, lower
    triangular with exact zeros above the diagonal, float64 to 1e-10."""
    P, _ = _spd(19, 8, seed=3)
    want = np.asarray(chol_inv_pallas(jnp.asarray(P), tile=8))
    before = chol_blocked.chol_inv_plain.calls
    got = chol_blocked.chol_inv(torch.from_numpy(P)).numpy()
    assert chol_blocked.chol_inv_plain.calls == before + 1
    assert got.dtype == np.float64 and got.shape == P.shape
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)
    assert not np.triu(got, 1).any()


def test_chol_sample_blocked_matches_jax(interpret_pallas):
    """K=20 with block=8: 3 panels and the identity K-padding, jitter
    0.25, float64 to 1e-10."""
    B, K = 23, 20
    P, rng = _spd(B, K, seed=4, ridge=3.0)
    b = rng.standard_normal((B, K))
    xi = rng.standard_normal((B, K))
    want = np.asarray(jax_blocked(jnp.asarray(P), jnp.asarray(b),
                                  jnp.asarray(xi), jitter=0.25, block=8,
                                  tile=8))
    before = chol_blocked.chol_inv_plain.calls
    got = chol_blocked.chol_sample_blocked(
        torch.from_numpy(P), torch.from_numpy(b), torch.from_numpy(xi),
        jitter=0.25, block=8).numpy()
    assert chol_blocked.chol_inv_plain.calls == before + 3
    assert got.shape == (B, K)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("K, panels", [(100, 2), (128, 2), (130, 0)])
def test_chol_sample_dispatch_routes(K, panels):
    """96 < K <= 128: Lambda added in place, then the blocked sampler
    (2 panels of 64); above 128: torch.linalg.  Both equal the reference
    chol_sample on P + Lambda to 1e-10 in float64."""
    B = 5
    P, rng = _spd(B, K, seed=K)
    Lam = 0.5 * np.eye(K) + 0.01
    b = rng.standard_normal((B, K))
    xi = rng.standard_normal((B, K))
    want = mvn.chol_sample(torch.from_numpy(P + Lam), torch.from_numpy(b),
                           torch.from_numpy(xi), jitter=0.25).numpy()
    Pt = torch.from_numpy(P.copy())
    before = chol_blocked.chol_inv_plain.calls
    got = mvn.chol_sample_dispatch(Pt, torch.from_numpy(b),
                                   torch.from_numpy(xi),
                                   torch.from_numpy(Lam), 0.25).numpy()
    assert chol_blocked.chol_inv_plain.calls == before + panels
    np.testing.assert_array_equal(Pt.numpy(), P + Lam)    # in place
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


def test_chol_sample_dispatch_leaves_packed_range_to_gather_path():
    """K <= 96 is the gather path's range: the dispatch samples it with the
    full-P samplers (K4 here, tests/test_torch_chol_full.py), not the
    blocked one, and leaves P as it was."""
    K = 96
    P, rng = _spd(2, K, seed=0)
    b = rng.standard_normal((2, K))
    xi = rng.standard_normal((2, K))
    Pt = torch.from_numpy(P.copy())
    before = chol_blocked.chol_inv_plain.calls
    got = mvn.chol_sample_dispatch(Pt, torch.from_numpy(b),
                                   torch.from_numpy(xi),
                                   torch.eye(K, dtype=torch.float64))
    want = mvn.chol_sample(torch.from_numpy(P + np.eye(K)),
                           torch.from_numpy(b), torch.from_numpy(xi))
    assert chol_blocked.chol_inv_plain.calls == before
    np.testing.assert_array_equal(Pt.numpy(), P)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10,
                               atol=1e-10)
