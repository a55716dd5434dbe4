"""The port's full-P samplers of the gather path (ops/chol_full.py: K3 for
K <= 32, K4 for 32 < K <= 96) and the full-P dispatch against the JAX
package.

The JAX side runs its Pallas kernels in interpret mode on the CPU, as
tests/test_pallas.py does; the port runs its plain torch version (the CUDA
kernels have no CPU mode).  The kernels themselves are checked against the
plain version on the card by tests/test_torch_gpu.py and chip_smoke.py.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from bayesiandatafusion_jl_tpu.ops import pallas_chol as jax_pallas_chol
from bayesiandatafusion_jl_tpu_torch.ops import chol_blocked, chol_full, mvn

# float32: the tolerance of tests/test_pallas.py for the same kernels;
# float64: both sides agree to rounding of a K-step recurrence
_TOL = {np.float32: 2e-5, np.float64: 1e-10}


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(orig, interpret=True))


def _problem(K, B, dtype, seed=7):
    """SPD rows P [B, K, K], Lambda, b and xi, made with numpy."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, K, K)) * 0.3
    P = A @ A.transpose(0, 2, 1) + np.eye(K)
    Lam = 2 * np.eye(K) + 0.05
    b = rng.standard_normal((B, K))
    xi = rng.standard_normal((B, K))
    return [a.astype(dtype) for a in (P, Lam, b, xi)]


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


_LAM_JITTER = [(False, 0.0), (True, 0.0), (True, 0.25), (False, 0.5)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize(
    "K, lam, jitter", [(K, *lj) for K in (8, 1, 17) for lj in _LAM_JITTER],
    ids=[("" if K == 8 else f"K{K}-") + f"{lam}-{jitter}"
         for K in (8, 1, 17) for lam, jitter in _LAM_JITTER])
def test_chol_sample_full_plain_matches_jax_kernel(interpret_pallas, K,
                                                   dtype, lam, jitter):
    """K3: K=8 and the card kernel's edges K=1 and 17, B=37 (no multiple
    of the TPU kernel's tile), Lambda added in registers or absent, with
    and without jitter."""
    B = 37
    P, Lam, b, xi = _problem(K, B, dtype)
    want = np.asarray(jax_pallas_chol.chol_sample_pallas(
        jnp.asarray(P), jnp.asarray(b), jnp.asarray(xi), jitter=jitter,
        tile=16, Lambda=jnp.asarray(Lam) if lam else None))
    before = chol_full.chol_sample_full_plain.calls
    Pt, Lt, bt, xt = _t(P, Lam, b, xi)
    got = chol_full.chol_sample_full(Pt, bt, xt, Lt if lam else None,
                                     jitter).numpy()
    assert chol_full.chol_sample_full_plain.calls == before + 1
    assert got.dtype == dtype and got.shape == (B, K)
    np.testing.assert_allclose(got, want, rtol=_TOL[dtype],
                               atol=_TOL[dtype])


@functools.lru_cache(maxsize=None)
def _jax_tiled(K, B, dtype, jitter):
    """The JAX slab kernel's samples for ``_problem(K, B, dtype)`` with
    Lambda added before the kernel, as the JAX dispatch does (interpret
    mode; K=33 compiles the unrolled slab kernel for ~10 s)."""
    P, Lam, b, xi = _problem(K, B, dtype, seed=K)
    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        return np.asarray(jax_pallas_chol.chol_sample_pallas_tiled(
            jnp.asarray(P + Lam), jnp.asarray(b), jnp.asarray(xi),
            jitter=jitter, tile=8))
    finally:
        pl.pallas_call = orig


@pytest.mark.parametrize("K, B, dtype", [(12, 20, np.float32),
                                         (12, 20, np.float64),
                                         (33, 11, np.float64),
                                         (33, 11, np.float32)])
def test_chol_sample_full_tiled_plain_matches_jax_kernel(K, B, dtype):
    """K4: K=12 (the JAX test's size) in both dtypes and K=33 (the first
    K of its range, which the CUDA kernel pads to two 32-wide panels) in
    both; B is no multiple of the tile."""
    want = _jax_tiled(K, B, dtype, 0.25)
    P, Lam, b, xi = _problem(K, B, dtype, seed=K)
    before = chol_full.chol_sample_full_plain.calls
    got = chol_full.chol_sample_full_tiled(*_t(P, b, xi), _t(Lam)[0],
                                           0.25).numpy()
    assert chol_full.chol_sample_full_plain.calls == before + 1
    np.testing.assert_allclose(got, want, rtol=_TOL[dtype],
                               atol=_TOL[dtype])


@pytest.mark.parametrize("K, sampler", [
    (8, "chol_sample_full"), (32, "chol_sample_full"),
    (33, "chol_sample_full_tiled"), (96, "chol_sample_full_tiled")])
def test_chol_sample_dispatch_routes_full(monkeypatch, K, sampler):
    """K <= 32 goes to K3 and 32 < K <= 96 to K4, Lambda handed through
    (P is left as it is); both equal the reference chol_sample on
    P + Lambda to 1e-10 in float64."""
    B = 5
    P, Lam, b, xi = _problem(K, B, np.float64, seed=K)
    seen = []
    fn = getattr(chol_full, sampler)

    def spy(*a, **kw):
        seen.append(sampler)
        return fn(*a, **kw)
    monkeypatch.setattr(mvn, sampler, spy)
    Pt, Lt, bt, xt = _t(P, Lam, b, xi)
    inv_before = chol_blocked.chol_inv_plain.calls
    got = mvn.chol_sample_dispatch(Pt, bt, xt, Lt, 0.25).numpy()
    want = mvn.chol_sample(*_t(P + Lam, b, xi), jitter=0.25).numpy()
    assert seen == [sampler]
    assert chol_blocked.chol_inv_plain.calls == inv_before
    np.testing.assert_array_equal(Pt.numpy(), P)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)
    # without Lambda: the sampler draws from P alone
    got0 = mvn.chol_sample_dispatch(Pt, bt, xt, None, 0.25).numpy()
    want0 = mvn.chol_sample(*_t(P, b, xi), jitter=0.25).numpy()
    np.testing.assert_allclose(got0, want0, rtol=1e-10, atol=1e-10)
