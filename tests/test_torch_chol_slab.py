"""The port's packed column-slab sampler (K2, 32 < K <= 96) and the packed
sampler dispatch against the JAX package.

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

from bayesiandatafusion_jl_tpu.ops import pallas_chol as jax_pallas_chol
from bayesiandatafusion_jl_tpu_torch.ops import chol_packed

_K = 40
_B = 37
# float32: the tolerance of tests/test_pallas.py for the same kernel;
# float64: both sides agree to rounding of a K-step recurrence
_TOL = {np.float32: 3e-5, np.float64: 1e-10}


def _problem(K, B, dtype, seed=7):
    """Packed SPD rows Pp [B, C], Lambda, b and xi, made with numpy."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, K, K)) * 0.2
    P = A @ A.transpose(0, 2, 1)
    iu, ju = np.triu_indices(K)
    Lam = 2 * np.eye(K) + 0.05
    b = rng.standard_normal((B, K))
    xi = rng.standard_normal((B, K))
    return [a.astype(dtype) for a in (P[:, iu, ju], Lam, b, xi)]


@functools.lru_cache(maxsize=None)
def _jax_samples(K, dtype):
    """The JAX kernel's samples for ``_problem(K, _B, dtype)`` in the
    engine's [C, B] layout (interpret mode), made once per process: each
    call compiles the unrolled slab kernel, ~20 s on a CPU.  Its
    batch-leading layout is the same kernel behind two transposes."""
    Pp, Lam, b, xi = _problem(K, _B, dtype)
    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        return np.asarray(jax_pallas_chol.chol_sample_packed_tiled(
            jnp.asarray(Pp.T.copy()), jnp.asarray(b.T.copy()),
            jnp.asarray(xi), jnp.asarray(Lam), jitter=0.25,
            transposed=True))
    finally:
        pl.pallas_call = orig


# K = 40 (ids without K) and K = 33, the first K past K1's register core,
# which the CUDA kernel pads to two 32-wide panels
_TILED_CASES = [
    pytest.param(K, transposed, dtype,
                 id=(f"{transposed}-{dtype.__name__}" if K == _K
                     else f"{K}-{transposed}-{dtype.__name__}"))
    for K in (_K, 33) for transposed in (True, False)
    for dtype in (np.float32, np.float64)]


@pytest.mark.parametrize("K, transposed, dtype", _TILED_CASES)
def test_chol_packed_tiled_plain_matches_jax_kernel(K, transposed, dtype):
    """K=40 and 33, B=37 (not a multiple of the TPU kernel's tile), both
    layouts; the [C, B] layout as a strided view, as the engine passes
    it."""
    Pp, Lam, b, xi = _problem(K, _B, dtype)
    if transposed:
        buf = np.zeros((Pp.shape[1], _B + 5), dtype)
        buf[:, :_B] = Pp.T
        Pp_t, b_t = torch.from_numpy(buf)[:, :_B], torch.from_numpy(
            b.T.copy())
    else:
        Pp_t, b_t = torch.from_numpy(Pp), torch.from_numpy(b)
    before = chol_packed.chol_sample_packed_plain.calls
    got = chol_packed.chol_sample_packed_tiled(
        Pp_t, b_t, torch.from_numpy(xi), torch.from_numpy(Lam), jitter=0.25,
        transposed=transposed).numpy()
    assert chol_packed.chol_sample_packed_plain.calls == before + 1
    assert got.dtype == dtype and got.shape == (_B, K)
    np.testing.assert_allclose(got, _jax_samples(K, dtype),
                               rtol=_TOL[dtype], atol=_TOL[dtype])


@pytest.mark.parametrize("K", [1, 33, 40, 96])
def test_tri_offsets_match_jax(K):
    assert chol_packed.tri_offsets(K) == jax_pallas_chol._tri_offsets(K)
    iu, ju = np.triu_indices(K)
    off = chol_packed.tri_offsets(K)
    # column j of the lower triangle is the contiguous range off[j] + (k - j)
    for j in range(K):
        np.testing.assert_array_equal(iu[off[j]:off[j] + K - j], j)
        np.testing.assert_array_equal(ju[off[j]:off[j] + K - j],
                                      np.arange(j, K))


@pytest.mark.parametrize("K, picked", [(32, "K1"), (33, "K2"), (96, "K2"),
                                       (97, None)])
def test_dispatch_picks_kernel_by_k(K, picked, monkeypatch):
    """K1 up to K=32, K2 up to K=96, and no packed sampler above."""
    seen = []
    for name, tag in (("chol_sample_packed", "K1"),
                      ("chol_sample_packed_tiled", "K2")):
        monkeypatch.setattr(chol_packed, name,
                            lambda *a, _tag=tag, **kw: seen.append(_tag))
    Pp, Lam, b, xi = _problem(K, 3, np.float64)
    args = [torch.from_numpy(a) for a in (Pp, b, xi, Lam)]
    if picked is None:
        with pytest.raises(ValueError, match="no packed sampler"):
            chol_packed.chol_sample_packed_dispatch(*args, transposed=False)
        assert not seen
    else:
        chol_packed.chol_sample_packed_dispatch(*args, transposed=False)
        assert seen == [picked]
