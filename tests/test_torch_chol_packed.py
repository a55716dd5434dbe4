"""The port's packed Cholesky sampler (K1) against the JAX package.

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

from bayesiandatafusion_jl_tpu.ops.pallas_chol import chol_sample_packed \
    as jax_chol_sample_packed
from bayesiandatafusion_jl_tpu_torch.ops import chol_packed, mvn


def _problem(K, B, dtype, seed=5):
    """Packed SPD rows Pp [B, C], Lambda, b and xi, made with numpy."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, K, K)) * 0.3
    P = A @ A.transpose(0, 2, 1)
    iu, ju = np.triu_indices(K)
    Lam = 2 * np.eye(K) + 0.1
    b = rng.standard_normal((B, K))
    xi = rng.standard_normal((B, K))
    return [a.astype(dtype) for a in (P[:, iu, ju], Lam, b, xi, P)]


# float32: the tolerance of tests/test_pallas.py for the same kernel;
# float64: both sides agree to rounding of a K-step recurrence
_TOL = {np.float32: 2e-5, np.float64: 1e-10}


@functools.lru_cache(maxsize=None)
def _jax_samples(K, dtype, transposed):
    """The JAX kernel's samples for ``_problem(K, 37, dtype)`` (interpret
    mode), made once per process: at K=32 each call compiles the unrolled
    kernel anew, ~18 s on a CPU."""
    Pp, Lam, b, xi, _ = _problem(K, 37, dtype)
    if transposed:
        Pp, b = Pp.T.copy(), b.T.copy()
    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        return np.asarray(jax_chol_sample_packed(
            jnp.asarray(Pp), jnp.asarray(b), jnp.asarray(xi),
            jnp.asarray(Lam), jitter=0.25, transposed=transposed))
    finally:
        pl.pallas_call = orig


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("transposed", [True, False])
@pytest.mark.parametrize("K", [8, 32, 1, 17])
def test_chol_packed_plain_matches_jax_kernel(K, transposed, dtype):
    """B=37 is not a multiple of the TPU kernel's tile.  The port runs in
    both layouts.  At K=1 and 8 the JAX kernel runs in the same layout; at
    K=17 and 32 it runs once per dtype in the engine's [C, B] layout, since
    its batch-leading path is the same kernel behind two transposes
    (tests/test_pallas.py:244).  K=1 and 17 are edges of the card kernel
    (one row; the first row past a half-warp's first rows)."""
    B = 37
    Pp, Lam, b, xi, _ = _problem(K, B, dtype)
    if transposed:
        Pp, b = Pp.T.copy(), b.T.copy()
    want = _jax_samples(K, dtype, transposed or K >= 17)
    got = chol_packed.chol_sample_packed(
        torch.from_numpy(Pp), torch.from_numpy(b), torch.from_numpy(xi),
        torch.from_numpy(Lam), jitter=0.25, transposed=transposed).numpy()
    assert got.dtype == dtype and got.shape == (B, K)
    np.testing.assert_allclose(got, want, rtol=_TOL[dtype], atol=_TOL[dtype])


def test_chol_packed_plain_matches_full_reference():
    """The plain packed path equals the unpacked batched reference
    (ops/mvn.chol_sample) on P + Lambda, with a strided [C, B] view."""
    K, B = 6, 29
    Pp, Lam, b, xi, P = _problem(K, B, np.float64, seed=9)
    buf = np.zeros((Pp.shape[1], B + 3))
    buf[:, :B] = Pp.T
    view = torch.from_numpy(buf)[:, :B]           # stride (B + 3, 1)
    before = chol_packed.chol_sample_packed_plain.calls
    got = chol_packed.chol_sample_packed(
        view, torch.from_numpy(b.T.copy()), torch.from_numpy(xi),
        torch.from_numpy(Lam), jitter=0.5)
    assert chol_packed.chol_sample_packed_plain.calls == before + 1
    want = mvn.chol_sample(torch.from_numpy(P + Lam), torch.from_numpy(b),
                           torch.from_numpy(xi), jitter=0.5)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-12)


def test_chol_packed_rejects_mismatched_shapes():
    K, B = 4, 5
    Pp, Lam, b, xi, _ = _problem(K, B, np.float32)
    with pytest.raises(ValueError):
        chol_packed.chol_sample_packed(
            torch.from_numpy(Pp), torch.from_numpy(b), torch.from_numpy(xi),
            torch.from_numpy(Lam), transposed=True)     # Pp is [B, C]


# a build log in ptxas's format (-Xptxas -v) for two entry functions
_PTXAS_LOG = """\
ptxas info    : Compiling entry function 'k_packed' for 'sm_90a'
ptxas info    : Function properties for k_packed
    16 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 48 registers, used 1 barriers
ptxas info    : Compiling entry function 'k_full' for 'sm_90a'
ptxas info    : Function properties for k_full
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 110 registers, used 0 barriers
"""


@pytest.mark.parametrize("name, spilled", [("k_packed", 8), ("k_full", 0)])
def test_sampler_spill_check_reads_build_lines(name, spilled):
    """chip_smoke.py fails when K1 or K3 spills: the spill bytes it reads
    from one kernel's build lines, and none of the other kernel's."""
    import chip_smoke
    from bayesiandatafusion_jl_tpu_torch import kernels
    lines = kernels.ptxas_lines(_PTXAS_LOG, name)
    assert len(lines) == 2
    assert chip_smoke.spills(lines) == spilled
