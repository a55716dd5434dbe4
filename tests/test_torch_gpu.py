"""Tests of the port that need a CUDA card (marker ``gpu``; they skip
without one).  This file imports neither jax nor the JAX package, so on the
GPU host it runs without the JAX test setup:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

import bayesiandatafusion_jl_tpu_torch as bt
from bayesiandatafusion_jl_tpu_torch.models.datasets import synthetic_ratings
from bayesiandatafusion_jl_tpu_torch.ops import (chol_blocked, chol_full,
                                                 chol_packed, dense_gram)
from bayesiandatafusion_jl_tpu_torch.utils.convert import (state_from_numpy,
                                                           state_to_numpy)
from bayesiandatafusion_jl_tpu_torch.utils.rng import draw_all_numpy
from _torch_xla_order import xla_cpu_ridge_step

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("K, B", [(32, 71_567), (32, 10_681), (8, 1_000),
                                  (40, 1_000), (64, 10_681), (96, 4_000)])
def test_chol_kernel_matches_plain(cuda, K, B):
    """The packed sampler's kernel for K (K1 up to 32, K2 above) against
    its plain version (the check chip_smoke.py runs)."""
    import chip_smoke
    r = chip_smoke.check_chol_kernel(K, B, timing=False)
    assert r["ok"], r


@pytest.mark.parametrize("lam", [True, False])
@pytest.mark.parametrize("K, B", [(32, 71_567), (32, 10_681), (8, 1_000),
                                  (64, 10_681), (96, 4_000), (40, 1_000),
                                  (33, 77)])
def test_full_kernel_matches_plain(cuda, K, B, lam):
    """The gather path's full-P sampler kernel for K (K3 up to 32, K4
    above), with and without Lambda, against its plain version."""
    import chip_smoke
    r = chip_smoke.check_full_kernel(K, B, lam=lam, timing=False)
    assert r["ok"], r


@pytest.mark.parametrize("K, B", [(64, 10_681), (64, 1_000), (20, 333)])
def test_chol_inv_kernel_matches_plain(cuda, K, B):
    """K5 against its plain version, W exactly zero above the diagonal."""
    import chip_smoke
    r = chip_smoke.check_chol_inv(K, B, timing=False)
    assert r["ok"], r


@pytest.mark.parametrize("K, B", [(128, 4_000), (100, 1_000)])
def test_blocked_sampler_matches_plain(cuda, K, B):
    """The blocked sampler on K5 against chol_sample on torch.linalg."""
    import chip_smoke
    r = chip_smoke.check_blocked(K, B, timing=False)
    assert r["ok"], r


def test_int8_contraction_exact(cuda):
    import chip_smoke
    assert all(chip_smoke.check_int8_contraction())


@pytest.mark.parametrize("K, kernel, per_sweep", [
    (8, chol_packed.chol_sample_packed, 2),
    (36, chol_packed.chol_sample_packed_tiled, 2),
    (100, chol_blocked.chol_inv, 4)])
def test_engine_cuda_matches_cpu(cuda, monkeypatch, K, kernel, per_sweep):
    """Three float64 sweeps with injected randoms on the card and on the
    CPU, through K1 (K=8), K2 (K=36) and K5 (K=100, two panels per
    entity).  The int8 products are exact and the rest is float64
    rounding, once the PD ridge's float32 mean is summed in one fixed order
    on both devices (torch's own sum rounds differently on each, which
    moves the chain by ~1e-9)."""
    monkeypatch.setattr(dense_gram, "ridge_step", xla_cpu_ridge_step)
    df = synthetic_ratings(300, 200, 12_000, seed=3)
    engines = {}
    for dev in ("cpu", "cuda"):
        rd = bt.RelationData.from_indexed_df(df)
        rd.assign_to_test(0, 1_000, seed=7)
        cfg = bt.MacauConfig(num_latent=K, dtype="float64", verbose=False,
                             clamp=(1.0, 5.0), seed=4)
        engines[dev] = bt.MacauEngine(rd, cfg, device=dev)
    st = engines["cpu"].init_state()
    states = {"cpu": st, "cuda": state_from_numpy(state_to_numpy(st), cuda,
                                                  torch.float64)}
    rng = np.random.default_rng(1)
    launches = kernel.launches
    for s in range(3):
        randoms = draw_all_numpy(rng, engines["cpu"].problem.random_spec)
        for dev in ("cpu", "cuda"):
            r = {k: torch.from_numpy(v).to(dev) for k, v in randoms.items()}
            states[dev], _ = engines[dev]._sweep_with_randoms(
                states[dev], r, 1.0)
    assert kernel.launches == launches + 3 * per_sweep
    a, b = state_to_numpy(states["cpu"]), state_to_numpy(states["cuda"])
    for ei in range(2):
        for key in ("U", "mu", "Lambda"):
            np.testing.assert_allclose(b["ent"][ei][key], a["ent"][ei][key],
                                       rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("K, accumulation, kernel", [
    (8, "segment", chol_full.chol_sample_full),
    (8, "planned", chol_full.chol_sample_full),
    (36, "segment", chol_full.chol_sample_full_tiled)])
def test_gather_engine_cuda_matches_cpu(cuda, K, accumulation, kernel):
    """The gather path (dense_gram=False, a narrow width ladder so that
    heavy users are chunked), three float64 sweeps with injected randoms
    on the card and on the CPU, through K3 (K=8) and K4 (K=36): two
    launches a sweep, and the chains agree to float64 rounding (the
    card's segment sum adds with atomics, in another order)."""
    df = synthetic_ratings(300, 200, 12_000, seed=3)
    engines = {}
    for dev in ("cpu", "cuda"):
        rd = bt.RelationData.from_indexed_df(df)
        rd.assign_to_test(0, 1_000, seed=7)
        cfg = bt.MacauConfig(num_latent=K, dtype="float64", verbose=False,
                             clamp=(1.0, 5.0), seed=4, dense_gram=False,
                             accumulation=accumulation,
                             bucket_widths=(8, 16, 32, 64))
        engines[dev] = bt.MacauEngine(rd, cfg, device=dev)
    st = engines["cpu"].init_state()
    states = {"cpu": st, "cuda": state_from_numpy(state_to_numpy(st), cuda,
                                                  torch.float64)}
    rng = np.random.default_rng(1)
    launches = kernel.launches
    for s in range(3):
        randoms = draw_all_numpy(rng, engines["cpu"].problem.random_spec)
        for dev in ("cpu", "cuda"):
            r = {k: torch.from_numpy(v).to(dev) for k, v in randoms.items()}
            states[dev], _ = engines[dev]._sweep_with_randoms(
                states[dev], r, 1.0)
    assert kernel.launches == launches + 6
    a, b = state_to_numpy(states["cpu"]), state_to_numpy(states["cuda"])
    for ei in range(2):
        for key in ("U", "mu", "Lambda"):
            np.testing.assert_allclose(b["ent"][ei][key], a["ent"][ei][key],
                                       rtol=1e-9, atol=1e-9)


def test_benchmark_on_cuda(cuda):
    df = synthetic_ratings(2_000, 1_500, 60_000, seed=2)
    rd = bt.RelationData.from_indexed_df(df)
    rd.assign_to_test(0, 5_000, seed=7)
    eng = bt.MacauEngine(rd, bt.MacauConfig(num_latent=16, burnin=5,
                                            psamples=0, clamp=(1, 5),
                                            verbose=False), device="cuda")
    out = eng.benchmark(5, repeats=2)
    assert all(np.isfinite(out["ms_per_sweep"]))
    assert 0.5 < out["metrics"]["r0.rmse_avg"] < 1.5


def test_gather_benchmark_on_default_device(cuda):
    """With no device argument the engine runs on the card: the gather
    path with a bfloat16 gather through benchmark()."""
    df = synthetic_ratings(2_000, 1_500, 60_000, seed=2)
    rd = bt.RelationData.from_indexed_df(df)
    rd.assign_to_test(0, 5_000, seed=7)
    launches = chol_full.chol_sample_full.launches
    eng = bt.MacauEngine(rd, bt.MacauConfig(
        num_latent=16, burnin=5, psamples=0, clamp=(1, 5), verbose=False,
        dense_gram=False, gram_dtype="bfloat16"))
    assert eng.device.type == "cuda"
    out = eng.benchmark(5, repeats=2)
    assert chol_full.chol_sample_full.launches == launches + 2 * 15
    assert all(np.isfinite(out["ms_per_sweep"]))
    assert 0.5 < out["metrics"]["r0.rmse_avg"] < 1.5
