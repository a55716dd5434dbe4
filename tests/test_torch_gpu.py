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
from bayesiandatafusion_jl_tpu_torch.ops import chol_packed, dense_gram
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


@pytest.mark.parametrize("K, B", [(32, 71_567), (32, 10_681), (8, 1_000)])
def test_chol_kernel_matches_plain(cuda, K, B):
    """The kernel against its plain version at the main path's shapes (the
    check chip_smoke.py runs)."""
    import chip_smoke
    r = chip_smoke.check_chol_kernel(K, B, timing=False)
    assert r["ok"], r


def test_int8_contraction_exact(cuda):
    import chip_smoke
    assert all(chip_smoke.check_int8_contraction())


def test_engine_cuda_matches_cpu(cuda, monkeypatch):
    """Three float64 sweeps with injected randoms on the card and on the
    CPU.  The int8 products are exact and the rest is float64 rounding,
    once the PD ridge's float32 mean is summed in one fixed order on both
    devices (torch's own sum rounds differently on each, which moves the
    chain by ~1e-9)."""
    monkeypatch.setattr(dense_gram, "ridge_step", xla_cpu_ridge_step)
    df = synthetic_ratings(300, 200, 12_000, seed=3)
    engines = {}
    for dev in ("cpu", "cuda"):
        rd = bt.RelationData.from_indexed_df(df)
        rd.assign_to_test(0, 1_000, seed=7)
        cfg = bt.MacauConfig(num_latent=8, dtype="float64", verbose=False,
                             clamp=(1.0, 5.0), seed=4)
        engines[dev] = bt.MacauEngine(rd, cfg, device=dev)
    st = engines["cpu"].init_state()
    states = {"cpu": st, "cuda": state_from_numpy(state_to_numpy(st), cuda,
                                                  torch.float64)}
    rng = np.random.default_rng(1)
    launches = chol_packed.chol_sample_packed.launches
    for s in range(3):
        randoms = draw_all_numpy(rng, engines["cpu"].problem.random_spec)
        for dev in ("cpu", "cuda"):
            r = {k: torch.from_numpy(v).to(dev) for k, v in randoms.items()}
            states[dev], _ = engines[dev]._sweep_with_randoms(
                states[dev], r, 1.0)
    assert chol_packed.chol_sample_packed.launches == launches + 6
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
