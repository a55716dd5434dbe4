"""The engines' float32 precision (``models/engine.full_float32``): their
build and their windows run with the float32 matmuls in full float32
whatever the caller set, and the caller's setting is theirs again after
each.  On the CPU the cuBLAS switch is only read and written; the card's
test (``tests/test_torch_gpu.py -k tf32``) holds a sweep's bits."""
import pytest
import torch
import torch.distributed as dist

import bayesiandatafusion_jl_tpu_torch as bt
from bayesiandatafusion_jl_tpu_torch.models import engine as engine_mod
from bayesiandatafusion_jl_tpu_torch.models.datasets import synthetic_chembl
from bayesiandatafusion_jl_tpu_torch.parallel.mesh import \
    initialize_distributed
from bayesiandatafusion_jl_tpu_torch.parallel.sharded import \
    ShardedMacauEngine

MM = torch.backends.cuda.matmul


@pytest.fixture
def caller_tf32():
    """The caller turned TF32 on; the process's setting is restored after
    the test."""
    before = MM.fp32_precision
    MM.fp32_precision = "tf32"
    try:
        yield
    finally:
        MM.fp32_precision = before


@pytest.mark.parametrize("setting", ["tf32", "ieee", "none"])
def test_the_switch_restores_the_callers_setting(setting):
    before = MM.fp32_precision
    try:
        MM.fp32_precision = setting
        with engine_mod.full_float32():
            assert MM.fp32_precision == "ieee"
        assert MM.fp32_precision == setting
        with pytest.raises(ValueError):
            with engine_mod.full_float32():
                raise ValueError("a sweep that raises")
        assert MM.fp32_precision == setting
    finally:
        MM.fp32_precision = before


def _problem():
    rd = synthetic_chembl(n_compounds=120, n_targets=20, n_features=600,
                          nnz=1_500, seed=3)
    rd.assign_to_test(0, 100, seed=7)
    cfg = bt.MacauConfig(num_latent=4, burnin=1, psamples=1, verbose=False,
                         seed=5, beta_solver="dual", use_ff=False)
    return rd, cfg


def _seen(monkeypatch, eng_cls, *a, **k):
    """The precision the engine's build and its window's sweeps saw, and
    the caller's after each."""
    seen = []
    plan = engine_mod.plan_gramians

    def planning(*pa, **pk):
        seen.append(("build", MM.fp32_precision))
        return plan(*pa, **pk)
    monkeypatch.setattr(engine_mod, "plan_gramians", planning)
    if eng_cls is ShardedMacauEngine:
        import bayesiandatafusion_jl_tpu_torch.parallel.sharded as sh
        monkeypatch.setattr(sh, "plan_gramians", planning)
    eng = eng_cls(*a, **k)
    seen.append(("after build", MM.fp32_precision))
    sweep = eng._sweep

    def sweeping(*sa, **sk):
        seen.append(("sweep", MM.fp32_precision))
        return sweep(*sa, **sk)
    eng._sweep = sweeping
    state, ms = eng._window(eng.init_state(), 5, 0, 2)
    eng._fetch(ms[-1:])
    seen.append(("after window", MM.fp32_precision))
    return seen


def test_the_engine_pins_full_float32_and_restores(monkeypatch,
                                                   caller_tf32):
    rd, cfg = _problem()
    seen = _seen(monkeypatch, bt.MacauEngine, rd, cfg, device="cpu")
    assert seen == [("build", "ieee"), ("after build", "tf32"),
                    ("sweep", "ieee"), ("sweep", "ieee"),
                    ("after window", "tf32")]


def test_the_sharded_engine_pins_full_float32_and_restores(
        monkeypatch, caller_tf32, tmp_path):
    rd, cfg = _problem()
    initialize_distributed(f"file://{tmp_path}/rdv", 1, 0, device="cpu")
    try:
        seen = _seen(monkeypatch, ShardedMacauEngine, rd, cfg, device="cpu")
    finally:
        dist.destroy_process_group()
    assert seen == [("build", "ieee"), ("after build", "tf32"),
                    ("sweep", "ieee"), ("sweep", "ieee"),
                    ("after window", "tf32")]
