"""The yardstick's counts: the model's work a sweep, and the copied kernel
bounds against PERF.md's kernel table (K6 at ML-10M, K = 32; K8a at
Netflix, K = 32)."""
import os

import pytest

from _tiny import ROOT

from benchmark import harness

PEAKS = harness.load_json(os.path.join(ROOT, "benchmark", "peaks.json"))
COUNTS = harness.count_modules(ROOT)
ML10M = (71_567, 10_681)
NETFLIX = (480_189, 17_770)


def _work(shape, nnz, K):
    """W from sweep_mfu_pct's reader: one sweep a second at the peak reads
    W / peak percent."""
    mfu = harness.load_module(os.path.join(ROOT, "benchmark", "metrics",
                                            "sweep_mfu_pct.py"))
    ctx = {"timed": {"seconds": 1.0, "sweeps": 1},
           "shape": {"n": list(shape), "nnz": nnz, "K": K}, "peaks": PEAKS}
    return mfu.read(ctx) / 100.0 * PEAKS["dense_op_s"]


@pytest.mark.parametrize("K, work", [(32, 2.324e10), (128, 3.922e11)])
def test_model_work_at_ml10m(K, work):
    assert _work(ML10M, 10_000_054 - 100_000, K) == pytest.approx(work,
                                                                  rel=1e-3)


def _ms(launch):
    _, nbytes, ops, rate = launch
    return max(nbytes / PEAKS["hbm_bytes_s"], ops / PEAKS[rate]) * 1e3


def test_k6_bounds_match_the_kernel_table():
    ms = [_ms(x) for x in COUNTS["k6"].launches(ML10M, 9_900_054, 32)]
    assert ms == pytest.approx([0.5063, 0.4758], abs=1e-4)


def test_k8a_bounds_match_the_kernel_table():
    ms = [_ms(x) for x in COUNTS["k8a"].launches(NETFLIX, 100_380_507, 32)]
    assert ms == pytest.approx([2.8904, 2.6409], abs=1e-4)


def test_sampler_bounds_follow_the_rank():
    assert COUNTS["k1"].launches(ML10M, 1, 128) == []
    assert COUNTS["k5"].launches(ML10M, 1, 32) == []
    (pats, nbytes, ops, _), = COUNTS["k5"].launches(ML10M, 1, 128)
    assert pats == ("chol_inv",) and nbytes > 0 and ops > 0
