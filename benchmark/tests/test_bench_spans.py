"""The readers of the program's own spans: ``spans.span_us`` on a fixed
event list (each launch under its innermost ``bdf.`` span, and
``trace.summarize`` reading the same with those spans in the trace); the
set-up metric files, None without the program's spans and numbers with
them, in a traced run of the harness; and ``spans.measure``, the split of
one cell by span, at a tiny size on the CPU."""
import copy
import sys

import pytest

from _tiny import quiet, shrink

from benchmark import harness
from benchmark import spans as bench_spans
from benchmark import trace as tr

SEED = 2 ** 31 + 777
SETUP = ("plan_s", "store_build_s", "layout_build_s")


def _x(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _events(with_spans=True):
    """A stretch of 120 us: a ``bench.gramian`` range holding a dense
    contribution with its table and contraction, a hyper draw before it,
    a launch between the spans and one outside every span; each device
    operation 10 us after its launch."""
    ev = [_x(tr.STRETCH, "user_annotation", 0.0, 120.0),
          _x("bench.gramian", "user_annotation", 20.0, 40.0)]
    if with_spans:
        ev += [_x("bdf.window", "user_annotation", 1.0, 95.0),
               _x("bdf.sweep", "user_annotation", 1.5, 89.5),
               _x("bdf.e0.hyper", "user_annotation", 2.0, 10.0),
               _x("bdf.r0m0.dense", "user_annotation", 20.0, 40.0),
               _x("bdf.ytab", "user_annotation", 21.0, 9.0),
               _x("bdf.contract", "user_annotation", 31.0, 20.0)]
    launches = [(3.0, "aten_mm_kernel", 2.0), (5.0, "getrf", 3.0),
                (22.0, "ytab_quant_kernel", 4.0),
                (33.0, "pair_contract_kernel<1>", 12.0),
                (55.0, "index_elementwise", 5.0),
                (70.0, "vectorized_elementwise", 1.0),
                (97.0, "memcpy", 1.0)]
    for c, (ts, name, dur) in enumerate(launches):
        ev.append(_x("cudaLaunchKernel", "cuda_runtime", ts, 1.0, c))
        ev.append(_x(name, "kernel", ts + 10.0, dur, c))
    return ev


def test_span_us_takes_the_innermost_span_at_each_launch():
    got = bench_spans.span_us(_events())
    assert got == {"bdf.e0.hyper": [5.0, 2], "bdf.ytab": [4.0, 1],
                   "bdf.contract": [12.0, 1], "bdf.r0m0.dense": [5.0, 1],
                   "bdf.sweep": [1.0, 1], "(none)": [1.0, 1]}
    assert bench_spans.parts(got, 1) == {
        "hyper_ms": 5e-3, "randoms_ms": 0.0, "predict_ms": 0.0,
        "expand_ms": 0.0}
    # a program without spans: every launch outside
    bare = bench_spans.span_us(_events(with_spans=False))
    assert bare == {"(none)": [28.0, 7]}


def test_two_spans_that_start_together_give_the_inner_one():
    ev = [_x(tr.STRETCH, "user_annotation", 0.0, 50.0),
          _x("bdf.window", "user_annotation", 1.0, 40.0),
          _x("bdf.randoms", "user_annotation", 1.0, 5.0),
          _x("cudaLaunchKernel", "cuda_runtime", 3.0, 1.0, 0),
          _x("philox", "kernel", 4.0, 2.0, 0)]
    assert bench_spans.span_us(ev) == {"bdf.randoms": [2.0, 1]}


def test_summarize_reads_the_same_with_the_programs_spans():
    layers = {"gramian": {"kernels": ["pair_contract_kernel", "ytab_"]},
              "sampler": {"kernels": ["chol_sample"]}}
    bare = tr.summarize(_events(with_spans=False), layers)
    full = tr.summarize(_events(), layers)
    for k in ("window_us", "busy_us", "layer_us", "kernel_us"):
        assert full[k] == bare[k], k
    assert full["layer_us"] == {"gramian": 21.0, "sampler": 0.0,
                                "unattributed": 7.0}
    # the idle gaps name the program's phases where it has them
    assert set(full["gaps"]) >= {"bdf.contract", "bdf.sweep"}
    assert "bdf.sweep" not in bare["gaps"]


@pytest.mark.parametrize("name", SETUP)
def test_setup_metrics_read_nothing_without_the_programs_spans(
        name, monkeypatch):
    reader = harness.load_module(harness.reader(name))
    monkeypatch.setitem(sys.modules,
                        "bayesiandatafusion_jl_tpu_torch.utils.spans", None)
    assert reader.read({}) is None


@pytest.mark.parametrize("name", SETUP)
def test_setup_metrics_read_the_newest_builds_phase(name, monkeypatch):
    from bayesiandatafusion_jl_tpu_torch.utils import spans
    phase = {"plan_s": "bdf.build.plan", "store_build_s": "bdf.build.store",
             "layout_build_s": "bdf.build.layouts"}[name]
    monkeypatch.setattr(spans, "_setup", {"bdf.build": [
        (phase, 0.25), (phase, 0.5), ("bdf.build", 2.0)]})
    reader = harness.load_module(harness.reader(name))
    assert reader.read({}) == 0.75
    monkeypatch.setattr(spans, "_setup", {"bdf.build": [("bdf.build", 2.0)]})
    assert reader.read({}) is None


@pytest.mark.parametrize("cell,found", [
    ("ml10m.k32_int8", {"plan_s", "store_build_s"}),
    ("netflix.k32_gather", {"plan_s", "layout_build_s"})])
def test_a_traced_run_reads_the_setup_spans(cell, found):
    out = harness.run_cell(cell, SEED, 0.2, True, device="cpu",
                           override=shrink(cell), log=quiet)
    assert out["correct"], out["check"]
    m = out["metrics"]
    assert set(SETUP) & set(m) == found
    assert sum(m[k]["value"] for k in found - {"plan_s"}) + m["plan_s"][
        "value"] <= m["engine_build_s"]["value"]
    assert all(m[k]["value"] > 0 and m[k]["unit"] == "s" for k in found)


def test_measure_splits_a_tiny_cell_by_span():
    cell = "ml10m.k32_int8"
    lines = []

    class Log:
        def write(self, s):
            lines.append(s)

        def flush(self):
            pass
    out = bench_spans.measure(cell, SEED, pairs=1, seconds=0.01,
                              device="cpu", override=shrink(cell), log=Log())
    assert len(out["rows_per_s"]["off"]) == len(out["rows_per_s"]["on"]) == 1
    host = out["host_ms"]
    assert {"bdf.sweep", "bdf.randoms", "bdf.e0.hyper", "bdf.ytab",
            "bdf.contract", "bdf.e1.draw", "bdf.r0.predict"} <= set(host)
    assert out["host_ms_a_sweep"] == pytest.approx(
        host["bdf.sweep"][0] + host["bdf.randoms"][0])
    assert host["bdf.sweep"][2] == 1.0 and host["bdf.ytab"][2] == 2.0
    assert all(0 <= v[1] <= v[0] for v in host.values())
    assert out["counters_a_sweep"]["pair_contract_plain.calls"] == 2.0
    assert set(out["parts_ms"]) == set(bench_spans.PARTS)
    assert out["setup_s"]["bdf.build.plan"] > 0
    assert out["gate_us"] > 0 and out["gate_entries_a_sweep"] > 10
    assert any("bdf.sweep" in s for s in lines)
    json_safe = copy.deepcopy(out)
    assert json_safe == out
