"""The port's spans and counters (``utils/spans.py``) on the CPU: off they
enter no ``record_function`` and record nothing; under ``torch.profiler``
a sweep's trace holds the named spans, each in the span the sweep opens it
in, on the packed, full-P, gather, fused and side-information paths and
in the sharded engine; ``recording()`` gives the tree, the sweep numbers
and the counters' changes; and each set-up attribute equals its span's
seconds."""
import json
import math
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

import bayesiandatafusion_jl_tpu_torch as bt
from bayesiandatafusion_jl_tpu_torch import native
from bayesiandatafusion_jl_tpu_torch.models.datasets import synthetic_ratings
from bayesiandatafusion_jl_tpu_torch.parallel.mesh import \
    initialize_distributed
from bayesiandatafusion_jl_tpu_torch.parallel.sharded import \
    ShardedMacauEngine
from bayesiandatafusion_jl_tpu_torch.utils import spans

PACKED = dict(dense_gram=True, dense_int8=True)
MODES = ("bdf.r0m0.dense", "bdf.r0m1.dense")
DRAWS = ("bdf.e0.draw", "bdf.e1.draw")
# (engine options, K, (span, the spans it may open in) the sweep must show)
SWEEP = [("bdf.randoms", "bdf.window"), ("bdf.sweep", "bdf.window"),
         ("bdf.e0.hyper", "bdf.sweep"), ("bdf.e1.hyper", "bdf.sweep"),
         ("bdf.e0.precision", "bdf.sweep"), ("bdf.e1.draw", "bdf.sweep"),
         ("bdf.r0.predict", "bdf.sweep")]
DENSE = [("bdf.r0m0.dense", "bdf.e0.precision"),
         ("bdf.r0m1.dense", "bdf.e1.precision"),
         ("bdf.ytab", MODES), ("bdf.contract", MODES)]
PATHS = {
    "packed": (PACKED, 8, SWEEP + DENSE),
    "full": (PACKED, 100, SWEEP + DENSE + [
        ("bdf.expand", MODES), ("bdf.k5", DRAWS), ("bdf.panels", DRAWS),
        ("bdf.solves", DRAWS)]),
    "gather": (dict(dense_gram=False), 8, SWEEP + [
        ("bdf.e0.buckets", "bdf.e0.precision"),
        ("bdf.e1.buckets", "bdf.e1.precision")]),
    "fused": (dict(dense_fused=True, dense_int8=True), 8, SWEEP + DENSE),
}


def _ratings(n_test=100):
    rd = bt.RelationData.from_indexed_df(synthetic_ratings(60, 40, 1_200))
    rd.assign_to_test(0, n_test, seed=7)
    return rd


def _macau():
    """Side features on entity 0 (the dual solve) and a sampled alpha."""
    rng = np.random.default_rng(3)
    X = (rng.random((60, 90)) < 0.2).astype(np.float64)
    df = synthetic_ratings(60, 40, 1_200)
    rd = bt.RelationData.from_matrix(df, feat1=X)
    rd.assign_to_test(0, 100, seed=7)
    rd.set_precision(0, 2.0, sample=True)
    return rd


def _engine(rd, K=8, **opts):
    cfg = bt.MacauConfig(num_latent=K, burnin=1, psamples=2, verbose=False,
                         seed=5, **opts)
    return bt.MacauEngine(rd, cfg, device="cpu")


def _window(eng, start=0, n=2):
    state, ms = eng._window(eng.init_state(), eng.config.seed, start, n)
    eng._fetch(ms[-1:])
    return state


def _traced_spans(run, tmp_path):
    """The ``bdf.`` ranges of a CPU trace of ``run()``: (name, start,
    end) on the profiler's clock."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    path = os.path.join(str(tmp_path), "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events if e.get("cat") == "user_annotation"
            and e.get("name", "").startswith("bdf.")]


def _opened_in(ranges, i):
    """The name of the innermost range that holds range ``i``, or None."""
    name, a, b = ranges[i]
    outer = [(r[2] - r[1], r[0]) for j, r in enumerate(ranges)
             if j != i and r[1] <= a and b <= r[2]]
    return min(outer)[1] if outer else None


def _assert_nested(ranges, pairs):
    """Each (inner, outer) pair: ``inner`` is in the trace, each of its
    ranges opened in ``outer`` (a name, or a tuple of the names allowed),
    and every name of a tuple holds one."""
    for inner, outer in pairs:
        allowed = (outer,) if isinstance(outer, str) else outer
        idx = [i for i, r in enumerate(ranges) if r[0] == inner]
        assert idx, f"no {inner} range in the trace"
        parents = {_opened_in(ranges, i) for i in idx}
        assert parents == set(allowed), (inner, allowed, parents)


def test_off_enters_no_record_function_and_records_nothing(monkeypatch):
    entered = []

    def counting(*a, **k):
        entered.append(a)
        raise AssertionError("record_function entered with tracing off")
    for mod in (spans, torch.profiler, torch.autograd.profiler):
        monkeypatch.setattr(mod, "record_function", counting)
    eng = _engine(_ratings(), **PACKED)
    before = spans.setup_seconds()
    _window(eng)
    assert entered == []
    assert spans._record is None
    assert spans.setup_seconds() == before
    assert spans.span("bdf.sweep", 1) is spans.span("bdf.fetch")


@pytest.mark.parametrize("path", sorted(PATHS))
def test_profiled_sweep_holds_the_spans_nested(path, tmp_path):
    opts, K, pairs = PATHS[path]
    eng = _engine(_ratings(), K=K, **opts)
    ranges = _traced_spans(lambda: _window(eng), tmp_path)
    _assert_nested(ranges, pairs)
    assert _opened_in(ranges, [r[0] for r in ranges].index(
        "bdf.window")) is None
    if path == "gather":
        assert not {"bdf.ytab", "bdf.contract"} & {r[0] for r in ranges}
    if path != "full":
        assert not {"bdf.expand", "bdf.k5"} & {r[0] for r in ranges}


def test_profiled_macau_sweep_holds_the_beta_and_alpha_spans(tmp_path):
    eng = _engine(_macau(), beta_solver="dual", use_ff=False)
    assert eng.problem.entity_specs[0].solver == "dual"
    ranges = _traced_spans(lambda: _window(eng), tmp_path)
    _assert_nested(ranges, SWEEP + [("bdf.e0.beta", "bdf.sweep"),
                                    ("bdf.beta_rhs", "bdf.e0.beta"),
                                    ("bdf.beta_solve", "bdf.e0.beta"),
                                    ("bdf.lambda_beta", "bdf.e0.beta"),
                                    ("bdf.r0.alpha", "bdf.sweep")])
    names = [r[0] for r in ranges]
    assert "bdf.e1.beta" not in names
    # the dual solve returns X beta itself
    assert "bdf.beta_fwd" not in names
    # the beta draw comes before the hyper draw of its entity
    assert names.index("bdf.e0.beta") < names.index("bdf.e0.hyper")


# per solver: (engine options, the beta draw's spans a sweep, its
# counters a sweep; None: at least one)
BETA = {
    "dual": (dict(beta_solver="dual", use_ff=False),
             {"bdf.beta_rhs": 1, "bdf.beta_solve": 1, "bdf.beta_fwd": 0,
              "bdf.lambda_beta": 1},
             {"dual_solve.calls": 1, "bucketed_spmm.calls": 3,
              "block_cg.calls": 0, "block_cg.iterations": 0,
              "chol_solve.calls": 0}),
    "cg": (dict(beta_solver="cg", use_ff=False),
           {"bdf.beta_rhs": 1, "bdf.beta_solve": 1, "bdf.beta_fwd": 1,
            "bdf.lambda_beta": 1},
           {"dual_solve.calls": 0, "block_cg.calls": 1,
            "block_cg.iterations": None, "chol_solve.calls": 0}),
    "ff": (dict(use_ff=True),
           {"bdf.beta_rhs": 1, "bdf.beta_solve": 1, "bdf.beta_fwd": 1,
            "bdf.lambda_beta": 1},
           {"dual_solve.calls": 0, "block_cg.calls": 0,
            "chol_solve.calls": 1, "bucketed_spmm.calls": 2}),
}


@pytest.mark.parametrize("solver", sorted(BETA))
def test_recording_counts_the_beta_draw_by_solver(solver):
    opts, want_spans, want_counts = BETA[solver]
    eng = _engine(_macau(), **opts)
    assert eng.problem.entity_specs[0].solver == solver
    assert "mv" in eng.problem.feat["e0"]       # the bucketed matvec
    sweeps = 3
    with spans.recording() as rec:
        state, ms = eng._window(eng.init_state(), eng.config.seed, 0, sweeps)
        m = eng._fetch(ms)
    got = {k: rec.counters.get(k, 0) / sweeps
           for k in list(want_spans) + list(want_counts)}
    for k, v in {**want_spans, **want_counts}.items():
        assert got[k] >= 1 if v is None else got[k] == v, (k, got[k])
    if solver == "cg":
        # the iterations counted are those the sweep reports
        assert rec.counters["block_cg.iterations"] == sum(
            x["e0.cg_iters"] for x in m)
        # one rhs pass, two a matvec (the start, each iteration, the
        # exit's true residual) and X beta
        assert rec.counters["bucketed_spmm.calls"] == sum(
            2 * (x["e0.cg_iters"] + 2) + 2 for x in m)
    # the spans nest in the entity's beta span
    names = [s.name for s in rec.spans]
    for sp in rec.spans:
        if sp.name in want_spans:
            assert names[sp.parent] in ("bdf.e0.beta", "bdf.beta_solve")


def test_profiled_sharded_sweep_holds_the_spans(tmp_path):
    initialize_distributed(f"file://{tmp_path}/rdv", 1, 0, device="cpu")
    try:
        cfg = bt.MacauConfig(num_latent=8, burnin=1, psamples=2,
                             verbose=False, seed=5, **PACKED)
        eng = ShardedMacauEngine(_ratings(), cfg, device="cpu")
        ranges = _traced_spans(lambda: _window(eng), tmp_path)
    finally:
        dist.destroy_process_group()
    _assert_nested(ranges, SWEEP + DENSE)


def test_recording_gives_the_tree_sweeps_and_counters():
    from bayesiandatafusion_jl_tpu_torch.ops import pair_contract
    eng = _engine(_ratings(), **PACKED)
    with spans.recording() as rec:
        _window(eng, start=4, n=2)
    first = rec.spans[0]
    assert (first.name, first.parent, first.sweep) == ("bdf.window", -1, 5)
    sweeps = [s for s in rec.spans if s.name == "bdf.sweep"]
    assert [s.sweep for s in sweeps] == [5, 6]
    assert all(rec.spans[s.parent].name == "bdf.window" for s in sweeps)
    for s in rec.spans:
        assert s.end_ns >= s.start_ns
        if s.parent >= 0:
            p = rec.spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
            assert s.sweep == p.sweep or s.name in ("bdf.randoms",
                                                    "bdf.sweep")
    ytabs = [s for s in rec.spans if s.name == "bdf.ytab"]
    assert [rec.spans[rec.spans[s.parent].parent].name for s in ytabs] == [
        "bdf.e0.precision", "bdf.e1.precision"] * 2
    fetch = rec.spans[-1]
    assert (fetch.name, fetch.parent, fetch.sweep) == ("bdf.fetch", -1,
                                                        None)
    c = rec.counters
    assert c["bdf.window"] == 1 and c["bdf.sweep"] == 2
    assert c["bdf.ytab"] == c["bdf.contract"] == 4
    assert c["pair_contract_plain.calls"] == 4
    assert c["ytab_quantize_plain.calls"] == 4
    assert c["chol_sample_packed_plain.calls"] == 4
    assert c["pair_contract.launches"] == 0
    assert c["chol_inv_plain.calls"] == 0
    totals = rec.totals()
    assert totals["bdf.sweep"][0] == 2
    assert totals["bdf.sweep"][1] == pytest.approx(
        sum(s.seconds for s in sweeps))
    # the counters are the registered attributes themselves
    assert spans.counts()["pair_contract.launches"] == \
        pair_contract.pair_contract.launches
    assert "chol_sample_packed_tiled.launches" in spans.counts()
    assert "ytab_quantize.launches" in spans.counts()
    with pytest.raises(RuntimeError, match="already open"):
        with spans.recording(), spans.recording():
            pass


@pytest.mark.parametrize("case", ["pair", "gather_planned",
                                  "gather_segment", "fused", "macau_dual",
                                  "macau_ff"])
def test_setup_attributes_equal_their_spans(case):
    opts = {"pair": PACKED, "gather_planned": dict(
        dense_gram=False, accumulation="planned"),
        "gather_segment": dict(dense_gram=False, accumulation="segment"),
        "fused": dict(dense_fused=True, dense_int8=True),
        "macau_dual": dict(beta_solver="dual", use_ff=False),
        "macau_ff": dict(use_ff=True)}[case]
    rd = _macau() if case.startswith("macau") else _ratings()
    with spans.recording() as rec:
        eng = _engine(rd, **opts)
    prob = eng.problem
    by_name = {}
    for s in rec.spans:
        by_name.setdefault(s.name, []).append(s)
    build, = by_name["bdf.build"]
    assert build.parent == -1 and prob.build_seconds == build.seconds
    plan, = by_name["bdf.build.plan"]
    assert rec.spans[plan.parent] is build
    assert prob.plan.seconds == plan.seconds
    assert prob.layout_seconds == sum(
        s.seconds for s in by_name.get("bdf.build.layouts", []))
    setup = spans.setup_seconds()
    for name, group in by_name.items():
        assert setup[name] == sum(s.seconds for s in group), name
    assert set(setup) == set(by_name)
    expect = {"pair": {"bdf.build.store"},
              "gather_planned": {"bdf.build.layouts", "bdf.build.acc_plan"},
              "gather_segment": {"bdf.build.layouts", "bdf.build.dest_map"},
              "fused": {"bdf.build.store"},
              "macau_dual": {"bdf.build.features", "bdf.build.operand",
                             "bdf.build.gram", "bdf.build.eigh"},
              "macau_ff": {"bdf.build.features", "bdf.build.operand",
                           "bdf.build.ftf"}}[case]
    assert expect <= set(by_name)
    if case.startswith("macau"):
        secs = prob.feat_seconds["e0"]
        assert secs and all(
            secs[k] == by_name[f"bdf.build.{k}"][0].seconds for k in secs)
        feat, = by_name["bdf.build.features"]
        assert all(rec.spans[by_name[f"bdf.build.{k}"][0].parent] is feat
                   for k in secs)


def test_sharded_setup_attributes_equal_their_spans(tmp_path):
    initialize_distributed(f"file://{tmp_path}/rdv", 1, 0, device="cpu")
    try:
        cfg = bt.MacauConfig(num_latent=8, burnin=1, psamples=2,
                             verbose=False, seed=5, dense_gram=False)
        with spans.recording() as rec:
            eng = ShardedMacauEngine(_ratings(), cfg, device="cpu")
    finally:
        dist.destroy_process_group()
    build = [s for s in rec.spans if s.name == "bdf.build"]
    assert len(build) == 1
    assert eng.problem.build_seconds == build[0].seconds
    layouts = [s for s in rec.spans if s.name == "bdf.build.layouts"]
    assert len(layouts) == 2
    assert eng.problem.layout_seconds == sum(s.seconds for s in layouts)


def test_native_build_seconds_equal_their_span(tmp_path):
    out = os.path.join(str(tmp_path), "lib.so")
    with spans.recording() as rec:
        native.build(native.SOURCE, out)
    s, = rec.spans
    assert s.name == "bdf.build.native"
    assert native.build_seconds() == s.seconds
    assert spans.setup_seconds("bdf.build.native") == {
        "bdf.build.native": s.seconds}


def test_timed_measures_with_nothing_listening():
    with spans.timed("bdf.build") as outer:
        with spans.timed("bdf.build.plan") as inner:
            sum(range(1000))
    assert 0 < inner.seconds <= outer.seconds
    assert spans.setup_seconds() == {"bdf.build.plan": inner.seconds,
                                     "bdf.build": outer.seconds}
    assert not math.isnan(outer.seconds)


def test_graphs_run_eagerly_off_the_card_and_replays_advance_counters():
    """Off the card a graphed phase runs its Python every call; a replay's
    captured counter change is added by ``spans.advance``."""
    from bayesiandatafusion_jl_tpu_torch.utils.graphs import Graphs
    calls = []

    def phase(a):
        calls.append(1)
        return (2 * a,)
    g, x = Graphs(), torch.arange(3.0)
    for _ in range(3):
        out, = g("phase", phase, x)
    assert len(calls) == 3 and g.captured() == 0
    assert torch.equal(out, 2 * x)
    before = spans.counts()["dual_solve.calls"]
    spans.advance({"dual_solve.calls": 2})
    assert spans.counts()["dual_solve.calls"] == before + 2
    spans.advance({"dual_solve.calls": -2})
    assert spans.counts()["dual_solve.calls"] == before


@pytest.mark.parametrize("solver", sorted(BETA))
def test_only_a_dual_beta_draw_turns_the_graphs_on(solver):
    """An engine replays its short phases from graphs where a featured
    entity draws beta on the dual solve, and not on CG, FF or without
    side features (their capture stream would cost cuBLAS a workspace)."""
    eng = _engine(_macau(), **BETA[solver][0])
    assert eng.graphs.enabled == (solver == "dual")
    assert not _engine(_ratings(), **PACKED).graphs.enabled
