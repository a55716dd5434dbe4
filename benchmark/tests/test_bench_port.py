"""The whole run on the CPU at a tiny size, the port on its plain kernels:
its last sweep agrees with the reference; the reference one precision step
lower, in the program's place, does not; and a timed path broken
underneath makes ``correct`` false, once for each fault a cell can have
(one card, so no exchange between cards to leave out), as does a plan
other than the one the mix names."""
import pytest

from _tiny import quiet, shrink

from benchmark import harness
from bayesiandatafusion_jl_tpu_torch.models import engine as engine_mod

CELLS = [w["name"] for w in harness.manifest()["workloads"]]
SEED = 2 ** 31 + 12345


def _run(cell, K=8, **kw):
    return harness.run_cell(cell, SEED, 0.2, False, device="cpu",
                            override=shrink(cell, K), log=quiet, **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_port_agrees_and_the_control_does_not(cell):
    out = _run(cell, controls=("tf32", "control"))
    assert out["correct"], out["check"]
    assert out["failed"] == 0 and out["attempted"] >= 3
    control = out["controls"]["control"]
    assert not control["correct"], control
    # the numbers of the output each have their upper reading: the control
    # fails each (the count, the clamp and the plan are exact properties)
    for k in ("state_gap", "accum_ulps", "init_gap"):
        v = control["numbers"][k]
        assert v["value"] > v["limit"], k
    # TF32 in the float32 stages alone moves the state past its limit, and
    # only the state
    assert not out["controls"]["tf32"]["correct"]
    tf32 = out["controls"]["tf32"]["numbers"]
    assert tf32["state_gap"]["value"] > 10 * out["check"]["state_gap"][
        "value"]
    assert tf32["accum_ulps"]["value"] <= 1 and tf32["init_gap"]["value"] == 0
    assert list(out)[-1] == "check"


def test_port_agrees_at_rank_32():
    out = _run("netflix.k32_s8", K=32)
    assert out["correct"], out["check"]


def _unchanged(eng):
    step = eng._sweep_with_randoms

    def frozen(state, randoms, accumulate):
        return state, step(state, randoms, accumulate)[1]
    eng._sweep_with_randoms = frozen


def _half_rows(monkeypatch):
    nw = engine_mod.normal_wishart_update

    def half(S, *a):
        return nw(S[: S.shape[0] // 2], *a)
    monkeypatch.setattr(engine_mod, "normal_wishart_update", half)


def _altered_row(eng):
    draw = eng._draw_rows

    def altered(prec, xi, rows=slice(None)):
        u = draw(prec, xi, rows)
        u[0] += 0.01
        return u
    eng._draw_rows = altered


def _accumulating(every):
    """A hook that makes each sweep accumulate as ``every(accumulate)``
    says, in place of the schedule's."""
    def hook(eng):
        step = eng._sweep_with_randoms

        def sweep(state, randoms, accumulate):
            return step(state, randoms, every(accumulate))
        eng._sweep_with_randoms = sweep
    return hook


def _skipping():
    n = [0]

    def every(accumulate):
        n[0] += 1
        return accumulate if n[0] % 2 else 0.0
    return _accumulating(every)


def _altered_prediction(monkeypatch):
    pt = engine_mod.predict_tuples

    def altered(factors, idx, mean_value):
        p = pt(factors, idx, mean_value)
        if idx.shape[0] == 2_000:           # the test tuples
            p[0] += 0.25
        return p
    monkeypatch.setattr(engine_mod, "predict_tuples", altered)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_rows",
                                   "row_altered", "prediction_altered",
                                   "accumulated_in_burnin",
                                   "accumulation_skips_sweeps"])
@pytest.mark.parametrize("cell", ["ml10m.k32_int8", "netflix.k32_gather"])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    hook = None
    if fault == "state_unchanged":
        hook = _unchanged
    elif fault == "half_the_rows":
        _half_rows(monkeypatch)
    elif fault == "row_altered":
        hook = _altered_row
    elif fault == "accumulated_in_burnin":
        hook = _accumulating(lambda accumulate: 1.0)
    elif fault == "accumulation_skips_sweeps":
        hook = _skipping()
    else:
        _altered_prediction(monkeypatch)
    out = _run(cell, fault=hook)
    assert not out["correct"], out["check"]


@pytest.mark.parametrize("cell", ["ml10m.k32_int8", "netflix.k32_s8"])
def test_a_plan_other_than_the_mix_names_is_not_correct(cell):
    def other(c):
        shrink(cell)(c)
        c["traffic"]["engine"] = {"dense_gram": False}
    out = harness.run_cell(cell, SEED, 0.2, False, device="cpu",
                           override=other, log=quiet)
    assert out["check"]["plan_gap"]["value"] == 2.0
    assert out["check"]["state_gap"]["value"] < 1e-3
    assert not out["correct"]


def test_a_traced_run_reads_its_layers():
    out = harness.run_cell("ml10m.k32_int8", SEED, 0.2, True, device="cpu",
                           override=shrink("ml10m.k32_int8"), log=quiet)
    assert out["correct"]
    m = out["metrics"]
    assert "rows_per_s.host_paced" not in m
    assert m["engine_build_s"]["value"] > 0
    assert 0 < m["sweep_mfu_pct.host_paced"]["value"] < 100
    assert out["device"]["window_s"] > 0 and "breakdown" in out
