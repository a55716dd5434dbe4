"""The Macau cell's float64 reference (``benchmark/reference/macau.py``)
against the port, at a tiny size on the CPU through the benchmark's own
run of ``chembl.k32_dual`` (its family, data generator and limits; the
port's plain kernels): a window's last sweep is ``correct`` for each beta
solver, the reference's beta not depending on the solver; the reference
computed lower in the program's place (``tf32``, ``control``) is not; and
``correct`` is false under each fault of the beta draw, each caught by
the number that judges its stage."""
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402

CELL = "chembl.k32_dual"
SEED = 2 ** 31 + 2718
# fewer compounds than features and F >= 4,096: the planner's dual solve
TINY = dict(n_compounds=300, n_targets=40, n_features=4_096, nnz=6_000,
            n_test=600, feat_per_compound=20)


def _tiny(solver="dual", dtype="float32"):
    """The cell at the tiny size, rank 8, 3 sweeps a window, on the int8
    pair (forced: the tiny relation is under the planner's floor), with
    entity 0's beta by ``solver`` in ``dtype``."""
    def override(cell):
        cell["config"]["data"].update(TINY)
        opts = cell["config"]["options"]
        opts["dtype"] = dtype
        if solver == "ff":
            opts["use_ff"] = True
        else:
            # CG to well under the limits where its dtype allows
            opts.update(beta_solver=solver, cg_tol=1e-9)
        t = cell["traffic"]
        t.update(num_latent=8, sweeps_per_dispatch=3, warm_windows=1,
                 trace_windows=1, solver=solver)
        t["engine"] = {**t["engine"], "dense_gram": True}
    return override


def _run(solver="dual", dtype="float32", **kw):
    return harness.run_cell(CELL, SEED, 0.2, False, device="cpu",
                            override=_tiny(solver, dtype),
                            log=lambda *a: None, **kw)


def _numbers(out):
    return {k: v["value"] for k, v in out["check"].items()}


# CG stops at a relative residual of 1e-5 in float32 (``_solve_beta``), so
# it is held to the limits in float64
@pytest.mark.parametrize("solver, dtype", [
    ("dual", "float32"), ("dual", "float64"), ("cg", "float64"),
    ("ff", "float32"), ("ff", "float64")])
def test_a_port_sweep_agrees_with_the_reference(solver, dtype):
    out = _run(solver, dtype)
    assert out["correct"], _numbers(out)
    assert out["failed"] == 0 and out["attempted"] >= 3
    got = _numbers(out)
    assert got["plan_gap"] == 0.0
    assert {"beta_gap", "lambda_beta_gap", "uhat_gap"} <= set(got)


def test_the_lower_precisions_are_not_correct():
    out = _run(controls=("tf32", "control"))
    assert out["correct"], _numbers(out)
    for q in ("tf32", "control"):
        c = out["controls"][q]
        assert not c["correct"], (q, c)
        # TF32 in the beta draw's products fails its own number
        v = c["numbers"]["beta_gap"]
        assert v["value"] > v["limit"], (q, v)
    # TF32 leaves the count, the start and the plan exact
    tf32 = out["controls"]["tf32"]["numbers"]
    for k in ("count_gap", "init_gap", "plan_gap"):
        assert tf32[k]["value"] == 0.0, k
    # the control's every stage one step lower fails each of these
    control = out["controls"]["control"]["numbers"]
    for k in ("state_gap", "accum_ulps", "init_gap", "beta_gap",
              "lambda_beta_gap", "uhat_gap"):
        assert control[k]["value"] > control[k]["limit"], k


def _dropped(which):
    """The beta draw's right-hand side without its E1 or E2 noise."""
    def hook(eng):
        rhs = eng._beta_rhs

        def dropped(ei, ent, U, e1, e2):
            if which == "e1":
                e1 = torch.zeros_like(e1)
            else:
                e2 = torch.zeros_like(e2)
            return rhs(ei, ent, U, e1, e2)
        eng._beta_rhs = dropped
    return hook


def _lambda_beta_fixed(eng):
    draw = eng._sample_beta

    def fixed(ei, ent, randoms):
        beta, uhat, _, diag = draw(ei, ent, randoms)
        return beta, uhat, ent["lambda_beta"], diag
    eng._sample_beta = fixed


def _uhat_left_out(eng):
    precision = eng._precision

    def without(ei, ent, dense, contribs, uhat=None):
        return precision(ei, ent, dense, contribs, None)
    eng._precision = without


def _previous_beta(eng):
    draw = eng._sample_beta

    def stale(ei, ent, randoms):
        _, _, lam, diag = draw(ei, ent, randoms)
        return ent["beta"], ent["uhat"], lam, diag
    eng._sample_beta = stale


# each fault, and the number that catches it
FAULTS = {"e2_dropped": (_dropped("e2"), "beta_gap"),
          "e1_dropped": (_dropped("e1"), "beta_gap"),
          "lambda_beta_fixed": (_lambda_beta_fixed, "lambda_beta_gap"),
          "uhat_left_out_of_the_prior_mean": (_uhat_left_out, "state_gap"),
          "beta_of_the_previous_sweep": (_previous_beta, "beta_gap")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_beta_draw_is_not_correct(fault):
    hook, number = FAULTS[fault]
    out = _run(fault=hook)
    assert not out["correct"], _numbers(out)
    v = out["check"][number]
    assert v["value"] > v["limit"], (number, v)


def test_a_solver_other_than_the_mix_names_is_not_correct():
    def cg(cell):
        _tiny("cg")(cell)
        cell["traffic"]["solver"] = "dual"
    out = harness.run_cell(CELL, SEED, 0.2, False, device="cpu",
                           override=cg, log=lambda *a: None)
    assert out["check"]["plan_gap"]["value"] == 1.0
    assert not out["correct"]
