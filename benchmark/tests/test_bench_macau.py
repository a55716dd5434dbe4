"""The Macau cell, ``chembl.k32_dual``, run tiny on the CPU with the port's
plain kernels: it resolves to its files, its beta draw's limits join the
six, the port's last sweep is ``correct`` with every number beside its
limit, and the reference computed lower in the program's place (``tf32``,
``control``) is not."""
from _tiny import quiet, shrink

from benchmark import harness

CELL = "chembl.k32_dual"
SEED = 2 ** 31 + 4099
BETA = ("beta_gap", "lambda_beta_gap", "uhat_gap")


def test_the_cell_resolves_to_its_files():
    cell = harness.resolve(CELL)
    assert cell["config"]["family"] == "macau"
    assert cell["traffic"]["plan"] == "pair_int8"
    assert cell["traffic"]["solver"] == "dual"
    names = {m["name"] for m in cell["per_layer"]}
    assert {"beta_ms", "features_build_s"} <= names
    beta = harness.load_json(harness.os.path.join(
        cell["root"], "benchmark", "limits", CELL + ".beta.json"))
    assert set(beta) == set(BETA)


def test_the_cell_runs_tiny_and_only_the_port_is_correct():
    out = harness.run_cell(CELL, SEED, 0.2, False, device="cpu",
                           override=shrink(CELL), log=quiet,
                           controls=("tf32", "control"))
    assert out["correct"], out["check"]
    assert out["failed"] == 0 and out["attempted"] >= 3
    assert set(BETA) <= set(out["check"])
    assert out["check"]["plan_gap"]["value"] == 0.0
    for q in ("tf32", "control"):
        c = out["controls"][q]
        assert not c["correct"], (q, c)
        # the beta draw on TF32 fails its own number
        v = c["numbers"]["beta_gap"]
        assert v["value"] > v["limit"], (q, v)
    traced = harness.run_cell(CELL, SEED, 0.2, True, device="cpu",
                              override=shrink(CELL), log=quiet)
    assert traced["correct"]
    assert traced["metrics"]["features_build_s"]["value"] > 0
