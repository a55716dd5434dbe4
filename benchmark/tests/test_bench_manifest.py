"""BENCHMARK.json and the files its names resolve to."""
import json
import os
import re

from _tiny import ROOT

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = harness.manifest(ROOT)
CELLS = [w["name"] for w in MAN["workloads"]]


def test_top_level_keys_and_paths():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w
               for w in MAN["command"])
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_names_and_units():
    names = []
    for sec in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in MAN[sec]:
            assert NAME.match(e["name"]), e["name"]
            names.append((sec in ("end_to_end", "per_layer"), e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    assert len(names) == len(set(names))
    for w in MAN["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and 0 < len(w["why"]) <= 200


def test_every_cell_resolves_to_its_files():
    for cell in CELLS:
        c = harness.resolve(cell, ROOT, MAN)
        plan = c["traffic"]["plan"]
        for path in plan if isinstance(plan, list) else [plan]:
            assert os.path.exists(os.path.join(ROOT, "benchmark", "reference",
                                               "paths", path + ".py")), path
        assert set(c["limits"]) == {"state_gap", "accum_ulps", "count_gap",
                                    "clamp_gap", "init_gap", "plan_gap"}
        gen = os.path.join(ROOT, "benchmark", "data",
                           c["config"]["data"]["generator"] + ".py")
        assert os.path.exists(gen)
        e2e = {m["name"] for m in c["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert c["per_layer"]
        for m in c["per_layer"]:
            assert m["moves"] in e2e, (cell, m["name"])


def test_configs_hold_their_source_and_cuts():
    for e in MAN["configs"]:
        assert e["file"].startswith("benchmark/")
        c = harness.load_json(os.path.join(ROOT, e["file"]))
        assert c["source"] == e["source"] and c["reduced"] == e["reduced"]
        assert os.path.exists(os.path.join(ROOT, c["reference"]))
        assert os.path.exists(os.path.join(ROOT, "benchmark", "families",
                                           c["family"] + ".py"))


def test_each_per_layer_metric_names_its_layer_and_one_mover():
    e2e = {m["name"] for m in MAN["end_to_end"]}
    layers = {harness.load_json(os.path.join(ROOT, "benchmark", "layers",
                                             f))["layer"]
              for f in os.listdir(os.path.join(ROOT, "benchmark", "layers"))}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e and isinstance(m["moves"], str)
        assert m["layer"] and "\n" not in m["layer"]
        assert set(m["workloads"]) <= set(CELLS)
        assert os.path.exists(harness.reader(m["name"], ROOT))
        if m["name"].startswith(("gramian", "sampler")):
            assert m["layer"] in layers


def test_end_to_end_bounds():
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {harness.base_name(m["name"]) for m in MAN["end_to_end"]} == {
        "rows_per_s", "peak_mem_gib", "setup_s"}
    # each cell's rate is one part of rows_per_s, and only one
    for cell in CELLS:
        parts = [m["name"] for m in harness.resolve(cell, ROOT, MAN)[
            "end_to_end"] if m["name"].startswith("rows_per_s")]
        assert len(parts) == 1, (cell, parts)
    json.dumps(MAN)
