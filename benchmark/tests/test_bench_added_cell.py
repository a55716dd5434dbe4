"""A cell added as files alone is found and run, with no edit of a file
that is there: a traffic mix, its limits and a manifest entry, in a copy
of the benchmark."""
import json
import os
import shutil

from _tiny import ROOT, quiet, shrink

from benchmark import harness


def test_a_cell_added_by_files_runs(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = harness.manifest(ROOT)
    name = "ml10m.k16_float"
    (root / "benchmark" / "traffic" / "k16_float.json").write_text(
        json.dumps({"why": "added by files", "num_latent": 16,
                    "engine": {"dense_gram": False},
                    "plan": "gather_bfloat16",
                    "sweeps_per_dispatch": 2, "warm_windows": 1,
                    "trace_windows": 1}))
    (root / "benchmark" / "limits" / f"{name}.json").write_text(
        json.dumps({"state_gap": 1e-3, "accum_ulps": 16.0, "count_gap": 0.0,
                    "clamp_gap": 1.0, "init_gap": 0.0, "plan_gap": 0.0}))
    man["workloads"].append({"name": name, "config": "ml10m",
                             "traffic": "k16_float", "chips": 1,
                             "why": "added by files"})
    for m in man["end_to_end"] + man["per_layer"]:
        if m["name"] in ("rows_per_s", "gramian_ms"):
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    cell = harness.resolve(name, str(root))
    assert cell["traffic"]["num_latent"] == 16
    assert [m["name"] for m in cell["per_layer"]] == ["gramian_ms"]

    def tiny(c):
        shrink(name, 16)(c)
        c["traffic"]["sweeps_per_dispatch"] = 2
    out = harness.run_cell(name, 7, 0.1, False, device="cpu",
                           root=str(root), override=tiny, log=quiet)
    assert out["correct"], out["check"]
    assert set(out["metrics"]) == {"rows_per_s", "peak_mem_gib", "setup_s"}
    traced = harness.run_cell(name, 7, 0.1, True, device="cpu",
                              root=str(root), override=tiny, log=quiet)
    assert set(traced["metrics"]) <= {"gramian_ms"}
