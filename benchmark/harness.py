"""The benchmark harness: finds a cell's files by the names in
``BENCHMARK.json``, makes the data from the seed, runs the program's Gibbs
windows, times them, traces a stretch, and decides ``correct`` by the
configuration's float64 reference.

Everything that belongs to one configuration, traffic mix, layer or
per-layer metric is a file of its own, found by name:

- ``configs/<config>.json`` (the manifest's ``file``): the data generator
  and its parameters, the chain's options, the source and the cuts, the
  ``family`` and the ``reference``;
- ``families/<family>.py``: the program's side of a kind of model: its
  data from the generator, its inputs and engine, its plan, the state the
  check reads, and the check itself (a family may also bring its own
  ``run_cell``, as one that spans several cards would);
- the ``reference`` (``reference/<family>.py``): the plain float64 sweep
  and its comparison, with one file a Gramian path under
  ``reference/paths/``;
- ``traffic/<traffic>.json``: rank, engine options, the plan the mix
  expects, windows;
- ``limits/<workload>.json``: the limit of each number ``correct`` compares;
- ``data/<generator>.py``: ``generate(params, generator, device)``;
- ``layers/<layer>.json``: kernel-name patterns and engine calls to span;
- ``metrics/<metric>.py``: ``read(ctx)``, None where it finds nothing (a
  metric ``<quantity>.<part>`` without a file of its own reads with
  ``metrics/<quantity>.py``);
- ``counts/<family>.py``: a kernel family's bytes and operations a sweep.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import sys
import time
from typing import Callable, Dict, Optional, Sequence

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

GIB = float(1 << 30)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str):
    """The Python file at ``path`` as a module (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "bench_" + os.path.basename(path)[:-3].replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def manifest(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def _applies(entry: dict, cell: str, moves_ok=None) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return moves_ok is None or entry.get("moves") in moves_ok


def resolve(workload: str, root: str = ROOT, man: Optional[dict] = None
            ) -> dict:
    """A cell's configuration, traffic, limits and metrics, by name."""
    man = man or manifest(root)
    cells = {w["name"]: w for w in man["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    cfg_entry = {c["name"]: c for c in man["configs"]}[w["config"]]
    bench = os.path.join(root, "benchmark")
    e2e = [m for m in man["end_to_end"] if _applies(m, workload)]
    names = {m["name"] for m in e2e}
    return {
        "workload": w,
        "config": load_json(os.path.join(root, cfg_entry["file"])),
        "traffic": load_json(os.path.join(bench, "traffic",
                                          w["traffic"] + ".json")),
        "limits": load_json(os.path.join(bench, "limits",
                                         workload + ".json")),
        "end_to_end": e2e,
        "per_layer": [m for m in man["per_layer"]
                      if _applies(m, workload, names)],
        "root": root,
    }


def loader(root: str = ROOT) -> Callable:
    """``load(kind, name)``: the module ``benchmark/<kind>/<name>.py``."""
    def load(kind: str, name: str):
        return load_module(os.path.join(root, "benchmark", kind,
                                        name + ".py"))
    return load


def family(cell: dict):
    """The program's side of the cell's configuration:
    ``families/<family>.py``."""
    return loader(cell["root"])("families", cell["config"]["family"])


def reference(cell: dict):
    """The configuration's plain reference, the file its ``reference``
    names."""
    return load_module(os.path.join(cell["root"],
                                    cell["config"]["reference"]))


def base_name(name: str) -> str:
    """A metric's quantity: its name up to the first dot.  One quantity
    is split by the regime of its cells (``rows_per_s`` where the card
    sets the pace, ``rows_per_s.host_paced`` where the host does), each
    part with its own bound or mover, the same arithmetic."""
    return name.split(".")[0]


def reader(name: str, root: str = ROOT) -> str:
    """The file that reads per-layer metric ``name``: its own,
    ``metrics/<name>.py``, else its quantity's, ``metrics/<base>.py``."""
    d = os.path.join(root, "benchmark", "metrics")
    own = os.path.join(d, name + ".py")
    return own if os.path.exists(own) else os.path.join(
        d, base_name(name) + ".py")


def layer_files(root: str = ROOT) -> Dict[str, dict]:
    d = os.path.join(root, "benchmark", "layers")
    return {f[:-5]: load_json(os.path.join(d, f))
            for f in sorted(os.listdir(d)) if f.endswith(".json")}


def count_modules(root: str = ROOT) -> Dict[str, object]:
    d = os.path.join(root, "benchmark", "counts")
    return {f[:-3]: load_module(os.path.join(d, f))
            for f in sorted(os.listdir(d)) if f.endswith(".py")}


def _finite(m: Dict[str, float]) -> bool:
    return all(math.isfinite(v) for v in m.values())


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             root: str = ROOT, override: Optional[Callable] = None,
             fault: Optional[Callable] = None,
             controls: Sequence[str] = (), log=None) -> dict:
    """One run of a cell: the result line's dict plus ``check`` (each
    number compared with its limit) last.

    ``override(cell)`` edits the resolved cell before use (the tests' tiny
    sizes); ``fault(engine)`` breaks the engine under the timed path (the
    tests of ``correct``).  ``controls`` names the reference's lower
    precisions to judge in the program's place as well ("tf32",
    "control"): their numbers and verdicts under ``controls`` (the
    readings that set the limits; ``benchmark/calibrate.py``)."""
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    t_start = time.perf_counter() if t_start is None else t_start
    cell = resolve(workload, root)
    if override is not None:
        override(cell)
    fam = family(cell)
    if hasattr(fam, "run_cell"):
        return fam.run_cell(cell, seed, seconds, trace, device=device,
                            t_start=t_start, fault=fault, controls=controls,
                            log=log)
    import torch
    from benchmark import trace as tr
    t = cell["traffic"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    seed = int(seed)
    data = fam.make_data(cell, seed, dev, loader(root))
    log(f"# data made at {time.perf_counter() - t_start:.3f} s")
    inputs = fam.port_inputs(cell, data, seed)
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    tb = time.perf_counter()
    eng = fam.build_engine(inputs, dev)
    build_s = time.perf_counter() - tb
    del inputs
    paths = fam.plan(eng)
    log(f"# engine built in {build_s:.3f} s; plan {paths}")
    if fault is not None:
        fault(eng)
    state = eng.init_state(torch.Generator(device=dev).manual_seed(seed))
    ref = reference(cell)
    prog_init = ref.init_sums(fam.snapshot(state)["U"])
    spd = int(t["sweeps_per_dispatch"])
    rec = {"last": -1}
    sweep = eng._sweep

    def recording_sweep(st, s, accumulate, sd=None):
        if s == rec["last"]:
            rec["in"] = st
        return sweep(st, s, accumulate, sd)
    eng._sweep = recording_sweep

    s = 0
    for _ in range(int(t["warm_windows"])):
        state, ms = eng._window(state, seed, s, spd)
        eng._fetch(ms[-1:])
        s += spd
    setup_s = time.perf_counter() - t_start
    log(f"# warm at {setup_s:.3f} s (engine built from "
        f"{tb - t_start:.3f} s)")
    n_sw = failed = 0
    t0 = time.perf_counter()
    while True:
        rec["last"] = s + spd - 1
        try:
            state, ms = eng._window(state, seed, s, spd)
            m = eng._fetch(ms[-1:])[0]
        except RuntimeError as exc:
            log(f"# window at sweep {s + 1} raised: {exc}")
            failed += spd
            n_sw += spd
            break
        if not _finite(m):
            failed += spd
        s += spd
        n_sw += spd
        if time.perf_counter() - t0 >= seconds:
            break
    t_win = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    checked = rec["last"] + 1            # the 1-based sweep checked
    summary = None
    if trace and not failed:
        def stretch():
            st, s2 = state, s
            for _ in range(int(t["trace_windows"])):
                st, ms2 = eng._window(st, seed, s2, spd)
                eng._fetch(ms2[-1:])
                s2 += spd
        layers = layer_files(root)
        with tr.spans(eng, layers):
            events = tr.profile(stretch, dev.type)
        summary = tr.summarize(events, layers)
        summary["sweeps"] = int(t["trace_windows"]) * spd
        del events
    snap_in = snap_out = None
    if not failed and "in" in rec:
        snap_in, snap_out = fam.snapshot(rec["in"]), fam.snapshot(state)
    shape = fam.shape(cell, data)
    del eng, state, rec, sweep
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    limits = cell["limits"]
    check = {k: math.inf for k in limits}
    judged = {}
    if snap_out is not None:
        tc = time.perf_counter()
        judged = fam.check(ref, cell, data, seed, checked, snap_in,
                           snap_out, prog_init, paths, dev,
                           ("stated",) + tuple(controls))
        check.update(judged.pop("stated"))
        log(f"# reference check took {time.perf_counter() - tc:.3f} s")
    correct = (failed == 0 and snap_out is not None
               and all(check[k] <= limits[k] for k in limits))

    ctx = {"trace": summary, "timed": {"seconds": t_win, "sweeps": n_sw},
           "shape": shape, "engine_build_s": build_s,
           "peaks": load_json(os.path.join(root, "benchmark", "peaks.json")),
           "counts": count_modules(root)}
    metrics = {}
    if trace:
        for m in cell["per_layer"]:
            v = load_module(reader(m["name"], root)).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        e2e = {"rows_per_s": sum(shape["n"]) * n_sw / t_win,
               "peak_mem_gib": peak / GIB, "setup_s": setup_s}
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": e2e[base_name(m["name"])],
                                  "unit": m["unit"]}
    if cuda:
        device_info = {"platform": "gpu",
                       "kind": torch.cuda.get_device_name(dev),
                       "count": 1, "memory_peak_bytes": int(peak)}
    else:
        device_info = {"platform": "cpu", "kind": "cpu", "count": 1,
                       "memory_peak_bytes": 0}
    out = {"correct": bool(correct), "attempted": n_sw, "failed": failed,
           "metrics": metrics, "device": device_info}
    if summary is not None:
        device_info["busy_s"] = summary["busy_us"] * 1e-6
        device_info["window_s"] = summary["window_us"] * 1e-6
        out["breakdown"] = tr.breakdown(summary)
    if controls:
        out["controls"] = {
            q: {"correct": all(nums[k] <= limits[k] for k in limits),
                "numbers": {k: {"value": nums[k], "limit": limits[k]}
                            for k in limits}}
            for q, nums in judged.items()}
    out["check"] = {k: {"value": check[k], "limit": limits[k]}
                    for k in limits}
    return out
