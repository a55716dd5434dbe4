#!/usr/bin/env python3
"""The program's own spans, read for the benchmark: the set-up phases that
the per-layer metrics ``plan_s``, ``store_build_s`` and ``layout_build_s``
read (``setup_phase``), the device time of a trace by the innermost
``bdf.`` span open at each launch (``span_us``), and a run of one cell that
splits its sweep by span on both clocks:

    python3 benchmark/spans.py --workload <cell> --seed <n> \
        [--pairs 3] [--seconds 4]

from the root of a checkout, on the card.  It makes the cell's data and
engine as ``harness.run_cell`` does and warms up on the cell's windows;
then ``--pairs`` pairs of stretches of at least ``--seconds`` each, one
with the program's recorder off and one with it on (``recording()``), in
alternating order, the profiler off; then the mix's ``trace_windows``
windows under ``torch.profiler``, with the harness's ``bench.<layer>``
ranges.  It prints the table of host ms a sweep (recorder) and device ms
a sweep (trace) by span on standard error, and as the last line of
standard output one JSON object: the rows/s of each stretch, host ms and
device ms a sweep by span, the layer split of ``trace.summarize``, the
counters a sweep, the set-up phases and the cost of a span with nothing
listening.  ``run.py`` does not run it, and its numbers judge nothing.
"""
from __future__ import annotations

import argparse
import bisect
import json
import os
import re
import sys
import time
import timeit
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

PREFIX = "bdf."
NONE = "(none)"
# the glue's parts, by span name
PARTS = {"hyper_ms": r"bdf\.e\d+\.hyper", "randoms_ms": r"bdf\.randoms",
         "predict_ms": r"bdf\.r\d+\.(alpha|predict)",
         "expand_ms": r"bdf\.expand"}


def setup_phase(name: str) -> Optional[float]:
    """Seconds of the set-up phase ``name`` in the program's newest engine
    build, summed over its entries; None where the program keeps no set-up
    spans or ran no such phase."""
    try:
        from bayesiandatafusion_jl_tpu_torch.utils.spans import setup_seconds
    except ImportError:
        return None
    secs = setup_seconds().get(name)
    return None if secs is None else float(secs)


def span_us(events: List[dict]) -> Dict[str, list]:
    """{span name: [device us, operations]} over the trace's
    ``bench.stretch``: each device operation under the innermost ``bdf.``
    range open on the host when it was launched (tied to its launch by
    correlation id, the rule of ``trace.summarize``); ``(none)`` holds
    those launched outside every span or with no launch found."""
    from benchmark import trace as tr
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    stretch = [e for e in xs if e.get("name") == tr.STRETCH
               and e.get("cat") == "user_annotation"]
    if not stretch:
        raise RuntimeError("the trace holds no stretch range")
    t0 = float(stretch[0]["ts"])
    t1 = t0 + float(stretch[0]["dur"])
    launch_ts = {}
    for e in xs:
        if e.get("cat") in tr.LAUNCH_CATS:
            c = (e.get("args") or {}).get("correlation")
            if c is not None:
                launch_ts[c] = float(e["ts"])
    # by start, the outer of two ranges that start together first
    iv = sorted(((float(e["ts"]), -float(e["dur"]), e["name"]) for e in xs
                 if e.get("cat") == "user_annotation"
                 and str(e.get("name", "")).startswith(PREFIX)))
    starts = [a for a, _, _ in iv]
    out: Dict[str, list] = {}
    for e in xs:
        if e.get("cat") not in tr.DEVICE_CATS or not \
                t0 <= float(e["ts"]) <= t1:
            continue
        what = NONE
        ts = launch_ts.get((e.get("args") or {}).get("correlation"))
        if ts is not None:
            for i in range(bisect.bisect_right(starts, ts) - 1, -1, -1):
                a, neg_dur, name = iv[i]
                if a - neg_dur >= ts:
                    what = name
                    break
        acc = out.setdefault(what, [0.0, 0])
        acc[0] += float(e["dur"])
        acc[1] += 1
    return out


def host_ms(records, sweeps: int) -> Dict[str, list]:
    """{span name: [ms a sweep inside it, of which in no child span,
    entries a sweep]} over the recorded stretches."""
    out: Dict[str, list] = {}
    for rec in records:
        child = [0.0] * len(rec.spans)
        for s in rec.spans:
            if s.parent >= 0:
                child[s.parent] += s.seconds
        for s, c in zip(rec.spans, child):
            acc = out.setdefault(s.name, [0.0, 0.0, 0])
            acc[0] += s.seconds
            acc[1] += s.seconds - c
            acc[2] += 1
    return {k: [v[0] * 1e3 / sweeps, v[1] * 1e3 / sweeps, v[2] / sweeps]
            for k, v in out.items()}


def parts(by_span: Dict[str, list], sweeps: int) -> Dict[str, float]:
    """The glue's parts (``PARTS``), device ms a sweep."""
    return {k: sum(v[0] for name, v in by_span.items()
                   if re.fullmatch(pat, name)) * 1e-3 / sweeps
            for k, pat in PARTS.items()}


def measure(workload: str, seed: int, pairs: int = 3, seconds: float = 4.0,
            device: str = "cuda", override=None, log=None) -> dict:
    """The run the module's docstring describes, on ``device``; returns
    the JSON object.  ``override(cell)`` edits the resolved cell first (the
    tests' tiny sizes)."""
    import torch
    from benchmark import harness
    from benchmark import trace as tr
    from bayesiandatafusion_jl_tpu_torch.utils import spans
    log = log or sys.stderr
    dev = torch.device(device)
    cell = harness.resolve(workload, ROOT)
    if override is not None:
        override(cell)
    fam = harness.family(cell)
    t = cell["traffic"]
    seed = int(seed)
    data = fam.make_data(cell, seed, dev, harness.loader(ROOT))
    rows = sum(fam.shape(cell, data)["n"])
    eng = fam.build_engine(fam.port_inputs(cell, data, seed), dev)
    del data
    spd = int(t["sweeps_per_dispatch"])
    run = {"state": eng.init_state(
        torch.Generator(device=dev).manual_seed(seed)), "s": 0}

    def window():
        run["state"], ms = eng._window(run["state"], seed, run["s"], spd)
        eng._fetch(ms[-1:])
        run["s"] += spd

    def stretch():
        """Windows for at least ``seconds``: (sweeps, seconds)."""
        n, t0 = 0, time.perf_counter()
        while n == 0 or time.perf_counter() - t0 < seconds:
            window()
            n += spd
        return n, time.perf_counter() - t0

    for _ in range(int(t["warm_windows"])):
        window()
    rates: Dict[str, list] = {"off": [], "on": []}
    records, rec_sweeps = [], 0
    for i in range(pairs):
        for side in (("off", "on") if i % 2 == 0 else ("on", "off")):
            if side == "on":
                with spans.recording() as rec:
                    n, secs = stretch()
                records.append(rec)
                rec_sweeps += n
            else:
                n, secs = stretch()
            rates[side].append(rows * n / secs)
    host = host_ms(records, rec_sweeps)
    counters: Dict[str, float] = {}
    for rec in records:
        for k, v in rec.counters.items():
            counters[k] = counters.get(k, 0) + v
    counters = {k: v / rec_sweeps for k, v in counters.items() if v}

    layers = harness.layer_files(ROOT)
    traced = int(t["trace_windows"]) * spd

    def profiled():
        for _ in range(int(t["trace_windows"])):
            window()
    with tr.spans(eng, layers):
        events = tr.profile(profiled, dev.type)
    summary = tr.summarize(events, layers)
    by_span = span_us(events)
    del events

    def gate(ei=0):
        with spans.span(f"bdf.e{ei}.hyper"):
            pass
    gate_us = timeit.timeit(gate, number=200_000) / 200_000 * 1e6
    entries = sum(v for k, v in counters.items() if k.startswith(PREFIX))
    out = {
        "workload": workload, "seed": seed,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "rows_per_s": rates,
        "host_ms_a_sweep": sum(host.get(k, [0.0])[0]
                               for k in ("bdf.randoms", "bdf.sweep")),
        "host_ms": host,
        "device_ms": {k: [v[0] * 1e-3 / traced, v[1] / traced]
                      for k, v in sorted(by_span.items(),
                                         key=lambda kv: -kv[1][0])},
        "parts_ms": parts(by_span, traced),
        "layer_ms": {k: v * 1e-3 / traced
                     for k, v in summary["layer_us"].items()},
        "idle_pct": 100.0 * (1.0 - summary["busy_us"]
                             / summary["window_us"]),
        "traced_ms_a_sweep": summary["window_us"] * 1e-3 / traced,
        "idle_gaps": tr.breakdown(summary)["idle_gaps"],
        "counters_a_sweep": counters,
        "setup_s": spans.setup_seconds(),
        "nvcc_s": spans.setup_seconds("bdf.build.nvcc"),
        "gate_us": gate_us, "gate_entries_a_sweep": entries,
    }
    print(f"# {workload} seed {seed}: rows/s off {rates['off']} on "
          f"{rates['on']}; host ms a sweep {out['host_ms_a_sweep']:.4f}; "
          f"traced {out['traced_ms_a_sweep']:.4f} ms a sweep, idle "
          f"{out['idle_pct']:.2f}%; gate {gate_us:.3f} us x {entries:.1f} "
          f"a sweep", file=log)
    print(f"# {'span':<22} {'host ms':>9} {'self':>9} {'n':>6} "
          f"{'device ms':>10} {'ops':>7}", file=log)
    for name in sorted(set(host) | set(out["device_ms"])):
        h = host.get(name, [0.0, 0.0, 0.0])
        d = out["device_ms"].get(name, [0.0, 0.0])
        print(f"# {name:<22} {h[0]:9.4f} {h[1]:9.4f} {h[2]:6.2f} "
              f"{d[0]:10.4f} {d[1]:7.2f}", file=log)
    log.flush()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    out = measure(args.workload, args.seed, args.pairs, args.seconds)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
