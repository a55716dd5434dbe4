"""The traced stretch: ``torch.profiler`` over whole dispatch windows, and
its reduction to device time by layer, busy time, idle gaps and the top
device operations.

A device operation belongs to a layer when its name matches one of the
layer's kernel-name patterns (``layers/<layer>.json`` "kernels"), else when
it was launched inside one of the layer's spans: the harness wraps the
engine methods a layer file names ("calls") in ``record_function`` ranges
``bench.<layer>`` for the stretch, and the trace links each launch to its
device operation by correlation id.  What neither claims is unattributed.
"""
from __future__ import annotations

import bisect
import contextlib
import functools
import json
import os
import tempfile
from typing import Dict, List

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime",)
HOST_CATS = ("cpu_op", "user_annotation")
STRETCH = "bench.stretch"


@contextlib.contextmanager
def spans(engine, layers: Dict[str, dict]):
    """Wrap each engine method the layer files name in a
    ``record_function("bench.<layer>")`` range; unwrap on exit."""
    from torch.profiler import record_function
    wrapped = []
    for key, layer in layers.items():
        for name in layer.get("calls", ()):
            fn = getattr(engine, name, None)
            if fn is None:
                continue

            def make(fn=fn, tag=f"bench.{key}"):
                @functools.wraps(fn)
                def call(*a, **k):
                    with record_function(tag):
                        return fn(*a, **k)
                return call
            setattr(engine, name, make())
            wrapped.append(name)
    try:
        yield
    finally:
        for name in wrapped:
            delattr(engine, name)


def profile(run_stretch, device_type: str) -> dict:
    """Run ``run_stretch()`` under ``torch.profiler`` inside a
    ``bench.stretch`` range and return the trace's events."""
    import torch
    from torch.profiler import ProfilerActivity, record_function
    acts = [ProfilerActivity.CPU]
    if device_type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with record_function(STRETCH):
            run_stretch()
            if device_type == "cuda":
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return events


def _merge(intervals: List[tuple]) -> List[list]:
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _match(name: str, layers: Dict[str, dict]):
    for key, layer in layers.items():
        if any(p in name for p in layer.get("kernels", ())):
            return key
    return None


def summarize(events: List[dict], layers: Dict[str, dict]) -> dict:
    """Reduce a trace's events to: ``window_us`` (the stretch on the host
    clock), ``busy_us`` (the union of device operations in it),
    ``layer_us`` (device time by layer and "unattributed"), ``kernel_us``
    ({name: [us, launches]}), ``gaps`` ({host activity: idle us})."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    stretch = [e for e in xs if e.get("name") == STRETCH
               and e.get("cat") == "user_annotation"]
    if not stretch:
        raise RuntimeError("the trace holds no stretch range")
    t0 = float(stretch[0]["ts"])
    t1 = t0 + float(stretch[0]["dur"])
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS
           and t0 <= float(e["ts"]) <= t1]
    launch_ts = {}
    for e in xs:
        if e.get("cat") in LAUNCH_CATS:
            c = (e.get("args") or {}).get("correlation")
            if c is not None:
                launch_ts[c] = float(e["ts"])
    span_iv = {key: sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                           for e in xs if e.get("cat") == "user_annotation"
                           and e.get("name") == f"bench.{key}")
               for key in layers}
    layer_us = {key: 0.0 for key in layers}
    layer_us["unattributed"] = 0.0
    kernel_us: Dict[str, list] = {}
    for e in dev:
        name, dur = e.get("name", "?"), float(e["dur"])
        k = kernel_us.setdefault(name, [0.0, 0])
        k[0] += dur
        k[1] += 1
        key = _match(name, layers)
        if key is None:
            ts = launch_ts.get((e.get("args") or {}).get("correlation"))
            if ts is not None:
                for lk, iv in span_iv.items():
                    i = bisect.bisect_right(iv, (ts, float("inf"))) - 1
                    if i >= 0 and iv[i][0] <= ts <= iv[i][1]:
                        key = lk
                        break
        layer_us[key or "unattributed"] += dur
    busy = _merge([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in dev])
    busy_us = sum(min(b, t1) - max(a, t0) for a, b in busy)
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e.get("name", "?")) for e in xs
                  if e.get("cat") in HOST_CATS
                  and not str(e.get("name", "")).startswith("bench."))
    starts = [h[0] for h in host]
    gaps: Dict[str, float] = {}
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    for a, b in zip(edges[0::2], edges[1::2]):
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        what = "host: between ops (Python)"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(-1, i - 400), -1):
            if host[j][1] >= mid:
                what = host[j][2]
                break
        gaps[what] = gaps.get(what, 0.0) + (b - a)
    return {"window_us": t1 - t0, "busy_us": busy_us, "layer_us": layer_us,
            "kernel_us": kernel_us, "gaps": gaps}


def breakdown(summary: dict) -> dict:
    """The result line's ``breakdown``: the ten device operations that took
    most time and the ten host activities the device waited longest on,
    in seconds."""
    ops = sorted(summary["kernel_us"].items(), key=lambda kv: -kv[1][0])
    gaps = sorted(summary["gaps"].items(), key=lambda kv: -kv[1])
    return {"device_ops": [[n[:160], v[0] * 1e-6] for n, v in ops[:10]],
            "idle_gaps": [[n[:160], us * 1e-6] for n, us in gaps[:10]]}
