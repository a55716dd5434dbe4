#!/usr/bin/env python3
"""Run one cell of the benchmark on the card and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  It makes the cell's ratings on the card from
the seed, builds the program's engine, warms up on the cell's own windows,
times ``--seconds`` of Gibbs windows, reads the peak memory, with
``--trace 1`` profiles a stretch of whole windows for the per-layer
metrics, then checks the window's last sweep against the float64
reference.  The last line of standard output is one JSON object; the
numbers the check compares end standard error, each beside its limit.
It exits non-zero, printing no result, without enough CUDA cards, or if
JAX or the JAX package was loaded.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

T_NOW = time.perf_counter()


def _process_start() -> float:
    """The process's start on the ``perf_counter`` clock: its age from
    /proc (start ticks against the uptime), else this module's import."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return T_NOW - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return T_NOW


T_START = _process_start()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "bayesiandatafusion_jl_tpu")


def _finite(x):
    """JSON has no infinity: an unbounded reading prints as the largest
    double."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return math.copysign(sys.float_info.max, x) if x == x else \
            sys.float_info.max
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the caches of anything that compiles, at fixed paths in the checkout
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch
    from benchmark import harness
    cell = harness.resolve(args.workload, ROOT)
    chips = int(cell["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {chips} CUDA card(s); found {found}", file=sys.stderr)
        return 2
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), device="cuda", t_start=T_START,
                           root=ROOT)
    loaded = sorted({m.split(".")[0] for m in sys.modules}
                    & set(FORBIDDEN))
    if loaded:
        print(f"the run loaded {', '.join(loaded)}: the benchmark measures "
              f"the PyTorch port alone", file=sys.stderr)
        return 3
    for k, v in out["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
