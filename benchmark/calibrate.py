#!/usr/bin/env python3
"""The readings that set a cell's limits, on the card at the cell's size:

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,13 \
        --seconds 2

For each seed, one run of the cell (a short window) whose last sweep is
judged against the float64 reference three times: the program's (the
lower readings), and in the program's place the reference's own with its
float32 matrix stages on TF32 (``tf32``) and with every stage one
precision step lower (``control``): the upper readings.  One JSON line a
seed on standard output.  The benchmark's runs never run the controls.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    os.environ["USE_FLAX"] = "0"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch
    from benchmark import harness
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    for seed in (int(x) for x in args.seeds.split(",")):
        out = harness.run_cell(args.workload, seed, args.seconds, False,
                               device="cuda", controls=("tf32", "control"),
                               root=ROOT)
        line = {"workload": args.workload, "seed": seed,
                "correct": out["correct"],
                "program": {k: v["value"] for k, v in out["check"].items()}}
        for q, c in out["controls"].items():
            line[q + "_correct"] = c["correct"]
            line[q] = {k: v["value"] for k, v in c["numbers"].items()}
        line["metrics"] = {k: v["value"] for k, v in out["metrics"].items()}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
