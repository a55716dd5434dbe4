"""The program's side of a Macau cell: one relation between a featured
entity (entity 0, binary side features X [n, F]) and a plain one, the
port's ``MacauEngine`` on one card, its link matrix beta drawn each sweep.

The harness finds this file by the configuration's ``family``.  Its
``run_cell`` joins the beta draw's limits (``limits/<cell>.beta.json``) to
the cell's and hands the run back to the harness with this file's steps
(``families/macau_steps.py``): ``make_data``, ``port_inputs``,
``build_engine``, ``shape``, ``plan``, ``snapshot`` and ``check``, as in
``families/bpmf.py``, whose engine options, engine, sizes and Gramian
plan it takes as they are.
"""
from __future__ import annotations

import os
from typing import Dict, List, Sequence

import torch

from benchmark import harness

HERE = os.path.dirname(os.path.abspath(__file__))
_bpmf = harness.load_module(os.path.join(HERE, "bpmf.py"))
build_engine = _bpmf.build_engine
shape = _bpmf.shape


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, **kw
             ) -> dict:
    """``harness.run_cell`` of the resolved ``cell``, its limits joined by
    the beta draw's."""
    name = cell["workload"]["name"]
    beta = harness.load_json(os.path.join(cell["root"], "benchmark",
                                          "limits", name + ".beta.json"))

    def joined(c):
        c.update(cell, config=dict(cell["config"], family="macau_steps"),
                 limits={**cell["limits"], **beta})
    return harness.run_cell(name, seed, seconds, trace, root=cell["root"],
                            override=joined, **kw)


def make_data(cell: dict, seed: int, device, load) -> dict:
    """The activities split into training and test on the device, and
    entity 0's features, as host arrays, from the seed."""
    p = cell["config"]["data"]
    gen = load("data", p["generator"])
    g = torch.Generator(device=device).manual_seed(int(seed))
    idx, vals, shp, (fr, fc) = gen.generate(p, g, device)
    nnz = vals.numel()
    test = torch.randperm(nnz, generator=g, device=device)[:int(p["n_test"])]
    test = torch.sort(test).values
    keep = torch.ones(nnz, dtype=torch.bool, device=device)
    keep[test] = False

    def host(a):
        return a.to(torch.int32).cpu().numpy()
    return {"train_idx": host(idx[keep]),
            "train_vals": vals[keep].cpu().numpy(),
            "test_idx": host(idx[test]), "test_vals": vals[test].cpu().numpy(),
            "shape": tuple(int(s) for s in shp),
            "feat_rows": host(fr), "feat_cols": host(fc),
            "feat_shape": (int(shp[0]), int(p["n_features"]))}


def port_inputs(cell: dict, data: dict, seed: int):
    from bayesiandatafusion_jl_tpu_torch import (IndexedDF, RelationData,
                                                 SparseBinMatrix)
    p = cell["config"]["data"]
    rd = RelationData.from_matrix(
        IndexedDF(data["train_idx"], data["train_vals"], data["shape"]),
        feat1=SparseBinMatrix(data["feat_rows"], data["feat_cols"],
                              data["feat_shape"]),
        names=tuple(p["entities"]), relation_name=p["relation"],
        class_cut=p.get("class_cut"))
    rd.relations[0].set_test(data["test_idx"], data["test_vals"])
    return rd, _bpmf.engine_config(cell, seed)


def plan(engine) -> List[str]:
    """Each focus mode's Gramian path (``families/bpmf.py``), then entity
    0's beta solver: "dual", "cg" or "ff"."""
    return _bpmf.plan(engine) + [engine.problem.entity_specs[0].solver]


def snapshot(state) -> Dict[str, object]:
    """``families/bpmf.py``'s, with entity 0's beta, uhat and
    lambda_beta."""
    e0 = state["ent"][0]
    return {**_bpmf.snapshot(state),
            **{k: e0[k] for k in ("beta", "uhat", "lambda_beta")}}


def check(ref, cell: dict, data: dict, seed: int, sweep_no: int,
          snap_in: dict, snap_out: dict, prog_init: torch.Tensor,
          paths: Sequence[str], device,
          quants: Sequence[str] = ("stated",)) -> Dict[str, dict]:
    """The numbers that decide ``correct`` for each precision in
    ``quants``, as in ``families/bpmf.py``: the reference's ``compare``
    of sweep ``sweep_no`` followed from ``snap_in``, and ``plan_gap``,
    the focus modes whose planned path is not the mix's ``plan`` and a
    beta solver other than its ``solver``."""
    t = cell["traffic"]
    want = [t["plan"]] * 2 + [t["solver"]]
    plan_gap = float(sum(a != b for a, b in zip(paths, want)))
    K = int(t["num_latent"])
    opts = {"K": K, "burnin": int(t["sweeps_per_dispatch"])
            * int(t["warm_windows"]), **cell["config"]["options"]}
    ratings = ref.Ratings(torch.from_numpy(data["train_idx"]),
                          torch.from_numpy(data["train_vals"]),
                          data["shape"], torch.from_numpy(data["test_idx"]),
                          device)
    feats = ref.Features(torch.from_numpy(data["feat_rows"]),
                         torch.from_numpy(data["feat_cols"]),
                         data["feat_shape"], device)
    ref_out = ref.sweep(ratings, feats, opts, paths[:2], seed, sweep_no,
                        snap_in, snap_out)
    start = ref.rng.initial_factors(seed, list(data["shape"]), K,
                                    float(opts["init_std"]), getattr(
                                        torch, opts["dtype"]), device)
    ref_init = ref.init_sums(start)
    out = {}
    for q in quants:
        if q == "stated":
            judged, judged_init = snap_out, prog_init
        else:
            judged = ref.sweep(ratings, feats, opts, paths[:2], seed,
                               sweep_no, snap_in, snap_out, quant=q)
            judged_init = ref.init_sums(
                [u.to(torch.bfloat16) for u in start] if q == "control"
                else start)
        out[q] = {**ref.compare(judged, ref_out, judged_init, ref_init,
                                opts["clamp"]), "plan_gap": plan_gap}
    return out
