"""The program's side of a BPMF cell: one relation between two entities,
the port's ``MacauEngine`` on one card.

The harness finds this file by the configuration's ``family`` and calls:

- ``make_data(cell, seed, device, load)``: the ratings from the seed, by
  the configuration's generator (``data/<generator>.py``), split into
  training and test on the device and handed over as host arrays;
- ``port_inputs(cell, data, seed)`` and ``build_engine(inputs, device)``:
  the port's ``RelationData`` and ``MacauConfig``, then its engine (the
  harness times the build);
- ``shape(cell, data)``: the sizes the per-layer readers count with;
- ``plan(engine)``: the Gramian path the engine planned for each focus
  mode, by the name of the reference's path file;
- ``snapshot(state)``: the part of the engine's state the check reads;
- ``check(...)``: the numbers that decide ``correct``, by the
  configuration's reference (``reference``) on the same raw arrays.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch


def make_data(cell: dict, seed: int, device, load) -> dict:
    """(train idx int32, train vals float64, test idx int32, test vals
    float64, shape) as host arrays, from the seed."""
    p = cell["config"]["data"]
    gen = load("data", p["generator"])
    g = torch.Generator(device=device).manual_seed(int(seed))
    idx, vals, shape = gen.generate(p, g, device)
    nnz = vals.numel()
    test = torch.randperm(nnz, generator=g, device=device)[:int(p["n_test"])]
    test = torch.sort(test).values
    keep = torch.ones(nnz, dtype=torch.bool, device=device)
    keep[test] = False
    return {"train_idx": idx[keep].to(torch.int32).cpu().numpy(),
            "train_vals": vals[keep].cpu().numpy(),
            "test_idx": idx[test].to(torch.int32).cpu().numpy(),
            "test_vals": vals[test].cpu().numpy(),
            "shape": tuple(int(s) for s in shape)}


def engine_config(cell: dict, seed: int):
    """The chain's options: the configuration's, then the mix's rank,
    engine options and windows; burn-in is the warm windows."""
    from bayesiandatafusion_jl_tpu_torch import MacauConfig
    t = cell["traffic"]
    opts = dict(cell["config"]["options"])
    for k in ("clamp", "bucket_widths"):
        if opts.get(k) is not None:
            opts[k] = tuple(opts[k])
    spd = int(t["sweeps_per_dispatch"])
    return MacauConfig(num_latent=int(t["num_latent"]),
                       burnin=spd * int(t["warm_windows"]),
                       psamples=1 << 40, verbose=False, seed=int(seed),
                       sweeps_per_dispatch=spd, metrics_every=spd,
                       **opts, **t.get("engine", {}))


def port_inputs(cell: dict, data: dict, seed: int):
    from bayesiandatafusion_jl_tpu_torch import IndexedDF, RelationData
    rd = RelationData.from_indexed_df(
        IndexedDF(data["train_idx"], data["train_vals"], data["shape"]),
        relation_name="ratings")
    rd.relations[0].set_test(data["test_idx"], data["test_vals"])
    return rd, engine_config(cell, seed)


def build_engine(inputs, device):
    from bayesiandatafusion_jl_tpu_torch import MacauEngine
    rd, cfg = inputs
    return MacauEngine(rd, cfg, device=device)


def shape(cell: dict, data: dict) -> dict:
    return {"n": list(data["shape"]), "nnz": int(data["train_vals"].size),
            "K": int(cell["traffic"]["num_latent"])}


def plan(engine) -> List[str]:
    """Each focus mode's Gramian path: ``<store>_<operand dtype>``: the
    int8 pair ``pair_int8``, the fused s8 store ``fused_int8`` (with
    ``_residual`` where a gather residual goes beside it), a float store
    or the gather path by the dtype its operands take."""
    prob, cfg = engine.problem, engine.config
    kind = prob.kinds[0]
    float_dt = cfg.gram_dtype or cfg.dtype
    out = []
    for mode in range(2):
        if kind == "fused":
            name = "fused_" + ("int8" if prob.fused_i8s[0] else float_dt)
            if prob.residual_nnzs[0]:
                name += "_residual"
        elif kind == "pair" and (0, mode) in prob.dense_plans:
            name = "pair_" + ("int8" if prob.pair_i8s[0] else float_dt)
        else:
            name = "gather_" + float_dt
        out.append(name)
    return out


def snapshot(state) -> Dict[str, object]:
    """The rows, hyperparameters and prediction accumulators of relation
    0, as the engine holds them."""
    return {"U": [e["U"] for e in state["ent"]],
            "mu": [e["mu"] for e in state["ent"]],
            "Lambda": [e["Lambda"] for e in state["ent"]],
            **{k: state["pred"]["r0"][k] for k in ("sum", "sum2", "n")}}


def check(ref, cell: dict, data: dict, seed: int, sweep_no: int,
          snap_in: dict, snap_out: dict, prog_init: torch.Tensor,
          paths: Sequence[str], device,
          quants: Sequence[str] = ("stated",)) -> Dict[str, dict]:
    """The numbers that decide ``correct`` for each precision in
    ``quants`` (``stated`` is the program judged; the others put the
    reference, computed lower, in the program's place): the reference's
    ``compare`` of sweep ``sweep_no`` followed from ``snap_in``, and
    ``plan_gap``, the focus modes whose planned path is not the mix's
    ``plan``.  ``prog_init``: the reference's ``init_sums`` of the
    program's starting rows."""
    t = cell["traffic"]
    want = t["plan"] if isinstance(t["plan"], list) else [t["plan"]] * 2
    plan_gap = float(sum(a != b for a, b in zip(paths, want)))
    K = int(t["num_latent"])
    opts = {"K": K, "burnin": int(t["sweeps_per_dispatch"])
            * int(t["warm_windows"]), **cell["config"]["options"]}
    ratings = ref.Ratings(torch.from_numpy(data["train_idx"]),
                          torch.from_numpy(data["train_vals"]),
                          data["shape"], torch.from_numpy(data["test_idx"]),
                          device)
    ref_out = ref.sweep(ratings, opts, paths, seed, sweep_no, snap_in,
                        snap_out)
    start = ref.rng.initial_factors(seed, list(data["shape"]), K,
                                    float(opts["init_std"]), getattr(
                                        torch, opts["dtype"]), device)
    ref_init = ref.init_sums(start)
    out = {}
    for q in quants:
        if q == "stated":
            judged, judged_init = snap_out, prog_init
        else:
            judged = ref.sweep(ratings, opts, paths, seed, sweep_no,
                               snap_in, snap_out, quant=q)
            judged_init = ref.init_sums(
                [u.to(torch.bfloat16) for u in start] if q == "control"
                else start)
        out[q] = {**ref.compare(judged, ref_out, judged_init, ref_init,
                                opts["clamp"]), "plan_gap": plan_gap}
    return out
