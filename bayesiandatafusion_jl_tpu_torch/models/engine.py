"""The Gibbs sweep engine, ``macau()`` — port of the JAX package's
``models/engine.py``.

The graphs this port covers: any set of relations without side features,
of any arity, over shared entities (an entity may fill several modes of one
relation, or none), with fixed or sampled noise precision alpha, at any
K.  Each relation takes one Gramian path:

- the dense pair (``dense_gram`` None or True; ops/dense_gram.py): the
  int8 pair, contracted by K6 (ops/pair_contract.py) against the partner
  table K7 quantizes each sweep (``dense_int8`` and the int32 bound
  ``int8_pair_ok``; at arity 3 K6 takes the largest partner and a float
  step the others), or the float pair on ``torch.matmul`` otherwise;
- the fused sparse regime (``dense_fused=True``, 2-ary relations the
  planner encodes): one stored int8 value array, contracted per mode by
  K8 (ops/fused_pair.py) against the partner table, which K7 (ops/ytab.py)
  quantizes each sweep on the s8 path (``dense_int8`` and the int32 bound
  ``fused_int8_ok``) and which is a float table in ``gram_dtype``
  otherwise.  Observations the one array cannot hold (a second rating of a
  cell, the zero-code level) ride the gather path as an exact-valued
  residual beside it;
- the bucketed gather path (``dense_gram=False``, or a relation without
  observations; ops/layout.py and ops/gramian.py), with ``accumulation``
  "segment" or "planned".

Each sweep, for each entity in turn:

  (mu, Lambda) <- Normal-Wishart draw from U                 (ops/hyper.py)
  P, b         <- alpha-scaled Gramians of the partner factors over the
                  entity's observations in every (relation, mode) it fills,
                  plus the prior term Lambda mu
  U            <- u ~ N(P'^-1 b, P'^-1) per row, P' = P + Lambda

then each sampled alpha is drawn from its relation's training residuals,
and the test tuples of every relation are predicted (clamped per sample)
and its posterior mean and RMSEs updated.

The sampler branches as the JAX engine does (engine.py:821, :924-951): an
entity with a dense contribution keeps P packed up to K = 96 under
"segment" accumulation ([K(K+1)/2, N], ops/chol_packed.py: the K1 kernel
up to K = 32, K2 above; its gather buckets are accumulated in that layout).
Otherwise P is a full [N, K, K] (dense contributions expanded, buckets
through ``assemble_precision``) for ops/mvn.chol_sample_dispatch: the K3
kernel up to K = 32, K4 up to 96, the blocked sampler on K5 up to 128.
With "segment" accumulation Lambda is left out of P and added by the
sampler; with "planned" it is in the accumulator.  Options outside the
port raise ``NotImplementedError`` naming their ROADMAP item.

State is a plain dict of tensors with the JAX engine's keys
(``utils/convert.py`` carries one across).  Randoms come from
``utils/rng.draw_all``, or are injected through ``_sweep_with_randoms``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import dense_gram as dg
from ..ops.chol_packed import K2_MAX_K, chol_sample_packed_dispatch
from ..ops.gramian import (assemble_precision, assemble_precision_planned,
                           packed_bucket_accum, plan_accumulation,
                           predict_tuples)
from ..ops.layout import build_mode_layout
from ..ops.hyper import normal_wishart_update, sample_alpha
from ..ops.mvn import chol_sample_dispatch
from ..utils.config import MacauConfig
from ..utils.rng import build_random_spec, draw_all
from .data import RelationData, resolved_alpha, resolved_alpha_sample


@dataclasses.dataclass(frozen=True)
class EntitySpec:
    name: str
    n: int


@dataclasses.dataclass(frozen=True)
class RelationSpec:
    name: str
    arity: int
    entity_ids: Tuple[int, ...]   # mode -> entity index
    nnz: int
    n_test: int
    alpha_sample: bool
    mean_value: float


def _check_slice(rd: RelationData) -> None:
    """Raise NotImplementedError for what the port does not cover yet."""
    if any(rel.class_cut is not None for rel in rd.relations):
        raise NotImplementedError(
            "not ported yet: class_cut / AUC (ROADMAP M8)")


def _plan_fused(rel, cfg: MacauConfig):
    """``fused_pair_plan``'s (s, m, keep) when the relation takes the fused
    path (JAX engine :128-179), else None."""
    if cfg.dense_fused is not True or cfg.dense_gram is False:
        return None
    plan = dg.fused_pair_plan(rel.data.idx, rel.data.vals, rel.data.shape,
                              tol=cfg.dense_fused_tol)
    if not dg.plan_fused_rels([rel.data.shape], cfg.dense_gram,
                              cfg.dense_fused, [plan and plan[:2]]):
        return None
    return plan


def _resolve_device(device) -> torch.device:
    """The engine's device.  The default is the CUDA card; without one it
    raises rather than run on the CPU, which only an explicit "cpu" asks
    for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the engine runs on the card by default; pass "
            "device='cpu' to run the plain versions on the CPU")
    return dev


class CompiledProblem:
    """The device arrays and static description of one RelationData graph.

    Per relation ``ri``, ``kinds[ri]`` names its Gramian path: "pair" (the
    dense pair, int8 where ``pair_i8s[ri]``), "fused" (the fused store, s8
    where ``fused_i8s[ri]``, with a gather-path residual where
    ``residual_nnzs[ri]``) or "gather"; ``stores[ri]`` holds the pair or
    the fused store.  ``layouts["r{ri}m{mode}"]`` are the gather buckets of
    every gather mode and fused residual."""

    def __init__(self, rd: RelationData, config: MacauConfig,
                 device: torch.device):
        _check_slice(rd)
        dtype = getattr(torch, config.dtype)
        ent_index = {id(e): i for i, e in enumerate(rd.entities)}
        self.entity_specs = [EntitySpec(e.name, int(e.count))
                             for e in rd.entities]
        self.rel_specs: List[RelationSpec] = []
        self.kinds: List[str] = []
        self.stores: List[Optional[dict]] = []
        self.pair_i8s: List[bool] = []
        self.fused_i8s: List[bool] = []
        self.residual_nnzs: List[int] = []
        self.layouts, self.acc_plan, self.padded_nnz = {}, {}, []
        self.test, self.train = {}, {}
        self.layout_seconds = self.plan_seconds = 0.0
        self._host_inst: Dict[str, List[np.ndarray]] = {}
        t0 = time.perf_counter()
        for ri, rel in enumerate(rd.relations):
            mean_value = float(rel.data.vals.mean()) if rel.data.nnz else 0.0
            rs = RelationSpec(
                name=rel.name, arity=rel.arity,
                entity_ids=tuple(ent_index[id(e)] for e in rel.entities),
                nnz=rel.data.nnz, n_test=len(rel.test_vals),
                alpha_sample=resolved_alpha_sample(rel, config),
                mean_value=mean_value)
            self.rel_specs.append(rs)
            self._build_relation(ri, rel, mean_value, config, device)
            if rel.test_idx.shape[0]:
                self.test[f"r{ri}"] = {
                    "idx": torch.from_numpy(rel.test_idx.astype(np.int64))
                    .to(device),
                    "vals": torch.from_numpy(rel.test_vals).to(device,
                                                               dtype)}
            if rs.alpha_sample:
                # the training tuples and centered values, for the SSE of
                # the alpha draw (JAX engine :344-347)
                self.train[f"r{ri}"] = {
                    "idx": torch.from_numpy(rel.data.idx.astype(np.int64))
                    .to(device),
                    "vals": torch.from_numpy(rel.data.vals - mean_value)
                    .to(device, dtype)}
        self.tri = (dg.tri_index(config.num_latent, device)
                    if set(self.kinds) - {"gather"} else None)
        if config.accumulation == "planned":
            self._build_acc_plans(config, device)
        del self._host_inst
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.build_seconds = time.perf_counter() - t0
        self.init_alpha = [resolved_alpha(rel, config)
                           for rel in rd.relations]
        self.random_spec = build_random_spec(
            [es.n for es in self.entity_specs], config.num_latent,
            config.resolved_nu0(), self.rel_specs, config.alpha_a0)

    def _build_relation(self, ri, rel, mean_value, config, device):
        """Relation ``ri``'s store or bucket layouts.  The gather path for
        every relation under ``dense_gram=False``, and for one without
        observations (JAX ``plan_dense_modes`` skips those); else the
        fused store where ``dense_fused`` asks and the planner encodes the
        relation; else the pair: int8 where asked for and eligible (JAX
        engine :113-118), else the float pair in the JAX store dtype
        (:109-112)."""
        store, pair_i8, fused_i8, resid = None, False, False, 0
        plan = None
        if config.dense_gram is not False and rel.data.nnz:
            t0 = time.perf_counter()
            plan = _plan_fused(rel, config)
            self.plan_seconds += time.perf_counter() - t0
        if config.dense_gram is False or not rel.data.nnz:
            kind = "gather"
            self._build_layouts(ri, rel, mean_value, config, device)
        elif plan is not None:
            kind = "fused"
            store, fused_i8, resid = self._build_fused(
                ri, rel, mean_value, config, device, *plan)
        else:
            kind = "pair"
            centered = rel.data.vals - mean_value
            pair_i8 = bool(config.dense_int8 and dg.int8_pair_ok(
                rel.data.idx, rel.data.shape))
            if pair_i8 and rel.arity > 3:
                raise NotImplementedError(
                    "not ported yet: the int8 pair at arity >= 4 (ROADMAP "
                    "M12); dense_int8=False takes the float pair")
            if pair_i8:
                store = dg.build_int8_pair(rel.data.idx, centered,
                                           rel.data.shape,
                                           config.np_dtype(), device)
            else:
                store = dg.build_dense_pair(
                    rel.data.idx, centered, rel.data.shape,
                    getattr(torch, config.gram_dtype or config.dtype),
                    device)
        self.kinds.append(kind)
        self.stores.append(store)
        self.pair_i8s.append(pair_i8)
        self.fused_i8s.append(fused_i8)
        self.residual_nnzs.append(resid)

    def _build_fused(self, ri, rel, mean_value, config, device, s, m, keep):
        """The fused path's store (JAX engine :163-198, :272-300): V8, the
        ridge degrees and the s8 decision from the kept observations only;
        the rest get the gather path's bucket layouts with their exact
        centered values (``mean_value`` is over all observations).
        Returns (store, s8, residual observation count)."""
        idx, vals = rel.data.idx, rel.data.vals
        if not keep.all():
            idx, vals = idx[keep], vals[keep]
        fused_i8 = bool(config.dense_int8 and dg.fused_int8_ok(
            dg.fused_code_bound(vals, s, m), rel.data.shape, idx=idx,
            abs_codes=dg.fused_abs_codes(vals, s, m)))
        store = dg.build_fused_store(idx, vals, rel.data.shape, s, m, device)
        del idx, vals
        resid = 0
        if not keep.all():
            rows = np.nonzero(~keep)[0]
            resid = int(rows.size)
            self._build_layouts(ri, rel, mean_value, config, device, rows)
        return store, fused_i8, resid

    def _build_layouts(self, ri, rel, mean_value, config, device, rows=None):
        """The gather path's device arrays for relation ``ri`` (JAX engine
        :277-300): per mode ``layouts["r{ri}m{mode}"]``, a list of buckets
        (``inst`` and ``part`` int32, ``val`` and ``mask`` in the compute
        dtype).  Adds the seconds to build and upload them to
        ``layout_seconds`` and the padded observation count of each mode to
        ``padded_nnz``.  ``rows`` selects the observations (the fused
        path's residual); None takes all."""
        idx, centered = rel.data.idx, rel.data.vals - mean_value
        if rows is not None:
            idx, centered = idx[rows], centered[rows]
        t0 = time.perf_counter()
        for mode in range(rel.arity):
            ml = build_mode_layout(
                idx, centered, mode, rel.entities[mode].count,
                widths=config.bucket_widths, row_pad=config.row_pad,
                dtype=config.np_dtype())
            key = f"r{ri}m{mode}"
            self._host_inst[key] = [b.inst for b in ml.buckets]
            self.padded_nnz.append(ml.padded_nnz)
            self.layouts[key] = [
                {"inst": torch.from_numpy(b.inst).to(device),
                 "part": [torch.from_numpy(p).to(device) for p in b.part],
                 "val": torch.from_numpy(b.val).to(device),
                 "mask": torch.from_numpy(b.mask).to(device)}
                for b in ml.buckets]
        self.layout_seconds += time.perf_counter() - t0

    def _build_acc_plans(self, config, device):
        """Per entity ``acc_plan["e{ei}"]``, the "planned" accumulation's
        static gather and overflow (JAX engine :420-432), over its gather
        buckets in the sweep's order: relations, then modes."""
        dtype = getattr(torch, config.dtype)
        for ei, es in enumerate(self.entity_specs):
            insts = [a for ri, rs in enumerate(self.rel_specs)
                     for mode, e in enumerate(rs.entity_ids) if e == ei
                     for a in self._host_inst.get(f"r{ri}m{mode}", ())]
            plan = {k: torch.from_numpy(v).to(device)
                    for k, v in plan_accumulation(insts, es.n).items()}
            plan["has"] = plan["has"].to(dtype)
            self.acc_plan[f"e{ei}"] = plan


class MacauEngine:
    """Gibbs engine for one RelationData graph on one device."""

    def __init__(self, rd: RelationData, config: MacauConfig,
                 device="cuda"):
        self.config = config
        self.device = _resolve_device(device)
        if self.device.type == "cuda":
            # the Normal-Wishart products (K x K, [K, N] @ [N, K]) and the
            # prior term run in full float32, as on the JAX package's
            # reference path; this is also PyTorch's default
            torch.backends.cuda.matmul.allow_tf32 = False
        self.dtype = getattr(torch, config.dtype)
        self.problem = CompiledProblem(rd, config, self.device)

    # -- state ---------------------------------------------------------------
    def init_state(self, generator: Optional[torch.Generator] = None
                   ) -> Dict[str, Any]:
        """U ~ init_std * N(0, I), mu = 0, Lambda = I, alpha from config."""
        cfg = self.config
        K, dt, dev = cfg.num_latent, self.dtype, self.device
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(cfg.seed)
        ents = [{"U": cfg.init_std * torch.randn((es.n, K),
                                                 generator=generator,
                                                 dtype=dt, device=dev),
                 "mu": torch.zeros(K, dtype=dt, device=dev),
                 "Lambda": torch.eye(K, dtype=dt, device=dev)}
                for es in self.problem.entity_specs]
        rels = [{"alpha": torch.tensor(a, dtype=dt, device=dev)}
                for a in self.problem.init_alpha]
        preds = {}
        for ri, rs in enumerate(self.problem.rel_specs):
            if rs.n_test:
                preds[f"r{ri}"] = {
                    "sum": torch.zeros(rs.n_test, dtype=dt, device=dev),
                    "sum2": torch.zeros(rs.n_test, dtype=dt, device=dev),
                    "n": torch.zeros((), dtype=dt, device=dev)}
        return {"ent": ents, "rel": rels, "pred": preds}

    # -- one sweep -----------------------------------------------------------
    def draw(self, sweep: int) -> Dict[str, torch.Tensor]:
        """The randoms of sweep ``sweep`` (1-based), on the device."""
        return draw_all(self.config.seed, sweep, self.problem.random_spec,
                        self.dtype, self.device)

    def _sweep(self, state, s: int, accumulate: float):
        return self._sweep_with_randoms(state, self.draw(s + 1), accumulate)

    def _sweep_with_randoms(self, state, randoms, accumulate: float):
        """One Gibbs sweep (JAX engine :748-998): each entity in turn, then
        the alpha draws, then the predictions."""
        cfg = self.config
        nu0 = cfg.resolved_nu0()
        prob = self.problem
        metrics: Dict[str, torch.Tensor] = {}
        ents = [dict(e) for e in state["ent"]]
        rels = list(state["rel"])

        for ei in range(len(prob.entity_specs)):
            ent = ents[ei]
            mu, Lambda = normal_wishart_update(
                ent["U"], cfg.nw_b0, nu0, 2.0 * randoms[f"e{ei}.nw_g"],
                randoms[f"e{ei}.nw_tri"], randoms[f"e{ei}.nw_mu"])
            ent["mu"], ent["Lambda"] = mu, Lambda
            # every (relation, mode) this entity fills, the partners read
            # from the current state (the entity's own U too, in a relation
            # where it fills two modes) (JAX engine :792-806)
            dense, contribs = [], []
            for ri, rs in enumerate(prob.rel_specs):
                for mode, e in enumerate(rs.entity_ids):
                    if e != ei:
                        continue
                    partners = [ents[rs.entity_ids[d]]["U"]
                                for d in range(rs.arity) if d != mode]
                    alpha = rels[ri]["alpha"]
                    if prob.kinds[ri] != "gather":
                        dense.append((ri, mode, partners, alpha))
                    for ba in prob.layouts.get(f"r{ri}m{mode}", ()):
                        contribs.append((alpha, partners, ba))
            ent["U"] = self._sample(ei, ent, dense, contribs,
                                    randoms[f"e{ei}.xi"])
            metrics[f"e{ei}.unorm"] = torch.linalg.norm(ent["U"])

        # noise precisions (JAX engine :953-965)
        for ri, rs in enumerate(prob.rel_specs):
            if not rs.alpha_sample:
                continue
            tr = prob.train[f"r{ri}"]
            pred_c = predict_tuples([ents[e]["U"] for e in rs.entity_ids],
                                    tr["idx"], 0.0)
            sse = torch.sum((tr["vals"] - pred_c) ** 2)
            del pred_c
            rels[ri] = {"alpha": sample_alpha(
                sse, rs.nnz, randoms[f"r{ri}.alpha_g"], cfg.alpha_a0,
                cfg.alpha_b0)}
            metrics[f"r{ri}.alpha"] = rels[ri]["alpha"]

        # prediction and the posterior mean (JAX engine :967-998)
        preds = dict(state["pred"])
        for ri, rs in enumerate(prob.rel_specs):
            key = f"r{ri}"
            if key not in preds:
                continue
            te = prob.test[key]
            p = predict_tuples([ents[e]["U"] for e in rs.entity_ids],
                               te["idx"], rs.mean_value)
            if cfg.clamp is not None:
                p = torch.clamp(p, cfg.clamp[0], cfg.clamp[1])
            pr = preds[key]
            pr = {"sum": pr["sum"] + accumulate * p,
                  "sum2": pr["sum2"] + accumulate * p * p,
                  "n": pr["n"] + accumulate}
            preds[key] = pr
            metrics[f"{key}.rmse_sample"] = torch.sqrt(
                torch.mean((p - te["vals"]) ** 2))
            pmean = pr["sum"] / torch.clamp_min(pr["n"], 1.0)
            metrics[f"{key}.rmse_avg"] = torch.sqrt(
                torch.mean((pmean - te["vals"]) ** 2))
        return {"ent": ents, "rel": rels, "pred": preds}, metrics

    def _sample(self, ei, ent, dense, contribs, xi):
        """The draw of entity ``ei``'s rows from its ``dense``
        contributions ((relation, mode, partners, alpha)) and its gather
        buckets ``contribs`` ((alpha, partners, bucket)).

        K <= 96 with a dense contribution and "segment" accumulation keeps
        P packed (JAX engine :818-923): the dense contributions summed in
        the transposed [C, n] layout, the buckets added into it
        (``packed_bucket_accum``), then the packed sampler (K1, K2).
        Otherwise (JAX :924-951) P is full: the buckets through
        ``assemble_precision`` (Lambda left to the sampler) or
        ``assemble_precision_planned`` (Lambda in P), the dense
        contributions unpacked and added, then the full-P sampler (K3, K4,
        the blocked one above K = 96); an entity with no contribution
        draws from its prior."""
        cfg = self.config
        K = cfg.num_latent
        n = self.problem.entity_specs[ei].n
        mu, Lambda = ent["mu"], ent["Lambda"]
        gd = getattr(torch, cfg.gram_dtype) if cfg.gram_dtype else None
        if K <= K2_MAX_K and dense and cfg.accumulation != "planned":
            P = b = None
            for ri, mode, partners, alpha in dense:
                P_d, b_d = self._dense_contrib(ri, mode, partners, alpha,
                                               packed=True)
                # the first contribution is a fresh output, summed into
                P, b = (P_d, b_d) if P is None else (P.add_(P_d),
                                                     b.add_(b_d))
            if contribs:
                packed_bucket_accum(contribs, n, K, gram_dtype=gd,
                                    transposed=True, out=(P, b),
                                    tri=self.problem.tri)
            b = (mu @ Lambda)[:, None] + b
            return chol_sample_packed_dispatch(P, b, xi, Lambda,
                                               cfg.chol_jitter,
                                               transposed=True)
        lam = Lambda
        if cfg.accumulation == "planned":
            P, b = assemble_precision_planned(
                Lambda, mu, contribs, n, self.problem.acc_plan[f"e{ei}"],
                gram_dtype=gd)
            lam = None
        elif contribs or not dense:
            P, b = assemble_precision(Lambda, mu, contribs, n,
                                      gram_dtype=gd, fuse_lambda=True)
        else:
            # dense contributions alone: the first one's fresh [n, K, K]
            # output is the accumulator, which saves an [n, K, K] buffer
            # (4.7 GB at K = 128 on ML-10M)
            P = None
            b = mu @ Lambda
        for ri, mode, partners, alpha in dense:
            P_d, b_d = self._dense_contrib(ri, mode, partners, alpha,
                                           packed=False)
            P = P_d if P is None else P.add_(P_d)
            b = b + b_d
            del P_d
        # P is fresh; the dispatch adds Lambda to it in place above K = 96
        return chol_sample_dispatch(P, b, xi, lam, cfg.chol_jitter)

    def _dense_contrib(self, ri, mode, partners, alpha, packed):
        """Relation ``ri``'s alpha-scaled contribution to focus ``mode``, in
        the packed transposed layout (P [C, n], b [K, n]) or unpacked (P
        [n, K, K], b [n, K]), fresh tensors either way: the int8 pair (K7
        and K6; alpha folded into the dequant scales), the float pair, the
        fused s8 store (K7 and K8; alpha folded) or the fused float store
        (the table in ``gram_dtype``, alpha multiplied after) (JAX engine
        :1000-1042)."""
        cfg = self.config
        prob = self.problem
        store, dtype = prob.stores[ri], self.dtype
        gd = getattr(torch, cfg.gram_dtype) if cfg.gram_dtype else None
        if prob.kinds[ri] == "pair":
            if prob.pair_i8s[ri]:
                return dg.int8_pair_contrib(store, prob.tri, partners, mode,
                                            alpha, dtype, packed=packed,
                                            op_dtype=gd)
            return dg.float_pair_contrib(store, prob.tri, partners, mode,
                                         alpha, dtype, packed=packed)
        mean = prob.rel_specs[ri].mean_value
        if prob.fused_i8s[ri]:
            return dg.fused_gram_contrib_i8(store, prob.tri, partners[0],
                                            mode, alpha, dtype, mean,
                                            packed=packed)
        P, b = dg.fused_gram_contrib(store, prob.tri, partners[0], mode,
                                     dtype, gd or dtype, mean, packed=packed,
                                     transposed=packed)
        P *= alpha          # the kernel's fresh output, or its expansion
        b *= alpha
        return P, b

    # -- run loops -----------------------------------------------------------
    def run(self, state=None, num_sweeps: Optional[int] = None,
            callback: Optional[Callable] = None) -> Dict[str, Any]:
        """Run burnin + psamples sweeps (or ``num_sweeps``); returns the
        reference-style results.  ``callback(sweep, phase, metrics, dt)``
        runs after every sweep; each sweep's metrics are read back to the
        host, which waits for the device."""
        cfg = self.config
        if state is None:
            state = self.init_state()
        total = (cfg.burnin + cfg.psamples if num_sweeps is None
                 else num_sweeps)
        history: List[Dict[str, float]] = []
        for s in range(total):
            t0 = time.perf_counter()
            state, m = self._sweep(state, s, 1.0 if s >= cfg.burnin else 0.0)
            metrics = {k: float(v) for k, v in m.items()}
            dt = time.perf_counter() - t0
            metrics["time"] = dt
            phase = "burnin" if s < cfg.burnin else "sample"
            history.append(metrics)
            if callback is not None:
                callback(s, phase, metrics, dt)
            if cfg.verbose:
                self._print_sweep(s, phase, metrics)
        return self._results(state, history)

    def benchmark(self, num_sweeps: int, repeats: int = 1
                  ) -> Dict[str, Any]:
        """Timing entry point, the JAX engine's protocol: one untimed warm
        window of ``num_sweeps`` sweeps, then ``repeats`` timed windows of
        ``num_sweeps`` each, continuing one chain.  Each window ends with a
        device-to-host read of its last metrics.

        Returns ``{"ms_per_sweep": [per window], "metrics": {last sweep},
        "rmse_at_sweeps": rmse_sample at sweep num_sweeps}`` (of the first
        relation with a test split)."""
        prob = self.problem
        first = next((ri for ri, rs in enumerate(prob.rel_specs)
                      if rs.n_test), None)
        if first is None:
            raise ValueError("benchmark needs a test split "
                             "(RelationData.assign_to_test)")
        cfg = self.config
        state = self.init_state()

        def run_window(state, start):
            t0 = time.perf_counter()
            for s in range(start, start + num_sweeps):
                state, last = self._sweep(state, s,
                                          1.0 if s >= cfg.burnin else 0.0)
            _ = float(last[f"r{first}.rmse_avg"])   # waits for the window
            dt = time.perf_counter() - t0
            return state, {k: float(v) for k, v in last.items()}, dt

        state, metrics, _ = run_window(state, 0)
        rmse_at = metrics[f"r{first}.rmse_sample"]
        windows = []
        for r in range(repeats):
            state, metrics, dt = run_window(state, (r + 1) * num_sweeps)
            windows.append(dt * 1e3 / num_sweeps)
        return {"ms_per_sweep": windows, "metrics": metrics,
                "rmse_at_sweeps": rmse_at}

    def _print_sweep(self, s, phase, metrics):
        """The reference's verbose line (JAX engine :666): sweep, phase,
        per relation its RMSEs (and AUC) and sampled alpha, per entity
        the norms and CG iterations it has in ``metrics``, time."""
        parts = [f"sweep {s + 1:4d} [{phase:6s}]"]
        for ri, rs in enumerate(self.problem.rel_specs):
            k = f"r{ri}.rmse_avg"
            if k in metrics:
                line = (f"{rs.name}: RMSE={metrics[k]:.4f} "
                        f"(sample {metrics[f'r{ri}.rmse_sample']:.4f})")
                if f"r{ri}.auc" in metrics:
                    line += f" AUC={metrics[f'r{ri}.auc']:.4f}"
                parts.append(line)
            if f"r{ri}.alpha" in metrics:
                parts.append(f"a{ri}={metrics[f'r{ri}.alpha']:.2f}")
        for ei in range(len(self.problem.entity_specs)):
            if f"e{ei}.unorm" in metrics:
                parts.append(f"|U{ei}|={metrics[f'e{ei}.unorm']:.1f}")
            if f"e{ei}.betanorm" in metrics:
                parts.append(f"|b{ei}|={metrics[f'e{ei}.betanorm']:.2f}"
                             f" lb={metrics[f'e{ei}.lambda_beta']:.3f}")
            if f"e{ei}.cg_iters" in metrics:
                parts.append(f"cg{ei}={metrics[f'e{ei}.cg_iters']:.0f}")
        parts.append(f"{metrics['time']:.3f}s")
        print("  ".join(parts), flush=True)

    def _results(self, state, history) -> Dict[str, Any]:
        """Reference-style result dict (JAX engine :1179): per relation with
        a test split, under its name, the RMSE of the posterior mean and
        the test predictions with their posterior stdev; relation 0's also
        at the top level."""
        out: Dict[str, Any] = {"state": state, "history": history}
        for ri, rs in enumerate(self.problem.rel_specs):
            key = f"r{ri}"
            if key not in state["pred"]:
                continue
            pr = {k: v.detach().cpu().numpy() for k, v in
                  state["pred"][key].items()}
            n = max(float(pr["n"]), 1.0)
            pmean = pr["sum"] / n
            pvar = np.maximum(pr["sum2"] / n - pmean ** 2, 0.0)
            te = self.problem.test[key]
            te_idx = te["idx"].cpu().numpy()
            te_val = te["vals"].cpu().numpy()
            rel_out = {"RMSE": float(np.sqrt(np.mean((pmean - te_val) ** 2))),
                       "predictions": {"idx": te_idx, "obs": te_val,
                                       "pred": pmean,
                                       "stdev": np.sqrt(pvar)}}
            out[rs.name] = rel_out
            if ri == 0:
                out.update(rel_out)
        return out


def macau(data: RelationData,
          num_latent: int = 10,
          burnin: int = 500,
          psamples: int = 200,
          clamp: Optional[Sequence[float]] = None,
          verbose: bool = True,
          seed: int = 1234,
          config: Optional[MacauConfig] = None,
          device="cuda",
          **kwargs) -> Dict[str, Any]:
    """Bayesian factorization of a RelationData graph by Gibbs sampling on
    ``device`` (the CUDA card unless the caller asks for "cpu"); extra
    kwargs go into MacauConfig."""
    if config is None:
        config = MacauConfig(
            num_latent=num_latent, burnin=burnin, psamples=psamples,
            clamp=tuple(clamp) if clamp is not None else None,
            verbose=verbose, seed=seed, **kwargs)
    return MacauEngine(data, config, device=device).run()
