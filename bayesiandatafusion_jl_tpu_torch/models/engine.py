"""The Gibbs sweep engine, ``macau()`` — port of the JAX package's
``models/engine.py`` main path.

The slice this port covers: one 2-ary relation without side features, at
any K, with either Gramian path:

- the dense int8 pair (``dense_gram`` None or True; ops/dense_gram.py);
- the bucketed gather path (``dense_gram=False``; ops/layout.py and
  ops/gramian.py), with ``accumulation`` "segment" or "planned".

Each sweep, for each entity in turn:

  (mu, Lambda) <- Normal-Wishart draw from U                 (ops/hyper.py)
  P, b         <- alpha-scaled Gramian of the partner factors over the
                  entity's observations, plus the prior term Lambda mu
  U            <- u ~ N(P'^-1 b, P'^-1) per row, P' = P + Lambda

The sampler branches as the JAX engine does (engine.py:821, :924-951).  On
the int8 pair path, K <= 96 keeps P packed ([K(K+1)/2, N],
ops/chol_packed.py: the K1 kernel up to K = 32, K2 above) and K > 96
expands it to [N, K, K].  The gather path always assembles a full
[N, K, K] P.  Full P goes to ops/mvn.chol_sample_dispatch: the K3 kernel
up to K = 32, K4 up to 96, the blocked sampler on K5 up to 128.  With
"segment" accumulation Lambda is left out of P and added by the sampler;
with "planned" it is in the accumulator.

then the test tuples are predicted (clamped per sample) and the posterior
mean and RMSEs are updated.  Options outside the slice raise
``NotImplementedError`` naming their ROADMAP item.

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
                           plan_accumulation, predict_tuples)
from ..ops.layout import build_mode_layout
from ..ops.hyper import normal_wishart_update
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
    entity_ids: Tuple[int, ...]   # mode -> entity index
    nnz: int
    n_test: int
    mean_value: float


def _check_slice(rd: RelationData, cfg: MacauConfig) -> None:
    """Raise NotImplementedError for whatever the port does not cover."""
    missing = []
    if len(rd.relations) != 1:
        missing.append("several relations / fusion graphs (ROADMAP M7)")
    for rel in rd.relations:
        if rel.arity != 2:
            missing.append("relations of arity >= 3 (ROADMAP M7)")
        if len({id(e) for e in rel.entities}) != rel.arity:
            missing.append("an entity in two modes of one relation "
                           "(ROADMAP M7)")
        if rel.class_cut is not None:
            missing.append("class_cut / AUC (ROADMAP M8)")
        if resolved_alpha_sample(rel, cfg):
            missing.append("alpha sampling (ROADMAP M7)")
    if len(rd.entities) != 2:
        missing.append("entities outside the relation (ROADMAP M7)")
    if missing:
        raise NotImplementedError("not ported yet: " + "; ".join(missing))
    if cfg.dense_gram is False:
        return
    if cfg.accumulation == "planned":
        raise NotImplementedError(
            "not ported yet: accumulation='planned' with the dense pair "
            "(ROADMAP M6); it applies to the gather path (dense_gram=False)")
    rel = rd.relations[0]
    if not dg.int8_pair_ok(rel.data.idx, rel.data.shape):
        raise NotImplementedError(
            "relation not int8-eligible: float dense pair (ROADMAP M3)")


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
    """The device arrays and static description of one RelationData."""

    def __init__(self, rd: RelationData, config: MacauConfig,
                 device: torch.device):
        _check_slice(rd, config)
        dtype = getattr(torch, config.dtype)
        ent_index = {id(e): i for i, e in enumerate(rd.entities)}
        self.entity_specs = [EntitySpec(e.name, int(e.count))
                             for e in rd.entities]
        rel = rd.relations[0]
        mean_value = float(rel.data.vals.mean()) if rel.data.nnz else 0.0
        self.rel_specs = [RelationSpec(
            name=rel.name,
            entity_ids=tuple(ent_index[id(e)] for e in rel.entities),
            nnz=rel.data.nnz, n_test=len(rel.test_vals),
            mean_value=mean_value)]
        t0 = time.perf_counter()
        self.gather = config.dense_gram is False
        self.pair = self.tri = None
        if self.gather:
            self._build_layouts(rel, mean_value, config, device)
        else:
            self.pair = dg.build_int8_pair(
                rel.data.idx, rel.data.vals - mean_value, rel.data.shape,
                config.np_dtype(), device)
            self.tri = dg.tri_index(config.num_latent, device)
        self.test = {}
        if rel.test_idx.shape[0]:
            self.test["r0"] = {
                "idx": torch.from_numpy(rel.test_idx.astype(np.int64))
                .to(device),
                "vals": torch.from_numpy(rel.test_vals).to(device, dtype)}
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.build_seconds = time.perf_counter() - t0
        self.init_alpha = [resolved_alpha(rel, config)]
        self.random_spec = build_random_spec(
            [es.n for es in self.entity_specs], config.num_latent,
            config.resolved_nu0())

    def _build_layouts(self, rel, mean_value, config, device):
        """The gather path's device arrays (JAX engine :277-300, :387-399):
        per mode ``layouts["r0m{mode}"]``, a list of buckets (``inst`` and
        ``part`` int32, ``val`` and ``mask`` in the compute dtype); with
        "planned" accumulation, per entity ``acc_plan["e{ei}"]``.  Records
        the seconds to build and upload them (``layout_seconds``) and the
        padded observation count per mode (``padded_nnz``)."""
        dtype = getattr(torch, config.dtype)
        centered = rel.data.vals - mean_value
        self.layouts, self.padded_nnz, host_inst = {}, [], {}
        t0 = time.perf_counter()
        for mode in range(rel.arity):
            ml = build_mode_layout(
                rel.data.idx, centered, mode, rel.entities[mode].count,
                widths=config.bucket_widths, row_pad=config.row_pad,
                dtype=config.np_dtype())
            key = f"r0m{mode}"
            host_inst[key] = [b.inst for b in ml.buckets]
            self.padded_nnz.append(ml.padded_nnz)
            self.layouts[key] = [
                {"inst": torch.from_numpy(b.inst).to(device),
                 "part": [torch.from_numpy(p).to(device) for p in b.part],
                 "val": torch.from_numpy(b.val).to(device),
                 "mask": torch.from_numpy(b.mask).to(device)}
                for b in ml.buckets]
        self.acc_plan = {}
        if config.accumulation == "planned":
            for ei, es in enumerate(self.entity_specs):
                modes = [m for m, e in enumerate(self.rel_specs[0].entity_ids)
                         if e == ei]
                plan = plan_accumulation(
                    [a for m in modes for a in host_inst[f"r0m{m}"]], es.n)
                plan = {k: torch.from_numpy(v).to(device)
                        for k, v in plan.items()}
                plan["has"] = plan["has"].to(dtype)
                self.acc_plan[f"e{ei}"] = plan
        self.layout_seconds = time.perf_counter() - t0


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
        cfg = self.config
        dtype = self.dtype
        nu0 = cfg.resolved_nu0()
        prob = self.problem
        rs = prob.rel_specs[0]
        metrics: Dict[str, torch.Tensor] = {}
        ents = [dict(e) for e in state["ent"]]
        rels = state["rel"]

        for ei, es in enumerate(prob.entity_specs):
            ent = ents[ei]
            mu, Lambda = normal_wishart_update(
                ent["U"], cfg.nw_b0, nu0, 2.0 * randoms[f"e{ei}.nw_g"],
                randoms[f"e{ei}.nw_tri"], randoms[f"e{ei}.nw_mu"])
            ent["mu"], ent["Lambda"] = mu, Lambda
            mode = rs.entity_ids.index(ei)
            partner = ents[rs.entity_ids[1 - mode]]["U"]
            xi = randoms[f"e{ei}.xi"]
            if prob.gather:
                ent["U"] = self._gather_sample(ent, ei, mode, partner, xi,
                                               rels[0]["alpha"])
                metrics[f"e{ei}.unorm"] = torch.linalg.norm(ent["U"])
                continue
            packed = cfg.num_latent <= K2_MAX_K
            P, b_d = dg.dense_gram_contrib(prob.pair, prob.tri, partner,
                                           mode, rels[0]["alpha"], dtype,
                                           packed=packed)
            # prior term Lambda mu for every row, plus the data term
            if packed:
                b = (mu @ Lambda)[:, None] + b_d[:, :es.n]
                ent["U"] = chol_sample_packed_dispatch(
                    P[:, :es.n], b, xi, Lambda, cfg.chol_jitter,
                    transposed=True)
            else:
                # P is the Gramian's fresh [n, K, K] expansion; the
                # dispatch adds Lambda to it in place, which saves an
                # [n, K, K] copy (4.7 GB at K=128 on ML-10M)
                b = (mu @ Lambda) + b_d
                ent["U"] = chol_sample_dispatch(P, b, xi, Lambda,
                                                cfg.chol_jitter)
            metrics[f"e{ei}.unorm"] = torch.linalg.norm(ent["U"])

        preds = dict(state["pred"])
        if "r0" in preds:
            te = prob.test["r0"]
            factors = [ents[e]["U"] for e in rs.entity_ids]
            p = predict_tuples(factors, te["idx"], rs.mean_value)
            if cfg.clamp is not None:
                p = torch.clamp(p, cfg.clamp[0], cfg.clamp[1])
            pr = preds["r0"]
            pr = {"sum": pr["sum"] + accumulate * p,
                  "sum2": pr["sum2"] + accumulate * p * p,
                  "n": pr["n"] + accumulate}
            preds["r0"] = pr
            metrics["r0.rmse_sample"] = torch.sqrt(
                torch.mean((p - te["vals"]) ** 2))
            pmean = pr["sum"] / torch.clamp_min(pr["n"], 1.0)
            metrics["r0.rmse_avg"] = torch.sqrt(
                torch.mean((pmean - te["vals"]) ** 2))
        return {"ent": ents, "rel": rels, "pred": preds}, metrics

    def _gather_sample(self, ent, ei, mode, partner, xi, alpha):
        """The gather path's draw of entity ``ei`` (JAX engine :924-951):
        assemble P and b over the mode's buckets, then the full-P sampler.
        "segment" leaves Lambda out of P for the sampler to add (in
        registers for K3, on load for K4); "planned" puts it in the
        accumulator and samples without it."""
        cfg = self.config
        prob = self.problem
        n = prob.entity_specs[ei].n
        gd = getattr(torch, cfg.gram_dtype) if cfg.gram_dtype else None
        contribs = [(alpha, [partner], ba)
                    for ba in prob.layouts[f"r0m{mode}"]]
        if cfg.accumulation == "planned":
            P, b = assemble_precision_planned(
                ent["Lambda"], ent["mu"], contribs, n,
                prob.acc_plan[f"e{ei}"], gram_dtype=gd)
            lam = None
        else:
            P, b = assemble_precision(ent["Lambda"], ent["mu"], contribs, n,
                                      gram_dtype=gd, fuse_lambda=True)
            lam = ent["Lambda"]
        return chol_sample_dispatch(P, b, xi, lam, cfg.chol_jitter)

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
        "rmse_at_sweeps": rmse_sample at sweep num_sweeps}``."""
        if not self.problem.rel_specs[0].n_test:
            raise ValueError("benchmark needs a test split "
                             "(RelationData.assign_to_test)")
        cfg = self.config
        state = self.init_state()

        def run_window(state, start):
            t0 = time.perf_counter()
            for s in range(start, start + num_sweeps):
                state, last = self._sweep(state, s,
                                          1.0 if s >= cfg.burnin else 0.0)
            _ = float(last["r0.rmse_avg"])      # waits for the window
            dt = time.perf_counter() - t0
            return state, {k: float(v) for k, v in last.items()}, dt

        state, metrics, _ = run_window(state, 0)
        rmse_at = metrics["r0.rmse_sample"]
        windows = []
        for r in range(repeats):
            state, metrics, dt = run_window(state, (r + 1) * num_sweeps)
            windows.append(dt * 1e3 / num_sweeps)
        return {"ms_per_sweep": windows, "metrics": metrics,
                "rmse_at_sweeps": rmse_at}

    def _print_sweep(self, s, phase, metrics):
        parts = [f"sweep {s + 1:4d} [{phase:6s}]"]
        if "r0.rmse_avg" in metrics:
            parts.append(f"{self.problem.rel_specs[0].name}: "
                         f"RMSE={metrics['r0.rmse_avg']:.4f} "
                         f"(sample {metrics['r0.rmse_sample']:.4f})")
        for ei in range(len(self.problem.entity_specs)):
            parts.append(f"|U{ei}|={metrics[f'e{ei}.unorm']:.1f}")
        parts.append(f"{metrics['time']:.3f}s")
        print("  ".join(parts), flush=True)

    def _results(self, state, history) -> Dict[str, Any]:
        """Reference-style result dict: RMSE of the posterior mean and the
        test predictions with their posterior stdev."""
        out: Dict[str, Any] = {"state": state, "history": history}
        rs = self.problem.rel_specs[0]
        if "r0" not in state["pred"]:
            return out
        pr = {k: v.detach().cpu().numpy() for k, v in
              state["pred"]["r0"].items()}
        n = max(float(pr["n"]), 1.0)
        pmean = pr["sum"] / n
        pvar = np.maximum(pr["sum2"] / n - pmean ** 2, 0.0)
        te = self.problem.test["r0"]
        te_idx = te["idx"].cpu().numpy()
        te_val = te["vals"].cpu().numpy()
        rel_out = {"RMSE": float(np.sqrt(np.mean((pmean - te_val) ** 2))),
                   "predictions": {"idx": te_idx, "obs": te_val,
                                   "pred": pmean, "stdev": np.sqrt(pvar)}}
        out[rs.name] = rel_out
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
