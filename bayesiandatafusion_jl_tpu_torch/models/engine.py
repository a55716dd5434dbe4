"""The Gibbs sweep engine, ``macau()`` — port of the JAX package's
``models/engine.py``.

The graphs this port covers: any set of relations of any arity over
shared entities (an entity may fill several modes of one relation, or
none), with fixed or sampled noise precision alpha, at any K; an entity
may carry side features X [N, F] (Macau), and a relation a ``class_cut``
(its test AUC).  ``plan_gramians`` gives each (relation, mode) one of
three Gramian paths, from relation statistics, the flags ``dense_gram``
and ``dense_fused`` and the byte budget ``dense_gram_budget_gb`` (the
planner of ops/dense_gram.py on the card's measured rates; JAX engine
:106-151):

- the dense pair (ops/dense_gram.py), stored once for all the relation's
  dense modes: the int8 pair, contracted by K6 (ops/pair_contract.py)
  against the partner table K7 quantizes each sweep (``dense_int8`` and
  the int32 bound ``int8_pair_ok``; at arity 3 and up K6 takes the
  largest partner and a float step the others), or the float pair on
  ``torch.matmul`` otherwise;
- the fused sparse regime (2-ary relations the fused planner encodes):
  one stored int8 value array, contracted per mode by K8
  (ops/fused_pair.py) against the partner table, which K7 (ops/ytab.py)
  quantizes each sweep on the s8 path (``dense_int8`` and the int32 bound
  ``fused_int8_ok``) and which is a float table in ``gram_dtype``
  otherwise.  Observations the one array cannot hold (a second rating of a
  cell, the zero-code level) ride the gather path as an exact-valued
  residual beside it;
- the bucketed gather path (ops/layout.py and ops/gramian.py), each
  bucket row written at its instance's row by the entity's destination
  map, made with the layouts: every mode the plan leaves undense, among
  them every mode under ``dense_gram=False`` and, by default, every mode
  of a relation under 50,000 observations.

Each sweep, for each entity in turn (JAX engine :760-951):

  with side features: beta <- its Gibbs draw with the current Lambda, by
                  the FF, dual or CG solver (``_sample_beta``); then
                  lambda_beta (``sample_lambda_beta``); uhat = X beta
  (mu, Lambda) <- Normal-Wishart draw from U - uhat          (ops/hyper.py)
  P, b         <- alpha-scaled Gramians of the partner factors over the
                  entity's observations in every (relation, mode) it fills,
                  plus the prior term Lambda (mu + uhat_i) of each row
  U            <- u ~ N(P'^-1 b, P'^-1) per row, P' = P + Lambda

then each sampled alpha is drawn from its relation's training residuals,
and the test tuples of every relation are predicted (clamped per sample)
and its posterior mean and RMSEs updated (and, under a ``class_cut``, the
AUC of the posterior mean).

The beta draw's products (X V, X' U, the dual eigenbasis and G) run on
``torch.matmul`` against a dense [N, F] operand (``use_dense_feat``), or
on the bucketed matvec (ops/spmv.py), as the JAX package leaves them to
XLA outside any Pallas kernel.

The sampler branches as the JAX engine does (engine.py:821, :924-951): an
entity with a dense contribution keeps P packed up to K = 96 under
"segment" accumulation ([K(K+1)/2, N], ops/chol_packed.py: the K1 kernel
up to K = 32, K2 above; its gather buckets are accumulated in that layout).
Otherwise P is a full [N, K, K] (dense contributions expanded, buckets
through ``assemble_precision`` and the destination map) for
ops/mvn.chol_sample_dispatch: the K3 kernel up to K = 32, K4 up to 96,
the blocked sampler on K5 up to 128.  With "segment" accumulation Lambda
is left out of P and added by the sampler; with "planned" it is in the
accumulator.  Every sum of a sweep adds in a fixed order (no scatter add
with atomics), so a chain's bits depend on its seed alone.  The sharded
engine (parallel/sharded.py) runs these per-entity pieces
(``_contributions``, ``_precision``, ``_draw_rows``, ``_beta_rhs``,
``_solve_beta``, ``_store_contrib``) on one rank's rows, with its
collectives in the hooks ``_allreduce``, ``_allgather`` and
``_local_rows`` (identities here) and its own ``_fold_ghosts``.

The driver (``GibbsDriver.run``, JAX ``GibbsDriverMixin`` :492-689), which
both engines run, runs
the sweeps in windows dispatched back to back with no host read inside
(``sweeps_per_dispatch``), reads the metrics the host needs at a window's
end (``metrics_every``), and writes the jsonl log, the posterior-sample
dumps, the checkpoints and a ``torch.profiler`` trace where configured.
A checkpoint is the JAX package's npz (``save_state`` / ``load_state``),
and ``run(sweep_offset=...)`` resumes the chain bit for bit.

State is a plain dict of tensors with the JAX engine's keys
(``utils/convert.py`` carries one across).  Randoms come from
``utils/rng.draw_all``, keyed by (seed, sweep, name), or are injected
through ``_sweep_with_randoms``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import glob
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.linalg import solve_triangular

from ..ops import dense_gram as dg
from ..ops.cg import block_cg
from ..ops.chol_packed import K2_MAX_K, chol_sample_packed_dispatch
from ..ops.dual import dual_eig_cached, dual_solve_g, use_dual
from ..ops.gramian import (assemble_precision, build_dest_maps,
                           packed_bucket_accum, predict_tuples)
from ..ops.layout import build_mode_layout
from ..ops.hyper import (normal_wishart_from_moments, normal_wishart_update,
                         sample_alpha, sample_lambda_beta)
from ..ops.mvn import chol_sample_dispatch, chol_solve
from ..ops.precond import build_nystrom, nystrom_apply, resolve_nystrom_rank
from ..ops.spmv import bucketed_spmm, build_bucketed_matvec
from ..utils.config import MacauConfig
from ..utils.convert import state_from_numpy, state_to_numpy
from ..utils.graphs import Graphs
from ..utils.rng import build_random_spec, draw_all
from ..utils.spans import span, timed
from .data import (RelationData, resolved_alpha, resolved_alpha_sample,
                   resolved_lambda_beta)


@dataclasses.dataclass(frozen=True)
class EntitySpec:
    name: str
    n: int
    num_features: int = 0
    use_ff: bool = False
    feat_nnz: int = 0
    # the beta solver of an entity with features: "ff", "dual" or "cg"
    solver: str = "cg"

    @property
    def has_features(self) -> bool:
        return self.num_features > 0


def sweep_flops(prob, extents) -> float:
    """``flops_per_sweep`` of a compiled or sharded problem whose entities
    span ``extents`` rows in its dense stores: per dense mode 2 *
    prod(extents) * (C + K), per gather mode 2 * nnz * (K^2 + K), per
    entity with features its beta solver's products."""
    K = prob.config.num_latent
    C = K * (K + 1) // 2
    f = 0.0
    for ri, rs in enumerate(prob.rel_specs):
        total = float(np.prod([extents[e] for e in rs.entity_ids]))
        for mode in range(rs.arity):
            if (ri, mode) in prob.dense_plans:
                f += 2.0 * total * (C + K)
            else:
                f += 2.0 * rs.nnz * (K * K + K)
    for es in prob.entity_specs:
        if not es.has_features:
            continue
        N, F = float(es.n), float(es.num_features)
        xpass = 2.0 * N * F * K          # one X @ / X' @ [., K] pass
        f += xpass                       # the right-hand side, X' resid
        if es.use_ff:
            f += F ** 3 / 3.0 + 2.0 * F * F * K + xpass
        elif es.solver == "dual":
            r = float(prob.config.dual_refine)
            f += 2.0 * xpass + (4.0 * (1.0 + r) + 2.0 * r) * N * N * K
        else:
            f += xpass                   # uhat
    return f


@dataclasses.dataclass(frozen=True)
class RelationSpec:
    name: str
    arity: int
    entity_ids: Tuple[int, ...]   # mode -> entity index
    nnz: int
    n_test: int
    alpha_sample: bool
    mean_value: float
    class_cut: Optional[float] = None


class _OnDemand:
    """A sequence of ``n`` items, each computed by ``fn(i)`` the first time
    it is read and kept: the planner reads a relation's fused encoding and
    int8 eligibility only where its rules need them, and each costs a sort
    of the relation's observations."""

    def __init__(self, n: int, fn: Callable[[int], Any]):
        self._n, self._fn, self._vals = n, fn, {}

    def __len__(self):
        return self._n

    def __getitem__(self, i):
        if i not in self._vals:
            self._vals[i] = self._fn(i)
        return self._vals[i]


@dataclasses.dataclass
class GramianPlan:
    """``plan_gramians``' decisions for one graph: ``fused`` {ri: (s, m,
    keep)} the relations on the fused store (``fused_pair_plan``'s
    encoding and keep mask); ``dense_plans`` {(ri, mode): DenseModePlan}
    every mode that contracts against a dense store ("canonical": the
    relation's pair; "fused"), the others ride the gather path;
    ``pair_i8`` {ri: bool} whether a relation that stores a pair stores
    the int8 one; ``store_bytes`` {ri: bytes} each dense store's size as
    the budget counts it (true extents); ``seconds`` the planner's."""
    fused: Dict[int, Tuple[float, int, np.ndarray]]
    dense_plans: Dict[Tuple[int, int], dg.DenseModePlan]
    pair_i8: Dict[int, bool]
    store_bytes: Dict[int, float]
    seconds: float


def plan_gramians(rd: RelationData, config: MacauConfig,
                  per_mode_pairs: bool = False) -> GramianPlan:
    """The Gramian path of every (relation, mode) of ``rd`` (JAX engine
    :106-151), from relation statistics alone: the fused encodings of the
    2-ary relations (where ``dense_fused`` is True or a relation has
    ``_AUTO_MIN_NNZ`` observations), ``plan_fused_rels`` on the whole
    budget, then ``plan_dense_modes`` on what is left, with the pair's
    itemsize per relation: 1 where ``dense_int8`` and ``int8_pair_ok`` both
    hold, else the float store's (bfloat16 under ``gram_dtype``, else the
    compute dtype).  ``per_mode_pairs``: each dense mode stores a copy of
    the pair led by its own focus axis ("copy" plans; the sharded engine,
    JAX parallel/sharded.py:133-177), its bytes charged once per mode;
    ``pair_i8`` and ``store_bytes`` then cover the relations with a
    copy."""
    with timed("bdf.build.plan") as t:
        rels = rd.relations
        shapes = [tuple(int(e.count) for e in rel.entities) for rel in rels]
        nnzs = [rel.data.nnz for rel in rels]
        base_item = (2 if config.gram_dtype == "bfloat16"
                     else config.np_dtype().itemsize)
        i8 = _OnDemand(len(rels), lambda ri: bool(
            config.dense_int8 and dg.int8_pair_ok(rels[ri].data.idx,
                                                  shapes[ri])))
        pair_item = _OnDemand(len(rels), lambda ri: 1 if i8[ri] else base_item)

        def encode(ri):
            rel = rels[ri]
            if (rel.arity != 2 or not rel.data.nnz
                    or not (config.dense_fused
                            or rel.data.nnz >= dg._AUTO_MIN_NNZ)):
                return None
            return dg.fused_pair_plan(rel.data.idx, rel.data.vals, shapes[ri],
                                      tol=config.dense_fused_tol)
        fused_plan = _OnDemand(len(rels), encode)
        enc = _OnDemand(len(rels), lambda ri: None if fused_plan[ri] is None
                        else fused_plan[ri][:2])
        budget = config.dense_gram_budget_gb * 1e9
        fused, spent = dg.plan_fused_rels(
            shapes, nnzs, config.num_latent, config.dense_gram,
            config.dense_fused, enc, pair_item, budget)
        dense_plans, canonical, copies = dg.plan_dense_modes(
            shapes, [0 if ri in fused else n for ri, n in enumerate(nnzs)],
            config.num_latent, config.dense_gram, budget - spent, pair_item,
            per_mode_pairs=per_mode_pairs)
        store_bytes = {}
        for ri in fused:
            store_bytes[ri] = float(shapes[ri][0]) * shapes[ri][1]
            for mode in range(2):
                dense_plans[(ri, mode)] = dg.DenseModePlan(
                    "fused", shapes[ri][mode], (shapes[ri][1 - mode],))
        for ri in canonical:
            store_bytes[ri] = 2.0 * float(np.prod(shapes[ri])) * pair_item[ri]
        for ri, _ in copies:
            canonical.add(ri)
            store_bytes[ri] = store_bytes.get(ri, 0.0) + 2.0 * float(
                np.prod(shapes[ri])) * pair_item[ri]
        decided = dict(fused={ri: fused_plan[ri] for ri in fused},
                       dense_plans=dense_plans,
                       pair_i8={ri: i8[ri] for ri in canonical},
                       store_bytes=store_bytes)
    return GramianPlan(**decided, seconds=t.seconds)


@contextlib.contextmanager
def full_float32():
    """Float32 matrix products in full float32 (no TF32) inside, the
    caller's setting restored on the way out: both engines build and run
    their windows inside.  The beta draw's dual solve needs it (its ``rhs -
    X' z`` cancels almost completely, ops/dual.py), as do the Normal-Wishart
    products and the blocked sampler's panels (the JAX package's
    Precision.HIGHEST).  It sets the cuBLAS matmul precision by PyTorch's
    own switch (``torch.backends.cuda.matmul.fp32_precision``), which reads
    back whichever API the caller set it through."""
    mm = torch.backends.cuda.matmul
    before = mm.fp32_precision
    mm.fp32_precision = "ieee"
    try:
        yield
    finally:
        mm.fp32_precision = before


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


@dataclasses.dataclass(frozen=True)
class RowShard:
    """The rows of an entity one rank of the sharded engine holds:
    ``local[i]`` the local row of original instance i (-1: another
    rank's), ``ids`` the original ids of the local rows in order,
    ``n_rows`` the local row count (padding after ``ids``), ``cols`` the
    original id of each position of the permuted order (the dual G's
    columns) and ``n_cols`` its padded count."""
    local: np.ndarray
    ids: np.ndarray
    n_rows: int
    cols: np.ndarray
    n_cols: int


def build_features(ent, config: MacauConfig, device,
                   shard: Optional[RowShard] = None):
    """An entity's beta-draw arrays and solver (JAX engine :310-385;
    sharded.py:429-527): (feat, build seconds, use_ff, solver).  The dense
    [N, F] X in the compute dtype where ``use_dense_feat`` picks it (at the
    JAX package's operand size, ``feat_itemsize``), else the bucketed
    matvec; the squared column sums (Jacobi); then by solver: "ff" (F <=
    ff_threshold unless the entity or the config says otherwise) X'X;
    "dual" (``use_dual``) the eigenbasis of XX', decomposed on ``device``,
    and G; "cg" the Nystrom factors where the rank resolves nonzero and F
    >= 4 x rank.  With ``shard`` the X (or matvec) and the dual solve's Q
    and G hold that rank's rows only (G's columns in the permuted order);
    the decisions, the eigendecomposition, the Nystrom factors and X'X are
    the whole entity's."""
    F, n, nf = ent.F, int(ent.count), ent.num_features
    np_dt = config.np_dtype()
    secs: Dict[str, float] = {}
    with timed("bdf.build.operand") as t:
        rows, cols, vals, n_rows = F.rows, F.cols, F.values(), n
        if shard is not None:
            loc = shard.local[F.rows]
            own = loc >= 0
            rows, cols, vals, n_rows = loc[own], cols[own], vals[own], \
                shard.n_rows
        feat: Dict[str, Any] = {"colcount": torch.from_numpy(
            F.col_sq_sums().astype(np_dt)).to(device)}
        itemsize = dg.feat_itemsize(F.is_binary, config.gram_dtype, np_dt)
        if dg.use_dense_feat(n, nf, F.nnz, itemsize, config.dense_gram):
            X = torch.zeros((n_rows, nf), dtype=getattr(torch, config.dtype),
                            device=device)
            cells = tuple(torch.from_numpy(a.astype(np.int64)).to(device)
                          for a in (rows, cols))
            X.index_put_(cells,
                         torch.from_numpy(vals.astype(np_dt)).to(device),
                         accumulate=True)
            feat["dense_X"] = X
        else:
            feat["mv"] = build_bucketed_matvec(
                rows, cols, (n_rows, nf), vals=None if F.is_binary else vals,
                widths=config.bucket_widths, row_pad=config.row_pad,
                dtype=np_dt, device=device)
    secs["operand"] = t.seconds
    pref = ent.use_ff if ent.use_ff is not None else config.use_ff
    use_ff = (nf <= config.ff_threshold) if pref is None else bool(pref)
    solver = "ff" if use_ff else "cg"
    if not use_ff and use_dual(config.beta_solver, n, nf, np_dt.itemsize,
                               config.dual_budget_gb):
        solver = "dual"
        Q, d, G = dual_eig_cached(F.rows, F.cols, F.values(), F.shape, np_dt,
                                  config.dual_cache_dir, device,
                                  timings=secs)
        if shard is not None:
            ids = shard.ids
            Q_loc = Q.new_zeros((shard.n_rows, n))
            Q_loc[:ids.size] = Q[torch.from_numpy(ids).to(device)]
            G_loc = np.zeros((shard.n_rows, shard.n_cols), np_dt)
            G_loc[:ids.size, :n] = G[np.ix_(ids, shard.cols)]
            Q, G = Q_loc, G_loc
        feat["dual_Q"], feat["dual_d"] = Q, d
        feat["dual_G"] = torch.from_numpy(G.astype(np_dt)).to(device)
        del G
    rank = resolve_nystrom_rank(config.cg_nystrom_rank, nf)
    if solver == "cg" and rank and nf >= 4 * rank:
        with timed("bdf.build.nystrom") as t:
            Un, dn = build_nystrom(F.rows, F.cols, F.values(), F.shape, rank,
                                   seed=config.seed)
            feat["nys_U"] = torch.from_numpy(Un.astype(np_dt)).to(device)
            feat["nys_d"] = torch.from_numpy(dn.astype(np_dt)).to(device)
        secs["nystrom"] = t.seconds
    if use_ff:
        import scipy.sparse as sp
        with timed("bdf.build.ftf") as t:
            X = sp.coo_matrix((F.values().astype(np_dt), (F.rows, F.cols)),
                              shape=F.shape).tocsr()
            feat["ftf"] = torch.from_numpy(
                np.asarray((X.T @ X).todense(), np_dt)).to(device)
        secs["ftf"] = t.seconds
    return feat, secs, use_ff, solver


class CompiledProblem:
    """The device arrays and static description of one RelationData graph.

    ``plan`` is ``plan_gramians``' decision of the Gramian path of each
    (relation, mode), ``dense_plans`` its ``dense_plans``: an entry for a
    mode that contracts against a dense store, none for a mode on the
    gather path.  Per relation ``ri``, ``kinds[ri]`` names its store:
    "pair" (the dense pair of a relation with a dense mode, int8 where
    ``pair_i8s[ri]``), "fused" (the fused store, s8 where
    ``fused_i8s[ri]``, with a gather-path residual where
    ``residual_nnzs[ri]``) or "gather" (none); ``stores[ri]`` holds the
    pair or the fused store.  ``layouts["r{ri}m{mode}"]`` are the gather
    buckets of every gather mode and fused residual, ``dest_maps["e{ei}"]``
    the destination map of entity ``ei``'s buckets
    (``ops/gramian.build_dest_maps``).  Per entity ``ei``
    with side features, ``feat["e{ei}"]`` holds its beta draw's arrays
    (the dense X or the bucketed matvec, the column sums, and the
    solver's: the eigenbasis of XX' and G, the Nystrom factors, or X'X),
    and ``feat_seconds["e{ei}"]`` the seconds each took to build."""

    def __init__(self, rd: RelationData, config: MacauConfig,
                 device: torch.device):
        dtype = getattr(torch, config.dtype)
        self.config = config
        ent_index = {id(e): i for i, e in enumerate(rd.entities)}
        self.entity_specs = [EntitySpec(e.name, int(e.count))
                             for e in rd.entities]
        self.feat: Dict[str, Dict[str, Any]] = {}
        self.feat_seconds: Dict[str, Dict[str, float]] = {}
        self.rel_specs: List[RelationSpec] = []
        self.kinds: List[str] = []
        self.stores: List[Optional[dict]] = []
        self.pair_i8s: List[bool] = []
        self.fused_i8s: List[bool] = []
        self.residual_nnzs: List[int] = []
        self.layouts, self.padded_nnz = {}, []
        self.dest_maps: Dict[str, dict] = {}
        self.test, self.train = {}, {}
        self.layout_seconds = 0.0
        self._host_inst: Dict[str, List[np.ndarray]] = {}
        with timed("bdf.build") as build:
            self.plan = plan = plan_gramians(rd, config)
            self.dense_plans = plan.dense_plans
            for ri, rel in enumerate(rd.relations):
                mean_value = (float(rel.data.vals.mean()) if rel.data.nnz
                              else 0.0)
                rs = RelationSpec(
                    name=rel.name, arity=rel.arity,
                    entity_ids=tuple(ent_index[id(e)] for e in rel.entities),
                    nnz=rel.data.nnz, n_test=len(rel.test_vals),
                    alpha_sample=resolved_alpha_sample(rel, config),
                    mean_value=mean_value, class_cut=rel.class_cut)
                self.rel_specs.append(rs)
                self._build_relation(ri, rel, mean_value, config, device, plan)
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
                        if self.dense_plans else None)
            if self._host_inst:
                with timed("bdf.build.dest_map"):
                    self.dest_maps = build_dest_maps(
                        self.rel_specs, self._host_inst,
                        [es.n for es in self.entity_specs], device)
            del self._host_inst
            for ei, ent in enumerate(rd.entities):
                if ent.has_features:
                    self._build_features(ei, ent, config, device)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        self.build_seconds = build.seconds
        self.init_alpha = [resolved_alpha(rel, config)
                           for rel in rd.relations]
        self.init_lambda_beta = [resolved_lambda_beta(e, config)
                                 for e in rd.entities]
        self.random_spec = build_random_spec(
            [es.n for es in self.entity_specs], config.num_latent,
            config.resolved_nu0(), self.rel_specs, config.alpha_a0,
            [es.num_features for es in self.entity_specs],
            config.sample_lambda_beta, config.nu_beta)

    def flops_per_sweep(self) -> float:
        """The matmul work of one sweep (JAX ``flops_per_sweep``
        :410-449), for an effective rate over a measured ms/sweep; no
        engine decision reads it.  A dense (pair or fused) mode counts its
        relation's full contraction, 2 * prod(dims) * (C + K); a gather
        mode 2 * nnz * (K^2 + K) (a fused relation's residual is not
        counted, as in JAX); an entity
        with features its beta solver's products (CG: the right-hand side
        and uhat only, its iterations depend on the data)."""
        return sweep_flops(self, [es.n for es in self.entity_specs])

    def _build_features(self, ei, ent, config, device):
        """Entity ``ei``'s beta-draw arrays and solver
        (``build_features``), their build seconds and its spec."""
        with timed("bdf.build.features"):
            feat, secs, use_ff, solver = build_features(ent, config, device)
        self.feat[f"e{ei}"] = feat
        self.feat_seconds[f"e{ei}"] = secs
        self.entity_specs[ei] = dataclasses.replace(
            self.entity_specs[ei], num_features=ent.num_features,
            use_ff=use_ff, feat_nnz=ent.F.nnz, solver=solver)

    def _build_relation(self, ri, rel, mean_value, config, device, plan):
        """Relation ``ri``'s store and bucket layouts, as ``plan`` says
        (JAX engine :163-300): the fused store where the plan puts the
        relation on it; else, where any of its modes is dense, the pair
        (stored once for all its modes: int8 where ``plan.pair_i8``, else
        the float pair in the JAX store dtype, engine :109-118) and the
        gather layouts of its other modes; else the gather layouts of every
        mode."""
        store, pair_i8, fused_i8, resid = None, False, False, 0
        gather = [m for m in range(rel.arity)
                  if (ri, m) not in self.dense_plans]
        if ri in plan.fused:
            kind = "fused"
            store, fused_i8, resid = self._build_fused(
                ri, rel, mean_value, config, device, *plan.fused[ri])
        elif len(gather) < rel.arity:
            kind = "pair"
            centered = rel.data.vals - mean_value
            pair_i8 = plan.pair_i8[ri]
            with timed("bdf.build.store"):
                if pair_i8:
                    store = dg.build_int8_pair(rel.data.idx, centered,
                                               rel.data.shape,
                                               config.np_dtype(), device)
                else:
                    store = dg.build_dense_pair(
                        rel.data.idx, centered, rel.data.shape,
                        getattr(torch, config.gram_dtype or config.dtype),
                        device)
            if gather:
                self._build_layouts(ri, rel, mean_value, config, device,
                                    modes=gather)
        else:
            kind = "gather"
            self._build_layouts(ri, rel, mean_value, config, device)
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
        with timed("bdf.build.store"):
            fused_i8 = bool(config.dense_int8 and dg.fused_int8_ok(
                dg.fused_code_bound(vals, s, m), rel.data.shape, idx=idx,
                abs_codes=dg.fused_abs_codes(vals, s, m)))
            store = dg.build_fused_store(idx, vals, rel.data.shape, s, m,
                                         device)
        del idx, vals
        resid = 0
        if not keep.all():
            rows = np.nonzero(~keep)[0]
            resid = int(rows.size)
            self._build_layouts(ri, rel, mean_value, config, device, rows)
        return store, fused_i8, resid

    def _build_layouts(self, ri, rel, mean_value, config, device, rows=None,
                       modes=None):
        """The gather path's device arrays for relation ``ri`` (JAX engine
        :277-300): per mode ``layouts["r{ri}m{mode}"]``, a list of buckets
        (``inst`` and ``part`` int32, ``val`` and ``mask`` in the compute
        dtype).  Adds the seconds to build and upload them to
        ``layout_seconds`` and the padded observation count of each mode to
        ``padded_nnz``.  ``rows`` selects the observations (the fused
        path's residual), ``modes`` the modes; None takes all."""
        idx, centered = rel.data.idx, rel.data.vals - mean_value
        if rows is not None:
            idx, centered = idx[rows], centered[rows]
        with timed("bdf.build.layouts") as t:
            for mode in (range(rel.arity) if modes is None else modes):
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
        self.layout_seconds += t.seconds


class GibbsDriver:
    """The driver loop both engines run (JAX ``GibbsDriverMixin``
    :492-689): ``run``, ``benchmark`` and their windows, metric reads,
    jsonl log, trace, posterior-sample dumps and checkpoints.  An engine
    supplies ``config``, ``device``, ``dtype``, ``problem`` (its
    ``random_spec``, ``entity_specs`` and ``rel_specs``), ``init_state``,
    ``_sweep_with_randoms``, ``_results``, ``_save_sample`` and
    ``save_state``.  ``_writer`` says whether this process writes the log
    (the sharded engine's rank 0 alone does), ``_trace_tag`` is added to
    the trace file's name."""

    _writer = True
    _trace_tag = ""

    def draw(self, sweep: int, seed: Optional[int] = None
             ) -> Dict[str, torch.Tensor]:
        """The randoms of sweep ``sweep`` (1-based) of the chain ``seed``
        (the config's by default), on the device."""
        return draw_all(self.config.seed if seed is None else seed, sweep,
                        self.problem.random_spec, self.dtype, self.device)

    def _sweep(self, state, s: int, accumulate: float,
               seed: Optional[int] = None):
        with span("bdf.randoms", s + 1):
            randoms = self.draw(s + 1, seed)
        with span("bdf.sweep", s + 1):
            return self._sweep_with_randoms(state, randoms, accumulate)

    # -- run loops (JAX ``GibbsDriverMixin`` :492-689) ----------------------
    def run(self, state=None, seed: Optional[int] = None,
            num_sweeps: Optional[int] = None, sweep_offset: int = 0,
            callback: Optional[Callable] = None) -> Dict[str, Any]:
        """Run burnin + psamples sweeps (or ``num_sweeps``) of the chain
        ``seed`` (the config's by default: sweep s draws the randoms of
        (seed, s + 1), the state starts from ``init_state`` seeded by it);
        returns the reference-style results.

        ``sweep_offset`` resumes the chain at that sweep, from ``state``
        (``load_state``): the sweeps from there on draw and accumulate as
        the run without interruption does, so its results are the same
        bits.  The sweeps run in windows of up to ``sweeps_per_dispatch``,
        dispatched back to back with no host read inside; a window ends where
        ``_chunk_limit`` says.  At its end the metrics of the sweeps the
        host needs (every ``metrics_every``-th, the last, and all under
        verbose, a callback, a log file or the trace) are stacked and read
        back at once; the other sweeps' history holds only "time", the
        window's wall time over its sweeps.  ``callback(sweep, phase,
        metrics, dt)`` runs after every sweep; then the jsonl line, the
        posterior-sample dump and the checkpoint, where configured."""
        cfg = self.config
        if seed is None:
            seed = cfg.seed
        if state is None:
            state = self.init_state(
                torch.Generator(device=self.device).manual_seed(seed))
        total = (cfg.burnin + cfg.psamples if num_sweeps is None
                 else num_sweeps)
        history: List[Dict[str, float]] = []
        spd = max(cfg.sweeps_per_dispatch, 1)
        every = max(cfg.metrics_every, 1)
        log_f = (open(cfg.log_file, "a") if cfg.log_file and self._writer
                 else None)
        try:
            s = sweep_offset
            while s < total:
                trace_this = (cfg.trace_dir is not None
                              and s == min(2, total - 1))
                n = 1 if trace_this else min(
                    spd, self._chunk_limit(s, total) - s)
                fetch_js = [
                    j for j in range(n)
                    if ((s + j + 1) % every == 0 or s + j == total - 1
                        or cfg.verbose or callback is not None
                        or cfg.log_file is not None or trace_this)]
                t0 = time.perf_counter()
                with (self._trace(s) if trace_this
                      else contextlib.nullcontext()):
                    state, mstack = self._window(state, seed, s, n)
                    m_host = self._fetch([mstack[j] for j in fetch_js])
                dt = (time.perf_counter() - t0) / n
                fetched = dict(zip(fetch_js, m_host))
                for j in range(n):
                    i = s + j
                    metrics = fetched.get(j, {})
                    phase = "burnin" if i < cfg.burnin else "sample"
                    metrics["time"] = dt
                    history.append(metrics)
                    if log_f is not None:
                        log_f.write(json.dumps(
                            {"sweep": i + 1, "phase": phase,
                             **metrics}) + "\n")
                        log_f.flush()
                    if cfg.output_prefix is not None and i >= cfg.burnin:
                        # windows are one sweep long in the psamples phase
                        # under output_prefix (_chunk_limit), so ``state``
                        # is sweep i's
                        self._save_sample(cfg.output_prefix,
                                          i - cfg.burnin, state)
                    if (cfg.checkpoint_every and cfg.checkpoint_path
                            and (i + 1) % cfg.checkpoint_every == 0):
                        self.save_state(cfg.checkpoint_path, state, i + 1)
                    if callback is not None:
                        callback(i, phase, metrics, dt)
                    if cfg.verbose and self._writer:
                        self._print_sweep(i, phase, metrics)
                s += n
        finally:
            if log_f is not None:
                log_f.close()
        return self._results(state, history)

    def _window(self, state, seed: int, start: int, n: int):
        """Sweeps [start, start + n), dispatched back to back: (state, each
        sweep's metrics, still on the device)."""
        burnin = self.config.burnin
        mstack = []
        with full_float32(), span("bdf.window", start + 1):
            for s in range(start, start + n):
                state, m = self._sweep(state, s,
                                       1.0 if s >= burnin else 0.0, seed)
                mstack.append(m)
        return state, mstack

    @staticmethod
    def _fetch(metric_dicts) -> List[Dict[str, float]]:
        """The metric dicts as host floats, their device values stacked and
        read back by one copy (which waits for the device)."""
        with span("bdf.fetch"):
            vals = [v for m in metric_dicts for v in m.values()
                    if torch.is_tensor(v)]
            host = iter(torch.stack([v.reshape(()).to(torch.float64)
                                     for v in vals]).tolist() if vals else ())
            return [{k: next(host) if torch.is_tensor(v) else float(v)
                     for k, v in m.items()} for m in metric_dicts]

    @contextlib.contextmanager
    def _trace(self, s: int):
        """A ``torch.profiler`` trace of the sweep run inside, CPU and (on
        the card) CUDA activity, written into ``trace_dir`` as a Chrome
        trace.  On the card a trace without device activity (the profiler
        could not reach CUPTI) raises rather than pass for a trace."""
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(self.config.trace_dir, exist_ok=True)
        with profile(activities=acts) as prof:
            yield
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        if self.device.type == "cuda" and not any(
                e.device_type == torch.autograd.DeviceType.CUDA
                for e in prof.events()):
            raise RuntimeError(
                f"torch.profiler recorded no CUDA activity in sweep {s + 1}:"
                f" it cannot trace the card here")
        prof.export_chrome_trace(os.path.join(
            self.config.trace_dir,
            f"sweep{s + 1:04d}{self._trace_tag}.pt.trace.json"))

    def _chunk_limit(self, s: int, total: int) -> int:
        """The exclusive end of a window starting at sweep ``s`` (JAX
        :646-664): a window must end at every sweep whose host work needs
        that sweep's state (a checkpoint, a posterior-sample dump) and
        before the traced sweep."""
        cfg = self.config
        end = total
        if cfg.trace_dir is not None:
            t = min(2, total - 1)
            if t > s:
                end = min(end, t)  # stop before the traced sweep
        ce = cfg.checkpoint_every
        if ce and cfg.checkpoint_path:
            nxt = s + ((ce - ((s + 1) % ce)) % ce)  # first i>=s, (i+1)%ce==0
            end = min(end, nxt + 1)
        if cfg.output_prefix is not None:
            # every sweep >= burnin dumps a posterior sample
            end = min(end, cfg.burnin if s < cfg.burnin else s + 1)
        return max(end, s + 1)

    def benchmark(self, num_sweeps: int, repeats: int = 1
                  ) -> Dict[str, Any]:
        """Timing entry point, the JAX engine's protocol (:586-644): one
        untimed warm window of ``num_sweeps`` sweeps, then ``repeats``
        timed windows of ``num_sweeps`` each, continuing one chain; each
        runs in sub-windows of ``sweeps_per_dispatch`` sweeps, as JAX's
        ``run_window`` does, and ends with one device-to-host read of its
        last metrics.

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
        spd = max(cfg.sweeps_per_dispatch, 1)

        def run_window(state, start):
            t0 = time.perf_counter()
            s = start
            while s < start + num_sweeps:
                c = min(spd, start + num_sweeps - s)
                state, mstack = self._window(state, cfg.seed, s, c)
                s += c
            last = self._fetch(mstack[-1:])[0]   # waits for the window
            return state, last, time.perf_counter() - t0

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


class MacauEngine(GibbsDriver):
    """Gibbs engine for one RelationData graph on one device."""

    def __init__(self, rd: RelationData, config: MacauConfig,
                 device="cuda"):
        self.config = config
        self.device = _resolve_device(device)
        self.dtype = getattr(torch, config.dtype)
        with full_float32():
            self.problem = CompiledProblem(rd, config, self.device)
        # the sweep's short phases of small operations (the beta draw, the
        # Normal-Wishart draws' K x K part, the AUC) replayed from CUDA
        # graphs on the card (``utils/graphs.py``), where a dual-solve beta
        # draw (some 130 operations a sweep, on a relation whose other
        # phases are short) puts the host's time over the card's; their
        # capture stream's cuBLAS workspace (32 MiB) is not spent on an
        # engine without one.  ``graphs.enabled = False`` runs them eagerly
        self.graphs = Graphs(enabled=any(
            es.has_features and es.solver == "dual"
            for es in self.problem.entity_specs))

    # -- state ---------------------------------------------------------------
    def init_state(self, generator: Optional[torch.Generator] = None
                   ) -> Dict[str, Any]:
        """U ~ init_std * N(0, I), mu = 0, Lambda = I, alpha from config;
        with side features beta = 0, uhat = 0 and lambda_beta from the
        entity or the config (JAX engine :710-740)."""
        cfg = self.config
        K, dt, dev = cfg.num_latent, self.dtype, self.device
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(cfg.seed)
        ents = []
        for ei, es in enumerate(self.problem.entity_specs):
            ent = {"U": cfg.init_std * torch.randn((es.n, K),
                                                   generator=generator,
                                                   dtype=dt, device=dev),
                   "mu": torch.zeros(K, dtype=dt, device=dev),
                   "Lambda": torch.eye(K, dtype=dt, device=dev)}
            if es.has_features:
                ent["beta"] = torch.zeros((es.num_features, K), dtype=dt,
                                          device=dev)
                ent["uhat"] = torch.zeros((es.n, K), dtype=dt, device=dev)
                ent["lambda_beta"] = torch.tensor(
                    self.problem.init_lambda_beta[ei], dtype=dt, device=dev)
            ents.append(ent)
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
    def _sweep_with_randoms(self, state, randoms, accumulate: float):
        """One Gibbs sweep (JAX engine :747-998): each entity in turn, then
        the alpha draws, then the predictions."""
        cfg = self.config
        nu0 = cfg.resolved_nu0()
        prob = self.problem
        metrics: Dict[str, torch.Tensor] = {}
        ents = [dict(e) for e in state["ent"]]
        rels = list(state["rel"])

        for ei, es in enumerate(prob.entity_specs):
            ent = ents[ei]
            uhat = None
            if es.has_features:
                # beta first, with the current Lambda (JAX :765-778)
                with span(f"bdf.e{ei}.beta"):
                    (ent["beta"], ent["uhat"], ent["lambda_beta"],
                     cg_diag) = self._sample_beta(ei, ent, randoms)
                if cg_diag is not None:
                    metrics[f"e{ei}.cg_iters"] = cg_diag[0]
                    metrics[f"e{ei}.cg_resid"] = cg_diag[1]
                uhat = ent["uhat"]
            with span(f"bdf.e{ei}.hyper"):
                mu, Lambda = normal_wishart_update(
                    ent["U"] if uhat is None else ent["U"] - uhat, cfg.nw_b0,
                    nu0, 2.0 * randoms[f"e{ei}.nw_g"],
                    randoms[f"e{ei}.nw_tri"], randoms[f"e{ei}.nw_mu"],
                    self._graphed_from_moments(ei))
            ent["mu"], ent["Lambda"] = mu, Lambda
            dense, contribs = self._contributions(ei, ents, rels)
            ent["U"] = self._sample(ei, ent, dense, contribs,
                                    randoms[f"e{ei}.xi"], uhat)
            metrics[f"e{ei}.unorm"] = torch.linalg.norm(ent["U"])
            if es.has_features:
                metrics[f"e{ei}.betanorm"] = torch.linalg.norm(ent["beta"])
                metrics[f"e{ei}.lambda_beta"] = ent["lambda_beta"]

        # noise precisions (JAX engine :953-965)
        for ri, rs in enumerate(prob.rel_specs):
            if not rs.alpha_sample:
                continue
            with span(f"bdf.r{ri}.alpha"):
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
            with span(f"bdf.r{ri}.predict"):
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
                if rs.class_cut is not None:
                    # the AUC of the running posterior mean (JAX :991-996)
                    def auc(pm, vals=te["vals"], cut=rs.class_cut):
                        labels = (vals < cut).to(self.dtype)
                        return (auc_device(labels, -pm),)
                    metrics[f"{key}.auc"], = self.graphs(("auc", ri), auc,
                                                         pmean)
        return {"ent": ents, "rel": rels, "pred": preds}, metrics

    def _contributions(self, ei, ents, rels):
        """Entity ``ei``'s contributions from every (relation, mode) it
        fills, the partners read from the current state ``ents`` (the
        entity's own U too, in a relation where it fills two modes) (JAX
        engine :792-806): (dense, contribs), (relation, mode, partners,
        alpha) of each dense mode and (alpha, partners, bucket) of each
        gather bucket, in the order of the entity's destination map."""
        prob = self.problem
        dense, contribs = [], []
        for ri, rs in enumerate(prob.rel_specs):
            for mode, e in enumerate(rs.entity_ids):
                if e != ei:
                    continue
                partners = [ents[rs.entity_ids[d]]["U"]
                            for d in range(rs.arity) if d != mode]
                alpha = rels[ri]["alpha"]
                if (ri, mode) in prob.dense_plans:
                    dense.append((ri, mode, partners, alpha))
                for ba in prob.layouts.get(f"r{ri}m{mode}", ()):
                    contribs.append((alpha, partners, ba))
        return dense, contribs

    def _graphed_from_moments(self, ei):
        """``normal_wishart_from_moments`` of entity ``ei``, its K x K
        draw replayed from a graph (``utils/graphs.py``)."""
        def from_moments(N, Sbar, scatter, b0, nu0, chi2, tri, mu_normals):
            def draw(*a):
                return normal_wishart_from_moments(N, a[0], a[1], b0, nu0,
                                                   *a[2:])
            return self.graphs(("hyper", ei), draw, Sbar, scatter, chi2,
                               tri, mu_normals)
        return from_moments

    def _feat_ops(self, ei):
        """Entity ``ei``'s (X @ V, X' @ U): on the dense X by
        ``torch.matmul``, else on the bucketed matvec (JAX :1062-1090)."""
        feat = self.problem.feat[f"e{ei}"]
        X = feat.get("dense_X")
        if X is not None:
            return (lambda V: X @ V), (lambda V: X.mT @ V)
        es = self.problem.entity_specs[ei]
        mv = feat["mv"]
        return (lambda V: bucketed_spmm(mv["fwd"], es.n, V),
                lambda V: bucketed_spmm(mv["t"], es.num_features, V))

    def _beta_rhs(self, ei, ent, U, e1, e2):
        """The right-hand side X'(U - mu + E1) + sqrt(lambda_beta) E2 of
        entity ``ei``'s beta draw from its rows ``U`` and their normals
        ``e1`` ([n, K]; the sharded engine passes its own rows) and ``e2``
        [F, K], E1 and E2 rows ~ N(0, Lambda^-1) (JAX :1054-1094)."""
        with span("bdf.beta_rhs"):
            L, _ = torch.linalg.cholesky_ex(ent["Lambda"])

            def colored(z):                      # L^-T z' per row
                return solve_triangular(L.mT, z.mT, upper=True).mT
            resid = U - ent["mu"][None, :] + colored(e1)
            return (self._feat_ops(ei)[1](resid) + torch.sqrt(
                ent["lambda_beta"]) * colored(e2))

    def _solve_beta(self, ei, rhs, lam, beta0):
        """(beta, uhat, cg_diag) from (X'X + lam I) beta = rhs by entity
        ``ei``'s solver (JAX :1096-1137): "ff" a Cholesky solve on X'X;
        "dual" ``dual_solve_g`` (uhat = its z); "cg" ``block_cg`` warm
        from ``beta0``, Nystrom- or Jacobi-preconditioned, to
        max(cg_tol, 1e-5) in float32, with cg_diag (iterations, the
        exit-time true relative residual)."""
        cfg = self.config
        es = self.problem.entity_specs[ei]
        feat = self.problem.feat[f"e{ei}"]
        fwd, t = self._feat_ops(ei)
        if es.solver == "dual":
            with span("bdf.beta_solve"):
                beta, uhat = dual_solve_g(
                    feat["dual_Q"], feat["dual_d"], feat["dual_G"], lam, rhs,
                    fwd, t, cfg.dual_refine, reduce=self._allreduce,
                    gather=self._allgather)
            return beta, uhat, None
        cg_diag = None
        with span("bdf.beta_solve"):
            if es.solver == "ff":
                A = feat["ftf"] + lam * torch.eye(
                    es.num_features, dtype=self.dtype, device=self.device)
                beta = chol_solve(A, rhs)
            else:
                tol = (cfg.cg_tol if self.dtype == torch.float64
                       else max(cfg.cg_tol, 1e-5))
                precond = None
                if "nys_U" in feat:
                    Un, dn = feat["nys_U"], feat["nys_d"]
                    precond = lambda r: nystrom_apply(  # noqa: E731
                        Un, dn, lam, r)
                beta, it, resid = block_cg(
                    lambda V: t(fwd(V)) + lam * V, rhs, beta0, tol=tol,
                    maxiter=cfg.cg_maxiter,
                    precond_diag=feat["colcount"] + lam, precond=precond)
                cg_diag = (it, resid)
        with span("bdf.beta_fwd"):
            return beta, fwd(beta), cg_diag

    def _draw_lambda_beta(self, ei, beta, Lambda, randoms):
        """Entity ``ei``'s lambda_beta | beta, Lambda (the Lambda entering
        the sweep: it is drawn before the Normal-Wishart)."""
        with span("bdf.lambda_beta"):
            cfg = self.config
            return sample_lambda_beta(beta, Lambda, randoms[f"e{ei}.lb_g"],
                                      cfg.nu_beta, cfg.lambda_beta_mean)

    def _sample_beta(self, ei, ent, randoms):
        """Entity ``ei``'s noise-injected exact Gibbs draw of beta
        (``_beta_rhs``, then ``_solve_beta``), then lambda_beta's
        (``_draw_lambda_beta``, else it stays): (beta, uhat = X beta,
        lambda_beta, cg_diag).  The dual solve's draw reads nothing back
        to the host, so it replays from a graph (``utils/graphs.py``);
        CG reads its stopping test every iteration and runs eagerly."""
        names = ["beta_e1", "beta_e2"] + (
            ["lb_g"] if self.config.sample_lambda_beta else [])

        def draw(U, mu, Lambda, lam, beta0, *r):
            rnd = {f"e{ei}.{k}": v for k, v in zip(names, r)}
            rhs = self._beta_rhs(ei, {"mu": mu, "Lambda": Lambda,
                                      "lambda_beta": lam}, U,
                                 rnd[f"e{ei}.beta_e1"], rnd[f"e{ei}.beta_e2"])
            beta, uhat, cg_diag = self._solve_beta(ei, rhs, lam, beta0)
            if self.config.sample_lambda_beta:
                lam = self._draw_lambda_beta(ei, beta, Lambda, rnd)
            return beta, uhat, lam, cg_diag

        args = [ent["U"], ent["mu"], ent["Lambda"], ent["lambda_beta"]]
        r = [randoms[f"e{ei}.{k}"] for k in names]
        if self.problem.entity_specs[ei].solver != "dual":
            return draw(*args, ent["beta"], *r)
        # the dual solve reads no warm start
        return (*self.graphs(("beta", ei),
                             lambda *a: draw(*a[:4], None, *a[4:])[:3],
                             *args, *r), None)

    # the collectives of the pieces above and below: none on one device;
    # the sharded engine sums over its ranks (``_allreduce``) and gathers
    # its ranks' rows (``_allgather``)
    @staticmethod
    def _allreduce(t: torch.Tensor) -> torch.Tensor:
        return t

    @staticmethod
    def _allgather(t: torch.Tensor) -> torch.Tensor:
        return t

    def _local_rows(self, ei) -> Tuple[int, int]:
        """(rows this process samples of entity ``ei``, ghost rows after
        them, which the sharded engine's ``_fold_ghosts`` folds): all of
        them, and none, on one device."""
        return self.problem.entity_specs[ei].n, 0

    def _sample(self, ei, ent, dense, contribs, xi, uhat=None):
        """The draw of entity ``ei``'s rows (``_precision``, then
        ``_draw_rows``)."""
        with span(f"bdf.e{ei}.precision"):
            prec = self._precision(ei, ent, dense, contribs, uhat)
        with span(f"bdf.e{ei}.draw"):
            return self._draw_rows(prec, xi)

    def _precision(self, ei, ent, dense, contribs, uhat=None):
        """The conditional precision of entity ``ei``'s rows from its
        ``dense`` contributions ((relation, mode, partners, alpha)) and its
        gather buckets ``contribs`` ((alpha, partners, bucket)), for
        ``_draw_rows``: (layout, P, b, Lambda for the sampler or None).

        K <= 96 with a dense contribution and "segment" accumulation keeps
        P packed (JAX engine :818-923): the dense contributions summed in
        the transposed [C, n] layout, the buckets added into it
        (``packed_bucket_accum``), then the packed sampler (K1, K2).
        Otherwise (JAX :924-951) P is full: the buckets through
        ``assemble_precision`` and the entity's destination map (Lambda left
        to the sampler, or in P under "planned"), the dense contributions
        unpacked and added, then the full-P sampler (K3, K4, the blocked one
        above K = 96); an entity with no contribution draws from its
        prior.  The prior term is Lambda (mu + uhat_i) for
        each row i of an entity with side features (``uhat`` [n, K]), else
        Lambda mu.  The rows are ``_local_rows``' (the sharded engine's
        own); with ghost rows after them (head splitting) the buckets are
        assembled over both, then ``_fold_ghosts`` folds the ghosts into
        their owners' rows (JAX sharded.py:1248-1263)."""
        cfg = self.config
        K = cfg.num_latent
        n, n_ghost = self._local_rows(ei)
        mu, Lambda = ent["mu"], ent["Lambda"]
        prior_mean = mu if uhat is None else mu + uhat
        gd = getattr(torch, cfg.gram_dtype) if cfg.gram_dtype else None
        if (K <= K2_MAX_K and dense and cfg.accumulation != "planned"
                and not n_ghost):
            P = b = None
            for ri, mode, partners, alpha in dense:
                with span(f"bdf.r{ri}m{mode}.dense"):
                    P_d, b_d = self._dense_contrib(ri, mode, partners, alpha,
                                                   packed=True)
                    # the first contribution is a fresh output, summed into
                    P, b = (P_d, b_d) if P is None else (P.add_(P_d),
                                                         b.add_(b_d))
            if contribs:
                with span(f"bdf.e{ei}.buckets"):
                    packed_bucket_accum(contribs, n, K, gram_dtype=gd,
                                        transposed=True, out=(P, b),
                                        tri=self.problem.tri)
            b = (mu @ Lambda)[:, None] + b if uhat is None else \
                (prior_mean @ Lambda).mT + b
            return "packed", P, b, Lambda
        dest_map = self.problem.dest_maps.get(f"e{ei}")
        # Lambda in P under "planned", but for ghost rows, which are folded
        # into their owners' rows after the assembly
        fuse = cfg.accumulation != "planned" or bool(n_ghost)
        if n_ghost:
            prior_ext = torch.cat([prior_mean.expand(n, K),
                                   prior_mean.new_zeros((n_ghost, K))])
            with span(f"bdf.e{ei}.buckets"):
                P, b = self._fold_ghosts(ei, *assemble_precision(
                    Lambda, prior_ext, contribs, n + n_ghost, gram_dtype=gd,
                    fuse_lambda=True, dest_map=dest_map))
        elif contribs or not dense or not fuse:
            with span(f"bdf.e{ei}.buckets"):
                P, b = assemble_precision(
                    Lambda, prior_mean, contribs, n, gram_dtype=gd,
                    fuse_lambda=fuse, dest_map=dest_map)
        else:
            # dense contributions alone: the first one's fresh [n, K, K]
            # output is the accumulator, which saves an [n, K, K] buffer
            # (4.7 GB at K = 128 on ML-10M)
            P = None
            b = prior_mean @ Lambda
        for ri, mode, partners, alpha in dense:
            with span(f"bdf.r{ri}m{mode}.dense"):
                P_d, b_d = self._dense_contrib(ri, mode, partners, alpha,
                                               packed=False)
                P = P_d if P is None else P.add_(P_d)
                b = b + b_d
                del P_d
        return "full", P, b, Lambda if fuse else None

    def _draw_rows(self, prec, xi, rows=slice(None)):
        """u ~ N(P'^-1 b, P'^-1) for the rows ``rows`` of ``_precision``'s
        ``prec`` with their normals ``xi`` [rows, K]: the packed sampler
        (K1, K2) or the full-P one (``chol_sample_dispatch``; P is fresh,
        and the dispatch adds Lambda to it in place above K = 96)."""
        layout, P, b, lam = prec
        if layout == "packed":
            return chol_sample_packed_dispatch(P[:, rows], b[:, rows], xi,
                                               lam, self.config.chol_jitter,
                                               transposed=True)
        return chol_sample_dispatch(P[rows], b[rows], xi, lam,
                                    self.config.chol_jitter)

    def _dense_contrib(self, ri, mode, partners, alpha, packed):
        """Relation ``ri``'s alpha-scaled contribution to focus ``mode``, in
        the packed transposed layout (P [C, n], b [K, n]) or unpacked (P
        [n, K, K], b [n, K]), fresh tensors either way: the int8 pair (K7
        and K6; alpha folded into the dequant scales), the float pair, the
        fused s8 store (K7 and K8; alpha folded) or the fused float store
        (the table in ``gram_dtype``, alpha multiplied after) (JAX engine
        :1000-1042)."""
        return self._store_contrib(self.problem.stores[ri], ri, mode,
                                   partners, alpha, packed)

    def _store_contrib(self, store, ri, mode, partners, alpha, packed):
        """``_dense_contrib`` from ``store``, relation ``ri``'s pair or
        fused store or one rank's slab of it, for its focus ``mode``."""
        cfg = self.config
        prob = self.problem
        dtype = self.dtype
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

    def _results(self, state, history) -> Dict[str, Any]:
        """Reference-style result dict (JAX engine :1179): per relation with
        a test split, under its name, the RMSE of the posterior mean and
        the test predictions with their posterior stdev (and, under a
        ``class_cut``, the AUC and the accuracy of the posterior mean);
        relation 0's also at the top level."""
        out: Dict[str, Any] = {"state": state, "history": history}
        preds = self._gathered_preds(state)
        for ri, rs in enumerate(self.problem.rel_specs):
            key = f"r{ri}"
            if key not in preds:
                continue
            pr = {k: v.detach().cpu().numpy() for k, v in
                  preds[key].items()}
            n = max(float(pr["n"]), 1.0)
            pmean = pr["sum"] / n
            pvar = np.maximum(pr["sum2"] / n - pmean ** 2, 0.0)
            te_idx, te_val = self._test_split(ri)
            rel_out = {"RMSE": float(np.sqrt(np.mean((pmean - te_val) ** 2))),
                       "predictions": {"idx": te_idx, "obs": te_val,
                                       "pred": pmean,
                                       "stdev": np.sqrt(pvar)}}
            if rs.class_cut is not None:
                obs_cls = te_val < rs.class_cut
                rel_out["AUC"] = _auc(obs_cls, -pmean)
                rel_out["accuracy"] = float(
                    np.mean((pmean < rs.class_cut) == obs_cls))
            out[rs.name] = rel_out
            if ri == 0:
                out.update(rel_out)
        return out

    def _gathered_preds(self, state):
        """Every relation's prediction sums over its whole test split."""
        return state["pred"]

    def _test_split(self, ri):
        """(test tuples, test values) of relation ``ri`` as numpy."""
        te = self.problem.test[f"r{ri}"]
        return te["idx"].cpu().numpy(), te["vals"].cpu().numpy()

    # -- posterior samples and checkpoints (JAX :1166-1177, :1213-1224) ----
    def _save_sample(self, prefix: str, psample_idx: int, state) -> None:
        """One posterior sample, ``{prefix}-sample{idx:04d}.npz``, with the
        JAX package's keys: ``e{i}.U``, ``e{i}.mu``, ``e{i}.Lambda`` (and,
        with side features, ``e{i}.beta``, ``e{i}.lambda_beta``,
        ``e{i}.uhat``) and ``r{i}.alpha``; ``predict_out_of_matrix`` reads
        them."""
        st = state_to_numpy(state)
        out = {}
        for ei, ent in enumerate(st["ent"]):
            for k, v in ent.items():
                out[f"e{ei}.{k}"] = v
        for ri, rel in enumerate(st["rel"]):
            out[f"r{ri}.alpha"] = rel["alpha"]
        np.savez(f"{prefix}-sample{psample_idx:04d}.npz", **out)

    def save_state(self, path: str, state, sweep: int) -> None:
        """The state after ``sweep`` sweeps as an npz of ``sweep``,
        ``n_leaves`` and ``leaf{i}``, the leaves in the order of
        ``jax.tree_util.tree_flatten`` (``_leaves``), so either package
        loads the other's file."""
        flat = _leaves(state_to_numpy(state))
        np.savez(path, sweep=sweep, n_leaves=len(flat),
                 **{f"leaf{i}": a for i, a in enumerate(flat)})

    def load_state(self, path: str):
        """(state, sweep) from a ``save_state`` file of either package, the
        leaves on the engine's device in its dtype; resume with
        ``run(state=state, sweep_offset=sweep)``."""
        return self._read_state(path, self.init_state())

    def _read_state(self, path: str, template):
        """(state, sweep) from a ``save_state`` file, in ``template``'s
        structure, on the engine's device in its dtype."""
        z = np.load(path)
        n = len(_leaves(template))
        if int(z["n_leaves"]) != n:
            raise ValueError(f"{path}: {int(z['n_leaves'])} leaves, this "
                             f"engine's state has {n}")
        leaves = iter(state_from_numpy([z[f"leaf{i}"] for i in range(n)],
                                       self.device, self.dtype))
        return _unflatten(template, leaves), int(z["sweep"])


def auc_device(labels: torch.Tensor, scores: torch.Tensor,
               weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Binary AUC by the midrank statistic, on the device (JAX
    ``engine.auc_device`` :1242): the labels sorted along with the scores,
    each tie group's first and last 1-based index found by running max /
    min scans over the group boundaries, ranks their mean, so tied scores
    agree with the host ``_auc``.  ``weights`` (0/1) leave out padding
    entries, whose scores must lie above every real score (+inf)."""
    dtype = scores.dtype
    n = scores.shape[0]
    s, order = torch.sort(scores, stable=True)
    lab = labels.to(dtype)[order]
    idx = torch.arange(1, n + 1, device=scores.device)
    one = torch.ones(1, dtype=torch.bool, device=scores.device)
    brk = s[1:] != s[:-1]                       # tie-group boundaries
    start = torch.cummax(torch.where(torch.cat([one, brk]), idx, 0), 0)[0]
    end = torch.flip(torch.cummin(torch.flip(
        torch.where(torch.cat([brk, one]), idx, n + 1), (0,)), 0)[0], (0,))
    ranks = 0.5 * (start + end).to(dtype)
    if weights is None:
        n_pos = torch.sum(labels.to(dtype))
        n_neg = n - n_pos
    else:
        w = weights.to(dtype)
        lab = lab * w[order]
        n_pos = torch.sum(labels.to(dtype) * w)
        n_neg = torch.sum(w) - n_pos
    r_pos = torch.sum(ranks * lab)
    return ((r_pos - n_pos * (n_pos + 1) / 2.0)
            / torch.clamp_min(n_pos * n_neg, 1.0))


def _auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Binary AUC by the rank statistic, midranks for ties, on the host
    (JAX ``engine._auc`` :1287); NaN without both classes."""
    pos = scores[labels]
    neg = scores[~labels]
    if len(pos) == 0 or len(neg) == 0:
        return float("nan")
    allv = np.concatenate([pos, neg])
    order = np.argsort(allv, kind="stable")
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(order) + 1)
    sv = allv[order]
    i = 0
    while i < len(sv):
        j = i
        while j + 1 < len(sv) and sv[j + 1] == sv[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = (i + 1 + j + 1) / 2.0
        i = j + 1
    n_p, n_n = len(pos), len(neg)
    return float((ranks[:n_p].sum() - n_p * (n_p + 1) / 2.0) / (n_p * n_n))


def _leaves(tree) -> list:
    """The leaves of nested dicts and lists in ``jax.tree_util``'s order:
    a dict's values by sorted key, a list's in order."""
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [a for v in tree for a in _leaves(v)]
    return [tree]


def _unflatten(template, leaves):
    """``template``'s structure with the next of ``leaves`` at each leaf,
    in ``_leaves``'s order."""
    if isinstance(template, dict):
        filled = {k: _unflatten(template[k], leaves)
                  for k in sorted(template)}
        return {k: filled[k] for k in template}
    if isinstance(template, (list, tuple)):
        return [_unflatten(v, leaves) for v in template]
    return next(leaves)


def predictions_frame(result: Dict[str, Any], relation=None):
    """The reference's predictions table (JAX :1227-1239): a pandas
    DataFrame of the index columns, obs, pred and stdev of ``result``
    (``macau()``'s return) or of its relation ``relation``.  pandas is
    imported here, and only here."""
    import pandas as pd
    src = result[relation] if relation is not None else result
    p = src["predictions"]
    d = {f"idx{d_}": p["idx"][:, d_] for d_ in range(p["idx"].shape[1])}
    d.update(obs=p["obs"], pred=p["pred"], stdev=p["stdev"])
    return pd.DataFrame(d)


def predict_out_of_matrix(prefix: str, x_new, feat_entity: int = 0,
                          partner_entity: int = 1,
                          relation_mean: float = 0.0,
                          partner_rows: Optional[np.ndarray] = None
                          ) -> np.ndarray:
    """Predictions for new instances of ``feat_entity`` from the posterior
    samples saved under ``output_prefix`` (JAX :1312-1343; numpy only):
    u_new = mu + x_new beta, pred = relation_mean + u_new V' against the
    partner's U (its ``partner_rows``), averaged over the samples.
    ``x_new`` is [n_new, F]."""
    files = sorted(glob.glob(f"{prefix}-sample*.npz"))
    if not files:
        raise FileNotFoundError(f"no saved samples at {prefix}-sample*.npz")
    x_new = np.asarray(x_new, np.float64)
    acc = None
    for fn in files:
        z = np.load(fn)
        beta = z[f"e{feat_entity}.beta"]
        mu = z[f"e{feat_entity}.mu"]
        V = z[f"e{partner_entity}.U"]
        if partner_rows is not None:
            V = V[np.asarray(partner_rows)]
        u_new = mu[None, :] + x_new @ beta
        p = relation_mean + u_new @ V.T
        acc = p if acc is None else acc + p
    return acc / len(files)


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
    kwargs go into MacauConfig (the driver's options among them:
    ``metrics_every``, ``sweeps_per_dispatch``, ``log_file``,
    ``output_prefix``, ``trace_dir``, ``checkpoint_every`` and
    ``checkpoint_path``)."""
    if config is None:
        config = MacauConfig(
            num_latent=num_latent, burnin=burnin, psamples=psamples,
            clamp=tuple(clamp) if clamp is not None else None,
            verbose=verbose, seed=seed, **kwargs)
    return MacauEngine(data, config, device=device).run()
