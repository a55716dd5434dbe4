"""The sharded Gibbs engine: hash-partitioned entities on torch.distributed.

Port of ``bayesiandatafusion_jl_tpu/parallel/sharded.py``.  One process per
device (``parallel/mesh.py``: NCCL between CUDA devices, gloo between CPU
processes); the engine goes through its collectives at every world size,
1 included:

  - every entity's instances are hash-partitioned over the ranks by a
    permutation that does not depend on the world size
    (``instance_permutation``), padded to a multiple of the world size;
    rank r owns the positions [r n_loc, (r + 1) n_loc);
  - each rank builds only its own shard of the problem (``ShardedProblem``)
    and assembles the Gramians and samples only its rows, on the same
    kernels as the single-device engine: a dense pair as one focus-led slab
    per mode (K6, K7), the fused store as the rank's row slab (K8, K7: mode
    0 contracts it locally; mode 1 contracts the sharded axis in exact
    int32 and reduce-scatters the partial sums, so the total is the single
    engine's bit for bit), the gather path over the rank's observations;
  - the sampled rows are exchanged by ``all_gather_into_tensor``, in
    ``exchange_blocks`` blocks whose gathers overlap the next block's
    sampling, so the next entity reads a replicated factor matrix;
  - the Normal-Wishart, lambda_beta and alpha draws reduce sufficient
    statistics with ``all_reduce`` and then every rank makes the same draw
    from the same randoms; the beta draw's X'(X v) and Q't sum over the
    ranks, the dual refinement gathers z;
  - instances of very high gather-path degree (``head_split_degree``) have
    their observations dealt to every rank into ghost rows, whose Gramians
    are summed over the ranks and folded into the owner's rows.

Randoms are drawn in original instance order with the single-device
engine's spec (``utils/rng.draw_all``, keyed by (seed, sweep, name)) and
each rank takes its rows, so a sharded chain is the single-device chain up
to the order of the float sums.  The state is ``{"ent": [...], "rel":
[...], "uhat": {"e{i}": this rank's rows}, "pred": {"r{i}": this rank's
test chunk}}``, U replicated in permuted, padded order;
``shard_state`` and ``unshard_state`` carry a state to and from the
single-device engine's layout, in which the checkpoints and posterior
samples are written (rank 0 writes, every rank reads).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..models.data import (RelationData, resolved_alpha,
                           resolved_alpha_sample, resolved_lambda_beta)
from ..models.engine import (EntitySpec, MacauEngine, RelationSpec, RowShard,
                             _resolve_device, auc_device, build_features,
                             full_float32, plan_gramians, sweep_flops)
from ..ops import dense_gram as dg
from ..ops.gramian import plan_accumulation, predict_tuples
from ..ops.hyper import normal_wishart_from_moments, sample_alpha
from ..ops.layout import build_mode_layout
from ..ops.spmv import bucketed_spmm
from ..utils.config import MacauConfig
from ..utils.rng import build_random_spec
from ..utils.spans import span, timed
from .mesh import backend_for, data_group, instance_permutation


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def resolve_head_split(cfg_value, deg: np.ndarray, n_dev: int):
    """Head-split threshold for one entity (JAX :63): ``None`` = off, an
    int = that threshold, "auto" = engage exactly when one instance's
    gather-path degree exceeds max(2048, a quarter of a rank's average
    gather work); anything else raises.  Returns the threshold or None."""
    if cfg_value is None or isinstance(cfg_value, (int, np.integer)):
        return cfg_value
    if cfg_value != "auto":
        raise ValueError(f"head_split_degree={cfg_value!r}")
    if n_dev <= 1 or deg.size == 0:
        return None
    total = float(deg.sum())
    if total == 0.0:
        return None
    thr = max(2048.0, 0.25 * total / n_dev)
    return int(thr) if float(deg.max()) > thr else None


def resolve_exchange_blocks(cfg_value, n_dev: int, min_n_loc: int) -> int:
    """Block-pipelined exchange depth (JAX :86): the config's value (at
    least 1), or by default 4 blocks when there is an exchange to overlap
    (more than one rank) and every shard holds 4096 rows or more, else
    1."""
    if cfg_value is not None:
        return max(1, int(cfg_value))
    return 4 if (n_dev > 1 and min_n_loc >= 4096) else 1


@dataclasses.dataclass(frozen=True)
class ShardedEntityMeta:
    n: int          # real instance count
    n_pad: int      # padded to a multiple of the world size
    n_loc: int      # rows a rank owns
    n_head: int = 0  # head instances split over the ranks (ghost rows)

    @property
    def n_ext(self) -> int:
        return self.n_loc + self.n_head


class ShardedProblem:
    """Rank ``rank``'s shard of one RelationData graph, on ``device``.

    Every rank reads the whole graph, so the plan (``plan_gramians`` with
    a focus-led copy of the pair per dense mode) and the head splits are
    the same on every rank.  Each entity is padded to a multiple of
    ``world`` only.  Per relation ``kinds[ri]`` is "pair", "fused" or
    "gather" (as in ``CompiledProblem``) and ``stores[(ri, mode)]`` holds
    this rank's slab of a dense mode's store: the pair's rows of its focus
    entity, [n_loc, partner extents], on the relation's own int8 scale; or
    the fused store's rows [n_loc0, n_pad1], with mode 1's ridge degrees
    for this rank's columns.  ``layouts["r{ri}m{mode}"]`` are the gather
    buckets of this rank's observations (with the head observations dealt
    round-robin to ghost rows n_loc..), ``test`` / ``train`` this rank's
    block of the tuples (``idx``, ``vals``, weights ``w``), ``feat`` the
    beta draw's arrays of this rank's rows (the dense X or the bucketed
    matvec, the dual Q and G) and the replicated ones (the column sums,
    the Nystrom factors, X'X), ``rowmask`` 1 on the valid rows and
    ``headmap`` the ghost rows this rank owns."""

    def __init__(self, rd: RelationData, config: MacauConfig, world: int,
                 rank: int, device: torch.device):
        with timed("bdf.build") as build:
            self._build(rd, config, world, rank, device)
        self.build_seconds = build.seconds

    def _build(self, rd: RelationData, config: MacauConfig, world: int,
               rank: int, device: torch.device):
        self.config, self.world, self.rank = config, world, rank
        dtype = getattr(torch, config.dtype)
        np_dt = config.np_dtype()
        ent_index = {id(e): i for i, e in enumerate(rd.entities)}
        self.entity_specs = [EntitySpec(e.name, int(e.count))
                             for e in rd.entities]
        self.rel_specs: List[RelationSpec] = []
        self.kinds: List[str] = []
        self.pair_i8s: List[bool] = []
        self.fused_i8s: List[bool] = []
        self.residual_nnzs: List[int] = []
        self.stores: Dict[Tuple[int, int], dict] = {}
        self.layouts: Dict[str, list] = {}
        self.test: Dict[str, dict] = {}
        self.test_meta: Dict[int, dict] = {}
        self.train: Dict[str, dict] = {}
        self.feat: Dict[str, dict] = {}
        self.acc_plan: Dict[str, dict] = {}
        # no destination maps: a rank's rows reduce by the segment sum
        self.dest_maps: Dict[str, dict] = {}
        self.layout_seconds = 0.0
        host_inst: Dict[str, List[np.ndarray]] = {}

        self.plan = plan = plan_gramians(rd, config, per_mode_pairs=True)
        self.dense_plans = dict(plan.dense_plans)
        # gather-path degrees, for head splitting: dense and fused modes
        # never head-split (their work is balanced by rows)
        deg_tot = [np.zeros(e.count, np.int64) for e in rd.entities]
        for ri, rel in enumerate(rd.relations):
            for d, e in enumerate(rel.entities):
                if (ri, d) in self.dense_plans or ri in plan.fused:
                    continue
                deg_tot[ent_index[id(e)]] += np.bincount(
                    rel.data.idx[:, d], minlength=e.count)

        self.ent_meta: List[ShardedEntityMeta] = []
        self.perms: List[np.ndarray] = []      # position -> original id
        pos_of: List[np.ndarray] = []          # original id -> position
        self.head_pos: List[np.ndarray] = []   # permuted positions of heads
        for ei, ent in enumerate(rd.entities):
            n = int(ent.count)
            perm = instance_permutation(n, ei)
            inv = np.empty(n, np.int64)
            inv[perm] = np.arange(n)
            self.perms.append(perm)
            pos_of.append(inv)
            thr = resolve_head_split(config.head_split_degree, deg_tot[ei],
                                     world)
            head_ids = (np.nonzero(deg_tot[ei] > thr)[0] if thr is not None
                        else np.zeros(0, np.int64))
            hpos = np.sort(inv[head_ids])
            self.head_pos.append(hpos)
            n_pad = _ceil_to(n, world)
            self.ent_meta.append(ShardedEntityMeta(
                n, n_pad, n_pad // world,
                _ceil_to(len(hpos), 8) if len(hpos) else 0))
        self.exchange_blocks = resolve_exchange_blocks(
            config.exchange_blocks, world,
            min(m.n_loc for m in self.ent_meta) if self.ent_meta else 0)
        # this rank's positions' original ids, per entity
        self.local_ids = [torch.from_numpy(self._valid_ids(ei)).to(device)
                          for ei in range(len(rd.entities))]

        for ri, rel in enumerate(rd.relations):
            mean_value = float(rel.data.vals.mean()) if rel.data.nnz else 0.0
            eids = tuple(ent_index[id(e)] for e in rel.entities)
            rs = RelationSpec(
                name=rel.name, arity=rel.arity, entity_ids=eids,
                nnz=rel.data.nnz, n_test=len(rel.test_vals),
                alpha_sample=resolved_alpha_sample(rel, config),
                mean_value=mean_value, class_cut=rel.class_cut)
            self.rel_specs.append(rs)
            idx_p = np.stack([pos_of[eids[d]][rel.data.idx[:, d]]
                              for d in range(rel.arity)], axis=1)
            centered = rel.data.vals - mean_value
            kind, pair_i8, fused_i8, resid_sel = "gather", False, False, None
            w_scale = None
            if ri in plan.fused:
                kind = "fused"
                s_, m_, keep = plan.fused[ri]
                with timed("bdf.build.store"):
                    fused_i8 = self._build_fused_slab(ri, rel, eids, idx_p,
                                                      s_, m_, keep, device)
                if not keep.all():
                    resid_sel = np.nonzero(~keep)[0]
            elif any((ri, m) in self.dense_plans for m in range(rel.arity)):
                kind = "pair"
                pair_i8 = plan.pair_i8[ri]
                if pair_i8:
                    with timed("bdf.build.store"):
                        w_scale = dg.pair_w_scale(rel.data.idx, centered,
                                                  np_dt)
            for mode in range(rel.arity):
                if kind == "fused" and resid_sel is None:
                    continue
                if kind == "pair" and (ri, mode) in self.dense_plans:
                    with timed("bdf.build.store"):
                        self._build_pair_slab(ri, mode, eids, idx_p,
                                              centered, pair_i8, w_scale,
                                              device)
                    continue
                with timed("bdf.build.layouts") as t:
                    g_idx = idx_p if resid_sel is None else idx_p[resid_sel]
                    g_cen = (centered if resid_sel is None
                             else centered[resid_sel])
                    host_inst[f"r{ri}m{mode}"] = self._build_layout(
                        ri, mode, eids[mode], g_idx, g_cen, device)
                self.layout_seconds += t.seconds
            self.kinds.append(kind)
            self.pair_i8s.append(pair_i8)
            self.fused_i8s.append(fused_i8)
            self.residual_nnzs.append(0 if resid_sel is None
                                      else int(resid_sel.size))
            if rel.test_idx.shape[0]:
                t_idx = np.stack([pos_of[eids[d]][rel.test_idx[:, d]]
                                  for d in range(rel.arity)], axis=1)
                self.test[f"r{ri}"], counts = self._shard_tuples(
                    t_idx, rel.test_vals, dtype, device)
                self.test_meta[ri] = {"idx": rel.test_idx.copy(),
                                      "vals": rel.test_vals.copy(),
                                      "counts": counts}
            if rs.alpha_sample:
                self.train[f"r{ri}"], _ = self._shard_tuples(
                    idx_p, centered, dtype, device)

        self.rowmask, self.headmap = {}, {}
        for ei, ent in enumerate(rd.entities):
            meta = self.ent_meta[ei]
            lo = rank * meta.n_loc
            rm = torch.zeros(meta.n_loc, dtype=dtype)
            rm[:self.local_ids[ei].numel()] = 1.0
            self.rowmask[f"e{ei}"] = rm.to(device)
            if meta.n_head:
                own = [(r, int(p) - lo) for r, p in
                       enumerate(self.head_pos[ei])
                       if int(p) // meta.n_loc == rank]
                self.headmap[f"e{ei}"] = {
                    k: torch.tensor([o[j] for o in own],
                                    dtype=torch.int64).to(device)
                    for j, k in enumerate(("ghost", "slot"))}
            if ent.has_features:
                with timed("bdf.build.features"):
                    self._build_features(ei, ent, device)
        if config.accumulation == "planned":
            with timed("bdf.build.acc_plan"):
                for ei, meta in enumerate(self.ent_meta):
                    insts = [a for ri, rs in enumerate(self.rel_specs)
                             for mode, e in enumerate(rs.entity_ids)
                             if e == ei
                             for a in host_inst.get(f"r{ri}m{mode}", ())]
                    acc = {k: torch.from_numpy(v).to(device)
                           for k, v in plan_accumulation(
                               insts, meta.n_ext).items()}
                    acc["has"] = acc["has"].to(dtype)
                    self.acc_plan[f"e{ei}"] = acc
        self.tri = (dg.tri_index(config.num_latent, device)
                    if self.dense_plans else None)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.init_alpha = [resolved_alpha(r, config) for r in rd.relations]
        self.init_lambda_beta = [resolved_lambda_beta(e, config)
                                 for e in rd.entities]
        self.random_spec = build_random_spec(
            [es.n for es in self.entity_specs], config.num_latent,
            config.resolved_nu0(), self.rel_specs, config.alpha_a0,
            [es.num_features for es in self.entity_specs],
            config.sample_lambda_beta, config.nu_beta)

    def flops_per_sweep(self) -> float:
        """The matmul work of one sweep over every rank (JAX
        ``ShardedProblem.flops_per_sweep`` :643-672), with the single
        engine's accounting, but a dense or fused mode counts its
        relation's padded extents (``n_pad``), the work the slabs
        execute; diagnostic only."""
        return sweep_flops(self, [m.n_pad for m in self.ent_meta])

    def _valid_ids(self, ei) -> np.ndarray:
        """Original ids of this rank's valid positions, in position order
        (the rows past them, up to n_loc, are padding)."""
        meta = self.ent_meta[ei]
        lo = self.rank * meta.n_loc
        return self.perms[ei][lo:min(lo + meta.n_loc, meta.n)]

    def _own(self, ei, pos: np.ndarray) -> np.ndarray:
        """Which permuted positions ``pos`` of entity ``ei`` this rank
        owns."""
        return pos // self.ent_meta[ei].n_loc == self.rank

    def _build_pair_slab(self, ri, mode, eids, idx_p, centered, i8,
                         w_scale, device):
        """This rank's slab of dense mode ``mode`` of relation ``ri`` (JAX
        :353-385): the pair of its observations whose focus row it owns,
        led by the focus axis (the slab's mode 0, n_loc rows), the partners
        after it in mode order but the largest (K6's first step) last;
        int8 on the relation's scale ``w_scale``, else in the float
        store's dtype.  ``partners`` records the partners' true counts."""
        cfg = self.config
        meta = self.ent_meta[eids[mode]]
        own = self._own(eids[mode], idx_p[:, mode])
        parts = [d for d in range(idx_p.shape[1]) if d != mode]
        true = [self.ent_meta[eids[d]].n for d in parts]
        big = 1 + int(np.argmax(true))
        order = (0, *[j for j in range(1, len(parts) + 1) if j != big], big)
        loc = np.stack([idx_p[own, mode] - self.rank * meta.n_loc]
                       + [idx_p[own, d] for d in parts], axis=1)
        shape = (meta.n_loc, *true)
        if i8:
            store = dg.build_int8_pair(loc, centered[own], shape,
                                       cfg.np_dtype(), device, order=order,
                                       w_scale=w_scale)
        else:
            store = dg.build_dense_pair(
                loc, centered[own], shape,
                getattr(torch, cfg.gram_dtype or cfg.dtype), device,
                order=order)
        store["partners"] = true
        self.stores[(ri, mode)] = store

    def _build_fused_slab(self, ri, rel, eids, idx_p, s, m, keep, device):
        """This rank's rows [n_loc0, n_pad1] of the fused store (JAX
        :276-342), from the kept observations whose row it owns; mode 1's
        ridge degrees are the relation's, for this rank's columns.
        Returns the s8 decision, the single-device engine's (over every
        kept observation)."""
        cfg = self.config
        m0, m1 = (self.ent_meta[e] for e in eids)
        idx_k, vals_k = idx_p, rel.data.vals
        if not keep.all():
            idx_k, vals_k = idx_p[keep], vals_k[keep]
        own = self._own(eids[0], idx_k[:, 0])
        loc = idx_k[own]
        loc[:, 0] -= self.rank * m0.n_loc
        store = dg.build_fused_store(loc, vals_k[own], (m0.n_loc, m1.n_pad),
                                     s, m, device)
        lo1 = self.rank * m1.n_loc
        deg1 = np.bincount(idx_k[:, 1], minlength=m1.n_pad)
        store["deg"][1] = torch.from_numpy(
            deg1[lo1:lo1 + m1.n_loc].astype(np.float32)).to(device)
        self.stores[(ri, 0)] = self.stores[(ri, 1)] = store
        for mode in range(2):
            dims = (m0.n_pad, m1.n_pad)
            self.dense_plans[(ri, mode)] = dg.DenseModePlan(
                "fused", dims[mode], (dims[1 - mode],))
        return bool(cfg.dense_int8 and dg.fused_int8_ok(
            dg.fused_code_bound(vals_k, s, m),
            [e.count for e in rel.entities], idx=idx_k,
            abs_codes=dg.fused_abs_codes(vals_k, s, m)))

    def _build_layout(self, ri, mode, em, g_idx, g_cen, device):
        """The gather buckets of mode ``mode`` over this rank's observations
        (JAX :386-414): those whose focus row it owns, and, for a head
        instance, every world-th of its observations, into the head's ghost
        row n_loc + (its rank among the heads).  Returns the buckets'
        instance arrays (for the planned accumulation)."""
        cfg = self.config
        meta = self.ent_meta[em]
        focus = g_idx[:, mode]
        owner = focus // meta.n_loc
        local = focus - owner * meta.n_loc
        if meta.n_head:
            hsel = np.nonzero(np.isin(focus, self.head_pos[em]))[0]
            owner[hsel] = hsel % self.world
            local[hsel] = meta.n_loc + np.searchsorted(self.head_pos[em],
                                                       focus[hsel])
        sel = owner == self.rank
        loc_idx = g_idx[sel].copy()
        loc_idx[:, mode] = local[sel]
        ml = build_mode_layout(loc_idx, g_cen[sel], mode, meta.n_ext,
                               widths=cfg.bucket_widths, row_pad=cfg.row_pad,
                               dtype=cfg.np_dtype())
        self.layouts[f"r{ri}m{mode}"] = [
            {"inst": torch.from_numpy(b.inst).to(device),
             "part": [torch.from_numpy(p).to(device) for p in b.part],
             "val": torch.from_numpy(b.val).to(device),
             "mask": torch.from_numpy(b.mask).to(device)}
            for b in ml.buckets]
        return [b.inst for b in ml.buckets]

    def _shard_tuples(self, idx, vals, dtype, device):
        """This rank's block of a tuple list (JAX :674): blocks of
        ceil(n / world) rounded up to 8 in list order, zero-padded with
        weight 0.  Returns (its idx, vals and w on ``device``, every
        rank's count)."""
        n = idx.shape[0]
        per = _ceil_to(max(-(-n // self.world), 1), 8)
        counts = [max(min((d + 1) * per, n) - d * per, 0)
                  for d in range(self.world)]
        s, c = self.rank * per, counts[self.rank]
        out_idx = np.zeros((per, idx.shape[1]), np.int64)
        out_val = np.zeros(per)
        out_w = np.zeros(per)
        out_idx[:c], out_val[:c], out_w[:c] = idx[s:s + c], vals[s:s + c], 1
        return ({"idx": torch.from_numpy(out_idx).to(device),
                 "vals": torch.from_numpy(out_val).to(device, dtype),
                 "w": torch.from_numpy(out_w).to(device, dtype)}, counts)

    def _build_features(self, ei, ent, device):
        """Entity ``ei``'s beta-draw arrays for this rank's rows (JAX
        :429-527, ``build_features`` with its ``RowShard``)."""
        meta = self.ent_meta[ei]
        ids = self._valid_ids(ei)
        local = np.full(meta.n, -1, np.int64)
        local[ids] = np.arange(ids.size)
        feat, _, use_ff, solver = build_features(
            ent, self.config, device,
            RowShard(local, ids, meta.n_loc, self.perms[ei], meta.n_pad))
        self.feat[f"e{ei}"] = feat
        self.entity_specs[ei] = dataclasses.replace(
            self.entity_specs[ei], num_features=ent.num_features,
            use_ff=use_ff, feat_nnz=ent.F.nnz, solver=solver)


class ShardedMacauEngine(MacauEngine):
    """The Gibbs engine over the ranks of a process group (JAX
    ``ShardedMacauEngine`` :696), one rank a process, on ``device``: the
    CUDA card (``cuda:<current device>``, NCCL) unless the caller asks for
    the CPU (gloo).  Needs an initialized process group whose backend
    matches the device (``parallel.mesh.initialize_distributed``).  It
    runs the single-device engine's driver loop and per-entity pieces
    (``MacauEngine``'s ``_precision``, ``_draw_rows``, ``_beta_rhs``,
    ``_solve_beta``, ``_store_contrib``) on this rank's rows, with the
    collectives in between; every rank returns the same results."""

    def __init__(self, rd: RelationData, config: MacauConfig,
                 device="cuda", group=None):
        self.config = config
        self.device = _resolve_device(device)
        self.group, self.world = data_group(group)
        backend = dist.get_backend(self.group)
        if backend != backend_for(self.device):
            raise RuntimeError(f"a {self.device.type} engine needs the "
                               f"{backend_for(self.device)} backend, the "
                               f"process group has {backend}")
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.rank = dist.get_rank(self.group)
        self._writer = self.rank == 0
        self._trace_tag = f".rank{self.rank}" if self.world > 1 else ""
        self.dtype = getattr(torch, config.dtype)
        with full_float32():
            self.problem = ShardedProblem(rd, config, self.world, self.rank,
                                          self.device)
        self._perm_t = [torch.from_numpy(p).to(self.device)
                        for p in self.problem.perms]

    # -- collectives --------------------------------------------------------
    def _allreduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks (a fresh tensor)."""
        out = t.contiguous().clone()
        dist.all_reduce(out, group=self.group)
        return out

    def _allgather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` stacked along dim 0 in rank order."""
        t = t.contiguous()
        out = t.new_empty((self.world * t.shape[0],) + t.shape[1:])
        dist.all_gather_into_tensor(out, t, group=self.group)
        return out

    def _reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of ``t`` [world * rows, ...], this rank's
        block of rows."""
        t = t.contiguous()
        out = t.new_empty((t.shape[0] // self.world,) + t.shape[1:])
        dist.reduce_scatter_tensor(out, t, group=self.group)
        return out

    def _reduce_scatter_cols(self, t: torch.Tensor) -> torch.Tensor:
        """``_reduce_scatter`` along the columns of t [R, world * n]."""
        R, W = t.shape[0], self.world
        return self._reduce_scatter(
            t.view(R, W, -1).transpose(0, 1).reshape(W * R, -1))

    def _local(self, arr: torch.Tensor, ei: int) -> torch.Tensor:
        """This rank's rows of a per-instance array in original order,
        [n_loc, ...] in position order, the padding rows zero."""
        ids = self.problem.local_ids[ei]
        out = arr.new_zeros((self.problem.ent_meta[ei].n_loc,)
                            + arr.shape[1:])
        out[:ids.numel()] = arr.index_select(0, ids.to(arr.device))
        return out

    def _local_rows(self, ei):
        meta = self.problem.ent_meta[ei]
        return meta.n_loc, meta.n_head

    def _fold_ghosts(self, ei, P, b):
        """Sum the ghost rows [n_loc:] of P and b over the ranks and add
        each head's total into its owner's row (JAX :1248-1263)."""
        n = self.problem.ent_meta[ei].n_loc
        P_g, b_g = self._allreduce(P[n:]), self._allreduce(b[n:])
        P, b = P[:n], b[:n]
        hm = self.problem.headmap[f"e{ei}"]
        P.index_add_(0, hm["slot"], P_g.index_select(0, hm["ghost"]))
        b.index_add_(0, hm["slot"], b_g.index_select(0, hm["ghost"]))
        return P, b

    def _feat_ops(self, ei):
        """(X @ V on this rank's rows, X' @ U summed over the ranks)."""
        feat = self.problem.feat[f"e{ei}"]
        X = feat.get("dense_X")
        if X is not None:
            return (lambda V: X @ V), (lambda V: self._allreduce(X.mT @ V))
        n_loc = self.problem.ent_meta[ei].n_loc
        nf = self.problem.entity_specs[ei].num_features
        mv = feat["mv"]
        return (lambda V: bucketed_spmm(mv["fwd"], n_loc, V),
                lambda V: self._allreduce(bucketed_spmm(mv["t"], nf, V)))

    def _dense_contrib(self, ri, mode, partners, alpha, packed):
        """This rank's rows of relation ``ri``'s contribution to focus
        ``mode`` (JAX :1075-1161, :1203-1231): a pair slab or fused mode 0
        as the single-device engine contracts its store, against the
        partners' valid rows (K7's scales over them, so equal to the
        single engine's); fused mode 1 by ``_fused_mode1``."""
        prob = self.problem
        store = prob.stores[(ri, mode)]
        eids = prob.rel_specs[ri].entity_ids
        if prob.kinds[ri] == "fused":
            if mode == 1:
                return self._fused_mode1(ri, store, partners[0], alpha,
                                         packed)
            partners = [partners[0][:prob.ent_meta[eids[1]].n]]
        else:
            partners = [U[:n] for U, n in zip(partners, store["partners"])]
            mode = 0
        return self._store_contrib(store, ri, mode, partners, alpha, packed)

    def _fused_mode1(self, ri, store, U0, alpha, packed):
        """Fused mode 1 on this rank's row slab (JAX :1122-1161): the
        contraction runs over the sharded axis, against the table of this
        rank's rows of U0, and its partial sums over every column are
        reduce-scattered into each rank's columns.  On the s8 path the
        table is quantized over all of U0's valid rows (the single engine's
        scales) and the raw int32 sums are reduced (K8a ``flip_out`` when
        packed, K8b otherwise), so the total is the single engine's bit for
        bit, then dequantized (``fused_finish_i8``); the float path reduces
        its float sums."""
        prob, dtype = self.problem, self.dtype
        eids = prob.rel_specs[ri].entity_ids
        m0 = prob.ent_meta[eids[0]]
        lo = self.rank * m0.n_loc
        V8 = store["V8"]
        n_cols = store["shape"][1]
        K = U0.shape[1]
        tri = prob.tri
        rs_cols = self._reduce_scatter_cols if packed else self._reduce_scatter
        if not prob.fused_i8s[ri]:
            U0_loc = U0[lo:lo + m0.n_loc][:max(min(m0.n - lo, m0.n_loc), 0)]
            gd = (getattr(torch, self.config.gram_dtype)
                  if self.config.gram_dtype else dtype)
            P, b = dg.fused_gram_contrib(store, tri, U0_loc, 1, dtype, gd,
                                         prob.rel_specs[ri].mean_value,
                                         packed=packed, transposed=packed)
            P, b = rs_cols(P), rs_cols(b)
            P *= alpha
            b *= alpha
            return P, b
        YZ8T, _, s_yz, s_z = dg.fused_quantize(U0[:m0.n], pad_rows=m0.n_pad,
                                               tri=tri)
        loc = YZ8T.new_zeros((YZ8T.shape[0], V8.shape[0]))
        loc[:, :m0.n_loc] = YZ8T[:, lo:lo + m0.n_loc]
        del YZ8T
        PM, BV = dg.fused_pair_contract_i8(V8, loc, 1, K, n_cols,
                                           flip_out=packed)
        del loc
        PM, BV = rs_cols(PM), rs_cols(BV)
        f64 = dtype == torch.float64
        Pt, b = dg.fused_finish_i8(
            PM, BV, s_yz, s_z, K, dtype, store["scale"], store["shift"],
            prob.rel_specs[ri].mean_value, tri[2], store["deg"][1],
            pre_transposed=packed, alpha=None if f64 else alpha)
        del PM, BV
        if f64:
            alpha = alpha.to(dtype)
            Pt, b = alpha * Pt, alpha * b
        return (Pt, b) if packed else (dg._expand(Pt, tri[3], K), b)

    # -- state --------------------------------------------------------------
    def init_state(self, generator: Optional[torch.Generator] = None):
        """``MacauEngine.init_state``'s draws (the same generator, the same
        U), permuted and padded (JAX :804); uhat and the prediction sums
        this rank's."""
        return self.shard_state(MacauEngine.init_state(self, generator))

    def shard_state(self, state) -> Dict[str, Any]:
        """A state in the single-device engine's layout (U and uhat [n, K]
        in original order, the prediction sums over the whole test split)
        as this rank's sharded state."""
        prob, dev, dt = self.problem, self.device, self.dtype
        ents, uhat = [], {}
        for ei, e in enumerate(state["ent"]):
            meta = prob.ent_meta[ei]
            ent = {k: v.to(dev, dt) for k, v in e.items() if k != "uhat"}
            U = torch.zeros((meta.n_pad, e["U"].shape[1]), dtype=dt,
                            device=dev)
            U[:meta.n] = ent["U"].index_select(0, self._perm_t[ei])
            ent["U"] = U
            if "uhat" in e:
                uhat[f"e{ei}"] = self._local(e["uhat"].to(dev, dt), ei)
            ents.append(ent)
        preds = {}
        for key, pr in state["pred"].items():
            counts = prob.test_meta[int(key[1:])]["counts"]
            per = prob.test[key]["w"].shape[0]
            s = self.rank * per
            c = counts[self.rank]

            def chunk(v):
                out = torch.zeros(per, dtype=dt, device=dev)
                out[:c] = v.to(dev, dt)[s:s + c]
                return out
            preds[key] = {"sum": chunk(pr["sum"]), "sum2": chunk(pr["sum2"]),
                          "n": pr["n"].to(dev, dt)}
        return {"ent": ents,
                "rel": [{k: v.to(dev, dt) for k, v in r.items()}
                        for r in state["rel"]],
                "uhat": uhat, "pred": preds}

    def unshard_state(self, state) -> Dict[str, Any]:
        """The single-device engine's layout of a sharded state (every rank
        takes part: uhat and the prediction sums are gathered)."""
        ents = []
        for ei, e in enumerate(state["ent"]):
            ent = {k: v for k, v in e.items()}
            ent["U"] = self._original_order(ei, e["U"])
            if f"e{ei}" in state["uhat"]:
                ent["uhat"] = self._original_order(
                    ei, self._allgather(state["uhat"][f"e{ei}"]))
            ents.append(ent)
        return {"ent": ents, "rel": state["rel"],
                "pred": self._gathered_preds(state)}

    def _original_order(self, ei, U: torch.Tensor) -> torch.Tensor:
        n = self.problem.ent_meta[ei].n
        out = U.new_empty((n,) + U.shape[1:])
        out[self._perm_t[ei]] = U[:n]
        return out

    def _gathered_preds(self, state):
        out = {}
        for key, pr in state["pred"].items():
            counts = self.problem.test_meta[int(key[1:])]["counts"]
            g = self._allgather(torch.stack([pr["sum"], pr["sum2"]]))
            g = g.view(self.world, 2, -1)
            full = torch.cat([g[d, :, :c] for d, c in enumerate(counts)],
                             dim=1)
            out[key] = {"sum": full[0], "sum2": full[1], "n": pr["n"]}
        return out

    def _test_split(self, ri):
        meta = self.problem.test_meta[ri]
        return meta["idx"], meta["vals"]

    def factors_original_order(self, state) -> List[np.ndarray]:
        """Every entity's U in original instance order, as numpy."""
        return [self._original_order(ei, e["U"]).cpu().numpy()
                for ei, e in enumerate(state["ent"])]

    # -- one sweep ----------------------------------------------------------
    def _sweep_with_randoms(self, state, randoms, accumulate: float):
        """One Gibbs sweep on this rank (JAX ``_local_sweep`` :985), from
        the sweep's randoms in original order: each entity in turn (beta,
        Normal-Wishart from reduced moments, the precision of this rank's
        rows, their draw and exchange), then the alpha draws from reduced
        sums of squares, then the predictions of this rank's test block
        and the metrics from reduced sums."""
        cfg = self.config
        prob = self.problem
        nu0 = cfg.resolved_nu0()
        metrics: Dict[str, Any] = {}
        ents = [dict(e) for e in state["ent"]]
        rels = list(state["rel"])
        uhat = dict(state["uhat"])
        for ei, es in enumerate(prob.entity_specs):
            meta = prob.ent_meta[ei]
            ent = ents[ei]
            lo = self.rank * meta.n_loc
            U_loc = ent["U"][lo:lo + meta.n_loc]
            w_row = prob.rowmask[f"e{ei}"][:, None]
            uhat_loc = None
            if es.has_features:
                with span(f"bdf.e{ei}.beta"):
                    rhs = self._beta_rhs(
                        ei, ent, U_loc,
                        self._local(randoms[f"e{ei}.beta_e1"], ei),
                        randoms[f"e{ei}.beta_e2"])
                    ent["beta"], uhat_loc, cg_diag = self._solve_beta(
                        ei, rhs, ent["lambda_beta"], ent["beta"])
                    uhat[f"e{ei}"] = uhat_loc
                    if cg_diag is not None:
                        metrics[f"e{ei}.cg_iters"] = cg_diag[0]
                        metrics[f"e{ei}.cg_resid"] = cg_diag[1]
                    if cfg.sample_lambda_beta:
                        ent["lambda_beta"] = self._draw_lambda_beta(
                            ei, ent["beta"], ent["Lambda"], randoms)
            # Normal-Wishart from moments summed over the ranks
            with span(f"bdf.e{ei}.hyper"):
                S = U_loc if uhat_loc is None else U_loc - uhat_loc
                Sbar = self._allreduce(torch.sum(S * w_row, dim=0)) / es.n
                Sc = (S - Sbar) * w_row
                mu, Lambda = normal_wishart_from_moments(
                    es.n, Sbar, self._allreduce(Sc.mT @ Sc), cfg.nw_b0, nu0,
                    2.0 * randoms[f"e{ei}.nw_g"], randoms[f"e{ei}.nw_tri"],
                    randoms[f"e{ei}.nw_mu"])
            ent["mu"], ent["Lambda"] = mu, Lambda
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
            with span(f"bdf.e{ei}.precision"):
                prec = self._precision(ei, ent, dense, contribs, uhat_loc)
            ent["U"] = self._exchange(
                ei, prec, self._local(randoms[f"e{ei}.xi"], ei))
            del prec
            # from the replicated U's valid rows: no collective
            metrics[f"e{ei}.unorm"] = torch.linalg.norm(ent["U"][:es.n])
            if es.has_features:
                metrics[f"e{ei}.betanorm"] = torch.linalg.norm(ent["beta"])
                metrics[f"e{ei}.lambda_beta"] = ent["lambda_beta"]

        for ri, rs in enumerate(prob.rel_specs):
            if not rs.alpha_sample:
                continue
            with span(f"bdf.r{ri}.alpha"):
                tr = prob.train[f"r{ri}"]
                pred_c = predict_tuples([ents[e]["U"] for e in rs.entity_ids],
                                        tr["idx"], 0.0)
                sse = self._allreduce(torch.sum(
                    tr["w"] * (tr["vals"] - pred_c) ** 2))
                rels[ri] = {"alpha": sample_alpha(
                    sse, rs.nnz, randoms[f"r{ri}.alpha_g"], cfg.alpha_a0,
                    cfg.alpha_b0)}
            metrics[f"r{ri}.alpha"] = rels[ri]["alpha"]

        preds = dict(state["pred"])
        for ri, rs in enumerate(prob.rel_specs):
            key = f"r{ri}"
            if key not in preds:
                continue
            with span(f"bdf.r{ri}.predict"):
                te = prob.test[key]
                w = te["w"]
                p = predict_tuples([ents[e]["U"] for e in rs.entity_ids],
                                   te["idx"], rs.mean_value)
                if cfg.clamp is not None:
                    p = torch.clamp(p, cfg.clamp[0], cfg.clamp[1])
                pr = preds[key]
                pr = {"sum": pr["sum"] + accumulate * p * w,
                      "sum2": pr["sum2"] + accumulate * p * p * w,
                      "n": pr["n"] + accumulate}
                preds[key] = pr
                pmean = pr["sum"] / torch.clamp_min(pr["n"], 1.0)
                sq = self._allreduce(torch.stack([
                    torch.sum(w * (p - te["vals"]) ** 2),
                    torch.sum(w * (pmean - te["vals"]) ** 2)]))
                metrics[f"{key}.rmse_sample"] = torch.sqrt(sq[0] / rs.n_test)
                metrics[f"{key}.rmse_avg"] = torch.sqrt(sq[1] / rs.n_test)
                if rs.class_cut is not None:
                    # the AUC over every rank's block: padding entries score
                    # +inf with weight 0 (JAX :1380-1391)
                    pm, v, wg = self._allgather(torch.stack(
                        [pmean, te["vals"], w])).view(self.world, 3, -1) \
                        .transpose(0, 1).reshape(3, -1)
                    labels = (v < rs.class_cut).to(self.dtype) * wg
                    scores = torch.where(wg > 0, -pm, torch.inf)
                    metrics[f"{key}.auc"] = auc_device(labels, scores,
                                                       weights=wg)
        return ({"ent": ents, "rel": rels, "uhat": uhat, "pred": preds},
                metrics)

    def _exchange(self, ei, prec, xi):
        """Draw this rank's rows and gather every rank's (JAX
        :1296-1340): U [n_pad, K], replicated.  With
        ``exchange_blocks`` > 1 blocks dividing n_loc, block b's
        ``all_gather_into_tensor`` is issued (asynchronously) before block
        b + 1 is drawn, and the gathered blocks are interleaved back into
        position order."""
        meta = self.problem.ent_meta[ei]
        n_blk = max(1, min(self.problem.exchange_blocks, meta.n_loc))
        blk = meta.n_loc // n_blk
        if n_blk == 1 or blk * n_blk != meta.n_loc:
            with span(f"bdf.e{ei}.draw"):
                u = self._draw_rows(prec, xi)
            return self._allgather(u)
        works = []
        for c in range(n_blk):
            rows = slice(c * blk, (c + 1) * blk)
            with span(f"bdf.e{ei}.draw"):
                u = self._draw_rows(prec, xi[rows], rows).contiguous()
            out = u.new_empty((self.world * blk, u.shape[1]))
            works.append((dist.all_gather_into_tensor(
                out, u, group=self.group, async_op=True), out))
        for work, _ in works:
            work.wait()
        return torch.stack([out.view(self.world, blk, -1)
                            for _, out in works], dim=1).reshape(meta.n_pad,
                                                                 -1)

    # -- posterior samples and checkpoints ------------------------------------
    def _save_sample(self, prefix: str, psample_idx: int, state) -> None:
        """The single-device engine's posterior-sample file, U in original
        order (every rank gathers, rank 0 writes)."""
        st = self.unshard_state(state)
        if self._writer:
            MacauEngine._save_sample(self, prefix, psample_idx, st)

    def save_state(self, path: str, state, sweep: int) -> None:
        """The single-device engine's checkpoint of the whole state (every
        rank gathers, rank 0 writes, all wait for the file), loadable at any
        world size and by the single-device engine."""
        st = self.unshard_state(state)
        if self._writer:
            MacauEngine.save_state(self, path, st, sweep)
        dist.barrier(group=self.group)

    def load_state(self, path: str):
        """(this rank's state, sweep) from a ``save_state`` file of either
        engine; every rank reads it."""
        template = self.unshard_state(self.init_state())
        st, sweep = self._read_state(path, template)
        return self.shard_state(st), sweep
