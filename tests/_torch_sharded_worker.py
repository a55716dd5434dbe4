"""The sharded engine's cases and their worker processes, for
``test_torch_sharded*.py``.  Jax-free: the workers import the port only.

Each case builds its graph with a package's own classes (the port's or the
JAX package's: the same API), so the test process builds the JAX reference
and the workers the port's sharded engine from the same numpy data.  One
launch (``launch``) starts ``world`` gloo processes that run every case
given and write one npz per case (rank 0), so process start-up is paid
once per world size:

  - a parity case loads the JAX engine's initial state (a ``save_state``
    file) and three sweeps of numpy randoms, runs them through
    ``_sweep_with_randoms`` and writes the state in the single-device
    layout, the last sweep's metrics and, for each rank, whether every
    entity with gather buckets there has its destination map;
  - the "driver" case (world 2) runs the chain of ``driver_case`` through
    ``run()``: without interruption, from its sweep-3 checkpoint, in
    windows of 3 sweeps, and on rank 0 at world 1 (a one-rank group).
"""
import os
import sys
import time
import traceback

import numpy as np
import torch

K = 4
TIMEOUT_S = 240


def _lowrank(rng, n0, n1, density=0.5, noise=0.1, k=3):
    U = rng.standard_normal((n0, k))
    V = rng.standard_normal((n1, k))
    R = U @ V.T + noise * rng.standard_normal((n0, n1))
    mask = rng.random((n0, n1)) < density
    return np.stack(np.nonzero(mask), 1), R[mask]


def _stars(rng, n0, n1, density=0.5):
    mask = rng.random((n0, n1)) < density
    R = np.clip(np.round((3 + rng.standard_normal((n0, n1))) * 2) / 2, 1, 5)
    return np.stack(np.nonzero(mask), 1), R[mask]


def _ratings(pkg, idx, vals, shape, n_test):
    rd = pkg.RelationData.from_indexed_df(pkg.IndexedDF(idx, vals, shape))
    rd.assign_to_test(0, n_test, seed=7)
    return rd


def _features(rng, pkg, n, f, n0_rel, density=0.25, binary=True,
              stars=False, class_cut=None):
    X = (rng.random((n, f)) < density).astype(np.float64)
    if not binary:
        X *= rng.standard_normal((n, f))
    idx, vals = (_stars if stars else _lowrank)(rng, n, n0_rel)
    rd = pkg.RelationData.from_matrix(pkg.IndexedDF(idx, vals, (n, n0_rel)),
                                      feat1=X, class_cut=class_cut)
    rd.assign_to_test(0, 40, seed=2)
    return rd


def build_case(name, pkg):
    """(RelationData, config options) of case ``name`` with ``pkg``'s
    classes (``bayesiandatafusion_jl_tpu_torch`` or the JAX package)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    opts = dict(num_latent=K, dtype="float64", verbose=False, seed=5)
    if name == "bpmf_gather":
        # sizes no world size divides: padding on every entity
        idx, vals = _lowrank(rng, 53, 37)
        return _ratings(pkg, idx, vals, (53, 37), 70), dict(
            opts, dense_gram=False)
    if name == "int8_pair":
        idx, vals = _stars(rng, 64, 48)
        return _ratings(pkg, idx, vals, (64, 48), 100), dict(
            opts, dense_gram=True, dense_int8=True, clamp=(1.0, 5.0),
            exchange_blocks=2)
    if name == "float_pair":
        idx, vals = _stars(rng, 61, 43)
        return _ratings(pkg, idx, vals, (61, 43), 100), dict(
            opts, dense_gram=True, dense_int8=False)
    if name == "fused_s8_residual":
        idx, vals = _stars(rng, 60, 45)
        idx = np.concatenate([idx, idx[:9]])
        vals = np.concatenate([vals, rng.integers(2, 11, 9) * 0.5])
        return _ratings(pkg, idx, vals, (60, 45), 100), dict(
            opts, dense_fused=True, dense_int8=True, clamp=(1.0, 5.0))
    if name == "head_split":
        # a full row and a full column: gather-path degrees 48 and 64,
        # above the threshold; n_loc even at world 2 and 4
        idx, vals = _lowrank(rng, 64, 48, density=0.3)
        extra = np.array([(5, j) for j in range(48)]
                         + [(i, 7) for i in range(64)])
        lin = np.unique(np.concatenate([idx[:, 0] * 48 + idx[:, 1],
                                        extra[:, 0] * 48 + extra[:, 1]]))
        idx = np.stack([lin // 48, lin % 48], 1)
        vals = rng.standard_normal(len(lin))
        return _ratings(pkg, idx, vals, (64, 48), 80), dict(
            opts, dense_gram=False, head_split_degree=30,
            exchange_blocks=2)
    if name == "planned":
        idx, vals = _lowrank(rng, 51, 39)
        return _ratings(pkg, idx, vals, (51, 39), 70), dict(
            opts, dense_gram=False, accumulation="planned")
    if name == "macau_ff":
        return _features(rng, pkg, 53, 17, 37), dict(opts, use_ff=True)
    if name == "macau_dual":
        # the dual solve (N < F) and a class_cut: the AUC over the ranks
        rd = _features(rng, pkg, 41, 60, 29, binary=False, class_cut=0.0)
        return rd, dict(opts, use_ff=False, beta_solver="dual")
    if name == "macau_nystrom":
        return _features(rng, pkg, 45, 40, 33), dict(
            opts, use_ff=False, beta_solver="cg", cg_nystrom_rank=8)
    if name == "tensor_alpha":
        # a (9, 8, 5) tensor beside a 2-ary relation, alpha sampled
        shape = (9, 8, 5)
        lin = rng.choice(int(np.prod(shape)), 150, replace=False)
        idx = np.stack(np.unravel_index(lin, shape), 1)
        rd = pkg.RelationData.from_indexed_df(
            pkg.IndexedDF(idx, rng.standard_normal(150), shape),
            relation_name="t")
        idx2, vals2 = _lowrank(rng, 9, 11)
        e0 = rd.relations[0].entities[0]
        e_new = pkg.Entity("side", count=11)
        rd.add_relation(pkg.IndexedDF(idx2, vals2, (9, 11)), "r2",
                        entities=[e0, e_new])
        rd.assign_to_test("t", 20, seed=3)
        rd.set_precision("r2", 4.0, sample=True)
        return rd, dict(opts, dense_gram=False)
    if name == "tensor_int8":
        # the int8 pair at arity 3: one focus-led slab a mode, K6's first
        # step on its last (largest partner) axis
        shape = (9, 8, 5)
        lin = rng.choice(int(np.prod(shape)), 200, replace=False)
        rd = pkg.RelationData.from_indexed_df(pkg.IndexedDF(
            np.stack(np.unravel_index(lin, shape), 1),
            rng.integers(1, 6, 200).astype(np.float64), shape))
        rd.assign_to_test(0, 20, seed=3)
        return rd, dict(opts, dense_gram=True, dense_int8=True)
    raise KeyError(name)


CASES = ("bpmf_gather", "int8_pair", "float_pair", "fused_s8_residual",
         "head_split", "planned", "macau_ff", "macau_dual", "macau_nystrom",
         "tensor_alpha", "tensor_int8")
SWEEPS = 3


def driver_case(pkg):
    """The world-2 driver checks' chain: side features on the bucketed
    matvec (CG), a fused s8 relation, sampled alpha."""
    rd = _features(np.random.default_rng(4), pkg, 48, 30, 40, stars=True)
    rd.set_precision(0, 3.0, sample=True)
    return rd, dict(num_latent=K, dtype="float64", verbose=False, seed=11,
                    use_ff=False, beta_solver="cg", dense_fused=True,
                    dense_int8=True, burnin=3, psamples=3)


def _run_case(name, world, in_dir, out_dir, bt, eng_cls):
    rd, opts = build_case(name, bt)
    eng = eng_cls(rd, bt.MacauConfig(**opts), device="cpu")
    state, _ = eng.load_state(os.path.join(in_dir, f"{name}.init.npz"))
    z = np.load(os.path.join(in_dir, f"{name}.randoms.npz"))
    for s in range(SWEEPS):
        randoms = {k.split("/", 1)[1]: torch.from_numpy(z[k])
                   for k in z.files if k.startswith(f"s{s}/")}
        state, m = eng._sweep_with_randoms(state, randoms,
                                           1.0 if s >= 1 else 0.0)
    st = eng.unshard_state(state)
    prob = eng.problem
    gather = {rs.entity_ids[m] for ri, rs in enumerate(prob.rel_specs)
              for m in range(rs.arity) if prob.layouts.get(f"r{ri}m{m}")}
    mapped = [None] * world
    torch.distributed.all_gather_object(mapped, bool(gather) and all(
        f"e{ei}" in prob.dest_maps for ei in gather))
    if eng.rank == 0:
        out = {f"m/{k}": float(v) for k, v in m.items()}
        for ei, ent in enumerate(st["ent"]):
            out.update({f"e{ei}.{k}": v.numpy() for k, v in ent.items()})
        for ri, rel in enumerate(st["rel"]):
            out[f"r{ri}.alpha"] = rel["alpha"].numpy()
        for key, pr in st["pred"].items():
            out[f"{key}.pred_sum"] = pr["sum"].numpy()
        out["kinds"] = np.array(eng.problem.kinds)
        out["exchange_blocks"] = eng.problem.exchange_blocks
        out["n_head"] = np.array([m.n_head for m in eng.problem.ent_meta])
        out["solvers"] = np.array([es.solver if es.has_features else ""
                                   for es in eng.problem.entity_specs])
        out["residual_nnzs"] = np.array(eng.problem.residual_nnzs)
        out["mapped"] = np.array(mapped)
        np.savez(os.path.join(out_dir, f"{name}.w{world}.npz"), **out)


def _run_driver(world, out_dir, bt, eng_cls, dist):
    from bayesiandatafusion_jl_tpu_torch.models.engine import _leaves
    rd, opts = driver_case(bt)
    out = {}
    # the uninterrupted chain, with its posterior-sample dumps
    prefix = os.path.join(out_dir, "drv")
    full = eng_cls(rd, bt.MacauConfig(**opts, output_prefix=prefix),
                   device="cpu").run()
    ck = os.path.join(out_dir, "drv.ck.npz")
    half = eng_cls(rd, bt.MacauConfig(**opts, checkpoint_every=3,
                                      checkpoint_path=ck), device="cpu")
    half.run(num_sweeps=3)
    st, sweep = half.load_state(ck)
    resumed = half.run(state=st, sweep_offset=sweep)
    win = eng_cls(rd, bt.MacauConfig(**opts, sweeps_per_dispatch=3,
                                     metrics_every=3), device="cpu").run()
    out["kinds"] = np.array(half.problem.kinds)
    out["resume_sweep"] = sweep
    out["resume_equal"] = all(torch.equal(a, b) for a, b in zip(
        _leaves(resumed["state"]), _leaves(full["state"])))
    out["windows_equal"] = all(torch.equal(a, b) for a, b in zip(
        _leaves(win["state"]), _leaves(full["state"])))
    out["rmse"] = full["RMSE"]
    out["pred"] = full["predictions"]["pred"]
    out["stdev"] = full["predictions"]["stdev"]
    out["idx"] = full["predictions"]["idx"]
    # the same chain at world 1, on a one-rank group of rank 0
    g1 = dist.new_group([0])
    if dist.get_rank() == 0:
        one = eng_cls(rd, bt.MacauConfig(**opts), device="cpu",
                      group=g1).run()
        out["rmse_w1"] = one["RMSE"]
        out["pred_w1"] = one["predictions"]["pred"]
        out["stdev_w1"] = one["predictions"]["stdev"]
        np.savez(os.path.join(out_dir, f"driver.w{world}.npz"), **out)
    dist.barrier()


def worker(rank, world, init_file, in_dir, out_dir, names):
    """One rank: join the gloo group, run ``names`` (cases, and "driver"),
    leave the group.  An error is written beside the outputs and
    re-raised."""
    torch.set_num_threads(1)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [os.path.dirname(here), here]
    import torch.distributed as dist

    import bayesiandatafusion_jl_tpu_torch as bt
    from bayesiandatafusion_jl_tpu_torch.ops import dense_gram
    from bayesiandatafusion_jl_tpu_torch.parallel.mesh import \
        initialize_distributed
    from bayesiandatafusion_jl_tpu_torch.parallel.sharded import \
        ShardedMacauEngine
    from _torch_xla_order import xla_cpu_ridge_step
    # the PD ridge summed in the JAX engine's order (as the single-device
    # parity tests patch it)
    dense_gram.ridge_step = xla_cpu_ridge_step
    initialize_distributed("file://" + init_file, world, rank, device="cpu",
                           timeout_s=TIMEOUT_S)
    try:
        for name in names:
            t0 = time.perf_counter()
            if name == "driver":
                _run_driver(world, out_dir, bt, ShardedMacauEngine, dist)
            else:
                _run_case(name, world, in_dir, out_dir, bt,
                          ShardedMacauEngine)
            if rank == 0:
                print(f"# world {world} {name}: "
                      f"{time.perf_counter() - t0:.2f} s", flush=True)
    except BaseException:
        with open(os.path.join(out_dir, f"error.rank{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def launch(world, in_dir, out_dir, names, timeout_s=TIMEOUT_S):
    """Run ``worker`` in ``world`` spawned processes; raise if one fails or
    the launch outlives ``timeout_s`` (its processes are then killed)."""
    import torch.multiprocessing as mp
    os.makedirs(out_dir, exist_ok=True)
    init_file = os.path.join(out_dir, "rendezvous")
    ctx = mp.start_processes(worker, args=(world, init_file, in_dir, out_dir,
                                           tuple(names)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"world {world}: no end in {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
