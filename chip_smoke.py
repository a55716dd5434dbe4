"""GPU smoke test of the PyTorch/CUDA port, ``bayesiandatafusion_jl_tpu_torch``.

Run from the repository root on a machine with one CUDA card (an H100):

    python3 chip_smoke.py

Phases, each fatal on failure (nonzero exit, no result line):

1. device: a CUDA device is present; its name and power limit;
2. build: ``nvcc`` compiles the port's kernels for sm_90a from ``csrc/``,
   and ptxas serializes no ``wgmma`` (no C75xx line in its log); the
   sampler kernels' build lines (K1-K5: registers, spills), failing on any
   spill in float32 or float64, and K7's (both passes), failing on any
   spill; then the native host builder (``native/layout.cpp``: the gather
   path's bucketed layouts, the SBM1 files) by the host C++ compiler;
3. kernels vs plain: each sampler kernel against its plain torch version
   on random SPD problems at the main paths' shapes, float32 and float64,
   both held against the float64 plain version: K1 (packed, K <= 32), K2
   (packed column-slab, 32 < K <= 96, also at K = 33, two padded panels),
   K3 (full P, K <= 32, with and without Lambda), K4 (full-P column-slab,
   32 < K <= 96, also at K = 33), K5 (panel factor-inverse, K <= 64, at
   the K = 128 paths' shapes, at K = 33, and on the panel view of a
   [B, 128, 128] P read in place; float64 to K5_F64_TOL) and the blocked
   K = 128 sampler built on K5 against ``torch.linalg``; K7 (the
   quantized partner table) and K8 (the masked-pair contraction, both focus modes: K8a raw int32 and the
   dequant epilogue, K8b the natural layout) bit for bit against their
   plain versions, K7 at the Netflix and ML-10M shapes (K = 32, 64, 97,
   128), ragged, and on adversarial factors (quotients on half-integers,
   an ulp or two either side, at the +-127 clip edge, scales from FLT_MIN
   up), K8 on small ragged stores; K8c and K8d (float operands: bfloat16
   on the tensor cores, float32 and float64 by FMA; flip_out and natural layout) within
   FLOAT_TOL of the largest sum; K6 (the int8 pair contraction, both focus
   modes from one stored pair, raw int32 and the dequant epilogue) bit for
   bit against its plain version on small ragged stores, K = 4, 8, 15, 16,
   32, 33 and 160; the samplers and K7 also at the graph paths' shapes (K1 at
   tensor's and fusion's entity counts, K3 at tensor_big's, K7 at their
   largest partners' tables); K9 (the windowed expand) bit for bit
   against its plain version on ragged plans (a hot window over several
   blocks, empty windows, no observation at all), K = 8, 32, 64 and 128,
   float32 and bfloat16, and
   timed beside ``index_select`` at the ML-10M gather shape;
4. int8 contraction: the plain versions' ``torch._int_mm`` equals a
   float64 matmul of the same codes exactly, at ML-10M shapes;
5. main paths: ML-10M-shaped synthetic BPMF (71,567 x 10,681, 10,000,054
   ratings, float32), made once, through ``MacauEngine.benchmark``; first
   the plan of bench.py's configuration as written (``plan_gramians``,
   its Gramian options BENCH_GRAM, the default dense_gram, dense_fused
   and budget): every mode on the int8 pair, as each path that follows
   prints its own plan and its seconds:
   - the MovieLens file branch (``models/datasets.py``): the same ratings
     written as ML-10M ships them (``ml-10M100K/ratings.dat``,
     ``UserID::MovieID::Rating::Timestamp``, user ids u + 1, movie ids
     3 m + 7, seeded timestamps), found by ``find_real_ratings`` one level
     down and parsed by ``load_movielens("10m", path=...)``: equal, bit
     for bit, to the generator's data after the same ``np.unique``
     (71,565 x 10,681: two users rate nothing), with the write and parse
     seconds; then bench.py:101-162's configuration as written on the
     parsed data (the plan: every mode on the int8 pair; K6, K7 and K1
     counted), PATHS[32]'s protocol, rmse_sample@40 and rmse_avg in their
     bands;
   - ``ml100k`` (``bench.py:533-537``) from a written ``ml-100k/u.data``
     (tabs, a timestamp column; every id occurs, so the parse must equal
     the data as it is): the plan the planner picks, 200-sweep windows,
     ms/sweep, rmse_avg within RMSE_BAND of the JAX chain's 0.6656 and
     rmse_sample@200 printed beside its 0.7726;
   - the long-chain gate (``tests/test_longchain.py``): 200 sweeps of the
     int8 pair in float32 (K6, K7, K1) against 200 of the float64 gather
     path (K3) on 943 x 1,682 ratings; the posterior-mean RMSEs within
     0.01, the mean of the last four rmse_sample readings within 0.015,
     the mean prediction stdev within 10%;
   - the int8 pair path at K = 32, 64, 96 and 128, the pair stored in one
     orientation.  Every sweep must contract both modes through K6, with
     the table quantized by K7, and sample both entities
     through the path's kernel (K1, K2, K2, K5 twice per entity); peak
     memory must stay below the two-orientation store's (PR 2).  K6 is
     held bit for bit against its plain version at each path's store and
     K, both modes, and timed beside the library (two ``torch._int_mm``
     and the dequant, on a transposed copy for mode 1) and, for mode 1,
     beside its own mode 0 on a transposed copy; a ``torch.profiler``
     split at K = 32, 64 and 128, with the largest kernels of no named
     part (the glue);
   - the driver loop (``MacauEngine.run``) on the int8 pair at K = 32: 20
     sweeps with every option (``DRIVER_RUN``: windows of 5 sweeps,
     metrics read every 5th, a checkpoint every 10, the posterior-sample
     dumps, the jsonl log, the ``torch.profiler`` trace), K6, K7 and K1
     counted with no plain call; the files checked (10 samples, 20 log
     lines, a trace with kernel events, the last checkpoint equal to the
     state); a run resumed from the sweep-10 checkpoint and a run in
     one-sweep windows, each equal to it bit for bit; a window dispatched
     with CUDA sync debugging set to raise; the seconds of a checkpoint,
     a sample dump and a load; run()'s ms/sweep at metrics_every 1 and 20
     and the effective TOP/s of ``flops_per_sweep``;
   - ``sharded1`` (``bench.py:101-145``): the sharded engine
     (``parallel/sharded.py``) on an NCCL group of this process at world
     size 1, ML-10M, K = 32, one int8 pair slab a mode, 40-sweep windows:
     its plan, K6, K7 and K1 counted with no plain call, rmse_sample@40 in
     the JAX band, a ``torch.profiler`` split (NCCL's kernels apart), the
     host time of its collectives, one sweep from the single-device
     engine's state and randoms within SHARDED_SWEEP_TOL (and
     SHARDED_FIXED_TOL with the hyper draws fixed), two runs of one seed
     and a resumed run bit for bit, its ms/sweep beside the single-device
     engine's, its peak memory and build seconds; at world size 2 where
     the host has two cards (one spawned process a card), else a line
     saying why not;
   - the float pair (``dense_int8=False``, the JAX default) at K = 32, one
     timed window of 40 sweeps each with a float32 store and with a
     bfloat16 one (``gram_dtype="bfloat16"``, widened to float32 a slice
     at a time): ``torch.matmul`` products and K1; the contribution of
     each mode held to FLOAT_PAIR_TOL of float64 sums of the same store
     and table, and timed by CUDA events (a ``torch.profiler`` trace of
     this path lost most of its kernel events);
   - the gather path (``dense_gram=False``, bfloat16 gather, the bench's
     25-width bucket ladder) at K = 32 and 64 with "segment" accumulation
     and at K = 32 with "planned".  Every sweep must sample both entities
     through K3 (K = 32) or K4 (K = 64); each path also reports a
     ``torch.profiler`` split of a few sweeps, and two runs of the same
     seed must give the same U, bit for bit (every sum in a fixed order);
     at K = 32 "segment" the driver loop's resume and window checks;
   - the fused path (``dense_fused=True``) at K = 32 and 64, one timed
     window of 40 sweeps and a ``torch.profiler`` split: K7 and K8a twice
     a sweep and the packed sampler (K1, K2), K8a held bitwise against its
     plain version on the path's own store, at K = 32 two runs of one
     seed equal bit for bit; at K = 128 (K8b, K7, the
     blocked sampler on K5; a 20-sweep window); and off
     the s8 path
     (``dense_int8=False``): a bfloat16 table at K = 64 (K8c, K2) and
     K = 128 (K8d, K5), a float32 table at K = 32 (K8c's FMA variant);
     each variant (K8b, K8c, K8d) held against its plain version at the
     path's store and timed beside the library's products on a
     materialized mask and codes, both modes (mode 1 on transposed
     copies); each timed bfloat16 line is followed by its kernel's build
     lines (registers, spills, any C75xx note of a serialized wgmma);
6. the Netflix fused paths at full width: the JAX bench's Netflix-shaped
   ratings (480,189 x 17,770, 100,480,507 stars 1..5, seed 9), K = 32,
   one stored 8.5 GB int8 array, the JAX bench's protocol (8 sweeps a
   window, 3 timed windows), rmse_sample@8 in the JAX chain's band and a
   ``torch.profiler`` split for each:
   - the s8 path, bench.py's configuration as written (the planner must
     choose the fused store: the int8 pair's 17.1 GB exceed the budget):
     K8a and K7 twice a sweep, K1 for both entities; K8a
     bitwise against its plain version at this shape in both modes, and
     the library's ``torch._int_mm`` on the materialized mask, both modes
     (mode 1 on transposed copies);
   - ``netflix_sharded1`` (``bench.py:474-495``): the sharded engine on
     the same data, the fused s8 store's row slab, one sweep a dispatch:
     K8a in both modes (mode 1 raw int32, reduce-scattered), K7 and K1,
     with ``sharded1``'s checks and rmse_sample@8 in the Netflix band;
   - the float path (``dense_int8=False``, a bfloat16 table): K8c twice a
     sweep; K8c against its plain version at this shape in both modes,
     and the library's bfloat16 ``torch.matmul`` on the materialized mask,
     both modes;
   - ``netflix_cont``: the stars jittered by +-0.45, no exact grid: the
     planner's uniform grid within ``dense_fused_tol=0.0125``, on the s8
     path (bench.py's options as written, as for ``netflix_dup``: the
     planner must choose the fused store);
   - ``netflix_gather`` (bench.py:422-472): the same data with
     ``dense_gram=False``, a bfloat16 gather, the bench's ladder, its
     layouts built by the native builder, K3 for both entities, the build
     seconds and rmse_sample@8 in the Netflix band;
   - ``netflix_dup``: every 67th rating a second time (1,499,710 more
     observations), which the one array cannot hold: they ride the gather
     path as a residual, added into the s8 contribution in the packed
     layout; two runs of one seed must give the same U, bit for bit.
7. the graph paths, each built as its ``bench.py`` function builds it
   (float32, seed 42, ``gram_dtype="bfloat16"``, the 25-width ladder, no
   clamp), with a ``torch.profiler`` split:
   - ``tensor``: 30,000 x 2,000 x 16, 5M cells, K = 32, the int8 pair at
     arity 3 (store [30000, 16, 2000]): K6 for each mode's first step, K7
     for each largest partner's table, K1 for the three entities; 15-sweep
     windows, rmse_avg in the JAX band; K6 held against its plain version
     on the store's two 2-D views;
   - ``fusion``: 50,000 compounds sharing three int8 pairs (x 500, 3,000,
     800; 10M cells): K6 and K7 six times a sweep, K1; rmse_avg of
     ``ic50`` in the JAX band; K6 held against its plain version on each
     pair's store, both focus modes; then one window with every alpha
     sampled, the alphas finite, positive and moving;
   - ``tensor_big``: 200,000 x 20,000 x 8, 30M cells, bench.py's options
     as written (the default dense_gram): the planner must send every
     mode to the gather path at arity 3 (K3), 8-sweep windows,
     rmse_sample@8 in the JAX band, layout seconds and peak memory;
   - K9 at tensor_big's shape (the 200,000-row entity's factors, the
     observations sorted by its id), held bit for bit and timed beside
     ``index_select`` in bfloat16 and float32.  No engine path runs K9
     (as in JAX): every path holds its launches to 0, and its row in the
     kernels line says 0;
   - ``tensor4``: tensor's relation with a fourth mode of 4 (30,000 x
     2,000 x 16 x 4, 5M cells, made from a seed), K = 32, the int8 pair at
     arity 4 (``dense_gram=True``, ``dense_int8=True``: one store [30000,
     16, 4, 2000], K6 for each mode's first step, K7, K1) and the gather
     path on the same data; their rmse_avg within RMSE_BAND of each other;
     K6 held against its plain version on the store's two 2-D views.
8. the ChEMBL Macau paths (``bench.py:165-189`` on the port: 15,000
   compounds x 346 targets, 300,000 activities, ``class_cut``
   log10(200), 15,000 x 32,000 binary fingerprint features; K = 32,
   float32, the int8 pair: K6 and K7 for both modes, K1 for both
   entities), each with its build seconds (G, eigh, Nystrom, X'X), the
   kernels' launches a sweep, peak memory and the beta draw's share of
   the sweep (``record_function`` ranges under ``torch.profiler``, and
   CUDA events around the draw):
   - ``chembl``: the dual solve (XX' decomposed in float32 on the card),
     the bench's protocol (20-sweep windows); rmse_avg 0.4998 +- 0.02 and
     AUC 0.8904 +- 0.01 (the JAX chain's), the dual solve's true residual
     below 1e-5 (float64 on the card), K6 held against its plain version
     on the path's store;
   - ``chembl_cg``: Nystrom-preconditioned CG (rank 1024), the same
     protocol and bands, its exit residual below 1e-4, the iterations and
     what their host reads cost;
   - ``chembl_cg_sparse``: Jacobi CG on the bucketed matvec
     (``dense_gram=False``: the relation on the gather path, K3); two runs
     of one seed equal bit for bit, as on ``chembl``;
   - ``chembl_ff``: 4,096 features, the X'X path.
   On every path the plain versions, the other paths' kernels,
   ``torch._int_mm`` and the torch quantization of the table
   (``quantize_table_t``; each counted through a wrapper the script
   installs around each run) must not run, and the RMSEs must lie in the
   JAX chain's bands where the JAX package has one (at K = 128, the port's own chain's).
   Each phase prints its seconds.
9. the planner's constants (``ops/dense_gram.py``) as this run measured
   them, beside the module's: the gather path's seconds per observation
   and mode, and the rates that reproduce K6's, the float pair's, K8a's
   and K8c's times through ``estimate_times``' model; and
   ``use_dense_feat``'s two, from the passes of a dense X and a bucketed
   matvec of ChEMBL's features (the paths use the one the rule picks).

The last lines are the card's ``nvidia-smi`` name and power limit, a JSON
object describing the kernels (with each one's bound on this card) and
the ``{"ok": true, "device": ...}`` line.
"""
import contextlib
import dataclasses
import functools
import glob
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

# The JAX package's chains on the same data and protocol (BENCH_r05.json,
# docs/BENCH_R5_RUNS.md:38,59): rmse_sample at the end of the first window
# and, at K = 32, the posterior-mean rmse after 160 sweeps.  The random
# streams differ, so these are chain-noise bands, not parity checks.  No
# K = 128 figure exists for the JAX package: K = 128 is held to the port's
# own chain on the int8 pair (rmse_sample@20 0.7572 on an NVIDIA H100 with
# the column-slab K5), so a change of the sampler's arithmetic that moves
# the chain shows.
RMSE_BAND = 0.02
# K: (sweeps per window, timed windows, rmse_sample anchor, rmse_avg anchor)
PATHS = {32: (40, 3, 0.6926, 0.6567),
         64: (40, 1, 0.7294, None),
         96: (20, 1, 0.7473, None),
         128: (20, 1, 0.7572, None)}
# The gather paths: (K, accumulation, sweeps per window, timed windows).
# The planned path runs one timed window of 40 sweeps, so that the same
# anchors as at K = 32 apply to it.
GATHER_PATHS = ((32, "segment", 40, 3), (64, "segment", 40, 1),
                (32, "planned", 40, 1))
# the bench's 25-step width ladder (bench.py:24-25)
BENCH_WIDTHS = (8, 12, 16, 20, 24, 28, 32, 40, 48, 56, 64, 80, 96, 112, 128,
                160, 192, 224, 256, 320, 384, 512, 768, 1024, 2048)
KERNEL_ERR_FACTOR = 10.0     # kernel error <= 10x the f32 plain version's
F64_KERNEL_TOL = 1e-9        # float64 kernel vs float64 plain version
# the sampler kernels K1-K5 and K7's two passes (a piece of their mangled
# names): their builds must not spill
SAMPLER_KERNELS = (("K1", "chol_sample_packed_kernel"),
                   ("K2", "chol_sample_packed_slab_kernel"),
                   ("K3", "chol_sample_full_kernel"),
                   ("K4", "chol_sample_full_slab_kernel"),
                   ("K5", "chol_inv_kernel"),
                   ("K7 colmax", "ytab_colmax_kernel"),
                   ("K7 quant", "ytab_quant_kernel"))
# K5's float64 W against the float64 plain version: both are exact to a
# few ulps of W (|W| ~ 1 on these problems)
K5_F64_TOL = 1e-12
# H100 SXM peaks (NVIDIA's data sheet, at 700 W): HBM bytes/s, float32
# FLOP/s outside the tensor cores and dense int8 tensor-core OP/s, for the
# kernels' bounds
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
INT8_OP_S = 1979e12
# The fused sparse regime on the JAX bench's netflix data (bench.py:329-421,
# seed 9): rmse_sample after 8 sweeps of the JAX chain
# (docs/BENCH_R5_RUNS.md:29), a chain-noise band as for ML-10M
NETFLIX_ANCHOR = 0.7055
NETFLIX_SWEEPS, NETFLIX_WINDOWS = 8, 3
# the same data with every 67th observation a second time (bench.py:382-385,
# ``netflix_dup``): the JAX chain's rmse_sample after 8 sweeps
# (docs/BENCH_R5_RUNS.md:47)
NETFLIX_DUP_ANCHOR = 0.7052
# the same cells with the stars jittered by +-0.45 (bench.py:388-405,
# ``netflix_cont``): no exact grid, so the fused path engages through
# ``dense_fused_tol``; the JAX chain's rmse_sample after 8 sweeps
# (docs/BENCH_R5_RUNS.md:33)
NETFLIX_CONT_ANCHOR = 0.7586
NETFLIX_CONT_TOL = 0.0125
# ML-10M through the fused path: one timed window of 40 sweeps at K = 32
# and 64, held to the int8 pair's @40 anchors
FUSED_ML_PATHS = (32, 64)
# ML-10M through the rest of the fused path, one timed window each: (K,
# sweeps a window, options).  K = 128 takes the natural-layout kernels and
# the full-P branch; dense_int8=False the float kernels, with a bfloat16
# table or (gram_dtype None) a float32 one, the FMA variant.  K = 128 has
# no JAX anchor: its rmse_sample is held to this run's int8 pair at K = 128.
# the int8 pair's peak device memory on these paths with the pair stored
# in two orientations (PERF.md, PR 2: NVIDIA H100 80GB HBM3, 700 W); one
# orientation must come in below it
TWO_ORIENTATION_PEAK_GB = {32: 3.78, 64: 5.64, 96: 8.67, 128: 15.19}
# the float pair (dense_int8=False, the JAX default): one timed window of
# 40 sweeps at K = 32 for each store dtype (``gram_dtype``: None stores the
# compute dtype, float32; "bfloat16" as the bench configs ask), held to the
# @40 anchor
FLOAT_PAIR_K = 32
FLOAT_PAIR_STORES = (None, "bfloat16")
# the float pair's contribution against float64 sums of the same (rounded)
# store and table: torch.matmul's float32 sums over up to 71,567 partners,
# in cuBLAS's order, relative to the largest sum
FLOAT_PAIR_TOL = 1e-4
# The graph paths, as the JAX bench builds them (bench.py:194-326; seed 42,
# float32, gram_dtype="bfloat16", the 25-width ladder, no clamp: the values
# are Gaussian): (sweeps a window, timed windows) and the JAX chains' bands
# (docs/BENCH_R5_RUNS.md:11,14,20): ``tensor`` rmse_avg after the
# benchmark protocol, ``tensor_big`` rmse_sample@8, ``fusion`` rmse_avg of
# ``ic50``
TENSOR_RUN, TENSOR_ANCHOR = (15, 3), 0.4375
FUSION_RUN, FUSION_ANCHOR = (15, 3), 0.4406
TENSOR_BIG_RUN, TENSOR_BIG_ANCHOR = (8, 1), 0.4420
# tensor's relation with a fourth mode of 4 (tensor4_synthetic, seed 12):
# the int8 pair at arity 4 (dense_gram=True, dense_int8=True) and the
# gather path on the same data, tensor's protocol; their rmse_avg within
# RMSE_BAND of each other
TENSOR4_SHAPE, TENSOR4_NNZ, TENSOR4_RANK = (30_000, 2_000, 16, 4), \
    5_000_000, 32
GRAPH_OPTS = dict(gram_dtype="bfloat16", bucket_widths=BENCH_WIDTHS)
# The ChEMBL Macau paths (bench.py:165-189): the data, its test split and
# the config (float32, K = 32, gram_dtype="bfloat16", use_ff=False,
# cg_maxiter=100, seed 42, dense_int8=True; no cache dir, so the
# eigendecomposition is built and timed every run; the bench's
# sweeps_per_dispatch=20, which run_path passes, does not change the
# chain), the bench's protocol (20-sweep windows, 3 timed), and the JAX
# chain's quality on the same data and protocol (docs/BENCH_R5_RUNS.md:19:
# rmse_avg 0.4998, AUC 0.8904), held to +-0.02 and +-0.01
CHEMBL_DATA = dict(n_compounds=15_000, n_targets=346, n_features=32_000,
                   nnz=300_000, seed=3)
CHEMBL_TEST = 30_000
CHEMBL_OPTS = dict(gram_dtype="bfloat16", use_ff=False, cg_maxiter=100,
                   dense_int8=True)
CHEMBL_RUN = (20, 3)
CHEMBL_RMSE_ANCHOR, CHEMBL_AUC_ANCHOR = 0.4998, 0.8904
CHEMBL_AUC_BAND = 0.01
# the dual solve's true relative residual (float32, one refinement) must
# stay below CG's float32 floor; CG's exit-time residual below 1e-4
DUAL_RESID_MAX, CG_RESID_MAX = 1e-5, 1e-4
# the sparse-operand CG path (Jacobi, the bucketed matvec, the relation on
# the gather path) and the FF path (4,096 features: F <= ff_threshold)
# run one shorter window each
CHEMBL_SHORT_RUN = (10, 1)
CHEMBL_FF_FEATURES = 4_096
FUSED_ML_MORE = ((128, 20, dict(dense_int8=True)),
                 (64, 40, dict(dense_int8=False, gram_dtype="bfloat16")),
                 (128, 20, dict(dense_int8=False, gram_dtype="bfloat16")),
                 (32, 40, dict(dense_int8=False)))


# The driver loop (MacauEngine.run, ROADMAP M4 and M10) on the main path,
# the ML-10M int8 pair at K = 32: 10 burn-in and 10 sampled sweeps with
# every option (windows of 5 sweeps, metrics read every 5th, a checkpoint
# every 10, the posterior-sample dumps, the jsonl log, the trace); its
# resume and window checks also on the gather path at K = 32 "segment";
# run()'s ms/sweep in one-sweep windows at metrics_every 1 and 20, over
# DRIVER_TIMED sweeps each, in turns
DRIVER_RUN = dict(burnin=10, psamples=10, metrics_every=5,
                  sweeps_per_dispatch=5, checkpoint_every=10)
DRIVER_GATHER = (32, "segment")
DRIVER_TIMED = 100

# The MovieLens file branch (models/datasets.py): a generator's ratings
# written as MovieLens ships them (variant: directory, file, separator, the
# movie ids of movie m; user ids are u + 1, ratings "3" or "3.5", the
# timestamps drawn from FILE_SEED over 1995-2009), found by
# find_real_ratings one level down and parsed by load_movielens(path=...)
RATINGS_FILES = {"10m": ("ml-10M100K", "ratings.dat", "::",
                         lambda m: 3 * m + 7),
                 "100k": ("ml-100k", "u.data", "\t", lambda m: m + 1)}
FILE_SEED = 11
# ml100k (bench.py:533-537, bench_ml("100k", 200)): 200-sweep windows, 3
# timed; rmse_avg held to the JAX chain's on the same data and protocol,
# rmse_sample@200 (one draw) printed beside its figure
# (docs/BENCH_R5_RUNS.md:18)
ML100K_RUN = (200, 3)
ML100K_AVG_ANCHOR, ML100K_SAMPLE_FIGURE = 0.6656, 0.7726
# The long-chain gate (tests/test_longchain.py:21-61): 200 sweeps of the
# int8 pair (float32, bfloat16 gram_dtype) against 200 of the float64
# gather path on 943 x 1,682, 100,000 ratings (seed 5), 10,000 test
# ratings (seed 7): the posterior-mean RMSE, the mean rmse_sample of the
# last four readings and the mean prediction stdev (relative) must agree
LONG_CHAIN = dict(num_latent=32, burnin=100, psamples=100, clamp=(1.0, 5.0),
                  verbose=False, seed=42, sweeps_per_dispatch=25,
                  metrics_every=25)
LONG_RMSE_TOL, LONG_TRAJ_TOL, LONG_STDEV_REL = 0.01, 0.015, 0.10


def require(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean device milliseconds per call of ``fn`` (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def spd_full(K, B, seed, device="cuda"):
    """float64 SPD rows P [B, K, K] (eigenvalues >= 2) and a generator."""
    import torch
    f64 = torch.float64
    g = torch.Generator(device=device).manual_seed(seed)
    A = torch.randn((B, K, K), generator=g, dtype=f64, device=device) * 0.3
    P = torch.baddbmm(torch.eye(K, dtype=f64, device=device).expand(B, K, K),
                      A, A.mT, beta=2.0)
    return P, g


def spd_problem(K, B, seed, device="cuda"):
    """float64 packed SPD rows as the main path hands them to the sampler:
    Pp a [C, B] view of a [C, B_stored] buffer, b [K, B], xi [B, K]."""
    import torch
    from bayesiandatafusion_jl_tpu_torch.ops.dense_gram import (
        STORE_ALIGN, tri_index)
    f64 = torch.float64
    g = torch.Generator(device=device).manual_seed(seed)
    iu, ju, _, _ = tri_index(K, device)
    ld = -(-B // STORE_ALIGN) * STORE_ALIGN
    A = torch.randn((B, K, K), generator=g, dtype=f64, device=device) * 0.3
    buf = torch.zeros((len(iu), ld), dtype=f64, device=device)
    buf[:, :B] = (A @ A.mT)[:, iu, ju].T
    del A
    Lam = torch.randn((K, K), generator=g, dtype=f64, device=device) * 0.2
    Lam = Lam @ Lam.T + 2.0 * torch.eye(K, dtype=f64, device=device)
    b = torch.randn((K, B), generator=g, dtype=f64, device=device)
    xi = torch.randn((B, K), generator=g, dtype=f64, device=device)
    return buf[:, :B], b, xi, Lam


def _verdict(kern, plain, kern64, ref):
    """Errors of the f32 kernel, the f32 plain version and the f64 kernel
    against the f64 plain version, and whether the kernel passes."""
    import torch
    torch.cuda.synchronize()
    err_k = (kern.double() - ref).abs().max().item()
    err_p = (plain.double() - ref).abs().max().item()
    err_k64 = (kern64 - ref).abs().max().item()
    return {"kernel_err": err_k, "plain_f32_err": err_p,
            "kernel_f64_err": err_k64,
            "ok": bool(torch.isfinite(kern).all().item()
                       and err_k <= KERNEL_ERR_FACTOR * err_p
                       and err_k64 <= F64_KERNEL_TOL)}


def check_chol_kernel(K, B, timing=True, seed=0, jitter=0.25):
    """The packed sampler's kernel for this K (K1 for K <= 32, K2 above),
    float32 and float64, and the float32 plain version against the float64
    plain version on the same inputs, Pp a strided [C, B] view."""
    import torch
    from bayesiandatafusion_jl_tpu_torch.ops.chol_packed import (
        chol_sample_packed_dispatch, chol_sample_packed_plain)
    Pp, b, xi, Lam = spd_problem(K, B, seed)
    ref = chol_sample_packed_plain(Pp, b, xi, Lam, jitter)
    f32 = [t.float() for t in (Pp, b, xi, Lam)]
    Pp32 = torch.zeros((Pp.shape[0], Pp.stride(0)), dtype=torch.float32,
                       device=Pp.device)[:, :B]
    Pp32.copy_(f32[0])                         # keep the strided layout
    args32 = (Pp32, *f32[1:])
    kern = chol_sample_packed_dispatch(*args32, jitter)
    plain = chol_sample_packed_plain(*args32, jitter)
    kern64 = chol_sample_packed_dispatch(Pp, b, xi, Lam, jitter)
    r = {"K": K, "B": B, **_verdict(kern, plain, kern64, ref)}
    if timing:
        r["kernel_ms"] = cuda_ms(
            lambda: chol_sample_packed_dispatch(*args32, jitter), 20)
        r["plain_ms"] = cuda_ms(
            lambda: chol_sample_packed_plain(*args32, jitter), 5)
    return r


def check_full_kernel(K, B, lam=True, timing=True, seed=0, jitter=0.25):
    """The full-P sampler's kernel for this K (K3 for K <= 32, K4 above),
    with or without Lambda, float32 and float64, and the float32 plain
    version against the float64 plain version; P [B, K, K] contiguous, as
    the gather path's assembly hands it over."""
    import torch
    from bayesiandatafusion_jl_tpu_torch.ops.chol_full import (
        K3_MAX_K, chol_sample_full, chol_sample_full_plain,
        chol_sample_full_tiled)
    fn = chol_sample_full if K <= K3_MAX_K else chol_sample_full_tiled
    P, g = spd_full(K, B, seed)
    Lam = None
    if lam:
        A = torch.randn((K, K), generator=g, dtype=P.dtype, device=P.device)
        Lam = 0.04 * A @ A.T + torch.eye(K, dtype=P.dtype, device=P.device)
    b = torch.randn((B, K), generator=g, dtype=P.dtype, device=P.device)
    xi = torch.randn((B, K), generator=g, dtype=P.dtype, device=P.device)
    ref = chol_sample_full_plain(P, b, xi, Lam, jitter)
    kern64 = fn(P, b, xi, Lam, jitter)
    args32 = [t.float() for t in (P, b, xi)] + [
        None if Lam is None else Lam.float()]
    del P
    kern = fn(*args32, jitter)
    plain = chol_sample_full_plain(*args32, jitter)
    r = {"K": K, "B": B, "lam": lam, **_verdict(kern, plain, kern64, ref)}
    if timing:
        r["kernel_ms"] = cuda_ms(lambda: fn(*args32, jitter), 20)
        r["plain_ms"] = cuda_ms(
            lambda: chol_sample_full_plain(*args32, jitter), 5)
    return r


def sampler_bound(K, B, lam=True):
    """(bytes, FLOP) a float32 sampler must spend on B rows: read each
    row's triangle, b and xi (and Lambda) once, write u once; factor
    (K^3/3) and two triangular solves (2 K^2)."""
    C = K * (K + 1) // 2
    nbytes = 4 * (B * (C + 3 * K) + (K * K if lam else 0))
    return nbytes, B * (K ** 3 / 3 + 2 * K * K)


def chol_inv_bound(K, B):
    """(bytes, FLOP) of K5 on B float32 panels: read each triangle once,
    write each full W once; factor (K^3/3) and invert L (K^3/3)."""
    return 4 * B * (K * (K + 1) // 2 + K * K), B * (2 * K ** 3 / 3)


def ytab_bound(n, K):
    """(bytes, operations) of K7 on n partner rows: read U twice (one pass
    each), write the [C + K, n] int8 codes once; ~10 operations a cell
    (product, |.|, max, divide, round, clip) on the float32 units."""
    ck = K * (K + 1) // 2 + K
    return 2 * 4 * n * K + ck * n, 10 * ck * n


def fused_pair_bound(shape, stored, K, focus, nnz):
    """(bytes, int8 operations) of K8's function for one focus mode: read
    the stored V8 and the partner table once, write the float32 dq outputs
    once (C + 2K rows of the focus count); a multiply-add into each of the
    C + 2K outputs for each of the ``nnz`` observed cells, the work this
    data needs (the zero cells add nothing)."""
    C = K * (K + 1) // 2
    nf = shape[focus]
    n_contract = stored[1 - focus]
    nbytes = stored[0] * stored[1] + (C + K) * n_contract + 4 * (C + 2 * K) * nf
    return nbytes, 2 * nnz * (C + 2 * K)


def fused_pair_dense_ops(shape, K):
    """The int8 operations of K8's design, which multiplies every cell of
    the true extent, observed or not, on the tensor cores: 2 n0 n1 (C + 2K)."""
    return 2 * shape[0] * shape[1] * (K * (K + 1) // 2 + 2 * K)


def count_observed(V8, rows=16_384):
    """The nonzero cells of V8, counted a block of rows at a time."""
    import torch
    return sum(int(torch.count_nonzero(V8[r:r + rows]).item())
               for r in range(0, V8.shape[0], rows))


def bound_ms(nbytes, flop, rate=F32_FLOP_S):
    """The least time on the card: the larger of bytes over the HBM rate
    and operations over ``rate`` (float32 by default); and which of the two
    it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flop / rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_chol_inv(K, B, timing=True, seed=0, ld=None):
    """K5 (float32 and float64) and the float32 plain version against the
    float64 plain version; W must be exactly zero above the diagonal.
    ``ld``: P is the panel view [:, :K, :K] of a contiguous [B, ld, ld],
    read in place, as the blocked sampler hands over its first panel."""
    import torch
    from bayesiandatafusion_jl_tpu_torch.ops.chol_blocked import (
        chol_inv, chol_inv_plain)
    P, _ = spd_full(K, B, seed)
    if ld is not None:
        big = torch.zeros((B, ld, ld), dtype=P.dtype, device=P.device)
        big[:, :K, :K] = P
        P = big[:, :K, :K]
        P32 = big.float()[:, :K, :K]
        del big
    else:
        P32 = P.float()
    ref = chol_inv_plain(P)
    kern = chol_inv(P32)
    kern64 = chol_inv(P)
    plain = chol_inv_plain(P32)
    r = {"K": K, "B": B, "ld": ld, **_verdict(kern, plain, kern64, ref)}
    upper = torch.triu(torch.ones(K, K, dtype=torch.bool, device=P.device),
                       1)
    r["ok"] = (r["ok"] and r["kernel_f64_err"] <= K5_F64_TOL
               and not bool(kern[:, upper].any().item()
                            or kern64[:, upper].any().item()))
    if timing:
        r["kernel_ms"] = cuda_ms(lambda: chol_inv(P32), 20)
        r["plain_ms"] = cuda_ms(lambda: chol_inv_plain(P32), 5)
    return r


def check_blocked(K, B, timing=True, seed=0, jitter=0.25):
    """The blocked sampler on K5 (float32 and float64) and the float32
    plain sampler on torch.linalg against the float64 plain sampler."""
    import torch
    from bayesiandatafusion_jl_tpu_torch.ops.chol_blocked import \
        chol_sample_blocked
    from bayesiandatafusion_jl_tpu_torch.ops.mvn import chol_sample
    P, g = spd_full(K, B, seed)
    b = torch.randn((B, K), generator=g, dtype=P.dtype, device=P.device)
    xi = torch.randn((B, K), generator=g, dtype=P.dtype, device=P.device)
    ref = chol_sample(P, b, xi, jitter)
    kern64 = chol_sample_blocked(P, b, xi, jitter)
    args32 = [t.float() for t in (P, b, xi)]
    del P
    kern = chol_sample_blocked(*args32, jitter)
    plain = chol_sample(*args32, jitter)
    r = {"K": K, "B": B, **_verdict(kern, plain, kern64, ref)}
    if timing:
        r["kernel_ms"] = cuda_ms(lambda: chol_sample_blocked(*args32, jitter),
                                 5)
        r["plain_ms"] = cuda_ms(lambda: chol_sample(*args32, jitter), 5)
    return r


def adversarial_factors(n, K, n_valid=None, seed=0, device="cuda"):
    """Factors U [n, K] float32 whose table cells fall where K7's codes are
    hardest to get right: in the factor columns (and, through a first
    column of ones, in the products (0, j)), quotients T / s on the
    half-integers -126.5 .. 126.5 and up to two ulps either side of them,
    and at +-127; each column's maximum in row 0, its magnitude 2^-125 ..
    2^60 (the smallest columns' scales floored at FLT_MIN) or all zeros;
    the rows from ``n_valid`` on outside the scales, at +-127.5 s and up
    to three times the maximum (clipped to +-127)."""
    import torch
    from bayesiandatafusion_jl_tpu_torch.ops import dense_gram as dg
    g = torch.Generator(device="cpu").manual_seed(seed)
    nv = n if n_valid is None else n_valid
    e = torch.randint(-60, 61, (K,), generator=g)
    e[K // 3::5] = -125
    top = (1.0 + torch.rand(K, generator=g)) * torch.pow(2.0, e.double())
    top = top.float().to(device)
    top[K // 2::7] = 0.0
    s = torch.clamp_min(top * dg.INV127, dg.TINY)
    half = (torch.randint(-127, 127, (n, K), generator=g) + 0.5).to(device)
    U = half * s
    step = torch.randint(-2, 3, (n, K), generator=g).to(device)
    for k in range(2):
        U = torch.where(step > k, torch.nextafter(U, U.new_tensor(math.inf)),
                        U)
        U = torch.where(step < -k, torch.nextafter(U, U.new_tensor(-math.inf)),
                        U)
    edge = torch.rand((n, K), generator=g).to(device) < 0.05
    U = torch.where(edge, torch.sign(half) * 127.0 * s, U)
    U = torch.clamp(U, -top, top)
    if nv < n:
        out = (torch.randint(-3, 4, (n - nv, K), generator=g)
               .to(device) * top)
        near = 127.5 * s
        out[::3] = torch.nextafter(near, near.new_tensor(math.inf)
                                   ).expand(out[::3].shape)
        out[1::3] = torch.nextafter(near, near.new_tensor(-math.inf)
                                    ).expand(out[1::3].shape)
        U[nv:] = out
    U[0] = top
    if K > 1:
        U[:, 0] = 1.0
    return U.contiguous()


def check_ytab(n, K, n_valid=None, timing=True, seed=0, adversarial=False):
    """K7 against its plain version on random factors U [n, K] (float32),
    or on ``adversarial_factors``, bit for bit: codes (rows padded to a
    multiple of 16, as the engine asks) and scales."""
    import torch
    from bayesiandatafusion_jl_tpu_torch.ops.ytab import (
        ytab_quantize, ytab_quantize_plain)
    g = torch.Generator(device="cuda").manual_seed(seed)
    U = (adversarial_factors(n, K, n_valid, seed) if adversarial else
         torch.randn((n, K), generator=g, device="cuda"))
    rows = -(-n // 16) * 16
    kern, s_k = ytab_quantize(U, n_valid, rows)
    plain, s_p = ytab_quantize_plain(U, n_valid, rows)
    torch.cuda.synchronize()
    diff = max((kern.int() - plain.int()).abs().max().item(),
               (s_k - s_p).abs().max().item())
    r = {"n": n, "K": K, "n_valid": n_valid, "adversarial": adversarial,
         "max_abs_err": diff,
         "ok": bool(torch.equal(kern, plain) and torch.equal(s_k, s_p))}
    if timing:
        r["kernel_ms"] = cuda_ms(lambda: ytab_quantize(U, n_valid, rows), 20)
        r["plain_ms"] = cuda_ms(
            lambda: ytab_quantize_plain(U, n_valid, rows), 5)
    return r


def random_store(true, seed=0, density=0.1):
    """A random fused store: V8 int8 codes in -5..5 on the true extent
    (zero-padded to multiples of 16), as ``build_fused_store`` lays it
    out."""
    import torch
    from bayesiandatafusion_jl_tpu_torch.ops.dense_gram import STORE_ALIGN
    g = torch.Generator(device="cuda").manual_seed(seed)
    stored = [-(-d // STORE_ALIGN) * STORE_ALIGN for d in true]
    V8 = torch.zeros(stored, dtype=torch.int8, device="cuda")
    obs = torch.rand(true, generator=g, device="cuda") < density
    codes = torch.randint(-5, 6, true, generator=g, device="cuda")
    V8[:true[0], :true[1]] = (codes * obs).to(torch.int8)
    return V8


def check_fused_pair(V8, shape, K, focus, timing=True, seed=0):
    """K8 against its plain version on the stored V8 (true extents
    ``shape``) for one focus mode, the partner table K7's codes of random
    factors and random dequant scales, bit for bit in both epilogues (the
    int32 sums are exact and both sides convert and multiply them the same
    way)."""
    import torch
    from bayesiandatafusion_jl_tpu_torch.ops.fused_pair import (
        fused_pair_contract, fused_pair_plain)
    from bayesiandatafusion_jl_tpu_torch.ops.ytab import ytab_quantize
    g = torch.Generator(device="cuda").manual_seed(seed)
    n_contract = V8.shape[1 - focus]
    nf = shape[focus]
    U = torch.randn((shape[1 - focus], K), generator=g, device="cuda")
    YZ8T, s = ytab_quantize(U, out_rows=n_contract)
    dq = (s * 2.5, s[-K:] * 2.5)
    raw_k = fused_pair_contract(V8, YZ8T, focus, K, nf)
    raw_p = fused_pair_plain(V8, YZ8T, focus, K, nf)
    dq_k = fused_pair_contract(V8, YZ8T, focus, K, nf, dq=dq)
    dq_p = fused_pair_plain(V8, YZ8T, focus, K, nf, dq=dq)
    torch.cuda.synchronize()
    pairs = list(zip(raw_k, raw_p)) + list(zip(dq_k, dq_p))
    err = max((a.double() - b.double()).abs().max().item() for a, b in pairs)
    r = {"shape": tuple(shape), "K": K, "focus": focus, "max_abs_err": err,
         "ok": all(torch.equal(a, b) for a, b in pairs)}
    del raw_k, raw_p, dq_k, dq_p, pairs
    if timing:
        r["raw_ms"] = cuda_ms(
            lambda: fused_pair_contract(V8, YZ8T, focus, K, nf), 10)
        r["kernel_ms"] = cuda_ms(
            lambda: fused_pair_contract(V8, YZ8T, focus, K, nf, dq=dq), 10)
        r["plain_ms"] = cuda_ms(
            lambda: fused_pair_plain(V8, YZ8T, focus, K, nf, dq=dq), 2)
        b = fused_pair_bound(shape, V8.shape, K, focus, count_observed(V8))
        r["bound_ms"], r["bound_by"] = bound_ms(*b, rate=INT8_OP_S)
        dense = fused_pair_dense_ops(shape, K)
        r["dense_bound_ms"] = dense / INT8_OP_S * 1e3
        r["tops"] = dense / r["kernel_ms"] * 1e-9
    return r


def pair_contract_bound(shape, stored, K, focus, nnz):
    """(bytes, int8 operations) of K6's function for one focus mode: read
    the stored M8 and W8 and the partner table once, write the float32 dq
    outputs once (C + K rows of the focus count); a multiply-add into each
    of the C + K outputs for each of the ``nnz`` observed cells, the work
    this data needs (the zero cells add nothing)."""
    C = K * (K + 1) // 2
    nf = shape[focus]
    n_contract = stored[1 - focus]
    nbytes = (2 * stored[0] * stored[1] + (C + K) * n_contract
              + 4 * (C + K) * nf)
    return nbytes, 2 * nnz * (C + K)


def pair_contract_dense_ops(shape, K):
    """The int8 operations of K6's design, which multiplies every cell of
    the true extent on the tensor cores: 2 n0 n1 (C + K)."""
    return 2 * shape[0] * shape[1] * (K * (K + 1) // 2 + K)


def random_pair(true, seed=0, density=0.1):
    """A random int8 pair as ``build_int8_pair`` lays it out: counts 1..3
    and value codes in -127..127 on the observed cells of the true extent,
    one [n0, n1] array each, zero-padded to multiples of 16."""
    import torch
    from bayesiandatafusion_jl_tpu_torch.ops.dense_gram import STORE_ALIGN
    g = torch.Generator(device="cuda").manual_seed(seed)
    stored = [-(-d // STORE_ALIGN) * STORE_ALIGN for d in true]
    obs = torch.rand(true, generator=g, device="cuda") < density
    out = {"shape": tuple(true)}
    for key, lo, hi in (("M8", 1, 4), ("W8", -127, 128)):
        t = torch.zeros(stored, dtype=torch.int8, device="cuda")
        codes = torch.randint(lo, hi, true, generator=g, device="cuda")
        t[:true[0], :true[1]] = (codes * obs).to(torch.int8)
        out[key] = t
    return out


def check_pair_contract(pair, K, focus, timing=True, seed=0):
    """K6 against its plain version on the stored pair (``build_int8_pair``
    's layout, true extents ``pair["shape"]``) for one focus mode, the
    partner table ``fused_quantize``'s codes of random factors (K7 up to
    K = 128) and random dequant scales, bit for bit in both epilogues (the
    int32 sums are exact and both sides convert and multiply them the same
    way).  Timing adds the library's time for the same function: two
    ``torch._int_mm`` products and the torch dequant, on the pair as it
    is stored for mode 0 and on a transposed copy for mode 1 (the "TN"
    layout the old path ran), with whether its sums equal K6's; and, for
    mode 1, K6's mode 0 on that transposed copy, the cost of reading the
    one store strided measured against a second stored orientation."""
    import torch
    from bayesiandatafusion_jl_tpu_torch.ops import dense_gram as dg
    from bayesiandatafusion_jl_tpu_torch.ops.pair_contract import (
        pair_contract, pair_contract_plain)
    M8, W8, shape = pair["M8"], pair["W8"], pair["shape"]
    g = torch.Generator(device="cuda").manual_seed(seed)
    C = K * (K + 1) // 2
    n_contract = M8.shape[1 - focus]
    nf = shape[focus]
    U = torch.randn((shape[1 - focus], K), generator=g, device="cuda")
    YZ8T = dg.fused_quantize(U, pad_rows=n_contract,
                             tri=dg.tri_index(K, "cuda"))[0]
    dq = tuple(torch.rand(n, generator=g, device="cuda") + 0.5
               for n in (C, K))
    raw_k = pair_contract(M8, W8, YZ8T, focus, K, nf)
    raw_p = pair_contract_plain(M8, W8, YZ8T, focus, K, nf)
    dq_k = pair_contract(M8, W8, YZ8T, focus, K, nf, dq=dq)
    dq_p = pair_contract_plain(M8, W8, YZ8T, focus, K, nf, dq=dq)
    torch.cuda.synchronize()
    pairs = list(zip(raw_k, raw_p)) + list(zip(dq_k, dq_p))
    err = max((a.double() - b.double()).abs().max().item() for a, b in pairs)
    r = {"shape": tuple(shape), "K": K, "focus": focus, "max_abs_err": err,
         "ok": all(torch.equal(a, b) for a, b in pairs)}
    del raw_p, dq_k, dq_p, pairs
    if not timing:
        return r
    r["raw_ms"] = cuda_ms(lambda: pair_contract(M8, W8, YZ8T, focus, K, nf),
                          10)
    r["kernel_ms"] = cuda_ms(
        lambda: pair_contract(M8, W8, YZ8T, focus, K, nf, dq=dq), 10)
    r["plain_ms"] = cuda_ms(
        lambda: pair_contract_plain(M8, W8, YZ8T, focus, K, nf, dq=dq), 3)
    b = pair_contract_bound(shape, M8.shape, K, focus, count_observed(M8))
    r["bound_ms"], r["bound_by"] = bound_ms(*b, rate=INT8_OP_S)
    dense = pair_contract_dense_ops(shape, K)
    r["dense_bound_ms"] = dense / INT8_OP_S * 1e3
    r["tops"] = dense / r["kernel_ms"] * 1e-9
    # the focus-leading copies: the store itself for mode 0, a transposed
    # copy for mode 1 (made here, for these timings only)
    Mt, Wt = ((M8, W8) if focus == 0 else
              (M8.mT.contiguous(), W8.mT.contiguous()))
    Y8, Z8 = YZ8T[:C], YZ8T[C:]

    def lib():
        return (torch._int_mm(Y8, Mt.mT).float() * dq[0][:, None],
                torch._int_mm(Z8, Wt.mT).float() * dq[1][:, None])
    r["library_ms"] = cuda_ms(lib, 10)
    pm, bv = torch._int_mm(Y8, Mt.mT), torch._int_mm(Z8, Wt.mT)
    r["library_equal"] = bool(torch.equal(pm[:, :nf], raw_k[0])
                              and torch.equal(bv[:, :nf], raw_k[1]))
    del pm, bv, raw_k
    if focus == 1:
        r["transposed_ms"] = cuda_ms(
            lambda: pair_contract(Mt, Wt, YZ8T, 0, K, nf, dq=dq), 10)
    return r


def print_pair_check(label, r):
    line = (f"# K6 {label} {r['shape']} K={r['K']} focus {r['focus']}: "
            f"bitwise {r['ok']} (max diff {r['max_abs_err']})")
    if "kernel_ms" in r:
        line += (f"; dq {r['kernel_ms']:.4f} ms ({r['tops']:.1f} dense "
                 f"TOP/s), raw {r['raw_ms']:.4f} ms, plain "
                 f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                 f"({r['bound_by']}); the dense-MMA design's floor "
                 f"{r['dense_bound_ms']:.4f} ms; library (two "
                 f"torch._int_mm, TN, and the dequant) "
                 f"{r['library_ms']:.4f} ms, sums equal "
                 f"{r['library_equal']}")
        if "transposed_ms" in r:
            line += (f"; K6 mode 0 on a transposed copy "
                     f"{r['transposed_ms']:.4f} ms")
    print(line, flush=True)
    if "kernel_ms" in r:
        print_ptxas(f"pair_contract_kernelILi{r['focus']}ELb1E")


def print_ptxas(name):
    """The build lines of the kernels whose mangled name contains ``name``:
    registers, spills and any C75xx line (a serialized wgmma).  Returns
    them."""
    from bayesiandatafusion_jl_tpu_torch import kernels
    lines = kernels.ptxas_lines(kernels.build_report()["log"], name)
    for b in lines:
        print(f"#   build: {b}", flush=True)
    return lines


def spills(lines):
    """The spill bytes (stores + loads) that ptxas lines report."""
    import re
    return sum(int(n) for line in lines
               for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", line))


def check_sampler_builds():
    """The sampler kernels' and K7's ptxas lines; fails on any spill."""
    for tag, name in SAMPLER_KERNELS:
        print(f"# {tag} build ({name}):", flush=True)
        lines = print_ptxas(name)
        require(lines and spills(lines) == 0,
                f"{tag} spills or has no build lines: {lines}")


BF16_FLOP_S = 989e12
# a float variant's sums against the float64 sums of the same (rounded)
# table: the rounding of the float32 accumulation only (exact products),
# relative to the largest sum
FLOAT_TOL = {"bfloat16": 1e-5, "float32": 1e-5, "float64": 1e-10}


def check_fused_variant(V8, shape, K, focus, table, flip_out, timing=True,
                        seed=0):
    """K8's other variants on the stored V8 (true extents ``shape``) for one
    focus mode: ``table`` "int8" (K7's codes of random factors up to
    K = 128, the torch quantization above; the natural layout, K8b, bit for
    bit against its plain version) or "bfloat16", "float32", "float64" (the
    float table of random factors; ``flip_out`` K8c, else K8d).  A float
    variant is held to FLOAT_TOL of the largest sum against the plain
    version on the same table widened to float64, the exact sums; its
    plain version's own error against them is reported beside it."""
    import torch
    from bayesiandatafusion_jl_tpu_torch.ops import dense_gram as dg
    from bayesiandatafusion_jl_tpu_torch.ops.fused_pair import (
        fused_pair_contract, fused_pair_plain)
    g = torch.Generator(device="cuda").manual_seed(seed)
    n_contract = V8.shape[1 - focus]
    nf = shape[focus]
    U = torch.randn((shape[1 - focus], K), generator=g, device="cuda")
    tri = dg.tri_index(K, "cuda")
    if table == "int8":
        YZT = dg.fused_quantize(U, pad_rows=n_contract, tri=tri)[0]
    else:
        YZT = dg.fused_table(U, getattr(torch, table), n_contract, tri)

    def max_diff(xs, ys):
        return max((a.double() - b.double()).abs().max().item()
                   for a, b in zip(xs, ys))
    kern = fused_pair_contract(V8, YZT, focus, K, nf, flip_out=flip_out)
    plain = fused_pair_plain(V8, YZT, focus, K, nf, flip_out=flip_out)
    torch.cuda.synchronize()
    r = {"shape": tuple(shape), "K": K, "focus": focus, "table": table,
         "flip_out": flip_out}
    if table == "int8":
        r["max_abs_err"] = max_diff(kern, plain)
        r["ok"] = all(torch.equal(a, b) for a, b in zip(kern, plain))
        r["max_abs"] = max(b.abs().max().item() for b in plain)
    else:
        exact = plain if table == "float64" else fused_pair_plain(
            V8, YZT.double(), focus, K, nf, flip_out=flip_out)
        r["max_abs"] = max(b.abs().max().item() for b in exact)
        r["max_abs_err"] = max_diff(kern, exact)
        r["plain_err"] = max_diff(plain, exact)
        r["ok"] = (all(bool(torch.isfinite(a).all().item()) for a in kern)
                   and r["max_abs_err"] <= FLOAT_TOL[table] * r["max_abs"])
        del exact
    del kern, plain
    if timing:
        r["kernel_ms"] = cuda_ms(
            lambda: fused_pair_contract(V8, YZT, focus, K, nf,
                                        flip_out=flip_out), 5)
        r["plain_ms"] = cuda_ms(
            lambda: fused_pair_plain(V8, YZT, focus, K, nf,
                                     flip_out=flip_out), 2)
        C = K * (K + 1) // 2
        rate = {"int8": INT8_OP_S, "bfloat16": BF16_FLOP_S}.get(table,
                                                                F32_FLOP_S)
        nbytes = (V8.numel() + YZT.numel() * YZT.element_size()
                  + 4 * (C + 2 * K) * nf)
        r["bound_ms"], r["bound_by"] = bound_ms(
            nbytes, 2 * count_observed(V8) * (C + 2 * K), rate=rate)
        dense = fused_pair_dense_ops(shape, K)
        r["dense_bound_ms"] = dense / rate * 1e3
        r["tops"] = dense / r["kernel_ms"] * 1e-9
    return r


def print_variant_check(label, r):
    tag = ("K8b" if r["table"] == "int8" else
           "K8c" if r["flip_out"] else "K8d")
    line = (f"# {tag} {label} {r['shape']} K={r['K']} focus {r['focus']} "
            f"{r['table']}: ok {r['ok']} (max |diff| {r['max_abs_err']:.3e} "
            f"of max |sum| {r['max_abs']:.3e}")
    line += (f"; the plain version's {r['plain_err']:.3e})"
             if "plain_err" in r else ")")
    if "kernel_ms" in r:
        line += (f"; kernel {r['kernel_ms']:.4f} ms ({r['tops']:.1f} dense "
                 f"TOP/s), plain {r['plain_ms']:.4f} ms, bound "
                 f"{r['bound_ms']:.4f} ms ({r['bound_by']}); the dense-MMA "
                 f"design's floor {r['dense_bound_ms']:.4f} ms")
    print(line, flush=True)
    if r["table"] == "bfloat16" and "kernel_ms" in r:
        # the build of this mode's and layout's ring kernel
        print_ptxas(f"fused_pair_bf16_kernelILi{r['focus']}ELb"
                    f"{int(not r['flip_out'])}E")


def materialized(V8, focus, dt, rows=16_384):
    """The library's operands for K8's focus mode: V8's 0/1 mask and its
    codes in ``dt``, [n0, n1] for mode 0, transposed to [n1, n0] for mode 1
    (made a block of rows at a time)."""
    import torch
    n0, n1 = V8.shape
    shape = (n0, n1) if focus == 0 else (n1, n0)
    mask = torch.empty(shape, dtype=dt, device=V8.device)
    codes = V8 if focus == 0 and dt == torch.int8 else torch.empty(
        shape, dtype=dt, device=V8.device)
    for r in range(0, n0, rows):
        blk = V8[r:r + rows]
        if focus == 0:
            mask[r:r + rows] = blk != 0
            if codes is not V8:
                codes[r:r + rows] = blk
        else:
            mask[:, r:r + rows] = (blk != 0).mT
            codes[:, r:r + rows] = blk.mT
    return mask, codes


def time_mask_library(V8, K, table="int8", focus=0, seed=0):
    """The library's time for K8's function in focus mode ``focus``: one
    product of the materialized 0/1 mask against the partner table and one
    of V8's codes against the factors (two calls; making the mask and the
    codes in the table's type, and for mode 1 their transposed copies, is
    not timed) — ``torch._int_mm`` for an int8 table, ``torch.matmul`` in
    the table's type (its output rounded to that type) for a float one.
    For int8, also whether its int32 sums equal the kernel's (the natural
    layout at the stored extent)."""
    import torch
    from bayesiandatafusion_jl_tpu_torch.ops import dense_gram as dg
    from bayesiandatafusion_jl_tpu_torch.ops.fused_pair import \
        fused_pair_contract
    g = torch.Generator(device="cuda").manual_seed(seed)
    n_contract = V8.shape[1 - focus]
    U = torch.randn((n_contract, K), generator=g, device="cuda")
    tri = dg.tri_index(K, "cuda")
    if table == "int8":
        YZT = dg.fused_quantize(U, pad_rows=n_contract, tri=tri)[0]
        dt, mm = torch.int8, torch._int_mm
    else:
        dt = getattr(torch, table)
        YZT = dg.fused_table(U, dt, n_contract, tri)
        mm = torch.matmul
    mask, codes = materialized(V8, focus, dt)
    ZT = YZT[-K:]

    def lib():
        return mm(mask, YZT.mT), mm(codes, ZT.mT)
    ms = cuda_ms(lib, 5)
    if table != "int8":
        return ms, None
    pm, bv = lib()
    del mask, codes
    PM, BV = fused_pair_contract(V8, YZT, focus, K, V8.shape[focus],
                                 flip_out=False)
    return ms, bool(torch.equal(pm, PM) and torch.equal(bv, BV))


def check_int8_contraction(n_rows=2048, K=32, seed=1):
    """The plain versions' int8 products (``torch._int_mm``) equal float64
    matmuls of the same int8 codes exactly, for a block of rows of each
    mode at ML-10M shapes (partner widths padded as the engine stores
    them)."""
    import torch
    from bayesiandatafusion_jl_tpu_torch.ops.fused_pair import int8_matmul
    g = torch.Generator(device="cuda").manual_seed(seed)
    C = K * (K + 1) // 2
    out = []
    for n_partner in (10_688, 71_568):
        a = torch.randint(-127, 128, (C, n_partner), generator=g,
                          device="cuda", dtype=torch.int8)
        blk = torch.randint(-127, 128, (n_rows, n_partner), generator=g,
                            device="cuda", dtype=torch.int8)
        got = int8_matmul(a, blk.mT)
        want = a.double() @ blk.double().mT
        out.append(bool(got.dtype == torch.int32
                        and torch.equal(got.double(), want)))
    return out


def windowed_expand_bytes(n_blocks, K, itemsize, table_rows):
    """The bytes K9's function must move for a plan of ``n_blocks`` blocks:
    write the [n_blocks * 1024, K] output once, read the lanes and the
    window map once and each of the ``table_rows`` table rows its windows
    cover once (a window read by several blocks counts once).  It does no
    arithmetic."""
    return (n_blocks * (1024 * (K * itemsize + 4) + 4)
            + table_rows * K * itemsize)


def window_rows(wmap, n_table):
    """The table rows the plan's distinct windows cover."""
    import numpy as np
    w = np.unique(wmap).astype(np.int64)
    return int(np.minimum(128, n_table - 128 * w).sum())


def ragged_parts(n_table, n_obs, seed, hot=0, gap=0):
    """Sorted partner ids: ``hot`` of them in window 0 (several 1024-slot
    blocks), none in windows 1 .. ``gap`` (empty windows), the rest
    uniform."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lo = min(128 * (gap + 1), n_table - 1) if gap else 0
    part = rng.integers(lo, n_table, n_obs)
    part[:hot] = rng.integers(0, min(128, n_table), hot)
    return np.sort(part).astype(np.int32)


def check_windowed_expand(part, n_table, K, dtype, timing=True, seed=0):
    """K9 against its plain version on random factors U [n_table, K] in
    ``dtype`` for the plan of the sorted partner ids ``part``, bit for bit,
    and every observation's slot holding its partner's row.  Timing adds
    the library's time for the same rows: one ``index_select`` of the
    observations' partner rows (in observation order, without the plan's
    tail slots), and K9's bound."""
    import torch
    from bayesiandatafusion_jl_tpu_torch.ops.gather_expand import (
        build_window_plan, windowed_expand, windowed_expand_plain)
    t0 = time.perf_counter()
    lanes, wmap, slot_of = build_window_plan(part, n_table)
    plan_s = time.perf_counter() - t0
    g = torch.Generator(device="cuda").manual_seed(seed)
    U = torch.randn((n_table, K), generator=g, device="cuda").to(
        getattr(torch, dtype))
    L = torch.from_numpy(lanes).to("cuda")
    Wm = torch.from_numpy(wmap).to("cuda")
    rows = torch.from_numpy(part).to("cuda").to(torch.int64)
    kern = windowed_expand(U, L, Wm)
    plain = windowed_expand_plain(U, L, Wm)
    torch.cuda.synchronize()
    err = (kern.double() - plain.double()).abs().max().item()
    ok = bool(torch.equal(kern, plain))
    ok = ok and bool(torch.equal(
        kern[torch.from_numpy(slot_of).to("cuda")], U[rows]))
    r = {"n_table": n_table, "n_obs": len(part), "K": K, "dtype": dtype,
         "n_blocks": len(wmap), "plan_s": plan_s, "max_abs_err": err,
         "ok": ok}
    del kern, plain
    if timing:
        r["kernel_ms"] = cuda_ms(lambda: windowed_expand(U, L, Wm), 10)
        r["plain_ms"] = cuda_ms(lambda: windowed_expand_plain(U, L, Wm), 3)
        r["library_ms"] = cuda_ms(lambda: U.index_select(0, rows), 10)
        r["bound_ms"], r["bound_by"] = bound_ms(windowed_expand_bytes(
            len(wmap), K, U.element_size(), window_rows(wmap, n_table)), 0)
    return r


def print_expand_check(label, r):
    line = (f"# K9 {label} table {r['n_table']} x K={r['K']} {r['dtype']}, "
            f"{r['n_obs']} observations in {r['n_blocks']} blocks (plan "
            f"{r['plan_s']:.2f} s): bitwise {r['ok']} (max diff "
            f"{r['max_abs_err']})")
    if "kernel_ms" in r:
        line += (f"; kernel {r['kernel_ms']:.4f} ms "
                 f"({r['n_blocks'] * 1024 / r['kernel_ms'] * 1e3:.4g} "
                 f"slots/s), "
                 f"plain {r['plain_ms']:.4f} ms, library (index_select) "
                 f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                 f"({r['bound_by']})")
    print(line, flush=True)


def counters():
    """(function, attribute) of each kernel wrapper's launch count and each
    plain version's call count, by name."""
    from bayesiandatafusion_jl_tpu_torch.ops import (chol_blocked, chol_full,
                                                     chol_packed, fused_pair,
                                                     gather_expand,
                                                     pair_contract, ytab)
    return {"K1": (chol_packed.chol_sample_packed, "launches"),
            "K2": (chol_packed.chol_sample_packed_tiled, "launches"),
            "K3": (chol_full.chol_sample_full, "launches"),
            "K4": (chol_full.chol_sample_full_tiled, "launches"),
            "K5": (chol_blocked.chol_inv, "launches"),
            "K6": (pair_contract.pair_contract, "launches"),
            "K7": (ytab.ytab_quantize, "launches"),
            "K8a": (fused_pair.fused_pair_contract, "launches_i8_flip"),
            "K8b": (fused_pair.fused_pair_contract, "launches_i8_nat"),
            "K8c": (fused_pair.fused_pair_contract, "launches_f_flip"),
            "K8d": (fused_pair.fused_pair_contract, "launches_f_nat"),
            "K9": (gather_expand.windowed_expand, "launches"),
            "plain_packed": (chol_packed.chol_sample_packed_plain, "calls"),
            "plain_full": (chol_full.chol_sample_full_plain, "calls"),
            "plain_inv": (chol_blocked.chol_inv_plain, "calls"),
            "plain_ytab": (ytab.ytab_quantize_plain, "calls"),
            "plain_fused": (fused_pair.fused_pair_plain, "calls"),
            "plain_pair": (pair_contract.pair_contract_plain, "calls"),
            "plain_expand": (gather_expand.windowed_expand_plain, "calls")}


def read_counts():
    return {k: getattr(f, a) for k, (f, a) in counters().items()}


def zero_counts():
    for f, a in counters().values():
        setattr(f, a, 0)


def graph_kernels(prob, K, blocks=lambda ei: 1):
    """{counter: launches per sweep} of the kernels a sweep must run, from
    its compiled problem: per dense (relation, mode) of its plan
    (``dense_plans``) on an int8 pair K6 once, on a fused store its K8
    variant once (by operand type and layout), and on either s8 kind, up to
    K = 128, K7 once (the largest partner's table); per entity, up to K =
    96, the packed sampler (K1, K2) where it has a dense contribution, else
    the full-P one (K3, K4), and above K = 96 K5 twice (the blocked
    sampler), each ``blocks(ei)`` times (the sharded engine draws an
    entity's rows in its exchange blocks: ``sharded_blocks``).  The float
    pair and the gather path launch no kernel of their own."""
    from bayesiandatafusion_jl_tpu_torch.ops import ytab
    want = {}

    def add(tag, n=1):
        want[tag] = want.get(tag, 0) + n
    packed = K <= 96
    for ei in range(len(prob.entity_specs)):
        dense = False
        for ri, rs in enumerate(prob.rel_specs):
            kind = prob.kinds[ri]
            for mode, e in enumerate(rs.entity_ids):
                if e != ei or (ri, mode) not in prob.dense_plans:
                    continue
                dense = True
                i8 = (prob.fused_i8s if kind == "fused" else
                      prob.pair_i8s)[ri]
                if kind == "fused":
                    add(("K8a" if packed else "K8b") if i8 else
                        ("K8c" if packed else "K8d"))
                elif i8:
                    add("K6")
                if i8 and K <= ytab.K7_MAX_K:
                    add("K7")
        if not packed:
            add("K5", 2 * blocks(ei))
        else:
            add(("K1" if K <= 32 else "K2") if dense else
                ("K3" if K <= 32 else "K4"), blocks(ei))
    return want


def sharded_blocks(prob):
    """The number of sampler calls a sweep makes for each entity of a
    sharded problem: its exchange blocks where they divide its rows
    (``ShardedMacauEngine._exchange``), else 1."""
    def blocks(ei):
        n_loc = prob.ent_meta[ei].n_loc
        n_blk = max(1, min(prob.exchange_blocks, n_loc))
        return n_blk if (n_loc // n_blk) * n_blk == n_loc else 1
    return blocks


def counted(fn):
    """``fn()``'s result and the counts of its run: every kernel's launches
    and plain version's calls (set to 0 just before, read just after) and,
    under "torch._int_mm", the calls of the library's int8 GEMM, and under
    "quantize_table_t" those of the torch quantization of the table (above
    K7's K = 128), which must not run on any path (each counted through a
    wrapper installed for the run)."""
    import torch
    from bayesiandatafusion_jl_tpu_torch.ops import dense_gram as dg
    int_mm, table_t = torch._int_mm, dg.quantize_table_t
    calls = {"torch._int_mm": 0, "quantize_table_t": 0}

    def counting(name, f):
        def wrapped(*a, **kw):
            calls[name] += 1
            return f(*a, **kw)
        return wrapped
    torch._int_mm = counting("torch._int_mm", int_mm)
    dg.quantize_table_t = counting("quantize_table_t", table_t)
    zero_counts()
    try:
        out = fn()
        counts = read_counts()
    finally:
        torch._int_mm, dg.quantize_table_t = int_mm, table_t
    counts.update(calls)
    return out, counts


def store_text(store, kind, i8):
    """A relation's store as ``run_path`` prints it: its array's shape,
    its kind and its mode order (the kind alone without a store)."""
    if store is None:
        return kind
    arr = store["V8"] if kind == "fused" else store["M8" if i8 else "M"]
    return f"{tuple(arr.shape)} {kind} order {store.get('order')}"


def run_path(rd, K, sweeps, repeats, anchor_s, anchor_avg, name="ML-10M",
             clamp=(1.0, 5.0), graph=False, **opts):
    """One main path: the benchmark protocol at rank K (``opts`` select the
    gather or the fused path, or leave it to the planner), with the
    kernels' counts set to 0 just before it and read just after.
    ``graph``: a graph of several relations or a tensor, labelled by its
    relations.  Every ``bench.py``
    configuration dispatches a window's sweeps at once
    (``sweeps_per_dispatch`` = its window: ``bench.py:133, 179, 215, 273,
    318, 415``), and so does every path here unless ``opts`` say
    otherwise.  Returns the engine, the counts and the benchmark's
    result."""
    import torch
    from bayesiandatafusion_jl_tpu_torch.models.engine import MacauEngine
    from bayesiandatafusion_jl_tpu_torch.utils.config import MacauConfig
    cfg = MacauConfig(num_latent=K, burnin=sweeps, psamples=0,
                      clamp=clamp, verbose=False, dtype="float32",
                      seed=42, **{"sweeps_per_dispatch": sweeps, **opts})
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = MacauEngine(rd, cfg, device="cuda")
    build_s = time.perf_counter() - t0
    prob = eng.problem
    gather = not prob.dense_plans
    fused = prob.kinds[0] == "fused"
    require(fused or not cfg.dense_fused,
            f"{name} K={K}: the fused store was not built")
    require(gather or cfg.dense_gram is not False,
            f"{name} K={K}: dense modes under dense_gram=False")
    require(not fused or prob.fused_i8s[0] == cfg.dense_int8,
            f"{name} K={K}: the fused path's s8 decision is "
            f"{prob.fused_i8s[0]}")
    pair_i8 = prob.pair_i8s[0]
    require(prob.kinds[0] != "pair" or pair_i8 == cfg.dense_int8,
            f"{name} K={K}: the pair's int8 decision is {pair_i8}")
    if graph:
        rels = []
        for rs, kind, i8 in zip(prob.rel_specs, prob.kinds, prob.pair_i8s):
            dims = "x".join(str(prob.entity_specs[e].n)
                            for e in rs.entity_ids)
            rels.append(f"{rs.name} {dims} {kind}{' int8' if i8 else ''}")
        label = f"{name} {' + '.join(rels)} K={K}"
    elif gather:
        label = f"{name} gather {cfg.accumulation} K={K}"
    elif fused:
        table = "s8" if prob.fused_i8s[0] else (cfg.gram_dtype or cfg.dtype)
        label = (f"{name} fused {table} K={K}"
                 + (" with residual" if prob.residual_nnzs[0] else ""))
    elif pair_i8:
        label = f"{name} int8 pair K={K}"
    else:
        label = f"{name} float pair {cfg.gram_dtype or cfg.dtype} K={K}"
    t0 = time.perf_counter()
    out, counts = counted(lambda: eng.benchmark(sweeps, repeats=repeats))
    bench_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    m = out["metrics"]
    wins = out["ms_per_sweep"]
    med = sorted(wins)[len(wins) // 2]
    n_rows = sum(es.n for es in prob.entity_specs)
    if gather:
        built = (f"layout {prob.layout_seconds:.1f} s, padded nnz per mode "
                 f"{prob.padded_nnz}")
    elif graph:
        built = "stores " + ", ".join(
            store_text(st, kind, i8)
            for st, kind, i8 in zip(prob.stores, prob.kinds, prob.pair_i8s))
        if prob.layouts:
            built += (f", layouts {prob.layout_seconds:.1f} s of "
                      f"{sorted(prob.layouts)}")
    elif fused:
        built = (f"V8 build {prob.build_seconds - prob.plan.seconds:.1f} s, "
                 f"V8 {tuple(prob.stores[0]['V8'].shape)}")
        if prob.residual_nnzs[0]:
            rows = [sum(ba["inst"].shape[0] for ba in prob.layouts[k])
                    for k in ("r0m0", "r0m1")]
            built += (f", residual {prob.residual_nnzs[0]} observations, "
                      f"bucket "
                      f"rows per mode {rows}, padded cells per mode "
                      f"{prob.padded_nnz}, layouts "
                      f"{prob.layout_seconds:.1f} s")
    else:
        M = prob.stores[0]["M8" if pair_i8 else "M"]
        built = (f"pair store {prob.build_seconds:.1f} s, M and W "
                 f"{tuple(M.shape)} {M.dtype}")
    print(f"# path {label}: ms/sweep per window {wins}, median {med:.3f}; "
          f"rows/s {n_rows / med * 1e3:.1f}; rmse_sample@{sweeps} "
          f"{out['rmse_at_sweeps']:.4f}; rmse_avg {m['r0.rmse_avg']:.4f}; "
          f"peak memory {peak_gb:.2f} GB; counts {counts}; engine build "
          f"{build_s:.1f} s (plan {prob.plan.seconds:.1f} s, {built}); "
          f"benchmark {bench_s:.1f} s with its warm window", flush=True)
    total_sweeps = sweeps * (repeats + 1)
    want = {k: 0 for k in counts}
    for tag, per_sweep in graph_kernels(prob, K).items():
        want[tag] = per_sweep * total_sweeps
    require(counts == want, f"{label}: counts {counts} for {total_sweeps} "
                            f"sweeps, want {want}")
    vals = [*wins, out["rmse_at_sweeps"], *m.values()]
    require(all(math.isfinite(v) for v in vals),
            f"{label}: non-finite metrics {m}")
    if anchor_s is not None:
        require(abs(out["rmse_at_sweeps"] - anchor_s) <= RMSE_BAND,
                f"{label}: rmse_sample@{sweeps} {out['rmse_at_sweeps']} "
                f"outside {anchor_s} +- {RMSE_BAND}")
    if anchor_avg is not None:
        require(abs(m["r0.rmse_avg"] - anchor_avg) <= RMSE_BAND,
                f"{label}: rmse_avg {m['r0.rmse_avg']} outside "
                f"{anchor_avg} +- {RMSE_BAND}")
    return eng, counts, out


# every bench.py configuration's Gramian options (bench.py:131-133,
# :176-180, :213-216, :271-273, :316-319, :413-421): the int8 pair where
# eligible, a bfloat16 gather and float table, dense_gram, dense_fused and
# the budget left to their defaults (netflix_gather: dense_gram=False)
BENCH_GRAM = dict(dense_int8=True, gram_dtype="bfloat16")


def plan_paths(rd, plan):
    """{(relation, mode): path} of ``plan_gramians``' plan: "pair int8",
    "pair float", "fused" or "gather"."""
    out = {}
    for ri, rel in enumerate(rd.relations):
        for mode in range(rel.arity):
            p = plan.dense_plans.get((ri, mode))
            out[(ri, mode)] = (
                "gather" if p is None else "fused" if p.kind == "fused"
                else "pair int8" if plan.pair_i8[ri] else "pair float")
    return out


def print_plan(label, rd, plan, want=None):
    """Print a plan per (relation, mode), its path and its store's bytes
    (a gather mode: its relation's observations), and require every mode
    on ``want`` (where given)."""
    paths = plan_paths(rd, plan)
    parts = []
    for (ri, mode), path in paths.items():
        rel = rd.relations[ri]
        size = (f"{rel.data.nnz} observations" if path == "gather"
                else f"store {plan.store_bytes[ri] / 1e9:.3f} GB")
        parts.append(f"{rel.name} mode {mode} ({rel.entities[mode].count} "
                     f"rows): {path}, {size}")
    print(f"# plan of {label}: {'; '.join(parts)}; planner "
          f"{plan.seconds:.2f} s", flush=True)
    require(want is None or set(paths.values()) == {want},
            f"{label}: the plan {paths}, want every mode on {want}")


def bench_plan(rd, **opts):
    """``plan_gramians`` of ``rd`` under bench.py's Gramian options
    (BENCH_GRAM, K = 32), ``opts`` added."""
    from bayesiandatafusion_jl_tpu_torch.models.engine import plan_gramians
    from bayesiandatafusion_jl_tpu_torch.utils.config import MacauConfig
    return plan_gramians(rd, MacauConfig(num_latent=32, verbose=False,
                                         dtype="float32", seed=42,
                                         **BENCH_GRAM, **opts))


# kernel-name fragments of each part of a gather sweep (torch.profiler);
# the segment sum sorts the rows' instances, gathers the rows in that
# order ("gather": an index_select) and sums each instance's run
SPLIT = (("sampler", ("chol_sample", "chol_inv")),
         ("gather", ("gather_kernel", "indexSelect")),
         ("segment sum", ("indexFunc", "segment_reduce", "radixSort",
                          "RadixSort", "searchsorted")),
         ("bmm", ("gemm", "gemv", "cutlass", "xmma", "sm90_")))


# ... and of a fused sweep: K8 per focus mode (the demangled or mangled
# template argument), K7, the packed sampler
FUSED_SPLIT = (("K8 mode 0", ("fused_pair_kernel<0", "fused_pair_kernelILi0",
                              "fused_pair_bf16_kernel<0",
                              "fused_pair_bf16_kernelILi0",
                              "fused_pair_fma_kernel<float, 0",
                              "fused_pair_fma_kernelIfLi0")),
               ("K8 mode 1", ("fused_pair_kernel<1", "fused_pair_kernelILi1",
                              "fused_pair_bf16_kernel<1",
                              "fused_pair_bf16_kernelILi1",
                              "fused_pair_fma_kernel<float, 1",
                              "fused_pair_fma_kernelIfLi1")),
               ("K7", ("ytab_",)),
               ("K1/K2/K5", ("chol_sample_packed", "chol_inv")),
               # the residual's parts; the gathers are also the float
               # table's and the expand's, the GEMM kernels also the hyper
               # draws' (a fused sweep without a residual shows how much)
               ("gather", ("gather_kernel", "indexSelect")),
               ("segment sum", ("indexFunc", "index_add", "segment_reduce",
                                "radixSort", "RadixSort", "searchsorted")),
               ("bmm and gemm", ("gemm", "gemv", "cutlass", "xmma", "sm90_")))


# ... and of an int8 pair sweep: K6 per focus mode, K7, the sampler
PAIR_SPLIT = (("K6 mode 0", ("pair_contract_kernel<0",
                             "pair_contract_kernelILi0")),
              ("K6 mode 1", ("pair_contract_kernel<1",
                             "pair_contract_kernelILi1")),
              ("K7", ("ytab_",)),
              ("K1/K2/K5", ("chol_sample_packed", "chol_inv")),
              ("gemm", ("gemm", "gemv", "cutlass", "xmma", "sm90_")))


# the sharded engine's collectives (NCCL's kernels)
NCCL_SPLIT = (("NCCL", ("nccl",)),)


def profile_split(eng, warm=2, sweeps=3, split=SPLIT):
    """Device milliseconds per sweep by part of the sweep (``split``, the
    rest under "rest"), the device idle share, the largest kernels and the
    largest of "rest" (ms per sweep, and launches in the trace, to show a
    lost event), from a ``torch.profiler`` trace of ``sweeps`` sweeps
    after ``warm``.  The engine's ``record_function`` ranges of the beta
    draw ("beta_e{i}"), where the trace carries them on the device's
    timeline, give ``beta_span_ms`` (their device span a sweep) and
    ``beta_busy_ms`` (the kernel time inside them); None without them."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    state = eng.init_state()
    for s in range(warm):
        state, _ = eng._sweep(state, s, 0.0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for s in range(warm, warm + sweeps):
            state, _ = eng._sweep(state, s, 0.0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, launches = {}, {}
    spans, kernels = [], []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        interval = (e.time_range.start, e.time_range.end)
        if (getattr(e, "is_user_annotation", False)
                or e.name.startswith("beta_e")):
            if e.name.startswith("beta_e"):
                spans.append(interval)
            continue
        kernels.append(interval)
        by_name[e.name] = (by_name.get(e.name, 0.0)
                           + e.time_range.elapsed_us() / 1e3)
        launches[e.name] = launches.get(e.name, 0) + 1
    beta_span = beta_busy = None
    if spans:
        beta_span = sum(b - a for a, b in spans) / 1e3 / sweeps
        beta_busy = sum(b - a for a, b in kernels
                        if any(s0 <= a < s1 for s0, s1 in spans)
                        ) / 1e3 / sweeps
    parts = {part: 0.0 for part, _ in split}
    parts["rest"] = 0.0
    rest = []
    for name, ms in by_name.items():
        part = next((p for p, frags in split
                     if any(f in name for f in frags)), "rest")
        parts[part] += ms / sweeps
        if part == "rest":
            rest.append((name, ms))
    split = parts
    device_ms = sum(split.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    rest.sort(key=lambda kv: -kv[1])
    return {"split_ms": split, "device_ms": device_ms,
            "wall_ms": wall_ms / sweeps,
            "idle": 1.0 - device_ms * sweeps / wall_ms,
            "beta_span_ms": beta_span, "beta_busy_ms": beta_busy,
            "top": [(n[:60], ms / sweeps, launches[n]) for n, ms in top[:8]],
            "rest_top": [(n[:200], ms / sweeps, launches[n])
                         for n, ms in rest[:10]]}


def check_float_pair_contrib(eng, seed=0):
    """The path's float pair contribution (``float_pair_contrib``, packed,
    float32 sums, alpha 2) on random partner factors, per focus mode:
    held to FLOAT_PAIR_TOL of the largest sum against float64 sums of the
    same store and the same table (made and rounded in the store dtype),
    and timed by CUDA events."""
    import torch
    from bayesiandatafusion_jl_tpu_torch.ops import dense_gram as dg
    prob = eng.problem
    pair, K = prob.stores[0], eng.config.num_latent
    iu, ju = prob.tri[:2]
    C = K * (K + 1) // 2
    g = torch.Generator(device="cuda").manual_seed(seed)
    alpha = torch.tensor(2.0, device="cuda")
    out = []
    for mode in range(2):
        partner = torch.randn((pair["shape"][1 - mode], K), generator=g,
                              device="cuda")
        P, b = dg.float_pair_contrib(pair, prob.tri, [partner], mode,
                                     alpha, torch.float32)
        UT = partner.to(pair["M"].dtype).mT
        err, big = 0.0, 0.0
        for got, T, A in ((P, UT[iu] * UT[ju], pair["M"]),
                          (b, UT, pair["W"])):
            A64 = A.double()
            want = 2.0 * (T.double() @ (A64.mT if mode == 0 else A64))
            del A64
            err = max(err, (got.double() - want).abs().max().item())
            big = max(big, want.abs().max().item())
            del want
        del P, b
        torch.cuda.empty_cache()
        ms = cuda_ms(lambda: dg.float_pair_contrib(
            pair, prob.tri, [partner], mode, alpha, torch.float32), 5)
        n0, n1 = pair["shape"]
        out.append({"mode": mode, "max_abs_err": err, "max_abs": big,
                    "ok": err <= FLOAT_PAIR_TOL * big, "ms": ms,
                    "tflops": 2 * n0 * n1 * (C + K) / ms * 1e-9})
    return out


def time_gathers(eng, K):
    """CUDA-event time of the gather step alone: one bfloat16
    ``index_select`` over all of a mode's partner indices, per mode."""
    import torch
    prob = eng.problem
    out = []
    for mode in range(2):
        idx = torch.cat([ba["part"][0].reshape(-1)
                         for ba in prob.layouts[f"r0m{mode}"]])
        partner = prob.entity_specs[prob.rel_specs[0].entity_ids[1 - mode]]
        U = torch.randn((partner.n, K), device="cuda").to(torch.bfloat16)
        ms = cuda_ms(lambda: U.index_select(0, idx), 10)
        out.append((idx.numel(), ms))
    return out


def same_seed_runs(eng, label, sweeps=3):
    """Two runs of ``sweeps`` sweeps from the same seed: their U must be
    equal bit for bit (every sum of a sweep adds in a fixed order: no
    scatter add with atomics on any path).  Prints the verdict and the
    largest difference."""
    import torch
    a = eng.run(num_sweeps=sweeps)["state"]["ent"]
    b = eng.run(num_sweeps=sweeps)["state"]["ent"]
    same = all(torch.equal(x["U"], y["U"]) for x, y in zip(a, b))
    diff = max(float((x["U"] - y["U"]).abs().max()) for x, y in zip(a, b))
    print(f"# same seed twice, {label}: U bitwise equal {same}, max |diff| "
          f"{diff:.3e}", flush=True)
    require(same, f"{label}: two runs of one seed differ by {diff:.3e}")


def equal_states(a, b):
    """Every leaf of two states equal, bit for bit."""
    import torch
    from bayesiandatafusion_jl_tpu_torch.models.engine import _leaves
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def run_driver_checks(eng, label, tally, timing=False):
    """The driver loop on ``eng``'s path (DRIVER_RUN), its files under a
    temporary directory removed afterwards:

    - run() with every option, its kernels counted (the path's kernels
      every sweep, no plain version): 10 sample files, 20 log lines, one
      trace with kernel events, the last checkpoint (sweep 20) equal to
      the run's state bit for bit;
    - the sweep-10 checkpoint (a run of 10 sweeps), ``load_state`` and
      ``run(sweep_offset=10)``: the run's state bit for bit (U, mu,
      Lambda, the prediction sums, alpha);
    - the same run in one-sweep windows: the same state bit for bit;
    - a window of 5 sweeps dispatched under ``torch.cuda`` sync debugging set
      to raise: nothing inside it waits for the device;
    - the seconds of ``save_state``, ``_save_sample`` and ``load_state``
      at this size; with ``timing``, run()'s ms/sweep at metrics_every 1
      and 20 (one-sweep windows, no log, in turns) and the effective
      TOP/s of ``flops_per_sweep``."""
    import torch
    base = eng.config
    K = base.num_latent
    tmp = tempfile.mkdtemp(prefix="chip_smoke_driver_")
    ck = os.path.join(tmp, "ck.npz")
    prefix = os.path.join(tmp, "sample")
    log = os.path.join(tmp, "log.jsonl")
    trace = os.path.join(tmp, "trace")
    total = DRIVER_RUN["burnin"] + DRIVER_RUN["psamples"]
    plain = dataclasses.replace(base, burnin=DRIVER_RUN["burnin"],
                                psamples=DRIVER_RUN["psamples"])
    try:
        eng.config = dataclasses.replace(
            base, **DRIVER_RUN, checkpoint_path=ck, output_prefix=prefix,
            log_file=log, trace_dir=trace)
        t0 = time.perf_counter()
        full, counts = counted(eng.run)
        run_s = time.perf_counter() - t0
        tally(counts)
        want = {k: 0 for k in counts}
        for tag, per_sweep in graph_kernels(eng.problem, K).items():
            want[tag] = per_sweep * total
        require(counts == want, f"driver loop, {label}: counts {counts} "
                                f"for {total} sweeps, want {want}")
        samples = sorted(glob.glob(prefix + "-sample*.npz"))
        with open(log) as f:
            lines = [json.loads(line) for line in f]
        traces = os.listdir(trace)
        with open(os.path.join(trace, traces[0])) as f:
            kernels = sum(e.get("cat") == "kernel"
                          for e in json.load(f)["traceEvents"])
        st, sweep = eng.load_state(ck)
        print(f"# driver loop, {label}: run() of {total} sweeps with every "
              f"option {run_s:.3f} s; counts {counts}; {len(samples)} "
              f"sample files ({os.path.getsize(samples[0]) / 1e6:.1f} MB "
              f"each), {len(lines)} log lines, trace {traces} "
              f"({os.path.getsize(os.path.join(trace, traces[0])) / 1e6:.1f}"
              f" MB, {kernels} kernel events), checkpoint at sweep {sweep} "
              f"({os.path.getsize(ck) / 1e6:.1f} MB)", flush=True)
        require(len(samples) == DRIVER_RUN["psamples"]
                and len(lines) == total
                and [ln["sweep"] for ln in lines] == list(range(1, total + 1))
                and len(traces) == 1 and kernels > 0 and sweep == total
                and equal_states(st, full["state"]),
                f"driver loop, {label}: artifacts")
        ck10 = os.path.join(tmp, "ck10.npz")
        eng.config = dataclasses.replace(plain, checkpoint_every=10,
                                         checkpoint_path=ck10)
        eng.run(num_sweeps=10)
        st10, sweep10 = eng.load_state(ck10)
        eng.config = plain
        resumed = eng.run(state=st10, sweep_offset=sweep10)
        eng.config = dataclasses.replace(plain, sweeps_per_dispatch=1)
        one = eng.run()
        same = (equal_states(resumed["state"], full["state"]),
                equal_states(one["state"], full["state"]))
        print(f"# driver loop, {label}: resumed from the sweep-{sweep10} "
              f"checkpoint, the state bitwise equal {same[0]}; one-sweep "
              f"windows bitwise equal {same[1]}", flush=True)
        require(sweep10 == 10 and all(same),
                f"driver loop, {label}: resume / windows differ")
        eng.config = plain
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eng._window(st10, base.seed, 10, DRIVER_RUN["sweeps_per_dispatch"])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        secs = {}
        for name, fn in (
                ("save_state", lambda: eng.save_state(ck, full["state"],
                                                      total)),
                ("_save_sample", lambda: eng._save_sample(prefix, 99,
                                                          full["state"])),
                ("load_state", lambda: eng.load_state(ck))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            secs[name] = time.perf_counter() - t0
        print(f"# driver loop, {label}: a window of "
              f"{DRIVER_RUN['sweeps_per_dispatch']} sweeps waited for the "
              f"device nowhere (sync debug mode 'error'); seconds at this "
              f"size {secs}", flush=True)
        if timing:
            ms = {1: [], 20: []}
            for every in (1, 20, 20, 1):
                eng.config = dataclasses.replace(
                    plain, metrics_every=every, sweeps_per_dispatch=1)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng.run(num_sweeps=DRIVER_TIMED)
                torch.cuda.synchronize()
                ms[every].append((time.perf_counter() - t0) * 1e3
                                 / DRIVER_TIMED)
            flops = eng.problem.flops_per_sweep()
            best = min(ms[20])
            print(f"# driver loop, {label}: run() ms/sweep over "
                  f"{DRIVER_TIMED} sweeps in one-sweep windows, in turns: "
                  f"metrics_every=1 {ms[1]}, metrics_every=20 {ms[20]}; "
                  f"the per-sweep read costs "
                  f"{min(ms[1]) - best:.3f} ms a sweep; flops_per_sweep "
                  f"{flops:.4e}, {flops / best * 1e-9:.2f} effective TOP/s "
                  f"at metrics_every=20", flush=True)
    finally:
        eng.config = base
        shutil.rmtree(tmp)


# bench.py's sharded configurations on the port's sharded engine
# (parallel/sharded.py): ``sharded1`` (bench.py:101-145: ML-10M, K = 32,
# the int8 pair, 40-sweep windows dispatched at once) and
# ``netflix_sharded1`` (bench.py:474-495: the Netflix-shaped ratings, the
# fused s8 store, one sweep a dispatch), each with its window, windows and
# the JAX chain's anchor
SHARDED_PATHS = {"sharded1": (40, 3, 40, PATHS[32][2]),
                 "netflix_sharded1": (NETFLIX_SWEEPS, NETFLIX_WINDOWS, 1,
                                      NETFLIX_ANCHOR)}
# one float32 sweep of the sharded engine from the single-device engine's
# state and randoms: U (original order) within this fraction of its
# largest entry.  The Normal-Wishart moments add in another order, which
# moves the first entity's draw by ~1e-7 of its scale; the next entity's
# partner table is quantized to int8 from it (K7), and a value that close
# to a rounding edge flips its code by one step, 1/127 of its column's
# scale: 6e-4 to 1.3e-3 on the int8 paths (CPU, float32), 4e-7 on
# the gather path.  With the hyper draws fixed (the same mu and Lambda in
# both engines) the sweep must agree to SHARDED_FIXED_TOL: the int8 sums
# are exact in both (0.0 on the CPU); only sums of float rows over
# ranks or ghost rows may add in another order.
SHARDED_SWEEP_TOL = 1e-2
SHARDED_FIXED_TOL = 1e-5


def sharded_group(world=1, rank=0, init=None):
    """Join an NCCL group of ``world`` ranks (a file rendezvous in a
    temporary folder unless ``init`` names one); returns the rendezvous."""
    from bayesiandatafusion_jl_tpu_torch.parallel.mesh import \
        initialize_distributed
    if init is None:
        init = "file://" + os.path.join(tempfile.mkdtemp(), "rendezvous")
    initialize_distributed(init, world, rank, device="cuda")
    return init


def sharded_config(name, **opts):
    """The MacauConfig of ``SHARDED_PATHS[name]``, as bench.py builds it."""
    from bayesiandatafusion_jl_tpu_torch.utils.config import MacauConfig
    sweeps, _, spd, _ = SHARDED_PATHS[name]
    return MacauConfig(num_latent=32, burnin=sweeps, psamples=0,
                       clamp=(1.0, 5.0), verbose=False, dtype="float32",
                       seed=42, **BENCH_GRAM, bucket_widths=BENCH_WIDTHS,
                       sweeps_per_dispatch=spd, **opts)


def collective_host_us(eng, reps=200):
    """Host microseconds a call of the sharded engine's collectives (its
    group, this card), issued back to back: an all-reduce of K floats, an
    all-gather of the largest entity's rows, and a launch of one small
    torch op for comparison."""
    import torch
    K = eng.config.num_latent
    n = max(m.n_loc for m in eng.problem.ent_meta)
    small = torch.zeros(K, device=eng.device)
    rows = torch.zeros((n, K), device=eng.device)
    out = {}
    for label, fn in (("all_reduce", lambda: eng._allreduce(small)),
                      ("all_gather", lambda: eng._allgather(rows)),
                      ("torch add", lambda: small + small)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        out[label] = round((time.perf_counter() - t0) * 1e6 / reps, 1)
        torch.cuda.synchronize()
    return out


def one_sweep_error(single, eng, fixed):
    """max |U - U_single| / max |U_single| per entity after one sweep of
    the sharded engine ``eng`` and of ``single`` from the same state and
    randoms (``eng.init_state()`` is ``single.init_state()`` sharded, its
    draws the same); ``fixed``: with both engines' Normal-Wishart draws
    replaced by mu = 0, Lambda = I.  A rank without ``single`` (None) takes
    part in the sharded sweep and returns None."""
    import torch
    from bayesiandatafusion_jl_tpu_torch.models import engine as em
    from bayesiandatafusion_jl_tpu_torch.parallel import sharded as shm
    saved = em.normal_wishart_update, shm.normal_wishart_from_moments

    def fixed_nw(*a, **kw):
        t = next(x for x in a if torch.is_tensor(x))
        K = t.shape[-1]
        return (t.new_zeros(K),
                torch.eye(K, dtype=t.dtype, device=t.device))
    if fixed:
        em.normal_wishart_update = shm.normal_wishart_from_moments = fixed_nw
    try:
        randoms = eng.draw(1)
        ss, _ = eng._sweep_with_randoms(eng.init_state(), randoms, 0.0)
        if single is not None:
            s1, _ = single._sweep_with_randoms(single.init_state(), randoms,
                                               0.0)
    finally:
        em.normal_wishart_update, shm.normal_wishart_from_moments = saved
    if single is None:
        return None
    got = eng.factors_original_order(ss)
    return [float((s1["ent"][ei]["U"].cpu() - torch.from_numpy(got[ei]))
                  .abs().max() / s1["ent"][ei]["U"].abs().max())
            for ei in range(len(got))]


def run_sharded_path(name, rd, single, single_ms, want, split):
    """One of bench.py's sharded configurations on this process's NCCL
    group: its plan (every mode on ``want``), the benchmark protocol with
    the kernels' counts set to 0 just before and read just after (the
    path's kernels each sweep, no plain version), rmse_sample in the JAX
    chain's band, peak memory and build seconds; one sweep from
    ``single``'s (the single-device engine on the same data) state and
    randoms within SHARDED_SWEEP_TOL of its U; at world size 1, two runs of
    one seed and a run resumed from a checkpoint equal bit for bit.
    Prints its ms/sweep beside ``single_ms`` (the single-device engine's
    on this data).  Returns (counts, median ms/sweep)."""
    import dataclasses

    import torch
    from bayesiandatafusion_jl_tpu_torch.parallel.sharded import \
        ShardedMacauEngine
    sweeps, repeats, _, anchor = SHARDED_PATHS[name]
    cfg = sharded_config(name)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = ShardedMacauEngine(rd, cfg, device="cuda")
    build_s = time.perf_counter() - t0
    prob = eng.problem
    print_plan(f"{name} (sharded, world {eng.world})", rd, prob.plan, want)
    stores = {k: tuple((v["V8"] if "V8" in v else v["M8"]).shape)
              for k, v in prob.stores.items()}
    print(f"# {name}: world {eng.world}, rank {eng.rank}; n_pad / n_loc "
          f"per entity {[(m.n_pad, m.n_loc) for m in prob.ent_meta]}; "
          f"heads {[m.n_head for m in prob.ent_meta]}; exchange blocks "
          f"{prob.exchange_blocks}; this rank's slabs {stores}; engine "
          f"build {build_s:.1f} s (plan {prob.plan.seconds:.1f} s)",
          flush=True)
    out, counts = counted(lambda: eng.benchmark(sweeps, repeats=repeats))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    wins = out["ms_per_sweep"]
    med = sorted(wins)[len(wins) // 2]
    total = sweeps * (repeats + 1)
    want_counts = {k: 0 for k in counts}
    for tag, per_sweep in graph_kernels(prob, 32,
                                        sharded_blocks(prob)).items():
        want_counts[tag] = per_sweep * total
    flops = prob.flops_per_sweep()
    print(f"# path {name}: ms/sweep per window {wins}, median {med:.3f} "
          f"(the single-device engine on this data {single_ms:.3f}); "
          f"rmse_sample@{sweeps} {out['rmse_at_sweeps']:.4f}; peak memory "
          f"{peak_gb:.2f} GB; counts {counts}; flops_per_sweep "
          f"{flops:.4e}, {flops / med * 1e-9:.2f} effective TOP/s",
          flush=True)
    require(counts == want_counts, f"{name}: counts {counts} for {total} "
                                   f"sweeps, want {want_counts}")
    require(abs(out["rmse_at_sweeps"] - anchor) <= RMSE_BAND,
            f"{name}: rmse_sample@{sweeps} {out['rmse_at_sweeps']} outside "
            f"{anchor} +- {RMSE_BAND}")
    prof = profile_split(eng, split=split)
    print_profile(f"{name} world {eng.world}", prof)
    host = collective_host_us(eng)
    print(f"# {name}: host microseconds a call at world {eng.world}, "
          f"{host}", flush=True)
    # one sweep from the single-device engine's state and randoms, as it is
    # and with the hyper draws fixed
    for fixed, tol in ((False, SHARDED_SWEEP_TOL), (True, SHARDED_FIXED_TOL)):
        err = one_sweep_error(single, eng, fixed)
        print(f"# {name}: one sweep from the single-device engine's state "
              f"and randoms{' with mu, Lambda fixed' if fixed else ''}, "
              f"max |U - U_single| / max |U_single| per entity {err} "
              f"(tolerance {tol})", flush=True)
        require(max(err) <= tol, f"{name}: one sweep off by {err}")
    if eng.world == 1:
        same_seed_runs(eng, f"{name} world 1")
        base = dataclasses.replace(cfg, burnin=2, psamples=2,
                                   sweeps_per_dispatch=1)
        eng.config = base
        full = eng.run()
        ck = os.path.join(tempfile.mkdtemp(), "ck.npz")
        eng.config = dataclasses.replace(base, checkpoint_every=2,
                                         checkpoint_path=ck)
        eng.run(num_sweeps=2)
        st, sweep = eng.load_state(ck)
        resumed = eng.run(state=st, sweep_offset=sweep)
        same = equal_states(resumed["state"], full["state"])
        print(f"# {name} world 1: resumed from its sweep-{sweep} checkpoint,"
              f" equal bit for bit {same}", flush=True)
        require(same, f"{name}: the resumed chain differs")
    del eng
    torch.cuda.empty_cache()
    return counts, med


def _sharded_rank(rank, world, init, name, result_dir):
    """One rank of a multi-card sharded run: its card, the NCCL group, the
    data made as the main script makes it, the benchmark protocol; rank 0
    writes its result."""
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    from bayesiandatafusion_jl_tpu_torch.models.data import RelationData
    from bayesiandatafusion_jl_tpu_torch.models.datasets import (
        load_movielens, netflix_synthetic)
    from bayesiandatafusion_jl_tpu_torch.parallel.sharded import \
        ShardedMacauEngine
    sharded_group(world, rank, init)
    df = (load_movielens("10m", seed=0) if name == "sharded1"
          else netflix_synthetic())
    rd = RelationData.from_indexed_df(df, relation_name="ratings")
    rd.assign_to_test(0, min(100_000, df.nnz // 10), seed=7)
    sweeps, repeats, _, anchor = SHARDED_PATHS[name]
    t0 = time.perf_counter()
    eng = ShardedMacauEngine(rd, sharded_config(name), device="cuda")
    build_s = time.perf_counter() - t0
    out, counts = counted(lambda: eng.benchmark(sweeps, repeats=repeats))
    want = {k: 0 for k in counts}
    for tag, per_sweep in graph_kernels(
            eng.problem, 32, sharded_blocks(eng.problem)).items():
        want[tag] = per_sweep * sweeps * (repeats + 1)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # one sweep against the single-device engine, built on rank 0's card
    single = None
    if rank == 0:
        from bayesiandatafusion_jl_tpu_torch.models.engine import MacauEngine
        single = MacauEngine(rd, eng.config, device="cuda")
    err = {fixed: one_sweep_error(single, eng, fixed)
           for fixed in (False, True)}
    if rank == 0:
        with open(os.path.join(result_dir, f"{name}.json"), "w") as f:
            json.dump({"ms": out["ms_per_sweep"],
                       "rmse": out["rmse_at_sweeps"], "counts": counts,
                       "want": want, "build_s": build_s, "peak_gb": peak_gb,
                       "exchange_blocks": eng.problem.exchange_blocks,
                       "n_loc": [m.n_loc for m in eng.problem.ent_meta],
                       "err": err[False], "err_fixed": err[True]}, f)
    import torch.distributed as dist
    dist.destroy_process_group()


def run_sharded_world(name, world, tally):
    """``name`` at ``world`` ranks, one process a card (spawned), on NCCL:
    the benchmark protocol, the kernels' counts, the anchor and one sweep
    against the single-device engine (``one_sweep_error``)."""
    import torch.multiprocessing as mp
    result_dir = tempfile.mkdtemp()
    init = "file://" + os.path.join(result_dir, "rendezvous")
    mp.start_processes(_sharded_rank, args=(world, init, name, result_dir),
                       nprocs=world, join=True, start_method="spawn")
    with open(os.path.join(result_dir, f"{name}.json")) as f:
        r = json.load(f)
    med = sorted(r["ms"])[len(r["ms"]) // 2]
    print(f"# path {name} at world {world} (one process a card): ms/sweep "
          f"per window {r['ms']}, median {med:.3f}; rmse_sample "
          f"{r['rmse']:.4f}; rank 0's peak memory {r['peak_gb']:.2f} GB, "
          f"build {r['build_s']:.1f} s, rows a rank {r['n_loc']}, exchange "
          f"blocks {r['exchange_blocks']}; rank 0's counts {r['counts']}; "
          f"one sweep against the single-device engine {r['err']} (hyper "
          f"draws fixed {r['err_fixed']})", flush=True)
    require(max(r["err"]) <= SHARDED_SWEEP_TOL
            and max(r["err_fixed"]) <= SHARDED_FIXED_TOL,
            f"{name} world {world}: one sweep off by {r['err']}, "
            f"{r['err_fixed']}")
    require(r["counts"] == r["want"], f"{name} world {world}: counts "
                                      f"{r['counts']}, want {r['want']}")
    require(abs(r["rmse"] - SHARDED_PATHS[name][3]) <= RMSE_BAND,
            f"{name} world {world}: rmse_sample {r['rmse']}")
    tally(r["counts"])
    return med


def run_sharded_worlds(name, tally):
    """``name`` at world size 2 where there are two cards or more (the
    world-1 run is in-process), else a line saying why not."""
    import torch
    n = torch.cuda.device_count()
    if n < 2:
        print(f"# {name} at world 2: not run, this host has {n} card "
              f"(one process a card needs two)", flush=True)
        return None
    return run_sharded_world(name, 2, tally)


def tensor_pair_views(pair):
    """An int8 store of arity 3 or more as K6 reads it: (pair, focus) of
    its 2-D view [(a, ...), b] (focus 0: mode a's first step, contracting
    b) and of its view [a, (..., b)] (focus 1: every other mode,
    contracting a), each with the extents K6 writes (the true a rows;
    every column of the second)."""
    M8, W8 = pair["M8"], pair["W8"]
    na = pair["shape"][pair["order"][0]]
    nb = pair["shape"][pair["order"][-1]]
    mid = math.prod(M8.shape[1:-1])
    return [({"M8": M8.view(-1, M8.shape[-1]), "W8": W8.view(-1, W8.shape[-1]),
              "shape": (na * mid, nb)}, 0),
            ({"M8": M8.view(M8.shape[0], -1), "W8": W8.view(W8.shape[0], -1),
              "shape": (na, mid * M8.shape[-1])}, 1)]


def tensor4_synthetic(seed=12):
    """``tensor``'s relation (bench.py:194-223) with a fourth mode:
    TENSOR4_SHAPE, TENSOR4_NNZ distinct cells drawn uniformly (sorted),
    values TENSOR4_RANK * sum_k of the four factors' products + 0.4 N(0, 1)
    from Gaussian factors of scale 1 / sqrt(rank) (the signal's spread is
    tensor's, 1 / sqrt(rank)), made from ``seed`` a chunk of observations
    at a time."""
    import numpy as np
    from bayesiandatafusion_jl_tpu_torch.models.data import IndexedDF
    shape, nnz, r = TENSOR4_SHAPE, TENSOR4_NNZ, TENSOR4_RANK
    rng = np.random.default_rng(seed)
    key = np.unique(rng.integers(0, math.prod(shape), int(nnz * 1.1),
                                 dtype=np.int64))
    key = np.sort(key[rng.permutation(key.size)[:nnz]])
    idx = np.stack(np.unravel_index(key, shape), 1).astype(np.int32)
    del key
    Us = [rng.standard_normal((n, r)) / np.sqrt(r) for n in shape]
    vals = np.empty(nnz)
    for a in range(0, nnz, 1 << 20):
        b = min(a + (1 << 20), nnz)
        prod = Us[0][idx[a:b, 0]]
        for d in range(1, 4):
            prod = prod * Us[d][idx[a:b, d]]
        vals[a:b] = r * prod.sum(axis=1)
    vals += 0.4 * rng.standard_normal(nnz)
    return IndexedDF(idx, vals, shape)


def run_graph_paths(tally):
    """The graph paths, each built as the JAX bench builds it, each
    printing its plan: ``tensor`` (int8 pair at arity 3: K6 for each
    mode's first step, K7 for each largest partner's table, K1),
    ``fusion`` (three int8 pairs on one compound entity: K6 and K7 six
    times a sweep, K1), the same graph with every alpha sampled (one
    window), ``tensor_big`` (its bench options as written: the planner
    sends every mode to the gather path at arity 3, K3) and K9 at
    tensor_big's shape, which no engine path runs (as in JAX): held
    bitwise against its plain version and timed beside ``index_select``;
    then ``tensor4`` (tensor4_synthetic: the int8 pair at arity 4, K6 for
    each mode's first step on the store read as a matrix, the other
    partners in one einsum, and the gather path on the same data, their
    rmse_avg within RMSE_BAND).  K6 is held against its plain version on
    the stores of ``tensor``, ``fusion`` and ``tensor4``.  Returns K9's
    checks by label."""
    import torch
    from bayesiandatafusion_jl_tpu_torch.models.data import RelationData
    from bayesiandatafusion_jl_tpu_torch.models.datasets import (
        fusion_synthetic, tensor_big_synthetic, tensor_synthetic)
    from bayesiandatafusion_jl_tpu_torch.models.engine import MacauEngine
    from bayesiandatafusion_jl_tpu_torch.utils.config import MacauConfig
    clock = [time.perf_counter()]

    def phase_done(name):
        now = time.perf_counter()
        print(f"# phase {name}: {now - clock[0]:.1f} s", flush=True)
        clock[0] = now

    # -- tensor: 30,000 x 2,000 x 16, 5M cells, the int8 pair at arity 3 --
    t0 = time.perf_counter()
    rd = RelationData.from_indexed_df(tensor_synthetic(),
                                      relation_name="tensor")
    rd.assign_to_test(0, 100_000, seed=7)
    print(f"# tensor data: {time.perf_counter() - t0:.1f} s with the test "
          f"split", flush=True)
    eng, counts, _ = run_path(rd, 32, *TENSOR_RUN, None, TENSOR_ANCHOR,
                              name="tensor", clamp=None, graph=True,
                              dense_int8=True, **GRAPH_OPTS)
    tally(counts)
    print_plan("tensor, bench.py:194-223", rd, eng.problem.plan, "pair int8")
    pair = eng.problem.stores[0]
    require(tuple(pair["M8"].shape) == (30_000, 16, 2_000),
            f"tensor: store {tuple(pair['M8'].shape)}")
    print_profile("tensor K=32", profile_split(eng, split=PAIR_SPLIT))
    del eng
    torch.cuda.empty_cache()
    for view, focus in tensor_pair_views(pair):
        r = check_pair_contract(view, 32, focus)
        print_pair_check("tensor view", r)
        require(r["ok"] and r["library_equal"],
                f"K6 disagrees with its plain version or the library: {r}")
        torch.cuda.empty_cache()
    del pair, rd
    phase_done("tensor path")

    # -- fusion: 50,000 compounds x (500, 3,000, 800), three int8 pairs ----
    t0 = time.perf_counter()
    rd = fusion_synthetic()
    rd.assign_to_test("ic50", 100_000, seed=7)
    print(f"# fusion data: {time.perf_counter() - t0:.1f} s with the test "
          f"split", flush=True)
    eng, counts, _ = run_path(rd, 32, *FUSION_RUN, None, FUSION_ANCHOR,
                              name="fusion", clamp=None, graph=True,
                              dense_int8=True, **GRAPH_OPTS)
    tally(counts)
    print_plan("fusion, bench.py:287-326", rd, eng.problem.plan, "pair int8")
    print_profile("fusion K=32", profile_split(eng, split=PAIR_SPLIT))
    stores = eng.problem.stores
    del eng
    torch.cuda.empty_cache()
    for pair in stores:
        for focus in (0, 1):
            r = check_pair_contract(pair, 32, focus, timing=False)
            print_pair_check("fusion pair", r)
            require(r["ok"], f"K6 disagrees with its plain version: {r}")
    del stores, pair
    torch.cuda.empty_cache()
    # every alpha sampled: one window of run(), the alphas read each sweep
    for rel in rd.relations:
        rd.set_precision(rel, 5.0, sample=True)
    sweeps = FUSION_RUN[0]
    cfg = MacauConfig(num_latent=32, burnin=sweeps, psamples=0, clamp=None,
                      verbose=False, dtype="float32", seed=42,
                      dense_int8=True, **GRAPH_OPTS)
    eng = MacauEngine(rd, cfg, device="cuda")
    t0 = time.perf_counter()
    res, counts = counted(lambda: eng.run(num_sweeps=sweeps))
    run_s = time.perf_counter() - t0
    tally(counts)
    want = {k: 0 for k in counts}
    for tag, per_sweep in graph_kernels(eng.problem, 32).items():
        want[tag] = per_sweep * sweeps
    require(counts == want, f"fusion, alpha sampled: counts {counts}, "
                            f"want {want}")
    alphas = [[h[f"r{ri}.alpha"] for h in res["history"]]
              for ri in range(len(rd.relations))]
    print(f"# fusion, every alpha sampled: {sweeps} sweeps in {run_s:.1f} s "
          f"(run(), a device read each sweep); alpha per relation, sweeps "
          f"1 and {sweeps}: {[(a[0], a[-1]) for a in alphas]}; rmse_sample "
          f"{res['history'][-1]['r0.rmse_sample']:.4f}; counts {counts}",
          flush=True)
    require(all(math.isfinite(x) and x > 0 for a in alphas for x in a)
            and all(a[0] != a[-1] and a[-1] != 5.0 for a in alphas),
            f"fusion: the sampled alphas did not move or are not positive: "
            f"{alphas}")
    del eng, rd, res
    torch.cuda.empty_cache()
    phase_done("fusion paths")

    # -- tensor_big: 200,000 x 20,000 x 8, 30M cells, as bench.py writes it:
    # the planner sends every mode to the gather path ----------------------
    t0 = time.perf_counter()
    rd = RelationData.from_indexed_df(tensor_big_synthetic(),
                                      relation_name="tensor")
    rd.assign_to_test(0, 100_000, seed=7)
    print(f"# tensor_big data: {time.perf_counter() - t0:.1f} s with the "
          f"test split", flush=True)
    eng, counts, _ = run_path(rd, 32, *TENSOR_BIG_RUN, TENSOR_BIG_ANCHOR,
                              None, name="tensor_big", clamp=None,
                              graph=True, dense_int8=True, **GRAPH_OPTS)
    tally(counts)
    print_plan("tensor_big, bench.py:226-285", rd, eng.problem.plan,
               "gather")
    print_profile("tensor_big K=32", profile_split(eng, warm=1, sweeps=2))
    del eng
    torch.cuda.empty_cache()
    phase_done("tensor_big path")

    # -- K9 at tensor_big's shape: no engine path runs it (as in JAX) ------
    part = rd.relations[0].data.idx[:, 0]
    n_table = rd.relations[0].data.shape[0]
    checks = {}
    for dtype in ("bfloat16", "float32"):
        r = check_windowed_expand(part, n_table, 32, dtype)
        print_expand_check("tensor_big", r)
        require(r["ok"], f"K9 disagrees with its plain version: {r}")
        checks[("tensor_big", dtype)] = r
        torch.cuda.empty_cache()
    del part, rd
    phase_done("K9 at tensor_big")

    # -- tensor4: the int8 pair at arity 4 against the gather path ---------
    t0 = time.perf_counter()
    rd = RelationData.from_indexed_df(tensor4_synthetic(),
                                      relation_name="tensor4")
    rd.assign_to_test(0, 100_000, seed=7)
    print(f"# tensor4 data: {time.perf_counter() - t0:.1f} s with the test "
          f"split", flush=True)
    eng, counts, pair_out = run_path(rd, 32, *TENSOR_RUN, None, None,
                                     name="tensor4", clamp=None, graph=True,
                                     dense_gram=True, dense_int8=True,
                                     **GRAPH_OPTS)
    tally(counts)
    pair = eng.problem.stores[0]
    require(pair["order"] == (0, 2, 3, 1)
            and tuple(pair["M8"].shape) == (30_000, 16, 4, 2_000),
            f"tensor4: store {tuple(pair['M8'].shape)} order "
            f"{pair['order']}")
    print_profile("tensor4 int8 pair K=32",
                  profile_split(eng, split=PAIR_SPLIT))
    del eng
    torch.cuda.empty_cache()
    for view, focus in tensor_pair_views(pair):
        r = check_pair_contract(view, 32, focus, timing=False)
        print_pair_check("tensor4 view", r)
        require(r["ok"], f"K6 disagrees with its plain version: {r}")
        torch.cuda.empty_cache()
    del pair
    eng, counts, gather_out = run_path(rd, 32, *TENSOR_RUN, None, None,
                                       name="tensor4", clamp=None,
                                       graph=True, dense_gram=False,
                                       **GRAPH_OPTS)
    tally(counts)
    rmse = [o["metrics"]["r0.rmse_avg"] for o in (pair_out, gather_out)]
    print(f"# tensor4: rmse_avg int8 pair {rmse[0]:.4f}, gather path "
          f"{rmse[1]:.4f}", flush=True)
    require(abs(rmse[0] - rmse[1]) <= RMSE_BAND,
            f"tensor4: the int8 pair's rmse_avg {rmse[0]} outside the "
            f"gather path's {rmse[1]} +- {RMSE_BAND}")
    del eng, rd
    torch.cuda.empty_cache()
    phase_done("tensor4 paths")
    return checks


@contextlib.contextmanager
def beta_draws(eng, timed=False):
    """Within the block, each call of ``eng._sample_beta`` appends to the
    list yielded its CG diagnostics (iterations, exit residual; None off
    the CG path) and, with ``timed``, CUDA events around it."""
    import torch
    draws = []
    orig = eng._sample_beta

    def wrapped(*a, **kw):
        ev = None
        if timed:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        out = orig(*a, **kw)
        if timed:
            ev[1].record()
        draws.append((out[2], ev))
        return out
    eng._sample_beta = wrapped
    try:
        yield draws
    finally:
        del eng._sample_beta


def beta_stream_split(eng, warm=2, sweeps=5):
    """The beta draw's share of a sweep on the stream: CUDA events around
    ``MacauEngine._sample_beta`` and around each sweep (``sweeps`` sweeps
    after ``warm``), in ms a sweep, with the wall time a sweep and, on the
    CG path, each draw's iterations and exit-time residual.  The stream
    time of the draw includes the device's waits for the host (CG's one
    read an iteration)."""
    import torch
    state = eng.init_state()
    for s in range(warm):
        state, _ = eng._sweep(state, s, 0.0)
    with beta_draws(eng, timed=True) as draws:
        torch.cuda.synchronize()
        s0 = torch.cuda.Event(enable_timing=True)
        s1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        s0.record()
        for s in range(warm, warm + sweeps):
            state, _ = eng._sweep(state, s, 0.0)
        s1.record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / sweeps
    diags = [d for d, _ in draws if d is not None]
    return {"beta_ms": sum(a.elapsed_time(b) for _, (a, b) in draws)
            / sweeps,
            "sweep_ms": s0.elapsed_time(s1) / sweeps, "wall_ms": wall,
            "cg_iters": [int(d[0]) for d in diags],
            "cg_resid": [float(d[1]) for d in diags]}


def dense_features(F):
    """The side features F as the dense float32 [N, F] X on the card."""
    import numpy as np
    import torch
    X = torch.zeros(F.shape, dtype=torch.float32, device="cuda")
    X.index_put_(tuple(torch.from_numpy(a.astype(np.int64)).cuda()
                       for a in (F.rows, F.cols)),
                 torch.from_numpy(F.values().astype(np.float32)).cuda(),
                 accumulate=True)
    return X


def feat_pass_ms(F, reps=20):
    """{"dense": (X @ V, X' @ U) device ms on the dense float32 X,
    "sparse": the same on the bucketed matvec} of side features F, K = 32,
    CUDA events: the two operands ``use_dense_feat`` chooses between."""
    import numpy as np
    import torch
    from bayesiandatafusion_jl_tpu_torch.ops.spmv import (
        bucketed_spmm, build_bucketed_matvec)
    n, f = F.shape
    g = torch.Generator(device="cuda").manual_seed(0)
    V = torch.randn((f, 32), generator=g, device="cuda")
    U = torch.randn((n, 32), generator=g, device="cuda")
    X = dense_features(F)
    dense = (cuda_ms(lambda: X @ V, reps), cuda_ms(lambda: X.mT @ U, reps))
    del X
    mv = build_bucketed_matvec(F.rows, F.cols, F.shape, vals=F.vals,
                               dtype=np.float32, device="cuda")
    sparse = (cuda_ms(lambda: bucketed_spmm(mv["fwd"], n, V), reps),
              cuda_ms(lambda: bucketed_spmm(mv["t"], f, U), reps))
    torch.cuda.empty_cache()
    return {"dense": dense, "sparse": sparse}


def print_feat_readout(feat_ms):
    """``use_dense_feat``'s constants (ops/dense_gram.py) as this run
    measures them, beside the module's: the rate that makes n f itemsize /
    rate one pass of the dense float32 X (itemsize the JAX operand's, which
    the rule is given: ``feat_itemsize``) and a bucketed pass's seconds per
    stored feature, each the mean of the X @ V and X' @ U passes on
    ChEMBL's features (``feat_pass_ms``: both operands built and timed,
    whichever the paths use)."""
    from bayesiandatafusion_jl_tpu_torch.ops import dense_gram as dg
    n, f, nnz, itemsize = feat_ms["shape"]
    dense_s = sum(feat_ms["dense"]) / 2e3
    sparse_s = sum(feat_ms["sparse"]) / 2e3
    got = {"_FEAT_HBM_BPS": n * f * itemsize / dense_s,
           "_SPMM_S_PER_NNZ": sparse_s / nnz}
    print(f"# use_dense_feat constants measured in this run (ops/"
          f"dense_gram.py's in parentheses): " + "; ".join(
              f"{k} {v:.4g} ({getattr(dg, k):.4g})" for k, v in got.items())
          + f"; dense X passes {feat_ms['dense']} ms, bucketed passes "
          f"{feat_ms['sparse']} ms at {n} x {f}, {nnz} stored, itemsize "
          f"{itemsize}", flush=True)


def dual_residual(eng, X, sweeps=3):
    """The dual solve on the card after ``sweeps`` sweeps of the chain: the
    next sweep's right-hand side (``_beta_rhs``) solved by
    ``dual_solve_g`` with the engine's refinement and without, each
    solution's true relative residual ||rhs - (X'X + lam I) beta|| /
    ||rhs|| (largest over the K columns) and ||uhat - X beta|| / ||X
    beta||, both computed in float64 on the card from the float32 X (the
    dense features, whichever operand the engine's draw reads)."""
    import torch
    from bayesiandatafusion_jl_tpu_torch.ops.dual import dual_solve_g
    state = eng.init_state()
    for s in range(sweeps):
        state, _ = eng._sweep(state, s, 0.0)
    ent = state["ent"][0]
    feat = eng.problem.feat["e0"]
    randoms = eng.draw(sweeps + 1)
    rhs = eng._beta_rhs(0, ent, ent["U"], randoms["e0.beta_e1"],
                        randoms["e0.beta_e2"])
    lam = ent["lambda_beta"]
    X64, rhs64, lam64 = X.double(), rhs.double(), lam.double()
    out = {"lambda_beta": float(lam)}
    for refine in sorted({eng.config.dual_refine, 0}):
        beta, z = dual_solve_g(feat["dual_Q"], feat["dual_d"],
                               feat["dual_G"], lam, rhs,
                               lambda v: X @ v, lambda v: X.mT @ v, refine)
        b = beta.double()
        xb = X64 @ b
        r = rhs64 - (X64.mT @ xb + lam64 * b)
        out[refine] = {
            "resid": float((r.norm(dim=0) / rhs64.norm(dim=0)).max()),
            "uhat_err": float((z.double() - xb).norm() / xb.norm())}
    del X64, xb, r
    torch.cuda.empty_cache()
    return out


def run_chembl_paths(tally):
    """The ChEMBL Macau paths (bench.py:165-189 on the port): the 15,000 x
    346 IC50 relation (300,000 activities, class_cut log10(200)) with
    15,000 x 32,000 binary fingerprint features on the compounds, K = 32,
    the int8 pair (K6 and K7 for both modes, K1 for both entities):

    - ``chembl``: the dual solve (float32 eigendecomposition of XX' on the
      card, one refinement), the bench's protocol; rmse_avg and AUC in the
      JAX chain's bands; the dual residual below DUAL_RESID_MAX; K6 held
      against its plain version on the path's store;
    - ``chembl_cg``: blocked CG with the Nystrom preconditioner (rank 1024),
      the bench's protocol; the exit residual below CG_RESID_MAX and the
      bands;
    - ``chembl_cg_sparse``: Jacobi CG on the bucketed matvec
      (``dense_gram=False``, which also puts the relation on the gather
      path: K3 for both entities, no K6 or K7), a shorter window;
    - ``chembl_ff``: 4,096 features, so the FF path resolves itself, a
      shorter window.

    Each prints its build (G, eigh, Nystrom, X'X seconds), ms a sweep,
    peak memory and the kernels' launches a sweep, and the beta draw's
    share of the sweep on the device."""
    import torch
    from bayesiandatafusion_jl_tpu_torch.models.datasets import \
        synthetic_chembl
    from bayesiandatafusion_jl_tpu_torch.ops import dense_gram as dg
    clock = [time.perf_counter()]

    def phase_done(name):
        now = time.perf_counter()
        print(f"# phase {name}: {now - clock[0]:.1f} s", flush=True)
        clock[0] = now

    def report(eng, counts, out, name, run):
        prob = eng.problem
        es = prob.entity_specs[0]
        n_sweeps = run[0] * (run[1] + 1)
        per = {k: v / n_sweeps for k, v in counts.items() if v}
        m = out["metrics"]
        X = prob.feat["e0"].get("dense_X")
        operand = ("bucketed matvec" if X is None else
                   f"dense X {tuple(X.shape)} {X.dtype}")
        print(f"# {name}: solver {es.solver}, F = {es.num_features} "
              f"({es.feat_nnz} stored), operand {operand}; "
              f"build seconds {prob.feat_seconds['e0']} (engine "
              f"{prob.build_seconds:.1f} s); kernel launches a sweep "
              f"{per}; rmse_avg {m['r0.rmse_avg']:.4f}, AUC "
              f"{m['r0.auc']:.4f}, |beta| {m['e0.betanorm']:.3f}, "
              f"lambda_beta {m['e0.lambda_beta']:.4f}"
              + (f", cg_iters {m['e0.cg_iters']:.0f}, cg_resid "
                 f"{m['e0.cg_resid']:.3e}" if "e0.cg_iters" in m else ""),
              flush=True)
        require(all(math.isfinite(v) for v in m.values()),
                f"{name}: non-finite metrics {m}")
        return m

    def split(eng, name, prof_split, sweeps=3):
        with beta_draws(eng) as draws:
            prof = profile_split(eng, sweeps=sweeps, split=prof_split)
        print_profile(name, prof)
        if prof["beta_span_ms"] is None:
            print(f"# profile {name}: the beta draw's ranges are not on the "
                  f"device timeline of this trace: split not measured by "
                  f"the profiler", flush=True)
        it = [int(d[0]) for d, _ in draws[-sweeps:] if d is not None]
        if it and prof["beta_span_ms"] is not None:
            # the device's time inside the draw's ranges that no kernel
            # covers: it waits for the host, which reads CG's test once
            # an iteration (under the profiler, which slows the host)
            wait = prof["beta_span_ms"] - prof["beta_busy_ms"]
            print(f"# profile {name}: CG iterations {it} in the profiled "
                  f"sweeps; the device idle inside the draw {wait:.3f} ms "
                  f"a sweep, {wait * len(it) / max(sum(it), 1):.4f} ms an "
                  f"iteration (its host reads)", flush=True)
        st = beta_stream_split(eng)
        line = (f"# {name}: beta draw {st['beta_ms']:.3f} ms of "
                f"{st['sweep_ms']:.3f} ms a sweep on the stream (CUDA "
                f"events), the rest {st['sweep_ms'] - st['beta_ms']:.3f} "
                f"ms; wall {st['wall_ms']:.3f} ms a sweep")
        it = st["cg_iters"]
        if it:
            line += (f"; CG iterations {it} (residuals "
                     f"{[f'{r:.2e}' for r in st['cg_resid']]}), "
                     f"{st['beta_ms'] * len(it) / max(sum(it), 1):.4f} ms "
                     f"of the draw an iteration")
        print(line, flush=True)

    t0 = time.perf_counter()
    rd = synthetic_chembl(**CHEMBL_DATA)
    rd.assign_to_test(0, CHEMBL_TEST, seed=7)
    F = rd.entities[0].F
    print(f"# chembl data: {time.perf_counter() - t0:.1f} s with the test "
          f"split ({rd.relations[0].data.nnz} training activities, features "
          f"{F.shape} with {F.nnz} stored)", flush=True)
    feat_ms = feat_pass_ms(F)
    feat_ms["shape"] = (*F.shape, F.nnz, dg.feat_itemsize(
        F.is_binary, CHEMBL_OPTS["gram_dtype"], "float32"))
    dense_x = dg.use_dense_feat(*feat_ms["shape"], None)

    # -- chembl: the dual solve ------------------------------------------
    eng, counts, out = run_path(rd, 32, *CHEMBL_RUN, None, CHEMBL_RMSE_ANCHOR,
                                name="chembl", clamp=None, graph=True,
                                **CHEMBL_OPTS)
    tally(counts)
    print_plan("chembl, bench.py:165-189", rd, eng.problem.plan, "pair int8")
    m = report(eng, counts, out, "chembl", CHEMBL_RUN)
    require(eng.problem.entity_specs[0].solver == "dual"
            and ("dense_X" in eng.problem.feat["e0"]) == dense_x,
            f"chembl: not the dual solve on the operand use_dense_feat "
            f"picks ({'dense X' if dense_x else 'bucketed matvec'})")
    require(abs(m["r0.auc"] - CHEMBL_AUC_ANCHOR) <= CHEMBL_AUC_BAND,
            f"chembl: AUC {m['r0.auc']} outside {CHEMBL_AUC_ANCHOR} +- "
            f"{CHEMBL_AUC_BAND}")
    res = dual_residual(eng, dense_features(F))
    print(f"# chembl dual solve (lambda_beta {res['lambda_beta']:.4f}): "
          f"true relative residual {res[eng.config.dual_refine]['resid']:.3e}"
          f" with {eng.config.dual_refine} refinement, {res[0]['resid']:.3e}"
          f" without; ||uhat - X beta|| / ||X beta|| "
          f"{res[eng.config.dual_refine]['uhat_err']:.3e}", flush=True)
    require(res[eng.config.dual_refine]["resid"] < DUAL_RESID_MAX,
            f"chembl: dual residual {res} over {DUAL_RESID_MAX}")
    split(eng, "chembl dual K=32", PAIR_SPLIT)
    a = eng.run(num_sweeps=3)["state"]["ent"][0]
    b = eng.run(num_sweeps=3)["state"]["ent"][0]
    same = (torch.equal(a["U"], b["U"]), torch.equal(a["beta"], b["beta"]))
    print(f"# same seed twice, chembl: U bitwise equal {same[0]}, beta "
          f"bitwise equal {same[1]}", flush=True)
    require(all(same), "chembl: two runs of one seed differ")
    pair = eng.problem.stores[0]
    del eng, a, b
    torch.cuda.empty_cache()
    for focus in (0, 1):
        r = check_pair_contract(pair, 32, focus, timing=False)
        print_pair_check("chembl", r)
        require(r["ok"], f"K6 disagrees with its plain version: {r}")
    del pair
    torch.cuda.empty_cache()
    phase_done("chembl dual path")

    # -- chembl_cg: Nystrom-preconditioned CG ----------------------------
    eng, counts, out = run_path(rd, 32, *CHEMBL_RUN, None, CHEMBL_RMSE_ANCHOR,
                                name="chembl_cg", clamp=None, graph=True,
                                **CHEMBL_OPTS, beta_solver="cg")
    tally(counts)
    m = report(eng, counts, out, "chembl_cg", CHEMBL_RUN)
    feat = eng.problem.feat["e0"]
    require(eng.problem.entity_specs[0].solver == "cg"
            and tuple(feat["nys_U"].shape) == (32_000, 1_024),
            "chembl_cg: not CG with the rank-1024 Nystrom preconditioner")
    require(m["e0.cg_resid"] < CG_RESID_MAX,
            f"chembl_cg: CG residual {m['e0.cg_resid']}")
    require(abs(m["r0.auc"] - CHEMBL_AUC_ANCHOR) <= CHEMBL_AUC_BAND,
            f"chembl_cg: AUC {m['r0.auc']} outside {CHEMBL_AUC_ANCHOR} +- "
            f"{CHEMBL_AUC_BAND}")
    split(eng, "chembl_cg K=32", PAIR_SPLIT)
    del eng, feat
    torch.cuda.empty_cache()
    phase_done("chembl_cg path")

    # -- chembl_cg_sparse: Jacobi CG on the bucketed matvec ---------------
    eng, counts, out = run_path(
        rd, 32, *CHEMBL_SHORT_RUN, None, None, name="chembl_cg_sparse",
        clamp=None, graph=True,
        **{**CHEMBL_OPTS, "beta_solver": "cg", "cg_nystrom_rank": 0,
           "dense_gram": False})
    tally(counts)
    m = report(eng, counts, out, "chembl_cg_sparse", CHEMBL_SHORT_RUN)
    require("mv" in eng.problem.feat["e0"]
            and "nys_U" not in eng.problem.feat["e0"],
            "chembl_cg_sparse: not Jacobi CG on the bucketed matvec")
    split(eng, "chembl_cg_sparse K=32", SPLIT)
    same_seed_runs(eng, "chembl_cg_sparse K=32")
    del eng
    torch.cuda.empty_cache()
    phase_done("chembl_cg_sparse path")

    # -- chembl_ff: 4,096 features, the X'X path ---------------------------
    t0 = time.perf_counter()
    rd = synthetic_chembl(**{**CHEMBL_DATA,
                             "n_features": CHEMBL_FF_FEATURES})
    rd.assign_to_test(0, CHEMBL_TEST, seed=7)
    print(f"# chembl_ff data: {time.perf_counter() - t0:.1f} s with the "
          f"test split", flush=True)
    opts = {k: v for k, v in CHEMBL_OPTS.items() if k != "use_ff"}
    eng, counts, out = run_path(rd, 32, *CHEMBL_SHORT_RUN, None, None,
                                name="chembl_ff", clamp=None, graph=True,
                                **opts)
    tally(counts)
    report(eng, counts, out, "chembl_ff", CHEMBL_SHORT_RUN)
    require(eng.problem.entity_specs[0].solver == "ff",
            "chembl_ff: the FF path did not resolve itself")
    split(eng, "chembl_ff K=32", PAIR_SPLIT)
    del eng, rd
    torch.cuda.empty_cache()
    phase_done("chembl_ff path")
    return feat_ms


def write_ratings(path, users, movies, vals, stamps, sep, chunk=1_000_000):
    """Write one line ``user<sep>movie<sep>rating<sep>timestamp`` a rating,
    as MovieLens files hold them (ids and timestamps non-negative integers,
    ratings on the half-star grid written "3" or "3.5"), formatted by
    numpy: ``chunk`` lines at a time, each field's digits a padded column
    block, the padding masked out."""
    import numpy as np
    h = np.rint(np.asarray(vals) * 2).astype(np.int64)
    require(np.array_equal(h / 2.0, vals) and (h >= 0).all(),
            "write_ratings: a rating off the half-star grid")
    cols = [np.asarray(x, np.int64) for x in (users, movies, h // 2, stamps)]
    tails = [np.frombuffer(t, np.uint8) for t in (sep.encode(),) * 3
             + (b"\n",)]
    half = np.frombuffer(b".5", np.uint8)
    with open(path, "wb") as f:
        for s in range(0, h.size, chunk):
            parts, keep = [], []
            for i, x in enumerate(cols):
                x = x[s:s + chunk]
                p10 = 10 ** np.arange(len(str(int(cols[i].max()))) - 1, -1,
                                      -1, dtype=np.int64)
                parts.append((48 + x[:, None] // p10 % 10).astype(np.uint8))
                keep.append((x[:, None] >= p10) | (p10 == 1))
                if i == 2:
                    parts.append(np.broadcast_to(half, (x.size, 2)))
                    keep.append(np.broadcast_to(
                        (h[s:s + chunk] % 2 == 1)[:, None], (x.size, 2)))
                parts.append(np.broadcast_to(tails[i],
                                             (x.size, tails[i].size)))
                keep.append(np.ones((x.size, tails[i].size), bool))
            f.write(np.hstack(parts)[np.hstack(keep)].tobytes())


def densified(df):
    """``df`` as a ratings file of its observations under ids in the same
    order reads back (``_parse_movielens_file``): each mode's ids
    renumbered by ``np.unique``, so that an id no rating uses drops out."""
    import numpy as np
    from bayesiandatafusion_jl_tpu_torch.models.data import IndexedDF
    cols = [np.unique(df.idx[:, d], return_inverse=True)[1]
            for d in range(2)]
    return IndexedDF(np.stack(cols, axis=1), df.vals,
                     tuple(int(c.max()) + 1 for c in cols))


def ratings_file_round_trip(df, variant, tmp):
    """Write ``df`` under ``tmp`` as MovieLens ships ``variant``
    (RATINGS_FILES), require ``find_real_ratings(tmp)`` to find it, read it
    with ``load_movielens(variant, path=...)`` and require the result to
    equal ``densified(df)`` bit for bit.  Prints the write and parse
    seconds; returns the parsed IndexedDF."""
    import numpy as np
    from bayesiandatafusion_jl_tpu_torch.models.datasets import (
        find_real_ratings, load_movielens)
    sub, name, sep, movie_id = RATINGS_FILES[variant]
    path = os.path.join(tmp, sub, name)
    os.makedirs(os.path.dirname(path))
    stamps = np.random.default_rng(FILE_SEED).integers(
        789_652_009, 1_262_304_000, df.nnz)
    t0 = time.perf_counter()
    write_ratings(path, df.idx[:, 0].astype(np.int64) + 1,
                  movie_id(df.idx[:, 1].astype(np.int64)), df.vals, stamps,
                  sep)
    write_s = time.perf_counter() - t0
    found = find_real_ratings(tmp)
    require(found == path, f"find_real_ratings found {found}, not {path}")
    t0 = time.perf_counter()
    got = load_movielens(variant, path=path)
    parse_s = time.perf_counter() - t0
    want = densified(df)
    same = (got.shape == want.shape and got.idx.dtype == want.idx.dtype
            and got.vals.dtype == want.vals.dtype
            and np.array_equal(got.idx, want.idx)
            and np.array_equal(got.vals.view(np.int64),
                               want.vals.view(np.int64)))
    print(f"# ratings file {sub}/{name}: {df.nnz} lines, "
          f"{os.path.getsize(path) / 1e6:.1f} MB written in {write_s:.2f} "
          f"s; found by find_real_ratings; parsed in {parse_s:.2f} s "
          f"({df.nnz / parse_s:.4g} rows/s), shape {got.shape} (the "
          f"generator's {df.shape}); equal to the generator's data after "
          f"np.unique, bit for bit: {same}", flush=True)
    require(same, f"{variant}: the parsed file differs from the data")
    return got


def run_ml10m_file(df, tally):
    """The ML-10M generator's ratings (``df``) through a ratings file
    (``ml-10M100K/ratings.dat``), then bench.py:101-162's configuration as
    written on the parsed data: the plan (every mode on the int8 pair),
    PATHS[32]'s protocol and anchors, its kernels counted.  The file's
    problem drops the users that rate nothing, so its chain is another
    than the generator-fed path's on the same test ratings."""
    from bayesiandatafusion_jl_tpu_torch.models.data import RelationData
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ml10m_") as tmp:
        fd = ratings_file_round_trip(df, "10m", tmp)
    rd = RelationData.from_indexed_df(fd, relation_name="ratings")
    rd.assign_to_test(0, min(100_000, fd.nnz // 10), seed=7)
    print_plan("ML-10M from ratings.dat, bench.py:101-162", rd,
               bench_plan(rd), "pair int8")
    sweeps, repeats, anchor_s, anchor_avg = PATHS[32]
    _, counts, _ = run_path(rd, 32, sweeps, repeats, anchor_s, anchor_avg,
                            name="ML-10M file", **BENCH_GRAM,
                            bucket_widths=BENCH_WIDTHS)
    tally(counts)


def run_ml100k(tally):
    """bench.py's ml100k (bench_ml("100k", 200), :533-537) fed from a
    written ``ml-100k/u.data``: every id occurs, so the parse must equal
    the generator's data as it is; the plan the planner picks, ML100K_RUN's
    protocol, rmse_avg within RMSE_BAND of the JAX chain's and
    rmse_sample@200 printed beside its figure."""
    from bayesiandatafusion_jl_tpu_torch.models.data import RelationData
    from bayesiandatafusion_jl_tpu_torch.models.datasets import \
        load_movielens
    df = load_movielens("100k")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ml100k_") as tmp:
        fd = ratings_file_round_trip(df, "100k", tmp)
    require(fd.shape == df.shape, f"ml100k: ids dropped, {fd.shape}")
    rd = RelationData.from_indexed_df(fd, relation_name="ratings")
    rd.assign_to_test(0, min(100_000, fd.nnz // 10), seed=7)
    print_plan("ml100k from u.data, bench.py:533-537", rd, bench_plan(rd))
    sweeps, repeats = ML100K_RUN
    _, counts, out = run_path(rd, 32, sweeps, repeats, None,
                              ML100K_AVG_ANCHOR, name="ml100k", **BENCH_GRAM,
                              bucket_widths=BENCH_WIDTHS)
    tally(counts)
    wins = out["ms_per_sweep"]
    med = sorted(wins)[len(wins) // 2]
    print(f"# ml100k: {med:.4f} ms/sweep (median window); "
          f"rmse_sample@{sweeps} {out['rmse_at_sweeps']:.4f} (the JAX "
          f"chain's {ML100K_SAMPLE_FIGURE}, one draw: not required); "
          f"rmse_avg {out['metrics']['r0.rmse_avg']:.4f} (the JAX chain's "
          f"{ML100K_AVG_ANCHOR} +- {RMSE_BAND})", flush=True)


def long_chain(label, tally, **opts):
    """One chain of the long-chain gate: ``run()`` of LONG_CHAIN with
    ``opts``, its kernels counted (every sweep the path's, no plain
    version).  Returns the result, the rmse_sample readings and the
    engine."""
    import numpy as np
    from bayesiandatafusion_jl_tpu_torch.models.data import RelationData
    from bayesiandatafusion_jl_tpu_torch.models.datasets import \
        synthetic_ratings
    from bayesiandatafusion_jl_tpu_torch.models.engine import MacauEngine
    from bayesiandatafusion_jl_tpu_torch.utils.config import MacauConfig
    rd = RelationData.from_indexed_df(
        synthetic_ratings(943, 1682, 100_000, seed=5),
        relation_name="ratings")
    rd.assign_to_test(0, 10_000, seed=7)
    eng = MacauEngine(rd, MacauConfig(**LONG_CHAIN, **opts), device="cuda")
    t0 = time.perf_counter()
    res, counts = counted(eng.run)
    secs = time.perf_counter() - t0
    tally(counts)
    total = LONG_CHAIN["burnin"] + LONG_CHAIN["psamples"]
    want = {k: 0 for k in counts}
    for tag, per_sweep in graph_kernels(eng.problem,
                                        LONG_CHAIN["num_latent"]).items():
        want[tag] = per_sweep * total
    traj = np.asarray([h["r0.rmse_sample"] for h in res["history"]
                       if "r0.rmse_sample" in h])
    print(f"# long chain {label}: {total} sweeps in {secs:.2f} s "
          f"({secs * 1e3 / total:.3f} ms/sweep with its reads); RMSE "
          f"{res['RMSE']:.5f}; rmse_sample readings {np.round(traj, 4)}; "
          f"mean prediction stdev {res['predictions']['stdev'].mean():.5f};"
          f" counts {counts}", flush=True)
    require(counts == want, f"long chain {label}: counts {counts} for "
                            f"{total} sweeps, want {want}")
    return res, traj, eng


def run_long_chain_gate(tally):
    """tests/test_longchain.py:21-61 on the card: chain A, float32 on the
    int8 pair (K6, K7, K1), first required to have engaged it; chain B,
    float64 on the gather path (K3 in float64).  Requires the three bounds
    (LONG_RMSE_TOL, LONG_TRAJ_TOL, LONG_STDEV_REL); returns the
    figures."""
    res8, t8, eng = long_chain("A: float32 int8 pair", tally,
                               dtype="float32", gram_dtype="bfloat16",
                               dense_gram=True, dense_int8=True)
    prob = eng.problem
    require(prob.kinds[0] == "pair" and prob.pair_i8s[0]
            and len(prob.dense_plans) == 2,
            "long chain A: the int8 pair did not engage")
    res64, t64, eng = long_chain("B: float64 gather", tally,
                                 dtype="float64", dense_gram=False)
    require(not eng.problem.dense_plans,
            "long chain B: not on the gather path")
    del eng
    s8 = float(res8["predictions"]["stdev"].mean())
    s64 = float(res64["predictions"]["stdev"].mean())
    got = {"rmse": (res8["RMSE"], res64["RMSE"]),
           "tail": (float(t8[-4:].mean()), float(t64[-4:].mean())),
           "stdev": (s8, s64)}
    diffs = {"rmse": abs(got["rmse"][0] - got["rmse"][1]),
             "tail": abs(got["tail"][0] - got["tail"][1]),
             "stdev": abs(s8 - s64) / s64}
    bounds = {"rmse": LONG_RMSE_TOL, "tail": LONG_TRAJ_TOL,
              "stdev": LONG_STDEV_REL}
    print(f"# long-chain gate: (int8 pair, float64 gather) {got}; "
          f"differences {diffs} (bounds {bounds}; stdev relative)",
          flush=True)
    for k, bound in bounds.items():
        require(diffs[k] < bound, f"long-chain gate: {k} {got[k]} differ "
                                  f"by {diffs[k]}, bound {bound}")
    return got


def main() -> int:
    import numpy as np
    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from bayesiandatafusion_jl_tpu_torch import kernels, native
    from bayesiandatafusion_jl_tpu_torch.models.data import (IndexedDF,
                                                             RelationData)
    from bayesiandatafusion_jl_tpu_torch.models.datasets import (
        load_movielens, netflix_synthetic)
    from bayesiandatafusion_jl_tpu_torch.models.engine import MacauEngine
    from bayesiandatafusion_jl_tpu_torch.utils.config import MacauConfig

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = nvidia_smi_line()
    print(f"# device: {torch.cuda.get_device_name(0)} | {card} | torch "
          f"{torch.__version__} cuda {torch.version.cuda} | numpy "
          f"{np.__version__} | {os.cpu_count()} CPUs", flush=True)
    clock = [time.perf_counter()]

    def phase_done(name):
        now = time.perf_counter()
        print(f"# phase {name}: {now - clock[0]:.1f} s", flush=True)
        clock[0] = now

    # -- build --------------------------------------------------------------
    if os.path.exists(kernels.LIB_PATH):
        os.remove(kernels.LIB_PATH)          # build from this checkout
    kernels.load()
    rep = kernels.build_report()
    print(f"# build: {rep['seconds']:.1f} s (nvcc sm_90a, one process per "
          f"source)", flush=True)
    for line in rep["log"].splitlines():
        if ("registers" in line or "spill" in line or "Compiling" in line
                or "C75" in line):
            print(f"#   {line.strip()}")
    # a C75xx note: ptxas serialized a ring kernel's wgmma (a product in a
    # branch it cannot prove warp-uniform), which costs about a third of
    # its speed
    serialized = [line for line in rep["log"].splitlines() if "C75" in line]
    require(not serialized, f"wgmma serialized: {serialized}")
    check_sampler_builds()
    if os.path.exists(native.LIB_PATH):
        os.remove(native.LIB_PATH)           # build from this checkout
    native.lib()
    print(f"# native host builder: {native.build_seconds():.1f} s (the "
          f"host C++ compiler, native/layout.cpp)", flush=True)
    phase_done("build")

    # -- kernels vs plain ---------------------------------------------------
    checks = {}
    for tag, fn, shapes in (
            # ML-10M, Netflix, then the graph paths' entities: tensor's
            # and fusion's; then ChEMBL's compounds and targets
            ("K1", check_chol_kernel, ((32, 71_567), (32, 10_681),
                                       (32, 480_189), (32, 17_770),
                                       (8, 1_000), (32, 30_000),
                                       (32, 2_000), (32, 16), (32, 50_000),
                                       (32, 500), (32, 3_000), (32, 800),
                                       (32, 15_000), (32, 346))),
            ("K2", check_chol_kernel, ((64, 71_567), (64, 10_681),
                                       (96, 71_567), (96, 10_681),
                                       (40, 1_000), (33, 71_567))),
            ("K3", check_full_kernel, ((32, 71_567), (32, 10_681),
                                       (8, 1_000), (32, 200_000),
                                       (32, 20_000), (32, 8), (32, 15_000),
                                       (32, 346))),
            ("K3 no Lambda", functools.partial(check_full_kernel, lam=False),
             ((32, 71_567), (32, 10_681), (8, 1_000))),
            ("K4", check_full_kernel, ((64, 71_567), (64, 10_681),
                                       (96, 71_567), (96, 10_681),
                                       (40, 1_000), (33, 71_567))),
            ("K5", check_chol_inv, ((64, 71_567), (64, 10_681),
                                    (33, 71_567), (64, 1_000))),
            # the blocked sampler's first panel, read in place
            ("K5 panel of [B, 128, 128]",
             functools.partial(check_chol_inv, ld=128), ((64, 71_567),)),
            ("blocked", check_blocked, ((128, 71_567),))):
        for K, B in shapes:
            r = fn(K, B)
            checks[(tag, K, B)] = r
            print(f"# {tag} K={K} B={B}: kernel err {r['kernel_err']:.3e} "
                  f"(f32 plain {r['plain_f32_err']:.3e}, f64 kernel "
                  f"{r['kernel_f64_err']:.3e}); kernel {r['kernel_ms']:.4f} "
                  f"ms, plain {r['plain_ms']:.4f} ms", flush=True)
            require(r["ok"], f"{tag} disagrees with its plain version: {r}")
            torch.cuda.empty_cache()
    # Netflix, ML-10M (K = 32, 64, 97, 128), a ragged case, then the graph
    # paths' tables: tensor's and fusion's largest partners, and ChEMBL's
    # two tables (both its modes); then
    # adversarial factors (adversarial_factors), ragged at K = 128
    for n, K, n_valid, adv in (
            (480_189, 32, None, False), (17_770, 32, None, False),
            (71_567, 32, None, False), (10_681, 32, None, False),
            (71_567, 64, None, False), (10_681, 64, None, False),
            (71_567, 97, None, False), (71_567, 128, None, False),
            (10_681, 128, None, False), (1_001, 36, 900, False),
            (30_000, 32, None, False), (2_000, 32, None, False),
            (50_000, 32, None, False), (500, 32, None, False),
            (3_000, 32, None, False), (800, 32, None, False),
            (15_000, 32, None, False), (346, 32, None, False),
            (71_567, 128, 70_001, True), (10_681, 64, None, True),
            (17_770, 32, 17_000, True), (4_001, 97, None, True),
            (500, 1, None, True)):
        r = check_ytab(n, K, n_valid, adversarial=adv)
        checks[("K7 adversarial" if adv else "K7", K, n)] = r
        print(f"# K7 n={n} K={K} n_valid={n_valid}"
              f"{' adversarial' if adv else ''}: bitwise {r['ok']} "
              f"(max diff {r['max_abs_err']}); kernel {r['kernel_ms']:.4f} "
              f"ms, plain {r['plain_ms']:.4f} ms, bound "
              f"{bound_ms(*ytab_bound(n, K))[0]:.4f} ms", flush=True)
        require(r["ok"], f"K7 disagrees with its plain version: {r}")
        torch.cuda.empty_cache()
    for true, K in (((1_000, 777), 32), ((300, 2_000), 8), ((129, 257), 36)):
        V8 = random_store(true, seed=K)
        for focus in (0, 1):
            r = check_fused_pair(V8, true, K, focus)
            print_fused_check("small ragged", r)
            require(r["ok"], f"K8 disagrees with its plain version: {r}")
        for focus in (0, 1):
            for table, flip in (("int8", False), ("bfloat16", True),
                                ("bfloat16", False), ("float32", True),
                                ("float32", False), ("float64", True),
                                ("float64", False)):
                r = check_fused_variant(V8, true, K, focus, table, flip,
                                        timing=False)
                print_variant_check("small ragged", r)
                require(r["ok"], f"K8 variant disagrees with its plain "
                                 f"version: {r}")
        del V8
    # K6's column tiles: its mask pairs are odd in number at K = 4, 8, 15,
    # 32, 33 and 160 (one tile mixes the last mask pair with the first
    # value pair; at K = 15 and 160 that mask pair is full, at K = 160 the
    # value pairs are two), even at K = 16
    for true, K in (((1_000, 777), 32), ((300, 2_000), 8), ((129, 257), 33),
                    ((64, 48), 4), ((200, 300), 15), ((300, 200), 16),
                    ((200, 300), 160)):
        pair = random_pair(true, seed=K)
        for focus in (0, 1):
            r = check_pair_contract(pair, K, focus, timing=False)
            print_pair_check("small ragged", r)
            require(r["ok"], f"K6 disagrees with its plain version: {r}")
        del pair
    # K9 on ragged plans: a 1,000-row table (not a multiple of 128), a hot
    # window of 5 blocks, windows 1 and 2 empty; and a plan with no
    # observation
    for K in (8, 32, 64, 128):
        for dtype in ("float32", "bfloat16"):
            for n_obs in (20_000, 0):
                r = check_windowed_expand(
                    ragged_parts(1_000, n_obs, K, hot=min(n_obs, 5_000),
                                 gap=2), 1_000, K, dtype, timing=False)
                print_expand_check("small ragged", r)
                require(r["ok"], f"K9 disagrees with its plain version: {r}")
    phase_done("kernels vs plain")

    # -- int8 contraction ----------------------------------------------------
    exact = check_int8_contraction()
    print(f"# the plain versions' int8 products exact (mode 0, mode 1): "
          f"{exact}", flush=True)
    require(all(exact), "torch._int_mm is not exact")

    # -- main paths ----------------------------------------------------------
    df = load_movielens("10m", seed=0)
    rd = RelationData.from_indexed_df(df, relation_name="ratings")
    rd.assign_to_test(0, min(100_000, df.nnz // 10), seed=7)
    ml_train_nnz, ml_shape = rd.relations[0].data.nnz, df.shape
    print(f"# data: nnz={df.nnz}, shape={df.shape}", flush=True)
    print_plan("ML-10M, bench.py:101-162", rd, bench_plan(rd), "pair int8")
    phase_done("ML-10M data")
    launches = dict.fromkeys(("K1", "K2", "K3", "K4", "K5", "K6", "K7",
                              "K8a", "K8b", "K8c", "K8d", "K9"), 0)

    def tally(counts):
        for k in launches:
            launches[k] += counts[k]

    # -- the MovieLens file branch: ML-10M and ml100k from ratings files ---
    run_ml10m_file(df, tally)
    phase_done("ML-10M from a ratings file")
    run_ml100k(tally)
    phase_done("ml100k")
    # -- the long-chain gate: the int8 pair against the float64 gather ----
    run_long_chain_gate(tally)
    phase_done("long-chain gate")
    # K9 at the ML-10M gather shape: the users' factors, the training
    # observations sorted by user id
    users = np.sort(rd.relations[0].data.idx[:, 0])
    for dtype in ("bfloat16", "float32"):
        r = check_windowed_expand(users, df.shape[0], 32, dtype)
        print_expand_check("ML-10M", r)
        require(r["ok"], f"K9 disagrees with its plain version: {r}")
        torch.cuda.empty_cache()
    del users
    rmse_pair = {}
    pair_ms = {}
    pair_checks = {}

    for K, (sweeps, repeats, anchor_s, anchor_avg) in PATHS.items():
        eng, counts, out = run_path(rd, K, sweeps, repeats, anchor_s,
                                    anchor_avg, dense_int8=True)
        tally(counts)
        rmse_pair[K] = out["rmse_at_sweeps"]
        pair_ms[K] = sorted(out["ms_per_sweep"])[len(out["ms_per_sweep"])
                                                 // 2]
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        print(f"# int8 pair K={K}: peak memory {peak_gb:.2f} GB with one "
              f"stored orientation, {TWO_ORIENTATION_PEAK_GB[K]} GB with two",
              flush=True)
        require(peak_gb < TWO_ORIENTATION_PEAK_GB[K],
                f"int8 pair K={K}: peak {peak_gb:.2f} GB")
        if K in (32, 64, 128):
            prof = profile_split(eng, split=PAIR_SPLIT)
            print_profile(f"ML-10M int8 pair K={K}", prof)
        pair = eng.problem.stores[0]
        del eng
        torch.cuda.empty_cache()
        # K6 at the path's own store and K, both modes
        for focus in (0, 1):
            r = check_pair_contract(pair, K, focus)
            print_pair_check("ML-10M", r)
            require(r["ok"] and r["library_equal"],
                    f"K6 disagrees with its plain version or the "
                    f"library: {r}")
            pair_checks[(K, focus)] = r
            torch.cuda.empty_cache()
        del pair
    phase_done("ML-10M int8 pair paths")
    eng = MacauEngine(rd, MacauConfig(num_latent=32, clamp=(1.0, 5.0),
                                      verbose=False, dtype="float32",
                                      seed=42, dense_int8=True),
                      device="cuda")
    require(eng.problem.pair_i8s[0], "driver loop: not the int8 pair")
    run_driver_checks(eng, "ML-10M int8 pair K=32", tally, timing=True)
    phase_done("driver loop")
    # -- sharded1: the sharded engine on ML-10M, NCCL ------------------------
    sharded_group()
    counts, _ = run_sharded_path("sharded1", rd, eng, pair_ms[32],
                                 "pair int8", PAIR_SPLIT + NCCL_SPLIT)
    tally(counts)
    del eng
    torch.cuda.empty_cache()
    run_sharded_worlds("sharded1", tally)
    phase_done("sharded1")
    float_pair_ms = {}
    for store in FLOAT_PAIR_STORES:
        eng, counts, _ = run_path(rd, FLOAT_PAIR_K, 40, 1,
                                  PATHS[FLOAT_PAIR_K][2], None,
                                  dense_int8=False, dense_gram=True,
                                  dense_fused=False, gram_dtype=store)
        tally(counts)
        for r in check_float_pair_contrib(eng):
            float_pair_ms[(store, r["mode"])] = r["ms"]
            print(f"# float pair {store or 'float32'} K={FLOAT_PAIR_K} mode "
                  f"{r['mode']}: the contribution (table, two torch.matmul "
                  f"with float32 sums, alpha) ok {r['ok']} (max |diff| "
                  f"{r['max_abs_err']:.3e} of max |sum| {r['max_abs']:.3e} "
                  f"against float64 sums), {r['ms']:.3f} ms, "
                  f"{r['tflops']:.1f} TFLOP/s", flush=True)
            require(r["ok"], f"the float pair's contribution is off: {r}")
        del eng
        torch.cuda.empty_cache()
    phase_done("ML-10M float pair paths")
    gather_prof = {}
    for K, acc, sweeps, repeats in GATHER_PATHS:
        anchor_s, anchor_avg = PATHS[K][2:]
        eng, counts, _ = run_path(rd, K, sweeps, repeats, anchor_s,
                                  anchor_avg, dense_gram=False,
                                  gram_dtype="bfloat16",
                                  bucket_widths=BENCH_WIDTHS, row_pad=8,
                                  accumulation=acc)
        tally(counts)
        prof = profile_split(eng)
        print_profile(f"gather {acc} K={K}", prof)
        gather_prof[(K, acc)] = prof
        for mode, (n, ms) in enumerate(time_gathers(eng, K)):
            print(f"# gather alone, gather {acc} K={K} mode {mode}: {n} "
                  f"rows in {ms:.3f} ms ({n / ms * 1e3:.4g} rows/s)",
                  flush=True)
        same_seed_runs(eng, f"gather {acc} K={K}")
        if (K, acc) == DRIVER_GATHER:
            run_driver_checks(eng, f"gather {acc} K={K}", tally)
        del eng
    phase_done("ML-10M gather paths")
    for K in FUSED_ML_PATHS:
        eng, counts, _ = run_path(rd, K, 40, 1, PATHS[K][2], None,
                                  dense_fused=True, dense_int8=True)
        tally(counts)
        prof = profile_split(eng, split=FUSED_SPLIT)
        print_profile(f"ML-10M fused s8 K={K}", prof)
        st = eng.problem.stores[0]
        for focus in (0, 1):
            r = check_fused_pair(st["V8"], st["shape"], K, focus)
            print_fused_check("ML-10M", r)
            require(r["ok"], f"K8 disagrees with its plain version: {r}")
        if K == 32:
            same_seed_runs(eng, f"fused K={K}")
        del eng, st
    phase_done("ML-10M fused paths")
    ml_checks = {}
    for K, sweeps, opts in FUSED_ML_MORE:
        eng, counts, out = run_path(rd, K, sweeps, 1, PATHS[K][2], None,
                                    dense_fused=True, **opts)
        tally(counts)
        if K == 128:
            require(abs(out["rmse_at_sweeps"] - rmse_pair[128]) <= RMSE_BAND,
                    f"fused K=128: rmse_sample@{sweeps} "
                    f"{out['rmse_at_sweeps']} outside this run's int8 pair's "
                    f"{rmse_pair[128]} +- {RMSE_BAND}")
        st = eng.problem.stores[0]
        i8 = eng.problem.fused_i8s[0]
        table = "int8" if i8 else (opts.get("gram_dtype") or "float32")
        prof = profile_split(eng, split=FUSED_SPLIT)
        print_profile(f"ML-10M fused {table} K={K}", prof)
        del eng
        torch.cuda.empty_cache()
        # the variant this path launches (K8b, K8c bf16, K8d, the FMA one),
        # both modes, at the path's own store and K
        for focus in (0, 1):
            r = check_fused_variant(st["V8"], st["shape"], K, focus, table,
                                    flip_out=K <= 96)
            print_variant_check("ML-10M", r)
            require(r["ok"], f"K8 variant disagrees with its plain "
                             f"version: {r}")
            ml_checks[(table, K, focus)] = r
            torch.cuda.empty_cache()
        # the library on the materialized mask, both modes
        for focus in (0, 1):
            ml_lib_ms, same = time_mask_library(st["V8"], K, table, focus)
            print(f"# library, ML-10M K={K} mode {focus}, {table}: the "
                  f"product on the materialized mask and on V8"
                  f"{' (transposed)' if focus else ''} (materialization "
                  f"not timed) {ml_lib_ms:.3f} ms"
                  + (f"; int32 sums equal K8b's: {same}" if i8 else ""),
                  flush=True)
            require(same is not False, "torch._int_mm and K8b disagree")
            ml_checks[(table, K, "library", focus)] = ml_lib_ms
            torch.cuda.empty_cache()
        del st
        torch.cuda.empty_cache()
    del rd, df
    phase_done("ML-10M fused paths, K = 128 and float")

    # -- the Netflix fused path, full width ---------------------------------
    t0 = time.perf_counter()
    df = netflix_synthetic()
    gen_s = time.perf_counter() - t0
    rd = RelationData.from_indexed_df(df, relation_name="ratings")
    rd.assign_to_test(0, 100_000, seed=7)
    nf_shape = df.shape
    print(f"# netflix data: generation {gen_s:.1f} s, with the test split "
          f"{time.perf_counter() - t0:.1f} s (nnz={df.nnz}, shape={df.shape})",
          flush=True)
    phase_done("Netflix data")
    # bench.py's options as written: the planner puts the relation on the
    # fused store (its int8 pair, 17.1 GB, past the budget)
    eng, counts, out = run_path(rd, 32, NETFLIX_SWEEPS, NETFLIX_WINDOWS,
                                NETFLIX_ANCHOR, None, name="Netflix",
                                **BENCH_GRAM, bucket_widths=BENCH_WIDTHS)
    tally(counts)
    print_plan("netflix, bench.py:329-421", rd, eng.problem.plan, "fused")
    phase_done("Netflix path")
    prof = profile_split(eng, split=FUSED_SPLIT)
    print_profile("Netflix fused K=32", prof)
    # -- netflix_sharded1: the sharded engine on the same data, NCCL -------
    counts, _ = run_sharded_path(
        "netflix_sharded1", rd, eng,
        sorted(out["ms_per_sweep"])[len(out["ms_per_sweep"]) // 2],
        "fused", FUSED_SPLIT + NCCL_SPLIT)
    tally(counts)
    phase_done("netflix_sharded1")
    st = eng.problem.stores[0]
    del eng
    nf_checks = []
    for focus in (0, 1):
        r = check_fused_pair(st["V8"], st["shape"], 32, focus)
        print_fused_check("Netflix", r)
        require(r["ok"], f"K8 disagrees with its plain version: {r}")
        nf_checks.append(r)
        torch.cuda.empty_cache()
    lib_ms = []
    for focus in (0, 1):
        ms, lib_same = time_mask_library(st["V8"], 32, focus=focus)
        print(f"# library, Netflix mode {focus}: torch._int_mm of the "
              f"materialized mask and of V8{' (transposed)' if focus else ''}"
              f" (materialization not timed) {ms:.3f} ms; int32 sums equal "
              f"K8's: {lib_same}", flush=True)
        require(lib_same, "torch._int_mm and K8 disagree")
        lib_ms.append(ms)
        torch.cuda.empty_cache()
    del st
    torch.cuda.empty_cache()
    phase_done("Netflix kernels")
    run_sharded_worlds("netflix_sharded1", tally)

    # -- the Netflix float fused path ---------------------------------------
    eng, counts, _ = run_path(rd, 32, NETFLIX_SWEEPS, NETFLIX_WINDOWS,
                              NETFLIX_ANCHOR, None, name="Netflix",
                              dense_fused=True, dense_int8=False,
                              gram_dtype="bfloat16")
    tally(counts)
    prof = profile_split(eng, split=FUSED_SPLIT)
    print_profile("Netflix fused bfloat16 K=32", prof)
    st = eng.problem.stores[0]
    del eng
    nf_float = []
    for focus in (0, 1):
        r = check_fused_variant(st["V8"], st["shape"], 32, focus, "bfloat16",
                                flip_out=True)
        print_variant_check("Netflix", r)
        require(r["ok"], f"K8c disagrees with its plain version: {r}")
        nf_float.append(r)
        torch.cuda.empty_cache()
    lib_float_ms = []
    for focus in (0, 1):
        ms, _ = time_mask_library(st["V8"], 32, "bfloat16", focus)
        print(f"# library, Netflix mode {focus}, bfloat16: torch.matmul of "
              f"the materialized mask and of V8's codes"
              f"{' (transposed)' if focus else ''}, 17.1 GB each in "
              f"bfloat16 (materialization not timed) {ms:.3f} ms",
              flush=True)
        lib_float_ms.append(ms)
        torch.cuda.empty_cache()
    del st
    torch.cuda.empty_cache()
    phase_done("Netflix float fused path")

    # -- netflix_gather: the same data on the gather path -------------------
    eng, counts, _ = run_path(rd, 32, NETFLIX_SWEEPS, NETFLIX_WINDOWS,
                              NETFLIX_ANCHOR, None, name="netflix_gather",
                              dense_gram=False, **BENCH_GRAM,
                              bucket_widths=BENCH_WIDTHS)
    tally(counts)
    print_plan("netflix_gather, bench.py:422-472", rd, eng.problem.plan,
               "gather")
    print_profile("netflix_gather K=32",
                  profile_split(eng, warm=1, sweeps=2))
    del eng, rd
    torch.cuda.empty_cache()
    phase_done("netflix_gather path")

    # -- netflix_cont: continuous values on a bounded-error grid ------------
    t0 = time.perf_counter()
    jitter = np.random.default_rng(17).uniform(-0.45, 0.45, df.nnz)
    rd = RelationData.from_indexed_df(
        IndexedDF(df.idx, df.vals.astype(np.float32)
                  + jitter.astype(np.float32), df.shape),
        relation_name="ratings")
    del jitter
    rd.assign_to_test(0, 100_000, seed=7)
    print(f"# netflix_cont data: {time.perf_counter() - t0:.1f} s with the "
          f"test split", flush=True)
    eng, counts, _ = run_path(rd, 32, NETFLIX_SWEEPS, NETFLIX_WINDOWS,
                              NETFLIX_CONT_ANCHOR, None, name="netflix_cont",
                              **BENCH_GRAM, dense_fused_tol=NETFLIX_CONT_TOL,
                              bucket_widths=BENCH_WIDTHS)
    tally(counts)
    print_plan("netflix_cont, bench.py:388-405", rd, eng.problem.plan,
               "fused")
    st = eng.problem.stores[0]
    print(f"# netflix_cont took the s8 fused path on the grid of step "
          f"{st['scale']:.6f} (rounding error <= {st['scale'] / 2:.6f}), "
          f"shift {st['shift']}, with a residual of "
          f"{eng.problem.residual_nnzs[0]} observations", flush=True)
    require(st["scale"] / 2 <= NETFLIX_CONT_TOL,
            f"netflix_cont: grid step {st['scale']} over the tolerance")
    del eng, st, rd
    torch.cuda.empty_cache()
    phase_done("netflix_cont path")

    # -- netflix_dup: the hybrid residual -----------------------------------
    t0 = time.perf_counter()
    dsel = np.arange(0, df.nnz, 67)
    df = IndexedDF(np.concatenate([df.idx, df.idx[dsel]]),
                   np.concatenate([df.vals, df.vals[dsel]]), df.shape)
    rd = RelationData.from_indexed_df(df, relation_name="ratings")
    rd.assign_to_test(0, 100_000, seed=7)
    print(f"# netflix_dup data: +{len(dsel)} duplicate observations, nnz="
          f"{df.nnz}, {time.perf_counter() - t0:.1f} s with the test split",
          flush=True)
    del df, dsel
    eng, counts, _ = run_path(rd, 32, NETFLIX_SWEEPS, NETFLIX_WINDOWS,
                              NETFLIX_DUP_ANCHOR, None, name="netflix_dup",
                              **BENCH_GRAM, bucket_widths=BENCH_WIDTHS)
    tally(counts)
    print_plan("netflix_dup, bench.py:382-385", rd, eng.problem.plan,
               "fused")
    require(eng.problem.residual_nnzs[0] > 1_400_000,
            f"netflix_dup: residual of {eng.problem.residual_nnzs[0]}")
    prof = profile_split(eng, split=FUSED_SPLIT)
    print_profile("netflix_dup fused K=32", prof)
    same_seed_runs(eng, "netflix_dup fused K=32 with residual")
    del eng, rd
    torch.cuda.empty_cache()
    phase_done("netflix_dup path")

    # -- the graph paths and K9 at tensor_big's shape ----------------------
    k9_checks = run_graph_paths(tally)

    # -- the ChEMBL Macau paths ---------------------------------------------
    feat_ms = run_chembl_paths(tally)

    print_planner_readout(
        gather_prof[(32, "segment")], ml_train_nnz,
        [pair_checks[(32, f)] for f in (0, 1)],
        [float_pair_ms[(None, f)] for f in (0, 1)], ml_shape,
        nf_checks[0], nf_float[0], nf_shape)
    print_feat_readout(feat_ms)
    dist.destroy_process_group()

    src = "bayesiandatafusion_jl_tpu_torch/csrc/"
    jax_src = "bayesiandatafusion_jl_tpu/ops/pallas_chol.py:"
    rows = []
    for tag, name, source, line, (K, B) in (
            ("K1", "chol_sample_packed", "chol_sample_packed.cu", 178,
             (32, 71_567)),
            ("K2", "chol_sample_packed_slab", "chol_sample_packed_slab.cu",
             269, (64, 71_567)),
            ("K3", "chol_sample_full", "chol_sample_full.cu", 29,
             (32, 71_567)),
            ("K4", "chol_sample_full_slab", "chol_sample_full_slab.cu", 77,
             (64, 71_567)),
            ("K5", "chol_inv", "chol_inv.cu", 389, (64, 71_567))):
        r = checks[(tag, K, B)]
        b_ms, b_by = bound_ms(*(chol_inv_bound(K, B) if tag == "K5"
                                else sampler_bound(K, B)))
        rows.append({"name": name, "route": "cuda", "source": src + source,
                     "replaces": jax_src + str(line),
                     "launches": launches[tag],
                     "max_abs_err": r["kernel_err"], "ms": r["kernel_ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None})
    r, r1 = pair_checks[(32, 0)], pair_checks[(32, 1)]
    rows.append({"name": "pair_contract_i8", "route": "cuda",
                 "source": src + "fused_pair_i8.cu",
                 "replaces": "bayesiandatafusion_jl_tpu/ops/pallas_pair.py:137",
                 "launches": launches["K6"], "max_abs_err": r["max_abs_err"],
                 "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
                 "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                 "library_ms": r["library_ms"],
                 "mode_1": {k: r1[k] for k in (
                     "max_abs_err", "plain_ms", "bound_ms", "bound_by",
                     "library_ms")} | {"ms": r1["kernel_ms"]}})
    r = checks[("K7", 32, 480_189)]
    b_ms, b_by = bound_ms(*ytab_bound(480_189, 32))
    rows.append({"name": "ytab_quantize", "route": "cuda",
                 "source": src + "ytab_quantize.cu",
                 "replaces": "bayesiandatafusion_jl_tpu/ops/pallas_ytab.py:125",
                 "launches": launches["K7"], "max_abs_err": r["max_abs_err"],
                 "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    fused_src = "bayesiandatafusion_jl_tpu/ops/pallas_fused.py:"
    # one row a kernel at its main shape, mode 0, and mode 1 beside it
    for tag, name, source, line, modes, lib in (
            ("K8a", "fused_pair_i8", "fused_pair_i8.cu", 127, nf_checks,
             lib_ms),
            ("K8b", "fused_pair_i8_natural", "fused_pair_i8.cu", 83,
             [ml_checks[("int8", 128, f)] for f in (0, 1)],
             [ml_checks[("int8", 128, "library", f)] for f in (0, 1)]),
            ("K8c", "fused_pair_float", "fused_pair_f.cu", 252, nf_float,
             lib_float_ms),
            ("K8d", "fused_pair_float_natural", "fused_pair_f.cu", 303,
             [ml_checks[("bfloat16", 128, f)] for f in (0, 1)],
             [ml_checks[("bfloat16", 128, "library", f)] for f in (0, 1)])):
        r, r1 = modes
        rows.append({"name": name, "route": "cuda", "source": src + source,
                     "replaces": fused_src + str(line),
                     "launches": launches[tag],
                     "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": lib[0],
                     "mode_1": {"max_abs_err": r1["max_abs_err"],
                                "ms": r1["kernel_ms"],
                                "plain_ms": r1["plain_ms"],
                                "bound_ms": r1["bound_ms"],
                                "bound_by": r1["bound_by"],
                                "library_ms": lib[1]}})
    r = k9_checks[("tensor_big", "bfloat16")]
    rows.append({"name": "windowed_expand", "route": "cuda",
                 "source": src + "windowed_expand.cu",
                 "replaces": "bayesiandatafusion_jl_tpu/ops/pallas_gather.py:90",
                 "launches": launches["K9"], "max_abs_err": r["max_abs_err"],
                 "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
                 "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                 "library_ms": r["library_ms"]})
    # K9 is on no engine path, as in JAX (the focus-order permutation it
    # would feed was never built): every path above held its launches to
    # 0, and its row says so
    for row in rows:
        require(row["launches"] > 0 or row["name"] == "windowed_expand",
                f"{row['name']} never launched on a main path")
    print(f"# total: {time.perf_counter() - T_START:.1f} s", flush=True)
    print(nvidia_smi_line())
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def dense_rate(ms, cells, itemsize, K=32):
    """The contraction rate ``estimate_times`` needs to predict ``ms`` for
    one mode over ``cells`` stored cells of ``itemsize`` bytes at rank K:
    ms = max(flops / rate, bytes / HBM) + bytes / HBM, solved for the rate
    (NaN when the time is the bytes' alone)."""
    flops = 2.0 * cells * (K * (K + 1) // 2)
    rest = ms * 1e-3 - cells * itemsize / HBM_BYTES_S
    return (flops / rest if rest > cells * itemsize / HBM_BYTES_S
            else float("nan"))


def print_planner_readout(gather_prof, nnz, k6, float_ms, ml_shape, k8a,
                          k8c, nf_shape):
    """The planner's constants (ops/dense_gram.py) as this run measures
    them, beside the module's: the gather path's device time outside the
    sampler a sweep at ML-10M K = 32 per training observation and mode;
    the rates that reproduce K6's mean mode time and the float32 pair's
    (both modes, ML-10M K = 32), K8a's and K8c's (bfloat16 table) mode-0
    time at Netflix, through ``estimate_times``' model (``dense_rate``)."""
    from bayesiandatafusion_jl_tpu_torch.ops import dense_gram as dg
    ml_cells = ml_shape[0] * ml_shape[1]
    nf_cells = nf_shape[0] * nf_shape[1]
    got = {
        "_GATHER_S_PER_OBS": (gather_prof["device_ms"]
                              - gather_prof["split_ms"]["sampler"])
        * 1e-3 / (2 * nnz),
        "_PAIR_I8_OPS": dense_rate(sum(r["kernel_ms"] for r in k6) / 2,
                                   ml_cells, 1),
        "_PAIR_FLOAT_FLOPS": dense_rate(sum(float_ms) / 2, ml_cells, 4),
        "_FUSED_S8_OPS": dense_rate(k8a["kernel_ms"], nf_cells, 1),
        "_FUSED_FLOAT_FLOPS": dense_rate(k8c["kernel_ms"], nf_cells, 1)}
    print("# planner constants measured in this run (ops/dense_gram.py's "
          "in parentheses): " + "; ".join(
              f"{k} {v:.4g} ({getattr(dg, k):.4g})" for k, v in got.items()),
          flush=True)


def print_profile(label, prof):
    print(f"# profile {label}: device ms/sweep {prof['device_ms']:.3f} of "
          f"{prof['wall_ms']:.3f} wall, idle {prof['idle']:.1%}; split "
          f"{ {k: round(v, 3) for k, v in prof['split_ms'].items()} }; "
          f"top kernels {prof['top']}", flush=True)
    print(f"# profile {label}: the largest kernels of no named part (ms a "
          f"sweep, launches in the trace) {prof['rest_top']}", flush=True)
    if prof["beta_span_ms"] is not None:
        print(f"# profile {label}: the beta draw's record_function ranges "
              f"on the device: span {prof['beta_span_ms']:.3f} ms a sweep, "
              f"kernels inside {prof['beta_busy_ms']:.3f} ms; the rest of "
              f"the sweep's kernels "
              f"{prof['device_ms'] - prof['beta_busy_ms']:.3f} ms",
              flush=True)


def print_fused_check(label, r):
    line = (f"# K8 {label} {r['shape']} K={r['K']} focus {r['focus']}: "
            f"bitwise {r['ok']} (max diff {r['max_abs_err']})")
    if "kernel_ms" in r:
        line += (f"; dq {r['kernel_ms']:.4f} ms ({r['tops']:.1f} dense "
                 f"TOP/s), raw {r['raw_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
                 f"{r['bound_ms']:.4f} ms ({r['bound_by']}); the dense-MMA "
                 f"design's floor {r['dense_bound_ms']:.4f} ms (every cell "
                 f"at the int8 peak)")
    print(line, flush=True)
    if "kernel_ms" in r:
        print_ptxas(f"fused_pair_kernelILi{r['focus']}ELi1E")


T_START = time.perf_counter()

if __name__ == "__main__":
    sys.exit(main())
