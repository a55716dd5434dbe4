"""GPU smoke test of the PyTorch/CUDA port, ``bayesiandatafusion_jl_tpu_torch``.

Run from the repository root on a machine with one CUDA card (an H100):

    python3 chip_smoke.py

Phases, each fatal on failure (nonzero exit, no result line):

1. device: a CUDA device is present; its name and power limit;
2. build: ``nvcc`` compiles the port's kernels for sm_90a from ``csrc/``;
3. kernels vs plain: each sampler kernel against its plain torch version
   on random SPD problems at the main paths' shapes, float32 and float64,
   both held against the float64 plain version: K1 (packed, K <= 32), K2
   (packed column-slab, 32 < K <= 96), K3 (full P, K <= 32, with and
   without Lambda), K4 (full-P column-slab, 32 < K <= 96), K5 (panel
   factor-inverse, K <= 64) and the blocked K = 128 sampler built on K5
   against ``torch.linalg``;
4. int8 contraction: ``torch._int_mm`` equals a float64 matmul of the same
   codes exactly, at ML-10M shapes;
5. main paths: ML-10M-shaped synthetic BPMF (71,567 x 10,681, 10,000,054
   ratings, float32), made once, through ``MacauEngine.benchmark``:
   - the int8 pair path at K = 32, 64, 96 and 128.  Every sweep must
     sample both entities through the path's kernel (K1, K2, K2, K5 twice
     per entity);
   - the gather path (``dense_gram=False``, bfloat16 gather, the bench's
     25-width bucket ladder) at K = 32 and 64 with "segment" accumulation
     and at K = 32 with "planned".  Every sweep must sample both entities
     through K3 (K = 32) or K4 (K = 64); each path also reports a
     ``torch.profiler`` split of a few sweeps and whether two runs of the
     same seed give the same U.
   On every path the plain versions and the other paths' kernels must not
   run, and the RMSEs must lie in the JAX chain's bands where the JAX
   package has one.

The last lines are the card's ``nvidia-smi`` name and power limit, a JSON
object describing the kernels (with each one's bound on this card) and
the ``{"ok": true, "device": ...}`` line.
"""
import functools
import json
import math
import os
import subprocess
import sys
import time

# The JAX package's chains on the same data and protocol (BENCH_r05.json,
# docs/BENCH_R5_RUNS.md:38,59): rmse_sample at the end of the first window
# and, at K = 32, the posterior-mean rmse after 160 sweeps.  The random
# streams differ, so these are chain-noise bands, not parity checks.  No
# K = 128 figure exists for either package.
RMSE_BAND = 0.02
# K: (sweeps per window, timed windows, rmse_sample anchor, rmse_avg anchor)
PATHS = {32: (40, 3, 0.6926, 0.6567),
         64: (40, 3, 0.7294, None),
         96: (20, 3, 0.7473, None),
         128: (20, 1, None, None)}
# The gather paths: (K, accumulation, sweeps per window, timed windows).
# The planned path runs one timed window of 40 sweeps, so that the same
# anchors as at K = 32 apply to it.
GATHER_PATHS = ((32, "segment", 40, 3), (64, "segment", 40, 3),
                (32, "planned", 40, 1))
# the bench's 25-step width ladder (bench.py:24-25)
BENCH_WIDTHS = (8, 12, 16, 20, 24, 28, 32, 40, 48, 56, 64, 80, 96, 112, 128,
                160, 192, 224, 256, 320, 384, 512, 768, 1024, 2048)
KERNEL_ERR_FACTOR = 10.0     # kernel error <= 10x the f32 plain version's
F64_KERNEL_TOL = 1e-9        # float64 kernel vs float64 plain version
# H100 SXM peaks (NVIDIA's data sheet, at 700 W): HBM bytes/s and float32
# FLOP/s outside the tensor cores, for the kernels' bounds
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12


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


def bound_ms(nbytes, flop):
    """The least time on the card: the larger of bytes over the HBM rate
    and FLOP over the float32 rate; and which of the two it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flop / F32_FLOP_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_chol_inv(K, B, timing=True, seed=0):
    """K5 (float32 and float64) and the float32 plain version against the
    float64 plain version; W must be exactly zero above the diagonal."""
    import torch
    from bayesiandatafusion_jl_tpu_torch.ops.chol_blocked import (
        chol_inv, chol_inv_plain)
    P, _ = spd_full(K, B, seed)
    ref = chol_inv_plain(P)
    P32 = P.float()
    kern = chol_inv(P32)
    kern64 = chol_inv(P)
    plain = chol_inv_plain(P32)
    r = {"K": K, "B": B, **_verdict(kern, plain, kern64, ref)}
    upper = torch.triu(torch.ones(K, K, dtype=torch.bool, device=P.device),
                       1)
    r["ok"] = r["ok"] and not bool(kern[:, upper].any().item()
                                   or kern64[:, upper].any().item())
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


def check_int8_contraction(n_rows=2048, K=32, seed=1):
    """torch._int_mm's int32 products equal float64 matmuls of the same
    int8 codes exactly, for a block of rows of each mode at ML-10M shapes
    (partner widths padded as the engine stores them)."""
    import torch
    from bayesiandatafusion_jl_tpu_torch.ops.dense_gram import int8_matmul
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


def counters():
    """(function, attribute) of each kernel wrapper's launch count and each
    plain version's call count, by name."""
    from bayesiandatafusion_jl_tpu_torch.ops import (chol_blocked, chol_full,
                                                     chol_packed)
    return {"K1": (chol_packed.chol_sample_packed, "launches"),
            "K2": (chol_packed.chol_sample_packed_tiled, "launches"),
            "K3": (chol_full.chol_sample_full, "launches"),
            "K4": (chol_full.chol_sample_full_tiled, "launches"),
            "K5": (chol_blocked.chol_inv, "launches"),
            "plain_packed": (chol_packed.chol_sample_packed_plain, "calls"),
            "plain_full": (chol_full.chol_sample_full_plain, "calls"),
            "plain_inv": (chol_blocked.chol_inv_plain, "calls")}


def read_counts():
    return {k: getattr(f, a) for k, (f, a) in counters().items()}


def zero_counts():
    for f, a in counters().values():
        setattr(f, a, 0)


def time_int8_products(pair, K):
    """CUDA-event times of one path's int8 P and b products, per mode, on
    its stored pair (random codes of the path's shapes)."""
    import torch
    from bayesiandatafusion_jl_tpu_torch.ops.dense_gram import (
        int8_matmul, quantize_rows)
    C = K * (K + 1) // 2
    for mode in range(2):
        Mf, Wf = pair["M8"][mode], pair["W8"][mode]
        Y8, _ = quantize_rows(torch.randn((C, Mf.shape[1]), device="cuda"))
        U8, _ = quantize_rows(torch.randn((K, Mf.shape[1]), device="cuda"))
        ms_p = cuda_ms(lambda: int8_matmul(Y8, Mf.mT), 10)
        ms_b = cuda_ms(lambda: int8_matmul(U8, Wf.mT), 10)
        print(f"# _int_mm K={K} mode {mode} (focus {Mf.shape[0]}, partner "
              f"{Mf.shape[1]}): P {ms_p:.3f} ms, b {ms_b:.3f} ms",
              flush=True)


def path_kernel(K, gather):
    """(counter, launches per sweep) of the sampler a path must run."""
    if gather and K <= 32:
        return "K3", 2
    if gather and K <= 96:
        return "K4", 2
    if K <= 32:
        return "K1", 2
    if K <= 96:
        return "K2", 2
    return "K5", 4


def run_path(rd, K, sweeps, repeats, anchor_s, anchor_avg, **opts):
    """One main path: the ML-10M benchmark protocol at rank K (``opts``
    select the gather path), with the kernels' counts set to 0 just before
    it and read just after."""
    import torch
    from bayesiandatafusion_jl_tpu_torch.models.engine import MacauEngine
    from bayesiandatafusion_jl_tpu_torch.utils.config import MacauConfig
    cfg = MacauConfig(num_latent=K, burnin=sweeps, psamples=0,
                      clamp=(1.0, 5.0), verbose=False, dtype="float32",
                      seed=42, **opts)
    gather = cfg.dense_gram is False
    label = (f"gather {cfg.accumulation} K={K}" if gather
             else f"int8 pair K={K}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = MacauEngine(rd, cfg, device="cuda")
    build_s = time.perf_counter() - t0
    zero_counts()
    out = eng.benchmark(sweeps, repeats=repeats)
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    m = out["metrics"]
    wins = out["ms_per_sweep"]
    med = sorted(wins)[len(wins) // 2]
    n_rows = sum(es.n for es in eng.problem.entity_specs)
    prob = eng.problem
    built = (f"layout {prob.layout_seconds:.1f} s, padded nnz per mode "
             f"{prob.padded_nnz}" if gather
             else f"pair store {prob.build_seconds:.1f} s")
    print(f"# path {label}: ms/sweep per window {wins}, median {med:.3f}; "
          f"rows/s {n_rows / med * 1e3:.1f}; rmse_sample@{sweeps} "
          f"{out['rmse_at_sweeps']:.4f}; rmse_avg {m['r0.rmse_avg']:.4f}; "
          f"peak memory {peak_gb:.2f} GB; counts {counts}; engine build "
          f"{build_s:.1f} s ({built})", flush=True)
    total_sweeps = sweeps * (repeats + 1)
    tag, per_sweep = path_kernel(K, gather)
    want = {k: 0 for k in counts}
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
    return eng, counts


# kernel-name fragments of each part of a gather sweep (torch.profiler)
SPLIT = (("sampler", ("chol_sample", "chol_inv")),
         ("gather", ("gather_kernel", "indexSelect")),
         ("segment sum", ("indexFunc",)),
         ("bmm", ("gemm", "gemv", "cutlass", "xmma", "sm90_")))


def profile_split(eng, warm=2, sweeps=3):
    """Device milliseconds per sweep by part of the sweep (SPLIT, the rest
    under "rest"), the device idle share and the largest kernels, from a
    ``torch.profiler`` trace of ``sweeps`` sweeps after ``warm``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    state = eng.init_state()
    for s in range(warm):
        state, _ = eng._sweep(state, s, 0.0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for s in range(warm, warm + sweeps):
            state, _ = eng._sweep(state, s, 0.0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
    split = {part: 0.0 for part, _ in SPLIT}
    split["rest"] = 0.0
    for name, ms in by_name.items():
        part = next((p for p, frags in SPLIT
                     if any(f in name for f in frags)), "rest")
        split[part] += ms / sweeps
    device_ms = sum(split.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"split_ms": split, "device_ms": device_ms,
            "wall_ms": wall_ms / sweeps,
            "idle": 1.0 - device_ms * sweeps / wall_ms,
            "top": [(n[:60], ms / sweeps) for n, ms in top]}


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


def same_seed_runs(eng, sweeps=3):
    """Whether two runs of ``sweeps`` sweeps from the same seed give the
    same U, bit for bit, and the largest difference."""
    import torch
    a = eng.run(num_sweeps=sweeps)["state"]["ent"]
    b = eng.run(num_sweeps=sweeps)["state"]["ent"]
    same = all(torch.equal(x["U"], y["U"]) for x, y in zip(a, b))
    diff = max(float((x["U"] - y["U"]).abs().max()) for x, y in zip(a, b))
    return same, diff


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from bayesiandatafusion_jl_tpu_torch import kernels
    from bayesiandatafusion_jl_tpu_torch.models.data import RelationData
    from bayesiandatafusion_jl_tpu_torch.models.datasets import \
        load_movielens

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = nvidia_smi_line()
    print(f"# device: {torch.cuda.get_device_name(0)} | {card} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)

    # -- build --------------------------------------------------------------
    if os.path.exists(kernels.LIB_PATH):
        os.remove(kernels.LIB_PATH)          # build from this checkout
    kernels.load()
    rep = kernels.build_report()
    print(f"# build: {rep['seconds']:.1f} s (nvcc sm_90a, one process per "
          f"source)", flush=True)
    for line in rep["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"#   {line.strip()}")

    # -- kernels vs plain ---------------------------------------------------
    checks = {}
    for tag, fn, shapes in (
            ("K1", check_chol_kernel, ((32, 71_567), (32, 10_681),
                                       (8, 1_000))),
            ("K2", check_chol_kernel, ((64, 71_567), (64, 10_681),
                                       (96, 71_567), (40, 1_000))),
            ("K3", check_full_kernel, ((32, 71_567), (32, 10_681),
                                       (8, 1_000))),
            ("K3 no Lambda", functools.partial(check_full_kernel, lam=False),
             ((32, 71_567), (32, 10_681), (8, 1_000))),
            ("K4", check_full_kernel, ((64, 71_567), (64, 10_681),
                                       (96, 71_567), (40, 1_000))),
            ("K5", check_chol_inv, ((64, 71_567), (64, 1_000))),
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

    # -- int8 contraction ----------------------------------------------------
    exact = check_int8_contraction()
    print(f"# int8 contraction exact (mode 0, mode 1): {exact}", flush=True)
    require(all(exact), "torch._int_mm is not exact")

    # -- main paths ----------------------------------------------------------
    t0 = time.perf_counter()
    df = load_movielens("10m", seed=0)
    rd = RelationData.from_indexed_df(df, relation_name="ratings")
    rd.assign_to_test(0, min(100_000, df.nnz // 10), seed=7)
    print(f"# data: {time.perf_counter() - t0:.1f} s (nnz={df.nnz}, "
          f"shape={df.shape})", flush=True)
    launches = dict.fromkeys(("K1", "K2", "K3", "K4", "K5"), 0)
    for K, (sweeps, repeats, anchor_s, anchor_avg) in PATHS.items():
        eng, counts = run_path(rd, K, sweeps, repeats, anchor_s, anchor_avg,
                               dense_int8=True)
        for k in launches:
            launches[k] += counts[k]
        if K == 32:
            time_int8_products(eng.problem.pair, K)
        del eng
    for K, acc, sweeps, repeats in GATHER_PATHS:
        anchor_s, anchor_avg = PATHS[K][2:]
        eng, counts = run_path(rd, K, sweeps, repeats, anchor_s, anchor_avg,
                               dense_gram=False, gram_dtype="bfloat16",
                               bucket_widths=BENCH_WIDTHS, row_pad=8,
                               accumulation=acc)
        for k in launches:
            launches[k] += counts[k]
        prof = profile_split(eng)
        print(f"# profile gather {acc} K={K}: device ms/sweep "
              f"{prof['device_ms']:.3f} of {prof['wall_ms']:.3f} wall, idle "
              f"{prof['idle']:.1%}; split "
              f"{ {k: round(v, 3) for k, v in prof['split_ms'].items()} }; "
              f"top kernels {prof['top']}", flush=True)
        for mode, (n, ms) in enumerate(time_gathers(eng, K)):
            print(f"# gather alone, gather {acc} K={K} mode {mode}: {n} "
                  f"rows in {ms:.3f} ms ({n / ms * 1e3:.4g} rows/s)",
                  flush=True)
        same, diff = same_seed_runs(eng)
        print(f"# same seed twice, gather {acc} K={K}: U bitwise equal "
              f"{same}, max |diff| {diff:.3e}", flush=True)
        require(math.isfinite(diff), f"gather {acc} K={K}: non-finite U")
        del eng

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
    print(nvidia_smi_line())
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
