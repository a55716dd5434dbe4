"""GPU smoke test of the PyTorch/CUDA port, ``bayesiandatafusion_jl_tpu_torch``.

Run from the repository root on a machine with one CUDA card (an H100):

    python3 chip_smoke.py

Phases, each fatal on failure (nonzero exit, no result line):

1. device: a CUDA device is present; its name and power limit;
2. build: ``nvcc`` compiles the port's kernels for sm_90a from ``csrc/``;
3. kernels vs plain: each sampler kernel against its plain torch version
   on random SPD problems at the main paths' shapes, float32 and float64,
   both held against the float64 plain version: K1 (packed, K <= 32), K2
   (packed column-slab, 32 < K <= 96), K5 (panel factor-inverse, K <= 64)
   and the blocked K = 128 sampler built on K5 against ``torch.linalg``;
4. int8 contraction: ``torch._int_mm`` equals a float64 matmul of the same
   codes exactly, at ML-10M shapes;
5. main paths: ML-10M-shaped synthetic BPMF (71,567 x 10,681, 10,000,054
   ratings, float32), made once, through ``MacauEngine.benchmark`` at
   K = 32, 64, 96 and 128.  Every sweep must sample both entities through
   the path's kernel (K1, K2, K2, K5 twice per entity), the plain versions
   must not run, and the RMSEs must lie in the JAX chain's bands where the
   JAX package has one.

The last lines are the card's ``nvidia-smi`` name and power limit, a JSON
object describing the kernels and the ``{"ok": true, "device": ...}`` line.
"""
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
KERNEL_ERR_FACTOR = 10.0     # kernel error <= 10x the f32 plain version's
F64_KERNEL_TOL = 1e-9        # float64 kernel vs float64 plain version


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
    from bayesiandatafusion_jl_tpu_torch.ops import chol_blocked, chol_packed
    return {"K1": (chol_packed.chol_sample_packed, "launches"),
            "K2": (chol_packed.chol_sample_packed_tiled, "launches"),
            "K5": (chol_blocked.chol_inv, "launches"),
            "plain_packed": (chol_packed.chol_sample_packed_plain, "calls"),
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


def run_path(rd, K):
    """One main path: the ML-10M benchmark protocol at rank K, with the
    kernels' counts set to 0 just before it and read just after."""
    import torch
    from bayesiandatafusion_jl_tpu_torch.models.engine import MacauEngine
    from bayesiandatafusion_jl_tpu_torch.utils.config import MacauConfig
    sweeps, repeats, anchor_s, anchor_avg = PATHS[K]
    cfg = MacauConfig(num_latent=K, burnin=sweeps, psamples=0,
                      clamp=(1.0, 5.0), verbose=False, dtype="float32",
                      seed=42, dense_int8=True)
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
    print(f"# path K={K}: ms/sweep per window {wins}, median {med:.3f}; "
          f"rows/s {n_rows / med * 1e3:.1f}; rmse_sample@{sweeps} "
          f"{out['rmse_at_sweeps']:.4f}; rmse_avg {m['r0.rmse_avg']:.4f}; "
          f"peak memory {peak_gb:.2f} GB; counts {counts}; engine build "
          f"{build_s:.1f} s (pair store {eng.problem.build_seconds:.1f} s)",
          flush=True)
    total_sweeps = sweeps * (repeats + 1)
    want = {"K1": 2 * total_sweeps if K <= 32 else 0,
            "K2": 2 * total_sweeps if 32 < K <= 96 else 0,
            "K5": 2 * 2 * total_sweeps if 96 < K <= 128 else 0,
            "plain_packed": 0, "plain_inv": 0}
    require(counts == want, f"K={K}: counts {counts} for {total_sweeps} "
                            f"sweeps, want {want}")
    vals = [*wins, out["rmse_at_sweeps"], *m.values()]
    require(all(math.isfinite(v) for v in vals),
            f"K={K}: non-finite metrics {m}")
    if anchor_s is not None:
        require(abs(out["rmse_at_sweeps"] - anchor_s) <= RMSE_BAND,
                f"K={K}: rmse_sample@{sweeps} {out['rmse_at_sweeps']} "
                f"outside {anchor_s} +- {RMSE_BAND}")
    if anchor_avg is not None:
        require(abs(m["r0.rmse_avg"] - anchor_avg) <= RMSE_BAND,
                f"K={K}: rmse_avg {m['r0.rmse_avg']} outside "
                f"{anchor_avg} +- {RMSE_BAND}")
    return eng, counts


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
    launches = {"K1": 0, "K2": 0, "K5": 0}
    for K in PATHS:
        eng, counts = run_path(rd, K)
        for k in launches:
            launches[k] += counts[k]
        if K == 32:
            time_int8_products(eng.problem.pair, K)
        del eng

    src = "bayesiandatafusion_jl_tpu_torch/csrc/"
    rows = []
    for tag, name, source, replaces, shape in (
            ("K1", "chol_sample_packed", "chol_sample_packed.cu",
             "bayesiandatafusion_jl_tpu/ops/pallas_chol.py:178", (32, 71_567)),
            ("K2", "chol_sample_packed_slab", "chol_sample_packed_slab.cu",
             "bayesiandatafusion_jl_tpu/ops/pallas_chol.py:269", (64, 71_567)),
            ("K5", "chol_inv", "chol_inv.cu",
             "bayesiandatafusion_jl_tpu/ops/pallas_chol.py:389",
             (64, 71_567))):
        r = checks[(tag, *shape)]
        rows.append({"name": name, "route": "cuda", "source": src + source,
                     "replaces": replaces, "launches": launches[tag],
                     "max_abs_err": r["kernel_err"], "ms": r["kernel_ms"],
                     "plain_ms": r["plain_ms"]})
    print(nvidia_smi_line())
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
