"""GPU smoke test of the PyTorch/CUDA port, ``bayesiandatafusion_jl_tpu_torch``.

Run from the repository root on a machine with one CUDA card (an H100):

    python3 chip_smoke.py

Phases, each fatal on failure (nonzero exit, no result line):

1. device: a CUDA device is present; its name and power limit;
2. build: ``nvcc`` compiles the port's kernels for sm_90a from ``csrc/``;
3. kernel vs plain: the packed Cholesky sampler's CUDA kernel against its
   plain torch version on random SPD problems at the main path's shapes,
   both held against the float64 plain version;
4. int8 contraction: ``torch._int_mm`` equals a float64 matmul of the same
   codes exactly, at ML-10M shapes;
5. main path: ML-10M-shaped synthetic BPMF (71,567 x 10,681, 10,000,054
   ratings, rank 32, float32) through ``MacauEngine.benchmark(40,
   repeats=3)``; every sweep must sample both entities through the kernel,
   and the RMSEs must lie in the JAX chain's band.

The last two lines are a JSON object describing the kernels and the
``{"ok": true, "device": ...}`` line.
"""
import json
import math
import os
import subprocess
import sys
import time

# the JAX package's chain on the same data and protocol (BENCH_r05.json):
# rmse_sample at sweep 40 and the posterior-mean rmse after 160 sweeps; the
# random streams differ, so they are a chain-noise band, not a parity check
JAX_RMSE_AT_40 = 0.6926
JAX_RMSE_AVG = 0.6567
RMSE_BAND = 0.02
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


def spd_problem(K, B, seed, device="cuda"):
    """float64 packed SPD rows as the main path hands them to the sampler:
    Pp a [C, B] view of a [C, B_stored] buffer, b [K, B], xi [B, K]."""
    import torch
    from bayesiandatafusion_jl_tpu_torch.ops.dense_gram import (
        STORE_ALIGN, tri_index)
    f64 = torch.float64
    g = torch.Generator(device=device).manual_seed(seed)
    iu, ju, _ = tri_index(K, device)
    ld = -(-B // STORE_ALIGN) * STORE_ALIGN
    A = torch.randn((B, K, K), generator=g, dtype=f64, device=device) * 0.3
    buf = torch.zeros((len(iu), ld), dtype=f64, device=device)
    buf[:, :B] = (A @ A.mT)[:, iu, ju].T
    Lam = torch.randn((K, K), generator=g, dtype=f64, device=device) * 0.2
    Lam = Lam @ Lam.T + 2.0 * torch.eye(K, dtype=f64, device=device)
    b = torch.randn((K, B), generator=g, dtype=f64, device=device)
    xi = torch.randn((B, K), generator=g, dtype=f64, device=device)
    return buf[:, :B], b, xi, Lam


def check_chol_kernel(K, B, timing=True, seed=0, jitter=0.25):
    """The CUDA kernel (float32 and float64) and the float32 plain version
    against the float64 plain version on the same inputs."""
    import torch
    from bayesiandatafusion_jl_tpu_torch.ops.chol_packed import (
        chol_sample_packed, chol_sample_packed_plain)
    Pp, b, xi, Lam = spd_problem(K, B, seed)
    ref = chol_sample_packed_plain(Pp, b, xi, Lam, jitter)
    f32 = [t.float() for t in (Pp, b, xi, Lam)]
    Pp32 = torch.zeros((Pp.shape[0], Pp.stride(0)), dtype=torch.float32,
                       device=Pp.device)[:, :B]
    Pp32.copy_(f32[0])                         # keep the strided layout
    args32 = (Pp32, *f32[1:])
    kern = chol_sample_packed(*args32, jitter)
    plain = chol_sample_packed_plain(*args32, jitter)
    kern64 = chol_sample_packed(Pp, b, xi, Lam, jitter)
    torch.cuda.synchronize()
    err_k = (kern.double() - ref).abs().max().item()
    err_p = (plain.double() - ref).abs().max().item()
    err_k64 = (kern64 - ref).abs().max().item()
    r = {"K": K, "B": B, "kernel_err": err_k, "plain_f32_err": err_p,
         "kernel_f64_err": err_k64,
         "ok": bool(torch.isfinite(kern).all().item()
                    and err_k <= KERNEL_ERR_FACTOR * err_p
                    and err_k64 <= F64_KERNEL_TOL)}
    if timing:
        r["kernel_ms"] = cuda_ms(lambda: chol_sample_packed(*args32, jitter),
                                 20)
        r["plain_ms"] = cuda_ms(
            lambda: chol_sample_packed_plain(*args32, jitter), 5)
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from bayesiandatafusion_jl_tpu_torch import kernels
    from bayesiandatafusion_jl_tpu_torch.models.data import RelationData
    from bayesiandatafusion_jl_tpu_torch.models.datasets import \
        load_movielens
    from bayesiandatafusion_jl_tpu_torch.models.engine import MacauEngine
    from bayesiandatafusion_jl_tpu_torch.ops import chol_packed
    from bayesiandatafusion_jl_tpu_torch.ops.dense_gram import (
        int8_matmul, quantize_rows)
    from bayesiandatafusion_jl_tpu_torch.utils.config import MacauConfig

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
    print(f"# build: {rep['seconds']:.1f} s (nvcc sm_90a)", flush=True)
    for line in rep["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"#   {line.strip()}")

    # -- kernel vs plain ----------------------------------------------------
    chol = {}
    for K, B in ((32, 71_567), (32, 10_681), (8, 1_000)):
        r = check_chol_kernel(K, B)
        chol[(K, B)] = r
        print(f"# K1 K={K} B={B}: kernel err {r['kernel_err']:.3e} "
              f"(f32 plain {r['plain_f32_err']:.3e}, f64 kernel "
              f"{r['kernel_f64_err']:.3e}); kernel {r['kernel_ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms", flush=True)
        require(r["ok"], f"kernel disagrees with its plain version: {r}")

    # -- int8 contraction ----------------------------------------------------
    exact = check_int8_contraction()
    print(f"# int8 contraction exact (mode 0, mode 1): {exact}", flush=True)
    require(all(exact), "torch._int_mm is not exact")

    # -- main path -----------------------------------------------------------
    t0 = time.perf_counter()
    df = load_movielens("10m", seed=0)
    rd = RelationData.from_indexed_df(df, relation_name="ratings")
    rd.assign_to_test(0, min(100_000, df.nnz // 10), seed=7)
    print(f"# data: {time.perf_counter() - t0:.1f} s (nnz={df.nnz}, "
          f"shape={df.shape})", flush=True)
    cfg = MacauConfig(num_latent=32, burnin=40, psamples=0, clamp=(1.0, 5.0),
                      verbose=False, dtype="float32", seed=42,
                      dense_int8=True)
    sweeps, repeats = 40, 3
    torch.cuda.reset_peak_memory_stats()
    chol_packed.chol_sample_packed.launches = 0
    chol_packed.chol_sample_packed_plain.calls = 0
    t0 = time.perf_counter()
    eng = MacauEngine(rd, cfg, device="cuda")
    print(f"# engine build: {time.perf_counter() - t0:.1f} s (pair store "
          f"{eng.problem.build_seconds:.1f} s)", flush=True)
    out = eng.benchmark(sweeps, repeats=repeats)
    launches = chol_packed.chol_sample_packed.launches
    plain_calls = chol_packed.chol_sample_packed_plain.calls
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    m = out["metrics"]
    wins = out["ms_per_sweep"]
    med = sorted(wins)[len(wins) // 2]
    n_rows = sum(es.n for es in eng.problem.entity_specs)
    print(f"# main path: ms/sweep per window {wins}, median {med:.3f}; "
          f"rows/s {n_rows / med * 1e3:.1f}; rmse_sample@{sweeps} "
          f"{out['rmse_at_sweeps']:.4f}; rmse_avg {m['r0.rmse_avg']:.4f}; "
          f"peak memory {peak_gb:.2f} GB; K1 launches {launches}; plain "
          f"sampler calls {plain_calls}", flush=True)
    total_sweeps = sweeps * (repeats + 1)
    require(launches == 2 * total_sweeps,
            f"K1 launched {launches} times for {total_sweeps} sweeps")
    require(plain_calls == 0, "the plain sampler ran on the main path")
    vals = [*wins, out["rmse_at_sweeps"], *m.values()]
    require(all(math.isfinite(v) for v in vals), f"non-finite metrics {m}")
    require(abs(out["rmse_at_sweeps"] - JAX_RMSE_AT_40) <= RMSE_BAND,
            f"rmse_sample@40 {out['rmse_at_sweeps']} outside the band")
    require(abs(m["r0.rmse_avg"] - JAX_RMSE_AVG) <= RMSE_BAND,
            f"rmse_avg {m['r0.rmse_avg']} outside the band")

    # the main path's int8 products, timed per mode on its stored pair
    pair = eng.problem.pair
    for mode in range(2):
        Mf = pair["M8"][mode]
        Y8, _ = quantize_rows(torch.randn((528, Mf.shape[1]),
                                          device="cuda"))
        U8, _ = quantize_rows(torch.randn((32, Mf.shape[1]), device="cuda"))
        ms_p = cuda_ms(lambda: int8_matmul(Y8, Mf.mT), 10)
        ms_b = cuda_ms(lambda: int8_matmul(U8, pair["W8"][mode].mT), 10)
        print(f"# _int_mm mode {mode} (focus {Mf.shape[0]}, partner "
              f"{Mf.shape[1]}): P {ms_p:.3f} ms, b {ms_b:.3f} ms",
              flush=True)

    main_k = chol[(32, 71_567)]
    print(nvidia_smi_line())
    print(json.dumps({"kernels": [{
        "name": "chol_sample_packed",
        "route": "cuda",
        "source": "bayesiandatafusion_jl_tpu_torch/csrc/chol_sample_packed.cu",
        "replaces": "bayesiandatafusion_jl_tpu/ops/pallas_chol.py:178",
        "launches": launches,
        "max_abs_err": main_k["kernel_err"],
        "ms": main_k["kernel_ms"],
        "plain_ms": main_k["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
