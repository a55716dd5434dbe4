"""Engine configuration (port of ``bayesiandatafusion_jl_tpu/utils/config.py``).

The fields keep the JAX package's names, meanings and defaults.  The JAX
options the port does not implement yet are not fields: passing one
raises ``NotImplementedError`` naming its ROADMAP item, whether through
``MacauConfig(...)`` or ``macau(**kwargs)``.
The TPU-only knobs (``pallas``, ``dense_gram_budget_gb``) are absent
altogether.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np


# Fields of the JAX package's MacauConfig that the port has no counterpart
# for yet, with their ROADMAP items: the sharded engine's.  The TPU-only
# knobs are not listed: the port has no use for them.
UNPORTED_FIELDS = dict.fromkeys(("exchange_blocks", "head_split_degree"),
                                "M11")


@dataclasses.dataclass(frozen=True)
class MacauConfig:
    num_latent: int = 10
    burnin: int = 500
    psamples: int = 200
    # clamp predictions per posterior sample, before averaging
    clamp: Optional[Tuple[float, float]] = None
    verbose: bool = True
    seed: int = 1234

    # Normal-Wishart hyperprior: mu0 = 0, b0, W0 = I, nu0 (None = K)
    nw_b0: float = 2.0
    nw_nu0: Optional[float] = None
    # link-matrix precision lambda_beta of an entity with side features:
    # its initial value, and (``sample_lambda_beta``) its Gamma hyperprior,
    # drawn each sweep from Gamma((nu_beta + F K)/2, rate = (nu_beta /
    # lambda_beta_mean + tr(beta' beta Lambda)) / 2)
    lambda_beta: float = 1.0
    sample_lambda_beta: bool = True
    nu_beta: float = 1e-3
    lambda_beta_mean: float = 1.0
    # noise precision of every relation: fixed, or (``alpha_sample``, or
    # ``RelationData.set_precision(..., sample=True)``) drawn each sweep
    # from Gamma(alpha_a0 + nnz/2, rate = alpha_b0 + SSE/2)
    alpha: float = 5.0
    alpha_sample: bool = False
    alpha_a0: float = 1e-3
    alpha_b0: float = 1e-3

    init_std: float = 0.3   # U ~ init_std * N(0, I)
    dtype: str = "float32"  # "float64" for the CPU parity tests
    chol_jitter: float = 0.0

    # Gramian path: None or True = the dense pair (ops/dense_gram.py) for
    # every relation with observations; False = every mode on the bucketed
    # gather path (ops/layout.py, ops/gramian.py).  The JAX package's None
    # is an auto planner on TPU-measured constants that can mix dense and
    # gather modes; the engine takes such a mix (an entity sums dense and
    # gather contributions), but the port has no H100 planner yet
    # (ROADMAP M6-rest), so None keeps the pair.
    dense_gram: Optional[bool] = None
    # int8 operands on the dense paths: True stores the int8 pair (K6 and
    # K7) for a relation that passes ``int8_pair_ok`` and puts a fused
    # relation on the s8 kernels; False (the JAX default) stores the float
    # pair (in ``gram_dtype``, else the compute dtype) and puts a fused
    # relation on the float kernels.  The gather path does not read it.
    dense_int8: bool = False
    # the fused sparse regime (ops/dense_gram.py, second half): one stored
    # int8 value array V8 instead of the pair, the mask derived on the fly.
    # True = wherever ``fused_pair_plan`` encodes the relation (the pair
    # otherwise); None or False = the pair.  The JAX package's
    # None is an auto rule on a TPU HBM budget (``dense_gram_budget_gb``);
    # the port has no H100 planner yet (ROADMAP M6-rest), as for
    # ``dense_gram``.
    dense_fused: Optional[bool] = None
    # bounded-error grids for continuous values: admit the finest uniform
    # int8 grid whose rounding error s/2 <= dense_fused_tol (None = exact
    # grids only); the JAX package's contract (``fused_pair_plan``)
    dense_fused_tol: Optional[float] = None

    # --- gather path, the fused residual, the float pair and fused table ---
    # partner gather/contraction dtype: None = compute dtype; "bfloat16"
    # gathers in bf16 and contracts with float32 accumulation and output
    gram_dtype: Optional[str] = None
    bucket_widths: Sequence[int] = (8, 16, 32, 64, 128, 256, 512, 1024,
                                    2048)
    # Gramian-row accumulation: "segment" = one segment sum over all
    # buckets' rows; "planned" = static first-row gather + overflow sum
    accumulation: str = "segment"
    row_pad: int = 8  # pad bucket rows to a multiple of this

    # --- the beta draw of an entity with side features (ops/dual.py,
    # ops/cg.py, ops/precond.py) ---
    # the direct X'X path ("ff"): None = where F <= ff_threshold (an
    # entity's own ``use_ff`` overrides)
    use_ff: Optional[bool] = None
    ff_threshold: int = 4096
    # off the FF path: None = the Woodbury "dual" solve on an
    # eigendecomposition of XX' where N < F, F >= 4096 and Q and G fit
    # dual_budget_gb (``use_dual``), else blocked CG; or "cg" / "dual"
    beta_solver: Optional[str] = None
    dual_budget_gb: float = 4.0
    # a directory to keep the XX' eigendecomposition in, keyed by a hash
    # of the features; None = decompose at every engine build
    dual_cache_dir: Optional[str] = None
    # refinement steps of the dual solve against the exact G
    dual_refine: int = 1
    # CG's relative residual (floored at 1e-5 in float32) and its limit
    cg_tol: float = 1e-6
    cg_maxiter: int = 200
    # the Nystrom preconditioner's rank: None = auto (1024 for F >= 16384,
    # 512 for F >= 8192), 0 = Jacobi; skipped when F < 4 x the rank
    cg_nystrom_rank: Optional[int] = None

    # --- the driver loop (``MacauEngine.run``) ---
    # read the sweeps' metrics back to the host every N sweeps (1 = every
    # sweep, the reference's behaviour; the last sweep always, and every
    # sweep under verbose, a callback or a log_file).  Each read waits for
    # the device; the sweeps between stay queued on it
    metrics_every: int = 1
    # dispatch up to N sweeps back to back as one window, with no host read
    # inside it and their metrics kept on the device until its end
    # (1 = one sweep a window).  Windows end at every sweep whose host
    # work needs that sweep's state: a checkpoint, a posterior-sample
    # dump, the traced sweep.  The results are bit-identical to N = 1
    sweeps_per_dispatch: int = 1
    # jsonl record of every sweep ({"sweep", "phase", metrics...}),
    # appended; None = off
    log_file: Optional[str] = None
    # posterior-sample dumps in the psamples phase, for out-of-matrix
    # prediction (``predict_out_of_matrix``): {prefix}-sampleNNNN.npz
    output_prefix: Optional[str] = None
    # a torch.profiler trace (Chrome format) of one sweep, min(2, total - 1),
    # written into this directory; None = off
    trace_dir: Optional[str] = None
    # every N sweeps save the state to checkpoint_path (the JAX package's
    # npz layout); 0 = off.  Resume with MacauEngine.load_state and
    # run(state=..., sweep_offset=...)
    checkpoint_every: int = 0
    checkpoint_path: Optional[str] = None

    def __new__(cls, *args, **kwargs):
        absent = [f"{k} (ROADMAP {UNPORTED_FIELDS[k]})" for k in kwargs
                  if k in UNPORTED_FIELDS]
        if absent:
            raise NotImplementedError("not ported yet: " + "; ".join(absent))
        return super().__new__(cls)

    def __post_init__(self):
        if self.dtype not in ("float32", "float64"):
            raise ValueError(f"unsupported dtype {self.dtype!r}")
        if self.accumulation not in ("segment", "planned"):
            raise ValueError(f"unknown accumulation {self.accumulation!r}")
        if self.gram_dtype not in (None, "bfloat16"):
            raise ValueError(f"unsupported gram_dtype {self.gram_dtype!r}")

    def np_dtype(self):
        return np.dtype(self.dtype)

    def resolved_nu0(self) -> float:
        return float(self.num_latent if self.nw_nu0 is None else self.nw_nu0)
