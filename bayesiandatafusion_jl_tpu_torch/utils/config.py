"""Engine configuration (port of ``bayesiandatafusion_jl_tpu/utils/config.py``).

The fields keep the JAX package's names, meanings and defaults, except
that ``dense_int8`` defaults to True: the int8 pair store is the only
dense Gramian this port has.  The JAX options the port does not implement
yet are not fields: passing one raises ``NotImplementedError`` naming its
ROADMAP item, whether through ``MacauConfig(...)`` or ``macau(**kwargs)``.
The TPU-only knobs (``pallas``, ``dense_gram_budget_gb``) are absent
altogether.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np


# Fields of the JAX package's MacauConfig that the port has no counterpart
# for yet, with their ROADMAP items.  The TPU-only knobs are not listed:
# the port has no use for them.
UNPORTED_FIELDS = {
    **dict.fromkeys(("lambda_beta", "sample_lambda_beta", "nu_beta",
                     "lambda_beta_mean", "use_ff", "ff_threshold",
                     "beta_solver", "dual_budget_gb", "dual_cache_dir",
                     "dual_refine", "cg_tol", "cg_maxiter",
                     "cg_nystrom_rank"), "M8"),
    **dict.fromkeys(("alpha_a0", "alpha_b0"), "M7"),
    **dict.fromkeys(("dense_fused", "dense_fused_tol"), "M9"),
    **dict.fromkeys(("metrics_every", "sweeps_per_dispatch", "trace_dir"),
                    "M4"),
    **dict.fromkeys(("log_file", "output_prefix", "checkpoint_every",
                     "checkpoint_path"), "M10"),
    **dict.fromkeys(("exchange_blocks", "head_split_degree"), "M11"),
}


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
    # noise precision of every relation (fixed; sampling is ROADMAP M7)
    alpha: float = 5.0
    alpha_sample: bool = False

    init_std: float = 0.3   # U ~ init_std * N(0, I)
    dtype: str = "float32"  # "float64" for the CPU parity tests
    chol_jitter: float = 0.0

    # Gramian path: None or True = the dense int8 pair (ops/dense_gram.py);
    # False = every mode on the bucketed gather path (ops/layout.py,
    # ops/gramian.py).  The JAX package's None is an auto planner on
    # TPU-measured constants; the port has no H100 planner yet (ROADMAP
    # M6), so None keeps the pair.
    dense_gram: Optional[bool] = None
    # the int8 pair store; False (the float pair) is ROADMAP M3.  The
    # gather path does not read it.
    dense_int8: bool = True

    # --- gather path ---
    # partner gather/contraction dtype: None = compute dtype; "bfloat16"
    # gathers in bf16 and contracts with float32 accumulation and output
    gram_dtype: Optional[str] = None
    bucket_widths: Sequence[int] = (8, 16, 32, 64, 128, 256, 512, 1024,
                                    2048)
    # Gramian-row accumulation: "segment" = one segment sum over all
    # buckets' rows; "planned" = static first-row gather + overflow sum
    accumulation: str = "segment"
    row_pad: int = 8  # pad bucket rows to a multiple of this

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
        if not self.dense_int8 and self.dense_gram is not False:
            raise NotImplementedError(
                "not ported yet: float dense pair (dense_int8=False) "
                "(ROADMAP M3)")

    def np_dtype(self):
        return np.dtype(self.dtype)

    def resolved_nu0(self) -> float:
        return float(self.num_latent if self.nw_nu0 is None else self.nw_nu0)
