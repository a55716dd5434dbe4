"""Engine configuration (port of ``bayesiandatafusion_jl_tpu/utils/config.py``).

The fields keep the JAX package's names, meanings and defaults, except
that ``dense_int8`` defaults to True: the int8 pair store is the only
Gramian path this port has.  The JAX options the port does not implement
yet are not fields: passing one raises ``NotImplementedError`` naming its
ROADMAP item, whether through ``MacauConfig(...)`` or ``macau(**kwargs)``.
The TPU layout knobs (``pallas``, ``gram_dtype``, bucket widths...) are
absent altogether.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


# Fields of the JAX package's MacauConfig that the port has no counterpart
# for yet, with their ROADMAP items.  The TPU layout knobs are not listed:
# the port has no use for them.
UNPORTED_FIELDS = {
    **dict.fromkeys(("lambda_beta", "sample_lambda_beta", "nu_beta",
                     "lambda_beta_mean", "use_ff", "ff_threshold",
                     "beta_solver", "dual_budget_gb", "dual_cache_dir",
                     "dual_refine", "cg_tol", "cg_maxiter",
                     "cg_nystrom_rank"), "M8"),
    **dict.fromkeys(("alpha_a0", "alpha_b0"), "M7"),
    **dict.fromkeys(("dense_gram", "accumulation"), "M6"),
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

    # the int8 pair store; False (the float pair) is ROADMAP M3
    dense_int8: bool = True

    def __new__(cls, *args, **kwargs):
        absent = [f"{k} (ROADMAP {UNPORTED_FIELDS[k]})" for k in kwargs
                  if k in UNPORTED_FIELDS]
        if absent:
            raise NotImplementedError("not ported yet: " + "; ".join(absent))
        return super().__new__(cls)

    def __post_init__(self):
        if self.dtype not in ("float32", "float64"):
            raise ValueError(f"unsupported dtype {self.dtype!r}")
        if not self.dense_int8:
            raise NotImplementedError(
                "not ported yet: float dense pair (dense_int8=False) "
                "(ROADMAP M3)")

    def np_dtype(self):
        return np.dtype(self.dtype)

    def resolved_nu0(self) -> float:
        return float(self.num_latent if self.nw_nu0 is None else self.nw_nu0)
