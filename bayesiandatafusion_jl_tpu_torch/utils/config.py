"""Engine configuration (port of ``bayesiandatafusion_jl_tpu/utils/config.py``).

The fields keep the JAX package's names, meanings and defaults, but for
``dense_gram_budget_gb``, whose default is the card's.  Every JAX option
is a field; the TPU-only knob ``pallas`` is absent altogether (a JAX YAML
file's ``pallas: auto`` is dropped on reading).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np


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

    # Gramian path of each (relation, mode) (ops/dense_gram.py's planner):
    # None = plan it: from 50,000 observations a mode contracts against its
    # relation's dense pair (ops/dense_gram.py) where that is predicted
    # faster than 0.7 x the bucketed gather path (ops/layout.py,
    # ops/gramian.py) on the card's measured rates and the pair fits the
    # budget, else it rides the gather path; True = every mode dense, within
    # the budget; False = every mode on the gather path
    dense_gram: Optional[bool] = None
    # the bytes the dense stores (pairs, fused arrays) may take, in GB: a
    # fixed number, not read from the device, so that a plan depends on the
    # problem alone.  16 GB on an 80 GB H100 (the JAX package's 9.0 is a
    # TPU's): under the Netflix-shaped int8 pair's 17.1 GB, which runs no
    # faster than its 8.5 GB fused store (PERF.md §6), and leaving the
    # sweep's transients 64 GB
    dense_gram_budget_gb: float = 16.0
    # int8 operands on the dense paths: True stores the int8 pair (K6 and
    # K7) for a relation that passes ``int8_pair_ok`` and puts a fused
    # relation on the s8 kernels; False (the JAX default) stores the float
    # pair (in ``gram_dtype``, else the compute dtype) and puts a fused
    # relation on the float kernels.  The gather path does not read it.
    dense_int8: bool = False
    # the fused sparse regime (ops/dense_gram.py, second half): one stored
    # int8 value array V8 of a 2-ary relation instead of the pair, the mask
    # derived on the fly.  True = wherever ``fused_pair_plan`` encodes the
    # relation, within the budget; None = plan it: from 50,000 observations
    # where the relation's pair does not fit ``dense_gram_budget_gb``, the
    # one array does, and its contraction is predicted faster than 0.7 x
    # the gather path; False = never
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

    # --- the sharded engine (parallel/sharded.py); the single-device engine
    # ignores both ---
    # sample and exchange each rank's rows in this many blocks, so that
    # block b's all-gather overlaps block b+1's sampling.  None = auto (4
    # blocks when the world has more than one rank and every shard holds
    # 4096 rows or more: ``resolve_exchange_blocks``); 1 = off
    exchange_blocks: Optional[int] = None
    # instances whose gather-path degree exceeds this threshold have their
    # observations dealt round-robin to every rank, into ghost slots whose
    # Gramians are summed over the ranks (head-entity splitting).  "auto" =
    # when one instance's degree exceeds a quarter of a rank's average
    # gather work (``resolve_head_split``); None = off; an int = explicit
    head_split_degree: Union[int, str, None] = "auto"

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

    # -- file-based config: the JAX package's YAML layout ------------------
    @classmethod
    def from_yaml(cls, path: str) -> "MacauConfig":
        """The config a YAML file holds (``to_yaml``'s, or the JAX
        package's).  A JAX file's TPU-only ``pallas`` key is dropped where
        it holds its default, "auto", and refused otherwise; every other
        key goes to the constructor as it is.  Needs PyYAML."""
        import yaml
        with open(path) as f:
            data = yaml.safe_load(f) or {}
        if "pallas" in data:
            if data["pallas"] != "auto":
                raise ValueError(f"pallas={data['pallas']!r} is a TPU "
                                 f"option: the port runs no Pallas kernel")
            del data["pallas"]
        for k in ("clamp", "bucket_widths"):
            if k in data and data[k] is not None:
                data[k] = tuple(data[k])
        return cls(**data)

    def to_yaml(self, path: str) -> None:
        """Write the config as YAML, every field, as the JAX package
        writes its own.  Needs PyYAML."""
        import yaml
        d = dataclasses.asdict(self)
        d["clamp"] = list(self.clamp) if self.clamp else None
        d["bucket_widths"] = list(self.bucket_widths)
        with open(path, "w") as f:
            yaml.safe_dump(d, f, sort_keys=False)
