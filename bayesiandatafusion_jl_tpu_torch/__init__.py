"""Bayesian data fusion (BPMF and Macau Gibbs sampling) on PyTorch and CUDA.

A port of ``bayesiandatafusion_jl_tpu`` (JAX on a TPU), which stays the
reference.  This package imports torch and numpy only — never jax
or the JAX package.  It covers graphs of relations of any arity, with
fixed or sampled noise precisions, at any rank K; entities may carry side
features (``Entity(F=...)``: the link matrix beta drawn each sweep by the
FF, dual or CG solver), and relations a ``class_cut`` (their test AUC).
The dense pair, fused and gather Gramian paths and the Cholesky samplers
run CUDA kernels for ``sm_90a``, built from ``csrc/`` at first use.

The driver (``MacauEngine.run``) takes the JAX package's options: windows
of sweeps with no host read inside (``sweeps_per_dispatch``), gated metric
reads (``metrics_every``), a jsonl log, a ``torch.profiler`` trace,
posterior-sample dumps for ``predict_out_of_matrix``, and checkpoints
(``save_state`` / ``load_state``, the JAX package's file layout) from which
``run(sweep_offset=...)`` resumes the chain bit for bit.  The export list
is the JAX package's: with the sparse file readers and writers (SBM1,
SBF1, MatrixMarket) and ``predictions_frame``.  See ROADMAP.md for what is
still to port.
"""

from .models.data import (Entity, EntityModel, IndexedDF, Relation,
                          RelationData, RelationModel)
from .models.engine import (CompiledProblem, MacauEngine, macau,
                            predict_out_of_matrix, predictions_frame)
from .ops.sparse import (SparseBinMatrix, read_matrix_market,
                         read_sparse_binary, read_sparse_float64,
                         write_matrix_market, write_sparse_binary,
                         write_sparse_float64)
from .utils.config import MacauConfig

__version__ = "0.1.0"

__all__ = [
    "Entity", "EntityModel", "IndexedDF", "Relation", "RelationData",
    "RelationModel", "macau", "MacauEngine", "MacauConfig",
    "CompiledProblem", "SparseBinMatrix", "predict_out_of_matrix",
    "predictions_frame",
    "read_sparse_binary", "write_sparse_binary",
    "read_sparse_float64", "write_sparse_float64",
    "read_matrix_market", "write_matrix_market",
]
