"""Bayesian data fusion (BPMF Gibbs sampling) on PyTorch and CUDA.

A port of ``bayesiandatafusion_jl_tpu`` (JAX on a TPU), which stays the
reference.  This package imports torch and numpy only — never jax
or the JAX package.  It covers the main path so far: one 2-ary relation,
the dense int8 pair Gramian and the packed Cholesky sampler (a CUDA kernel
for ``sm_90a``, built from ``csrc/`` at first use).  See ROADMAP.md for
what is still to port.
"""

from .models.data import Entity, IndexedDF, Relation, RelationData
from .models.engine import CompiledProblem, MacauEngine, macau
from .utils.config import MacauConfig

__version__ = "0.1.0"

__all__ = [
    "Entity", "IndexedDF", "Relation", "RelationData", "macau",
    "MacauEngine", "MacauConfig", "CompiledProblem",
]
