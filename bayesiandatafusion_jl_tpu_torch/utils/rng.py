"""Randoms for one sweep, with the JAX package's injection seam.

Port of ``bayesiandatafusion_jl_tpu/utils/rng.py`` and of
``models/engine.build_random_spec``.  Every sampler reads its Gaussian and
standard-Gamma draws from a dict of named tensors built before the sweep.
On the device, ``draw_all`` fills it from a ``torch.Generator`` seeded per
(run seed, sweep, crc32(name)), so each stream is independent of draw
order; the streams are not JAX's threefry bits.  The parity tests instead
build the dict with ``draw_all_numpy`` and hand the same numbers to both
engines.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DrawSpec:
    """One named random draw: standard normal or standard gamma."""

    kind: str  # "normal" | "gamma"
    shape: Tuple[int, ...]
    # for gamma: static shape parameter(s), broadcastable to `shape`
    gamma_a: Optional[Tuple[float, ...]] = None


RandomSpec = Dict[str, DrawSpec]


def build_random_spec(entity_sizes: Sequence[int], K: int, nu0: float,
                      rel_specs: Sequence = (), alpha_a0: float = 0.0
                      ) -> RandomSpec:
    """Shapes of one sweep's draws for featureless entities — the keys,
    shapes and Gamma parameters of the JAX ``engine.build_random_spec``
    (:459-488) for the same graph: per entity its Normal-Wishart draws and
    the latent rows' normals; per relation of ``rel_specs`` (objects with
    ``alpha_sample`` and ``nnz``) whose alpha is sampled, the standard
    Gamma(alpha_a0 + nnz/2) variate ``r{ri}.alpha_g``.  (Side features add
    draws there; they are ROADMAP M8.)"""
    spec: RandomSpec = {}
    for ei, N in enumerate(entity_sizes):
        nu_star = nu0 + N
        spec[f"e{ei}.nw_g"] = DrawSpec(
            "gamma", (K,), tuple((nu_star - i) / 2.0 for i in range(K)))
        spec[f"e{ei}.nw_tri"] = DrawSpec("normal", (K, K))
        spec[f"e{ei}.nw_mu"] = DrawSpec("normal", (K,))
        spec[f"e{ei}.xi"] = DrawSpec("normal", (N, K))
    for ri, rs in enumerate(rel_specs):
        if rs.alpha_sample:
            spec[f"r{ri}.alpha_g"] = DrawSpec(
                "gamma", (), (alpha_a0 + rs.nnz / 2.0,))
    return spec


def _name_salt(name: str) -> int:
    return zlib.crc32(name.encode("utf-8"))


def _mix(*words: int) -> int:
    """splitmix64 over the words: a 63-bit generator seed."""
    h = 0
    for w in words:
        h = (h ^ (w & 0xFFFFFFFFFFFFFFFF)) + 0x9E3779B97F4A7C15
        h &= 0xFFFFFFFFFFFFFFFF
        h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
        h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        h ^= h >> 31
    return h >> 1


def draw_all(seed: int, sweep: int, spec: RandomSpec, dtype: torch.dtype,
             device) -> Dict[str, torch.Tensor]:
    """Build one sweep's randoms on ``device``."""
    gen = torch.Generator(device=device)
    out = {}
    for name, d in spec.items():
        gen.manual_seed(_mix(seed, sweep, _name_salt(name)))
        if d.kind == "normal":
            out[name] = torch.randn(d.shape, generator=gen, dtype=dtype,
                                    device=device)
        elif d.kind == "gamma":
            # a host tensor copied without a stream sync
            a = torch.tensor(d.gamma_a, dtype=dtype).to(device,
                                                         non_blocking=True)
            a = a.reshape(-1).expand(d.shape) if d.shape else a.reshape(())
            out[name] = torch._standard_gamma(a.contiguous(), generator=gen)
        else:
            raise ValueError(f"unknown draw kind {d.kind}")
    return out


def draw_all_numpy(rng: np.random.Generator, spec: RandomSpec,
                   dtype=np.float64) -> Dict[str, np.ndarray]:
    """The same-shaped randoms with NumPy (the injection seam); identical to
    the JAX package's ``draw_all_numpy`` for the same generator state."""
    out = {}
    for name, d in spec.items():
        if d.kind == "normal":
            out[name] = rng.standard_normal(d.shape).astype(dtype)
        elif d.kind == "gamma":
            a = np.asarray(d.gamma_a, np.float64).reshape(-1)
            a = np.broadcast_to(a, d.shape) if d.shape else a[0]
            g = rng.gamma(shape=a, scale=1.0)
            out[name] = np.asarray(g, dtype).reshape(d.shape)
        else:
            raise ValueError(f"unknown draw kind {d.kind}")
    return out
