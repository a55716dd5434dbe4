"""The randoms of one Gibbs sweep of a two-entity BPMF chain, frozen here so
that the yardstick does not move when the program's generator changes.

The program draws each named stream from a ``torch.Generator`` seeded by
splitmix64 over (chain seed, sweep, crc32(name)); on the same device the
same seed gives the same bits.  The reference regenerates the streams it
needs this way and widens them to float64.
"""
from __future__ import annotations

import zlib
from typing import Dict

import torch


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


def _gen(device, seed: int, sweep: int, name: str) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(_mix(seed, sweep, zlib.crc32(name.encode("utf-8"))))
    return g


def entity_draws(seed: int, sweep: int, ei: int, n: int, K: int, nu0: float,
                 dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    """Entity ``ei``'s streams of sweep ``sweep`` (1-based) in the chain's
    dtype: the Normal-Wishart standard gammas ``nw_g`` [K] (shapes
    (nu0 + n - i) / 2), its normals ``nw_tri`` [K, K] and ``nw_mu`` [K],
    and the rows' normals ``xi`` [n, K]."""
    out = {}
    name = f"e{ei}.nw_g"
    a = torch.tensor(tuple((nu0 + n - i) / 2.0 for i in range(K)),
                     dtype=dtype).to(device)
    out["nw_g"] = torch._standard_gamma(a.contiguous(),
                                        generator=_gen(device, seed, sweep,
                                                       name))
    for key, shape in (("nw_tri", (K, K)), ("nw_mu", (K,)), ("xi", (n, K))):
        out[key] = torch.randn(shape, generator=_gen(device, seed, sweep,
                                                     f"e{ei}.{key}"),
                               dtype=dtype, device=device)
    return out


def initial_factors(seed: int, sizes, K: int, init_std: float,
                    dtype: torch.dtype, device):
    """The chain's starting rows: init_std * N(0, I) for each entity in
    turn, from one generator seeded by the chain seed."""
    g = torch.Generator(device=device).manual_seed(seed)
    return [init_std * torch.randn((n, K), generator=g, dtype=dtype,
                                   device=device) for n in sizes]
