"""Process groups and the hash partition of the sharded engine.

Port of ``bayesiandatafusion_jl_tpu/parallel/mesh.py`` on
``torch.distributed``: one process per device, NCCL between CUDA devices
and gloo between CPU processes.  The JAX package's 1-D mesh over every
chip becomes the default process group (or a group the caller passes);
each rank holds one shard of every entity's instances.
"""
from __future__ import annotations

import datetime
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist


def backend_for(device) -> str:
    """The collective backend of a device: NCCL for CUDA, gloo for the
    CPU."""
    kind = torch.device(device).type
    if kind == "cuda":
        return "nccl"
    if kind == "cpu":
        return "gloo"
    raise ValueError(f"no collective backend for device {device}")


def initialize_distributed(init_method: str, world_size: int, rank: int,
                           device="cuda", local_rank: Optional[int] = None,
                           timeout_s: Optional[float] = None
                           ) -> torch.device:
    """Join the default process group (``jax.distributed.initialize``'s
    counterpart) and return this rank's device: ``cuda:<local_rank>``
    (``rank`` by default) on NCCL, or the CPU on gloo.  ``init_method`` is
    the rendezvous, ``tcp://<host>:<port>`` or ``file://<path>``; nothing
    finds it from the environment.  Call it once in every process before
    building the engine, at world size 1 too."""
    backend = backend_for(device)
    dev = torch.device("cpu")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for an NCCL process group")
        dev = torch.device("cuda", rank if local_rank is None
                           else local_rank)
        torch.cuda.set_device(dev)
    kw = {} if timeout_s is None else {
        "timeout": datetime.timedelta(seconds=timeout_s)}
    if backend == "nccl":
        kw["device_id"] = dev       # binds the rank's card (its barriers)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank, **kw)
    return dev


def data_group(group=None) -> Tuple[Optional[dist.ProcessGroup], int]:
    """(group, its world size): the data axis the sharded engine
    partitions over (``data_mesh``'s counterpart), the default group unless
    one is given.  Raises when no process group is initialized: the
    sharded engine never falls back to one device."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "the sharded engine needs an initialized process group: call "
            "parallel.mesh.initialize_distributed (or "
            "torch.distributed.init_process_group) in every process first")
    return group, dist.get_world_size(group)


def instance_permutation(n: int, entity_index: int) -> np.ndarray:
    """Deterministic hash-partition permutation of instance ids, the JAX
    package's bit for bit: independent of the world size (so factor state
    is comparable across world sizes and resumable on another), and
    pseudo-random, so each contiguous shard's observation count is
    balanced in expectation.  Returns ``perm`` with ``perm[position] =
    original_id``."""
    rng = np.random.default_rng(0xB0F + entity_index)
    return rng.permutation(n).astype(np.int64)
