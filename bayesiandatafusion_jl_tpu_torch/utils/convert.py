"""Carry a sampler state between the JAX package and the port.

Both engines keep the state as the same nested structure —
``{"ent": [{"U", "mu", "Lambda", ...}], "rel": [{"alpha"}],
"pred": {"r0": {"sum", "sum2", "n"}}}`` — the JAX one as arrays, the port
as tensors.  A JAX state enters here as numpy (``jax.device_get``).  No
Gramian path adds to it: the fused path's store, its residual layouts and
its float tables belong to the compiled problem, not to the state.
"""
from __future__ import annotations

import numpy as np
import torch


def state_from_numpy(state_np, device, dtype: torch.dtype):
    """Nested dicts/lists of numpy arrays -> the same of tensors on
    ``device``; floating arrays are cast to ``dtype``."""
    if isinstance(state_np, dict):
        return {k: state_from_numpy(v, device, dtype)
                for k, v in state_np.items()}
    if isinstance(state_np, (list, tuple)):
        return [state_from_numpy(v, device, dtype) for v in state_np]
    t = torch.from_numpy(np.array(state_np))   # a writable host copy
    if t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def state_to_numpy(state):
    """The port's state as nested numpy arrays (copied to the host)."""
    if isinstance(state, dict):
        return {k: state_to_numpy(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return [state_to_numpy(v) for v in state]
    return state.detach().cpu().numpy()
