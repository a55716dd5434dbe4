"""The windowed expand (K9): partner rows for observations sorted by
partner id, gathered one 128-row window of the factor table at a time.

Port of ``bayesiandatafusion_jl_tpu/ops/pallas_gather.py``: the host plan
``build_window_plan`` (:44) and ``windowed_expand`` (:90, TPU kernel
``_kern`` :80), the CUDA kernel ``csrc/windowed_expand.cu``.  With the
observations' partner ids sorted ascending, each block of 1024 output
slots belongs to one 128-row window of the table, and a window with more
observations spans several blocks:

    out[1024 b + s] = U[128 wmap[b] + lanes[b, s]]

the partner rows in partner-sorted slot order (``slot_of_obs`` maps each
observation to its slot; tail slots repeat lane 0).  It is the first half
of a gather design whose second half, the permutation into focus-bucket
order, the JAX package never built; like the JAX engine, the port's
engine does not call it.

Layout: the port keeps factors as U [n_table, K] (row-major), so the
kernel takes them so and writes [n_blocks * 1024, K]; the TPU kernel
takes UT [K, n_table] and writes [K, n_blocks * 1024], its lane layout.
The values are the same, transposed.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import kernels
from ..utils import spans

BS = 1024       # slots per block
WIN = 128       # factor rows per window
# the kernel's widest row: one window of 128 rows in shared memory
K9_MAX_K = 128


def build_window_plan(part: np.ndarray, n_table: int
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The host plan for ``windowed_expand`` (JAX ``build_window_plan``
    :44, with its per-window loop vectorized; the same arrays).

    ``part``: the observations' partner ids, sorted ascending (the caller
    keeps the sort permutation).  Returns ``(lanes [n_blocks, 8, 128]
    int32, wmap [n_blocks] int32, slot_of_obs [n_obs] int64)``: the window
    of each block of 1024 slots, the row within it of each slot (tail
    slots repeat lane 0; callers mask by the observation count), and each
    observation's slot."""
    part = np.asarray(part)
    if np.any(np.diff(part) < 0):
        raise ValueError("observations must be partner-sorted")
    win = part // WIN
    lane = (part % WIN).astype(np.int32)
    n_win = (n_table + WIN - 1) // WIN
    counts = np.bincount(win, minlength=n_win)
    blocks_per_win = -(-counts // BS)
    n_blocks = max(int(blocks_per_win.sum()), 1)
    wmap = np.repeat(np.arange(n_win, dtype=np.int32), blocks_per_win)
    if len(wmap) == 0:
        wmap = np.zeros(1, np.int32)
    # each window's first slot and first observation
    first_slot = np.concatenate([[0], np.cumsum(blocks_per_win)[:-1]]) * BS
    first_obs = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot_of_obs = (first_slot[win] + np.arange(len(part))
                   - first_obs[win]).astype(np.int64)
    lanes = np.zeros(n_blocks * BS, np.int32)
    lanes[slot_of_obs] = lane
    return lanes.reshape(n_blocks, 8, BS // 8), wmap, slot_of_obs


def windowed_expand_plain(U: torch.Tensor, lanes: torch.Tensor,
                          wmap: torch.Tensor) -> torch.Tensor:
    """The plain torch version: ``index_select`` of the rows window * 128 +
    lane from the table zero-padded to a multiple of 128 rows.  Runs on
    any device; returns [n_blocks * 1024, K] in U's dtype."""
    windowed_expand_plain.calls += 1
    n_blocks = wmap.shape[0]
    rows = (wmap.to(torch.int64)[:, None] * WIN
            + lanes.reshape(n_blocks, BS).to(torch.int64)).reshape(-1)
    pad = (-U.shape[0]) % WIN
    if pad:
        U = torch.cat([U, U.new_zeros((pad, U.shape[1]))])
    return U.index_select(0, rows)


windowed_expand_plain.calls = 0
spans.counter(windowed_expand_plain, "calls")


def windowed_expand(U: torch.Tensor, lanes: torch.Tensor,
                    wmap: torch.Tensor) -> torch.Tensor:
    """The expanded partner rows [n_blocks * 1024, K] of the factors U
    [n_table, K] (float32 or bfloat16, K <= 128) for the plan ``lanes``
    ([n_blocks, 8, 128] or [n_blocks, 1024] int32, each in [0, 128)) and
    ``wmap`` ([n_blocks] int32) of ``build_window_plan``.

    CPU tensors run the plain version; CUDA tensors launch the kernel on
    the current stream or raise — there is no fallback.
    ``windowed_expand.launches`` counts the launches."""
    if U.device.type == "cpu":
        return windowed_expand_plain(U, lanes, wmap)
    if U.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {U.device}")
    if (U.dim() != 2 or U.dtype not in (torch.float32, torch.bfloat16)
            or not U.is_contiguous() or U.data_ptr() % 16):
        raise ValueError(f"U must be a contiguous, 16-byte aligned [n, K] "
                         f"float32 or bfloat16 tensor, got {U.dtype} "
                         f"{tuple(U.shape)}")
    n_table, K = U.shape
    if not 1 <= K <= K9_MAX_K or n_table < 1:
        raise ValueError(f"the kernel takes 1 <= K <= {K9_MAX_K} and a "
                         f"nonempty table, got {tuple(U.shape)}")
    n_blocks = wmap.shape[0]
    for name, t, numel in (("lanes", lanes, n_blocks * BS),
                           ("wmap", wmap, n_blocks)):
        if (t.dtype != torch.int32 or not t.is_contiguous()
                or t.numel() != numel or t.device != U.device):
            raise ValueError(f"{name} must be contiguous int32 with {numel} "
                             f"entries on {U.device}")
    if n_blocks < 1:
        raise ValueError("the plan has no block")
    out = torch.empty((n_blocks * BS, K), dtype=U.dtype, device=U.device)
    lib = kernels.load()
    stream = torch.cuda.current_stream(U.device).cuda_stream
    with torch.cuda.device(U.device):
        rc = lib.bdf_windowed_expand(U.data_ptr(), n_table,
                                     K * U.element_size(), lanes.data_ptr(),
                                     wmap.data_ptr(), n_blocks,
                                     out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"windowed expand kernel launch failed: CUDA "
                           f"error {rc}")
    windowed_expand.launches += 1
    return out


windowed_expand.launches = 0
spans.counter(windowed_expand, "launches")
