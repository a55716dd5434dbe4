"""The PD ridge's float32 step summed in XLA:CPU's order, for the port's
parity tests (jax-free, so the GPU tests can use it too).  Test files
import it as ``_torch_xla_order``: pytest puts this directory on the path.

The JAX engine's compiled sweep takes mean(s) * sqrt(K) / 2 over the
C = K(K+1)/2 row scales with XLA:CPU's reduction: sequential sums over
32-wide windows, the first padded by half the slack, repeated while more
than 32 partial sums remain, then one sequential sum; 1/C and sqrt(K)/2 are
folded into one float32 constant.  The port's ``ops/dense_gram.ridge_step``
sums with torch, which rounds differently in the last bit.  Patched in with
``monkeypatch.setattr(dense_gram, "ridge_step", xla_cpu_ridge_step)``, this
makes the float64 slice match the JAX engine to ~1e-15 instead of drifting
from 1e-9 to 2e-7 in 3 sweeps, and makes the CPU and CUDA chains take the
same step.
"""
import numpy as np
import torch


def xla_cpu_ridge_step(s: torch.Tensor, K: int) -> torch.Tensor:
    f32 = torch.float32
    c = (torch.tensor(1.0 / s.numel(), dtype=f32)
         * torch.tensor(0.5 * float(np.sqrt(K)), dtype=f32)).to(s.device)
    x = s
    while x.numel() > 32:
        m = x.numel()
        total = -(-m // 32) * 32
        lo = (total - m) // 2
        win = torch.nn.functional.pad(x, (lo, total - m - lo)).view(-1, 32)
        x = win[:, 0]
        for i in range(1, 32):
            x = x + win[:, i]
    acc = x[0]
    for i in range(1, x.numel()):
        acc = acc + x[i]
    return acc * c
