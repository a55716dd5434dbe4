"""K5, the diagonal panels' factor-and-invert of the blocked sampler
(ops/chol_blocked.py), above K = 96: one launch a 64-wide panel and
entity.  Bytes: each panel's triangle read once, its full inverse factor
written once.  Operations: factor (B^3/3) and invert (B^3/3)."""

RATE = "f32_flop_s"


def stored(shape):
    """The stores' extents, padded to multiples of 16."""
    return [-(-int(d) // 16) * 16 for d in shape]


def tri(K):
    return K * (K + 1) // 2
PANEL = 64


def launches(shape, nnz, K):
    if K <= 96:
        return []
    panels = -(-K // PANEL)
    nbytes = sum(panels * 4 * n * (tri(PANEL) + PANEL * PANEL)
                 for n in shape)
    ops = sum(panels * n * (2 * PANEL ** 3 / 3) for n in shape)
    return [(("chol_inv",), nbytes, ops, RATE)]
