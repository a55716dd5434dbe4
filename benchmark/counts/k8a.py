"""K8a, the fused s8 contraction (ops/fused_pair.py): one launch a focus
mode.  Bytes: the stored V8 and the partner table read once, the float32
outputs (C + 2K rows of the focus count) written once.  Operations: a
multiply-add into each of the C + 2K outputs for each observed cell."""

RATE = "int8_op_s"


def stored(shape):
    """The stores' extents, padded to multiples of 16."""
    return [-(-int(d) // 16) * 16 for d in shape]


def tri(K):
    return K * (K + 1) // 2


def launches(shape, nnz, K):
    C, st = tri(K), stored(shape)
    out = []
    for f in (0, 1):
        nbytes = (st[0] * st[1] + (C + K) * st[1 - f]
                  + 4 * (C + 2 * K) * shape[f])
        out.append(((f"fused_pair_kernel<{f}", f"fused_pair_kernelILi{f}"),
                    nbytes, 2 * nnz * (C + 2 * K), RATE))
    return out
