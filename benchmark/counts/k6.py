"""K6, the int8 pair contraction (ops/pair_contract.py): one launch a focus
mode.  Bytes: the stored M8 and W8 and the partner table read once, the
float32 outputs (C + K rows of the focus count) written once.  Operations:
a multiply-add into each of the C + K outputs for each observed cell, the
work these data need (the zero cells add nothing)."""

RATE = "int8_op_s"


def stored(shape):
    """The stores' extents, padded to multiples of 16."""
    return [-(-int(d) // 16) * 16 for d in shape]


def tri(K):
    return K * (K + 1) // 2


def launches(shape, nnz, K):
    """[(kernel-name patterns, bytes, operations, rate key)] a sweep."""
    C, st = tri(K), stored(shape)
    out = []
    for f in (0, 1):
        nbytes = (2 * st[0] * st[1] + (C + K) * st[1 - f]
                  + 4 * (C + K) * shape[f])
        out.append(((f"pair_contract_kernel<{f}",
                     f"pair_contract_kernelILi{f}"),
                    nbytes, 2 * nnz * (C + K), RATE))
    return out
