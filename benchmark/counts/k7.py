"""K7, the partner table's int8 quantization (ops/ytab.py): one launch (two
passes) a focus mode, over the partner's rows.  Bytes: the rows read twice
(one pass each), the [C + K, n] codes written once.  Operations: ~10 a
table cell (product, |.|, max, divide, round, clip) on the float32 units."""

RATE = "f32_flop_s"


def stored(shape):
    """The stores' extents, padded to multiples of 16."""
    return [-(-int(d) // 16) * 16 for d in shape]


def tri(K):
    return K * (K + 1) // 2


def launches(shape, nnz, K):
    ck = tri(K) + K
    b = sum(2 * 4 * n * K + ck * n for n in shape)
    ops = sum(10 * ck * n for n in shape)
    return [(("ytab_",), b, ops, RATE)]
