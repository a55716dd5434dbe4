"""K1/K2, the packed samplers (ops/chol_packed.py), and K3/K4, the full-P
samplers (ops/chol_full.py): one launch an entity.  Bytes: each row's
triangle, b and xi (and Lambda) read once, u written once.  Operations: a
factorization (K^3/3) and two triangular solves (2 K^2) a row."""

RATE = "f32_flop_s"


def stored(shape):
    """The stores' extents, padded to multiples of 16."""
    return [-(-int(d) // 16) * 16 for d in shape]


def tri(K):
    return K * (K + 1) // 2


def _bound(K, B):
    return 4 * (B * (tri(K) + 3 * K) + K * K), B * (K ** 3 / 3 + 2 * K * K)


def launches(shape, nnz, K):
    if K > 96:
        return []
    b = [_bound(K, n) for n in shape]
    nbytes, ops = sum(x[0] for x in b), sum(x[1] for x in b)
    return [(("chol_sample_packed",), nbytes, ops, RATE),
            (("chol_sample_full",), nbytes, ops, RATE)]
