"""Per-instance precision and right-hand side over bucketed observations
(the gather path), and test-tuple prediction.

Port of ``bayesiandatafusion_jl_tpu/ops/gramian.py``: ``bucket_gramian``
:38, ``assemble_precision`` :118, ``packed_bucket_accum`` :175,
``plan_accumulation`` :253,
``assemble_precision_planned`` :296 and ``predict_tuples`` :333.  For
entity rows i with observations o,

    P_i = Lambda + sum_r alpha_r sum_{o in Omega_i^r} z_o z_o^T
    b_i = Lambda mu  + sum_r alpha_r sum_o (v_o - mean_r) z_o

where z_o is the product of the other modes' latent rows.  Per bucket of
the layout (ops/layout.py) the partner rows are gathered into a
[rows, W, K] block and contracted into per-row Gramians by batched matrix
products (the JAX package's XLA einsums); the rows then reduce into the
instances by one segment sum (``index_add_``) or by the compile-time plan.
The layout's index arrays stay int32 on the device: ``index_select`` and
``index_add_`` take them as they are.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

# Gathered-block transient budget in bytes (rows * W * K * itemsize per
# partner table).  A bucket over it is processed in row chunks; each row's
# W-reduction stays inside one chunk, so chunking gives the same bits as
# one pass.  ML-10M's largest bucket set at K = 64 in bfloat16 (~1.45 GB a
# mode) stays on the one-pass path.
_GATHER_CHUNK_BYTES = 4e9


def bucket_gramian(
    partner_factors: Sequence[torch.Tensor],  # (arity-1) x [N_d, K]
    part: Sequence[torch.Tensor],             # (arity-1) x [rows, W] int32
    val: torch.Tensor,                        # [rows, W]
    mask: torch.Tensor,                       # [rows, W]
    gram_dtype=None,
    max_gather_bytes: float = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row Gramian and rhs contribution of one bucket (without alpha):
    (P [rows, K, K], b [rows, K]) in ``val``'s dtype.

    With ``gram_dtype=torch.bfloat16`` the partner rows (and the values)
    are gathered and masked in bfloat16, then contracted in ``val``'s dtype:
    a product of two bfloat16 values is exact in float32, so this is the
    JAX package's bf16 contraction with float32 accumulation and output,
    up to the order of the sums."""
    out_dtype = val.dtype
    if gram_dtype is not None:
        partner_factors = [U.to(gram_dtype) for U in partner_factors]
    budget = (_GATHER_CHUNK_BYTES if max_gather_bytes is None
              else max_gather_bytes)
    rows, W = val.shape
    K = partner_factors[0].shape[-1]
    transient = (float(rows) * W * K * partner_factors[0].element_size()
                 * len(partner_factors))

    def fetch(U, p):
        return U.index_select(0, p.reshape(-1)).view(*p.shape, K)

    def block(parts_b, val_b, mask_b):
        z = fetch(partner_factors[0], parts_b[0])            # [r, W, K]
        for U, p in zip(partner_factors[1:], parts_b[1:]):
            z = z * fetch(U, p)
        zm = z * mask_b[..., None].to(z.dtype)
        v = val_b.to(z.dtype)
        if zm.dtype != out_dtype:
            zm, v = zm.to(out_dtype), v.to(out_dtype)
        P = torch.bmm(zm.mT, zm)
        b = torch.bmm(zm.mT, v[..., None])[..., 0]
        return P, b

    if transient <= budget or rows <= 1:
        return block(part, val, mask)
    n_chunks = min(int(np.ceil(transient / budget)), rows)
    cr = -(-rows // n_chunks)
    P = torch.empty((rows, K, K), dtype=out_dtype, device=val.device)
    b = torch.empty((rows, K), dtype=out_dtype, device=val.device)
    for start in range(0, rows, cr):
        sl = slice(start, min(start + cr, rows))
        P[sl], b[sl] = block([p[sl] for p in part], val[sl], mask[sl])
    return P, b


def _gramian_rows(contribs, K: int, gram_dtype):
    """Every bucket's alpha-scaled per-row Gramians and rhs, concatenated
    in contribs order: (P_cat [R, K*K], b_cat [R, K])."""
    R = sum(ba["inst"].shape[0] for _, _, ba in contribs)
    val0 = contribs[0][2]["val"]
    P_cat = torch.empty((R, K * K), dtype=val0.dtype, device=val0.device)
    b_cat = torch.empty((R, K), dtype=val0.dtype, device=val0.device)
    cast = {}     # each partner table converted to gram_dtype once

    def to_gram(U):
        if gram_dtype is None:
            return U
        if id(U) not in cast:
            cast[id(U)] = U.to(gram_dtype)
        return cast[id(U)]

    off = 0
    for alpha, partner_factors, ba in contribs:
        P, b = bucket_gramian([to_gram(U) for U in partner_factors],
                              ba["part"], ba["val"], ba["mask"],
                              gram_dtype=gram_dtype)
        r = P.shape[0]
        torch.mul(P.view(r, K * K), alpha, out=P_cat[off:off + r])
        torch.mul(b, alpha, out=b_cat[off:off + r])
        off += r
    return P_cat, b_cat


def _segment_sum(rows: torch.Tensor, seg: torch.Tensor, n: int
                 ) -> torch.Tensor:
    """out[s] = sum of rows[r] with seg[r] == s, for s < n (JAX
    ``segment_sum``).  On CUDA ``index_add_`` adds with atomics, so the
    order of a float sum changes from run to run."""
    out = torch.zeros((n, rows.shape[1]), dtype=rows.dtype,
                      device=rows.device)
    return out.index_add_(0, seg, rows)


def _prior_term(prior_mean, Lambda, n):
    """Lambda mu for every row: [n, K] (prior_mean [n, K] or [K])."""
    return (prior_mean @ Lambda).expand(n, Lambda.shape[-1])


def assemble_precision(
    Lambda: torch.Tensor,       # [K, K]
    prior_mean: torch.Tensor,   # [n, K] or [K]
    contribs,                   # list of (alpha, partner_factors, bucket)
    n: int,
    gram_dtype=None,
    fuse_lambda: bool = False,  # leave Lambda out of P: the sampler adds it
) -> Tuple[torch.Tensor, torch.Tensor]:
    """P [n, K, K] and b [n, K] by ONE segment sum over all buckets' rows,
    in the flat [rows, K*K] layout.  A bucket is a dict of device tensors:
    ``inst`` [rows] int32, ``part`` list of [rows, W] int32, ``val`` and
    ``mask`` [rows, W]."""
    K = Lambda.shape[-1]
    if fuse_lambda:
        P_acc = torch.zeros((n, K * K), dtype=Lambda.dtype,
                            device=Lambda.device)
    else:
        P_acc = Lambda.reshape(1, K * K).expand(n, K * K)
    b_acc = _prior_term(prior_mean, Lambda, n)
    if contribs:
        P_cat, b_cat = _gramian_rows(contribs, K, gram_dtype)
        inst = torch.cat([ba["inst"] for _, _, ba in contribs])
        segP = _segment_sum(P_cat, inst, n)
        del P_cat
        P_acc = segP if fuse_lambda else P_acc + segP
        b_acc = b_acc + _segment_sum(b_cat, inst, n)
    return P_acc.reshape(n, K, K).contiguous(), b_acc.contiguous()


# Transient budget of the packed accumulation, in bytes of the larger of a
# chunk's [rows, K, K] Gramian block and its [rows, W, K] gather: a bucket
# over it accumulates in row chunks, each segment-summed into the persistent
# accumulator.  The Netflix-shaped residual (one duplicate rating for each
# of ~460k users: 1.9 GB of [rows, 32, 32] float32 blocks at once) runs in
# 4 chunks beside the 8.5 GB value array.
_PACKED_CHUNK_BYTES = 5e8


def packed_bucket_accum(contribs, n: int, K: int, gram_dtype=None,
                        transposed: bool = False, out=None, tri=None):
    """Packed-triangle accumulation of bucket contributions: (Pp [n, C],
    b [n, K]) with C = K(K+1)/2, alpha-scaled, or with ``transposed``
    (Pp [C, n], b [K, n]), the packed samplers' layout.  ``out`` = (Pp, b)
    accumulators of that layout are added to in place and returned: the
    fused path's residual goes straight into the fused contribution, with
    neither an [n, C] buffer of its own nor a transposed pass over it.
    ``tri`` = ``dense_gram.tri_index(K, device)``, the triangle's index
    tensors already on the device, as the engine passes it; without it (the
    JAX signature, which the parity tests call, as they do the natural
    layout and ``out=None``) the index is made and uploaded in the call.

    It lets the packed branch take gather contributions, the hybrid fused
    relations' exact-valued residual buckets.  ``bucket_gramian``'s P is
    symmetric bit for bit (commuting products, the same W-reduction), so
    its upper triangle is exact.  A bucket over ``_PACKED_CHUNK_BYTES``
    runs in row chunks; that changes the order of the segment sums, not a
    row's own Gramian.  Returns (None, None) for no contribs and no
    ``out``."""
    if not contribs:
        return (None, None) if out is None else out
    val0 = contribs[0][2]["val"]
    dev, dtype = val0.device, val0.dtype
    if tri is None:
        tri = [torch.from_numpy(a.astype(np.int64)).to(dev)
               for a in np.triu_indices(K)]
    sel = tri[0] * K + tri[1]
    C = sel.numel()
    if out is None:
        out = (torch.zeros((C, n) if transposed else (n, C), dtype=dtype,
                           device=dev),
               torch.zeros((K, n) if transposed else (n, K), dtype=dtype,
                           device=dev))
    Pp, b_acc = out
    cast = {}     # each partner table converted to gram_dtype once
    for alpha, partner_factors, ba in contribs:
        if gram_dtype is not None:
            for U in partner_factors:
                if id(U) not in cast:
                    cast[id(U)] = U.to(gram_dtype)
            partner_factors = [cast[id(U)] for U in partner_factors]
        rows, W = ba["val"].shape
        per_row = max(K * K * ba["val"].element_size(),
                      W * K * partner_factors[0].element_size()
                      * len(partner_factors))
        n_chunks = max(1, min(int(np.ceil(float(rows) * per_row
                                          / _PACKED_CHUNK_BYTES)), rows))
        cr = -(-rows // n_chunks)
        for start in range(0, rows, cr):
            sl = slice(start, min(start + cr, rows))
            P, b = bucket_gramian(partner_factors,
                                  [p[sl] for p in ba["part"]], ba["val"][sl],
                                  ba["mask"][sl], gram_dtype=gram_dtype)
            Pp_rows = P.view(P.shape[0], K * K).index_select(1, sel)
            del P
            Pp_rows *= alpha
            b = b * alpha
            inst = ba["inst"][sl]
            if transposed:
                Pp.index_add_(1, inst, Pp_rows.mT)
                b_acc.index_add_(1, inst, b.mT)
            else:
                Pp.index_add_(0, inst, Pp_rows)
                b_acc.index_add_(0, inst, b)
    return Pp, b_acc


def plan_accumulation(inst_arrays: Sequence[np.ndarray], n: int):
    """Compile-time plan replacing the segment sum (host-side NumPy).

    An instance owns exactly one Gramian row per (relation, mode), plus
    extra chunk rows only when its degree exceeds the widest bucket.  So
    the [rows] -> [n] reduction is a static gather of each instance's first
    row plus a small overflow segment sum.  Padded bucket rows carry
    inst = 0 with all-zero contributions; so as never to take one of them
    as instance 0's first row, all of instance 0's rows go through the
    overflow.

    Returns numpy arrays: first [n] int32 (concatenated row id of the first
    contributing row; 0 if none), has [n] float32 (0/1), ov_rows [R_ex]
    int32 and ov_inst [R_ex] int32, padded to a multiple of 8 with row 0
    aimed at the sentinel segment n.
    """
    inst_cat = np.concatenate([np.asarray(a) for a in inst_arrays]) \
        if inst_arrays else np.zeros(0, np.int32)
    rowids = np.arange(len(inst_cat), dtype=np.int64)
    nz = inst_cat != 0
    u, fpos = np.unique(inst_cat[nz], return_index=True)
    first = np.zeros(n, np.int32)
    has = np.zeros(n, np.float32)
    first[u] = rowids[nz][fpos].astype(np.int32)
    has[u] = 1.0
    is_first = np.zeros(len(inst_cat), bool)
    is_first[rowids[nz][fpos]] = True
    ov_rows = rowids[~is_first].astype(np.int32)
    ov_inst = inst_cat[~is_first].astype(np.int32)
    pad = (-len(ov_rows)) % 8 or 8
    ov_rows = np.concatenate([ov_rows, np.zeros(pad, np.int32)])
    ov_inst = np.concatenate([ov_inst, np.full(pad, n, np.int32)])
    return {"first": first, "has": has, "ov_rows": ov_rows,
            "ov_inst": ov_inst}


def assemble_precision_planned(
    Lambda: torch.Tensor,
    prior_mean: torch.Tensor,
    contribs,
    n: int,
    plan: dict,                # plan_accumulation's arrays, on the device
    gram_dtype=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """P [n, K, K] (Lambda included) and b [n, K] with the compile-time
    plan: a static gather of each instance's first row plus the overflow
    segment sum (the sentinel segment n takes the padding)."""
    K = Lambda.shape[-1]
    P_acc = Lambda.reshape(1, K * K).expand(n, K * K)
    b_acc = _prior_term(prior_mean, Lambda, n)
    if not contribs:
        return P_acc.reshape(n, K, K).contiguous(), b_acc.contiguous()
    P_cat, b_cat = _gramian_rows(contribs, K, gram_dtype)
    has = plan["has"][:, None]
    first = plan["first"]
    P_acc = P_acc + P_cat.index_select(0, first) * has
    b_acc = b_acc + b_cat.index_select(0, first) * has

    def overflow(rows_cat):
        return _segment_sum(rows_cat.index_select(0, plan["ov_rows"]),
                            plan["ov_inst"], n + 1)[:n]

    return ((P_acc + overflow(P_cat)).reshape(n, K, K),
            b_acc + overflow(b_cat))


def predict_tuples(factors: Sequence[torch.Tensor], idx: torch.Tensor,
                   mean_value: float) -> torch.Tensor:
    """pred = mean_r + sum_k prod_d U_d[i_d, k] for idx [n, D]."""
    prod = factors[0][idx[:, 0]]
    for d in range(1, len(factors)):
        prod = prod * factors[d][idx[:, d]]
    return mean_value + prod.sum(dim=1)
