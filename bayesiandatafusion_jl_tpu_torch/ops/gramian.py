"""Per-instance precision and right-hand side over bucketed observations
(the gather path), and test-tuple prediction.

Port of ``bayesiandatafusion_jl_tpu/ops/gramian.py``: ``bucket_gramian``
:38, ``packed_bucket_accum`` :175, ``plan_accumulation`` :253 and
``predict_tuples`` :333.  The one ``assemble_precision`` gives what both
JAX assemblies give, up to the order of the sums: its
``assemble_precision`` :118 (Lambda in P or, with ``fuse_lambda``, left to
the sampler) and ``assemble_precision_planned`` :296 (Lambda in P).  For
entity rows i with observations o,

    P_i = Lambda + sum_r alpha_r sum_{o in Omega_i^r} z_o z_o^T
    b_i = Lambda mu  + sum_r alpha_r sum_o (v_o - mean_r) z_o

where z_o is the product of the other modes' latent rows.  Per bucket of
the layout (ops/layout.py) each row's partner rows are contracted into its
Gramian: for a bfloat16 gather on the card by the gather-Gramian kernel
(``gather_gram``, ``csrc/gather_gram.cu``: the rows gathered into shared
memory and contracted on the tensor cores in one pass), else by torch code
that gathers them into a [rows, W, K] block and contracts it by batched
matrix products (the JAX package's XLA einsums).  The rows then reach the
instances through the entity's destination map (``build_dest_map``, made
once from the layouts, on the device by ``build_dest_maps``): each row is
written at its instance's row, or, for an instance's further rows, at an
overflow slot whose sum is added in (``assemble_precision``).  The
layout's index arrays stay int32 on the device: the kernel and
``index_select`` take them as they are.

Every sum of rows here adds in one fixed order, the same on every run: an
instance's overflow slots in layout order, summed over their static
lengths (``torch.segment_reduce``) and added to its first row once; or,
for the packed accumulator, the rows sorted stably by instance and each
instance's rows summed in that order, one nonzero row an instance that
``index_add_`` adds in (``_run_sums``).  A scatter add of the rows
themselves would add with atomics on CUDA, whose order changes from run
to run, so two runs of one seed would not give the same bits, and a
resumed chain would not equal the one without interruption.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .. import kernels
from ..utils import spans

# Gathered-block transient budget in bytes (rows * W * K * itemsize per
# partner table) of the torch code.  A bucket over it is processed in row
# chunks; each row's W-reduction stays inside one chunk, so chunking gives
# the same bits as one pass.  ML-10M's largest bucket set at K = 64 in
# bfloat16 (~1.45 GB a mode) stays on the one-pass path.
_GATHER_CHUNK_BYTES = 4e9

# The gather-Gramian kernel (csrc/gather_gram.cu) takes K a multiple of 16
# up to 64, one or two partner tables (arity 2 or 3).  Above K = 64 a
# warp's accumulators of P would not fit its registers.
GATHER_GRAM_KS = (16, 32, 48, 64)
# the kernel's slots a step, and the steps a warp walks at most (a few
# narrow rows, or one wide row, in one pipeline)
_GG_STEP = 16
_GG_WARP_STEPS = 32


def gather_gram_takes(device_type: str, gram_dtype, val_dtype, K: int,
                      arity: int) -> bool:
    """The dispatch rule of ``bucket_gramian``: the gather-Gramian kernel
    for a bfloat16 gather of float32 values on a CUDA device at K in
    ``GATHER_GRAM_KS`` and arity 2 or 3; the torch code for everything
    else (float32 and float64 gathers, the CPU, other K and arities)."""
    return (device_type == "cuda" and gram_dtype == torch.bfloat16
            and val_dtype == torch.float32 and K in GATHER_GRAM_KS
            and arity in (2, 3))


def bucket_gramian(
    partner_factors: Sequence[torch.Tensor],  # (arity-1) x [N_d, K]
    part: Sequence[torch.Tensor],             # (arity-1) x [rows, W] int32
    val: torch.Tensor,                        # [rows, W]
    mask: torch.Tensor,                       # [rows, W]
    gram_dtype=None,
    max_gather_bytes: float = None,
    alpha=None,
    out=None,
    dest=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row Gramian and rhs contribution of one bucket: (P [rows, K, K],
    b [rows, K]) in ``val``'s dtype, times ``alpha`` where given (a number
    or a one-element tensor); with ``out`` = (P [rows, K*K], b [rows, K])
    written there and returned.  With ``dest`` (int32 [rows] on the
    device, distinct output rows) as well, ``out`` = (P [N, K*K], b [N,
    K]) of any N and row r goes to output row ``dest[r]``; the kernel
    stores nothing where ``dest[r]`` is outside [0, N), the torch code
    takes only destinations inside it (it moves the rows by
    ``index_copy_``; on the CPU it drops the others).

    With ``gram_dtype=torch.bfloat16`` the partner rows (and the values)
    are gathered and masked in bfloat16, then contracted in ``val``'s dtype:
    a product of two bfloat16 values is exact in float32, so this is the
    JAX package's bf16 contraction with float32 accumulation and output,
    up to the order of the sums.  Where ``gather_gram_takes`` (a CUDA
    device, float32 values, K in ``GATHER_GRAM_KS``, arity 2 or 3) it runs
    the gather-Gramian kernel (``gather_gram``), else the torch code."""
    if gram_dtype is not None:
        partner_factors = [U.to(gram_dtype) for U in partner_factors]
    if gather_gram_takes(val.device.type, gram_dtype, val.dtype,
                         partner_factors[0].shape[-1],
                         len(partner_factors) + 1):
        return gather_gram(partner_factors, part, val, mask, alpha=alpha,
                           out=out, dest=dest)
    return _bucket_gramian_torch(partner_factors, part, val, mask,
                                 max_gather_bytes, alpha, out, dest)


def _bucket_gramian_torch(partner_factors, part, val, mask,
                          max_gather_bytes, alpha, out, dest=None):
    """``bucket_gramian`` in torch operations, the partner tables already
    in the gather's dtype: each row's partner rows gathered into a [rows,
    W, K] block (in row chunks over ``max_gather_bytes``), masked, then
    contracted by batched matrix products in ``val``'s dtype; with
    ``dest``, the alpha-scaled rows moved into ``out`` by ``index_copy_``
    (the same bits as without it)."""
    out_dtype = val.dtype
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
        P, b = block(part, val, mask)
    else:
        n_chunks = min(int(np.ceil(transient / budget)), rows)
        cr = -(-rows // n_chunks)
        P = torch.empty((rows, K, K), dtype=out_dtype, device=val.device)
        b = torch.empty((rows, K), dtype=out_dtype, device=val.device)
        for start in range(0, rows, cr):
            sl = slice(start, min(start + cr, rows))
            P[sl], b[sl] = block([p[sl] for p in part], val[sl], mask[sl])
    if out is not None and dest is None:
        scale = 1.0 if alpha is None else alpha
        torch.mul(P.view(out[0].shape), scale, out=out[0])
        torch.mul(b, scale, out=out[1])
        return out
    if alpha is not None:
        P, b = P.mul_(alpha), b.mul_(alpha)
    if dest is None:
        return P, b
    d = dest.long()
    if d.device.type == "cpu":
        keep = (d >= 0) & (d < out[0].shape[0])
        if not bool(keep.all()):
            d, P, b = d[keep], P[keep], b[keep]
    out[0].view(-1, P.shape[-2] * P.shape[-1]).index_copy_(
        0, d, P.view(-1, P.shape[-2] * P.shape[-1]))
    out[1].index_copy_(0, d, b)
    return out


def gather_gram_plain(partner_factors, part, val, mask, alpha=None,
                      out=None, dest=None):
    """The plain torch version of ``gather_gram``: the torch code of
    ``bucket_gramian`` with the partner rows in bfloat16.  Runs on any
    device; ``gather_gram_plain.calls`` counts its calls."""
    gather_gram_plain.calls += 1
    return _bucket_gramian_torch([U.to(torch.bfloat16)
                                  for U in partner_factors], part, val, mask,
                                 None, alpha, out, dest)


gather_gram_plain.calls = 0
spans.counter(gather_gram_plain, "calls")


def gather_gram(partner_factors, part, val, mask, alpha=None, out=None,
                dest=None):
    """One bucket's per-row alpha * P [rows, K, K] and alpha * b [rows, K]
    (float32) from a bfloat16 gather: the partner tables ``partner_factors``
    (one or two [N_d, K] bfloat16, K in ``GATHER_GRAM_KS``), the indices
    ``part`` (as many [rows, W] int32), ``val`` and ``mask`` ([rows, W]
    float32), ``alpha`` a number or a one-element tensor (default 1).  With
    ``out`` = (P [rows, K*K] or [rows, K, K], b [rows, K]), contiguous
    float32, the results go there.  With ``dest`` (contiguous int32
    [rows]) too, ``out`` may have any number N of rows, and row r goes to
    output row ``dest[r]``, nowhere where that is outside [0, N): the same
    bits as without ``dest``, moved.

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (``csrc/gather_gram.cu``) on the current stream or raise — there is no
    fallback.  The kernel reads nothing outside a table: an index outside
    it, like a slot with mask 0, reads as a zero row.
    ``gather_gram.launches`` counts the launches."""
    dev = val.device
    if dev.type == "cpu":
        return gather_gram_plain(partner_factors, part, val, mask, alpha,
                                 out, dest)
    if dev.type != "cuda":
        raise RuntimeError(f"no kernel for device {dev}")
    nt = len(partner_factors)
    if nt not in (1, 2) or len(part) != nt:
        raise ValueError(f"the kernel takes one or two partner tables with "
                         f"an index array each, got {nt} and {len(part)}")
    K = partner_factors[0].shape[-1]
    if K not in GATHER_GRAM_KS:
        raise ValueError(f"the kernel takes K in {GATHER_GRAM_KS}, got {K}")
    for U in partner_factors:
        if (U.dim() != 2 or U.shape[1] != K or U.shape[0] < 1
                or U.dtype != torch.bfloat16 or not U.is_contiguous()
                or U.data_ptr() % 16 or U.device != dev):
            raise ValueError(f"a partner table must be a nonempty, "
                             f"contiguous, 16-byte aligned [n, {K}] bfloat16 "
                             f"tensor on {dev}, got {U.dtype} "
                             f"{tuple(U.shape)} on {U.device}")
    if val.dim() != 2:
        raise ValueError(f"val must be [rows, W], got {tuple(val.shape)}")
    rows, W = val.shape
    for name, t, dt in (*((f"part[{d}]", p, torch.int32)
                          for d, p in enumerate(part)),
                        ("val", val, torch.float32),
                        ("mask", mask, torch.float32)):
        if (t.dtype != dt or tuple(t.shape) != (rows, W)
                or not t.is_contiguous() or t.device != dev):
            raise ValueError(f"{name} must be contiguous {dt} [{rows}, {W}] "
                             f"on {dev}, got {t.dtype} {tuple(t.shape)}")
    if torch.is_tensor(alpha):
        if alpha.numel() != 1:
            raise ValueError("alpha must hold one value")
        a = alpha.to(device=dev, dtype=torch.float32).reshape(())
    else:
        a = torch.full((), 1.0 if alpha is None else float(alpha),
                       dtype=torch.float32, device=dev)
    if out is None:
        if dest is not None:
            raise ValueError("dest needs out")
        out = (torch.empty((rows, K, K), dtype=torch.float32, device=dev),
               torch.empty((rows, K), dtype=torch.float32, device=dev))
    n_out = out[0].shape[0]
    if dest is None and n_out != rows:
        raise ValueError(f"out must have {rows} rows without dest, got "
                         f"{n_out}")
    if dest is not None and (dest.dtype != torch.int32
                             or tuple(dest.shape) != (rows,)
                             or not dest.is_contiguous()
                             or dest.device != dev):
        raise ValueError(f"dest must be contiguous int32 [{rows}] on {dev}, "
                         f"got {dest.dtype} {tuple(dest.shape)}")
    for name, t, numel in (("P", out[0], n_out * K * K),
                           ("b", out[1], n_out * K)):
        if (t.dtype != torch.float32 or t.numel() != numel
                or t.shape[0] != n_out or not t.is_contiguous()
                or t.data_ptr() % 16 or t.device != dev):
            raise ValueError(f"out {name} must be contiguous, 16-byte "
                             f"aligned float32 with {numel} entries on "
                             f"{dev}")
    if rows == 0:
        return out
    # a warp takes up to _GG_WARP_STEPS steps' rows, fewer where the bucket
    # has too few rows for 32 warps a SM
    n_steps = -(-W // _GG_STEP)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows_per_warp = max(1, min(max(1, _GG_WARP_STEPS // n_steps),
                               -(-rows // (32 * sms))))
    U1, p1 = partner_factors[-1], part[-1]
    lib = kernels.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.bdf_gather_gram(
            partner_factors[0].data_ptr(), partner_factors[0].shape[0],
            U1.data_ptr(), U1.shape[0], K, nt, part[0].data_ptr(),
            p1.data_ptr(), val.data_ptr(), mask.data_ptr(), rows, W,
            rows_per_warp, a.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), None if dest is None else dest.data_ptr(),
            n_out, stream)
    if rc != 0:
        raise RuntimeError(f"gather-Gramian kernel launch failed: CUDA "
                           f"error {rc}")
    gather_gram.launches += 1
    return out


gather_gram.launches = 0
spans.counter(gather_gram, "launches")


def _gramian_rows(contribs, K: int, gram_dtype, dest: torch.Tensor,
                  n_out: int):
    """Every bucket's alpha-scaled per-row Gramians and rhs, the rows in
    contribs order, row r at row ``dest[r]`` (int32 [R], a destination
    map's) of (P [n_out, K*K], b [n_out, K])."""
    val0 = contribs[0][2]["val"]
    P_out = torch.empty((n_out, K * K), dtype=val0.dtype, device=val0.device)
    b_out = torch.empty((n_out, K), dtype=val0.dtype, device=val0.device)
    cast = {}     # each partner table converted to gram_dtype once

    def to_gram(U):
        if gram_dtype is None:
            return U
        if id(U) not in cast:
            cast[id(U)] = U.to(gram_dtype)
        return cast[id(U)]

    off = 0
    for alpha, partner_factors, ba in contribs:
        r = ba["inst"].shape[0]
        bucket_gramian([to_gram(U) for U in partner_factors], ba["part"],
                       ba["val"], ba["mask"], gram_dtype=gram_dtype,
                       alpha=alpha, out=(P_out, b_out),
                       dest=dest[off:off + r])
        off += r
    return P_out, b_out


def _run_sums(seg: torch.Tensor, *rows: torch.Tensor):
    """(segment ids sorted stably, each of ``rows``' run sums): the rows
    sorted by segment, and at the first row of each run of one segment the
    sum of the run's rows in that order (+0 at the run's other rows).  An
    ``index_add_`` of the run sums at the sorted ids adds one nonzero row
    and +0s into each segment, which its atomics add to the same bits in
    any order: a fixed-order sum into an existing accumulator, in any
    layout."""
    s, order = torch.sort(seg, stable=True)
    R = s.numel()
    start = torch.ones(R, dtype=torch.bool, device=s.device)
    start[1:] = s[1:] != s[:-1]
    lengths = torch.where(start, torch.searchsorted(s, s, right=True)
                          - torch.arange(R, device=s.device), 0)
    return s, [torch.segment_reduce(r.index_select(0, order), "sum",
                                    lengths=lengths, unsafe=True)
               for r in rows]


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
    dest_map=None,              # the entity's, from build_dest_maps
) -> Tuple[torch.Tensor, torch.Tensor]:
    """P [n, K, K] and b [n, K] from all buckets' rows.  A bucket is a dict
    of device tensors: ``inst`` [rows] int32, ``part`` list of [rows, W]
    int32, ``val`` and ``mask`` [rows, W].

    The rows go through the destination map ``dest_map`` (the entity's,
    over these contribs in this order; a map is needed where there are
    rows): every bucket's rows written into one [n + R_ov, ...] buffer,
    each instance's first row at the instance's row, its other rows at its
    overflow slots after them; the rows no bucket reaches zeroed; then each
    instance's overflow slots summed (``segment_reduce`` over the static
    run lengths) and that one sum added into its row; then the prior term,
    and Lambda unless ``fuse_lambda``.  Without contribs P is Lambda (or
    zeros) and b the prior term.

    An instance of one row gets that row's bits (+0.0 for -0.0); one of
    several rows sums its first row + (the others, in layout order): a
    fixed order, the same on every run.  ``assemble_precision``'s
    ``direct_rows`` and ``overflow_rows`` count the rows of each kind (from
    the map, on the host)."""
    K = Lambda.shape[-1]
    if not contribs:
        P = (torch.zeros((n, K, K), dtype=Lambda.dtype, device=Lambda.device)
             if fuse_lambda else Lambda.expand(n, K, K).contiguous())
        return P, _prior_term(prior_mean, Lambda, n).contiguous()
    if dest_map is None:
        raise ValueError("bucket rows need their entity's destination map")
    dm = dest_map
    n_ov = dm["overflow_rows"]
    buf_P, buf_b = _gramian_rows(contribs, K, gram_dtype, dm["dest"],
                                 n + n_ov)
    P, b = buf_P[:n], buf_b[:n]
    if dm["empty"].numel():
        P.index_fill_(0, dm["empty"], 0.0)
        b.index_fill_(0, dm["empty"], 0.0)
    if n_ov:
        with spans.span(dm["span"]):
            for acc, buf in ((P, buf_P), (b, buf_b)):
                acc.index_add_(0, dm["ov_inst"], torch.segment_reduce(
                    buf[n:], "sum", lengths=dm["ov_len"], unsafe=True))
    assemble_precision.direct_rows += dm["direct_rows"]
    assemble_precision.overflow_rows += n_ov
    b = b.add_(_prior_term(prior_mean, Lambda, n))
    if not fuse_lambda:
        P = P.add_(Lambda.reshape(1, K * K))
    return P.view(n, K, K), b


assemble_precision.direct_rows = 0
assemble_precision.overflow_rows = 0
spans.counter(assemble_precision, "direct_rows", "overflow_rows")


def plan_accumulation(inst_arrays: Sequence[np.ndarray], n: int):
    """The static plan of an entity's bucket rows (host-side NumPy; the JAX
    package's planned assembly's), from which ``build_dest_map`` makes its
    map.

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


def build_dest_map(inst_arrays: Sequence[np.ndarray], n: int,
                   span: str = "bdf.overflow") -> dict:
    """The destination map of one entity's bucket rows (host-side NumPy),
    from ``plan_accumulation``'s arrays, over the rows of ``inst_arrays``
    concatenated (contribs order): ``dest`` [R] int32, each instance's
    first row (``first``, where ``has``) mapped to the instance's row of
    the [n, ...] output, every other row (``plan_accumulation``'s overflow:
    an instance's chunk rows after its first, every row of instance 0,
    whose rows include the buckets' padding) to n + its overflow slot,
    slots in instance order and, within an instance, in layout order;
    ``ov_inst`` int64 and ``ov_len`` int64, the instances with overflow
    slots and each one's number of slots; ``empty`` int64, the instances
    with no first row (zeroed before the overflow is added);
    ``direct_rows`` and ``overflow_rows``, the counts; ``span``, the name
    of the overflow's span."""
    plan = plan_accumulation(inst_arrays, n)
    R = sum(len(a) for a in inst_arrays)
    real = plan["ov_inst"] < n    # drop the padding aimed at segment n
    ov_rows, ov_inst = plan["ov_rows"][real], plan["ov_inst"][real]
    order = np.argsort(ov_inst, kind="stable")
    ov_rows, ov_inst = ov_rows[order], ov_inst[order]
    has = plan["has"] > 0
    direct = np.nonzero(has)[0]
    dest = np.empty(R, np.int32)
    dest[plan["first"][direct]] = direct
    dest[ov_rows] = n + np.arange(len(ov_rows), dtype=np.int32)
    u, lens = np.unique(ov_inst, return_counts=True)
    return {"dest": dest, "ov_inst": u.astype(np.int64),
            "ov_len": lens.astype(np.int64),
            "empty": np.nonzero(~has)[0].astype(np.int64),
            "direct_rows": int(len(direct)),
            "overflow_rows": int(len(ov_rows)), "span": span}


def build_dest_maps(rel_specs, host_inst, ns: Sequence[int],
                    device) -> dict:
    """``{"e{ei}": map}`` for each entity ``ei`` with gather buckets: its
    destination map (``build_dest_map``'s) over ``ns[ei]`` output rows, the
    arrays on ``device`` and the counts on the host, its overflow's span
    ``bdf.e{ei}.overflow``.  The rows are the entity's buckets' in the
    sweep's order, relations (``rel_specs``' ``entity_ids``), then modes;
    ``host_inst["r{ri}m{mode}"]`` holds a mode's buckets' host ``inst``
    arrays."""
    maps = {}
    for ei, n in enumerate(ns):
        insts = [a for ri, rs in enumerate(rel_specs)
                 for mode, e in enumerate(rs.entity_ids) if e == ei
                 for a in host_inst.get(f"r{ri}m{mode}", ())]
        if not insts:
            continue
        dm = build_dest_map(insts, n, f"bdf.e{ei}.overflow")
        for k in ("dest", "ov_inst", "ov_len", "empty"):
            dm[k] = torch.from_numpy(dm[k]).to(device)
        maps[f"e{ei}"] = dm
    return maps


# Transient budget of the packed accumulation, in bytes of the larger of a
# chunk's [rows, K, K] Gramian block and, on the torch code, its [rows, W,
# K] gather (the gather-Gramian kernel builds no such block): a bucket over
# it accumulates in row chunks, each segment-summed into the persistent
# accumulator.  The Netflix-shaped residual (one duplicate rating for each
# of ~460k users: 1.9 GB of [rows, 32, 32] float32 blocks at once) runs in
# 4 chunks beside the 8.5 GB value array.
_PACKED_CHUNK_BYTES = 5e8


def packed_chunk_rows(rows: int, W: int, K: int, itemsize: int,
                      gather_bytes: int) -> int:
    """The rows of each chunk ``packed_bucket_accum`` takes from a bucket
    of ``rows`` x ``W``: within ``_PACKED_CHUNK_BYTES`` of the chunk's
    [rows, K, K] Gramian block of ``itemsize`` bytes an entry and its
    gathered block of ``gather_bytes`` a slot (0 for the gather-Gramian
    kernel, which builds none)."""
    per_row = max(K * K * itemsize, W * gather_bytes)
    n_chunks = max(1, min(int(np.ceil(float(rows) * per_row
                                      / _PACKED_CHUNK_BYTES)), rows))
    return -(-rows // n_chunks)


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
    runs in row chunks (``packed_chunk_rows``); that changes the order of
    the instance sums, not a row's own Gramian.  Each chunk's rows are summed by instance in a
    fixed order (``_run_sums``) before they are added.  Returns (None,
    None) for no contribs and no ``out``."""
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
        gather_bytes = (0 if gather_gram_takes(
            dev.type, gram_dtype, dtype, K, len(partner_factors) + 1)
            else K * partner_factors[0].element_size()
            * len(partner_factors))
        cr = packed_chunk_rows(rows, W, K, ba["val"].element_size(),
                               gather_bytes)
        for start in range(0, rows, cr):
            sl = slice(start, min(start + cr, rows))
            P, b = bucket_gramian(partner_factors,
                                  [p[sl] for p in ba["part"]], ba["val"][sl],
                                  ba["mask"][sl], gram_dtype=gram_dtype,
                                  alpha=alpha)
            Pp_rows = P.view(P.shape[0], K * K).index_select(1, sel)
            del P
            inst, (Pp_rows, b) = _run_sums(ba["inst"][sl], Pp_rows, b)
            if transposed:
                Pp.index_add_(1, inst, Pp_rows.mT)
                b_acc.index_add_(1, inst, b.mT)
            else:
                Pp.index_add_(0, inst, Pp_rows)
                b_acc.index_add_(0, inst, b)
    return Pp, b_acc


def predict_tuples(factors: Sequence[torch.Tensor], idx: torch.Tensor,
                   mean_value: float) -> torch.Tensor:
    """pred = mean_r + sum_k prod_d U_d[i_d, k] for idx [n, D]."""
    prod = factors[0][idx[:, 0]]
    for d in range(1, len(factors)):
        prod = prod * factors[d][idx[:, d]]
    return mean_value + prod.sum(dim=1)
