"""One Gibbs sweep of BPMF, one relation between two entities, in float64:
the plain reference that decides a run's ``correct``.

It imports nothing of the program and takes nothing the program made.  It
follows the program one sweep at a time from the program's own state:
given the rows before the window's last sweep, it draws entity 0 (its
Normal-Wishart hyperparameters, then its rows), then entity 1 against the
program's new rows of entity 0, then the predictions from the program's
new rows, and accumulates them as the sampling phase does, counting the
sampling sweeps from the chain's schedule.

Each focus mode's precision and right-hand side come from the Gramian path
the program planned for it: ``paths/<path>.py``, found by the path's name,
works out again from the raw ratings and the partner rows the precision
that path states.  A path the program may plan is added as a file there.

``quant`` picks what is computed:

- ``stated``: every stage in the precision the configuration states;
- ``tf32``: the float32 matrix stages alone on TF32, the step a TF32
  switch would take: the hyper draw's products and the row draws'
  factorization and solves with their operands rounded to 10 mantissa
  bits;
- ``control``: every stage one precision step lower: ``tf32``, the paths'
  own lower step (int8 codes as int4, bfloat16 operands as float8 e4m3),
  the predictions from bfloat16 rows and their accumulation in bfloat16.
"""
from __future__ import annotations

import importlib.util
import math
import os
import warnings
from typing import Dict, Optional, Sequence

import torch

from benchmark.reference import common, rng

F64 = common.F64
HERE = os.path.dirname(os.path.abspath(__file__))
QUANTS = ("stated", "tf32", "control")
_PATHS: Dict[str, object] = {}


def path_module(name: str):
    """The Gramian path ``name``: ``paths/<name>.py`` beside this file."""
    if name not in _PATHS:
        f = os.path.join(HERE, "paths", name + ".py")
        if not os.path.exists(f):
            raise KeyError(f"the reference has no Gramian path {name!r} "
                           f"(no {f})")
        spec = importlib.util.spec_from_file_location(
            "bench_ref_path_" + name, f)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _PATHS[name] = mod
    return _PATHS[name]


class Ratings:
    """The training ratings of one relation, laid out for the reference:
    per focus mode a CSR of its observations and the degrees, the centered
    values, the test tuples, and ``cache`` for what the paths work out
    from them once."""

    def __init__(self, idx: torch.Tensor, vals: torch.Tensor, shape,
                 test_idx: torch.Tensor, device):
        self.shape = tuple(int(s) for s in shape)
        self.device = device
        idx = idx.to(device=device, dtype=torch.int64)
        vals = vals.to(device=device, dtype=F64)
        self.nnz = int(vals.numel())
        self.mean = float(vals.mean())
        self.centered = vals - self.mean
        self.cache: Dict = {}
        self.modes = []
        for f in range(2):
            n_f = self.shape[f]
            order = torch.argsort(idx[:, f], stable=True)
            rows = idx[order, f]
            cols = idx[order, 1 - f].contiguous()
            deg = torch.bincount(rows, minlength=n_f)
            crow = torch.zeros(n_f + 1, dtype=torch.int64, device=device)
            crow[1:] = torch.cumsum(deg, 0)
            self.modes.append({"crow": crow, "col": cols, "order": order,
                               "deg": deg.to(F64)})
            del rows
        self.test_idx = test_idx.to(device=device, dtype=torch.int64)

    def csr(self, f: int, values: Optional[torch.Tensor]) -> torch.Tensor:
        """Focus mode ``f``'s observations as a [n_f, n_partner] CSR of
        ``values`` (in the observations' order), or of ones."""
        m = self.modes[f]
        v = (torch.ones(self.nnz, dtype=F64, device=self.device)
             if values is None else values[m["order"]])
        with warnings.catch_warnings():     # "CSR support is in beta"
            warnings.simplefilter("ignore", UserWarning)
            return torch.sparse_csr_tensor(
                m["crow"], m["col"], v, (self.shape[f], self.shape[1 - f]),
                check_invariants=False)


def normal_wishart(U: torch.Tensor, b0: float, nw_g, nw_tri, nw_mu,
                   quant: str):
    """(mu, Lambda) of one Normal-Wishart conditional draw (mu0 = 0,
    W0 = I) from the rows U by the Bartlett decomposition."""
    S = (U.to(torch.float32) if quant == "stated"
         else common.round_tf32(U)).to(F64)
    N, K = S.shape
    Sbar = S.mean(dim=0)
    Sc = S - Sbar
    scatter = Sc.mT @ Sc
    b_star = b0 + N
    mu_star = N * Sbar / b_star
    Winv = (torch.eye(K, dtype=F64, device=U.device) + scatter
            + (b0 * N / b_star) * torch.outer(Sbar, Sbar))
    M = torch.linalg.cholesky(Winv)
    chi2 = 2.0 * nw_g.to(F64)
    A = torch.tril(nw_tri.to(F64), -1) + torch.diag(torch.sqrt(chi2))
    BA = torch.linalg.solve_triangular(M.mT, A, upper=True)
    Lam = BA @ BA.mT
    w = torch.linalg.solve_triangular(A.mT, nw_mu.to(F64)[:, None],
                                      upper=True)
    mu = mu_star + (M @ w)[:, 0] / math.sqrt(b_star)
    return mu, Lam


def _tf32(x: torch.Tensor) -> torch.Tensor:
    return common.round_tf32(x).to(F64)


def draw_rows(P: torch.Tensor, b: torch.Tensor, Lam: torch.Tensor,
              mu: torch.Tensor, xi: torch.Tensor, quant: str = "stated",
              block: int = 0):
    """u ~ N(P'^-1 b', P'^-1) per row, P' = P + Lambda, b' = b + Lambda mu,
    from packed P [n, C]: u = P'^-1 b' + L^-T xi with P' = L L^T; rows in
    blocks so that the full [rows, K, K] matrices fit.  Outside ``stated``
    P', b' and L enter the factorization and the solves rounded to TF32."""
    n, K = b.shape
    iu, ju = common.tri_pairs(K, P.device)
    lam_mu = Lam @ mu
    block = block or max(1, (1 << 27) // (K * K))
    low = quant != "stated"
    out = torch.empty((n, K), dtype=F64, device=P.device)
    for r0 in range(0, n, block):
        r1 = min(n, r0 + block)
        full = torch.zeros((r1 - r0, K, K), dtype=F64, device=P.device)
        full[:, iu, ju] = P[r0:r1]
        full[:, ju, iu] = P[r0:r1]
        full += Lam
        rhs = (b[r0:r1] + lam_mu)[..., None]
        if low:
            full, rhs = _tf32(full), _tf32(rhs)
        L = torch.linalg.cholesky(full)
        del full
        if low:
            L = _tf32(L)
        mean = torch.cholesky_solve(rhs, L)
        noise = torch.linalg.solve_triangular(
            L.mT, xi[r0:r1].to(F64)[..., None], upper=True)
        out[r0:r1] = (mean + noise)[..., 0]
    return out


def sweep(data: Ratings, opts: Dict, paths: Sequence[str], seed: int,
          sweep_no: int, state_in: Dict, prog_out: Dict,
          quant: str = "stated") -> Dict:
    """The reference's sweep ``sweep_no`` (1-based) of the chain ``seed``.

    ``paths``: the Gramian path of each focus mode, as the program planned
    it.  ``state_in``: the program's state before the sweep, ``U`` (two
    [n_e, K] row tensors) and ``sum``, ``sum2`` (the test predictions'
    accumulators); ``prog_out``: the program's new rows ``U`` after it,
    which the later stages read as the program did.  ``opts``: ``K``,
    ``alpha``, ``nw_b0``, ``nw_nu0`` (None: K), ``clamp``, ``dtype`` (the
    chain's, in which the randoms are drawn) and ``burnin``.  Returns each
    entity's ``mu``, ``Lambda`` and ``U``, the accumulators (as the
    chain's float32 sums of them) and ``n``, the sampling sweeps the
    schedule has run by then, in float64."""
    if quant not in QUANTS:
        raise ValueError(f"unknown precision {quant!r}")
    K = int(opts["K"])
    dev = data.device
    nu0 = float(K if opts.get("nw_nu0") is None else opts["nw_nu0"])
    dtype = getattr(torch, opts.get("dtype", "float32"))
    out = {"mu": [], "Lambda": [], "U": []}
    for e in range(2):
        n = data.shape[e]
        r = rng.entity_draws(seed, sweep_no, e, n, K, nu0, dtype, dev)
        mu, Lam = normal_wishart(state_in["U"][e].to(dev),
                                 float(opts["nw_b0"]), r["nw_g"],
                                 r["nw_tri"], r["nw_mu"], quant)
        partner = (state_in["U"][1] if e == 0 else prog_out["U"][0]).to(dev)
        P, b = path_module(paths[e]).gramian(data, e, partner,
                                             float(opts["alpha"]), quant)
        U = draw_rows(P, b, Lam, mu, r["xi"], quant)
        del P, b
        out["mu"].append(mu)
        out["Lambda"].append(Lam)
        out["U"].append(U)
    U0, U1 = (prog_out["U"][e].to(dev, F64) for e in range(2))
    acc = torch.bfloat16 if quant == "control" else torch.float32
    if quant == "control":
        U0, U1 = U0.to(acc).to(F64), U1.to(acc).to(F64)
    ti = data.test_idx
    p = data.mean + (U0[ti[:, 0]] * U1[ti[:, 1]]).sum(dim=1)
    lo, hi = opts["clamp"]
    p = torch.clamp(p, float(lo), float(hi)).to(acc)
    s_in = {k: state_in[k].to(dev, acc) for k in ("sum", "sum2")}
    out["sum"] = (s_in["sum"] + p).to(F64)
    out["sum2"] = (s_in["sum2"] + p * p).to(F64)
    count = torch.tensor(float(max(sweep_no - int(opts["burnin"]), 0)),
                         dtype=F64)
    out["n"] = count.to(acc).to(F64)
    return out


def _ulp32(x: torch.Tensor) -> torch.Tensor:
    """The float32 spacing at |x|, in float64."""
    a = x.to(torch.float32).abs()
    return (torch.nextafter(a, torch.full_like(a, math.inf)) - a).to(F64)


def init_sums(U: Sequence[torch.Tensor]):
    """Per entity (sum, sum of squares) of the starting rows, in float64."""
    out = []
    for u in U:
        d = u.to(F64)
        out.append(torch.stack([d.sum(), (d * d).sum()]))
    return torch.stack(out)


def compare(prog: Dict, ref: Dict, prog_init, ref_init,
            clamp) -> Dict[str, float]:
    """The numbers that decide ``correct``:

    - ``state_gap``: over both entities, the widest gap of the new rows
      (against the rms of the reference's rows), of mu (the same scale)
      and of Lambda (against its largest entry);
    - ``accum_ulps``: the widest gap of the accumulated prediction sums and
      sums of squares, in float32 units at the reference's value;
    - ``count_gap``: the program's count of accumulated sweeps against the
      schedule's (sweeps run past the burn-in), exact;
    - ``clamp_gap``: how far the posterior mean sum / n of any test rating
      lies outside the clamp range, in units of the widest float32
      rounding that n clamped additions can make (n * 2^-24 * hi): the
      stage that following the program's own sums skips, the sweeps
      before the last, may not carry more than that;
    - ``init_gap``: the gap of the starting rows' sums and sums of squares,
      which the same reduction gives bit for bit."""
    gaps = []
    for e in range(2):
        Ur = ref["U"][e]
        rms = float(torch.sqrt(torch.mean(Ur * Ur)))
        dev = Ur.device
        gaps.append(float((prog["U"][e].to(dev, F64) - Ur).abs().max()) / rms)
        gaps.append(float((prog["mu"][e].to(dev, F64)
                           - ref["mu"][e]).abs().max()) / rms)
        L = ref["Lambda"][e]
        gaps.append(float((prog["Lambda"][e].to(dev, F64) - L).abs().max())
                    / float(L.abs().max()))
    ulps = []
    for k in ("sum", "sum2"):
        r = ref[k]
        d = (prog[k].to(r.device, F64) - r).abs() / _ulp32(r)
        ulps.append(float(d.max()))
    n = float(prog["n"])
    lo, hi = (float(x) for x in clamp)
    if n >= 1.0:
        mean = prog["sum"].to(F64) / n
        out = torch.clamp_min(torch.maximum(lo - mean, mean - hi), 0.0)
        clamp_gap = float(out.max()) / (n * 2.0 ** -24 * hi)
    else:
        clamp_gap = math.inf
    init = float((prog_init.to(ref_init.device) - ref_init).abs().max())
    return {"state_gap": _widest(gaps), "accum_ulps": _widest(ulps),
            "count_gap": _widest([abs(n - float(ref["n"]))]),
            "clamp_gap": _widest([clamp_gap]),
            "init_gap": _widest([init])}


def _widest(xs) -> float:
    """The largest reading; a NaN or an infinity reads as infinity."""
    return max(x if math.isfinite(x) else math.inf for x in xs)
