"""One Gibbs sweep of Macau (one relation between a featured entity and a
plain one) in float64: the plain reference that decides a Macau run's
``correct``.

Macau (Simm et al., "Macau: Scalable Bayesian factorization with
high-dimensional side information using MCMC", MLSP 2017,
arXiv:1509.04610) gives entity 0's rows the prior N(mu + x_i beta,
Lambda^-1), with the link matrix beta [F, K] ~ N(0, (lambda_beta
Lambda)^-1) by rows, and draws beta by noise injection into a linear
regression: beta solves

    (X'X + lambda_beta I) beta = X'(U - mu + E1) + sqrt(lambda_beta) E2,

E1 [N, K] and E2 [F, K] with rows ~ N(0, Lambda^-1).

It imports nothing of the program and takes nothing the program made.  It
follows the program one sweep at a time from the program's own state, in
the engine's order: entity 0's beta with the Lambda, mu and lambda_beta
entering the sweep, then lambda_beta | beta, Lambda, then its
Normal-Wishart hyperparameters from U - uhat (uhat = X beta), then its
rows with the prior mean mu + uhat_i; entity 1 as in BPMF against the
program's new rows of entity 0; then the predictions from the program's
new rows and their float32 accumulation (``reference/bpmf.py``'s stages,
imported).  The beta draw is independent of the program's solvers: a
Cholesky of XX' + lambda_beta I (N x N) and the Woodbury identity

    (X'X + lam I)^-1 v = (v - X'(XX' + lam I)^-1 X v) / lam,

all in float64.  Departures from the paper, each the program's own: the
Normal-Wishart prior has mu0 = 0 and W0 = I (``bpmf.normal_wishart``);
lambda_beta has the Gamma((nu_beta + F K)/2, rate (nu_beta / mean +
tr(beta' beta Lambda)) / 2) conditional of a Gamma prior with shape
nu_beta / 2 and mean ``lambda_beta_mean``; each focus mode's precision is
the Gramian path the program planned (``reference/paths/``).

``quant`` as in ``reference/bpmf.py``; the beta draw's float32 products
take TF32 outside ``stated``: the right-hand side X'(U - mu + E1) from
rows rounded to 10 mantissa bits, and the dual form's X rhs and X'z from
a rounded rhs and z (z = (XX' + lam I)^-1 X rhs = X beta = uhat), the
product whose cancellation against rhs a TF32 switch would amplify by
~||X'X|| / lambda_beta.  ``control`` also takes lambda_beta one step
below its float32 draw, in bfloat16 (its trace sums F K products, so no
rounding of the products moves it).
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

from benchmark.reference import bpmf, common, rng

F64 = common.F64
QUANTS = bpmf.QUANTS
Ratings = bpmf.Ratings
init_sums = bpmf.init_sums


class Features:
    """Entity 0's binary features X [n, F] in float64 on ``device``, and
    the Cholesky factor of XX' + lam I, kept for the newest lam asked."""

    def __init__(self, rows: torch.Tensor, cols: torch.Tensor, shape,
                 device):
        self.shape = tuple(int(s) for s in shape)
        self.X = torch.zeros(self.shape, dtype=F64, device=device)
        self.X[rows.to(device, torch.int64),
               cols.to(device, torch.int64)] = 1.0
        self._factors: Dict[float, torch.Tensor] = {}

    def factor(self, lam: float) -> torch.Tensor:
        if lam not in self._factors:
            G = self.X @ self.X.mT
            G.diagonal().add_(lam)
            self._factors = {lam: torch.linalg.cholesky(G)}
        return self._factors[lam]


def beta_draws(seed: int, sweep: int, ei: int, n: int, n_features: int,
               K: int, nu_beta: float, dtype: torch.dtype, device
               ) -> Dict[str, torch.Tensor]:
    """Entity ``ei``'s beta streams of sweep ``sweep`` (1-based) in the
    chain's dtype, seeded as ``reference/rng.py`` seeds every stream:
    the normals ``beta_e1`` [n, K] and ``beta_e2`` [F, K] and the
    standard Gamma((nu_beta + F K)/2) variate ``lb_g``."""
    out = {}
    for key, shape in (("beta_e1", (n, K)), ("beta_e2", (n_features, K))):
        out[key] = torch.randn(shape, generator=rng._gen(
            device, seed, sweep, f"e{ei}.{key}"), dtype=dtype, device=device)
    a = torch.tensor((nu_beta + n_features * K) / 2.0, dtype=dtype)
    out["lb_g"] = torch._standard_gamma(
        a.to(device).reshape(()).contiguous(),
        generator=rng._gen(device, seed, sweep, f"e{ei}.lb_g"))
    return out


def _low(x: torch.Tensor, quant: str) -> torch.Tensor:
    return x if quant == "stated" else common.round_tf32(x).to(F64)


def draw_beta(feats: Features, U, mu, Lam, lam: float, e1, e2,
              quant: str):
    """(beta, uhat = X beta) of the noise-injected draw from the rows U,
    mu, Lambda and lambda_beta entering the sweep."""
    X = feats.X
    L = torch.linalg.cholesky(Lam)

    def colored(z):                        # rows ~ N(0, Lambda^-1)
        return torch.linalg.solve_triangular(L.mT, z.to(F64).mT,
                                             upper=True).mT
    resid = U.to(F64) - mu + colored(e1)
    rhs = X.mT @ _low(resid, quant) + math.sqrt(lam) * colored(e2)
    z = torch.cholesky_solve(X @ _low(rhs, quant), feats.factor(lam))
    if quant == "stated":
        beta = (rhs - X.mT @ z) / lam
        return beta, X @ beta
    z = _low(z, quant)
    return (rhs - X.mT @ z) / lam, z


def sweep(data: Ratings, feats: Features, opts: Dict, paths: Sequence[str],
          seed: int, sweep_no: int, state_in: Dict, prog_out: Dict,
          quant: str = "stated") -> Dict:
    """The reference's sweep ``sweep_no`` (1-based) of the chain ``seed``.

    ``paths``: the Gramian path of each focus mode, as the program planned
    it.  ``state_in``: the program's state before the sweep: ``U`` (two
    [n_e, K] row tensors), entity 0's ``mu``, ``Lambda`` and
    ``lambda_beta``, and ``sum``, ``sum2`` (the test predictions'
    accumulators); ``prog_out``: the program's new rows ``U`` after it.
    ``opts``: ``bpmf.sweep``'s, with ``nu_beta`` and
    ``lambda_beta_mean``.  Returns ``bpmf.sweep``'s keys and entity 0's
    ``beta``, ``uhat`` and ``lambda_beta``, in float64."""
    if quant not in QUANTS:
        raise ValueError(f"unknown precision {quant!r}")
    K = int(opts["K"])
    dev = data.device
    nu0 = float(K if opts.get("nw_nu0") is None else opts["nw_nu0"])
    dtype = getattr(torch, opts.get("dtype", "float32"))
    b0, alpha = float(opts["nw_b0"]), float(opts["alpha"])
    n0, n_f = feats.shape
    bd = beta_draws(seed, sweep_no, 0, n0, n_f, K, float(opts["nu_beta"]),
                    dtype, dev)
    Lam_in = state_in["Lambda"][0].to(dev, F64)
    beta, uhat = draw_beta(feats, state_in["U"][0].to(dev),
                           state_in["mu"][0].to(dev, F64), Lam_in,
                           float(state_in["lambda_beta"]), bd["beta_e1"],
                           bd["beta_e2"], quant)
    tr = torch.einsum("fk,fl,kl->", beta, beta, Lam_in)
    lb = bd["lb_g"].to(F64) / ((float(opts["nu_beta"])
                                / float(opts["lambda_beta_mean"]) + tr) / 2.0)
    if quant == "control":
        lb = lb.to(torch.bfloat16).to(F64)
    out = {"beta": beta, "uhat": uhat, "lambda_beta": lb, "mu": [],
           "Lambda": [], "U": []}
    for e in range(2):
        n = data.shape[e]
        r = rng.entity_draws(seed, sweep_no, e, n, K, nu0, dtype, dev)
        S = state_in["U"][e].to(dev, F64)
        if e == 0:
            S = S - uhat
        mu, Lam = bpmf.normal_wishart(S, b0, r["nw_g"], r["nw_tri"],
                                      r["nw_mu"], quant)
        partner = (state_in["U"][1] if e == 0 else prog_out["U"][0]).to(dev)
        P, b = bpmf.path_module(paths[e]).gramian(data, e, partner, alpha,
                                                  quant)
        if e == 0:                          # the prior mean mu + uhat_i
            b = b + uhat @ Lam
        out["U"].append(bpmf.draw_rows(P, b, Lam, mu, r["xi"], quant))
        del P, b
        out["mu"].append(mu)
        out["Lambda"].append(Lam)
    U0, U1 = (prog_out["U"][e].to(dev, F64) for e in range(2))
    acc = torch.bfloat16 if quant == "control" else torch.float32
    if quant == "control":
        U0, U1 = U0.to(acc).to(F64), U1.to(acc).to(F64)
    ti = data.test_idx
    p = (data.mean + (U0[ti[:, 0]] * U1[ti[:, 1]]).sum(dim=1)).to(acc)
    s_in = {k: state_in[k].to(dev, acc) for k in ("sum", "sum2")}
    out["sum"] = (s_in["sum"] + p).to(F64)
    out["sum2"] = (s_in["sum2"] + p * p).to(F64)
    count = torch.tensor(float(max(sweep_no - int(opts["burnin"]), 0)),
                         dtype=F64)
    out["n"] = count.to(acc).to(F64)
    return out


def _gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest gap of ``prog`` against the rms of ``ref``."""
    rms = float(torch.sqrt(torch.mean(ref * ref)))
    return float((prog.to(ref.device, F64) - ref).abs().max()) / rms


def compare(prog: Dict, ref: Dict, prog_init, ref_init,
            clamp) -> Dict[str, float]:
    """The numbers that decide ``correct``: ``bpmf.compare``'s (with no
    clamp stated, nothing can lie outside it: ``clamp_gap`` 0 once a
    sweep has been accumulated), and

    - ``beta_gap``: the widest gap of beta against the rms of the
      reference's beta;
    - ``lambda_beta_gap``: lambda_beta's relative gap;
    - ``uhat_gap``: the widest gap of uhat = X beta against the rms of the
      reference's uhat."""
    out = bpmf.compare(prog, ref, prog_init, ref_init,
                       (-math.inf, math.inf) if clamp is None else clamp)
    lb = float(ref["lambda_beta"])
    out.update(beta_gap=bpmf._widest([_gap(prog["beta"], ref["beta"])]),
               lambda_beta_gap=bpmf._widest(
                   [abs(float(prog["lambda_beta"]) - lb) / lb]),
               uhat_gap=bpmf._widest([_gap(prog["uhat"], ref["uhat"])]))
    return out
