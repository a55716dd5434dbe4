"""The float64 reference against an independent dense sweep, row by row in
NumPy, at a tiny size on the CPU."""
import os

import numpy as np
import pytest
import torch

from _tiny import ROOT

from benchmark.reference import bpmf, rng

N0, N1, K, NNZ = 40, 25, 4, 400
OPTS = {"K": K, "alpha": 5.0, "nw_b0": 2.0, "nw_nu0": None,
        "clamp": [1.0, 5.0], "dtype": "float32", "burnin": 2}
PATHS = sorted(f[:-3] for f in os.listdir(os.path.join(
    ROOT, "benchmark", "reference", "paths")) if f.endswith(".py"))


def _data(seed=0):
    r = np.random.default_rng(seed)
    cells = r.choice(N0 * N1, NNZ + 30, replace=False)
    idx = np.stack([cells // N1, cells % N1], 1)
    vals = r.integers(2, 11, NNZ + 30) / 2.0
    return idx[:NNZ], vals[:NNZ], idx[NNZ:], vals[NNZ:]


def _table(V, levels):
    V = V.astype(np.float32)
    iu, ju = np.triu_indices(K)
    T = np.concatenate([V[:, iu] * V[:, ju], V], 1)
    s = np.maximum(np.abs(T).max(0) * np.float32(1.0 / levels),
                   np.float32(np.finfo(np.float32).tiny)).astype(np.float32)
    return np.clip(np.rint(T / s), -levels, levels).astype(np.float64), \
        s.astype(np.float64)


def _dense_entity(idx, vals, f, V, path, nw, xi, mean):
    """Entity f's rows, one at a time: the precision and right-hand side
    summed observation by observation, then the draw."""
    n = (N0, N1)[f]
    iu, ju = np.triu_indices(K)
    mu, Lam = nw
    c32 = (vals - mean).astype(np.float32)
    if path == "gather_bfloat16":
        Vq = torch.from_numpy(V).to(torch.bfloat16).double().numpy()
        w = torch.from_numpy(c32).to(torch.bfloat16).double().numpy()
    else:
        codes, s = _table(V, 127)
        C = K * (K + 1) // 2
        if path == "pair_int8":
            ws = np.float32((float(np.abs(c32).max()) / 127.0) or 1.0)
            w = np.clip(np.rint(c32 / ws), -127, 127).astype(np.float64)
            wscale = float(ws)
        else:
            w, wscale = vals - mean, 1.0
    U = np.zeros((n, K))
    for i in range(n):
        obs = np.nonzero(idx[:, f] == i)[0]
        P = np.zeros((K, K))
        b = np.zeros(K)
        for o in obs:
            j = idx[o, 1 - f]
            if path == "gather_bfloat16":
                P += np.outer(Vq[j], Vq[j])
                b += w[o] * Vq[j]
            else:
                p = np.zeros((K, K))
                p[iu, ju] = codes[j, :C] * s[:C]
                p[ju, iu] = codes[j, :C] * s[:C]
                P += p
                b += w[o] * codes[j, C:] * s[C:] * wscale
        P *= 5.0
        b *= 5.0
        if path != "gather_bfloat16":
            _, s = _table(V, 127)
            ridge = 5.0 * s[:K * (K + 1) // 2].mean() * np.sqrt(K) / 2
            P[np.arange(K), np.arange(K)] += ridge * np.sqrt(len(obs))
        P = P + Lam
        L = np.linalg.cholesky(P)
        m = np.linalg.solve(P, b + Lam @ mu)
        U[i] = m + np.linalg.solve(L.T, xi[i])
    return U


def _dense_nw(U, g, tri, mn):
    S = U.astype(np.float64)
    N = S.shape[0]
    Sbar = S.mean(0)
    Sc = S - Sbar
    b_star = 2.0 + N
    Winv = np.eye(K) + Sc.T @ Sc + (2.0 * N / b_star) * np.outer(Sbar, Sbar)
    M = np.linalg.cholesky(Winv)
    A = np.tril(tri, -1) + np.diag(np.sqrt(2.0 * g))
    BA = np.linalg.solve(M.T, A)
    Lam = BA @ BA.T
    mu = N * Sbar / b_star + M @ np.linalg.solve(A.T, mn) / np.sqrt(b_star)
    return mu, Lam


def test_the_paths_are_the_three_the_cells_plan():
    assert PATHS == ["fused_int8", "gather_bfloat16", "pair_int8"]


@pytest.mark.parametrize("path", PATHS)
def test_reference_matches_a_dense_sweep(path):
    idx, vals, tidx, _ = _data()
    g = torch.Generator().manual_seed(1)
    U_in = [0.3 * torch.randn((n, K), generator=g) for n in (N0, N1)]
    U0_prog = 0.3 * torch.randn((N0, K), generator=g)
    U1_prog = 0.3 * torch.randn((N1, K), generator=g)
    pred = {"sum": torch.full((30,), 7.0), "sum2": torch.full((30,), 20.0),
            "n": torch.tensor(2.0)}
    data = bpmf.Ratings(torch.from_numpy(idx), torch.from_numpy(vals),
                        (N0, N1), torch.from_numpy(tidx), "cpu")
    ref = bpmf.sweep(data, OPTS, [path, path], 77, 5, {"U": U_in, **pred},
                     {"U": [U0_prog, U1_prog]})
    mean = vals.mean()
    for e, partner in ((0, U_in[1]), (1, U0_prog)):
        r = rng.entity_draws(77, 5, e, (N0, N1)[e], K, float(K),
                             torch.float32, "cpu")
        nw = _dense_nw(U_in[e].numpy(), r["nw_g"].double().numpy(),
                       r["nw_tri"].double().numpy(),
                       r["nw_mu"].double().numpy())
        np.testing.assert_allclose(ref["mu"][e].numpy(), nw[0], rtol=1e-10,
                                   atol=1e-12)
        np.testing.assert_allclose(ref["Lambda"][e].numpy(), nw[1],
                                   rtol=1e-10)
        U = _dense_entity(idx, vals, e, partner.numpy(), path, nw,
                          r["xi"].double().numpy(), mean)
        np.testing.assert_allclose(ref["U"][e].numpy(), U, rtol=1e-9,
                                   atol=1e-11)
    p = mean + (U0_prog.double()[tidx[:, 0]]
                * U1_prog.double()[tidx[:, 1]]).sum(1).numpy()
    p = np.clip(p, 1.0, 5.0).astype(np.float32)
    np.testing.assert_array_equal(ref["sum"].numpy(),
                                  (np.float32(7.0) + p).astype(np.float64))
    assert float(ref["n"]) == 3.0


def test_a_non_finite_state_reads_as_unbounded():
    U = [torch.ones(3, 2, dtype=torch.float64),
         torch.ones(2, 2, dtype=torch.float64)]
    ref = {"U": U, "mu": [torch.zeros(2)] * 2, "Lambda": [torch.eye(2)] * 2,
           "sum": torch.ones(4), "sum2": torch.ones(4), "n": torch.ones(())}
    prog = dict(ref, U=[U[0], torch.full((2, 2), float("nan"))])
    init = torch.zeros(2, 2)
    nums = bpmf.compare(prog, ref, init, init, (1.0, 5.0))
    assert nums["state_gap"] == float("inf")
    assert nums["accum_ulps"] == 0.0 and nums["init_gap"] == 0.0
    assert nums["count_gap"] == 0.0 and nums["clamp_gap"] == 0.0


def test_a_mean_outside_the_clamp_is_counted_in_rounding_units():
    one = torch.ones(3, 2, dtype=torch.float64)
    ref = {"U": [one, one], "mu": [torch.zeros(2)] * 2,
           "Lambda": [torch.eye(2)] * 2, "sum": torch.full((4,), 20.0),
           "sum2": torch.ones(4), "n": torch.tensor(4.0)}
    init = torch.zeros(2, 2)
    inside = bpmf.compare(ref, ref, init, init, (1.0, 5.0))
    assert inside["clamp_gap"] == 0.0
    over = dict(ref, sum=torch.full((4,), 20.001, dtype=torch.float64))
    nums = bpmf.compare(over, ref, init, init, (1.0, 5.0))
    assert nums["clamp_gap"] == pytest.approx(0.001 / 4 / (4 * 2 ** -24 * 5))
    off = dict(ref, n=torch.tensor(5.0))
    assert bpmf.compare(off, ref, init, init, (1.0, 5.0))["count_gap"] == 1
