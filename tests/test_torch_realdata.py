"""Real-data gate of the port (the counterpart of tests/test_realdata.py;
imports neither jax nor the JAX package).

Skipped until a real MovieLens-family ratings file lands under the
repository's ``.cache/`` (``ratings.dat`` / ``u.data`` / ``ratings.csv``
/ ``ratings.txt``, top level or one directory down; ``find_real_ratings``).
Then it runs the JAX gate's chain on the card, or on the CPU where there
is no card, and holds the posterior-mean RMSE to the same
literature-anchored bands: ML-100k converged BPMF ~0.90, ML-1M
~0.86-0.87, ML-10M ~0.86 (subsampled here to 2M observations, hence the
wider band).  The bands catch a chain that does not learn (it sits at the
ratings' stdev, ~1.05-1.12), not MCMC noise.
"""
import numpy as np
import pytest
import torch

import bayesiandatafusion_jl_tpu_torch as bt
from bayesiandatafusion_jl_tpu_torch.models.datasets import (
    _parse_movielens_file, find_real_ratings)

_REAL = find_real_ratings()

pytestmark = pytest.mark.skipif(
    _REAL is None, reason="no real ratings file under .cache/")


@pytest.mark.slow
def test_real_movielens_rmse_trajectory():
    df = _parse_movielens_file(_REAL)
    nnz = df.nnz
    rng = np.random.default_rng(13)
    if nnz > 2_000_000:
        rows = np.sort(rng.choice(nnz, 2_000_000, replace=False))
        df = bt.IndexedDF(df.idx[rows], df.vals[rows], df.shape)
    rd = bt.RelationData.from_indexed_df(df, relation_name="ratings")
    rd.assign_to_test(0, min(100_000, df.nnz // 10), seed=7)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    res = bt.macau(rd, num_latent=16, burnin=20, psamples=20,
                   clamp=(1.0, 5.0), verbose=False, dtype="float32",
                   seed=42, sweeps_per_dispatch=10, device=device)
    rmse = float(res["RMSE"])
    # band by dataset size (posterior-mean RMSE after 40 sweeps)
    if nnz < 2e5:
        lo, hi = 0.82, 1.02      # ML-100k
    elif nnz < 2e6:
        lo, hi = 0.78, 0.95      # ML-1M
    else:
        lo, hi = 0.78, 1.02      # ML-10M (subsampled: above 0.86)
    assert lo < rmse < hi, (
        f"real-data RMSE {rmse:.4f} outside the literature-anchored band "
        f"({lo}, {hi}) for nnz={nnz}")
