"""BPMF on MovieLens-shaped ratings with the PyTorch/CUDA port — the
counterpart of ``examples/movielens.py``.

``--data /path/to/u.data`` (or ``ratings.dat``, ``ratings.csv``) reads a
MovieLens ratings file; without it the ratings are the port's synthetic,
shape-matched MovieLens data.  ``--device cpu`` runs the kernels' plain
versions on the CPU.
"""
import argparse

import bayesiandatafusion_jl_tpu_torch as bt
from bayesiandatafusion_jl_tpu_torch.models.datasets import load_movielens

parser = argparse.ArgumentParser()
parser.add_argument("--data", default=None, help="u.data / ratings.dat path")
parser.add_argument("--variant", default="100k", choices=["100k", "1m", "10m"])
parser.add_argument("--num-latent", type=int, default=32)
parser.add_argument("--burnin", type=int, default=100)
parser.add_argument("--psamples", type=int, default=100)
parser.add_argument("--device", default="cuda")
args = parser.parse_args()

df = load_movielens(args.variant, path=args.data)
rd = bt.RelationData.from_indexed_df(df, relation_name="ratings")
rd.assign_to_test(0, df.nnz // 10)

result = bt.macau(rd, num_latent=args.num_latent, burnin=args.burnin,
                  psamples=args.psamples, clamp=[1.0, 5.0],
                  dense_int8=True, metrics_every=10, device=args.device,
                  verbose=False)
print(f"posterior-mean RMSE: {result['RMSE']:.4f}")
