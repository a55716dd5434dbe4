"""Multi-relation data fusion over shared entities and a 3-way tensor
relation on the PyTorch/CUDA port — the counterpart of
``examples/fusion_graph.py``: compound x target IC50 fused with compound x
assay outcomes (its noise precision sampled) and a compound x target x
cell-context tensor.
"""
import argparse

import numpy as np

import bayesiandatafusion_jl_tpu_torch as bt

parser = argparse.ArgumentParser()
parser.add_argument("--compounds", type=int, default=2_000)
parser.add_argument("--num-latent", type=int, default=16)
parser.add_argument("--burnin", type=int, default=60)
parser.add_argument("--psamples", type=int, default=60)
parser.add_argument("--device", default="cuda")
args = parser.parse_args()

rng = np.random.default_rng(0)
nc, nt, na, ncell, k = args.compounds, 300, 50, 8, 16

Uc = rng.standard_normal((nc, k)) / np.sqrt(k)
Ut = rng.standard_normal((nt, k))
Ua = rng.standard_normal((na, k))
Ux = rng.standard_normal((ncell, k))


def sparse_rel(shape, density, gen):
    mask = rng.random(shape) < density
    idx = np.stack(np.nonzero(mask), 1)
    return bt.IndexedDF(idx, gen(idx), shape)


compound = bt.Entity("compound", count=nc)
target = bt.Entity("target", count=nt)
assay = bt.Entity("assay", count=na)
cell = bt.Entity("cell", count=ncell)

rd = bt.RelationData()
rd.add_relation(
    sparse_rel((nc, nt), 0.05,
               lambda i: (Uc[i[:, 0]] * Ut[i[:, 1]]).sum(1)
               + 0.2 * rng.standard_normal(len(i))),
    "ic50", [compound, target])
rd.add_relation(
    sparse_rel((nc, na), 0.20,
               lambda i: (Uc[i[:, 0]] * Ua[i[:, 1]]).sum(1)
               + 0.3 * rng.standard_normal(len(i))),
    "assay", [compound, assay])
rd.add_relation(
    sparse_rel((nc, nt, ncell), 0.002,
               lambda i: (Uc[i[:, 0]] * Ut[i[:, 1]] * Ux[i[:, 2]]).sum(1)
               + 0.3 * rng.standard_normal(len(i))),
    "context", [compound, target, cell])

rd.assign_to_test("ic50", min(3_000, rd.relations[0].data.nnz // 5))
rd.set_precision("assay", 2.0, sample=True)   # Gamma-sampled noise
rd.set_precision("context", 2.0)

result = bt.macau(rd, num_latent=args.num_latent, burnin=args.burnin,
                  psamples=args.psamples, device=args.device, verbose=False)
print(f"ic50 RMSE: {result['ic50']['RMSE']:.4f}")
