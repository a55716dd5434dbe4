"""Macau on ChEMBL-IC50-shaped data with sparse binary compound
fingerprints, on the PyTorch/CUDA port — the counterpart of
``examples/chembl_macau.py`` (compound x target pIC50, the link matrix
beta drawn each sweep by blocked CG, class_cut = log10(200) active /
inactive AUC).

With ``--save-prefix`` the posterior samples of the psamples phase are
saved (``output_prefix``) and new compounds are scored from them by their
fingerprints alone (``predict_out_of_matrix``), the reference README's
workflow.
"""
import argparse

import numpy as np

import bayesiandatafusion_jl_tpu_torch as bt
from bayesiandatafusion_jl_tpu_torch.models.datasets import synthetic_chembl

parser = argparse.ArgumentParser()
parser.add_argument("--compounds", type=int, default=15_000)
parser.add_argument("--features", type=int, default=32_000)
parser.add_argument("--num-latent", type=int, default=32)
parser.add_argument("--burnin", type=int, default=200)
parser.add_argument("--psamples", type=int, default=100)
parser.add_argument("--save-prefix", default=None,
                    help="dump posterior samples for out-of-matrix use")
parser.add_argument("--device", default="cuda")
args = parser.parse_args()

rd = synthetic_chembl(n_compounds=args.compounds,
                      n_features=args.features)
rd.assign_to_test("ic50", 20_000)

result = bt.macau(rd, num_latent=args.num_latent, burnin=args.burnin,
                  psamples=args.psamples, use_ff=False,
                  gram_dtype="bfloat16", output_prefix=args.save_prefix,
                  device=args.device, verbose=False)
print(f"RMSE: {result['RMSE']:.4f}  AUC: {result['AUC']:.4f}  "
      f"accuracy: {result['accuracy']:.3f}")

if args.save_prefix:
    # five new compounds, scored from the saved beta and mu
    x_new = (np.random.default_rng(0).random((5, args.features)) < 0.001)
    preds = bt.predict_out_of_matrix(
        args.save_prefix, x_new.astype(float),
        relation_mean=float(rd.relations[0].data.vals.mean()))
    print("new-compound predictions:", preds.shape)
