"""The Gramian kernels' share of their roofline: the sum of each launch's
least time on the card, max(bytes / HBM rate, operations / peak rate),
from the count files k6, k8a and k7, over the same launches' measured
time, for the launches the traced stretch holds."""

FAMILIES = ("k6", "k8a", "k7")


def read(ctx):
    s = ctx["trace"]
    if not s or not s.get("sweeps"):
        return None
    sh, peaks = ctx["shape"], ctx["peaks"]
    bound = spent = 0.0
    for fam in FAMILIES:
        for pats, nbytes, ops, rate in ctx["counts"][fam].launches(
                sh["n"], sh["nnz"], sh["K"]):
            us = sum(v[0] for name, v in s["kernel_us"].items()
                     if any(p in name for p in pats))
            if us <= 0:
                continue
            least = max(nbytes / peaks["hbm_bytes_s"], ops / peaks[rate])
            bound += least * s["sweeps"]
            spent += us * 1e-6
    return 100.0 * bound / spent if spent > 0 else None
