"""The whole sweep's share of the card's highest dense rate: the model's
work a sweep, counted from the data and K and not from the plan, over the
timed window's seconds a sweep times the peak.  No implementation of the
same work can read above 100%."""


def read(ctx):
    t = ctx["timed"]
    if t["sweeps"] <= 0 or t["seconds"] <= 0:
        return None
    sh = ctx["shape"]
    K = sh["K"]
    C = K * (K + 1) // 2
    work = (2 * 2.0 * sh["nnz"] * (C + K)
            + sum(n * (K ** 3 / 3 + 2 * K * K) for n in sh["n"]))
    t_sweep = t["seconds"] / t["sweeps"]
    return 100.0 * work / (t_sweep * ctx["peaks"]["dense_op_s"])
