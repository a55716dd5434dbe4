"""Device milliseconds a sweep that no layer file claims: the hyper draws,
the randoms, the predictions and the metrics' reductions, over the traced
stretch."""


def read(ctx):
    s = ctx["trace"]
    if not s or not s.get("sweeps"):
        return None
    return s["layer_us"].get("unattributed", 0.0) / s["sweeps"] / 1e3
