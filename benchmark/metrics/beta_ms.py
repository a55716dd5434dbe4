"""Device milliseconds a sweep in the beta-draw layer (layers/beta.json:
the device work launched inside the engine's ``_sample_beta``: the
right-hand side, the solve, X beta and the lambda_beta draw), over the
traced stretch; None where no sweep draws a beta."""


def read(ctx):
    s = ctx["trace"]
    if not s or not s.get("sweeps"):
        return None
    us = s["layer_us"].get("beta", 0.0)
    return us / s["sweeps"] / 1e3 if us > 0 else None
