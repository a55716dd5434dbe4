"""Device milliseconds a sweep in the sampler layer (layers/sampler.json: its
kernels by name, the rest of its device work by the span of its calls),
over the traced stretch."""


def read(ctx):
    s = ctx["trace"]
    if not s or not s.get("sweeps"):
        return None
    us = s["layer_us"].get("sampler", 0.0)
    return us / s["sweeps"] / 1e3 if us > 0 else None
