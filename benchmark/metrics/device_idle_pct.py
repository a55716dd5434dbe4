"""The device's idle share over the traced stretch: 1 - the union of the
intervals in which a device operation ran / the stretch's wall time."""


def read(ctx):
    s = ctx["trace"]
    if not s or s["window_us"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_us"] / s["window_us"])
