"""Seconds of the dense stores in the engine's build (the int8 or float
pair, or the fused store's V8: built on the host and uploaded), read from
the program's set-up spans ``bdf.build.store``; None where the program
records no such span or the plan keeps no dense store."""
from benchmark.spans import setup_phase


def read(ctx):
    return setup_phase("bdf.build.store")
