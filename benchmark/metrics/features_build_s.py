"""Seconds of the side features' set-up in the engine's build (the
operand: the bucketed matvec or the dense X; the dual solve's G and its
eigendecomposition; the Nystrom factors or X'X), read from the program's
set-up span ``bdf.build.features``; None where the program records no such
span or no entity has features."""
from benchmark.spans import setup_phase


def read(ctx):
    return setup_phase("bdf.build.features")
