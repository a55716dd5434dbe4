"""Seconds of the planner in the engine's build (``plan_gramians``: the
relation statistics, the fused encodings, the byte budget), read from the
program's set-up span ``bdf.build.plan``; None where the program records
no such span."""
from benchmark.spans import setup_phase


def read(ctx):
    return setup_phase("bdf.build.plan")
