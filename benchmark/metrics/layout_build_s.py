"""Seconds of the gather path's bucket layouts in the engine's build
(built on the host and uploaded), read from the program's set-up spans
``bdf.build.layouts``; None where the program records no such span or the
plan puts no mode on the gather path."""
from benchmark.spans import setup_phase


def read(ctx):
    return setup_phase("bdf.build.layouts")
