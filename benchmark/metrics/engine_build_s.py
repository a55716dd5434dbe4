"""Seconds to build the engine on the host clock: the planner, the stores
and layouts, their upload (``MacauEngine(...)``)."""


def read(ctx):
    return ctx["engine_build_s"]
