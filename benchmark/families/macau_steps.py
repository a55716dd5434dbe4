"""The Macau family's steps for the harness's own run: those of
``families/macau.py`` without its ``run_cell``, which hands the run here
once it has joined the beta draw's limits to the cell's."""
import os

from benchmark import harness

_macau = harness.load_module(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "macau.py"))
make_data = _macau.make_data
port_inputs = _macau.port_inputs
build_engine = _macau.build_engine
shape = _macau.shape
plan = _macau.plan
snapshot = _macau.snapshot
check = _macau.check
