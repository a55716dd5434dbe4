"""Tiny sizes of the cells, for runs of the whole harness on the CPU with
the port's plain kernels."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# under 50,000 observations the planner puts every mode on the gather
# path, so the pair cells keep more; the fused cell forces its store
SIZES = {"ml10m": dict(n_users=700, n_movies=300, nnz=60_000, n_test=2_000),
         "netflix": dict(n_users=800, n_movies=300, nnz=60_000,
                         n_test=2_000)}
FORCE = {"netflix.k32_s8": {"dense_fused": True}}


def shrink(workload, K=8):
    """An ``override`` for ``harness.run_cell``: the cell at a tiny size
    and rank K, 3 sweeps a dispatch."""
    def override(cell):
        cell["config"]["data"].update(SIZES[cell["workload"]["config"]])
        t = cell["traffic"]
        t.update(num_latent=K, sweeps_per_dispatch=3, warm_windows=1,
                 trace_windows=1)
        t["engine"] = {**t.get("engine", {}), **FORCE.get(workload, {})}
    return override


def quiet(*a):
    pass
