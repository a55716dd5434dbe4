"""The port, its GPU smoke script and its examples import neither jax nor
the JAX package (nor its oracle, which imports jax)."""
import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "bayesiandatafusion_jl_tpu_torch")
EXAMPLES = os.path.join(ROOT, "examples_torch")
FORBIDDEN = ("jax", "jaxlib", "bayesiandatafusion_jl_tpu", "oracle")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in (*os.walk(PORT), *os.walk(EXAMPLES)):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    bad = [m for m in _imported(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_scan_covers_the_port():
    rel = {os.path.relpath(p, ROOT) for p in _sources()}
    for must in ("chip_smoke.py",
                 "bayesiandatafusion_jl_tpu_torch/models/engine.py",
                 "bayesiandatafusion_jl_tpu_torch/ops/chol_packed.py",
                 "bayesiandatafusion_jl_tpu_torch/ops/chol_blocked.py",
                 "bayesiandatafusion_jl_tpu_torch/ops/chol_full.py",
                 "bayesiandatafusion_jl_tpu_torch/ops/fused_pair.py",
                 "bayesiandatafusion_jl_tpu_torch/ops/gather_expand.py",
                 "bayesiandatafusion_jl_tpu_torch/ops/pair_contract.py",
                 "bayesiandatafusion_jl_tpu_torch/ops/ytab.py",
                 "bayesiandatafusion_jl_tpu_torch/models/datasets.py",
                 "bayesiandatafusion_jl_tpu_torch/ops/gramian.py",
                 "bayesiandatafusion_jl_tpu_torch/ops/layout.py",
                 "bayesiandatafusion_jl_tpu_torch/ops/mvn.py",
                 "bayesiandatafusion_jl_tpu_torch/kernels.py",
                 "bayesiandatafusion_jl_tpu_torch/ops/sparse.py",
                 "examples_torch/movielens.py",
                 "examples_torch/chembl_macau.py",
                 "examples_torch/fusion_graph.py"):
        assert must in rel
