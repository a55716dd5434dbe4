"""The port and its GPU smoke script import neither jax nor the JAX
package (nor its oracle, which imports jax)."""
import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "bayesiandatafusion_jl_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "bayesiandatafusion_jl_tpu", "oracle")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PORT):
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
                 "bayesiandatafusion_jl_tpu_torch/ops/gramian.py",
                 "bayesiandatafusion_jl_tpu_torch/ops/layout.py",
                 "bayesiandatafusion_jl_tpu_torch/ops/mvn.py",
                 "bayesiandatafusion_jl_tpu_torch/kernels.py"):
        assert must in rel
