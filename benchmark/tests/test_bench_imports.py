"""The import rule: nothing under benchmark/ loads JAX or the JAX package
(compared by whole top-level names: the port's name begins with the JAX
package's), and the reference loads nothing of the port."""
import ast
import os

from _tiny import ROOT

BENCH = os.path.join(ROOT, "benchmark")
JAX = {"jax", "jaxlib", "flax", "bayesiandatafusion_jl_tpu"}
PORT = "bayesiandatafusion_jl_tpu_torch"


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_loads_jax_or_the_jax_package():
    for path in _sources(BENCH):
        bad = set(_imports(path)) & JAX
        assert not bad, (path, bad)


def test_reference_loads_nothing_of_the_port():
    for path in _sources(os.path.join(BENCH, "reference")):
        assert PORT not in set(_imports(path)), path


def test_top_level_names_are_compared_whole():
    # the port's name begins with the JAX package's, and is allowed
    assert PORT.split(".")[0] not in JAX
