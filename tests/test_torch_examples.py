"""The port's examples (``examples_torch/``) run end to end on the CPU at
tiny sizes (``--device cpu``), as ``tests/test_examples.py`` runs the JAX
package's."""
import os
import subprocess
import sys

import numpy as np

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples_torch")


def _run(script, argv, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.dirname(EXAMPLES) + os.pathsep
                         + env.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES, script), "--device", "cpu",
         *argv], capture_output=True, text=True, timeout=timeout, env=env)
    assert r.returncode == 0, f"{script} failed:\n{r.stdout}\n{r.stderr}"
    return r.stdout


def test_movielens_example():
    out = _run("movielens.py", ["--variant", "100k", "--num-latent", "4",
                                "--burnin", "2", "--psamples", "2"])
    assert "RMSE" in out


def test_movielens_example_reads_a_ratings_file(tmp_path):
    """``--data``: a written ``u.data`` (60 users x 40 movies, gappy
    1-based ids, a timestamp column) is parsed and trained on."""
    rng = np.random.default_rng(8)
    u = rng.integers(0, 60, 1_500) * 2 + 1
    m = rng.integers(0, 40, 1_500) * 3 + 5
    r = rng.integers(1, 6, 1_500)
    p = tmp_path / "u.data"
    p.write_text("".join(f"{a}\t{b}\t{c}\t{881250949 + i}\n"
                         for i, (a, b, c) in enumerate(zip(u, m, r))))
    out = _run("movielens.py", ["--data", str(p), "--num-latent", "4",
                                "--burnin", "2", "--psamples", "2"])
    assert "RMSE" in out


def test_chembl_example(tmp_path):
    out = _run("chembl_macau.py",
               ["--compounds", "400", "--features", "600",
                "--num-latent", "4", "--burnin", "3", "--psamples", "3",
                "--save-prefix", str(tmp_path / "chembl")])
    assert "AUC" in out
    assert "new-compound predictions: (5, " in out


def test_fusion_graph_example():
    out = _run("fusion_graph.py", ["--compounds", "300", "--num-latent", "4",
                                   "--burnin", "2", "--psamples", "2"])
    assert "ic50 RMSE" in out
