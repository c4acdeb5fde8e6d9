"""The port's examples on the CPU, at their smallest size, beside the JAX
package's: ``torch_quickstart.py`` prints what ``quickstart.py`` prints
(rows and modeled bytes), ``torch_sparql_lubm.py`` prints the same plans
(``--explain``) and the same rows for an ad-hoc query (``--sparql``) at one
university, and ``torch_serve_lm.py`` serves the reduced qwen3-8b. Without
``--device cpu`` an example asks for the card, and a host without one
refuses."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
QUERY = "SELECT ?x WHERE { ?x a <Professor> . ?x <worksFor> <Dept0.U0> . }"


def _run(script, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, str(ROOT / "examples" / script),
                           *args], env=env, capture_output=True, text=True,
                          timeout=600)


def _ok(out):
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    return out.stdout


def test_quickstart_prints_what_the_reference_prints():
    got = _ok(_run("torch_quickstart.py", "--device", "cpu"))
    assert got == _ok(_run("quickstart.py"))
    assert got.count("('Article") == 4


@pytest.mark.parametrize("args", [["--explain"], ["--sparql", QUERY]],
                         ids=["explain", "sparql"])
def test_sparql_lubm_matches_the_reference(args):
    got = _ok(_run("torch_sparql_lubm.py", "1", "--device", "cpu", *args))
    assert got == _ok(_run("sparql_lubm.py", "1", *args))
    if args[0] == "--sparql":
        assert "-- 0 rows" not in got and "overflow=0" in got


def test_serve_lm_on_the_cpu():
    got = _ok(_run("torch_serve_lm.py", "--device", "cpu"))
    assert "prefill(" in got and "on cpu" in got and "sampled ids" in got


def test_examples_ask_for_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    out = _run("torch_quickstart.py")
    assert out.returncode != 0 and "CUDA is not available" in out.stderr
