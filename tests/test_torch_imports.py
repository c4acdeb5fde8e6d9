"""The port stands alone: importing any of its modules loads neither jax
nor the JAX package, and the GPU smoke script refuses to run where it has
no card or no port beside it."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_CHECK = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), bad)
print(" ".join(names))
sys.exit(1 if bad else 0)
"""
# the LM families' modules: every config the port serves, the MoE layer
# and the recurrent models
FAMILY_MODULES = {f"repro_torch.configs.{m}" for m in (
    "dbrx_132b", "deepseek_7b", "deepseek_v3_671b", "musicgen_large",
    "pixtral_12b", "qwen3_8b", "recurrentgemma_9b", "xlstm_125m", "yi_34b",
    "yi_6b")} | {f"repro_torch.models.{m}" for m in ("moe", "recurrent",
                                                    "xlstm")}
# the sharding and launch slice: the rules, the mesh, the cost model, the
# dry-run and roofline, and the paper's workload config
SHARDING_MODULES = {"repro_torch.sharding", "repro_torch.sharding.rules",
                    "repro_torch.launch.mesh", "repro_torch.launch.costmodel",
                    "repro_torch.launch.dryrun", "repro_torch.launch.roofline",
                    "repro_torch.configs.mapsin_rdf"}
EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", _CHECK], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    count, _, names = out.stdout.partition("\n")
    assert int(count.split()[0]) >= 70               # every module was imported
    assert FAMILY_MODULES <= set(names.split())
    assert SHARDING_MODULES <= set(names.split())


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in
                                        [*PORT.rglob("*.py"),
                                         ROOT / "chip_smoke.py", *EXAMPLES]))
def test_no_jax_import_statement(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom)
                 else [])
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                f"{path}:{node.lineno} imports {name}"


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_refuses_without_the_port(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
