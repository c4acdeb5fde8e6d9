"""The port's training path for every LM family against the JAX package's:
one ``make_train_step`` step of each TransformerLM family (the cases of
tests/test_torch_lm_families.py: qwen3-8b, deepseek-7b, yi-34b, dbrx-132b,
pixtral-12b, musicgen-large, dbrx-132b with a leading dense layer and a
shared expert, deepseek-v3-671b with its ``mtp`` subtree, yi-6b with a
sliding window) at one microbatch, and a MoE case at two; the token
pipeline's vlm and audio branches; checkpoints of the MoE, MLA and
recurrent parameter and optimizer trees across the two packages; the
training CLI for every registered arch; and ``examples/torch_train_lm.py``.

Both sides run each config at ``reduce_for_smoke``. The JAX parameters are
made once a case by ``init_tree`` and carried over with
``params_from_numpy``; batches come from numpy's RandomState (some labels
-1); the JAX step runs under ``jax.jit``. Tolerances are
tests/test_torch_recurrent.py's for a train step:
- every metric within 1e-5 of its size;
- every updated parameter within 1e-6, except where the reference's
  gradient lies within the gradient bound (1e-5 of the leaf's largest) of
  zero: there Adam's first update, lr g / (|g| + eps), may take either
  sign, so those entries are held within 2 lr;
- tokens and checkpoints bit for bit.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import latest as j_latest
from repro.checkpoint import load as j_load
from repro.checkpoint import save as j_save
from repro.common import tree_paths as j_tree_paths
from repro.configs import get_config as j_get_config
from repro.configs import reduce_for_smoke as j_reduce
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.data import batch_for_step as j_batch_for_step
from repro.models import api as japi
from repro.models import build_model as j_build_model
from repro.models.params import init_tree
from repro.optim import OptConfig as JOptConfig
from repro.optim import adamw as jadamw

from repro_torch.checkpoint import latest, load, save
from repro_torch.common import tree_map_with_path, tree_paths
from repro_torch.configs import get_config, list_archs, reduce_for_smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import batch_for_step
from repro_torch.models import build_model, make_train_step
from repro_torch.models.params import params_from_numpy
from repro_torch.optim import OptConfig, init_opt_state

ROOT = Path(__file__).resolve().parents[1]
B, S = 2, 40
OPT = dict(learning_rate=3e-4, warmup_steps=10, decay_steps=110)
VARIANTS = {"mixed": dict(first_dense_layers=1, dense_d_ff=96,
                          num_shared_experts=1),
            "window": dict(window_size=32)}
CASES = ["qwen3-8b", "deepseek-7b", "yi-34b", "dbrx-132b", "pixtral-12b",
         "musicgen-large", "dbrx-132b+mixed", "deepseek-v3-671b",
         "yi-6b+window"]


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, rel, atol=0.0):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = _np(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale + atol)


def _to_numpy(tree):
    """A JAX tree as numpy; bfloat16 leaves as float32 (numpy has none)."""
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32))
                        if a.dtype == jnp.bfloat16 else np.asarray(a), tree)


def _configs(case, **over):
    arch, _, variant = case.partition("+")
    jcfg, cfg = j_reduce(j_get_config(arch)), reduce_for_smoke(get_config(arch))
    over = dict(VARIANTS.get(variant, {}), **over)
    return dataclasses.replace(jcfg, **over), dataclasses.replace(cfg, **over)


def _batch(cfg, rows, rng):
    """rows x S positions: tokens, labels (10% masked), and the vlm
    family's patch embeddings (S counts them) or the audio family's
    codebooks."""
    s = S - cfg.num_patches
    tail = (cfg.num_codebooks,) if cfg.family == "audio" else ()
    toks = rng.randint(0, cfg.vocab_size, (rows, s) + tail).astype(np.int32)
    labels = rng.randint(0, cfg.vocab_size, (rows, s) + tail).astype(np.int32)
    labels[rng.rand(*labels.shape) < 0.1] = -1
    batch = {"tokens": toks, "labels": labels}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.randn(rows, cfg.num_patches, 1024).astype(
            np.float32)
    return batch


# ---------------------------------------------------------------------------
# One train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case,micro", [(c, 1) for c in CASES]
                         + [("dbrx-132b+mixed", 2)])
def test_train_step_matches_jax(case, micro):
    jcfg, cfg = _configs(case)
    jmodel = j_build_model(jcfg)
    jparams = init_tree(jmodel.param_defs(), jax.random.key(0))
    batch = _batch(cfg, B, np.random.RandomState(0))
    fold = ((lambda a: a.reshape(micro, B // micro, *a.shape[1:]))
            if micro > 1 else (lambda a: a))
    batch = {k: fold(v) for k, v in batch.items()}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    # the reference's gradient, for the entries Adam may move either way
    grads_of = jax.jit(jax.grad(lambda p, b: jmodel.loss(p, b)[0]))
    if micro == 1:
        jgrads = grads_of(jparams, jbatch)
    else:
        parts = [grads_of(jparams, {k: v[i] for k, v in jbatch.items()})
                 for i in range(micro)]
        jgrads = jax.tree.map(lambda *g: sum(g) / micro, *parts)
    jgrads = dict(j_tree_paths(jgrads))
    jstep = jax.jit(japi.make_train_step(jmodel, JOptConfig(**OPT), micro))
    jp, jstate, jm = jstep(jparams,
                           jadamw.init_opt_state(jparams, JOptConfig(**OPT)),
                           jbatch)

    params = params_from_numpy(_to_numpy(jparams), "cpu")
    step = make_train_step(build_model(cfg, "cpu"), OptConfig(**OPT), micro)
    tp, state, m = step(params, init_opt_state(params, OptConfig(**OPT)),
                        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert sorted(m) == sorted(jm)
    assert ("mtp_ce" in m) == bool(cfg.mtp_depth)
    for k in m:
        _close(m[k], jm[k], 1e-5)
    lr = float(jm["lr"])
    flat = dict(tree_paths(tp))
    assert set(flat) == set(jgrads)
    if cfg.mtp_depth:
        assert any(p[0] == "mtp" for p in flat)
    for path, want in j_tree_paths(jp):
        d = np.abs(flat[path].numpy() - np.asarray(want))
        g = np.abs(np.asarray(jgrads[path]))
        assert d.max() <= 2 * lr * 1.01 + 1e-6, path
        assert (g[d > 1e-6] <= 1e-5 * g.max()).all(), path
    assert int(state["step"]) == int(jstate["step"]) == 1


# ---------------------------------------------------------------------------
# Tokens
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["pixtral-12b", "musicgen-large"])
@pytest.mark.parametrize("seed,step,rows", [(0, 0, None), (2, 9, np.arange(1, 3))])
def test_batch_for_step_bit_identical(arch, seed, step, rows):
    """The vlm branch (text tokens after the patches, stub patch
    embeddings) and the audio branch (one stream a codebook) at the full
    configs' num_patches and num_codebooks."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    shape = ShapeConfig("t", 512, 4, "train")
    jshape = JShapeConfig("t", 512, 4, "train")
    got = batch_for_step(cfg, shape, step, seed, rows)
    want = j_batch_for_step(jcfg, jshape, step, seed, rows)
    assert sorted(got) == sorted(want)
    n = 4 if rows is None else len(rows)
    if cfg.family == "vlm":
        assert got["tokens"].shape == (n, 512 - cfg.num_patches)
        assert got["patch_embeds"].shape == (n, cfg.num_patches, 1024)
    else:
        assert got["tokens"].shape == (n, 512, cfg.num_codebooks)
    for k in got:
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))


# ---------------------------------------------------------------------------
# Checkpoints across the packages
# ---------------------------------------------------------------------------

CKPT_CASES = ["dbrx-132b+mixed", "deepseek-v3-671b", "recurrentgemma-9b"]


def _trained_jax(case):
    """bfloat16 parameters after one JAX train step, and its float32
    moments: the trees a checkpoint holds."""
    jcfg, cfg = _configs(case, param_dtype="bfloat16",
                         activation_dtype="bfloat16")
    jmodel = j_build_model(jcfg)
    jparams = init_tree(jmodel.param_defs(), jax.random.key(1))
    batch = {k: jnp.asarray(v) for k, v in
             _batch(cfg, B, np.random.RandomState(1)).items()}
    jstep = jax.jit(japi.make_train_step(jmodel, JOptConfig(**OPT), 1))
    jp, jstate, _ = jstep(jparams, jadamw.init_opt_state(jparams,
                                                         JOptConfig(**OPT)),
                          batch)
    return cfg, {"params": jp, "opt_state": jstate}


def _as_torch(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _port_templates(cfg):
    params = build_model(cfg, "cpu").init_params(0)
    return {"params": params,
            "opt_state": init_opt_state(params, OptConfig(**OPT))}


def _assert_bits(torch_tree, jax_tree):
    jflat = dict(j_tree_paths(jax_tree))
    flat = dict(tree_paths(torch_tree))
    assert set(flat) == set(jflat)
    for path, t in flat.items():
        want = _as_torch(jflat[path])
        assert t.dtype == want.dtype and t.shape == want.shape, path
        assert torch.equal(t, want), path


@pytest.mark.parametrize("case", CKPT_CASES)
def test_checkpoint_from_jax_loads_in_the_port_and_back(case, tmp_path):
    """The JAX package writes; the port loads every leaf bit for bit, writes
    again, and the JAX package reads its own bits back."""
    cfg, trees = _trained_jax(case)
    j_save(str(tmp_path / "jax"), 1, trees)
    step, got = load(latest(str(tmp_path / "jax")), _port_templates(cfg))
    assert step == 1
    _assert_bits(got, trees)
    save(str(tmp_path / "port"), 2, got)
    jtempl = jax.tree.map(jnp.zeros_like, trees)
    jstep, back = j_load(j_latest(str(tmp_path / "port")), jtempl)
    assert jstep == 2
    _assert_bits(got, back)


@pytest.mark.parametrize("case", CKPT_CASES)
def test_checkpoint_from_the_port_loads_in_jax_and_back(case, tmp_path):
    """The port trains a step and writes; the JAX package loads every leaf
    bit for bit, writes again, and the port reads its own bits back."""
    jcfg, cfg = _configs(case, param_dtype="bfloat16",
                         activation_dtype="bfloat16")
    model = build_model(cfg, "cpu")
    params = model.init_params(1)
    opt = OptConfig(**OPT)
    batch = {k: torch.from_numpy(v) for k, v in
             _batch(cfg, B, np.random.RandomState(1)).items()}
    params, state, _ = make_train_step(model, opt)(
        params, init_opt_state(params, opt), batch)
    trees = {"params": params, "opt_state": state}
    assert any(t.dtype == torch.bfloat16 for _, t in tree_paths(trees))
    save(str(tmp_path / "port"), 1, trees)
    jmodel = j_build_model(jcfg)
    jparams = init_tree(jmodel.param_defs(), jax.random.key(5))
    jtempl = {"params": jparams,
              "opt_state": jadamw.init_opt_state(jparams, JOptConfig(**OPT))}
    jstep, jtrees = j_load(j_latest(str(tmp_path / "port")), jtempl)
    assert jstep == 1
    _assert_bits(trees, jtrees)
    j_save(str(tmp_path / "jax"), 2, jtrees)
    step, back = load(latest(str(tmp_path / "jax")),
                      tree_map_with_path(lambda _, t: torch.zeros_like(t), trees))
    assert step == 2
    for (path, a), (_, b) in zip(tree_paths(trees), tree_paths(back)):
        assert a.dtype == b.dtype and torch.equal(a, b), path


# ---------------------------------------------------------------------------
# The CLI and the example
# ---------------------------------------------------------------------------


def _run(argv, cwd, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, *argv], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("arch", list_archs())
def test_train_cli_trains_every_arch_on_the_cpu(arch, tmp_path):
    out = _run(["-m", "repro_torch.launch.train", "--arch", arch, "--smoke",
                "--device", "cpu", "--steps", "2", "--workdir",
                str(tmp_path)], ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "step     1  loss" in out.stdout and "done on cpu" in out.stdout
    loss = [float(line.split()[3]) for line in out.stdout.splitlines()
            if line.startswith("step")]
    assert len(loss) == 2 and all(np.isfinite(loss))


def test_torch_train_lm_example_runs_on_the_cpu(tmp_path):
    out = _run([str(ROOT / "examples" / "torch_train_lm.py"), "--device",
                "cpu", "--steps", "12"], tmp_path)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "arch=xlstm-125m steps=12 device=cpu" in out.stdout
    assert "checkpoints: step_00000010" in out.stdout
