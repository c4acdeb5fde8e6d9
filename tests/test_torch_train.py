"""The port's LM training path against the JAX package's: AdamW and its
schedule, the chunked cross-entropy, the attention backward, the model's
loss and every gradient leaf, the train step, the token pipeline,
checkpoints across packages, and the Trainer's crash-resume.

The model is ``reduce_for_smoke(yi-6b)`` with num_kv_heads=2 (GQA repeats
each kv head twice), float32. JAX parameters come from ``init_tree`` and
are carried over with ``params_from_numpy``; batches come from numpy's
RandomState, some labels -1 (masked). Reference functions run under
``jax.jit``. Tolerances, all float32 (the JAX package enables x64, but
every array here is float32):
- ``cosine_lr``, ``global_norm``: 1e-6 relative (a few ulps);
- ``adamw_update`` on identical grads: params, float32 moments and the
  metrics within 1e-6 relative + 1e-9 (``b ** step`` and the division
  chain may round differently in the last ulp); bfloat16 moments within
  one bfloat16 step (2^-8 relative: a float32 value one ulp off may round
  to the neighbouring bfloat16); the step counter equal;
- the cross-entropy and its gradients: 1e-5 relative to the largest
  value (the logsumexp and the chunk sums are taken in another order);
- the attention backward (``flash_attention_backward_plain`` against
  ``jax.vjp`` of ``naive_attention``): 1e-5 absolute on O(1) inputs;
- ``model.loss``: 1e-5 absolute, every gradient leaf within 1e-5 of the
  leaf's largest gradient (the port's full-softmax attention against the
  reference's blockwise online softmax, through 4 layers: measured up to
  6e-7);
- one train step: the metrics within 1e-5 relative; the parameters
  within 1e-6, except that at step 1 AdamW moves a parameter by about
  lr * sign(g), so where a near-zero gradient differs in sign between
  the packages a parameter may differ by up to 2 lr: at most 0.1% of the
  elements, and none by more than 2 lr;
- tokens, checkpoints (bfloat16 leaves included) and the Trainer's
  resume: bit for bit.
"""
import dataclasses
import os
import subprocess
import sys
import types
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
from repro.configs import get_config as j_get_config
from repro.configs import reduce_for_smoke as j_reduce
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.data import batch_for_step as j_batch_for_step
from repro.models import api as japi
from repro.models import attention as jattn
from repro.models import build_model as j_build_model
from repro.models import layers as jlayers
from repro.models.params import init_tree
from repro.optim import OptConfig as JOptConfig
from repro.optim import adamw as jadamw

from repro_torch.checkpoint import latest, load, save
from repro_torch.common import tree_map_with_path, tree_paths
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import batch_for_step
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.launch import train as train_cli
from repro_torch.models import (build_model, default_micro_batches,
                                input_defs, layers, loss_and_grads,
                                make_train_step)
from repro_torch.models.params import params_from_numpy
from repro_torch.optim import (OptConfig, adamw_update, cosine_lr,
                               global_norm, init_opt_state, opt_state_defs)
from repro_torch.runtime import SimulatedFailure, Trainer

ROOT = Path(__file__).resolve().parents[1]
B, S = 2, 48
OPT = dict(learning_rate=3e-4, warmup_steps=10, decay_steps=110)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    """A JAX array (or numpy) as a float32/int tensor on the CPU."""
    a = np.asarray(x)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _close(got, want, rel, atol=0.0):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = _np(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale + atol)


@pytest.fixture(scope="module")
def lm():
    jcfg = dataclasses.replace(j_reduce(j_get_config("yi-6b")), num_kv_heads=2)
    cfg = dataclasses.replace(reduce_for_smoke(get_config("yi-6b")),
                              num_kv_heads=2)
    jmodel = j_build_model(jcfg)
    jparams = init_tree(jmodel.param_defs(), jax.random.key(0))
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[rng.rand(B, S) < 0.1] = -1
    return dict(jcfg=jcfg, cfg=cfg, jmodel=jmodel, jparams=jparams,
                np_params=jax.tree.map(np.asarray, jparams),
                batch={"tokens": toks, "labels": labels})


def _params(lm):
    return params_from_numpy(lm["np_params"], "cpu")


def _grads(model, params, batch):
    loss, metrics, grads = loss_and_grads(model, params, batch)
    return loss, metrics, dict(tree_paths(grads))


# --- optimizer --------------------------------------------------------------


@pytest.mark.parametrize("step", [0, 5, 10, 60, 110, 500])
def test_cosine_lr_matches_jax(step):
    got = cosine_lr(OptConfig(**OPT), torch.tensor(step, dtype=torch.int32))
    want = jadamw.cosine_lr(JOptConfig(**OPT), jnp.int32(step))
    assert got.dtype == torch.float32
    _close(got, want, 1e-6)


def _opt_inputs(rng):
    shapes = {"w": (3, 5, 4), "m": (6, 7), "b": (7,)}
    p = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    g = {k: (rng.randn(*s) * 0.3).astype(np.float32) for k, s in shapes.items()}
    g["b"][:3] = 0.0                             # a 1-d leaf with zero grads
    g["m"][0] = 0.0                              # and a matrix row
    return p, g


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(moment_dtype, rng):
    """Three steps on identical grads: params, moments, step and metrics,
    with clipping active (clip_norm below the grads' norm)."""
    cfg = dict(OPT, warmup_steps=2, clip_norm=0.5, moment_dtype=moment_dtype)
    p, g = _opt_inputs(rng)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    jstate = jadamw.init_opt_state(jp, JOptConfig(**cfg))
    state = init_opt_state(tp, OptConfig(**cfg))
    jupd = jax.jit(lambda g, s, p: jadamw.adamw_update(g, s, p, JOptConfig(**cfg)))
    mtol = 2 ** -8 if moment_dtype == "bfloat16" else 1e-6
    for _ in range(3):
        jp, jstate, jm = jupd(jg, jstate, jp)
        tp, state, m = adamw_update(tg, state, tp, OptConfig(**cfg))
        assert int(state["step"]) == int(jstate["step"])
        assert state["step"].dtype == torch.int32
        for k in p:
            _close(tp[k], jp[k], 1e-6, 1e-9)
            for mom in ("mu", "nu"):
                assert state[mom][k].dtype == getattr(torch, moment_dtype)
                _close(state[mom][k], jstate[mom][k], mtol, 1e-12)
        _close(m["grad_norm"], jm["grad_norm"], 1e-6)
        _close(m["lr"], jm["lr"], 1e-6)
    # decoupled weight decay reaches matrices only: zero-grad entries of a
    # matrix shrink, those of the 1-d leaf stay
    assert torch.equal(tp["b"][:3], torch.from_numpy(p["b"][:3]))
    assert (tp["m"][0].abs() < torch.from_numpy(p["m"][0]).abs()).all()


def test_global_norm_matches_jax(rng):
    _, g = _opt_inputs(rng)
    got = global_norm({k: torch.from_numpy(v) for k, v in g.items()})
    want = jadamw.global_norm({k: jnp.asarray(v) for k, v in g.items()})
    _close(got, want, 1e-6)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_opt_state_defs_match_jax(lm, moment_dtype):
    defs = opt_state_defs(build_model(lm["cfg"], "cpu").param_defs(),
                          OptConfig(moment_dtype=moment_dtype))
    jdefs = jadamw.opt_state_defs(lm["jmodel"].param_defs(),
                                  JOptConfig(moment_dtype=moment_dtype))
    got = {p: (d.shape, d.axes, d.dtype, d.init) for p, d in tree_paths(defs)}
    want = {p: (d.shape, d.axes, d.dtype, d.init)
            for p, d in _tree_paths_np(jdefs)}
    assert got == want


# --- cross-entropy and attention backward -----------------------------------


def test_softmax_xent_chunked_matches_jax(rng):
    """Two chunks of 16 and a remainder of 8, labels -1 at masked
    positions, value and gradients of hidden and head_w."""
    b, s, d, v = 2, 40, 16, 24
    h = rng.randn(b, s, d).astype(np.float32)
    w = (rng.randn(d, v) * 0.5).astype(np.float32)
    y = rng.randint(0, v, (b, s)).astype(np.int32)
    y[rng.rand(b, s) < 0.2] = -1
    m = (y >= 0).astype(np.float32)

    def jloss(h, w):
        return jlayers.softmax_xent_chunked(h, w, jnp.asarray(y),
                                            jnp.asarray(m), chunk=16)
    want, (jdh, jdw) = jax.jit(jax.value_and_grad(jloss, (0, 1)))(
        jnp.asarray(h), jnp.asarray(w))
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    got = layers.softmax_xent_chunked(th, tw, torch.from_numpy(y),
                                      torch.from_numpy(m), chunk=16)
    got.backward()
    _close(got.detach(), want, 1e-5)
    _close(th.grad, jdh, 1e-5)
    _close(tw.grad, jdw, 1e-5)


@pytest.mark.parametrize("causal,sq,skv", [(True, 48, 48), (False, 48, 48),
                                           (True, 24, 48)])
def test_flash_attention_backward_matches_jax(causal, sq, skv, rng):
    """dq, dk, dv against jax.vjp of the reference's naive attention (GQA
    2, query blocks of 20 rows: two whole and a ragged one), directly and
    through ops.flash_attention's autograd."""
    b, h, g, e = 2, 4, 2, 16
    q, k, v = (rng.randn(b, n, heads, e).astype(np.float32)
               for n, heads in ((sq, h), (skv, g), (skv, g)))
    do = rng.randn(b, sq, h, e).astype(np.float32)
    out, vjp = jax.vjp(lambda q, k, v: jattn.naive_attention(
        q, k, v, causal=causal), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o = fa.flash_attention_plain(tq, tk, tv, causal)
    _close(o, out, 0, 1e-5)
    got = fa.flash_attention_backward_plain(tq, tk, tv, o, tdo, causal,
                                            block_q=20)
    for x, w in zip(got, want):
        _close(x, w, 0, 1e-5)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    before = dict(ops.launches)
    ops.flash_attention(*leaves, causal=causal).backward(tdo)
    assert ops.launches == before                # the CPU runs no kernel
    for t, w in zip(leaves, want):
        _close(t.grad, w, 0, 1e-5)


# --- the model --------------------------------------------------------------


@pytest.mark.parametrize("remat", ["names", "none"])
def test_loss_and_grads_match_jax(lm, remat):
    jmodel = j_build_model(dataclasses.replace(lm["jcfg"], remat_policy=remat))
    jbatch = {k: jnp.asarray(v) for k, v in lm["batch"].items()}
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        jmodel.loss, has_aux=True))(lm["jparams"], jbatch)
    model = build_model(dataclasses.replace(lm["cfg"], remat_policy=remat),
                        "cpu")
    batch = {k: torch.from_numpy(v) for k, v in lm["batch"].items()}
    loss, met, grads = _grads(model, _params(lm), batch)
    _close(loss, jloss, 0, 1e-5)
    _close(met["ce"], jmet["ce"], 0, 1e-5)
    assert float(met["aux"]) == float(jmet["aux"]) == 0.0
    jflat = dict((p, a) for p, a in _tree_paths_np(jgrads))
    assert set(grads) == set(jflat)
    for path, gr in grads.items():
        assert gr.shape == jflat[path].shape, path
        _close(gr, jflat[path], 1e-5)


def _tree_paths_np(tree):
    from repro.common import tree_paths as jtp
    return list(jtp(tree))


@pytest.mark.parametrize("policy", ["minimal", "full"])
def test_remat_policies_give_the_same_gradients(lm, policy):
    """Remat changes what is kept for the backward, not a bit of it."""
    batch = {k: torch.from_numpy(v) for k, v in lm["batch"].items()}
    base = _grads(build_model(dataclasses.replace(lm["cfg"], remat_policy="none"),
                              "cpu"), _params(lm), batch)
    got = _grads(build_model(dataclasses.replace(lm["cfg"], remat_policy=policy),
                             "cpu"), _params(lm), batch)
    assert torch.equal(got[0], base[0])
    for path in base[2]:
        assert torch.equal(got[2][path], base[2][path]), path


@pytest.mark.parametrize("micro", [1, 2])
def test_train_step_matches_jax(lm, micro):
    jmodel, model = lm["jmodel"], build_model(lm["cfg"], "cpu")
    fold = (lambda a: a.reshape(micro, B // micro, *a.shape[1:])) if micro > 1 \
        else (lambda a: a)
    batch = {k: fold(v) for k, v in lm["batch"].items()}
    jstep = jax.jit(japi.make_train_step(jmodel, JOptConfig(**OPT), micro))
    jstate = jadamw.init_opt_state(lm["jparams"], JOptConfig(**OPT))
    jp, jstate, jm = jstep(lm["jparams"], jstate,
                           {k: jnp.asarray(v) for k, v in batch.items()})
    params = _params(lm)
    step = make_train_step(model, OptConfig(**OPT), micro)
    tp, state, m = step(params, init_opt_state(params, OptConfig(**OPT)),
                        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert sorted(m) == sorted(jm)
    for k in m:
        _close(m[k], jm[k], 1e-5)
    lr = float(jm["lr"])
    for path, want in _tree_paths_np(jp):
        d = np.abs(_flat(tp, path).detach().numpy() - np.asarray(want))
        assert d.max() <= 2 * lr * 1.01 + 1e-6, path
        assert (d > 1e-6).mean() <= 1e-3, path
    assert int(state["step"]) == int(jstate["step"]) == 1


def _flat(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def test_input_defs_and_micro_batches_match_jax(lm):
    shape = ShapeConfig("t", 64, 8, "train")
    jshape = JShapeConfig("t", 64, 8, "train")
    for n in (1, 2, 4):
        got = {k: (d.shape, d.axes, d.dtype)
               for k, d in input_defs(lm["cfg"], shape, n).items()}
        want = {k: (d.shape, d.axes, d.dtype)
                for k, d in japi.input_defs(lm["jcfg"], jshape, n).items()}
        assert got == want
    big = ShapeConfig("t", 4096, 256, "train")
    jbig = JShapeConfig("t", 4096, 256, "train")
    full, jfull = get_config("yi-6b"), j_get_config("yi-6b")
    for mesh in (None, types.SimpleNamespace(shape={"data": 8}),
                 types.SimpleNamespace(shape={"data": 4, "pod": 2})):
        assert default_micro_batches(full, big, mesh) == \
            japi.default_micro_batches(jfull, jbig, mesh)
    assert default_micro_batches(full, big) == 1


# --- data and checkpoints ---------------------------------------------------


@pytest.mark.parametrize("seed,step,rows", [(0, 0, None), (3, 7, None),
                                            (1, 12345, np.arange(4, 8))])
def test_batch_for_step_bit_identical(seed, step, rows):
    cfg, jcfg = get_config("yi-6b"), j_get_config("yi-6b")
    shape, jshape = ShapeConfig("t", 256, 8, "train"), JShapeConfig("t", 256, 8, "train")
    got = batch_for_step(cfg, shape, step, seed, rows)
    want = j_batch_for_step(jcfg, jshape, step, seed, rows)
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])


def _ckpt_tree(rng):
    return {"a": {"w": rng.randn(3, 4).astype(np.float32),
                  "h": rng.randn(5).astype(ml_dtypes.bfloat16)},
            "c": [rng.randn(2, 2).astype(ml_dtypes.bfloat16), np.int32(7)]}


def test_checkpoint_written_by_jax_loads_in_the_port(tmp_path, rng):
    tree = _ckpt_tree(rng)
    j_save(str(tmp_path), 42, {"params": jax.tree.map(jnp.asarray, tree)})
    path = latest(str(tmp_path))
    assert path.endswith("step_00000042")
    templ = tree_map_with_path(lambda _, a: _t(a), tree)
    step, out = load(path, {"params": templ})
    assert step == 42
    for (p, a), (_, b) in zip(tree_paths(templ), tree_paths(out["params"])):
        assert b.dtype == a.dtype and torch.equal(a, b), p


def test_checkpoint_written_by_the_port_loads_in_jax(tmp_path, rng):
    tree = tree_map_with_path(lambda _, a: _t(a), _ckpt_tree(rng))
    for s in range(5):                          # keep=3: the oldest go
        save(str(tmp_path), s, {"params": tree}, keep=3)
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert kept == ["step_00000002", "step_00000003", "step_00000004"]
    jtempl = tree_map_with_path(
        lambda _, t: jnp.asarray(t.float().numpy()).astype(
            jnp.bfloat16 if t.dtype == torch.bfloat16 else t.numpy().dtype),
        tree)
    step, out = j_load(j_latest(str(tmp_path)), {"params": jtempl})
    assert step == 4
    for (p, a), (_, b) in zip(tree_paths(tree), _tree_paths_np(out["params"])):
        assert torch.equal(_t(b), a), p


# --- the trainer ------------------------------------------------------------


def test_trainer_crash_resume_bit_exact(tmp_path):
    """test_checkpoint_optim_data.py::test_crash_resume_bit_exact on the
    port: an uninterrupted run against a run killed at step 7 and resumed
    from its step-4 checkpoint."""
    cfg = reduce_for_smoke(get_config("yi-6b"))
    shape = ShapeConfig("tiny", 32, 2, "train")
    opt = OptConfig(warmup_steps=2, decay_steps=20)
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    p1, s1, m1 = Trainer(cfg, shape, d1, opt, ckpt_every=4, device="cpu").run(10)
    t2 = Trainer(cfg, shape, d2, opt, ckpt_every=4, device="cpu")
    with pytest.raises(SimulatedFailure):
        t2.run(10, fail_at=7)
    t2.ckpt.wait()                    # the write in flight when it "crashed"
    assert latest(d2).endswith("step_00000004")
    p2, s2, m2 = Trainer(cfg, shape, d2, opt, ckpt_every=4, device="cpu").run(10)
    assert float(m1["loss"]) == float(m2["loss"])
    assert int(s1["step"]) == int(s2["step"]) == 10
    for (path, a), (_, b) in zip(tree_paths((p1, s1)), tree_paths((p2, s2))):
        assert torch.equal(a, b), path


def test_training_entry_points_need_a_card(lm, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    shape = ShapeConfig("tiny", 32, 2, "train")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(lm["cfg"], shape, str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(lm["cfg"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--arch", "yi-6b", "--smoke", "--workdir",
                        str(tmp_path)])


def test_train_cli_runs_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "yi-6b",
         "--smoke", "--device", "cpu", "--steps", "2", "--workdir",
         str(tmp_path)], env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "step     1  loss" in out.stdout and "done on cpu" in out.stdout


@pytest.mark.gpu
def test_flash_attention_backward_on_the_card():
    """The kernel's forward with the plain backward against autograd of
    the plain forward, bf16 at yi-6b's head layout."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.RandomState(0)
    b, s, h, g, e = 1, 512, 32, 4, 128
    q, k, v, do = (torch.from_numpy(rng.randn(b, s, n, e).astype(np.float32))
                   .to("cuda", torch.bfloat16) for n in (h, g, g, h))
    grads = {}
    for impl in ("kernel", "torch"):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        ops.flash_attention(*leaves, impl=impl).backward(do)
        grads[impl] = [t.grad.float() for t in leaves]
    ref = [t.clone().float().requires_grad_() for t in (q, k, v)]
    fa.flash_attention_plain(*ref).backward(do.float())
    for got, want in zip(grads["torch"], ref):
        assert float((got - want.grad).abs().max()) <= 2 ** -5 * float(
            want.grad.abs().max())
    for got, want in zip(grads["kernel"], grads["torch"]):
        assert float((got - want).abs().max()) <= 2 ** -5 * float(
            want.abs().max())
