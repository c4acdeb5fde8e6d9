"""The port's RecurrentGemma (hybrid family: RG-LRU blocks and local
attention in a (rec, rec, attn) pattern) against the JAX package's, with
the pieces it shares with a windowed TransformerLM: ``rg_lru_scan``,
``causal_conv1d``, ``geglu``, ``local_attention`` and the windowed
``naive_attention`` and ``decode_attention``.

The JAX parameters are made once by ``init_tree`` at ``reduce_for_smoke``
(5 layers: one macro of (rec, rec, attn) and two tail rec layers; lru
width 64, window 32; float32 params and activations) and carried over with
``params_from_numpy``; inputs come from numpy's RandomState; reference
model steps run under ``jax.jit``. Tolerances:
- ``rg_lru_scan`` within rtol 2e-5, atol 1e-5 of the JAX scan and of a
  step-by-step float64 recurrence (tests/test_recurrent_cells.py's
  bounds);
- ``causal_conv1d``, ``geglu``, the attention functions within 1e-5 of the
  output's largest element (float32 sums in another order);
- prefill and decode logits within 1e-4 (as tests/test_torch_lm.py), and
  the caches leaf by leaf within 1e-5 of the leaf's largest element
  (the recurrent state h float32; the conv and attention caches in the
  activation dtype, float32 here);
- greedy ids equal;
- ``loss`` within 1e-5 absolute and every gradient leaf within 1e-5 of
  the leaf's largest gradient; one ``make_train_step`` step's metrics
  within 1e-5 of their size and each updated parameter within 1e-6,
  except where the reference's gradient is within the gradient bound of
  zero: there Adam's first update, lr g / (|g| + eps), may take either
  sign, so those entries are held within 2 lr (tests/test_torch_train.py's
  bound);
- the rotating window cache: prefill(s) and three decode steps equal to
  the reference at s = 20, 40 and 64 against window 32, within 1e-4. The
  reference's decode agrees with a longer prefill only where s is a
  multiple of the window (64); at 20 and 40 it is several percent of
  max|logits| away (ROADMAP, known behaviour 14), and so is the port's.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.common import tree_paths as j_tree_paths
from repro.configs import get_config as j_get_config
from repro.configs import reduce_for_smoke as j_reduce
from repro.models import attention as jattn
from repro.models import api as japi
from repro.models import build_model as j_build_model
from repro.models import layers as jlayers
from repro.models import recurrent as jrec
from repro.models.params import init_tree
from repro.optim import OptConfig as JOptConfig
from repro.optim import adamw as jadamw

from repro_torch.common import tree_paths
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.launch import serve
from repro_torch.models import attention, build_model, layers, loss_and_grads
from repro_torch.models import recurrent
from repro_torch.models import make_train_step
from repro_torch.models.params import cache_from_numpy, params_from_numpy
from repro_torch.optim import OptConfig, init_opt_state

ARCH = "recurrentgemma-9b"
B, S, DECODE = 2, 40, 3


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, rel, atol=0.0):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = _np(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale + atol)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# The pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_h0", [False, True])
def test_rg_lru_scan_matches_jax_and_recurrence(with_h0, rng):
    b, s, w = 2, 37, 8                        # an odd length
    u = rng.randn(b, s, w).astype(np.float32)
    log_a = -np.abs(rng.randn(b, s, w)).astype(np.float32)
    h0 = rng.randn(b, w).astype(np.float32) if with_h0 else None
    got = recurrent.rg_lru_scan(_t(u), _t(log_a), None if h0 is None else _t(h0))
    want = jrec.rg_lru_scan(jnp.asarray(u), jnp.asarray(log_a),
                            None if h0 is None else jnp.asarray(h0))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=2e-5, atol=1e-5)
    h = np.zeros((b, w)) if h0 is None else h0.astype(np.float64)
    a = np.exp(log_a.astype(np.float64))
    for t in range(s):
        h = a[:, t] * h + u[:, t]
        np.testing.assert_allclose(got[:, t].numpy(), h, rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_jax(with_state, rng):
    x = rng.randn(2, 9, 6).astype(np.float32)
    kernel = rng.randn(4, 6).astype(np.float32)
    state = rng.randn(2, 3, 6).astype(np.float32) if with_state else None
    y, new = layers.causal_conv1d(_t(x), _t(kernel),
                                  None if state is None else _t(state))
    jy, jnew = jlayers.causal_conv1d(jnp.asarray(x), jnp.asarray(kernel),
                                     None if state is None else jnp.asarray(state))
    _close(y, jy, 1e-5)
    np.testing.assert_array_equal(new.numpy(), _np(jnew))
    assert tuple(new.shape) == (2, 3, 6)


def test_geglu_matches_jax(rng):
    x, wg, wu = (rng.randn(*s).astype(np.float32) for s in
                 ((3, 5, 16), (16, 24), (16, 24)))
    wd = rng.randn(24, 16).astype(np.float32)
    got = layers.geglu(_t(x), _t(wg), _t(wu), _t(wd))
    want = jlayers.geglu(*(jnp.asarray(a) for a in (x, wg, wu, wd)))
    _close(got, want, 1e-5)
    # the exact GELU is another function: the tanh form is the one
    exact = (torch.nn.functional.gelu(_t(x) @ _t(wg)) * (_t(x) @ _t(wu))) @ _t(wd)
    assert float((exact - got).abs().max()) > 1e-4


def _qkv(rng, b=2, s=40, h=4, g=2, e=16):
    return [rng.randn(b, s, n, e).astype(np.float32) for n in (h, g, g)]


def test_local_attention_matches_jax_and_naive(rng):
    """40 positions in blocks of 16 (a short last block), window 8."""
    q, k, v = _qkv(rng)
    got = attention.local_attention(_t(q), _t(k), _t(v), window=8, block_q=16)
    want = jax.jit(lambda *a: jattn.local_attention(*a, window=8, block_q=16))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _close(got, want, 1e-5)
    naive = attention.naive_attention(_t(q), _t(k), _t(v), window=8)
    jnaive = jattn.naive_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), window=8)
    _close(naive, jnaive, 1e-5)
    _close(got, naive, 1e-5)
    # the dispatch sends a windowed causal call to local_attention under
    # every impl, the kernel's included, and a non-causal one to naive
    for impl in ("kernel", "torch"):
        assert torch.equal(attention.attention(
            _t(q), _t(k), _t(v), impl=impl, window=8, block_q=16), got)
    _close(attention.attention(_t(q), _t(k), _t(v), causal=False, window=8),
           jattn.naive_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=False, window=8), 1e-5)


@pytest.mark.parametrize("cur_len", [5, 12, 30])
def test_windowed_decode_attention_matches_jax(cur_len, rng):
    """A 12-slot rotating cache (window 12): the valid slots are those
    below min(cur_len, 12)."""
    q = rng.randn(2, 1, 4, 16).astype(np.float32)
    kc, vc = (rng.randn(2, 12, 2, 16).astype(np.float32) for _ in range(2))
    got = attention.decode_attention(_t(q), _t(kc), _t(vc),
                                     torch.tensor(cur_len, dtype=torch.int32),
                                     window=12)
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                  jnp.asarray(vc), jnp.int32(cur_len), window=12)
    _close(got, want, 1e-5)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

_LM: dict = {}


def _lm():
    """Models, carried-over weights, inputs and jitted JAX steps, made
    once."""
    if _LM:
        return _LM
    jcfg, cfg = j_reduce(j_get_config(ARCH)), reduce_for_smoke(get_config(ARCH))
    jmodel = j_build_model(jcfg)
    jparams = init_tree(jmodel.param_defs(), jax.random.key(0))
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg.vocab_size, (B, 64 + DECODE + 1)).astype(np.int32)
    labels = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[rng.rand(*labels.shape) < 0.1] = -1
    _LM.update(
        jcfg=jcfg, cfg=cfg, jmodel=jmodel, jparams=jparams,
        model=build_model(cfg, "cpu"),
        params=params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu"),
        toks=toks, labels=labels,
        prefill=jax.jit(jmodel.prefill),
        decode=jax.jit(lambda p, c, t: jmodel.decode_step(p, c, t)))
    return _LM


def _cache_close(cache, jcache):
    jflat = dict(j_tree_paths(jcache))
    flat = dict(tree_paths(cache))
    assert set(flat) == set(jflat)
    for path, t in flat.items():
        assert t.dtype == getattr(torch, str(jflat[path].dtype)), path
        assert tuple(t.shape) == jflat[path].shape, path
        _close(t, jflat[path], 1e-5)


def test_config_and_params_carry_over():
    lm = _lm()
    cfg = lm["cfg"]
    assert (cfg.num_layers, cfg.lru_width, cfg.window_size,
            cfg.block_pattern) == (5, 64, 32, ("rec", "rec", "attn"))
    full = get_config(ARCH)
    got, want = dataclasses.asdict(full), dataclasses.asdict(j_get_config(ARCH))
    assert got.pop("attention_impl") == "kernel"
    want.pop("attention_impl")
    assert got == want
    jdefs = dict(j_tree_paths(lm["jmodel"].param_defs()))
    defs = dict(tree_paths(lm["model"].param_defs()))
    assert {p: (d.shape, d.dtype, d.init, d.scale) for p, d in defs.items()} == \
        {p: (d.shape, d.dtype, d.init, d.scale) for p, d in jdefs.items()}
    assert {"macros", "tail0", "tail1", "lm_head"} <= set(lm["params"])
    full_defs = dict(tree_paths(build_model(full, "cpu").param_defs()))
    assert full_defs[("macros", "b0", "mix", "lam")].dtype == "float32"
    assert full_defs[("macros", "b0", "mix", "w_a")].dtype == "bfloat16"


def test_prefill_matches_jax():
    lm = _lm()
    tokens = lm["toks"][:, :S]
    jlogits, jcache = lm["prefill"](lm["jparams"], {"tokens": jnp.asarray(tokens)})
    logits, cache = lm["model"].prefill(lm["params"], {"tokens": _t(tokens)})
    assert tuple(logits.shape) == jlogits.shape == (B, lm["cfg"].vocab_size)
    np.testing.assert_allclose(logits.numpy(), _np(jlogits), rtol=0, atol=1e-4)
    assert int(cache["cur_len"]) == S
    _cache_close(cache, jcache)
    # the attention layer keeps the last 32 positions
    assert tuple(cache["macros"]["b2"][0].shape) == (1, B, 32, 1, 16)


def test_decode_steps_match_jax():
    """Three decode steps of the port from JAX's prefill cache (carried
    over) against JAX's decode_step, each fed JAX's greedy token; the
    caches after each step compared leaf by leaf."""
    lm = _lm()
    jlogits, jcache = lm["prefill"](lm["jparams"],
                                    {"tokens": jnp.asarray(lm["toks"][:, :S])})
    cache = cache_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    for _ in range(DECODE):
        tok = jnp.argmax(jlogits, axis=-1)[:, None].astype(jnp.int32)
        jlogits, jcache = lm["decode"](lm["jparams"], jcache, tok)
        logits, cache = lm["model"].decode_step(lm["params"], cache,
                                                _t(np.array(tok)))
        np.testing.assert_allclose(logits.numpy(), _np(jlogits), rtol=0,
                                   atol=1e-4)
        _cache_close(cache, jcache)


def test_greedy_loop_matches_jax():
    lm = _lm()
    n = 4
    tokens = lm["toks"][:, :S]
    jlogits, jcache = lm["prefill"](lm["jparams"], {"tokens": jnp.asarray(tokens)})
    want = []
    for _ in range(n):
        nxt = jnp.argmax(jlogits, axis=-1)
        want.append(np.asarray(nxt))
        jlogits, jcache = lm["decode"](lm["jparams"], jcache,
                                       nxt[:, None].astype(jnp.int32))
    ids, _, _ = serve.generate(lm["model"], lm["params"], _t(tokens), n)
    np.testing.assert_array_equal(ids.numpy(), np.stack(want, 1))


def _train_batch(lm):
    return {"tokens": lm["toks"][:, :S], "labels": lm["labels"]}


def _jax_loss_and_grads(lm):
    """The reference's (loss, metrics) and gradients on `_train_batch`,
    made once."""
    if "jgrads" not in lm:
        lm["jgrads"] = jax.jit(jax.value_and_grad(
            lm["jmodel"].loss, has_aux=True))(
                lm["jparams"],
                {k: jnp.asarray(v) for k, v in _train_batch(lm).items()})
    return lm["jgrads"]


def test_loss_and_grads_match_jax():
    lm = _lm()
    batch = _train_batch(lm)
    (jloss, jmet), jgrads = _jax_loss_and_grads(lm)
    loss, met, grads = loss_and_grads(lm["model"], lm["params"],
                                      {k: _t(v) for k, v in batch.items()})
    _close(loss, jloss, 0, 1e-5)
    assert set(met) == set(jmet) == {"ce", "aux"}
    for name in met:
        _close(met[name], jmet[name], 0, 1e-5)
    jflat = dict(j_tree_paths(jgrads))
    flat = dict(tree_paths(grads))
    assert set(flat) == set(jflat)
    for path, g in flat.items():
        assert g.shape == jflat[path].shape, path
        _close(g, jflat[path], 1e-5)


@pytest.mark.parametrize("s", [20, 40, 64])
def test_rotating_window_decode_matches_jax(s):
    """prefill(s) and three teacher-forced decode steps on both sides at
    window 32, and the step's distance to prefill(s + 1): the quirk of the
    rotating cache, reproduced."""
    lm = _lm()
    toks = lm["toks"]
    jlogits, jcache = lm["prefill"](lm["jparams"], {"tokens": jnp.asarray(toks[:, :s])})
    logits, cache = lm["model"].prefill(lm["params"], {"tokens": _t(toks[:, :s])})
    np.testing.assert_allclose(logits.numpy(), _np(jlogits), rtol=0, atol=1e-4)
    steps = []
    for t in range(s, s + DECODE):
        tok = toks[:, t:t + 1]
        jlogits, jcache = lm["decode"](lm["jparams"], jcache, jnp.asarray(tok))
        logits, cache = lm["model"].decode_step(lm["params"], cache, _t(tok))
        np.testing.assert_allclose(logits.numpy(), _np(jlogits), rtol=0,
                                   atol=1e-4)
        steps.append(logits)
    longer, _ = lm["model"].prefill(lm["params"], {"tokens": _t(toks[:, :s + 1])})
    gap = float((steps[0] - longer).abs().max() / longer.abs().max())
    if s % lm["cfg"].window_size == 0:
        assert gap < 1e-5
    else:
        assert gap > 1e-2


def test_train_step_matches_jax():
    lm = _lm()
    opt = dict(learning_rate=3e-4, warmup_steps=10, decay_steps=110)
    batch = _train_batch(lm)
    jgrads = dict(j_tree_paths(_jax_loss_and_grads(lm)[1]))
    jstep = jax.jit(japi.make_train_step(lm["jmodel"], JOptConfig(**opt), 1))
    jp, jstate, jm = jstep(lm["jparams"],
                           jadamw.init_opt_state(lm["jparams"], JOptConfig(**opt)),
                           {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_numpy(jax.tree.map(np.asarray, lm["jparams"]), "cpu")
    step = make_train_step(lm["model"], OptConfig(**opt), 1)
    tp, state, m = step(params, init_opt_state(params, OptConfig(**opt)),
                        {k: _t(v) for k, v in batch.items()})
    assert sorted(m) == sorted(jm)
    for k in m:
        _close(m[k], jm[k], 1e-5)
    lr = float(jm["lr"])
    flat = dict(tree_paths(tp))
    for path, want in j_tree_paths(jp):
        d = np.abs(flat[path].numpy() - np.asarray(want))
        g = np.abs(np.asarray(jgrads[path]))
        assert d.max() <= 2 * lr * 1.01 + 1e-6, path
        assert (g[d > 1e-6] <= 1e-5 * g.max()).all(), path
    assert int(state["step"]) == int(jstate["step"]) == 1


def test_serve_cli_runs_on_the_cpu(capsys):
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--tokens", "3"])
    out = capsys.readouterr().out
    assert "prefill(64 tok x 2) on cpu" in out and "sampled ids:" in out
