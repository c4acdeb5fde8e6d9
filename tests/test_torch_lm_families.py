"""The port's TransformerLM families against the JAX package's: qwen3-8b
(qk-norm), deepseek-7b, yi-34b, dbrx-132b (MoE), pixtral-12b (vlm: patch
embeddings before the text), musicgen-large (audio: four codebooks) and
deepseek-v3-671b (MLA with its latent caches, a leading dense layer, a
shared expert, multi-token prediction), each at ``reduce_for_smoke`` on
both sides, dbrx with a leading dense layer and a shared expert (both
layer groups, the shared branch), and yi-6b with a 32-position sliding
window (local attention and the rotating cache; no config of either
package sets a window without a block pattern).

The JAX parameters are made once a config by ``init_tree`` and carried
over with ``params_from_numpy``; prompts, labels and patch embeddings come
from numpy's RandomState. Reference steps run under ``jax.jit``. Float32
params and activations; tolerances:
- prefill and decode logits within 1e-4 (as tests/test_torch_lm.py);
- caches (bfloat16, the config's ``kv_cache_dtype``) within one bfloat16
  step: a cached value may round to the neighbouring bfloat16;
- greedy ids equal;
- ``loss`` and each metric (ce, aux, deepseek-v3's mtp_ce) within 1e-5
  absolute and every gradient leaf (the ``mtp`` subtree's too) within 1e-5 of
  the leaf's largest gradient (tests/test_torch_train.py's bounds: the
  port's full-softmax attention against the reference's blockwise online
  softmax, the router's float32 products in another order; measured up
  to 1.1e-6, on qwen3's qk-norm weight);
- ``moe_ffn`` at capacity_factor 0.5 (so that experts overflow and the
  spill row is written): expert ids, slots, kept pairs and the dropped
  share identical; y within 1e-5 of its largest element, aux within 1e-6
  relative (float32 rounding of sums taken in another order);
- the windowed yi-6b's prefill(s) and three teacher-forced decode steps
  at s = 20, 40 and 64 within 1e-4 of the reference's logits. The
  reference's rotating cache makes decode agree with a longer prefill
  only where s is a multiple of the window or s plus the steps stay
  inside it (ROADMAP, known behaviour 14): at 40 the first step is
  several percent of max|logits| away, at 20 and 64 within a bfloat16
  cache's rounding, and the port reproduces both.
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
from repro.models import build_model as j_build_model
from repro.models import moe as jmoe
from repro.models.params import init_tree

from repro_torch.common import tree_paths
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import build_model, loss_and_grads, moe
from repro_torch.models.params import cache_from_numpy, params_from_numpy

B, S, DECODE = 2, 40, 3
# dbrx with a leading dense layer (its own d_ff) and one shared expert;
# yi-6b with a sliding window shorter than the prompt
VARIANTS = {"mixed": dict(first_dense_layers=1, dense_d_ff=96,
                          num_shared_experts=1),
            "window": dict(window_size=32)}
CASES = ["qwen3-8b", "deepseek-7b", "yi-34b", "dbrx-132b", "pixtral-12b",
         "musicgen-large", "dbrx-132b+mixed", "deepseek-v3-671b",
         "yi-6b+window"]


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _to_numpy(tree):
    """A JAX tree as numpy; bfloat16 leaves as float32 (numpy has none)."""
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32))
                        if a.dtype == jnp.bfloat16 else np.asarray(a), tree)


def _close(got, want, rel, atol=0.0):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = _np(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale + atol)


def _configs(case):
    arch, _, variant = case.partition("+")
    jcfg, cfg = j_reduce(j_get_config(arch)), reduce_for_smoke(get_config(arch))
    if variant:
        jcfg = dataclasses.replace(jcfg, **VARIANTS[variant])
        cfg = dataclasses.replace(cfg, **VARIANTS[variant])
    return jcfg, cfg


_LMS: dict = {}


def _lm(case):
    """The case's models, carried-over weights, inputs and jitted JAX
    steps, made once a case."""
    if case in _LMS:
        return _LMS[case]
    jcfg, cfg = _configs(case)
    jmodel = j_build_model(jcfg)
    jparams = init_tree(jmodel.param_defs(), jax.random.key(0))
    model = build_model(cfg, "cpu")
    params = params_from_numpy(_to_numpy(jparams), "cpu")
    rng = np.random.RandomState(0)
    s = S - cfg.num_patches
    tail = (cfg.num_codebooks,) if cfg.family == "audio" else ()
    toks = rng.randint(0, cfg.vocab_size, (B, s + 1) + tail).astype(np.int32)
    labels = rng.randint(0, cfg.vocab_size, (B, s) + tail).astype(np.int32)
    labels[rng.rand(*labels.shape) < 0.1] = -1
    batch = {"tokens": toks[:, :s]}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.randn(B, cfg.num_patches, 1024).astype(
            np.float32)
    _LMS[case] = dict(
        jcfg=jcfg, cfg=cfg, jmodel=jmodel, jparams=jparams, model=model,
        params=params, toks=toks, labels=labels, batch=batch,
        prefill=jax.jit(jmodel.prefill),
        decode=jax.jit(lambda p, c, t: jmodel.decode_step(p, c, t)))
    return _LMS[case]


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _groups(cfg):
    if not cfg.num_experts:
        return ["dense_layers"]
    return ["dense_layers", "moe_layers"] if cfg.first_dense_layers else ["moe_layers"]


@pytest.mark.parametrize("case", CASES)
def test_params_carry_over(case):
    lm = _lm(case)
    jdefs = dict(j_tree_paths(lm["jmodel"].param_defs()))
    defs = dict(tree_paths(lm["model"].param_defs()))
    assert {p: (d.shape, d.dtype, d.init, d.scale) for p, d in defs.items()} == \
        {p: (d.shape, d.dtype, d.init, d.scale) for p, d in jdefs.items()}
    assert sorted(k for k in lm["params"] if k.endswith("_layers")) == \
        _groups(lm["cfg"])
    shapes = {p: tuple(t.shape) for p, t in tree_paths(lm["params"])}
    assert shapes == {p: d.shape for p, d in defs.items()}


@pytest.mark.parametrize("case", CASES)
def test_prefill_matches_jax(case):
    lm = _lm(case)
    cfg = lm["cfg"]
    jlogits, jcache = lm["prefill"](lm["jparams"], _jbatch(lm["batch"]))
    logits, cache = lm["model"].prefill(lm["params"], _tbatch(lm["batch"]))
    want_shape = ((B, cfg.num_codebooks, cfg.vocab_size)
                  if cfg.family == "audio" else (B, cfg.vocab_size))
    assert tuple(logits.shape) == jlogits.shape == want_shape
    np.testing.assert_allclose(logits.numpy(), _np(jlogits), rtol=0, atol=1e-4)
    assert int(cache["cur_len"]) == int(jcache["cur_len"]) == S
    assert set(cache) == set(jcache) == {"cur_len", *_groups(cfg)}
    for group in _groups(cfg):
        for got, want in zip(cache[group], jcache[group]):
            assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
            np.testing.assert_allclose(got.float().numpy(), _np(want),
                                       rtol=2 ** -7, atol=1e-6)


def _next_tokens(jlogits, cfg):
    nxt = jnp.argmax(jlogits, axis=-1)
    return (nxt[:, None, :] if cfg.family == "audio" else nxt[:, None]).astype(jnp.int32)


@pytest.mark.parametrize("case", CASES)
def test_decode_steps_match_jax(case):
    """Three decode steps of the port from JAX's prefill cache (carried
    over) against JAX's decode_step, each fed JAX's greedy token."""
    lm = _lm(case)
    jlogits, jcache = lm["prefill"](lm["jparams"], _jbatch(lm["batch"]))
    cache = cache_from_numpy(_to_numpy(jcache), "cpu")
    for group in _groups(lm["cfg"]):
        cache[group] = tuple(t.to(torch.bfloat16) for t in cache[group])
    for _ in range(DECODE):
        tok = _next_tokens(jlogits, lm["cfg"])
        jlogits, jcache = lm["decode"](lm["jparams"], jcache, tok)
        logits, cache = lm["model"].decode_step(
            lm["params"], cache, torch.from_numpy(np.array(tok)))
        np.testing.assert_allclose(logits.numpy(), _np(jlogits), rtol=0,
                                   atol=1e-4)
        assert int(cache["cur_len"]) == int(jcache["cur_len"])


@pytest.mark.parametrize("case", CASES)
def test_greedy_loop_matches_jax(case):
    """launch/serve.py's loop against repro/launch/serve.py's, written out
    (its main draws its own weights): audio feeds back (b, 1, K)."""
    lm = _lm(case)
    n = 4
    jlogits, jcache = lm["prefill"](lm["jparams"], _jbatch(lm["batch"]))
    want = []
    for _ in range(n):
        want.append(np.asarray(jnp.argmax(jlogits, axis=-1)))
        jlogits, jcache = lm["decode"](lm["jparams"], jcache,
                                       _next_tokens(jlogits, lm["cfg"]))
    before = dict(ops.launches)
    tb = _tbatch(lm["batch"])
    ids, _, _ = serve.generate(lm["model"], lm["params"], tb["tokens"], n,
                               tb.get("patch_embeds"))
    np.testing.assert_array_equal(ids.numpy(), np.stack(want, 1))
    assert ops.launches == before                # the CPU runs no kernel


@pytest.mark.parametrize("case", CASES)
def test_loss_and_grads_match_jax(case):
    lm = _lm(case)
    batch = dict(lm["batch"], labels=lm["labels"])
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lm["jmodel"].loss, has_aux=True))(lm["jparams"], _jbatch(batch))
    loss, met, grads = loss_and_grads(lm["model"], lm["params"], _tbatch(batch))
    _close(loss, jloss, 0, 1e-5)
    assert set(met) == set(jmet) == {"ce", "aux"} | (
        {"mtp_ce"} if lm["cfg"].mtp_depth else set())
    for name in met:
        _close(met[name], jmet[name], 0, 1e-5)
    assert (float(met["aux"]) > 0) == bool(lm["cfg"].num_experts)
    jflat = dict(j_tree_paths(jgrads))
    flat = dict(tree_paths(grads))
    assert set(flat) == set(jflat)
    for path, gr in flat.items():
        assert gr.shape == jflat[path].shape, path
        _close(gr, jflat[path], 1e-5)


def _reference_dispatch(ids, num_experts, cap):
    """moe.py:116-125 of the JAX package (inline there): the sorted
    pairs' experts, tokens and slots, and which are kept."""
    t, k = ids.shape
    flat_e = ids.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    se, st = flat_e[order], jnp.repeat(jnp.arange(t), k)[order]
    first = jnp.searchsorted(se, jnp.arange(num_experts), side="left")
    slot = jnp.arange(t * k) - first[se]
    keep = slot < cap
    return se, st, jnp.where(keep, slot, cap), keep


@pytest.mark.parametrize("shared", [False, True])
def test_moe_ffn_matches_jax_with_drops(shared, rng):
    t, d, f, e, k, factor = 96, 32, 24, 8, 2, 0.5
    params = {"router": rng.randn(d, e).astype(np.float32),
              "w_gate": rng.randn(e, d, f).astype(np.float32) * 0.2,
              "w_up": rng.randn(e, d, f).astype(np.float32) * 0.2,
              "w_down": rng.randn(e, f, d).astype(np.float32) * 0.2}
    if shared:
        params.update(shared_w_gate=rng.randn(d, f).astype(np.float32) * 0.2,
                      shared_w_up=rng.randn(d, f).astype(np.float32) * 0.2,
                      shared_w_down=rng.randn(f, d).astype(np.float32) * 0.2)
    x = rng.randn(t, d).astype(np.float32)
    # skew the router so a few experts overflow their capacity
    params["router"][:, :2] += 0.5
    jp = {n: jnp.asarray(a) for n, a in params.items()}
    tp = {n: torch.from_numpy(a) for n, a in params.items()}
    cap = moe.capacity_of(t, e, k, factor)
    assert cap == jmoe.capacity_of(t, e, k, factor) == 12

    jw, jids, jaux = jmoe.router_topk(jnp.asarray(x), jp["router"], k, e)
    w, ids, aux = moe.router_topk(torch.from_numpy(x), tp["router"], k, e)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    _close(w, jw, 1e-6)
    _close(aux, jaux, 1e-6)

    order, se, st, slot, keep = moe.dispatch(ids, e, cap)
    want = _reference_dispatch(jids, e, cap)
    for got, ref in zip((se, st, slot, keep), want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert int((~keep).sum()) > 0 and int((slot == cap).sum()) > 1

    jy, jaux2, jdropped = jax.jit(lambda a, p: jmoe.moe_ffn(
        a, p, top_k=k, num_experts=e, capacity_factor=factor))(jnp.asarray(x), jp)
    y, aux2, dropped = moe.moe_ffn(torch.from_numpy(x), tp, top_k=k,
                                   num_experts=e, capacity_factor=factor)
    assert float(dropped) == float(jdropped) == float((~keep).float().mean())
    _close(aux2, jaux2, 1e-6)
    _close(y, jy, 1e-5)
    # a rerun gives the same bits (no atomics in the combine)
    again, _, _ = moe.moe_ffn(torch.from_numpy(x), tp, top_k=k, num_experts=e,
                              capacity_factor=factor)
    assert torch.equal(again, y)


def test_topk_ties_take_the_lower_expert_first():
    """Equal probabilities: jax.lax.top_k's order (lower index first)."""
    x = torch.zeros((3, 4))
    w = torch.zeros((4, 6))
    _, ids, _ = moe.router_topk(x, w, 3, 6)
    _, jids, _ = jmoe.router_topk(jnp.zeros((3, 4)), jnp.zeros((4, 6)), 3, 6)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert ids.tolist() == [[0, 1, 2]] * 3


@pytest.mark.parametrize("case", ["pixtral-12b", "musicgen-large",
                                  "dbrx-132b", "deepseek-v3-671b"])
def test_decode_consistency(case):
    """Teacher forcing: prefill(s) + decode(tok_s) == prefill(s + 1). A
    MoE layer's capacity depends on the tokens it is given (a prompt's
    tokens may be dropped, a decode step's 2 are not), so dbrx runs here
    at capacity_factor 2.0: every expert can take every token."""
    lm = _lm(case)
    model = build_model(dataclasses.replace(lm["cfg"], capacity_factor=2.0),
                        "cpu")
    params = lm["params"]
    tb = _tbatch(lm["batch"])
    toks = torch.from_numpy(lm["toks"])
    _, cache = model.prefill(params, tb)
    s = tb["tokens"].shape[1]
    got, _ = model.decode_step(params, cache, toks[:, s:s + 1])
    want, _ = model.prefill(params, dict(tb, tokens=toks))
    assert float((got - want).abs().max()) < 2e-3


@pytest.mark.parametrize("s", [20, 40, 64])
def test_rotating_window_decode_matches_jax(s):
    """yi-6b at window 32: prefill(s) and three teacher-forced decode
    steps on both sides, and the first step's distance to prefill(s + 1)."""
    lm = _lm("yi-6b+window")
    toks = np.random.RandomState(1).randint(
        0, lm["cfg"].vocab_size, (B, 64 + DECODE)).astype(np.int32)
    jlogits, jcache = lm["prefill"](lm["jparams"], {"tokens": jnp.asarray(toks[:, :s])})
    logits, cache = lm["model"].prefill(lm["params"],
                                        {"tokens": torch.from_numpy(toks[:, :s])})
    np.testing.assert_allclose(logits.numpy(), _np(jlogits), rtol=0, atol=1e-4)
    slots = min(s, 32) if s > 32 else s + 64       # the window, or a margin
    assert tuple(cache["dense_layers"][0].shape[2:4]) == \
        tuple(jcache["dense_layers"][0].shape[2:4]) == (slots, lm["cfg"].num_kv_heads)
    steps = []
    for t in range(s, s + DECODE):
        tok = toks[:, t:t + 1]
        jlogits, jcache = lm["decode"](lm["jparams"], jcache, jnp.asarray(tok))
        logits, cache = lm["model"].decode_step(lm["params"], cache,
                                                torch.from_numpy(tok))
        np.testing.assert_allclose(logits.numpy(), _np(jlogits), rtol=0,
                                   atol=1e-4)
        steps.append(logits)
    longer, _ = lm["model"].prefill(
        lm["params"], {"tokens": torch.from_numpy(toks[:, :s + 1])})
    gap = float((steps[0] - longer).abs().max() / longer.abs().max())
    assert (gap > 1e-2) if s == 40 else (gap < 5e-3)
