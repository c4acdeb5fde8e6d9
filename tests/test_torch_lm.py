"""The port's yi-6b serving path against the JAX package's, on the reduced
config with num_kv_heads=2 (so GQA repeats each kv head twice): layers,
the carried-over parameter tree, prefill logits and caches, decode steps,
teacher forcing, the greedy loop of launch/serve.py, and the entry points'
device rule.

The JAX parameters are made once by ``init_tree`` and carried over with
``params_from_numpy``, so both packages run the same weights; prompts come
from numpy's RandomState. Float32 params and activations: logits agree
within 1e-4. The caches are bfloat16 (the config's ``kv_cache_dtype``):
a cached value may round to the neighbouring bfloat16, so caches agree
within one bfloat16 step (at most 2^-7 of the value)."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.common import tree_paths as j_tree_paths
from repro.configs import get_config as j_get_config
from repro.configs import reduce_for_smoke as j_reduce
from repro.models import build_model as j_build_model
from repro.models import embedding as j_embedding
from repro.models import layers as jlayers
from repro.models.params import bytes_of as j_bytes_of
from repro.models.params import init_tree

from repro_torch.common import param_count, tree_paths
from repro_torch.configs import get_config, list_archs, reduce_for_smoke
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import build_model, embedding, layers
from repro_torch.models.params import (bytes_of, cache_from_numpy, init_params,
                                       params_from_numpy)

ROOT = Path(__file__).resolve().parents[1]
B, S = 2, 40


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _to_numpy(tree):
    """A JAX tree as numpy; bfloat16 leaves as float32 (numpy has none)."""
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32))
                        if a.dtype == jnp.bfloat16 else np.asarray(a), tree)


def _cast_like(tree, jtree):
    """Cast a carried-over tree's leaves back to the JAX tree's dtypes."""
    flat = dict(tree_paths(tree))
    for path, a in j_tree_paths(jtree):
        if a.dtype == jnp.bfloat16:
            leaf = flat[path]
            leaf.data = leaf.to(torch.bfloat16)
    return tree


@pytest.fixture(scope="module")
def lm():
    jcfg = dataclasses.replace(j_reduce(j_get_config("yi-6b")), num_kv_heads=2)
    cfg = dataclasses.replace(reduce_for_smoke(get_config("yi-6b")),
                              num_kv_heads=2)
    jmodel = j_build_model(jcfg)
    jparams = init_tree(jmodel.param_defs(), jax.random.key(0))
    model = build_model(cfg, "cpu")
    params = params_from_numpy(_to_numpy(jparams), "cpu")
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size, (B, S + 1))
    return dict(jcfg=jcfg, cfg=cfg, jmodel=jmodel, jparams=jparams,
                model=model, params=params, toks=toks.astype(np.int32))


def _jax_steps(lm, impl):
    jmodel = j_build_model(dataclasses.replace(lm["jcfg"], attention_impl=impl))
    return (jax.jit(jmodel.prefill),
            jax.jit(lambda p, c, t: jmodel.decode_step(p, c, t)))


@pytest.mark.parametrize("fn", ["rms_norm", "apply_rope", "swiglu"])
def test_layers_match_jax(fn, rng):
    x = rng.randn(2, 5, 4, 16).astype(np.float32)
    if fn == "rms_norm":
        w = rng.randn(16).astype(np.float32)
        got = layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6)
        want = jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)
    elif fn == "apply_rope":
        pos = np.arange(3, 8)[None]
        got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                5e6)
        want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 5e6)
    else:
        ws = [rng.randn(*s).astype(np.float32) * 0.2
              for s in ((16, 24), (16, 24), (24, 16))]
        got = layers.swiglu(torch.from_numpy(x), *map(torch.from_numpy, ws))
        want = jlayers.swiglu(jnp.asarray(x), *map(jnp.asarray, ws))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-5)


def test_params_carry_over(lm):
    jdefs = dict(j_tree_paths(lm["jmodel"].param_defs()))
    defs = dict(tree_paths(lm["model"].param_defs()))
    assert {p: (d.shape, d.dtype, d.init, d.scale) for p, d in defs.items()} == \
        {p: (d.shape, d.dtype, d.init, d.scale) for p, d in jdefs.items()}
    assert bytes_of(lm["model"].param_defs()) == j_bytes_of(lm["jmodel"].param_defs())
    shapes = {p: tuple(t.shape) for p, t in tree_paths(lm["params"])}
    assert shapes == {p: d.shape for p, d in defs.items()}
    # n_params() (the JAX package's analytic count) leaves out final_norm
    assert param_count(lm["params"]) == lm["cfg"].n_params() + lm["cfg"].d_model
    full = get_config("yi-6b")
    assert full.n_params() == j_get_config("yi-6b").n_params()
    assert 6.0e9 < full.n_params() < 6.1e9
    # the port's own init: every def's shape and dtype, a fixed seed
    # giving the same numbers again
    mine = init_params(lm["model"].param_defs(), seed=3, device="cpu")
    again = init_params(lm["model"].param_defs(), seed=3, device="cpu")
    for (p, a), (_, b) in zip(tree_paths(mine), tree_paths(again)):
        assert a.shape == defs[p].shape and torch.equal(a, b)
    w = mine["dense_layers"]["attn"]["wq"]
    assert abs(float(w.std()) - 0.02) < 2e-3 and not torch.equal(w[0], w[1])


@pytest.mark.parametrize("impl", ["pallas_interpret", "xla"])
def test_prefill_matches_jax(lm, impl):
    prefill, _ = _jax_steps(lm, impl)
    jlogits, jcache = prefill(lm["jparams"], {"tokens": jnp.asarray(lm["toks"][:, :S])})
    logits, cache = lm["model"].prefill(
        lm["params"], {"tokens": torch.from_numpy(lm["toks"][:, :S])})
    assert logits.shape == (B, lm["cfg"].vocab_size)
    np.testing.assert_allclose(logits.numpy(), _np(jlogits), rtol=0, atol=1e-4)
    assert int(cache["cur_len"]) == int(jcache["cur_len"]) == S
    for got, want in zip(cache["dense_layers"], jcache["dense_layers"]):
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.float().numpy(), _np(want),
                                   rtol=2 ** -7, atol=1e-6)


def test_decode_steps_match_jax(lm):
    """Three decode steps of the port from JAX's prefill cache (carried
    over) against JAX's decode_step, each fed JAX's greedy token."""
    prefill, decode = _jax_steps(lm, "xla")
    jlogits, jcache = prefill(lm["jparams"], {"tokens": jnp.asarray(lm["toks"][:, :S])})
    cache = _cast_like(cache_from_numpy(_to_numpy(jcache), "cpu"), jcache)
    for _ in range(3):
        tok = jnp.argmax(jlogits, axis=-1)[:, None].astype(jnp.int32)
        jlogits, jcache = decode(lm["jparams"], jcache, tok)
        logits, cache = lm["model"].decode_step(
            lm["params"], cache, torch.from_numpy(np.array(tok)))
        np.testing.assert_allclose(logits.numpy(), _np(jlogits), rtol=0,
                                   atol=1e-4)
        assert int(cache["cur_len"]) == int(jcache["cur_len"])


def test_decode_consistency(lm):
    """Teacher forcing, as test_models_smoke.py::test_decode_consistency:
    prefill(s) + decode(tok_s) == prefill(s + 1)."""
    model, params = lm["model"], lm["params"]
    toks = torch.from_numpy(lm["toks"])
    _, cache = model.prefill(params, {"tokens": toks[:, :S]})
    got, _ = model.decode_step(params, cache, toks[:, S:S + 1])
    want, _ = model.prefill(params, {"tokens": toks})
    assert float((got - want).abs().max()) < 2e-3


def test_greedy_loop_matches_jax(lm):
    """launch/serve.py's loop against repro/launch/serve.py's, written out
    (its main draws its own weights), on the same weights and prompt."""
    n = 6
    prefill, decode = _jax_steps(lm, "xla")
    jlogits, jcache = prefill(lm["jparams"], {"tokens": jnp.asarray(lm["toks"][:, :S])})
    want = []
    for _ in range(n):
        nxt = jnp.argmax(jlogits, axis=-1)
        jlogits, jcache = decode(lm["jparams"], jcache,
                                 nxt[:, None].astype(jnp.int32))
        want.append(np.asarray(nxt))
    before = dict(ops.launches)
    ids, _, _ = serve.generate(lm["model"], lm["params"],
                               torch.from_numpy(lm["toks"][:, :S]), n)
    np.testing.assert_array_equal(ids.numpy(), np.stack(want, 1))
    assert ops.launches == before                # the CPU runs no kernel


def test_entry_points_default_to_cuda(lm):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(lm["model"].param_defs())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(lm["cfg"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--smoke"])


def test_unported_archs_raise():
    """Every architecture of the JAX package is ported: the registries
    agree, only an unknown name raises, and a windowed TransformerLM
    builds."""
    from repro.configs import list_archs as j_list_archs
    from repro_torch.configs.base import NOT_PORTED
    assert NOT_PORTED == ()
    assert list_archs() == j_list_archs()
    for arch in list_archs():
        assert build_model(get_config(arch), "cpu").cfg.name == arch
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")
    model = build_model(dataclasses.replace(get_config("yi-6b"),
                                            window_size=32), "cpu")
    assert model.cache_defs(1, 4096)["dense_layers"][0].shape[2] == 32


def test_out_of_range_token_ids():
    """The reference's ``jnp.take`` fills a NaN row for an id >= vocab;
    the port's indexing raises IndexError (a device-side assert on a card).
    Both wrap -1 to the last row."""
    table = np.arange(12, dtype=np.float32).reshape(3, 4)
    ids = np.array([0, 5, -1], np.int32)
    want = np.asarray(j_embedding.embed(jnp.asarray(table), jnp.asarray(ids),
                                        "dense"))
    np.testing.assert_array_equal(want[[0, 2]], table[[0, 2]])
    assert np.isnan(want[1]).all()
    t = torch.from_numpy(table)
    with pytest.raises(IndexError):
        embedding.embed(t, torch.from_numpy(ids), "dense")
    np.testing.assert_array_equal(
        embedding.embed(t, torch.tensor([0, -1]), "mapsin").numpy(),
        table[[0, 2]])


def test_serve_cli_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu", "--tokens", "4"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "decode:" in out.stdout and "ms/token" in out.stdout
