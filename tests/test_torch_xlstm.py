"""The port's xLSTM (ssm family: mLSTM and sLSTM blocks) against the JAX
package's: ``mlstm_chunkwise``, ``mlstm_decode``, ``slstm_step``,
``slstm_seq`` and ``XLSTMLM``.

The JAX parameters are made once by ``init_tree`` at ``reduce_for_smoke``
(4 layers, sLSTM at 3, d_model 64, 4 heads; float32 params and
activations) and carried over with ``params_from_numpy``; ``w_if`` and
``b_i``, zeros at init, are drawn from the seed here so that the input
gate varies. Inputs come from numpy's RandomState; reference model steps
run under ``jax.jit``. Tolerances:
- the cells against the JAX cells within 1e-5 of the output's largest
  element (float32 sums in another order); ``mlstm_chunkwise`` against
  the token-by-token ``mlstm_decode`` within 2e-4 and ``slstm_seq``
  against ``slstm_step`` within 2e-5 (tests/test_recurrent_cells.py's
  bounds);
- prefill and decode logits within 1e-4 (as tests/test_torch_lm.py), and
  the caches leaf by leaf within 1e-5 of the leaf's largest element;
- greedy ids equal;
- ``loss`` within 1e-5 absolute and every gradient leaf within 1e-5 of
  the leaf's largest gradient; one ``make_train_step`` step's metrics
  within 1e-5 of their size and each updated parameter within 1e-6,
  except where the reference's gradient is within the gradient bound of
  zero: there Adam's first update, lr g / (|g| + eps), may take either
  sign, so those entries are held within 2 lr (tests/test_torch_train.py's
  bound).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.common import tree_paths as j_tree_paths
from repro.configs import get_config as j_get_config
from repro.configs import reduce_for_smoke as j_reduce
from repro.models import api as japi
from repro.models import build_model as j_build_model
from repro.models import xlstm as jx
from repro.models.params import init_tree
from repro.optim import OptConfig as JOptConfig
from repro.optim import adamw as jadamw

from repro_torch.common import tree_paths
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.launch import serve
from repro_torch.models import build_model, loss_and_grads, xlstm
from repro_torch.models import make_train_step
from repro_torch.models.params import cache_from_numpy, params_from_numpy
from repro_torch.optim import OptConfig, init_opt_state

ARCH = "xlstm-125m"
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


def _mlstm_inputs(rng, b=2, s=50, h=2, e=8):
    q, k, v = (rng.randn(b, s, h, e).astype(np.float32) for _ in range(3))
    log_i = (rng.randn(b, s, h) * 0.5).astype(np.float32)
    log_f = (-np.abs(rng.randn(b, s, h)) * 0.1).astype(np.float32)
    return q, k, v, log_i, log_f


# ---------------------------------------------------------------------------
# The cells
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_chunkwise_matches_jax_and_decode(with_state, rng):
    """50 positions in chunks of 16 (padded), from zeros or from an
    incoming state; against the JAX function and against the port's own
    token-by-token recurrence."""
    args = _mlstm_inputs(rng)
    b, s, h, e = args[0].shape
    state = None
    if with_state:
        state = (rng.randn(b, h, e, e).astype(np.float32),
                 rng.randn(b, h, e).astype(np.float32),
                 rng.randn(b, h).astype(np.float32))
    out, st = xlstm.mlstm_chunkwise(*map(_t, args), None if state is None
                                    else tuple(map(_t, state)), chunk=16)
    jout, jst = jax.jit(lambda *a: jx.mlstm_chunkwise(*a[:5], a[5], chunk=16))(
        *map(jnp.asarray, args),
        None if state is None else tuple(map(jnp.asarray, state)))
    _close(out, jout, 1e-5)
    for got, want in zip(st, jst):
        _close(got, want, 1e-5)
    run = (tuple(map(_t, state)) if state is not None else
           (torch.zeros(b, h, e, e), torch.zeros(b, h, e),
            torch.full((b, h), -1e30)))
    outs = []
    for t in range(s):
        o, run = xlstm.mlstm_decode(*(_t(a[:, t]) for a in args), run)
        outs.append(o)
    np.testing.assert_allclose(out.numpy(), torch.stack(outs, 1).numpy(),
                               rtol=2e-4, atol=2e-4)


def test_mlstm_decode_matches_jax(rng):
    q, k, v, log_i, log_f = (a[:, 0] for a in _mlstm_inputs(rng))
    b, h, e = q.shape
    state = (rng.randn(b, h, e, e).astype(np.float32),
             rng.randn(b, h, e).astype(np.float32),
             rng.randn(b, h).astype(np.float32))
    out, st = xlstm.mlstm_decode(*map(_t, (q, k, v, log_i, log_f)),
                                 tuple(map(_t, state)))
    jout, jst = jx.mlstm_decode(*map(jnp.asarray, (q, k, v, log_i, log_f)),
                                tuple(map(jnp.asarray, state)))
    _close(out, jout, 1e-5)
    for got, want in zip(st, jst):
        _close(got, want, 1e-5)


def test_slstm_step_and_seq_match_jax(rng):
    b, s, h, e = 2, 20, 2, 4
    gates = (rng.randn(b, s, 4, h, e) * 0.5).astype(np.float32)
    R = (rng.randn(4, h, e, e) * 0.1).astype(np.float32)
    hs, state = xlstm.slstm_seq(_t(gates), {"R": _t(R)})
    jhs, jstate = jax.jit(jx.slstm_seq)(jnp.asarray(gates), {"R": jnp.asarray(R)})
    _close(hs, jhs, 1e-5)
    for got, want in zip(state, jstate):
        _close(got, want, 1e-5)
    z = torch.zeros(b, h, e)
    st = (z, z, z, torch.full((b, h, e), -1e30))
    jz = jnp.zeros((b, h, e))
    jst = (jz, jz, jz, jnp.full((b, h, e), -1e30))
    for t in range(s):
        st = xlstm.slstm_step(_t(gates[:, t]), *st, {"R": _t(R)})
        jst = jx.slstm_step(jnp.asarray(gates[:, t]), *jst, {"R": jnp.asarray(R)})
        for got, want in zip(st, jst):
            _close(got, want, 1e-5)
        np.testing.assert_allclose(hs[:, t].numpy(), st[0].numpy(),
                                   rtol=2e-5, atol=2e-5)


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
    for i in range(cfg.num_layers):
        if i not in cfg.slstm_at:          # the input gate's zero init
            p = jparams[f"layer{i}"]
            p["w_if"] = jnp.asarray(rng.randn(*p["w_if"].shape) * 0.1, jnp.float32)
            p["b_i"] = jnp.asarray(rng.randn(*p["b_i"].shape) * 0.5, jnp.float32)
    toks = rng.randint(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
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
    assert (lm["cfg"].num_layers, lm["cfg"].slstm_at) == (4, (3,))
    full = get_config(ARCH)
    assert (full.num_layers, full.d_model, full.slstm_at,
            full.tie_embeddings) == (12, 768, (5, 11), True)
    jdefs = dict(j_tree_paths(lm["jmodel"].param_defs()))
    defs = dict(tree_paths(lm["model"].param_defs()))
    assert {p: (d.shape, d.dtype, d.init, d.scale) for p, d in defs.items()} == \
        {p: (d.shape, d.dtype, d.init, d.scale) for p, d in jdefs.items()}
    assert "lm_head" not in defs                 # tied to the embedding
    full_defs = dict(tree_paths(build_model(full, "cpu").param_defs()))
    for path in (("layer0", "w_if"), ("layer0", "b_i"), ("layer0", "b_f"),
                 ("layer5", "W"), ("layer5", "R"), ("layer5", "b")):
        assert full_defs[path].dtype == "float32", path
    assert full_defs[("layer0", "wq")].dtype == "bfloat16"


def test_prefill_matches_jax():
    lm = _lm()
    tokens = lm["toks"][:, :S]
    jlogits, jcache = lm["prefill"](lm["jparams"], {"tokens": jnp.asarray(tokens)})
    logits, cache = lm["model"].prefill(lm["params"], {"tokens": _t(tokens)})
    assert tuple(logits.shape) == jlogits.shape == (B, lm["cfg"].vocab_size)
    np.testing.assert_allclose(logits.numpy(), _np(jlogits), rtol=0, atol=1e-4)
    assert int(cache["cur_len"]) == S
    _cache_close(cache, jcache)


def test_decode_steps_match_jax():
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


def test_greedy_loop_and_decode_consistency():
    """launch/serve.py's loop against the JAX steps, and prefill(s) + one
    step against prefill(s + 1): a recurrent state has no window."""
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
    model, params = lm["model"], lm["params"]
    _, cache = model.prefill(params, {"tokens": _t(tokens)})
    got, _ = model.decode_step(params, cache, _t(lm["toks"][:, S:S + 1]))
    longer, _ = model.prefill(params, {"tokens": _t(lm["toks"])})
    _close(got, longer, 1e-4)


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
