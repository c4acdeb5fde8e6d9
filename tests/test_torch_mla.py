"""The port's MLA pieces against the JAX package's: blockwise prefill
attention, the naive yardstick, the absorbed decode, the multi-token
prediction loss, and the float8 cache cast with the configs that use it.

Inputs come from numpy's RandomState; reference functions run under
``jax.jit``. One shape a case family: b 2, 40 positions (not a multiple
of the reduced config's blocks, 16 q and 32 kv, so the last blocks are
short), 4 heads, latent 16, dn 16, dr 8, dv 16. Tolerances:
- prefill attention, float32: within 1e-6 of the output's largest element
  (both online softmaxes in float32, sums in another order); bfloat16:
  within one bfloat16 step of the largest element (2^-7 of it): p is
  rounded to bfloat16 before p.v on both sides, and a float32 sum in
  another order may round the output to the neighbouring bfloat16;
- the naive yardstick against the reference's naive MLA branch and
  against the blockwise function: within 1e-6 of the largest element;
- absorbed decode: within 1e-6 of the largest element, and equal bit for
  bit to the same call with the cache past cur_len zeroed (a masked
  position adds exactly 0);
- the MTP loss within 1e-5 absolute (tests/test_torch_lm_families.py's
  loss bound);
- the float8 cast: bit for bit, from float32 and from bfloat16;
- float8 caches of a reduced GQA and MLA config: prefill caches within one
  float8 step (2^-3 of the value, 2^-9 for subnormals: a value computed in
  another order may round to the neighbouring float8), decode logits from
  the reference's cache within 1e-4 (tests/test_torch_lm.py's bound).
"""
import dataclasses
import functools
import struct

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config
from repro.configs import reduce_for_smoke as j_reduce
from repro.models import attention as jattn
from repro.models import build_model as j_build_model
from repro.models.params import init_tree

from repro_torch.common import cache_cast
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models import attention as attn
from repro_torch.models import build_model
from repro_torch.models.params import params_from_numpy

B, S, H, C, DN, DR, DV = 2, 40, 4, 16, 16, 8, 16
BLOCK_Q, BLOCK_KV = 16, 32
SCALE = (DN + DR) ** -0.5
F8 = "float8_e4m3fn"


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _to_numpy(tree):
    """A JAX tree as numpy; bfloat16 and float8 leaves as float32 (numpy
    has neither)."""
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32))
                        if a.dtype in (jnp.bfloat16, jnp.float8_e4m3fn)
                        else np.asarray(a), tree)


def _close(got, want, rel, atol=0.0):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = _np(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()) + atol)


def _mla_inputs(rng, dtype):
    """(q, ckv, k_pe, kv_b_k, kv_b_v) as numpy float32, rounded to `dtype`
    through JAX, and as tensors of `dtype` with the same values."""
    arrs = [rng.randn(B, S, H, DN + DR), rng.randn(B, S, C), rng.randn(B, S, DR),
            rng.randn(C, H, DN) * 0.3, rng.randn(C, H, DV) * 0.3]
    jx = [jnp.asarray(a, jnp.float32).astype(dtype) for a in arrs]
    tx = [torch.tensor(_np(a)).to(getattr(torch, jnp.dtype(dtype).name))
          for a in jx]
    return jx, tx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_prefill_attention_matches_jax(dtype, rng):
    jx, tx = _mla_inputs(rng, dtype)
    want = jax.jit(functools.partial(
        jattn.mla_prefill_attention, scale=SCALE, block_q=BLOCK_Q,
        block_kv=BLOCK_KV))(*jx)
    got = attn.mla_prefill_attention(*tx, scale=SCALE, block_q=BLOCK_Q,
                                     block_kv=BLOCK_KV)
    assert got.dtype == tx[1].dtype and tuple(got.shape) == want.shape == (
        B, S, H, DV)
    _close(got, want, 1e-6 if dtype == "float32" else 2 ** -7)


def test_mla_naive_attention_matches_jax_and_blockwise(rng):
    jx, tx = _mla_inputs(rng, "float32")

    def reference_naive(q, ckv, k_pe, kv_b_k, kv_b_v):
        # src/repro/models/transformer.py's attention_impl == "naive" branch
        kvup = jnp.einsum("bsk,khe->bshe", ckv,
                          jnp.concatenate([kv_b_k, kv_b_v], -1))
        k = jnp.concatenate([kvup[..., :DN], jnp.broadcast_to(
            k_pe[:, :, None, :], q[..., DN:].shape)], -1)
        return jattn.attention(q, k, kvup[..., DN:], impl="naive",
                               causal=True, scale=SCALE)

    want = jax.jit(reference_naive)(*jx)
    got = attn.mla_naive_attention(*tx, scale=SCALE)
    _close(got, want, 1e-6)
    blockwise = attn.mla_prefill_attention(*tx, scale=SCALE, block_q=BLOCK_Q,
                                           block_kv=BLOCK_KV)
    _close(got, blockwise, 1e-6)


def test_mla_absorbed_decode_matches_jax(rng):
    """cur_len < S, the cache past cur_len filled with large garbage."""
    cur = 29
    q_nope, q_pe = rng.randn(B, H, DN), rng.randn(B, H, DR)
    ckv, kpe = rng.randn(B, S, C), rng.randn(B, S, DR)
    ckv[:, cur:] = rng.randn(B, S - cur, C) * 1e3
    kpe[:, cur:] = rng.randn(B, S - cur, DR) * 1e3
    kv_b_k, kv_b_v = rng.randn(C, H, DN) * 0.3, rng.randn(C, H, DV) * 0.3
    arrs = [a.astype(np.float32) for a in (q_nope, q_pe, ckv, kpe, kv_b_k,
                                           kv_b_v)]
    want = jax.jit(functools.partial(jattn.mla_absorbed_decode, scale=SCALE))(
        *map(jnp.asarray, arrs[:4]), *map(jnp.asarray, arrs[4:]),
        jnp.int32(cur))
    t = [torch.from_numpy(a) for a in arrs]
    got = attn.mla_absorbed_decode(*t, torch.tensor(cur, dtype=torch.int32),
                                   scale=SCALE)
    assert tuple(got.shape) == want.shape == (B, H, DV)
    _close(got, want, 1e-6)
    clean = [x.clone() for x in t]
    clean[2][:, cur:] = 0
    clean[3][:, cur:] = 0
    again = attn.mla_absorbed_decode(*clean, torch.tensor(cur), scale=SCALE)
    assert torch.equal(again, got)


def _lm(arch, **overrides):
    jcfg = dataclasses.replace(j_reduce(j_get_config(arch)), **overrides)
    cfg = dataclasses.replace(reduce_for_smoke(get_config(arch)), **overrides)
    jmodel = j_build_model(jcfg)
    jparams = init_tree(jmodel.param_defs(), jax.random.key(0))
    return (jmodel, jparams, build_model(cfg, "cpu"),
            params_from_numpy(_to_numpy(jparams), "cpu"), cfg)


def test_mtp_loss_matches_jax(rng):
    jmodel, jparams, model, params, cfg = _lm("deepseek-v3-671b")
    hidden = rng.randn(B, S, cfg.d_model).astype(np.float32)
    toks = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[rng.rand(B, S) < 0.1] = -1
    want = jax.jit(jmodel._mtp_loss)(jparams, jnp.asarray(hidden),
                                     jnp.asarray(toks), jnp.asarray(labels))
    got = model._mtp_loss(params, torch.from_numpy(hidden),
                          torch.from_numpy(toks), torch.from_numpy(labels))
    assert np.isfinite(float(got))
    _close(got, want, 0, 1e-5)


# ±448, ±463.9, ±464, ±464.1, ±480, ±1e9, ±inf, ±NaN, ±2^-10 and the
# subnormals (k x 2^-9, k < 8) with the float32 values between them
F8_EDGES = np.concatenate([
    np.array([448, 463.9, 464, 464.1, 480, 1e9, np.inf, np.nan, 2 ** -10,
              3 * 2 ** -11], np.float32),
    np.arange(1, 8, dtype=np.float32) * 2 ** -9,
    np.arange(1, 16, dtype=np.float32) * 2 ** -10])


def _f8_vector():
    """F8_EDGES, their negatives (-NaN with the sign bit set), and a
    spread of random magnitudes, float32."""
    rng = np.random.RandomState(1)
    spread = rng.randn(4096) * np.exp(rng.randn(4096) * 4)
    neg = -F8_EDGES
    neg[np.isnan(neg)] = np.frombuffer(struct.pack("<I", 0xFFC00000),
                                       np.float32)
    return np.concatenate([F8_EDGES, neg, spread.astype(np.float32)])


@pytest.mark.parametrize("source", ["float32", "bfloat16"])
def test_cache_cast_matches_jax_float8(source):
    """Both sides cast the same bits: a bfloat16 vector is JAX's rounding
    of the float32 one, carried over bit for bit (torch's own float32 to
    bfloat16 cast turns every NaN into 0xFFFF, a negative NaN)."""
    jv = jnp.asarray(_f8_vector()).astype(source)
    if source == "float32":
        tv = torch.from_numpy(np.asarray(jv))
    else:
        tv = torch.from_numpy(np.asarray(jv.view(jnp.uint16)).astype(
            np.int16)).view(torch.bfloat16)
    want = np.asarray(jv.astype(jnp.float8_e4m3fn).view(jnp.uint8))
    got = cache_cast(tv, torch.float8_e4m3fn)
    assert got.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(got.view(torch.uint8).numpy(), want)
    # the edges themselves: 448 up to 464, NaN past it and at inf (in
    # bfloat16, 463.9 and 464.1 are 464)
    edge = got.view(torch.uint8)[:6].tolist()
    over = 0x7E if source == "bfloat16" else 0x7F
    assert edge == [0x7E, 0x7E, 0x7E, over, 0x7F, 0x7F]
    assert got.view(torch.uint8)[len(F8_EDGES) + 4].item() == 0xFF  # -480
    assert got.view(torch.uint8)[len(F8_EDGES) + 7].item() == 0xFF  # -NaN
    # other dtypes cast as `to`
    assert torch.equal(cache_cast(tv, torch.bfloat16).view(torch.int16),
                       tv.to(torch.bfloat16).view(torch.int16))


@pytest.mark.parametrize("arch", ["yi-6b", "deepseek-v3-671b"])
def test_float8_caches_match_jax(arch):
    """kv_cache_dtype float8_e4m3fn: GQA's (k, v) and MLA's (ckv, k_pe)."""
    jmodel, jparams, model, params, cfg = _lm(arch, kv_cache_dtype=F8)
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size, (B, S + 2))
    toks = toks.astype(np.int32)
    jlogits, jcache = jax.jit(jmodel.prefill)(jparams,
                                              {"tokens": jnp.asarray(toks[:, :S])})
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(toks[:, :S])})
    _close(logits, jlogits, 0, 1e-4)
    groups = [g for g in cache if g != "cur_len"]
    assert groups and set(cache) == set(jcache)
    for group in groups:
        for got, want in zip(cache[group], jcache[group]):
            assert got.dtype == torch.float8_e4m3fn
            assert want.dtype == jnp.float8_e4m3fn
            np.testing.assert_allclose(got.float().numpy(), _np(want),
                                       rtol=2 ** -3, atol=2 ** -9)
    # decode from the reference's cache, carried over exactly
    cache = params_from_numpy(_to_numpy(jcache), "cpu")
    for group in groups:
        cache[group] = tuple(t.to(torch.float8_e4m3fn) for t in cache[group])
    decode = jax.jit(lambda p, c, t: jmodel.decode_step(p, c, t))
    for i in range(2):
        tok = toks[:, S + i:S + i + 1]
        jlogits, jcache = decode(jparams, jcache, jnp.asarray(tok))
        logits, cache = model.decode_step(params, cache, torch.from_numpy(tok))
        _close(logits, jlogits, 0, 1e-4)
    for group in groups:
        for got, want in zip(cache[group], jcache[group]):
            np.testing.assert_allclose(got.float().numpy(), _np(want),
                                       rtol=2 ** -3, atol=2 ** -9)
