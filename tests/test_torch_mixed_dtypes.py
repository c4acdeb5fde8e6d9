"""Parameters and activations of different dtypes against the JAX package.

With ``param_dtype="bfloat16"`` and ``activation_dtype="float32"`` every
product of a bfloat16 weight with a float32 activation promotes to
float32 in the reference's ``jnp.einsum``; the port casts the bfloat16
operand up (exactly) and multiplies in float32 (``common.einsum`` and
``common.matmul``), where a bare ``torch.einsum`` raises. One model of
each class, ``TransformerLM`` (yi-6b), ``RecurrentGemmaLM`` and
``XLSTMLM``, at ``reduce_for_smoke`` with the JAX package's weights (made
by ``init_tree``, bfloat16 where the def says so, carried over exactly):
``loss`` within 1e-5 absolute and prefill logits within 1e-4 of their
largest (tests/test_torch_lm_families.py's float32 bounds).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config
from repro.configs import reduce_for_smoke as j_reduce
from repro.models import build_model as j_build_model
from repro.models.params import init_tree

from repro_torch.common import dtype_of, einsum, matmul, tree_map_with_path
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models import build_model
from repro_torch.models.params import params_from_numpy

B, S = 2, 40
MIXED = dict(param_dtype="bfloat16", activation_dtype="float32")


def _to_numpy(tree):
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32))
                        if a.dtype == jnp.bfloat16 else np.asarray(a), tree)


@pytest.mark.parametrize("arch", ["yi-6b", "recurrentgemma-9b", "xlstm-125m"])
def test_mixed_dtypes_match_jax(arch):
    jcfg = dataclasses.replace(j_reduce(j_get_config(arch)), **MIXED)
    cfg = dataclasses.replace(reduce_for_smoke(get_config(arch)), **MIXED)
    jmodel = j_build_model(jcfg)
    jparams = init_tree(jmodel.param_defs(), jax.random.key(0))
    model = build_model(cfg, device="cpu")
    defs = dict(model.param_defs())
    params = params_from_numpy(_to_numpy(jparams), "cpu")
    params = tree_map_with_path(
        lambda path, t: t.to(dtype_of(_at(defs, path).dtype)), params)
    assert params["embed"].dtype == torch.bfloat16
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[rng.rand(B, S) < 0.1] = -1
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tbatch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    jloss, _ = jax.jit(jmodel.loss)(jparams, jbatch)
    with torch.no_grad():
        loss, _ = model.loss(params, tbatch)
        logits, _ = model.prefill(params, {"tokens": tbatch["tokens"]})
    assert loss.dtype == torch.float32
    assert abs(float(loss) - float(jloss)) <= 1e-5
    jlogits, _ = jax.jit(jmodel.prefill)(jparams, {"tokens": jbatch["tokens"]})
    want = np.asarray(jlogits, np.float32)
    assert logits.dtype == torch.float32 and logits.shape == want.shape
    np.testing.assert_allclose(logits.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def _at(tree, path):
    for p in path:
        tree = tree[p] if isinstance(tree, dict) else tree[int(p)]
    return tree


def test_products_promote_as_jnp():
    rng = np.random.RandomState(1)
    a = rng.randn(3, 5).astype(np.float32)
    w = torch.from_numpy(rng.randn(5, 4).astype(np.float32)).to(torch.bfloat16)
    got = einsum("ij,jk->ik", torch.from_numpy(a), w)
    want = jnp.einsum("ij,jk->ik", jnp.asarray(a),
                      jnp.asarray(w.float().numpy()).astype(jnp.bfloat16))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(matmul(torch.from_numpy(a), w).numpy(),
                               np.asarray(want), rtol=1e-6, atol=1e-6)
    # one dtype: untouched
    wb = w.clone()
    assert einsum("jk->kj", wb).dtype == torch.bfloat16
