"""The port's attention against the JAX package's: the flash-attention
kernel's plain version against the Pallas kernel (interpret mode) and
``ref.attention_ref``, the naive and decode attention against the JAX
ones, and the dispatch rules.

Inputs are made by numpy from a seed; bf16 inputs are rounded once with
ml_dtypes and handed to both packages. Tolerances are those of
tests/test_kernels_attention.py: 2e-5 in float32, 2e-2 in bfloat16 (one
rounding of the output). The CUDA kernel runs only on a card: its case is
marked ``gpu`` and skips elsewhere."""
import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_plain)
from repro_torch.models import attention as attn

CASES = [
    # (b, sq, skv, h, g, e, causal): tests/test_kernels_attention.py's CASES
    (2, 128, 128, 4, 4, 64, True),
    (1, 256, 256, 8, 2, 32, True),
    (2, 96, 160, 4, 1, 16, False),
    (1, 64, 64, 2, 2, 128, True),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(rng, b, sq, skv, h, g, e, dtype):
    """(numpy arrays for JAX, tensors for the port) holding equal values."""
    arrs = [rng.randn(b, sq, h, e), rng.randn(b, skv, g, e),
            rng.randn(b, skv, g, e)]
    if dtype == "bfloat16":
        arrs = [a.astype(ml_dtypes.bfloat16) for a in arrs]
        tens = [torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
                for a in arrs]
    else:
        arrs = [a.astype(np.float32) for a in arrs]
        tens = [torch.from_numpy(a) for a in arrs]
    return [jnp.asarray(a) for a in arrs], tens


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_and_ref(case, dtype, rng):
    b, sq, skv, h, g, e, causal = case
    (jq, jk, jv), (q, k, v) = _inputs(rng, b, sq, skv, h, g, e, dtype)
    got = ops.flash_attention(q, k, v, causal=causal)
    assert got.dtype == q.dtype and got.shape == (b, sq, h, e)
    want = jref.attention_ref(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=0, atol=TOL[dtype])
    pallas = jops.flash_attention(jq, jk, jv, causal=causal, block_q=64,
                                  block_kv=64)
    np.testing.assert_allclose(_f32(got), _f32(pallas), rtol=0,
                               atol=TOL[dtype])


@pytest.mark.parametrize("sq,skv", [(1, 70), (40, 100), (63, 65)])
def test_causal_end_aligned_when_sq_differs(sq, skv, rng):
    (jq, jk, jv), (q, k, v) = _inputs(rng, 2, sq, skv, 4, 2, 32, "float32")
    got = ops.flash_attention(q, k, v, causal=True)
    want = jref.attention_ref(jq, jk, jv, causal=True)
    np.testing.assert_allclose(got.numpy(), _f32(want), rtol=0, atol=2e-5)
    # the last query row sees every key: a decode step's row
    full = ops.flash_attention(q, k, v, causal=False)
    np.testing.assert_allclose(got[:, -1].numpy(), full[:, -1].numpy(),
                               rtol=0, atol=2e-5)


def test_causal_rejects_more_queries_than_keys():
    q = torch.zeros((1, 8, 2, 16))
    k = torch.zeros((1, 4, 2, 16))
    for impl in ("kernel", "torch"):
        with pytest.raises(ValueError, match="sq <= skv"):
            ops.flash_attention(q, k, k, causal=True, impl=impl)


@pytest.mark.parametrize("causal", [True, False])
def test_naive_attention_matches_jax(causal, rng):
    (jq, jk, jv), (q, k, v) = _inputs(rng, 2, 24, 40, 4, 2, 16, "float32")
    got = attn.naive_attention(q, k, v, causal=causal)
    want = jattn.naive_attention(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(got.numpy(), _f32(want), rtol=0, atol=2e-5)


def test_decode_matches_jax_and_prefill_row(rng):
    """test_kernels_attention.py::test_decode_matches_prefill_row on both
    packages, and the port's decode against a cache longer than cur_len."""
    b, s, h, g, e = 2, 33, 4, 2, 16
    (jq, jk, jv), (q, k, v) = _inputs(rng, b, s, s, h, g, e, "float32")
    one = attn.decode_attention(q[:, -1:], k, v, cur_len=torch.tensor(s))
    full = attn.naive_attention(q, k, v, causal=True)
    np.testing.assert_allclose(one[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=0, atol=2e-5)
    want = jattn.decode_attention(jq[:, -1:], jk, jv, cur_len=s)
    np.testing.assert_allclose(one.numpy(), _f32(want), rtol=0, atol=2e-5)
    # slots at and past cur_len are masked, whatever they hold
    part = attn.decode_attention(q[:, 20:21], k, v, cur_len=torch.tensor(21))
    want = jattn.decode_attention(jq[:, 20:21], jk, jv, cur_len=21)
    np.testing.assert_allclose(part.numpy(), _f32(want), rtol=0, atol=2e-5)


def test_dispatch_on_the_cpu_uses_the_plain_version(rng):
    _, (q, k, v) = _inputs(rng, 1, 16, 16, 4, 2, 16, "float32")
    before = dict(ops.launches)
    got = attn.attention(q, k, v, impl="kernel")
    want = flash_attention_plain(q, k, v, causal=True)
    assert torch.equal(got, want)
    assert torch.equal(attn.attention(q, k, v, impl="torch"), want)
    assert ops.launches == before                # no kernel ran
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v, impl="pallas_interpret")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, v)


@pytest.mark.parametrize("impl", ["xla", "naive", "pallas_interpret", "xla_tri"])
def test_config_rejects_the_jax_impl_names(impl):
    with pytest.raises(ValueError, match="kernel"):
        ModelConfig(name="x", family="dense", num_layers=1, d_model=8,
                    num_heads=1, num_kv_heads=1, d_ff=8, vocab_size=8,
                    attention_impl=impl)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [
    (2, 130, 130, 8, 2, 64, True), (1, 63, 1000, 4, 4, 128, True),
    (2, 65, 97, 4, 1, 16, False), (1, 1, 65, 32, 4, 32, True)])
def test_cuda_kernel_matches_plain(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    b, sq, skv, h, g, e, causal = shape
    _, tens = _inputs(np.random.RandomState(sq), b, sq, skv, h, g, e, dtype)
    q, k, v = (t.cuda() for t in tens)
    before = ops.launches["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal, impl="kernel")
    want = ops.flash_attention(q, k, v, causal=causal, impl="torch")
    assert ops.launches["flash_attention"] == before + 1
    err = float((got.float() - want.float()).abs().max())
    assert err <= TOL[dtype], err
