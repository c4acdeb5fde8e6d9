"""The port's attention against the JAX package's: the flash-attention
kernel's plain version against the Pallas kernel (interpret mode) and
``ref.attention_ref``, the naive and decode attention against the JAX
ones, and the dispatch rules.

Inputs are made by numpy from a seed; bf16 inputs are rounded once with
ml_dtypes and handed to both packages. Tolerances are those of
tests/test_kernels_attention.py: 2e-5 in float32, 2e-2 in bfloat16 (one
rounding of the output). The CUDA kernels run only on a card: their case
is marked ``gpu`` and skips elsewhere. A numerical model of the
tensor-core kernel (P rounded to bf16 before P.V) stands in for it on the
CPU, held against ``ref.attention_ref`` at the same bf16 tolerance."""
import math

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
from repro_torch.kernels import flash_attention as fa
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
# chip_smoke.py's flash_attention fuzz: (causal, sq, skv), ragged lengths
# and the end-aligned causal diagonal with sq < skv
FUZZ = [(True, 1, 1), (True, 63, 63), (True, 65, 65), (True, 1000, 1000),
        (True, 1, 65), (True, 63, 1000), (True, 65, 130), (True, 1, 1000),
        (False, 65, 63), (False, 1000, 1), (False, 63, 1000), (False, 1, 65)]


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


def _row_rel_err(got, want) -> float:
    """max over rows of max|got - want| / max|want| in that row: an error
    that scales with the output, where the absolute bf16 bound is a large
    share of the small outputs of long rows."""
    got, want = (x.float() if isinstance(x, torch.Tensor)
                 else torch.tensor(_f32(x)) for x in (got, want))
    d = (got - want).abs().amax(-1)
    return float((d / want.abs().amax(-1).clamp(min=1e-30)).max())


# max |got - want| in a row over max |want| there: four bf16 ulps of the
# row's largest element (chip_smoke.py's ATTN_ROW_TOL)
ROW_TOL = {"float32": 2 ** -12, "bfloat16": 2 ** -5}


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


def _wgmma_model(q, k, v, causal, block_kv=128, lose=None):
    """The arithmetic of csrc/flash_attention.cu's wgmma kernel in plain
    torch: kv tiles of block_kv keys (tiles wholly above the causal
    diagonal skipped), scores in float32 scaled by scale * log2(e), an
    online max and rescale with exp2, p zeroed by the mask, the sum l from
    the float32 p, P rounded to bf16 before P.V, the output rounded once.
    ``lose=(k0, row)`` models a faulty kernel: the tile at key k0 is lost
    for query rows from ``row`` on."""
    b, sq, h, e = q.shape
    skv, g = k.shape[1], k.shape[2]
    c = e ** -0.5 * math.log2(math.e)
    qg = q.float().reshape(b, sq, g, h // g, e)
    rows = torch.arange(sq)[:, None]
    acc = torch.zeros(b, g, h // g, sq, e)
    m = torch.full((b, g, h // g, sq), fa.NEG)
    l = torch.zeros(b, g, h // g, sq)
    last = sq - 1 + skv - sq if causal else skv - 1
    for k0 in range(0, min(skv, last + 1), block_kv):
        kt, vt = (x[:, k0:k0 + block_kv].float() for x in (k, v))
        cols = torch.arange(k0, k0 + kt.shape[1])[None, :]
        ok = cols <= rows + (skv - sq) if causal else cols >= 0
        if lose is not None and k0 == lose[0]:
            ok = ok & (rows < lose[1])
        s = torch.einsum("bqgre,bkge->bgrqk", qg, kt) * c
        s = torch.where(ok, s, torch.tensor(fa.NEG))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None]) * ok
        l = l * alpha + p.sum(-1)
        pv = torch.einsum("bgrqk,bkge->bgrqe", p.bfloat16().float(), vt)
        acc = acc * alpha[..., None] + pv
        m = m_new
    o = acc / l.clamp(min=1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, e).to(q.dtype)


@pytest.mark.parametrize("case", CASES)
def test_wgmma_model_matches_ref_on_cases(case, rng):
    """bf16 P before P.V stays inside the bf16 tolerance on the reference
    test's cases."""
    b, sq, skv, h, g, e, causal = case
    (jq, jk, jv), (q, k, v) = _inputs(rng, b, sq, skv, h, g, e, "bfloat16")
    got = _wgmma_model(q, k, v, causal)
    want = jref.attention_ref(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=0,
                               atol=TOL["bfloat16"])
    assert _row_rel_err(got, want) <= ROW_TOL["bfloat16"]


@pytest.mark.parametrize("causal,sq,skv", FUZZ)
def test_wgmma_model_matches_ref_on_fuzz_shapes(causal, sq, skv, rng):
    """The same at the chip fuzz's lengths, at yi-6b's head dim and GQA
    ratio: ragged tails, a single key, causal with sq < skv."""
    (jq, jk, jv), (q, k, v) = _inputs(rng, 1, sq, skv, 16, 2, 128, "bfloat16")
    got = _wgmma_model(q, k, v, causal)
    want = jref.attention_ref(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=0,
                               atol=TOL["bfloat16"])
    assert _row_rel_err(got, want) <= ROW_TOL["bfloat16"]
    if skv > 1:        # rounding P moves the result off the plain version
        assert not torch.equal(got, flash_attention_plain(q, k, v, causal))


@pytest.mark.parametrize("lose", [(256, 900), (0, 999), (896, 990)])
def test_row_check_catches_a_lost_kv_tile(lose, rng):
    """The per-row bound passes the kernel's rounding of P and fails a
    kernel that loses one interior, first or diagonal kv tile for a few
    late rows of a long causal prompt."""
    _, (q, k, v) = _inputs(rng, 1, 1000, 1000, 8, 2, 128, "bfloat16")
    want = flash_attention_plain(q, k, v, causal=True)
    assert _row_rel_err(_wgmma_model(q, k, v, True), want) <= ROW_TOL["bfloat16"]
    bad = _wgmma_model(q, k, v, True, lose=lose)
    assert _row_rel_err(bad, want) > 4 * ROW_TOL["bfloat16"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e", fa.HEAD_DIMS)
def test_variant_choice_by_dtype_and_head_dim(dtype, e):
    q = torch.zeros((1, 4, 8, e), dtype=getattr(torch, dtype))
    want = "wgmma" if dtype == "bfloat16" and e in (64, 128) else "simt"
    assert fa.variant(q) == want


def test_variant_needs_16_byte_aligned_pointers(monkeypatch):
    """The wgmma kernel's tensor maps need q, k and v 16-byte aligned: the
    wrapper raises on a pointer that is not, and never swaps kernels."""
    q = torch.zeros((1, 4, 8, 128), dtype=torch.bfloat16)
    flat = torch.zeros(q.numel() + 1, dtype=torch.bfloat16)
    off = flat[1:].view(q.shape)                 # 2 bytes past an allocation
    assert fa.variant(off) == fa.variant(q) == "wgmma"
    # let CPU tensors past the device check, which comes first on a card
    monkeypatch.setattr(fa, "check_tensor", lambda *a, **kw: None)
    for name, args in (("q", (off, q, q)), ("k", (q, off, q)),
                       ("v", (q, q, off))):
        with pytest.raises(ValueError, match=f"{name}: .*16-byte aligned"):
            flash_attention_cuda(*args)


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
@pytest.mark.parametrize("dtype,shape", [
    (dt, shape) for dt in ("float32", "bfloat16") for shape in [
        (2, 130, 130, 8, 2, 64, True), (1, 63, 1000, 4, 4, 128, True),
        (2, 65, 97, 4, 1, 16, False), (1, 1, 65, 32, 4, 32, True)]]
    # yi-6b's prefill head layout at one full prompt
    + [("bfloat16", (1, 4000, 4000, 32, 4, 128, True))]
    # dbrx's and yi-34b's GQA ratios of 6 and 7 (not powers of two)
    + [(dt, shape) for dt in ("float32", "bfloat16") for shape in [
        (1, 2048, 2048, 48, 8, 128, True), (1, 1000, 1000, 56, 8, 128, True)]])
def test_cuda_kernel_matches_plain(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    b, sq, skv, h, g, e, causal = shape
    _, tens = _inputs(np.random.RandomState(sq), b, sq, skv, h, g, e, dtype)
    q, k, v = (t.cuda() for t in tens)
    kernel = "wgmma" if dtype == "bfloat16" and e in (64, 128) else "simt"
    before = dict(ops.launches)
    by_kernel = dict(ops.flash_attention_variants)
    got = ops.flash_attention(q, k, v, causal=causal, impl="kernel")
    want = ops.flash_attention(q, k, v, causal=causal, impl="torch")
    assert ops.launches["flash_attention"] == before["flash_attention"] + 1
    assert ops.flash_attention_variants == {
        n: c + (n == kernel) for n, c in by_kernel.items()}
    err = float((got.float() - want.float()).abs().max())
    assert err <= TOL[dtype], err
    assert _row_rel_err(got.cpu(), want.cpu()) <= ROW_TOL[dtype]
