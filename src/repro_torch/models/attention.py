"""Attention: the naive reference, sliding-window local attention, the
one-step decode, the dispatch of prefill attention to
``kernels.ops.flash_attention``, and MLA (deepseek-v3's multi-head latent
attention).

The GQA functions take q: (b, sq, h, e), k: (b, skv, g, e), v: (b, skv,
g, ev) with h = g * rep. MLA's take the latent kv instead: ckv (b, s, c)
and the roped k_pe (b, s, dr) shared by every head, with the up-projections
kv_b_k (c, h, dn) and kv_b_v (c, h, dv). Softmax statistics are float32.
MLA and the sliding window run in plain PyTorch in both packages: MLA's
head dims (dn + dr for q and k, dv for v) differ, the flash kernel takes
equal ones, and it has no window. The JAX package's blockwise and
triangle variants are its XLA lowerings of full causal attention, which
the flash kernel does here; they are not ported.
"""
from __future__ import annotations

import torch

from repro_torch.common import ceil_div, einsum
from repro_torch.kernels import ops

NEG = -1e30


def _split_heads(q: torch.Tensor, g: int) -> torch.Tensor:
    b, s, h, e = q.shape
    return q.reshape(b, s, g, h // g, e)


def naive_attention(q, k, v, *, causal=True, window=0, scale=None):
    """Reference: materializes the full score matrix; causal rows are
    right-aligned to the keys (the last query sees every key). With a
    window, query q sees only keys k with q - k < window."""
    b, sq, h, eq = q.shape
    g, skv = k.shape[2], k.shape[1]
    scale = scale or eq ** -0.5
    s = einsum("bqgre,bkge->bgrqk", _split_heads(q, g).float(),
               k.float()) * scale
    if causal or window:
        q_pos = torch.arange(sq, device=q.device) + (skv - sq)
        k_pos = torch.arange(skv, device=q.device)
        masked = torch.zeros((sq, skv), dtype=torch.bool, device=q.device)
        if causal:
            masked |= k_pos[None, :] > q_pos[:, None]
        if window:
            masked |= q_pos[:, None] - k_pos[None, :] >= window
        s = s.masked_fill(masked, NEG)
    p = torch.softmax(s, dim=-1)
    o = einsum("bgrqk,bkgf->bqgrf", p.to(v.dtype), v)
    return o.reshape(b, sq, h, v.shape[-1])


def local_attention(q, k, v, *, window, block_q=512, scale=None):
    """Sliding-window causal attention in O(sq * window): query q sees the
    keys k <= q with q - k < window. q and k start at the same position
    (sq == skv, a prefill). Each block of block_q queries touches only
    the kv span [clip(q_start - window, 0, skv - span), + span), span =
    min(window + block_q, skv), so no sq x skv score matrix is held; the
    last block is short (the JAX package pads it and drops the padded
    rows, which changes no other row). Scores and softmax in float32, the
    probabilities rounded to v's dtype before the product, as the JAX
    package's ``local_attention``."""
    b, sq, h, eq = q.shape
    g, skv, ev = k.shape[2], k.shape[1], v.shape[-1]
    scale = scale or eq ** -0.5
    block_q = min(block_q, sq)
    span = min(window + block_q, skv)
    out = torch.empty((b, sq, h, ev), dtype=v.dtype, device=q.device)
    for q_start in range(0, sq, block_q):
        qb = q[:, q_start:q_start + block_q]
        bq = qb.shape[1]
        start = min(max(q_start - window, 0), skv - span)
        kj, vj = k[:, start:start + span], v[:, start:start + span]
        s = einsum("bqgre,bkge->bgrqk", _split_heads(qb, g).float(),
                   kj.float()) * scale
        q_pos = q_start + torch.arange(bq, device=q.device)
        k_pos = start + torch.arange(span, device=q.device)
        msk = ((k_pos[None] <= q_pos[:, None])
               & (q_pos[:, None] - k_pos[None] < window))
        s = s.masked_fill(~msk, NEG)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * msk
        p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
        o = einsum("bgrqk,bkgf->bqgrf", p.to(v.dtype), vj)
        out[:, q_start:q_start + bq] = o.reshape(b, bq, h, ev)
    return out


def decode_attention(q, k_cache, v_cache, cur_len, *, window=0, scale=None):
    """One-step decode: q (b, 1, h, eq) against cache (b, S, g, e*).

    cur_len: 0-dim int tensor — the number of valid cache positions
    (including this step's freshly inserted kv); it stays on the device, so
    a decode step never waits for the host. With a window (a rotating
    cache of S == window slots) the valid slots are those below
    min(cur_len, window), as in the JAX package: slot validity, not
    position.
    """
    b, _, h, eq = q.shape
    g, S = k_cache.shape[2], k_cache.shape[1]
    scale = scale or eq ** -0.5
    qg = q.reshape(b, g, h // g, eq)
    s = einsum("bgre,bsge->bgrs", qg.float(), k_cache.float()) * scale
    valid = torch.arange(S, device=q.device) < (
        torch.clamp(cur_len, max=window) if window else cur_len)
    s = s.masked_fill(~valid, NEG)
    p = torch.softmax(s, dim=-1)
    o = einsum("bgrs,bsgf->bgrf", p.to(v_cache.dtype), v_cache)
    return o.reshape(b, 1, h, v_cache.shape[-1])


def attention(q, k, v, *, impl="kernel", causal=True, window=0,
              block_q=512, scale=None):
    """Prefill attention through ``ops.flash_attention``: the CUDA kernel
    for CUDA tensors under ``impl="kernel"``, else its plain version. A
    windowed call never reaches the kernel, which has no window: a causal
    one runs ``local_attention`` under every impl, another
    ``naive_attention`` (the JAX package's ``pallas_interpret`` path
    drops the window instead)."""
    if window:
        if causal:
            return local_attention(q, k, v, window=window, block_q=block_q,
                                   scale=scale)
        return naive_attention(q, k, v, causal=False, window=window,
                               scale=scale)
    return ops.flash_attention(q, k, v, causal=causal, scale=scale, impl=impl)


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, deepseek-v3)
# ---------------------------------------------------------------------------


def _flash_q_block(qb, q_start, producer, nk, block_kv, ev, scale):
    """Online softmax over kv blocks for one q block, the JAX package's
    ``_flash_q_block`` with a kv producer and one kv head a query head.

    qb: (b, Bq, h, e), its rows at positions q_start...; producer(j) ->
    (kj (b, Bk, h, e), vj (b, Bk, h, ev)), kv block j (positions
    j * block_kv...) made on the fly, for j < nk. Returns o (b, h, Bq, ev)
    float32, normalised."""
    b, bq, h, _ = qb.shape
    q_pos = q_start + torch.arange(bq, device=qb.device)
    qf = qb.float()
    o = torch.zeros((b, h, bq, ev), dtype=torch.float32, device=qb.device)
    m = torch.full((b, h, bq), NEG, dtype=torch.float32, device=qb.device)
    l = torch.zeros((b, h, bq), dtype=torch.float32, device=qb.device)
    for j in range(nk):
        kj, vj = producer(j)
        k_pos = j * block_kv + torch.arange(kj.shape[1], device=qb.device)
        msk = k_pos[None, :] <= q_pos[:, None]
        s = einsum("bqhe,bkhe->bhqk", qf, kj.float()) * scale
        s = s.masked_fill(~msk, NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None]) * msk
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        # p rounded to the value dtype before p.v, the product in float32
        pv = einsum("bhqk,bkhf->bhqf", p.to(vj.dtype).float(),
                    vj.float())
        o = o * alpha[..., None] + pv
        m = m_new
    return o / torch.clamp(l, min=1e-30)[..., None]


def mla_prefill_attention(q, ckv, k_pe, kv_b_k, kv_b_v, *, scale,
                          block_q=512, block_kv=1024):
    """Blockwise causal MLA attention that up-projects the latent kv one
    block at a time: the per-head K/V of the whole sequence, (b, s, h,
    dn + dr) and (b, s, h, dv), is never held. q: (b, s, h, dn + dr);
    ckv: (b, s, c); k_pe: (b, s, dr). Returns (b, s, h, dv) in ckv's dtype.

    The JAX package pads q and the latent to whole blocks, visits every
    (q block, kv block) pair and masks. Here the last blocks are short
    instead (a masked padding position adds exactly 0), and a kv block
    wholly above a q block's diagonal is skipped: it is masked for every
    row, so its scores are NEG, m stays, alpha = exp(0) = 1 and p = 0, and
    it adds exactly 0 to l and o. Neither changes a bit. On ``meta``
    tensors (no values: the dry-run's count) a q block's kv blocks run as
    one block over the same rows: the same products, one dispatch each."""
    b, sq, h, _ = q.shape
    dv = kv_b_v.shape[-1]
    skv = ckv.shape[1]
    block_q, block_kv = min(block_q, sq), min(block_kv, skv)

    def producer(j, blocks=1):
        c_j = ckv[:, j * block_kv:(j + blocks) * block_kv]
        pe_j = k_pe[:, j * block_kv:(j + blocks) * block_kv]
        kn = einsum("bkc,chn->bkhn", c_j, kv_b_k)
        vv = einsum("bkc,chv->bkhv", c_j, kv_b_v)
        kk = torch.cat([kn, pe_j[:, :, None, :].expand(
            *kn.shape[:3], pe_j.shape[-1])], dim=-1)
        return kk, vv

    out = torch.empty((b, sq, h, dv), dtype=ckv.dtype, device=q.device)
    for q_start in range(0, sq, block_q):
        qb = q[:, q_start:q_start + block_q]
        # the kv blocks that start at or before the block's last row
        nk = min(ceil_div(skv, block_kv),
                 (q_start + qb.shape[1] - 1) // block_kv + 1)
        if q.device.type == "meta":
            o = _flash_q_block(qb, q_start, lambda j, n=nk: producer(0, n), 1,
                               block_kv, dv, scale)
        else:
            o = _flash_q_block(qb, q_start, producer, nk, block_kv, dv, scale)
        out[:, q_start:q_start + block_q] = o.transpose(1, 2).to(ckv.dtype)
    return out


def mla_naive_attention(q, ckv, k_pe, kv_b_k, kv_b_v, *, scale):
    """The JAX package's ``attention_impl="naive"`` MLA prefill, the plain
    yardstick of ``mla_prefill_attention``: the whole latent up-projected
    to per-head K/V, then ``naive_attention`` with the explicit scale."""
    dn = kv_b_k.shape[-1]
    kvup = einsum("bsk,khe->bshe", ckv, torch.cat([kv_b_k, kv_b_v], -1))
    k_nope, v = kvup[..., :dn], kvup[..., dn:]
    k = torch.cat([k_nope, k_pe[:, :, None, :].expand(
        *k_nope.shape[:3], k_pe.shape[-1])], dim=-1)
    return naive_attention(q, k, v, causal=True, scale=scale)


def mla_absorbed_decode(q_nope, q_pe, ckv_cache, kpe_cache, kv_b_k, kv_b_v,
                        cur_len, *, scale):
    """Matrix-absorbed MLA decode: the scores are taken against the latent
    cache directly, never against per-head K/V.

    q_nope: (b, h, dn), q_pe: (b, h, dr); ckv_cache: (b, S, c); kpe_cache:
    (b, S, dr); cur_len: 0-dim int tensor, the valid positions (this step's
    included), compared on the device. Returns (b, h, dv)."""
    qc = einsum("bhn,chn->bhc", q_nope, kv_b_k)          # absorb W_UK
    s = einsum("bhc,bsc->bhs", qc.float(), ckv_cache.float())
    s = s + einsum("bhr,bsr->bhs", q_pe.float(), kpe_cache.float())
    s = s * scale
    valid = torch.arange(ckv_cache.shape[1], device=s.device) < cur_len
    p = torch.softmax(s.masked_fill(~valid, NEG), dim=-1)
    oc = einsum("bhs,bsc->bhc", p.to(ckv_cache.dtype), ckv_cache)
    return einsum("bhc,chv->bhv", oc, kv_b_v)            # absorb W_UV
