"""Attention: the naive reference, the one-step decode, and the dispatch of
prefill attention to ``kernels.ops.flash_attention``.

All functions take q: (b, sq, h, e), k: (b, skv, g, e), v: (b, skv, g, ev)
with h = g * rep (GQA). Softmax statistics are float32. The JAX package's
blockwise, triangle, local (sliding-window) and MLA variants belong to the
model families that need them and are not here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops

NEG = -1e30


def _split_heads(q: torch.Tensor, g: int) -> torch.Tensor:
    b, s, h, e = q.shape
    return q.reshape(b, s, g, h // g, e)


def naive_attention(q, k, v, *, causal=True, scale=None):
    """Reference: materializes the full score matrix; causal rows are
    right-aligned to the keys (the last query sees every key)."""
    b, sq, h, eq = q.shape
    g, skv = k.shape[2], k.shape[1]
    scale = scale or eq ** -0.5
    s = torch.einsum("bqgre,bkge->bgrqk", _split_heads(q, g).float(),
                     k.float()) * scale
    if causal:
        q_pos = torch.arange(sq, device=q.device) + (skv - sq)
        k_pos = torch.arange(skv, device=q.device)
        s = s.masked_fill(k_pos[None, :] > q_pos[:, None], NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrqk,bkgf->bqgrf", p.to(v.dtype), v)
    return o.reshape(b, sq, h, v.shape[-1])


def decode_attention(q, k_cache, v_cache, cur_len, *, scale=None):
    """One-step decode: q (b, 1, h, eq) against cache (b, S, g, e*).

    cur_len: 0-dim int tensor — the number of valid cache positions
    (including this step's freshly inserted kv); it stays on the device, so
    a decode step never waits for the host.
    """
    b, _, h, eq = q.shape
    g, S = k_cache.shape[2], k_cache.shape[1]
    scale = scale or eq ** -0.5
    qg = q.reshape(b, g, h // g, eq)
    s = torch.einsum("bgre,bsge->bgrs", qg.float(), k_cache.float()) * scale
    valid = torch.arange(S, device=q.device) < cur_len
    s = s.masked_fill(~valid, NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrs,bsgf->bgrf", p.to(v_cache.dtype), v_cache)
    return o.reshape(b, 1, h, v_cache.shape[-1])


def attention(q, k, v, *, impl="kernel", causal=True, scale=None):
    """Prefill attention through ``ops.flash_attention``: the CUDA kernel
    for CUDA tensors under ``impl="kernel"``, else its plain version."""
    return ops.flash_attention(q, k, v, causal=causal, scale=scale, impl=impl)
