"""RecurrentGemma / Griffin: RG-LRU recurrent blocks and local attention in
a (rec, rec, attn) pattern.

The JAX package's ``RecurrentGemmaLM`` with the same parameter and cache
trees (the pattern's blocks stacked ``n_macro`` times under ``macros`` as
``b0``, ``b1``, ... ; the layers past the last whole macro as
``tail0``, ...), the same weight layouts, dtypes (``lam`` is float32) and
entry points. The JAX ``lax.scan`` over macros is a Python loop over the
macro index.

The RG-LRU is the diagonal linear recurrence h_t = a_t h_{t-1} + b_t,
computed over the sequence by `rg_lru_scan` in log depth. Local attention
is ``attention.local_attention``; a prefill caches the last min(window,
seq) keys and values, in the activation dtype, and decode writes slot
cur_len % W of that W-slot cache: the JAX package's rotating cache, which
agrees with a longer prefill only where the prompt is a multiple of the
window or prompt and steps stay inside it (ROADMAP, known behaviour 14).
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.common import dtype_of, einsum, matmul, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import embedding as embed_lib
from repro_torch.models.layers import (apply_rope, causal_conv1d, geglu,
                                      rms_norm, softmax_xent_chunked)
from repro_torch.models.params import init_params, pdef, stack_defs, unstack
from repro_torch.models.transformer import _cache_write, _remat, cache_slot

C_LRU = 8.0  # Griffin's fixed recurrence-sharpness constant


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Along dim 1: even[0], odd[0], even[1], ...; even has as many
    entries as odd or one more."""
    n = odd.shape[1]
    both = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    return torch.cat([both, even[:, n:]], dim=1) if even.shape[1] > n else both


def _scan(a: torch.Tensor, u: torch.Tensor):
    """Inclusive scan over dim 1 of the combine (a1, u1), (a2, u2) ->
    (a1 a2, a2 u1 + u2), by JAX's ``associative_scan`` recursion: combine
    adjacent pairs, scan the half, fix up the even entries. The same
    combine tree as the JAX package's, so the same sums in the same
    order; O(s) work in O(log s) rounds of whole-tensor passes."""
    n = a.shape[1]
    if n < 2:
        return a, u
    a0, u0 = a[:, 0:n - 1:2], u[:, 0:n - 1:2]
    a1, u1 = a[:, 1::2], u[:, 1::2]
    odd_a, odd_u = _scan(a0 * a1, a1 * u0 + u1)
    a2, u2 = a[:, 2::2], u[:, 2::2]
    if n % 2 == 0:
        pa, pu = odd_a[:, :-1], odd_u[:, :-1]
    else:
        pa, pu = odd_a, odd_u
    even_a = torch.cat([a[:, :1], pa * a2], dim=1)
    even_u = torch.cat([u[:, :1], a2 * pu + u2], dim=1)
    return _interleave(even_a, odd_a), _interleave(even_u, odd_u)


def rg_lru_scan(u: torch.Tensor, log_a: torch.Tensor,
                h0: torch.Tensor | None) -> torch.Tensor:
    """u, log_a: (b, s, w) float32. h_t = a_t h_{t-1} + u_t with a = exp(
    log_a), from h0 (b, w) or zeros; returns h (b, s, w). No per-step loop
    (s launches) and no closed form through exp(cumsum(log_a)), which
    underflows within a few hundred steps: `_scan`."""
    a = torch.exp(log_a)
    if h0 is not None:
        u = torch.cat([u[:, :1] + a[:, :1] * h0[:, None], u[:, 1:]], dim=1)
    return _scan(a, u)[1]


class RecurrentGemmaLM(nn.Module):
    """Stateless, as ``TransformerLM``: methods take the parameter tree.
    `device` is where it makes positions and caches.
    `mesh` and `rules` reach the embedding, as in ``TransformerLM``."""

    def __init__(self, cfg: ModelConfig, device="cuda", mesh=None, rules=None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device, "RecurrentGemmaLM")
        self.mesh, self.rules = mesh, rules
        self.adt = dtype_of(cfg.activation_dtype)
        period = len(cfg.block_pattern)
        self.n_macro = cfg.num_layers // period
        self.n_tail = cfg.num_layers - self.n_macro * period

    # ------------------------------------------------------------------
    # Parameter definitions
    # ------------------------------------------------------------------
    def _rec_defs(self) -> dict[str, Any]:
        c = self.cfg
        d, w, pd = c.d_model, c.lru_width, c.param_dtype
        return {
            "norm": pdef((d,), ("embed",), pd, "ones"),
            "w_gate_br": pdef((d, w), ("fsdp", "lru"), pd),
            "w_x": pdef((d, w), ("fsdp", "lru"), pd),
            "conv": pdef((c.conv_width, w), (None, "lru"), pd, "normal", 0.1),
            "w_a": pdef((w, w), ("fsdp", "lru"), pd, "normal", 0.01),
            "b_a": pdef((w,), ("lru",), pd, "zeros"),
            "w_i": pdef((w, w), ("fsdp", "lru"), pd, "normal", 0.01),
            "b_i": pdef((w,), ("lru",), pd, "zeros"),
            "lam": pdef((w,), ("lru",), "float32", "ones"),
            "w_out": pdef((w, d), ("lru", "fsdp"), pd),
        }

    def _attn_defs(self) -> dict[str, Any]:
        c = self.cfg
        d, h, g, e, pd = c.d_model, c.num_heads, c.num_kv_heads, c.resolved_head_dim, c.param_dtype
        return {
            "norm": pdef((d,), ("embed",), pd, "ones"),
            "wq": pdef((d, h, e), ("fsdp", "heads", "head_dim"), pd),
            "wk": pdef((d, g, e), ("fsdp", "kv_heads", "head_dim"), pd),
            "wv": pdef((d, g, e), ("fsdp", "kv_heads", "head_dim"), pd),
            "wo": pdef((h, e, d), ("heads", "head_dim", "fsdp"), pd),
        }

    def _mlp_defs(self) -> dict[str, Any]:
        c = self.cfg
        d, f, pd = c.d_model, c.d_ff, c.param_dtype
        return {
            "norm": pdef((d,), ("embed",), pd, "ones"),
            "w_gate": pdef((d, f), ("fsdp", "mlp"), pd),
            "w_up": pdef((d, f), ("fsdp", "mlp"), pd),
            "w_down": pdef((f, d), ("mlp", "fsdp"), pd),
        }

    def _block_defs(self, ltype: str) -> dict[str, Any]:
        mix = self._rec_defs() if ltype == "rec" else self._attn_defs()
        return {"mix": mix, "mlp": self._mlp_defs()}

    def param_defs(self) -> dict[str, Any]:
        c = self.cfg
        d, v, pd = c.d_model, c.vocab_size, c.param_dtype
        defs: dict[str, Any] = {"embed": pdef((v, d), ("vocab", "fsdp"), pd)}
        if self.n_macro:
            macro = {f"b{i}": self._block_defs(t)
                     for i, t in enumerate(c.block_pattern)}
            defs["macros"] = stack_defs(macro, self.n_macro)
        for j in range(self.n_tail):
            defs[f"tail{j}"] = self._block_defs(c.block_pattern[j])
        defs["final_norm"] = pdef((d,), ("embed",), pd, "ones")
        defs["lm_head"] = pdef((d, v), ("embed", "vocab"), pd)
        return defs

    def init_params(self, seed: int = 0) -> dict[str, Any]:
        return init_params(self.param_defs(), seed, self.device)

    # ------------------------------------------------------------------
    # Blocks
    # ------------------------------------------------------------------
    def _rec_block(self, p, x, *, mode, cache=None):
        """The RG-LRU block. Returns (x + out, (h_last (b, w) float32,
        conv_state (b, conv_width - 1, w))) in prefill. In decode `cache`
        is this layer's (h, conv_state) views, updated in place."""
        c = self.cfg
        xs = rms_norm(x, p["norm"], c.norm_eps)
        gate = F.gelu(matmul(xs, p["w_gate_br"]), approximate="tanh")
        u = matmul(xs, p["w_x"])
        u, new_conv = causal_conv1d(u, p["conv"],
                                    cache[1] if cache is not None else None)
        uf = u.float()
        r = torch.sigmoid(uf @ p["w_a"].float() + p["b_a"].float())
        i = torch.sigmoid(uf @ p["w_i"].float() + p["b_i"].float())
        log_a = -C_LRU * F.softplus(p["lam"]) * r          # (b, s, w), < 0
        beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6))
        b_in = beta * (i * uf)
        new_cache = None
        if mode == "decode":
            h0, conv = cache
            h = (torch.exp(log_a[:, 0]) * h0 + b_in[:, 0])[:, None]
            h0.copy_(h[:, 0])
            conv.copy_(new_conv)
        else:
            h = rg_lru_scan(b_in, log_a, None)
            if mode == "prefill":
                new_cache = (h[:, -1], new_conv)
        out = matmul(h.to(x.dtype) * gate, p["w_out"])
        return x + out, new_cache

    def _attn_block(self, p, x, positions, *, mode, cache=None, cur_len=None):
        """Local attention. Returns (x + out, (k, v) of the last
        min(window, s) positions) in prefill; in decode writes `cache`'s
        slot cur_len % W (W its slots) and attends with window W."""
        c = self.cfg
        xs = rms_norm(x, p["norm"], c.norm_eps)
        q = einsum("bsd,dhe->bshe", xs, p["wq"])
        k = einsum("bsd,dge->bsge", xs, p["wk"])
        v = einsum("bsd,dge->bsge", xs, p["wv"])
        q = apply_rope(q, positions, c.rope_theta)
        k = apply_rope(k, positions, c.rope_theta)
        new_cache = None
        if mode == "decode":
            kc, vc = cache
            W = kc.shape[1]
            slot = cache_slot(cur_len, W, W)
            _cache_write(kc, slot, k)
            _cache_write(vc, slot, v)
            o = attn_lib.decode_attention(q, kc, vc, cur_len + 1, window=W)
        else:
            o = attn_lib.local_attention(q, k, v, window=c.window_size,
                                         block_q=c.attn_block_q)
            if mode == "prefill":
                W = min(c.window_size, k.shape[1])
                new_cache = (k[:, -W:], v[:, -W:])
        out = einsum("bshe,hed->bsd", o, p["wo"])
        return x + out, new_cache

    def _block(self, p, x, positions, ltype, *, mode, cache=None,
               cur_len=None):
        if ltype == "rec":
            x, new_cache = self._rec_block(p["mix"], x, mode=mode, cache=cache)
        else:
            x, new_cache = self._attn_block(p["mix"], x, positions, mode=mode,
                                            cache=cache, cur_len=cur_len)
        xs = rms_norm(x, p["mlp"]["norm"], self.cfg.norm_eps)
        x = x + geglu(xs, p["mlp"]["w_gate"], p["mlp"]["w_up"],
                      p["mlp"]["w_down"])
        return x, new_cache

    def _macro_train(self, p, x, positions):
        for i, t in enumerate(self.cfg.block_pattern):
            x, _ = self._block(p[f"b{i}"], x, positions, t, mode="train")
        return x

    def _layers(self, params):
        """(cache key, macro index or None, block name or None, layer
        type, parameters) of every layer in order: the macros' blocks,
        then the tail."""
        pat = self.cfg.block_pattern
        if self.n_macro:
            for m, p in enumerate(unstack(params["macros"])):
                for i, t in enumerate(pat):
                    yield "macros", m, f"b{i}", t, p[f"b{i}"]
        for j in range(self.n_tail):
            yield f"tail{j}", None, None, pat[j], params[f"tail{j}"]

    @staticmethod
    def _layer_cache(cache, key, m, name):
        """One layer's cache tuple: views of the stacked macro cache."""
        if m is None:
            return cache[key]
        return tuple(t[m] for t in cache[key][name])

    # ------------------------------------------------------------------
    # Caches and entry points
    # ------------------------------------------------------------------
    def cache_defs(self, batch: int, seq_len: int) -> dict[str, Any]:
        c = self.cfg
        dt = c.activation_dtype
        w = c.lru_width
        W = min(c.window_size, seq_len)
        g, e = c.num_kv_heads, c.resolved_head_dim

        def mix_cache(t):
            if t == "rec":
                return (pdef((batch, w), ("batch", "lru"), "float32", "zeros"),
                        pdef((batch, c.conv_width - 1, w), ("batch", None, "lru"), dt, "zeros"))
            return (pdef((batch, W, g, e), ("batch", None, "kv_heads", "head_dim"), dt, "zeros"),
                    pdef((batch, W, g, e), ("batch", None, "kv_heads", "head_dim"), dt, "zeros"))

        defs: dict[str, Any] = {}
        if self.n_macro:
            macro = {f"b{i}": mix_cache(t) for i, t in enumerate(c.block_pattern)}
            defs["macros"] = stack_defs(macro, self.n_macro)
        for j in range(self.n_tail):
            defs[f"tail{j}"] = mix_cache(c.block_pattern[j])
        defs["cur_len"] = pdef((), (), "int32", "zeros")
        return defs

    def _embed(self, params, tokens):
        return embed_lib.embed(params["embed"], tokens,
                               self.cfg.embedding_impl, self.mesh,
                               self.rules).to(self.adt)

    def _logits(self, params, x):
        h = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        return einsum("bsd,dv->bsv", h, params["lm_head"])[:, 0]

    def loss(self, params, batch):
        """batch: tokens (b, s), labels (b, s) with -1 at masked positions.
        Returns (mean cross-entropy, {"ce", "aux" (0)}); each macro under
        the config's remat policy, the tail blocks not, as in the JAX
        package."""
        c = self.cfg
        labels = batch["labels"]
        x = self._embed(params, batch["tokens"])
        positions = torch.arange(x.shape[1], device=x.device)[None]
        if self.n_macro:
            macro = _remat(self._macro_train, c.remat_policy)
            for p in unstack(params["macros"]):
                x = macro(p, x, positions)
        for j in range(self.n_tail):
            x, _ = self._block(params[f"tail{j}"], x, positions,
                               c.block_pattern[j], mode="train")
        h = rms_norm(x, params["final_norm"], c.norm_eps)
        ce = softmax_xent_chunked(h, params["lm_head"], labels,
                                  (labels >= 0).float())
        return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32,
                                                 device=x.device)}

    @torch.inference_mode()
    def prefill(self, params, batch):
        """batch: {"tokens": (b, s)}. Returns (logits of the last position
        (b, vocab), cache): each rec layer's (h (b, w) float32, conv state
        (b, conv_width - 1, w)), each attention layer's (k, v) of the last
        min(window, s) positions (b, W, g, e), all in the activation dtype
        but h, stacked over macros as `cache_defs`; cur_len = s."""
        tokens = batch["tokens"]
        x = self._embed(params, tokens)
        b, seq = tokens.shape
        positions = torch.arange(seq, device=x.device)[None]
        cache = init_params(self.cache_defs(b, seq), 0, x.device)
        for key, m, name, t, p in self._layers(params):
            x, new = self._block(p, x, positions, t, mode="prefill")
            for buf, val in zip(self._layer_cache(cache, key, m, name), new):
                buf.copy_(val)
        cache["cur_len"].fill_(seq)
        return self._logits(params, x[:, -1:]), cache

    @torch.inference_mode()
    def decode_step(self, params, cache, tokens):
        """tokens: (b, 1). The cache's tensors are updated in place; the
        returned cache holds them with cur_len + 1."""
        cur = cache["cur_len"]
        x = self._embed(params, tokens)
        positions = cur.reshape(1, 1)
        for key, m, name, t, p in self._layers(params):
            x, _ = self._block(p, x, positions, t, mode="decode",
                               cache=self._layer_cache(cache, key, m, name),
                               cur_len=cur)
        new_cache = {k: v for k, v in cache.items() if k != "cur_len"}
        new_cache["cur_len"] = cur + 1
        return self._logits(params, x), new_cache
