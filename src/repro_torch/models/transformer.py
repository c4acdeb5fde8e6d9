"""TransformerLM: the dense decoder with grouped-query attention (yi-6b).

The JAX package's ``TransformerLM`` with the same parameter tree (stacked
per-layer tensors under ``dense_layers``, JAX's weight layouts and einsum
strings), the same training loss (``loss``: the blocks under the config's
remat policy, the chunked cross-entropy) and the same serving entry
points: ``prefill`` fills a KV cache with a 64-position decode margin,
``decode_step`` extends it by one token. The JAX ``lax.scan`` over the
stacked layers is a Python loop over the layer index. The MoE, MLA, vlm,
audio and multi-token-prediction variants belong to later slices and
raise ``NotImplementedError``.
"""
from __future__ import annotations

import functools
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.common import (dtype_of, resolve_device, tree_map_with_path,
                                tree_paths)
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import embedding as embed_lib
from repro_torch.models.layers import (apply_rope, rms_norm,
                                      softmax_xent_chunked, swiglu)
from repro_torch.models.params import ParamDef, init_params, pdef, stack_defs


def _save_dots_without_batch_dims(ctx, op, *args, **kwargs):
    """JAX's ``dots_with_no_batch_dims_saveable``: keep the outputs of the
    weight products (``mm``, and the one-batch ``bmm`` that ``einsum``
    lowers them to), recompute the rest."""
    if op == torch.ops.aten.mm.default or (
            op == torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, policy: str):
    """`fn` under the JAX package's remat policy. "names" saves only the
    layer input (the JAX package names it "layer_in"), which is what a
    checkpoint of the block keeps, its inputs: so here it is "full". The
    blocks draw no random numbers, so no RNG state is stashed."""
    if policy == "none":
        return fn
    kw = {}
    if policy == "minimal":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots_without_batch_dims)
    return functools.partial(checkpoint, fn, use_reentrant=False,
                             preserve_rng_state=False, **kw)


class TransformerLM(nn.Module):
    """Stateless: methods take the parameter tree (as the JAX model does),
    so one module serves weights made by ``init_params`` or carried over by
    ``params_from_numpy``. `device` is where it makes positions and caches."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        unported = [name for name, on in (
            (f"family {cfg.family!r}", cfg.family != "dense"),
            ("MLA", cfg.use_mla), ("MoE", bool(cfg.num_experts)),
            ("multi-token prediction", bool(cfg.mtp_depth)),
            ("sliding-window attention", bool(cfg.window_size))) if on]
        if unported:
            raise NotImplementedError(
                f"{cfg.name}: {', '.join(unported)} is not ported yet; this "
                f"package runs the dense GQA decoder only")
        self.cfg = cfg
        self.device = resolve_device(device, "TransformerLM")
        self.adt = dtype_of(cfg.activation_dtype)

    # ------------------------------------------------------------------
    # Parameter definitions
    # ------------------------------------------------------------------
    def _attn_defs(self) -> dict[str, ParamDef]:
        c = self.cfg
        d, h, g, e = c.d_model, c.num_heads, c.num_kv_heads, c.resolved_head_dim
        pd = c.param_dtype
        out = {
            "norm": pdef((d,), ("embed",), pd, "ones"),
            "wq": pdef((d, h, e), ("fsdp", "heads", "head_dim"), pd),
            "wk": pdef((d, g, e), ("fsdp", "kv_heads", "head_dim"), pd),
            "wv": pdef((d, g, e), ("fsdp", "kv_heads", "head_dim"), pd),
            "wo": pdef((h, e, d), ("heads", "head_dim", "fsdp"), pd),
        }
        if c.qk_norm:
            out["qn"] = pdef((e,), ("head_dim",), pd, "ones")
            out["kn"] = pdef((e,), ("head_dim",), pd, "ones")
        return out

    def _mlp_defs(self, d_ff: int) -> dict[str, ParamDef]:
        c = self.cfg
        d, pd = c.d_model, c.param_dtype
        return {
            "norm": pdef((d,), ("embed",), pd, "ones"),
            "w_gate": pdef((d, d_ff), ("fsdp", "mlp"), pd),
            "w_up": pdef((d, d_ff), ("fsdp", "mlp"), pd),
            "w_down": pdef((d_ff, d), ("mlp", "fsdp"), pd),
        }

    def param_defs(self) -> dict[str, Any]:
        c = self.cfg
        d, v, pd = c.d_model, c.vocab_size, c.param_dtype
        block = {"attn": self._attn_defs(),
                 "mlp": self._mlp_defs(c.dense_d_ff or c.d_ff)}
        defs: dict[str, Any] = {
            "embed": pdef((v, d), ("vocab", "fsdp"), pd),
            "dense_layers": stack_defs(block, c.num_layers),
            "final_norm": pdef((d,), ("embed",), pd, "ones"),
        }
        if not c.tie_embeddings:
            defs["lm_head"] = pdef((d, v), ("embed", "vocab"), pd)
        return defs

    def init_params(self, seed: int = 0) -> dict[str, Any]:
        return init_params(self.param_defs(), seed, self.device)

    # ------------------------------------------------------------------
    # Blocks
    # ------------------------------------------------------------------
    def _gqa_attention(self, p, x, positions, *, mode, cache=None,
                       cur_len=None):
        """mode "prefill": attention over the prompt through the flash
        kernel, returning this layer's (k, v). mode "decode": writes the new
        (k, v) into `cache` (this layer's (b, S, g, e) views of the stacked
        cache) in place at min(cur_len, S - 1), the index that JAX's
        ``dynamic_update_slice`` clamps to, with ``index_copy_`` on the
        device-side index, and attends over the cache."""
        c = self.cfg
        eps = c.norm_eps
        xs = rms_norm(x, p["norm"], eps)
        q = torch.einsum("bsd,dhe->bshe", xs, p["wq"])
        k = torch.einsum("bsd,dge->bsge", xs, p["wk"])
        v = torch.einsum("bsd,dge->bsge", xs, p["wv"])
        if c.qk_norm:
            q = rms_norm(q, p["qn"], eps)
            k = rms_norm(k, p["kn"], eps)
        q = apply_rope(q, positions, c.rope_theta)
        k = apply_rope(k, positions, c.rope_theta)
        new_kv = None
        if mode == "decode":
            kc, vc = cache
            idx = torch.clamp(cur_len, max=kc.shape[1] - 1).reshape(1).long()
            kc.index_copy_(1, idx, k.to(kc.dtype))
            vc.index_copy_(1, idx, v.to(vc.dtype))
            o = attn_lib.decode_attention(q, kc.to(self.adt), vc.to(self.adt),
                                          cur_len + 1)
        else:
            o = attn_lib.attention(q, k, v,
                                   impl=c.attention_impl, causal=True)
            if mode == "prefill":
                new_kv = (k, v)
        out = torch.einsum("bshe,hed->bsd", o, p["wo"])
        return x + out, new_kv

    def _ffn(self, p, x):
        xs = rms_norm(x, p["norm"], self.cfg.norm_eps)
        return x + swiglu(xs, p["w_gate"], p["w_up"], p["w_down"])

    def _block(self, p, x, positions, *, mode, cache=None, cur_len=None):
        x, new_kv = self._gqa_attention(p["attn"], x, positions, mode=mode,
                                        cache=cache, cur_len=cur_len)
        return self._ffn(p["mlp"], x), new_kv

    def _layers(self, params):
        """Each layer's parameters, taken with one ``unbind(0)`` a stacked
        leaf: its backward writes the leaf's gradient once, where one
        ``t[i]`` a layer would write a zeroed whole-leaf gradient a layer."""
        stacked = params["dense_layers"]
        parts = {path: t.unbind(0) for path, t in tree_paths(stacked)}
        for i in range(self.cfg.num_layers):
            yield i, tree_map_with_path(lambda path, _: parts[path][i], stacked)

    # ------------------------------------------------------------------
    # Embedding / head
    # ------------------------------------------------------------------
    def _embed_tokens(self, params, tokens):
        return embed_lib.embed(params["embed"], tokens,
                               self.cfg.embedding_impl).to(self.adt)

    def _head_w(self, params):
        if self.cfg.tie_embeddings:
            return params["embed"].T
        return params["lm_head"]

    def _last_logits(self, params, h):
        return torch.einsum("bsd,dv->bsv", h, self._head_w(params))[:, 0]

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------
    def loss(self, params, batch):
        """batch: tokens (b, s), labels (b, s) with -1 at masked positions.
        Returns (loss, {"ce", "aux"}): the mean cross-entropy over unmasked
        positions plus router_aux_weight * aux (0 for the dense model)."""
        c = self.cfg
        tokens, labels = batch["tokens"], batch["labels"]
        x = self._embed_tokens(params, tokens)
        positions = torch.arange(x.shape[1], device=x.device)[None]
        block = _remat(functools.partial(self._block, mode="train"),
                       c.remat_policy)
        for _, p in self._layers(params):
            x, _ = block(p, x, positions)
        h = rms_norm(x, params["final_norm"], c.norm_eps)
        mask = (labels >= 0).float()
        ce = softmax_xent_chunked(h, self._head_w(params), labels, mask)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return ce + c.router_aux_weight * aux, {"ce": ce, "aux": aux}

    # ------------------------------------------------------------------
    # Serving
    # ------------------------------------------------------------------
    def cache_defs(self, batch: int, seq_len: int) -> dict[str, Any]:
        c = self.cfg
        dt = c.kv_cache_dtype
        g, e = c.num_kv_heads, c.resolved_head_dim
        per = (pdef((batch, seq_len, g, e), ("batch", None, "kv_heads", "head_dim"), dt, "zeros"),
               pdef((batch, seq_len, g, e), ("batch", None, "kv_heads", "head_dim"), dt, "zeros"))
        return {"dense_layers": stack_defs(per, c.num_layers),
                "cur_len": pdef((), (), "int32", "zeros")}

    @torch.inference_mode()
    def prefill(self, params, batch, margin: int = 64):
        """batch: {"tokens": (b, s) int}. Returns (logits (b, vocab) of the
        last position, cache): the cache holds (k, v) stacked over layers,
        (L, b, s + margin, g, e) in ``kv_cache_dtype`` (the margin is decode
        headroom: without it the first generated token's kv would overwrite
        the last prompt position), and cur_len = s as a 0-dim int32 tensor."""
        tokens = batch["tokens"]
        b, seq = tokens.shape
        x = self._embed_tokens(params, tokens)
        positions = torch.arange(seq, device=x.device)[None]
        cache = init_params(self.cache_defs(b, seq + margin), 0, x.device)
        kc, vc = cache["dense_layers"]
        for i, p in self._layers(params):
            x, (k, v) = self._block(p, x, positions, mode="prefill")
            kc[i, :, :seq] = k
            vc[i, :, :seq] = v
        h = rms_norm(x[:, -1:], params["final_norm"], self.cfg.norm_eps)
        cache["cur_len"].fill_(seq)
        return self._last_logits(params, h), cache

    @torch.inference_mode()
    def decode_step(self, params, cache, tokens):
        """tokens: (b, 1) — one new token given an existing cache. The
        cache's tensors are updated in place (no copy of the whole cache per
        step); the returned cache holds them with cur_len + 1."""
        cur = cache["cur_len"]
        x = self._embed_tokens(params, tokens)
        positions = cur.reshape(1, 1)
        kc, vc = cache["dense_layers"]
        for i, p in self._layers(params):
            x, _ = self._block(p, x, positions, mode="decode",
                               cache=(kc[i], vc[i]), cur_len=cur)
        h = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        return self._last_logits(params, h), {"dense_layers": (kc, vc),
                                              "cur_len": cur + 1}
