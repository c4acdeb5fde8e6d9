"""TransformerLM: the dense, MoE, vlm and audio decoders (yi-6b/34b,
deepseek-7b, qwen3-8b's qk-norm, dbrx, pixtral's backbone, musicgen's
backbone) with grouped-query attention, and deepseek-v3 with multi-head
latent attention (MLA) and multi-token prediction (MTP).

The JAX package's ``TransformerLM`` with the same parameter tree (stacked
per-layer tensors under ``dense_layers`` and ``moe_layers``, JAX's weight
layouts and einsum strings), the same training loss (``loss``: the blocks
under the config's remat policy, the chunked cross-entropy, the router's
auxiliary loss, with MTP 0.1 x the t+2 cross-entropy) and the same
serving entry points: ``prefill`` fills a KV cache with a 64-position
decode margin, ``decode_step`` extends it by one token. A GQA layer caches
(k, v), an MLA layer its latent ckv and roped k_pe. The JAX ``lax.scan``
over each group's stacked layers is a Python loop over the layer index.
The vlm family prepends projected patch embeddings (a stub ViT's output)
to the text; the audio family sums one embedding a codebook and predicts
every codebook. With ``window_size`` the attention is a causal sliding
window (``attention.local_attention``) and a prompt longer than the window
keeps only its last ``window_size`` positions in a rotating cache, as the
JAX package does (see ``prefill``). The hybrid and ssm families are
``models/recurrent.py`` and ``models/xlstm.py``.
"""
from __future__ import annotations

import functools
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.common import cache_cast, dtype_of, einsum, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import embedding as embed_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (apply_rope, rms_norm,
                                      softmax_xent_chunked, swiglu)
from repro_torch.models.params import (ParamDef, init_params, pdef, stack_defs,
                                      unstack)

VIT_DIM = 1024  # pixtral ViT stub output width
GROUPS = (("dense_layers", False), ("moe_layers", True))


def _save_dots_without_batch_dims(ctx, op, *args, **kwargs):
    """JAX's ``dots_with_no_batch_dims_saveable``: keep the outputs of the
    weight products (``mm``, and the one-batch ``bmm`` that ``einsum``
    lowers them to), recompute the rest."""
    if op == torch.ops.aten.mm.default or (
            op == torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def cache_slot(cur_len, S: int, window: int = 0):
    """The cache slot a decode step at position `cur_len` (0-dim int
    tensor) writes, on the device: cur_len % window in a rotating cache
    of S == window slots, else min(cur_len, S - 1), the index JAX's
    ``dynamic_update_slice`` clamps to."""
    if window and S == window:
        return torch.remainder(cur_len, window)
    return torch.clamp(cur_len, max=S - 1)


def _cache_write(buf, slot, t):
    """buf[:, slot] = t in buf's dtype (`cache_cast`), written by
    ``index_copy_`` at the device-side `slot` (`cache_slot`), so decode
    never waits for the host. buf: one layer's (b, S, ...) cache view; t:
    (b, 1, ...). A float8 cache is written through its bytes
    (``index_copy_`` has no float8 CPU kernel)."""
    idx = slot.reshape(1).long()
    t = cache_cast(t, buf.dtype)
    if buf.dtype == torch.float8_e4m3fn:
        buf, t = buf.view(torch.uint8), t.view(torch.uint8)
    buf.index_copy_(1, idx, t)


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
    ``params_from_numpy``. `device` is where it makes positions and caches.
    `mesh` and `rules` (``launch.mesh.Mesh``, ``sharding.Rules``) reach
    the embedding: with ``embedding_impl="mapsin"`` the lookup runs
    vocab-sharded over the mesh's `model` axis. The JAX model's
    ``_constrain`` (``with_sharding_constraint``) has no counterpart: it
    places values and changes none."""

    def __init__(self, cfg: ModelConfig, device="cuda", mesh=None, rules=None):
        super().__init__()
        if cfg.family not in ("dense", "moe", "vlm", "audio"):
            raise ValueError(f"{cfg.name}: TransformerLM runs the dense, MoE, "
                             f"vlm and audio families, not {cfg.family!r} "
                             f"(models.build_model picks the model)")
        self.cfg = cfg
        self.device = resolve_device(device, "TransformerLM")
        self.mesh, self.rules = mesh, rules
        self.adt = dtype_of(cfg.activation_dtype)

    # ------------------------------------------------------------------
    # Parameter definitions
    # ------------------------------------------------------------------
    def _attn_defs(self) -> dict[str, ParamDef]:
        c = self.cfg
        d, h, g, e = c.d_model, c.num_heads, c.num_kv_heads, c.resolved_head_dim
        pd = c.param_dtype
        if c.use_mla:
            dn, dr, dv = c.qk_nope_head_dim, c.qk_rope_head_dim, c.v_head_dim
            return {
                "norm": pdef((d,), ("embed",), pd, "ones"),
                "q_a": pdef((d, c.q_lora_rank), ("fsdp", "q_lora"), pd),
                "q_norm": pdef((c.q_lora_rank,), ("q_lora",), pd, "ones"),
                "q_b": pdef((c.q_lora_rank, h, dn + dr), ("q_lora", "heads", None), pd),
                "kv_a": pdef((d, c.kv_lora_rank + dr), ("fsdp", None), pd),
                "kv_norm": pdef((c.kv_lora_rank,), ("kv_lora",), pd, "ones"),
                "kv_b_k": pdef((c.kv_lora_rank, h, dn), ("kv_lora", "heads", None), pd),
                "kv_b_v": pdef((c.kv_lora_rank, h, dv), ("kv_lora", "heads", None), pd),
                "wo": pdef((h, dv, d), ("heads", None, "fsdp"), pd),
            }
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

    def _moe_defs(self) -> dict[str, ParamDef]:
        c = self.cfg
        d, pd = c.d_model, c.param_dtype
        e, f = c.num_experts, c.moe_d_ff
        out = {
            "norm": pdef((d,), ("embed",), pd, "ones"),
            "router": pdef((d, e), ("embed", "experts"), "float32"),
            "w_gate": pdef((e, d, f), ("experts", "fsdp", "mlp"), pd),
            "w_up": pdef((e, d, f), ("experts", "fsdp", "mlp"), pd),
            "w_down": pdef((e, f, d), ("experts", "mlp", "fsdp"), pd),
        }
        if c.num_shared_experts:
            fs = f * c.num_shared_experts
            out["shared_w_gate"] = pdef((d, fs), ("fsdp", "mlp"), pd)
            out["shared_w_up"] = pdef((d, fs), ("fsdp", "mlp"), pd)
            out["shared_w_down"] = pdef((fs, d), ("mlp", "fsdp"), pd)
        return out

    def _block_defs(self, moe: bool) -> dict[str, Any]:
        mix = self._moe_defs() if moe else self._mlp_defs(self.cfg.dense_d_ff or self.cfg.d_ff)
        return {"attn": self._attn_defs(), "mlp": mix}

    def _group_sizes(self) -> dict[str, int]:
        """Layers in each group: the leading dense layers of a MoE model
        (all of a dense one's), then its MoE layers."""
        c = self.cfg
        n_dense = c.first_dense_layers if c.num_experts else c.num_layers
        return {"dense_layers": n_dense, "moe_layers": c.num_layers - n_dense}

    def param_defs(self) -> dict[str, Any]:
        c = self.cfg
        d, v, pd = c.d_model, c.vocab_size, c.param_dtype
        defs: dict[str, Any] = {}
        if c.family == "audio":
            defs["embed"] = pdef((c.num_codebooks, v, d), ("stack", "vocab", "fsdp"), pd)
        else:
            defs["embed"] = pdef((v, d), ("vocab", "fsdp"), pd)
        if c.family == "vlm":
            defs["patch_proj"] = pdef((VIT_DIM, d), ("embed", "fsdp"), pd)
        sizes = self._group_sizes()
        for group, moe in GROUPS:
            if sizes[group]:
                defs[group] = stack_defs(self._block_defs(moe), sizes[group])
        defs["final_norm"] = pdef((d,), ("embed",), pd, "ones")
        if c.family == "audio":
            defs["lm_head"] = pdef((c.num_codebooks, d, v), ("stack", "embed", "vocab"), pd)
        elif not c.tie_embeddings:
            defs["lm_head"] = pdef((d, v), ("embed", "vocab"), pd)
        if c.mtp_depth:
            defs["mtp"] = {
                "norm1": pdef((d,), ("embed",), pd, "ones"),
                "norm2": pdef((d,), ("embed",), pd, "ones"),
                "proj": pdef((2 * d, d), ("fsdp", "embed"), pd),
                "block": self._block_defs(bool(c.num_experts)),
            }
        return defs

    def init_params(self, seed: int = 0) -> dict[str, Any]:
        return init_params(self.param_defs(), seed, self.device)

    # ------------------------------------------------------------------
    # Blocks
    # ------------------------------------------------------------------
    def _gqa_attention(self, p, x, positions, *, mode, cache=None,
                       cur_len=None):
        """mode "prefill": attention over the prompt through the flash
        kernel (``local_attention`` with a window), returning this layer's
        (k, v). mode "decode": writes the new (k, v) into `cache` (this
        layer's (b, S, g, e) views of the stacked cache) in place at
        `cache_slot` (`_cache_write`) and attends over the cache."""
        c = self.cfg
        eps = c.norm_eps
        xs = rms_norm(x, p["norm"], eps)
        q = einsum("bsd,dhe->bshe", xs, p["wq"])
        k = einsum("bsd,dge->bsge", xs, p["wk"])
        v = einsum("bsd,dge->bsge", xs, p["wv"])
        if c.qk_norm:
            q = rms_norm(q, p["qn"], eps)
            k = rms_norm(k, p["kn"], eps)
        q = apply_rope(q, positions, c.rope_theta)
        k = apply_rope(k, positions, c.rope_theta)
        new_kv = None
        if mode == "decode":
            kc, vc = cache
            slot = cache_slot(cur_len, kc.shape[1], c.window_size)
            _cache_write(kc, slot, k)
            _cache_write(vc, slot, v)
            o = attn_lib.decode_attention(q, kc.to(self.adt), vc.to(self.adt),
                                          cur_len + 1, window=c.window_size)
        else:
            o = attn_lib.attention(q, k, v, impl=c.attention_impl, causal=True,
                                   window=c.window_size, block_q=c.attn_block_q)
            if mode == "prefill":
                new_kv = (k, v)
        out = einsum("bshe,hed->bsd", o, p["wo"])
        return x + out, new_kv

    def _mla_attention(self, p, x, positions, *, mode, cache=None,
                       cur_len=None):
        """Multi-head latent attention. q comes through the q_lora
        bottleneck; keys and values through the kv_lora latent ckv, beside
        a roped k_pe of qk_rope_head_dim that every head shares; the scale
        is (dn + dr) ** -0.5. mode "prefill" (and "train"): blockwise
        attention up-projecting the latent one kv block at a time,
        returning this layer's (ckv, k_pe). mode "decode": writes them into
        `cache` ((b, S, c) and (b, S, dr) views) as ``_gqa_attention``
        does and attends in the latent space (the absorbed decode)."""
        c = self.cfg
        eps = c.norm_eps
        dn, dr = c.qk_nope_head_dim, c.qk_rope_head_dim
        xs = rms_norm(x, p["norm"], eps)
        cq = rms_norm(einsum("bsd,dq->bsq", xs, p["q_a"]), p["q_norm"], eps)
        q = einsum("bsq,qhe->bshe", cq, p["q_b"])
        q_nope, q_pe = q[..., :dn], q[..., dn:]
        q_pe = apply_rope(q_pe, positions, c.rope_theta)
        kv = einsum("bsd,dk->bsk", xs, p["kv_a"])
        ckv, k_pe = kv[..., :c.kv_lora_rank], kv[..., c.kv_lora_rank:]
        ckv = rms_norm(ckv, p["kv_norm"], eps)
        k_pe = apply_rope(k_pe[:, :, None, :], positions, c.rope_theta)[:, :, 0]
        scale = (dn + dr) ** -0.5
        new_kv = None
        if mode == "decode":
            ckv_c, kpe_c = cache
            slot = cache_slot(cur_len, ckv_c.shape[1])
            _cache_write(ckv_c, slot, ckv)
            _cache_write(kpe_c, slot, k_pe)
            o = attn_lib.mla_absorbed_decode(
                q_nope[:, 0], q_pe[:, 0], ckv_c.to(self.adt),
                kpe_c.to(self.adt), p["kv_b_k"], p["kv_b_v"], cur_len + 1,
                scale=scale)[:, None]                     # (b, 1, h, dv)
        else:
            o = attn_lib.mla_prefill_attention(
                torch.cat([q_nope, q_pe], dim=-1), ckv, k_pe, p["kv_b_k"],
                p["kv_b_v"], scale=scale, block_q=c.attn_block_q,
                block_kv=c.attn_block_kv)
            if mode == "prefill":
                new_kv = (ckv, k_pe)
        out = einsum("bshv,hvd->bsd", o, p["wo"])
        return x + out, new_kv

    def _ffn(self, p, x, moe: bool):
        """The feed-forward half of a block: (x + ffn, the router's aux
        loss, 0 for a dense layer)."""
        c = self.cfg
        xs = rms_norm(x, p["norm"], c.norm_eps)
        if moe:
            b, s, d = xs.shape
            y, aux, _ = moe_lib.moe_ffn(xs.reshape(b * s, d), p, top_k=c.top_k,
                                        num_experts=c.num_experts,
                                        capacity_factor=c.capacity_factor)
            return x + y.reshape(b, s, d), aux
        return (x + swiglu(xs, p["w_gate"], p["w_up"], p["w_down"]),
                torch.zeros((), dtype=torch.float32, device=x.device))

    def _block(self, p, x, positions, moe: bool, *, mode, cache=None,
               cur_len=None):
        mix = self._mla_attention if self.cfg.use_mla else self._gqa_attention
        x, new_kv = mix(p["attn"], x, positions, mode=mode, cache=cache,
                        cur_len=cur_len)
        x, aux = self._ffn(p["mlp"], x, moe)
        return x, new_kv, aux

    def _groups(self, params):
        """(group, moe) of each layer group the parameters hold, in order."""
        return [(group, moe) for group, moe in GROUPS if group in params]

    def _layers(self, params, group: str):
        """(index, parameters) of each layer in `group` (`unstack`)."""
        return enumerate(unstack(params[group]))

    # ------------------------------------------------------------------
    # Embedding / head
    # ------------------------------------------------------------------
    def _embed_tokens(self, params, tokens):
        c = self.cfg
        if c.family == "audio":
            # tokens: (b, s, K): the codebooks' embeddings summed in order
            # in the table's dtype, as the reference's reduce(jnp.add)
            out = self._embed(params["embed"][0], tokens[..., 0])
            for k in range(1, c.num_codebooks):
                out = out + self._embed(params["embed"][k], tokens[..., k])
            return out.to(self.adt)
        return self._embed(params["embed"], tokens).to(self.adt)

    def _embed(self, table, tokens):
        return embed_lib.embed(table, tokens, self.cfg.embedding_impl,
                               self.mesh, self.rules)

    def _embed_inputs(self, params, batch):
        """(x, n_prefix): the token embeddings, behind the projected patch
        embeddings for the vlm family (n_prefix of them)."""
        x = self._embed_tokens(params, batch["tokens"])
        if self.cfg.family != "vlm":
            return x, 0
        patches = einsum("bpv,vd->bpd",
                         batch["patch_embeds"].to(self.adt),
                         params["patch_proj"]).to(self.adt)
        return torch.cat([patches, x], dim=1), patches.shape[1]

    def _head_w(self, params):
        if self.cfg.tie_embeddings:
            return params["embed"].T
        return params["lm_head"]

    def _last_logits(self, params, h):
        """(b, vocab), or (b, K, vocab) for the audio family."""
        if self.cfg.family == "audio":
            return einsum("bsd,kdv->bskv", h, params["lm_head"])[:, 0]
        return einsum("bsd,dv->bsv", h, self._head_w(params))[:, 0]

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------
    def loss(self, params, batch):
        """batch: tokens (b, s[, K]), labels (b, s[, K]) with -1 at masked
        positions, and patch_embeds (b, num_patches, VIT_DIM) for the vlm
        family. Returns (loss, {"ce", "aux"[, "mtp_ce"]}): the mean
        cross-entropy over unmasked positions (the text positions for vlm,
        the mean over the codebooks for audio) plus router_aux_weight * aux,
        the router losses summed over the MoE layers (0 without experts),
        plus 0.1 * mtp_ce with multi-token prediction (`_mtp_loss`)."""
        c = self.cfg
        labels = batch["labels"]
        x, n_prefix = self._embed_inputs(params, batch)
        positions = torch.arange(x.shape[1], device=x.device)[None]
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for group, moe in self._groups(params):
            block = _remat(functools.partial(self._block, moe=moe, mode="train"),
                           c.remat_policy)
            for _, p in self._layers(params, group):
                x, _, a = block(p, x, positions)
                aux = aux + a
        h = rms_norm(x, params["final_norm"], c.norm_eps)
        if n_prefix:
            h = h[:, n_prefix:]
        mask = (labels >= 0).float()
        if c.family == "audio":
            tot = torch.zeros((), dtype=torch.float32, device=x.device)
            for k in range(c.num_codebooks):
                tot = tot + softmax_xent_chunked(h, params["lm_head"][k],
                                                 labels[..., k], mask[..., k])
            ce = tot / c.num_codebooks
        else:
            ce = softmax_xent_chunked(h, self._head_w(params), labels, mask)
        metrics = {"ce": ce, "aux": aux}
        loss = ce + c.router_aux_weight * aux
        if c.mtp_depth:
            mtp_ce = self._mtp_loss(params, x, batch["tokens"], labels)
            metrics["mtp_ce"] = mtp_ce
            loss = loss + 0.1 * mtp_ce
        return loss, metrics

    def _mtp_loss(self, params, hidden, tokens, labels):
        """DeepSeek-V3 multi-token prediction (depth 1): predict token t+2
        from the trunk's h_t (before ``final_norm``) joined with the
        embedding of token t+1, through one more block (not under remat,
        its router loss dropped), ``final_norm`` and the shared head."""
        c = self.cfg
        p = params["mtp"]
        h = rms_norm(hidden[:, :-1], p["norm1"], c.norm_eps)
        e = rms_norm(self._embed_tokens(params, tokens[:, 1:]), p["norm2"],
                     c.norm_eps)
        x = einsum("bsd,dk->bsk", torch.cat([h, e], dim=-1), p["proj"])
        positions = torch.arange(x.shape[1], device=x.device)[None]
        x, _, _ = self._block(p["block"], x, positions, bool(c.num_experts),
                              mode="train")
        hh = rms_norm(x, params["final_norm"], c.norm_eps)
        lab = labels[:, 1:]      # labels are the t+1 targets: shift once more
        return softmax_xent_chunked(hh, self._head_w(params), lab,
                                    (lab >= 0).float())

    # ------------------------------------------------------------------
    # Serving
    # ------------------------------------------------------------------
    def cache_defs(self, batch: int, seq_len: int) -> dict[str, Any]:
        """A cache of seq_len slots, or of window_size where the window is
        shorter (the rotating cache)."""
        w = self.cfg.window_size
        return self._cache_defs(batch, min(seq_len, w) if w else seq_len)

    def _cache_defs(self, batch: int, S: int) -> dict[str, Any]:
        c = self.cfg
        dt = c.kv_cache_dtype
        if c.use_mla:
            per = (pdef((batch, S, c.kv_lora_rank), ("batch", "seq_kv", "kv_lora"), dt, "zeros"),
                   pdef((batch, S, c.qk_rope_head_dim), ("batch", "seq_kv", "rope"), dt, "zeros"))
        else:
            g, e = c.num_kv_heads, c.resolved_head_dim
            per = (pdef((batch, S, g, e), ("batch", None, "kv_heads", "head_dim"), dt, "zeros"),
                   pdef((batch, S, g, e), ("batch", None, "kv_heads", "head_dim"), dt, "zeros"))
        defs: dict[str, Any] = {group: stack_defs(per, n) for group, n
                                in self._group_sizes().items() if n}
        defs["cur_len"] = pdef((), (), "int32", "zeros")
        return defs

    @torch.inference_mode()
    def prefill(self, params, batch, margin: int = 64):
        """batch: {"tokens": (b, s) int, or (b, s, K) for audio} and, for
        vlm, "patch_embeds" (b, num_patches, VIT_DIM). Returns (logits of
        the last position, (b, vocab) or (b, K, vocab) for audio, cache):
        the cache holds each group's pair stacked over its layers in
        ``kv_cache_dtype`` (`cache_cast`): (k, v), each (L, b, n + margin,
        g, e), or MLA's (ckv, k_pe), (L, b, n + margin, kv_lora_rank) and
        (L, b, n + margin, qk_rope_head_dim); n is the prompt's positions
        (patches included; the margin is decode headroom: without it the
        first generated token's kv would overwrite the last prompt
        position), and cur_len = n as a 0-dim int32 tensor.

        With a window shorter than n the cache is the last window_size
        positions, in slots 0... (no margin), and decode writes slot
        cur_len % window_size: the JAX package's rotating cache. It
        agrees with a longer prefill only where n is a multiple of the
        window (otherwise decode evicts a position other than the
        oldest); a shorter prompt keeps n + margin slots and attends to
        the slots below window_size (ROADMAP, known behaviour 14)."""
        x, _ = self._embed_inputs(params, batch)
        b, seq = x.shape[:2]
        positions = torch.arange(seq, device=x.device)[None]
        w = self.cfg.window_size
        keep = w if w and w < seq else seq
        cache = init_params(self._cache_defs(b, keep if keep < seq else seq + margin),
                            0, x.device)
        for group, moe in self._groups(params):
            for i, p in self._layers(params, group):
                x, kv, _ = self._block(p, x, positions, moe, mode="prefill")
                for buf, t in zip(cache[group], kv):
                    buf[i, :, :keep] = cache_cast(t[:, seq - keep:], buf.dtype)
        h = rms_norm(x[:, -1:], params["final_norm"], self.cfg.norm_eps)
        cache["cur_len"].fill_(seq)
        return self._last_logits(params, h), cache

    @torch.inference_mode()
    def decode_step(self, params, cache, tokens):
        """tokens: (b, 1), or (b, 1, K) for audio — one new token given an
        existing cache. The cache's tensors are updated in place (no copy
        of the whole cache per step); the returned cache holds them with
        cur_len + 1."""
        cur = cache["cur_len"]
        x = self._embed_tokens(params, tokens)
        positions = cur.reshape(1, 1)
        new_cache: dict[str, Any] = {"cur_len": cur + 1}
        for group, moe in self._groups(params):
            pair = cache[group]
            for i, p in self._layers(params, group):
                x, _, _ = self._block(p, x, positions, moe, mode="decode",
                                      cache=tuple(t[i] for t in pair),
                                      cur_len=cur)
            new_cache[group] = pair
        h = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        return self._last_logits(params, h), new_cache
