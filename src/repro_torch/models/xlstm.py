"""xLSTM (arXiv:2405.04517): mLSTM (matrix memory) and sLSTM (scalar
memory) blocks.

The JAX package's ``XLSTMLM`` with the same parameter and cache trees
(``layer{i}`` each, sLSTM at ``slstm_at``), weight layouts and dtypes
(the gate weights ``w_if``, ``b_i``, ``b_f`` and the sLSTM's ``W``, ``R``,
``b`` are float32), and the same entry points. The mLSTM runs chunkwise
(`mlstm_chunkwise`: the stabilised quadratic form within a chunk, the
matrix state (C, n, m) across chunks, a loop over chunks where the JAX
package scans); the sLSTM is sequential by definition (`slstm_seq`: a loop
over time, as the JAX package's ``lax.scan``). Decode is one recurrent
step of each cell. The head is tied to the embedding.

On ``meta`` tensors (no values: the dry-run's count) both loops run their
middle steps as one batch (`_steps_on_meta`), so that a 32k-token
sequence counts in one dispatch of each op, not one a step.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.common import dtype_of, einsum, matmul, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import embedding as embed_lib
from repro_torch.models.layers import (causal_conv1d, geglu, rms_norm,
                                      softmax_xent_chunked)
from repro_torch.models.params import init_params, pdef

CHUNK = 64
M_INIT = -1e30   # the stabiliser m of an empty state


# ---------------------------------------------------------------------------
# mLSTM cell: chunkwise-parallel form with exponential-gating stabilisation
# ---------------------------------------------------------------------------

def mlstm_chunkwise(q, k, v, log_i, log_f, state=None, chunk=CHUNK):
    """q, k, v: (b, s, h, e) float32; log_i, log_f: (b, s, h) float32.

    Returns (out (b, s, h, e), (C, n, m)), the state stabilised (the true
    C is C * exp(m)): C (b, h, e, e), n (b, h, e), m (b, h). A sequence
    that is not a whole number of chunks is padded with log_i = -30 (keys
    that add nothing to within float32) and log_f = 0."""
    b, s, h, e = q.shape
    q = q * e ** -0.5
    pad = (-s) % chunk
    if pad:
        q, k, v = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (q, k, v))
        log_i = F.pad(log_i, (0, 0, 0, pad), value=-30.0)
        log_f = F.pad(log_f, (0, 0, 0, pad))
    L = chunk
    if state is None:
        C = q.new_zeros((b, h, e, e))
        n = q.new_zeros((b, h, e))
        m = q.new_full((b, h), M_INIT)
    else:
        C, n, m = state
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    n_chunks = q.shape[1] // L
    if q.device.type == "meta" and n_chunks > 2:
        out, state = _steps_on_meta(
            lambda xs, st: _mlstm_chunk(*xs, *st, tri),
            (q, k, v, log_i, log_f), (C, n, m), n_chunks)
        return out[:, :s], state
    outs = []
    for j in range(n_chunks):
        sl = slice(j * L, (j + 1) * L)
        out, (C, n, m) = _mlstm_chunk(q[:, sl], k[:, sl], v[:, sl],
                                      log_i[:, sl], log_f[:, sl], C, n, m, tri)
        outs.append(out)
    return torch.cat(outs, dim=1)[:, :s], (C, n, m)


def _mlstm_chunk(qj, kj, vj, li, lf, C, n, m, tri):
    """One chunk of `mlstm_chunkwise` from the state (C, n, m) before it:
    (out (b, L, h, e), the state after it)."""
    lc = torch.cumsum(lf, dim=1)                      # inclusive decay to t
    Ft = lc[:, -1]                                    # (b, h) total decay
    # intra-chunk log weights D[t, s] = lc_t - lc_s + li_s (s <= t)
    D = lc[:, :, None, :] - lc[:, None, :, :] + li[:, None, :, :]
    D = torch.where(tri[None, :, :, None], D, M_INIT)  # (b, t, s, h)
    b_inter = lc + m[:, None, :]                      # (b, t, h)
    m_t = torch.maximum(D.amax(dim=2), b_inter)       # (b, t, h)
    w_intra = torch.exp(D - m_t[:, :, None, :])
    w_inter = torch.exp(b_inter - m_t)
    scores = einsum("bthe,bshe->btsh", qj, kj) * w_intra
    num = einsum("btsh,bshe->bthe", scores, vj)
    num = num + einsum("bthe,bhef->bthf", qj, C) * w_inter[..., None]
    den = scores.sum(dim=2)                           # (b, t, h)
    den = den + einsum("bthe,bhe->bth", qj, n) * w_inter
    out = num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None]
    # the state at the end of the chunk
    key_decay = Ft[:, None, :] - lc + li              # (b, s, h)
    m_new = torch.maximum(Ft + m, key_decay.amax(dim=1))
    kw = torch.exp(key_decay - m_new[:, None, :])     # (b, s, h)
    carry_w = torch.exp(Ft + m - m_new)               # (b, h)
    C = C * carry_w[..., None, None] + einsum(
        "bshe,bshf,bsh->bhef", kj, vj, kw)
    n = n * carry_w[..., None] + einsum("bshe,bsh->bhe", kj, kw)
    return out, (C, n, m_new)


def _steps_on_meta(step, xs, state, n):
    """`n` > 2 steps of ``step(xs_j, state) -> (out_j, state)`` on
    ``meta`` tensors, xs each (b, n * L, ...) and xs_j its j-th L-slice
    along dim 1; returns (the outs joined along dim 1, the last state).

    Step 0 runs from `state`, steps 1..n-2 as one step over (n - 2) * b
    rows from the state after step 0, step n-1 from the last of those
    rows. Every product has the shapes of the loop's, times the steps it
    stands for, and each step's input state takes part in the graph
    exactly as in the loop, so the forward and backward flops are the
    loop's."""
    L, b = xs[0].shape[1] // n, xs[0].shape[0]
    mid = n - 2
    first, state = step(tuple(x[:, :L] for x in xs), state)
    rows = tuple(t.expand(mid, *t.shape).reshape(mid * b, *t.shape[1:])
                 for t in state)
    middle, state = step(tuple(
        x[:, L:-L].reshape(b, mid, L, *x.shape[2:]).transpose(0, 1)
        .reshape(mid * b, L, *x.shape[2:]) for x in xs), rows)
    middle = middle.reshape(mid, b, *middle.shape[1:]).transpose(0, 1)
    last, state = step(tuple(x[:, -L:] for x in xs),
                       tuple(t[-b:] for t in state))
    return torch.cat([first, middle.reshape(b, mid * L, *middle.shape[3:]),
                      last], dim=1), state


def mlstm_decode(q, k, v, log_i, log_f, state):
    """One recurrent mLSTM step. q, k, v: (b, h, e); log_i, log_f: (b, h);
    state (C, n, m) as `mlstm_chunkwise` returns it."""
    C, n, m = state
    q = q * q.shape[-1] ** -0.5
    m_new = torch.maximum(log_f + m, log_i)
    i_w = torch.exp(log_i - m_new)
    f_w = torch.exp(log_f + m - m_new)
    C = C * f_w[..., None, None] + einsum("bhe,bhf,bh->bhef", k, v, i_w)
    n = n * f_w[..., None] + k * i_w[..., None]
    num = einsum("bhe,bhef->bhf", q, C)
    den = einsum("bhe,bhe->bh", q, n)
    out = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    return out, (C, n, m_new)


# ---------------------------------------------------------------------------
# sLSTM cell: sequential exponential-gated scalar memory
# ---------------------------------------------------------------------------

def slstm_step(x_t, h_prev, c_prev, n_prev, m_prev, p):
    """x_t: (b, 4, h, e) the input side's pre-activations of the gates i,
    f, z, o; the recurrent side is h_prev through the block-diagonal
    per-head p["R"] (4, h, e, e). Returns (h, c, n, m), each (b, h, e)."""
    z_t = x_t + einsum("bhe,ghef->bghf", h_prev, p["R"])
    i_t, f_t, z_in, o_in = z_t.unbind(1)
    m_new = torch.maximum(f_t + m_prev, i_t)
    i = torch.exp(i_t - m_new)
    f = torch.exp(f_t + m_prev - m_new)
    c = f * c_prev + i * torch.tanh(z_in)
    n = f * n_prev + i
    h = torch.sigmoid(o_in) * c / torch.clamp(n, min=1e-6)
    return h, c, n, m_new


def slstm_seq(x_gates, p, state=None):
    """x_gates: (b, s, 4, h, e) float32; state (h, c, n, m) or, where
    None, zeros with m = -1e30. Returns (hs (b, s, h, e), state)."""
    b, s, _, h, e = x_gates.shape
    if state is None:
        z = x_gates.new_zeros((b, h, e))
        state = (z, z, z, x_gates.new_full((b, h, e), M_INIT))
    if x_gates.device.type == "meta" and s > 2:
        def step(xs, st):
            st = slstm_step(xs[0][:, 0], *st, p)
            return st[0][:, None], st
        return _steps_on_meta(step, (x_gates,), state, s)
    hs = []
    for t in range(s):
        state = slstm_step(x_gates[:, t], *state, p)
        hs.append(state[0])
    return torch.stack(hs, dim=1), state


# ---------------------------------------------------------------------------
# Blocks and model
# ---------------------------------------------------------------------------


class XLSTMLM(nn.Module):
    """Stateless, as ``TransformerLM``: methods take the parameter tree.
    `device` is where it makes caches.
    `mesh` and `rules` reach the embedding, as in ``TransformerLM``."""

    def __init__(self, cfg: ModelConfig, device="cuda", mesh=None, rules=None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device, "XLSTMLM")
        self.mesh, self.rules = mesh, rules
        self.adt = dtype_of(cfg.activation_dtype)
        self.inner = int(cfg.d_model * cfg.mlstm_proj_factor)
        self.heads = cfg.num_heads
        self.he_m = self.inner // self.heads   # mLSTM head dim
        self.he_s = cfg.d_model // self.heads  # sLSTM head dim

    def _mlstm_defs(self) -> dict[str, Any]:
        c, d, inner, h, e = self.cfg, self.cfg.d_model, self.inner, self.heads, self.he_m
        pd = c.param_dtype
        return {
            "norm": pdef((d,), ("embed",), pd, "ones"),
            "w_up": pdef((d, 2 * inner), ("fsdp", "inner"), pd),
            "conv": pdef((c.conv_width, inner), (None, "inner"), pd, "normal", 0.1),
            "wq": pdef((inner, h, e), ("inner", "heads", None), pd),
            "wk": pdef((inner, h, e), ("inner", "heads", None), pd),
            "wv": pdef((inner, h, e), ("inner", "heads", None), pd),
            "w_if": pdef((inner, 2 * h), ("inner", None), "float32", "zeros"),
            "b_i": pdef((h,), ("heads",), "float32", "zeros"),
            "b_f": pdef((h,), ("heads",), "float32", "ones"),
            "gn": pdef((inner,), ("inner",), pd, "ones"),
            "w_down": pdef((inner, d), ("inner", "fsdp"), pd),
        }

    def _slstm_defs(self) -> dict[str, Any]:
        c, d, h, e = self.cfg, self.cfg.d_model, self.heads, self.he_s
        pd = c.param_dtype
        f = int(d * c.slstm_proj_factor)
        return {
            "norm": pdef((d,), ("embed",), pd, "ones"),
            "W": pdef((d, 4, h, e), ("fsdp", None, "heads", None), "float32", "normal", 0.02),
            "R": pdef((4, h, e, e), (None, "heads", None, None), "float32", "normal", 0.02),
            "b": pdef((4, h, e), (None, "heads", None), "float32", "zeros"),
            "gn": pdef((d,), ("embed",), pd, "ones"),
            "ffn_norm": pdef((d,), ("embed",), pd, "ones"),
            "w_gate": pdef((d, f), ("fsdp", "mlp"), pd),
            "w_up": pdef((d, f), ("fsdp", "mlp"), pd),
            "w_down": pdef((f, d), ("mlp", "fsdp"), pd),
        }

    def param_defs(self) -> dict[str, Any]:
        c = self.cfg
        d, v, pd = c.d_model, c.vocab_size, c.param_dtype
        defs: dict[str, Any] = {"embed": pdef((v, d), ("vocab", "fsdp"), pd)}
        for i in range(c.num_layers):
            defs[f"layer{i}"] = (self._slstm_defs() if i in c.slstm_at
                                 else self._mlstm_defs())
        defs["final_norm"] = pdef((d,), ("embed",), pd, "ones")
        if not c.tie_embeddings:
            defs["lm_head"] = pdef((d, v), ("embed", "vocab"), pd)
        return defs

    def init_params(self, seed: int = 0) -> dict[str, Any]:
        return init_params(self.param_defs(), seed, self.device)

    # ------------------------------------------------------------------
    def _mlstm_block(self, p, x, *, mode, cache=None):
        """cache: this layer's (C, n, m, conv_state); in decode its views,
        updated in place. Returns (x + out, the new cache in prefill)."""
        c = self.cfg
        b, s, _ = x.shape
        h = self.heads
        xs = rms_norm(x, p["norm"], c.norm_eps)
        xm, z = matmul(xs, p["w_up"]).chunk(2, dim=-1)
        xc, new_conv = causal_conv1d(xm, p["conv"],
                                     cache[3] if cache is not None else None)
        xc = F.silu(xc)
        q = einsum("bsi,ihe->bshe", xc, p["wq"]).float()
        k = einsum("bsi,ihe->bshe", xc, p["wk"]).float()
        v = einsum("bsi,ihe->bshe", xm, p["wv"]).float()
        gif = matmul(xc.float(), p["w_if"])
        log_i = gif[..., :h] + p["b_i"]
        log_f = F.logsigmoid(gif[..., h:] + p["b_f"])
        new_cache = None
        if mode == "decode":
            out, state = mlstm_decode(q[:, 0], k[:, 0], v[:, 0], log_i[:, 0],
                                      log_f[:, 0], cache[:3])
            out = out[:, None]
            for buf, t in zip(cache, state + (new_conv,)):
                buf.copy_(t)
        else:
            out, state = mlstm_chunkwise(q, k, v, log_i, log_f)
            if mode == "prefill":   # a copy: new_conv views the conv input
                new_cache = state + (new_conv.clone(),)
        out = out.reshape(b, s, self.inner).to(x.dtype)
        out = rms_norm(out, p["gn"], c.norm_eps)  # group-norm stand-in
        out = out * F.silu(z)
        return x + matmul(out, p["w_down"]), new_cache

    def _slstm_block(self, p, x, *, mode, cache=None):
        """cache: this layer's (h, c, n, m); in decode its views, updated
        in place. Returns (x + out + ffn, the new cache in prefill)."""
        c = self.cfg
        xs = rms_norm(x, p["norm"], c.norm_eps).float()
        gates = einsum("bsd,dghe->bsghe", xs, p["W"]) + p["b"]
        new_cache = None
        if mode == "decode":
            state = slstm_step(gates[:, 0], *cache, p)
            hs = state[0][:, None]
            for buf, t in zip(cache, state):
                buf.copy_(t)
        else:
            hs, state = slstm_seq(gates, p)
            if mode == "prefill":
                new_cache = state
        b, s = x.shape[:2]
        out = rms_norm(hs.reshape(b, s, c.d_model).to(x.dtype), p["gn"],
                       c.norm_eps)
        x = x + out
        xf = rms_norm(x, p["ffn_norm"], c.norm_eps)
        return x + geglu(xf, p["w_gate"], p["w_up"], p["w_down"]), new_cache

    def cache_defs(self, batch: int, seq_len: int) -> dict[str, Any]:
        """Each layer's recurrent state (seq_len does not size it): sLSTM
        (h, c, n, m), each (b, h, e_s) float32, zeros; mLSTM (C (b, h, e,
        e), n (b, h, e), m (b, h)) float32 and the conv state (b,
        conv_width - 1, inner) in the activation dtype."""
        c = self.cfg
        h, em, es = self.heads, self.he_m, self.he_s
        defs: dict[str, Any] = {}
        for i in range(c.num_layers):
            if i in c.slstm_at:
                z = pdef((batch, h, es), ("batch", "heads", None), "float32", "zeros")
                defs[f"layer{i}"] = (z, z, z, z)
            else:
                defs[f"layer{i}"] = (
                    pdef((batch, h, em, em), ("batch", "heads", None, None), "float32", "zeros"),
                    pdef((batch, h, em), ("batch", "heads", None), "float32", "zeros"),
                    pdef((batch, h), ("batch", "heads"), "float32", "zeros"),
                    pdef((batch, c.conv_width - 1, self.inner), ("batch", None, "inner"), c.activation_dtype, "zeros"),
                )
        defs["cur_len"] = pdef((), (), "int32", "zeros")
        return defs

    # ------------------------------------------------------------------
    def _run(self, params, x, *, mode, cache=None):
        """x through every layer; in prefill also {"layer{i}": cache}."""
        new_cache: dict[str, Any] = {}
        for i in range(self.cfg.num_layers):
            block = self._slstm_block if i in self.cfg.slstm_at else self._mlstm_block
            x, new = block(params[f"layer{i}"], x, mode=mode,
                           cache=cache[f"layer{i}"] if cache is not None else None)
            if mode == "prefill":
                new_cache[f"layer{i}"] = new
        return x, new_cache

    def _embed(self, params, tokens):
        return embed_lib.embed(params["embed"], tokens,
                               self.cfg.embedding_impl, self.mesh,
                               self.rules).to(self.adt)

    def _head(self, params):
        return params["embed"].T if self.cfg.tie_embeddings else params["lm_head"]

    def _logits(self, params, x):
        h = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        return einsum("bsd,dv->bsv", h, self._head(params))[:, 0]

    def loss(self, params, batch):
        """batch: tokens (b, s), labels (b, s) with -1 at masked positions.
        Returns (mean cross-entropy, {"ce", "aux" (0)}); no remat, as in
        the JAX package."""
        labels = batch["labels"]
        x, _ = self._run(params, self._embed(params, batch["tokens"]),
                         mode="train")
        h = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        ce = softmax_xent_chunked(h, self._head(params), labels,
                                  (labels >= 0).float())
        return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32,
                                                 device=x.device)}

    @torch.inference_mode()
    def prefill(self, params, batch):
        """batch: {"tokens": (b, s)}. Returns (logits of the last position
        (b, vocab), cache as `cache_defs` with cur_len = s)."""
        tokens = batch["tokens"]
        x, cache = self._run(params, self._embed(params, tokens),
                             mode="prefill")
        cache["cur_len"] = torch.full((), tokens.shape[1], dtype=torch.int32,
                                      device=x.device)
        return self._logits(params, x[:, -1:]), cache

    @torch.inference_mode()
    def decode_step(self, params, cache, tokens):
        """tokens: (b, 1). The cache's tensors are updated in place; the
        returned cache holds them with cur_len + 1."""
        x, _ = self._run(params, self._embed(params, tokens), mode="decode",
                         cache=cache)
        new_cache = dict(cache, cur_len=cache["cur_len"] + 1)
        return self._logits(params, x), new_cache
