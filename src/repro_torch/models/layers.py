"""Elementary layers (plain functions on tensors)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.common import einsum, matmul


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies for rotary embeddings (half-dim)."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary position embedding on the two halves of the head dim (not
    interleaved pairs), as the JAX package does.

    x: (..., seq, heads, head_dim); positions: broadcastable to (..., seq).
    """
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs  # (..., s, half)
    cos = torch.cos(angles)[..., None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    return matmul(F.silu(matmul(x, w_gate)) * matmul(x, w_up), w_down)


def geglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
          w_down: torch.Tensor) -> torch.Tensor:
    """GELU-gated feed-forward. The GELU is the tanh approximation, which
    is ``jax.nn.gelu``'s default (the exact one differs by about 1e-3)."""
    return matmul(F.gelu(matmul(x, w_gate), approximate="tanh")
                  * matmul(x, w_up), w_down)


def causal_conv1d(x: torch.Tensor, kernel: torch.Tensor,
                  state: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal 1-D convolution.

    x: (b, s, c); kernel: (w, c); state: the (b, w - 1, c) inputs before
    x (zeros where None). Returns (y, new_state), new_state the trailing
    w - 1 inputs for streaming decode. The taps are summed in x's dtype,
    one at a time, as the JAX package sums them."""
    w = kernel.shape[0]
    b, s, c = x.shape
    if state is None:
        state = x.new_zeros((b, w - 1, c))
    xp = torch.cat([state, x], dim=1)  # (b, s + w - 1, c)
    y = torch.zeros_like(x)
    for i in range(w):
        y = y + xp[:, i:i + s] * kernel[i]
    new_state = xp[:, s:] if w > 1 else x.new_zeros((b, 0, c))
    return y, new_state


def _xent_chunk(h, head_w, y, m):
    """(sum of masked token losses, sum of the mask) of one chunk, from
    float32 logits. A label of -1 marks a masked position: JAX's
    ``take_along_axis`` reads it as the last column, ``gather`` refuses it,
    so it is clamped to 0; the mask zeroes the term either way."""
    logits = einsum("bsd,dv->bsv", h, head_w).float()
    lse = torch.logsumexp(logits, dim=-1)
    lab = torch.gather(logits, -1, y.clamp(min=0).long()[..., None])[..., 0]
    return ((lse - lab) * m).sum(), m.sum()


def _xent_chunks(hidden, labels, mask, chunk):
    """The JAX package's chunking: (hidden, labels, mask) of n whole chunks
    of `chunk` positions, then of the remainder."""
    s = hidden.shape[1]
    chunk = min(chunk, s)
    bounds = [(i, i + chunk) for i in range(0, s - chunk + 1, chunk)]
    if bounds[-1][1] < s:
        bounds.append((bounds[-1][1], s))
    return [(hidden[:, a:b], labels[:, a:b], mask[:, a:b]) for a, b in bounds]


class _ChunkedXent(torch.autograd.Function):
    """Keeps only its inputs for the backward, which recomputes one chunk's
    logits at a time (the JAX scan keeps every chunk's float32 logits:
    2.1 GB at yi-6b's (2, 4096) batch) and differentiates it by autograd."""

    @staticmethod
    def forward(ctx, hidden, head_w, labels, mask, chunk):
        with torch.profiler.record_function("softmax_xent_chunked"):
            tot = cnt = 0.0
            for h, y, m in _xent_chunks(hidden, labels, mask, chunk):
                l, c = _xent_chunk(h, head_w, y, m)
                tot, cnt = tot + l, cnt + c
            denom = torch.clamp(cnt, min=1.0)
        ctx.save_for_backward(hidden, head_w, labels, mask, denom)
        ctx.chunk = chunk
        return tot / denom

    @staticmethod
    def backward(ctx, g):
        hidden, head_w, labels, mask, denom = ctx.saved_tensors
        with torch.profiler.record_function("softmax_xent_chunked_backward"):
            w = head_w.detach().requires_grad_()
            dh, dw = [], torch.zeros(head_w.shape, dtype=torch.float32,
                                     device=head_w.device)
            for h, y, m in _xent_chunks(hidden, labels, mask, ctx.chunk):
                h = h.detach().requires_grad_()
                with torch.enable_grad():
                    l, _ = _xent_chunk(h, w, y, m)
                dhc, dwc = torch.autograd.grad(l, (h, w), g / denom)
                dh.append(dhc)
                dw += dwc                  # summed over chunks in float32
        return torch.cat(dh, dim=1), dw.to(head_w.dtype), None, None, None


def softmax_xent_chunked(hidden: torch.Tensor, head_w: torch.Tensor,
                         labels: torch.Tensor, mask: torch.Tensor,
                         chunk: int = 512) -> torch.Tensor:
    """Cross-entropy without materializing full (b, s, vocab) fp32 logits.

    hidden: (b, s, d); head_w: (d, v); labels/mask: (b, s). Sums the masked
    token losses over sequence chunks of `chunk` positions (and the
    remainder), then divides by max(sum of the mask, 1)."""
    return _ChunkedXent.apply(hidden, head_w, labels, mask, chunk)
