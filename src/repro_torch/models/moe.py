"""Mixture-of-Experts layer with sort-based routed dispatch.

The JAX package's ``models/moe.py`` on one device: the top-k (expert,
token) pairs are sorted by expert, each pair takes a slot in its expert's
capacity buffer, the experts run as one batched product over the buffers,
and the results go back to their tokens. Every step gives the same bits on
a rerun, on the CPU and on a card:
- top-k is a stable descending sort, so among equal probabilities the
  lower expert index comes first, as ``jax.lax.top_k`` orders them;
- the pairs are sorted with ``stable=True``, so a pair's slot, and which
  pairs an expert over capacity drops, are the reference's;
- a dropped pair writes a zero row into the spill row ``cap``, so the
  scatter's duplicate writes all carry the same value;
- the combine adds no atomics: each token's k contributions are gathered
  in expert order (the order in which the reference's scatter-add meets
  them) and summed one after another in float32.
The expert and router products are plain matrix products, as in the
reference, which runs them outside any Pallas kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.common import ceil_div, einsum
from repro_torch.models.layers import swiglu


def router_topk(x: torch.Tensor, w_router: torch.Tensor, top_k: int,
                num_experts: int):
    """Returns (weights (T, k) fp32, expert_ids (T, k) int64, aux_loss)."""
    logits = einsum("td,de->te", x.float(), w_router.float())
    probs = torch.softmax(logits, dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, ids = top.values[:, :top_k], top.indices[:, :top_k]
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    # load-balance auxiliary loss (Switch-style)
    me = probs.mean(dim=0)                                   # (E,)
    ce = _counts(ids.reshape(-1), num_experts).float()
    ce = ce / torch.clamp(ce.sum(), min=1.0)
    aux = num_experts * torch.sum(me * ce)
    return weights, ids, aux


def _counts(flat_e: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Pairs routed to each expert, (E,) int64, without a host sync (a
    CUDA ``bincount`` reads the largest id back to size its output)."""
    experts = torch.arange(num_experts, device=flat_e.device)
    return (flat_e[:, None] == experts).sum(0)


def capacity_of(num_tokens: int, num_experts: int, top_k: int,
                capacity_factor: float) -> int:
    return max(ceil_div(int(num_tokens * top_k * capacity_factor), num_experts), 4)


def dispatch(ids: torch.Tensor, num_experts: int, cap: int):
    """The routed pairs sorted by expert: (order, se, st, slot, keep).
    `order` sorts the flat (token, k) pairs by expert id (stable); se and
    st are each sorted pair's expert and token; slot is its row in the
    expert's buffer, `cap` (the spill row) where keep is False."""
    t, top_k = ids.shape
    flat_e = ids.reshape(-1)                                 # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    st = order // top_k
    # slot within expert = position - first position of that expert id
    first = torch.searchsorted(
        se, torch.arange(num_experts, device=ids.device), side="left")
    slot = torch.arange(t * top_k, device=ids.device) - first[se]
    keep = slot < cap
    return order, se, st, torch.where(keep, slot, cap), keep


def moe_ffn(x: torch.Tensor, params: dict, *, top_k: int, num_experts: int,
            capacity_factor: float = 1.25):
    """x: (T, d) flat tokens. params: router (d,E), w_gate/w_up (E,d,f),
    w_down (E,f,d), optionally shared_* dense expert weights.

    Returns (y (T, d), aux_loss, dropped_fraction)."""
    t, d = x.shape
    weights, ids, aux = router_topk(x, params["router"], top_k, num_experts)
    cap = capacity_of(t, num_experts, top_k, capacity_factor)
    order, se, st, slot, keep = dispatch(ids, num_experts, cap)
    sw = weights.reshape(-1)[order]
    dropped = 1.0 - keep.float().mean()
    # gather tokens into per-expert buffers (E, cap+1, d); +1 = spill row
    buf = torch.zeros((num_experts, cap + 1, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((se, slot), x[st] * keep[:, None].to(x.dtype))

    # ---- expert FFN, batched over experts ----
    g = einsum("ecd,edf->ecf", buf, params["w_gate"])
    u = einsum("ecd,edf->ecf", buf, params["w_up"])
    y = einsum("ecf,efd->ecd", F.silu(g) * u, params["w_down"])

    # ---- combine: each token's k results, in expert order ----
    contrib = y[se, slot].float() * (sw * keep)[:, None]   # sorted pairs
    pos = torch.empty_like(order)
    pos[order] = torch.arange(order.numel(), device=x.device)
    pos = torch.sort(pos.view(t, top_k), dim=1).values     # expert order
    parts = contrib[pos]                                    # (T, k, d)
    out = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    for j in range(top_k):
        out = out + parts[:, j]

    if "shared_w_gate" in params:
        out = out + swiglu(x, params["shared_w_gate"], params["shared_w_up"],
                           params["shared_w_down"]).float()
    return out.to(x.dtype), aux, dropped
