"""Uniform model API: build_model, input defs per shape, step factories.

    train_step(params, opt_state, batch)        -> (params, opt_state, metrics)
    prefill_step(params, batch)                 -> (logits, cache)
    decode_step(params, cache, batch)           -> (logits, cache)
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.common import tree_map_with_path, tree_paths
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.params import pdef
from repro_torch.models.recurrent import RecurrentGemmaLM
from repro_torch.models.transformer import VIT_DIM, TransformerLM
from repro_torch.models.xlstm import XLSTMLM
from repro_torch.optim.adamw import OptConfig, adamw_update


def build_model(cfg: ModelConfig, mesh=None, rules=None, device=None):
    """The model of `cfg`'s family: XLSTMLM (ssm), RecurrentGemmaLM
    (hybrid) or TransformerLM (the rest), as the JAX package's
    ``build_model(cfg, mesh, rules)``. The model lives on `device`: by
    default the mesh's, else the card. A device in `mesh`'s place
    (``build_model(cfg, "cpu")``) is taken as `device`."""
    if isinstance(mesh, (str, torch.device)):
        mesh, device = None, mesh
    if device is None:
        device = getattr(mesh, "device", None) or "cuda"
    if cfg.family == "ssm":
        return XLSTMLM(cfg, device, mesh, rules)
    if cfg.family == "hybrid":
        return RecurrentGemmaLM(cfg, device, mesh, rules)
    return TransformerLM(cfg, device, mesh, rules)


def input_defs(cfg: ModelConfig, shape: ShapeConfig,
               micro_batches: int = 1) -> dict[str, Any]:
    """ParamDef tree for the step inputs of one (arch x shape) cell.

    With micro_batches > 1, train inputs carry a leading microbatch dim:
    (n_micro, rows, seq), which ``make_train_step`` walks. The modality
    frontends are stubs: the vlm family takes precomputed patch
    embeddings (num_patches of the shape's positions), the audio family
    one token a codebook at each position; the rest take plain tokens."""
    b, s, kind = shape.global_batch, shape.seq_len, shape.kind
    tok_axes: tuple = ("batch", "seq")
    lead: tuple[int, ...] = ()
    lead_axes: tuple = ()
    if kind == "train" and micro_batches > 1:
        if b % micro_batches:
            raise ValueError(f"{b} rows do not split into {micro_batches} "
                             f"microbatches")
        b = b // micro_batches
        lead, lead_axes = (micro_batches,), (None,)
    tail: tuple[int, ...] = ()
    tail_axes: tuple = ()
    if cfg.family == "audio":
        tail, tail_axes = (cfg.num_codebooks,), (None,)
    if kind == "decode":
        return {"tokens": pdef((b, 1) + tail, tok_axes + tail_axes, "int32",
                               "zeros")}
    out: dict[str, Any] = {}
    if cfg.family == "vlm":
        s = s - cfg.num_patches
        out["patch_embeds"] = pdef(lead + (b, cfg.num_patches, VIT_DIM),
                                   lead_axes + ("batch", None, None),
                                   cfg.activation_dtype, "zeros")
    tok = pdef(lead + (b, s) + tail, lead_axes + tok_axes + tail_axes,
               "int32", "zeros")
    out["tokens"] = tok
    if kind == "train":
        out["labels"] = tok
    return out


def default_micro_batches(cfg: ModelConfig, shape: ShapeConfig,
                          mesh=None) -> int:
    """Pick the microbatch count so the per-microbatch remat stash
    (L x rows_local x seq x d_model, bf16) stays ~<= 2 GiB a device.
    `mesh` is anything with a ``shape`` mapping of axis sizes ("data",
    "pod"); without one the step takes the whole batch at once."""
    if shape.kind != "train" or mesh is None:
        return 1
    dp = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)
    best = 1
    for n in range(1, shape.global_batch + 1):
        rows = shape.global_batch // n
        # microbatch rows must stay evenly DP-shardable
        if shape.global_batch % n or rows % dp or rows < dp:
            continue
        rows_local = rows // dp
        stash = cfg.num_layers * rows_local * shape.seq_len * cfg.d_model * 2
        best = n
        if stash <= 2 * 2**30:
            break
    return best


def loss_and_grads(model, params, batch):
    """(loss, metrics, grads): the model's loss on `batch` and its gradient
    with respect to every leaf of `params`, as a tree of the same shape.
    Tensors are detached; `params` take no ``.grad``."""
    live = tree_map_with_path(lambda _, t: t.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss, metrics = model.loss(live, batch)
        leaves = list(tree_paths(live))
        flat = torch.autograd.grad(loss, [t for _, t in leaves])
    by_path = {path: g for (path, _), g in zip(leaves, flat)}
    grads = tree_map_with_path(lambda path, _: by_path[path], params)
    return loss.detach(), {k: m.detach() for k, m in metrics.items()}, grads


def make_train_step(model, opt_cfg: OptConfig, micro_batches: int = 1,
                    accum_dtype: torch.dtype | None = None):
    """Grad-accumulating train step. With micro_batches > 1 each batch
    leaf is (micro_batches, rows, ...); one microbatch's activations are
    live at a time, and the gradients accumulate as acc + g / n in
    `accum_dtype` (float32 by default), as the JAX step's scan does.
    `params` and `opt_state` are updated in place (the JAX step donates
    them) and returned; metrics are 0-dim tensors on the device."""
    accum_dtype = accum_dtype or torch.float32

    def train_step(params, opt_state, batch):
        if micro_batches == 1:
            loss, metrics, grads = loss_and_grads(model, params, batch)
        else:
            grads = tree_map_with_path(
                lambda _, p: torch.zeros(p.shape, dtype=accum_dtype,
                                         device=p.device), params)
            acc = dict(tree_paths(grads))
            losses, metricses = [], []
            for i in range(micro_batches):
                loss, metrics, g = loss_and_grads(
                    model, params, {k: v[i] for k, v in batch.items()})
                for path, gi in tree_paths(g):
                    acc[path].add_(gi.to(accum_dtype) / micro_batches)
                del g
                losses.append(loss)
                metricses.append(metrics)
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in metricses]).mean()
                       for k in metricses[0]}
        params, opt_state, opt_metrics = adamw_update(grads, opt_state, params,
                                                      opt_cfg)
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return params, opt_state, metrics
    return train_step


def make_prefill_step(model):
    def prefill_step(params, batch):
        return model.prefill(params, batch)
    return prefill_step


def make_decode_step(model):
    def decode_step(params, cache, batch):
        return model.decode_step(params, cache, batch["tokens"])
    return decode_step
