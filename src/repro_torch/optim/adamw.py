"""AdamW with global-norm clipping and dtype-configurable moments.

The JAX package's ``repro.optim.adamw`` with the same state tree
(``{"mu", "nu", "step"}``, ``step`` an int32 0-dim tensor on the device)
and the same arithmetic: moments stored in ``moment_dtype``, the update
computed in float32, decoupled weight decay on matrices only. Where the
JAX function returns new trees, ``adamw_update`` writes the parameters and
moments in place (the JAX trainer donates them), one slice of at most
``CHUNK`` elements of one leaf at a time: at yi-6b's width the largest
stacked leaf is 2.9 GB in float32, so the reference's float32 copies of
p, g, mu and nu of a whole leaf are never all live at once. Every
operation is elementwise, so the slicing changes no bit of the result.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.common import dtype_of, tree_map_with_path, tree_paths

CHUNK = 1 << 26          # elements of one leaf updated at a time (256 MB f32)


@dataclasses.dataclass(frozen=True)
class OptConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"  # "bfloat16" = compressed optimizer states


def cosine_lr(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``learning_rate``, then a cosine decay to
    ``min_lr_ratio`` of it at ``decay_steps``; float32, on step's device."""
    step = torch.as_tensor(step).float()
    warm = cfg.learning_rate * torch.clamp(step, max=cfg.warmup_steps) / cfg.warmup_steps
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cfg.learning_rate * cos)


def init_opt_state(params: Any, cfg: OptConfig) -> dict:
    mdt = dtype_of(cfg.moment_dtype)
    zeros = lambda _, p: torch.zeros(p.shape, dtype=mdt, device=p.device)
    device = next(t for _, t in tree_paths(params)).device
    return {
        "mu": tree_map_with_path(zeros, params),
        "nu": tree_map_with_path(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def _chunks(t: torch.Tensor):
    """Slices of a flat view; `view` raises on a tensor that is not
    contiguous, where slices of a copy would take no in-place update."""
    return t.view(-1).split(CHUNK)


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    total = None
    for _, x in tree_paths(tree):
        for c in x.reshape(-1).split(CHUNK):
            s = c.float().square().sum()
            total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads: Any, state: dict, params: Any, cfg: OptConfig):
    """Returns (params, state, metrics): `params` and the moments of
    `state` updated in place, a new step counter, and {"grad_norm", "lr"}
    as 0-dim float32 tensors. No value is read back to the host."""
    with torch.profiler.record_function("adamw_update"):
        step = state["step"] + 1
        gnorm = global_norm(grads)
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
        lr = cosine_lr(cfg, step)
        stepf = step.float()
        b1c = 1 - torch.pow(cfg.b1, stepf)
        b2c = 1 - torch.pow(cfg.b2, stepf)
        g_of = dict(tree_paths(grads))
        mu_of = dict(tree_paths(state["mu"]))
        nu_of = dict(tree_paths(state["nu"]))
        for path, p in tree_paths(params):
            decay = p.dim() >= 2       # decoupled weight decay on matrices only
            gs = g_of[path].reshape(-1).split(CHUNK)
            for pc, gc, mc, nc in zip(_chunks(p), gs, _chunks(mu_of[path]),
                                      _chunks(nu_of[path])):
                g = gc.float() * scale
                mu32 = cfg.b1 * mc.float() + (1 - cfg.b1) * g
                nu32 = cfg.b2 * nc.float() + (1 - cfg.b2) * g.square()
                delta = (mu32 / b1c) / (torch.sqrt(nu32 / b2c) + cfg.eps)
                p32 = pc.float()
                if decay:
                    delta = delta + cfg.weight_decay * p32
                pc.copy_(p32 - lr * delta)
                mc.copy_(mu32)
                nc.copy_(nu32)
    new_state = {"mu": state["mu"], "nu": state["nu"], "step": step}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}


def opt_state_defs(param_defs: Any, cfg: OptConfig) -> dict:
    """ParamDef tree for the optimizer state (same layout as params)."""
    from repro_torch.models.params import ParamDef, pdef

    def mom(_, d: ParamDef):
        return dataclasses.replace(d, dtype=cfg.moment_dtype, init="zeros")
    return {
        "mu": tree_map_with_path(mom, param_defs),
        "nu": tree_map_with_path(mom, param_defs),
        "step": pdef((), (), "int32", "zeros"),
    }
