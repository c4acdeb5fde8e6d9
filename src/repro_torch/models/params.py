"""Parameter definition trees: one source of truth for shapes, init and
sharding.

Models declare ``ParamDef`` trees; from the same tree this module makes
 * concrete tensors (``init_params``, the JAX package's ``init_tree``),
 * ``meta`` tensors that allocate nothing (``abstract_tree``: the dry-run),
 * ``PartitionSpec`` and ``NamedSharding`` trees via the logical-axis
   ``Rules``, and the per-device bytes they imply.
A JAX parameter tree carried over as numpy arrays (``params_from_numpy``)
has the same paths, shapes and layouts, so the model loads it as it is.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch.common import (dtype_of, resolve_device, tree_map_with_path,
                                tree_paths)
from repro_torch.sharding.rules import Rules


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """A dataclass (not NamedTuple) so tree utils treat it as a leaf."""
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]   # logical axis per dim (len == ndim)
    dtype: str = "bfloat16"
    init: str = "normal"           # normal | zeros | ones
    scale: float = 0.02


def pdef(shape, axes, dtype="bfloat16", init="normal", scale=0.02) -> ParamDef:
    shape = tuple(int(s) for s in shape)
    axes = tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in rank")
    return ParamDef(shape, axes, dtype, init, scale)


def is_def(x: Any) -> bool:
    return isinstance(x, ParamDef)


def stack_defs(defs: Any, n: int, axis_name: str = "layers") -> Any:
    """Prepend a stacked (layer) dim of size n to every def in the tree."""
    def f(_, d: ParamDef):
        return ParamDef((n,) + d.shape, (axis_name,) + d.axes, d.dtype, d.init, d.scale)
    return tree_map_with_path(f, defs)


def unstack(stacked: Any) -> list:
    """The per-layer trees of a tree stacked by `stack_defs`, taken with
    one ``unbind(0)`` a leaf: its backward writes the leaf's gradient
    once, where one ``t[i]`` a layer would write a zeroed whole-leaf
    gradient a layer."""
    parts = {path: t.unbind(0) for path, t in tree_paths(stacked)}
    n = len(next(iter(parts.values())))
    return [tree_map_with_path(lambda path, _: parts[path][i], stacked)
            for i in range(n)]


def bytes_of(defs: Any) -> int:
    return sum(int(np.prod(d.shape)) * dtype_of(d.dtype).itemsize
               for _, d in tree_paths(defs))


def abstract_tree(defs: Any, rules: Rules | None = None) -> Any:
    """``meta`` tensors of each def's shape and dtype: nothing is allocated.
    With `rules`, each carries its ``NamedSharding`` as ``.sharding`` (the
    JAX package's ``ShapeDtypeStruct(..., sharding=...)``)."""
    def make(_, d: ParamDef):
        t = torch.empty(d.shape, dtype=dtype_of(d.dtype), device="meta")
        if rules is not None:
            t.sharding = rules.sharding(*d.axes)
        return t
    return tree_map_with_path(make, defs)


def pspec_tree(defs: Any, rules: Rules) -> Any:
    return tree_map_with_path(lambda _, d: rules.pspec(*d.axes), defs)


def sharding_tree(defs: Any, rules: Rules) -> Any:
    return tree_map_with_path(lambda _, d: rules.sharding(*d.axes), defs)


def sharded_bytes_per_device(defs: Any, rules: Rules) -> int:
    """Exact per-device resident bytes for a def tree under its shardings
    (ceil division per sharded dim, matching GSPMD's padding)."""
    return sum(math.prod(rules.sharding(*d.axes).shard_shape(d.shape))
               * dtype_of(d.dtype).itemsize for _, d in tree_paths(defs))


def path_seed(seed: int, path: tuple) -> int:
    """A stable per-parameter seed: the path hash of the JAX package's
    ``fold_path`` mixed with `seed` (Python's ``hash`` of a string changes
    between processes, so it is not used)."""
    h = 0
    for part in path:
        for ch in str(part):
            h = (h * 131 + ord(ch)) % (2**31 - 1)
    return (seed * (2**31 - 1) + h) % (2**63 - 1)


def init_params(defs: Any, seed: int = 0, device="cuda") -> Any:
    """Concrete tensors for a ParamDef tree: normal * scale drawn in float32
    from a ``torch.Generator`` on `device` seeded per path (per layer for a
    stacked def, so the float32 draw never holds more than one layer), cast
    to the def's dtype; ``zeros``/``ones`` as named. The numbers differ from
    the JAX package's for the same seed (another generator); tests carry
    weights across with ``params_from_numpy``."""
    device = resolve_device(device, "init_params")

    def make(path, d: ParamDef):
        dt = dtype_of(d.dtype)
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dt, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dt, device=device)
        gen = torch.Generator(device=device)
        stacked = bool(d.axes) and d.axes[0] == "layers"
        out = torch.empty(d.shape, dtype=dt, device=device)
        for i, part in enumerate(out if stacked else [out]):
            gen.manual_seed(path_seed(seed, path + ((i,) if stacked else ())))
            w = torch.randn(part.shape, generator=gen, dtype=torch.float32,
                            device=device)
            part.copy_(w.mul_(d.scale))
        return out

    return tree_map_with_path(make, defs)


def params_from_numpy(tree: Any, device="cuda") -> Any:
    """The JAX package's parameter (or cache) tree, given as numpy arrays
    under the same nested keys, as tensors on `device`. Shapes, dtypes and
    layouts are kept: no transposes, since the port uses the JAX package's
    weight layouts (``wq`` is (d, h, e), ``wo`` is (h, e, d), ...). numpy
    has no bfloat16: pass such arrays as float32 and cast the result."""
    device = resolve_device(device, "params_from_numpy")
    return tree_map_with_path(
        lambda _, a: torch.from_numpy(np.array(a)).to(device), tree)


# a decode cache carries across the same way: each group's pair stacked
# over its layers, (k, v) or MLA's (ckv, k_pe), and a 0-dim int32 cur_len;
# numpy has no float8 either: pass a float8 cache as float32 and cast back
# (exact, every float8 value is a float32 one)
cache_from_numpy = params_from_numpy
