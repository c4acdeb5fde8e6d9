"""Shared small utilities."""
from __future__ import annotations

import dataclasses
import functools
import json
from typing import Any, Iterator

import numpy as np
import torch

# Canonical dtype registry (string names keep configs JSON-serializable).
DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "int32": torch.int32,
    "int64": torch.int64,
    "int8": torch.int8,
    "float8_e4m3fn": torch.float8_e4m3fn,
}


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


# float8_e4m3fn's largest finite value is 448 and it has no infinity: the
# JAX package's cast rounds |x| > 464 (past the midpoint to 480) to NaN
F8_OVERFLOW = 464.0


def cache_cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`x` cast to a KV cache's `dtype` as the JAX package's ``astype``
    casts it. For float8_e4m3fn torch saturates an overflow to ±448 where
    JAX gives NaN: here |x| > 464, ±inf and NaN become NaN with x's sign
    bit, and every other value takes torch's round-to-nearest-even, which
    is JAX's (exactly 464 rounds to 448). Other dtypes cast as ``to``."""
    if dtype != torch.float8_e4m3fn:
        return x.to(dtype)
    nan = x.isnan() | (x.abs() > F8_OVERFLOW)
    bits = torch.where(nan, 0, x).to(dtype).view(torch.uint8)
    nan_bits = torch.where(torch.signbit(x), 0xFF, 0x7F).to(torch.uint8)
    return torch.where(nan, nan_bits, bits).view(dtype)


def einsum(eq: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with ``jnp.einsum``'s dtype promotion: operands of
    different dtypes (bfloat16 weights with float32 activations) are cast
    up, exactly, to their common type, where torch raises. Operands of one
    dtype pass through untouched."""
    dtypes = {o.dtype for o in operands}
    if len(dtypes) == 1:
        return torch.einsum(eq, *operands)
    dt = functools.reduce(torch.promote_types, dtypes)
    return torch.einsum(eq, *(o.to(dt) for o in operands))


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with ``jnp``'s dtype promotion, as `einsum`."""
    if a.dtype == b.dtype:
        return a @ b
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def tree_paths(tree: Any, prefix: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """Yield (path, leaf) for a nested dict/list tree of leaves."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_paths(v, prefix + (str(i),))
    else:
        yield prefix, tree


def tree_map_with_path(fn, tree: Any, prefix: tuple = ()) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        typ = type(tree)
        return typ(tree_map_with_path(fn, v, prefix + (str(i),)) for i, v in enumerate(tree))
    return fn(prefix, tree)


def param_count(tree: Any) -> int:
    return sum(x.numel() for _, x in tree_paths(tree))


def param_bytes(tree: Any) -> int:
    return sum(x.numel() * x.element_size() for _, x in tree_paths(tree))


def resolve_device(device, caller: str) -> torch.device:
    """`device` as a torch.device; raise if it is CUDA and this host has
    none. Entry points default to "cuda" and call this first."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{caller}: CUDA is not available on this host; pass "
            f"device='cpu' to run the plain PyTorch path on the CPU")
    return device


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return ceil_div(a, b) * b


class NpEncoder(json.JSONEncoder):
    """JSON for numpy scalars and arrays and dataclasses (the launch
    tools' reports)."""

    def default(self, obj):
        if isinstance(obj, (np.integer,)):
            return int(obj)
        if isinstance(obj, (np.floating,)):
            return float(obj)
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        if dataclasses.is_dataclass(obj):
            return dataclasses.asdict(obj)
        return super().default(obj)


def dump_json(obj: Any, path: str) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=2, cls=NpEncoder)
