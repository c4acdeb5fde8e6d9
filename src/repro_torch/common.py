"""Shared small utilities."""
from __future__ import annotations

from typing import Any, Iterator

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
