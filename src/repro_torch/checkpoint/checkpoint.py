"""Atomic, optionally asynchronous checkpoints, in the JAX package's format.

Format: one directory per step, ``step_%08d``, containing
``manifest.json`` (the step and each tree's sorted leaf keys) and
``arrays.npz`` (leaves keyed by '/'-joined path, under the tree's name).
numpy has no bfloat16, so a bf16 leaf is stored as its uint16 bits under
the key + ``::bf16``: the JAX package's format, so a checkpoint written by
either package loads in the other. Arrays are saved with their *global*
shapes, so restore is mesh-agnostic: ``load`` places every leaf on one
device, or, given shardings, cuts it into one block a position of the
*target* mesh (``sharding.ShardedTensor``): the elastic restore (train on
N shards, resume on M). ``save`` takes such sharded leaves and writes
their global tensors, so a tree saved from a mesh loads with none.

Writes are atomic (tmp dir + rename) and optionally asynchronous (snapshot
to the host synchronously, file I/O on a writer thread) so the train loop
never blocks on disk.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.common import tree_map_with_path, tree_paths
from repro_torch.sharding.rules import ShardedTensor

MANIFEST = "manifest.json"
ARRAYS = "arrays.npz"
BF16 = "::bf16"


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    out = {}
    for path, leaf in tree_paths(tree):
        key = "/".join(path)
        if isinstance(leaf, ShardedTensor):
            leaf = leaf.full()
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu()
            if leaf.dtype == torch.bfloat16:
                out[key + BF16] = leaf.view(torch.int16).numpy().view(np.uint16)
                continue
            leaf = leaf.numpy()
        out[key] = np.asarray(leaf)
    return out


def save(workdir: str, step: int, trees: dict[str, Any],
         keep: int = 3) -> str:
    """trees: e.g. {"params": ..., "opt_state": ...} of tensors, sharded
    tensors or numpy arrays. Returns the checkpoint's path."""
    os.makedirs(workdir, exist_ok=True)
    final = os.path.join(workdir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays: dict[str, np.ndarray] = {}
    spec: dict[str, Any] = {"step": step, "trees": {}}
    for name, tree in trees.items():
        flat = _flatten(tree)
        for k, v in flat.items():
            arrays[f"{name}/{k}"] = v
        spec["trees"][name] = sorted(flat)
    np.savez(os.path.join(tmp, ARRAYS), **arrays)
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(spec, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    _gc(workdir, keep)
    return final


def _steps(workdir: str) -> list[str]:
    return sorted(d for d in os.listdir(workdir)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def _gc(workdir: str, keep: int) -> None:
    for d in _steps(workdir)[:-keep]:
        shutil.rmtree(os.path.join(workdir, d), ignore_errors=True)


def latest(workdir: str) -> str | None:
    if not os.path.isdir(workdir):
        return None
    ckpts = _steps(workdir)
    return os.path.join(workdir, ckpts[-1]) if ckpts else None


def load(path: str, templates: dict[str, Any],
         shardings: dict[str, Any] | None = None,
         device=None) -> tuple[int, dict[str, Any]]:
    """templates: same-structure trees of tensors (``meta`` ones will do
    with `shardings`), whose shapes the checkpoint's must match. Without
    `shardings` each leaf takes its template's dtype and goes to `device`
    (default: its template's). `shardings`: same-structure trees of
    ``NamedSharding`` for re-placement on a (possibly different) mesh, the
    elastic restore: each leaf becomes a ``ShardedTensor`` on the mesh's
    device in the checkpoint's own dtype (the JAX package's
    ``device_put(arr, sharding)`` casts nothing). Returns (step, trees)."""
    with open(os.path.join(path, MANIFEST)) as f:
        spec = json.load(f)
    out: dict[str, Any] = {}
    with np.load(os.path.join(path, ARRAYS)) as data:
        for name, template in templates.items():
            def fill(p, leaf):
                key = f"{name}/" + "/".join(p)
                if key + BF16 in data:
                    t = torch.from_numpy(data[key + BF16].view(np.int16)).view(torch.bfloat16)
                else:
                    t = torch.from_numpy(np.asarray(data[key]))
                if tuple(t.shape) != tuple(leaf.shape):
                    raise ValueError(f"{key}: checkpoint shape "
                                     f"{tuple(t.shape)} != template "
                                     f"{tuple(leaf.shape)}")
                if shardings is not None:
                    return _lookup(shardings[name], p).shard(t)
                return t.to(device=device or leaf.device, dtype=leaf.dtype)
            out[name] = tree_map_with_path(fill, template)
    return spec["step"], out


def _lookup(tree: Any, path: tuple):
    for p in path:
        tree = tree[p] if isinstance(tree, dict) else tree[int(p)]
    return tree


class AsyncCheckpointer:
    """Snapshot synchronously (device -> host copy), write on a thread."""

    def __init__(self, workdir: str, keep: int = 3):
        self.workdir = workdir
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self.last_path: str | None = None

    def save(self, step: int, trees: dict[str, Any]) -> None:
        self.wait()
        # a copy: the train step updates the device (or CPU) tensors in place
        host = {name: tree_map_with_path(
            lambda _, t: (t.full() if isinstance(t, ShardedTensor) else t
                          ).detach().to("cpu", copy=True), tree)
            for name, tree in trees.items()}

        def _write():
            try:
                self.last_path = save(self.workdir, step, host, self.keep)
            except BaseException as e:     # raised again by wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Wait for the write in flight; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
