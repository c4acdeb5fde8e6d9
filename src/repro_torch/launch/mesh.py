"""Meshes: the port's description of a device mesh (a function, never
module-level state).

A ``Mesh`` is what the JAX package's code reads of a ``jax.sharding.Mesh``:
its ``axis_names`` and an ordered ``shape`` mapping (axis -> size, with
``.get``), plus an optional ``device``. ``Rules`` (sharding/rules.py)
resolves logical axes against it, and ``NamedSharding`` cuts a tensor into
one block per mesh position on that device.

The production layouts have no device: they are abstract, for the dry-run
and the cost model. A mesh from ``make_mesh_for`` holds all its shards on
one device; the collectives of one of its axes run through
``core/collectives.py`` (``axis_mesh``).
"""
from __future__ import annotations

import math

from repro_torch.core.collectives import LocalMesh, _mesh_device


class Mesh:
    """`axis_names` and their sizes; `device` is where the shards live
    (None: an abstract layout that runs nothing)."""

    def __init__(self, axis_names, sizes, device=None):
        self.axis_names = tuple(axis_names)
        sizes = tuple(int(s) for s in sizes)
        if len(sizes) != len(self.axis_names) or min(sizes, default=1) < 1:
            raise ValueError(f"mesh axes {self.axis_names} need one size >= 1 "
                             f"each, got {sizes}")
        self.shape = dict(zip(self.axis_names, sizes))
        self.device = None if device is None else _mesh_device(device, "Mesh")

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def axis_mesh(self, axis: str):
        """The one-axis ``LocalMesh`` whose ``run`` executes `axis`'s
        collectives on `device`."""
        if self.device is None:
            raise ValueError(f"mesh {self.shape} is an abstract layout with "
                             f"no device; it runs no collective")
        return LocalMesh(self.shape[axis], self.device, axis=axis)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device})"


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """16x16 (256 GPUs, ``pod16x16``) or 2x16x16 (512 GPUs,
    ``pod2x16x16``): 16-way tensor parallelism over ``model``, data
    parallelism over ``data`` (and ``pod``). The names are the JAX
    package's, so the two packages' dry-run reports line up. Abstract
    unless `device` is given (the dry-run passes ``"meta"``)."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16), device)
    return Mesh(("data", "model"), (16, 16), device)


def make_mesh_for(n_devices: int, model_par: int = 1, device="cuda") -> Mesh:
    """`n_devices` shards on one device: ``data`` alone, or ``data`` x
    ``model`` with `model_par` shards on ``model``."""
    if n_devices % model_par:
        raise ValueError(f"{n_devices} shards do not split {model_par}-way")
    if model_par > 1:
        return Mesh(("data", "model"), (n_devices // model_par, model_par),
                    device)
    return Mesh(("data",), (n_devices,), device)
