"""Meshes of region shards and their collectives: the port's counterpart of
``jax.sharding.Mesh`` + ``shard_map`` + the ``jax.lax`` collectives.

A mesh runs one per-shard body SPMD-style: ``mesh.run(body)`` calls
``body(comm)`` once for every shard and returns the bodies' results in
shard order. ``comm`` stands where the JAX package's distributed code
takes its mesh axis name:

    comm.index            jax.lax.axis_index(axis)
    comm.size             jax.lax.psum(1, axis)
    comm.all_to_all(x)    jax.lax.all_to_all(x, axis, 0, 0, tiled=True):
                          dim 0 splits into `size` equal blocks, block s
                          goes to shard s, and the received blocks are
                          concatenated in sender order
    comm.all_gather(x)    jax.lax.all_gather(x, axis): (size, *x.shape),
                          stacked in shard order
    comm.psum(x)          jax.lax.psum(x, axis)
    comm.psum_scatter(x)  jax.lax.psum_scatter(x, axis, 0, tiled=True):
                          shard `index` receives chunk `index` (dim 0) of
                          the sum

Two meshes:

* ``LocalMesh(num_shards, device)`` runs all shards in one process on one
  device, one Python thread a shard. Every collective is a rendezvous:
  each shard posts its tensor, waits at a ``threading.Barrier`` and
  reads the others' tensors on the device. All shards launch on the
  caller's current stream, so launch order orders every exchange and no
  event is needed. A shard that raises aborts the barrier, so the others
  stop at their next rendezvous, and ``run`` re-raises the first
  failure with its traceback; a rendezvous that waits longer than
  ``timeout`` seconds breaks the same way.
* ``ProcessGroupMesh(group)`` wraps a ``torch.distributed`` process
  group, one shard a rank: ``all_to_all_single``,
  ``all_gather_into_tensor``, ``all_reduce`` and
  ``reduce_scatter_tensor``. ``run`` gathers each rank's results, so
  every rank returns all shards' results as ``LocalMesh`` does.

No collective copies a tensor to the host to exchange it.
"""
from __future__ import annotations

import threading
from typing import Callable

import torch

from repro_torch.common import resolve_device

RENDEZVOUS_TIMEOUT_S = 600.0


def _mesh_device(device, caller: str) -> torch.device:
    """`device` with its index filled in ("cuda" is the current card),
    so that it compares equal to a tensor's device."""
    device = resolve_device(device, caller)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class _Rendezvous:
    """The exchange point of one ``LocalMesh.run``: a barrier and two
    slot lists used in turn. A shard can only write the slots of
    collective g + 2 after every shard has passed the barrier of g + 1,
    that is after every shard has taken its copy of collective g's
    slots, so one barrier a collective suffices."""

    def __init__(self, n: int, timeout: float):
        self.barrier = threading.Barrier(n, timeout=timeout)
        self.slots = ([None] * n, [None] * n)


class LocalComm:
    """One shard's view of a ``LocalMesh`` rendezvous."""

    def __init__(self, rv: _Rendezvous, index: int, size: int):
        self._rv = rv
        self._gen = 0
        self.index = index
        self.size = size

    def _exchange(self, x: torch.Tensor) -> list:
        """Post `x`, wait for every shard, return all posts in shard
        order."""
        slots = self._rv.slots[self._gen & 1]
        self._gen += 1
        slots[self.index] = x
        self._rv.barrier.wait()
        return list(slots)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        me, n = self.index, self.size
        return torch.cat([p.chunk(n)[me] for p in self._exchange(x)])

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        return torch.stack(self._exchange(x))

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return torch.stack(self._exchange(x)).sum(0, dtype=x.dtype)

    def psum_scatter(self, x: torch.Tensor) -> torch.Tensor:
        me, n = self.index, self.size
        return torch.stack([p.chunk(n)[me] for p in self._exchange(x)]
                           ).sum(0, dtype=x.dtype)


class LocalMesh:
    """`num_shards` region shards in this process, on one device.

    ``shape[axis]`` is the shard count, as on a JAX mesh. The shards'
    bodies run in threads of their own, created per ``run``; ``run``
    calls do not overlap (a lock orders them)."""

    def __init__(self, num_shards: int, device="cuda", axis: str = "data",
                 timeout: float = RENDEZVOUS_TIMEOUT_S):
        if num_shards < 1:
            raise ValueError("a mesh needs at least one shard")
        self.num_shards = int(num_shards)
        self.device = _mesh_device(device, "LocalMesh")
        self.axis_names = (axis,)
        self.shape = {axis: self.num_shards}
        self.timeout = timeout
        self._lock = threading.Lock()

    def fingerprint(self, axis: str) -> tuple:
        """Hashable identity for cache keys (the reference's
        ``mesh_fingerprint``): two meshes with the same fingerprint place
        the same shard on the same device, so a cascade built for one is
        valid for the other."""
        return ("local", axis, self.num_shards, str(self.device))

    def run(self, body: Callable[[LocalComm], object]) -> list:
        """``body(comm)`` for every shard, concurrently; the results in
        shard order. Re-raises the first shard failure."""
        n = self.num_shards
        rv = _Rendezvous(n, self.timeout)
        results: list = [None] * n
        errors: list = [None] * n
        cuda = self.device.type == "cuda"
        stream = torch.cuda.current_stream(self.device) if cuda else None

        def shard(i: int) -> None:
            try:
                if cuda:
                    with torch.cuda.device(self.device), \
                            torch.cuda.stream(stream):
                        results[i] = body(LocalComm(rv, i, n))
                else:
                    results[i] = body(LocalComm(rv, i, n))
            except BaseException as e:        # noqa: BLE001 — re-raised by run
                errors[i] = e
                rv.barrier.abort()

        with self._lock:
            threads = [threading.Thread(target=shard, args=(i,),
                                        name=f"shard{i}", daemon=True)
                       for i in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        failed = [e for e in errors if e is not None]
        if failed:
            # the shard that failed first, not the ones its abort broke
            first = next((e for e in failed
                          if not isinstance(e, threading.BrokenBarrierError)),
                         None)
            if first is None:
                raise TimeoutError(
                    f"LocalMesh: a rendezvous waited more than "
                    f"{self.timeout} s") from failed[0]
            raise first
        return results


class ProcessGroupComm:
    """One rank's collectives over a ``torch.distributed`` group. bool
    tensors travel as uint8 (gloo reduces and exchanges no bool)."""

    def __init__(self, group, index: int, size: int):
        self.group = group
        self.index = index
        self.size = size

    @staticmethod
    def _wire(x: torch.Tensor) -> torch.Tensor:
        return (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()

    @staticmethod
    def _back(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return y.to(torch.bool) if like.dtype == torch.bool else y

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as td
        w = self._wire(x)
        out = torch.empty_like(w)
        td.all_to_all_single(out, w, group=self.group)
        return self._back(out, x)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as td
        w = self._wire(x).reshape(-1)
        out = w.new_empty((self.size * w.numel(),))
        td.all_gather_into_tensor(out, w, group=self.group)
        return self._back(out.view((self.size,) + tuple(x.shape)), x)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as td
        out = x.clone().contiguous()
        td.all_reduce(out, group=self.group)
        return out

    def psum_scatter(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as td
        w = x.contiguous()
        out = w.new_empty((w.shape[0] // self.size,) + tuple(w.shape[1:]))
        td.reduce_scatter_tensor(out, w, group=self.group)
        return out


class ProcessGroupMesh:
    """One shard a rank of a ``torch.distributed`` process group (the
    default group when `group` is None). `device` is where the rank's
    tensors live: the current card unless the caller asks for the CPU, as
    a gloo group does."""

    def __init__(self, group=None, axis: str = "data", device="cuda"):
        import torch.distributed as td
        self.group = group
        self.size = td.get_world_size(group)
        self.rank = td.get_rank(group)
        self.device = _mesh_device(device, "ProcessGroupMesh")
        self.axis_names = (axis,)
        self.shape = {axis: self.size}

    def fingerprint(self, axis: str) -> tuple:
        import torch.distributed as td
        return ("process_group", axis, self.size, self.rank,
                str(td.get_backend(self.group)), str(self.device))

    def run(self, body: Callable[[ProcessGroupComm], object]) -> list:
        """``body(comm)`` for this rank's shard; every shard's results
        (a tensor or a tuple of tensors each), gathered in rank order."""
        comm = ProcessGroupComm(self.group, self.rank, self.size)
        out = body(comm)
        single = isinstance(out, torch.Tensor)
        parts = [comm.all_gather(t) for t in ((out,) if single else out)]
        shards = [tuple(p[s] for p in parts) for s in range(self.size)]
        return [s[0] for s in shards] if single else shards
