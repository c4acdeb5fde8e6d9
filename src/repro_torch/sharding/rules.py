"""Logical-axis -> mesh-axis sharding rules (DP / FSDP / TP / EP).

A copy of the JAX package's ``sharding/rules.py`` (the port imports
nothing of that package). Every parameter and activation is annotated with
*logical* axis names; a ``Rules`` object (built per mesh + model) resolves
them to a ``PartitionSpec``. The same model code serves 1 device, a 16x16
layout or the 2x16x16 one.

Axis vocabulary
  batch      activation batch            -> (pod, data)
  seq        sequence                    -> () (context-parallel variant: model)
  embed      activation hidden dim       -> ()
  heads      attention query heads       -> model
  kv_heads   attention kv heads          -> model (or () in head_dim mode)
  head_dim   per-head dim                -> () (or model in head_dim mode)
  mlp        FFN hidden                  -> model
  vocab      vocabulary                  -> model
  experts    MoE experts (EP)            -> model
  fsdp       parameter shard dim (ZeRO)  -> data (+pod if fsdp_pod)
  layers     stacked layer dim           -> ()
  lru        RG-LRU width                -> model
  inner      xLSTM inner dim             -> model
  window     local-attention window      -> ()
  kv_lora/q_lora/rope  MLA compressed dims -> ()

The port's counterparts of JAX's sharding types live here too:
``PartitionSpec`` (entries ``None``, an axis name or a tuple of names),
``NamedSharding`` (a mesh and a spec: a leaf's per-shard block shape, and
how to cut a tensor into one block per mesh position and put the blocks
back together) and ``ShardedTensor`` (a tensor held as those blocks).
"""
from __future__ import annotations

import dataclasses
import itertools
import math

import torch

from repro_torch.common import ceil_div
from repro_torch.launch.mesh import Mesh


class PartitionSpec(tuple):
    """One entry a dim: None (replicated), a mesh axis name, or a tuple of
    names (the dim split over their product, the first name major). Dims
    past the spec's length are replicated."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    mesh: Mesh
    spec: PartitionSpec

    def dim_axes(self, ndim: int) -> list[tuple[str, ...]]:
        """The mesh axes each of `ndim` dims is split over."""
        parts = tuple(self.spec) + (None,) * (ndim - len(self.spec))
        if len(parts) > ndim:
            raise ValueError(f"spec {self.spec} has more entries than {ndim} dims")
        return [() if sp is None else (sp,) if isinstance(sp, str) else tuple(sp)
                for sp in parts]

    def shard_shape(self, shape) -> tuple[int, ...]:
        """One block's shape: ceil division per sharded dim (the last
        blocks are padded, as GSPMD pads)."""
        return tuple(ceil_div(n, math.prod(self.mesh.shape[a] for a in axes))
                     for n, axes in zip(shape, self.dim_axes(len(shape))))

    def positions(self) -> list[dict[str, int]]:
        """Every mesh position's coordinates, row-major over the axes."""
        names = self.mesh.axis_names
        return [dict(zip(names, c)) for c in itertools.product(
            *(range(self.mesh.shape[a]) for a in names))]

    def _block_slices(self, shape, pos: dict[str, int]) -> tuple[slice, ...]:
        block = self.shard_shape(shape)
        out = []
        for n, b, axes in zip(shape, block, self.dim_axes(len(shape))):
            i = 0
            for a in axes:
                i = i * self.mesh.shape[a] + pos[a]
            out.append(slice(min(i * b, n), min((i + 1) * b, n)))
        return tuple(out)

    def shard(self, x: torch.Tensor) -> "ShardedTensor":
        """`x` cut into one block a mesh position (row-major), each a
        contiguous tensor on the mesh's device (the tensor's own when the
        mesh has none), padded with zeros to `shard_shape`."""
        device = self.mesh.device or x.device
        block = self.shard_shape(x.shape)
        blocks = []
        for pos in self.positions():
            part = x[self._block_slices(x.shape, pos)]
            if tuple(part.shape) == block:
                blocks.append(part.to(device, copy=True).contiguous())
                continue
            b = torch.zeros(block, dtype=x.dtype, device=device)
            b[tuple(slice(0, n) for n in part.shape)] = part.to(device)
            blocks.append(b)
        return ShardedTensor(self, tuple(x.shape), blocks)

    def unshard(self, blocks, shape) -> torch.Tensor:
        """The global tensor of `shape` that `blocks` (one a position, as
        `shard` cut them) hold, without the padding."""
        out = torch.empty(tuple(shape), dtype=blocks[0].dtype,
                          device=blocks[0].device)
        for pos, b in zip(self.positions(), blocks):
            where = self._block_slices(shape, pos)
            out[where] = b[tuple(slice(0, s.stop - s.start) for s in where)]
        return out


@dataclasses.dataclass
class ShardedTensor:
    """A global tensor of `shape` held as one block a mesh position of
    `sharding` (the port's counterpart of a sharded ``jax.Array``)."""
    sharding: NamedSharding
    shape: tuple[int, ...]
    blocks: list[torch.Tensor]

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    @property
    def device(self) -> torch.device:
        return self.blocks[0].device

    def full(self) -> torch.Tensor:
        return self.sharding.unshard(self.blocks, self.shape)


@dataclasses.dataclass
class Rules:
    mesh: Mesh
    fsdp: bool = True
    fsdp_pod: bool = False       # also shard params over the pod axis
    kv_mode: str = "kv_heads"    # kv_heads | head_dim  (see choose_kv_mode)
    shard_batch: bool = True     # False for global_batch < data axis (long_500k)
    seq_shard: bool = False      # context parallelism over the model axis
    serve: bool = False          # inference: no FSDP (weights stream per step)
    num_experts: int = 0         # EP across (data x model) when experts allow
    dp_heavy: bool = False       # small models: no TP — batch over ALL axes
    wide_mlp_serve: bool = False  # serve: shard d_ff over data x model

    def __post_init__(self):
        axes = self.mesh.axis_names
        model = ("model",) if "model" in axes else ()
        data = ("data",) if "data" in axes else ()
        pod = ("pod",) if "pod" in axes else ()
        if self.dp_heavy:
            # small models waste the interconnect on TP combines: the
            # model axis becomes extra data parallelism
            batch = (pod + data + model) if self.shard_batch else ()
            model = ()
        else:
            batch = (pod + data) if self.shard_batch else ()
        if self.serve:
            fsdp = ()  # inference never gathers FSDP shards per step
        else:
            fsdp = (pod + data) if (self.fsdp and self.fsdp_pod) else data if self.fsdp else ()
        # expert parallelism: spread experts over as many axes as divide the
        # expert count (EP weights never move, only routed tokens do)
        ep = ()
        for cand in (data + model, data, model):
            n = math.prod(self.mesh.shape[a] for a in cand)
            if cand and self.num_experts and self.num_experts % max(n, 1) == 0:
                ep = cand
                break
        mlp = (data + model) if (self.serve and self.wide_mlp_serve) else model
        kv_on_heads = self.kv_mode == "kv_heads"
        self._map: dict[str | None, tuple[str, ...]] = {
            None: (), "layers": (), "stack": (), "window": (),
            "batch": batch,
            "seq": model if self.seq_shard else (),
            # remat-saved layer inputs: always sequence-sharded over `model`
            "seq_ckpt": model,
            "embed": (),
            "heads": model if kv_on_heads else (),
            "kv_heads": model if kv_on_heads else (),
            "head_dim": () if kv_on_heads else model,
            "mlp": mlp,
            "vocab": model,
            "experts": ep,
            # MLA latent KV cache: the sequence dim over `model`
            "seq_kv": model,
            "fsdp": fsdp,
            "lru": model,
            "inner": model,
            "kv_lora": (), "q_lora": (), "rope": (),
            # MoE per-expert buffers: capacity dim shards over the DP axes
            "capacity": batch,
        }

    def pspec(self, *axes: str | None) -> PartitionSpec:
        parts = []
        used: set[str] = set()
        for a in axes:
            mesh_axes = tuple(m for m in self._map[a] if m not in used)
            used.update(mesh_axes)
            if len(mesh_axes) == 0:
                parts.append(None)
            elif len(mesh_axes) == 1:
                parts.append(mesh_axes[0])
            else:
                parts.append(mesh_axes)
        return PartitionSpec(*parts)

    def sharding(self, *axes: str | None) -> NamedSharding:
        return NamedSharding(self.mesh, self.pspec(*axes))


def choose_kv_mode(num_kv_heads: int, mesh: Mesh) -> str:
    """Shard kv heads over `model` when divisible; otherwise shard head_dim.

    GQA models with few kv heads (kv=1..8) cannot split kv 16-way; sharding
    head_dim instead keeps every shard busy at the cost of an all-reduce
    over the contracted dim in attention.
    """
    if "model" not in mesh.axis_names:
        return "kv_heads"
    msize = mesh.shape["model"]
    return "kv_heads" if num_kv_heads % msize == 0 else "head_dim"


def make_rules(mesh: Mesh, cfg=None, shape=None, **overrides) -> Rules:
    kw: dict = {}
    if cfg is not None:
        kw["kv_mode"] = choose_kv_mode(cfg.num_kv_heads, mesh)
        kw["num_experts"] = cfg.num_experts
    if shape is not None and "data" in mesh.axis_names:
        dp = mesh.shape["data"] * mesh.shape.get("pod", 1)
        kw["shard_batch"] = shape.global_batch >= dp
        kw["serve"] = shape.kind != "train"
    if cfg is not None and "pod" in mesh.axis_names:
        # very large models: FSDP over pod axis too (memory floor)
        kw["fsdp_pod"] = cfg.n_params() > 100e9
    kw.update(overrides)
    return Rules(mesh, **kw)


def single_device_mesh(device="cuda") -> Mesh:
    return Mesh(("data",), (1,), device)
