"""Token embedding lookups.

`mapsin` path: the paper's technique as an LM feature. The table is
vocab-sharded over the mesh's `model` axis (a distributed sorted index,
row key = token id); each shard answers the ids in its own range and a
psum routes only the resolved rows back, instead of gathering the table:
the map-side index nested-loop join's economy applied to embeddings. The
shards run through ``core/collectives.py`` (one thread a shard on a
``LocalMesh``, one rank a shard on a ``ProcessGroupMesh``). Without a mesh,
without a `model` axis, or with a vocabulary that does not split evenly
over it, the lookup is the dense gather, as in the JAX package.

An id >= the vocabulary differs: the JAX package's dense ``jnp.take``
fills its row with NaN, where indexing raises ``IndexError`` (a
device-side assert on a card); ids come from the tokenizer's range. Both
wrap -1 to the last row. The mapsin lookup gives such ids (and -1) a row
of zeros in both packages: no shard owns them.
"""
from __future__ import annotations

import torch


def dense_embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def mapsin_embed(table: torch.Tensor, tokens: torch.Tensor, mesh,
                 rules=None) -> torch.Tensor:
    """table: (v, d); tokens: any shape of ids. `mesh` is a
    ``launch.mesh.Mesh`` (its `model` axis runs the shards) or a one-axis
    ``LocalMesh``/``ProcessGroupMesh`` named `model`.

    Shard i holds rows [i * v/m, (i+1) * v/m): it gathers the ids that fall
    in its range (an HBase-region GET against its sorted local index), zeros
    the rest, and the psum over `model` sums the shards' rows. The gradient
    flows from the psum back into each shard's rows of the table."""
    if mesh is None or "model" not in mesh.axis_names:
        return dense_embed(table, tokens)
    msize = mesh.shape["model"]
    v = table.shape[0]
    if v % msize:
        return dense_embed(table, tokens)
    vloc = v // msize
    shards = table.split(vloc)
    runner = mesh.axis_mesh("model") if hasattr(mesh, "axis_mesh") else mesh
    # grad and inference mode are thread-local: the shards' threads take
    # the caller's, or a lookup under no_grad would record a graph
    grad = torch.is_grad_enabled()
    inference = torch.is_inference_mode_enabled()

    def body(comm):
        with torch.inference_mode(inference), torch.set_grad_enabled(grad):
            local = tokens - comm.index * vloc
            hit = (local >= 0) & (local < vloc)
            rows = dense_embed(shards[comm.index], local.clamp(0, vloc - 1))
            rows = rows * hit[..., None].to(rows.dtype)
            return comm.psum(rows)

    return runner.run(body)[0]


def embed(table: torch.Tensor, tokens: torch.Tensor, impl: str, mesh=None,
          rules=None) -> torch.Tensor:
    if impl == "mapsin":
        return mapsin_embed(table, tokens, mesh, rules)
    if impl != "dense":
        raise ValueError(f"embedding_impl must be 'dense' or 'mapsin', got {impl!r}")
    return dense_embed(table, tokens)
