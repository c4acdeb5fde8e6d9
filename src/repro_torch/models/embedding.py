"""Token embedding lookups.

On one device the JAX package's ``mapsin`` lookup (the vocab-sharded
table answering token-id GETs) is the dense gather, so ``impl="mapsin"``
maps to it here; the sharded form belongs to the distributed slice.

An id >= the vocabulary differs: the JAX package's ``jnp.take`` fills its
row with NaN, where indexing raises ``IndexError`` (a device-side assert
on a card); ids come from the tokenizer's range. Both wrap -1 to the last
row.
"""
from __future__ import annotations

import torch


def dense_embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def embed(table: torch.Tensor, tokens: torch.Tensor, impl: str) -> torch.Tensor:
    if impl not in ("dense", "mapsin"):
        raise ValueError(f"embedding_impl must be 'dense' or 'mapsin', got {impl!r}")
    return dense_embed(table, tokens)
