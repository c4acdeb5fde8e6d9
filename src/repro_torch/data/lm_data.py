"""Deterministic, stateless synthetic LM data pipeline.

Tokens are a pure function of (seed, step, row, position) via a counter-mode
integer hash — no files, no iterator state. That makes fault-tolerant
restart trivial (re-derive any batch from the step index, bit-exact) and
lets every data-parallel host slice exactly its rows with zero coordination.
A Zipf-ish transform keeps the token histogram realistic so vocab-sharded
embedding paths (MAPSIN lookups) see skewed traffic like real text.

A copy of the JAX package's ``repro.data.lm_data`` (numpy only): the same
seed, step and rows give the same tokens, bit for bit, in both packages.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


def _hash64(x: np.ndarray) -> np.ndarray:
    """splitmix64 — counter-mode PRNG, vectorized."""
    x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    x ^= x >> np.uint64(30)
    x = (x * np.uint64(0xBF58476D1CE4E5B9)).astype(np.uint64)
    x ^= x >> np.uint64(27)
    x = (x * np.uint64(0x94D049BB133111EB)).astype(np.uint64)
    return x ^ (x >> np.uint64(31))


def tokens_for(seed: int, step: int, rows: np.ndarray, seq_len: int,
               vocab: int) -> np.ndarray:
    """(len(rows), seq_len) int32 tokens; `rows` are global batch indices."""
    pos = np.arange(seq_len + 1, dtype=np.uint64)
    ctr = (np.uint64(seed) << np.uint64(48)) ^ (np.uint64(step) << np.uint64(24))
    grid = ctr ^ (rows.astype(np.uint64)[:, None] << np.uint64(40)) ^ pos[None]
    h = _hash64(grid)
    u = (h >> np.uint64(11)).astype(np.float64) / float(1 << 53)
    # Zipf-ish skew: id = vocab * u^3 concentrates mass on small ids
    ids = np.minimum((vocab * u ** 3).astype(np.int64), vocab - 1)
    return ids.astype(np.int32)


def batch_for_step(cfg: ModelConfig, shape: ShapeConfig, step: int,
                   seed: int = 0, rows: np.ndarray | None = None) -> dict:
    """Full (or row-sliced) batch for `step`. labels = next-token targets."""
    if rows is None:
        rows = np.arange(shape.global_batch)
    batch: dict = {}
    if cfg.family == "vlm":
        s_text = shape.seq_len - cfg.num_patches
        t = tokens_for(seed, step, rows, s_text, cfg.vocab_size)  # (b, s_text+1)
        batch["tokens"] = t[:, :-1]
        batch["labels"] = t[:, 1:].copy()
        pe = _hash64((np.uint64(seed + 7) << np.uint64(32))
                     ^ np.arange(len(rows) * cfg.num_patches * 16,
                                 dtype=np.uint64))
        pe = (pe.astype(np.float64) / 2**64 - 0.5).astype(np.float32)
        # cheap deterministic patch embeddings (stub ViT output, dim 1024)
        base = pe.reshape(len(rows), cfg.num_patches, 16)
        batch["patch_embeds"] = np.tile(base, (1, 1, 64)).astype(np.float32)
    elif cfg.family == "audio":
        k = cfg.num_codebooks
        t = np.stack([tokens_for(seed + c, step, rows, shape.seq_len,
                                 cfg.vocab_size) for c in range(k)], -1)
        batch["tokens"] = t[:, :-1]
        batch["labels"] = t[:, 1:].copy()
    else:
        t = tokens_for(seed, step, rows, shape.seq_len, cfg.vocab_size)
        batch["tokens"] = t[:, :-1]
        batch["labels"] = t[:, 1:].copy()
    return batch
