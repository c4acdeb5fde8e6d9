"""Sharded sorted triple store — the HBase analogue.

Two indexes mirror the paper's two-table schema:
  T_spo — composite keys sorted by (s, p, o)   [row key = subject]
  T_ops — composite keys sorted by (o, p, s)   [row key = object]

Each index is range-partitioned into `num_shards` equal slices (region
boundaries on the full composite key), padded to equal length with INF
keys. The key tensors live on the store's device; every downstream
operation takes its device from them.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.common import ceil_div, resolve_device
from repro_torch.core.rdf import INF_KEY, pack3
from repro_torch.obs.trace import Tracer, optional_span

SPO, OPS = 0, 1  # index ids (paper Table 3 chooses between them per pattern)

PLAN_CACHE_SIZE = 512  # default plan_cache bound (entries, not bytes)


class LRUCache(OrderedDict):
    """Dict with least-recently-used eviction — bounds the per-store
    plan/cascade cache so a many-tenant query stream can't grow host
    memory forever. Reads refresh recency; writes evict the coldest entry
    once `maxsize` is exceeded."""

    def __init__(self, maxsize: int = PLAN_CACHE_SIZE):
        super().__init__()
        if maxsize < 1:
            raise ValueError("LRUCache needs maxsize >= 1")
        self.maxsize = maxsize

    def __getitem__(self, key):
        val = super().__getitem__(key)
        self.move_to_end(key)
        return val

    def get(self, key, default=None):
        if key in self:
            return self[key]
        return default

    def __setitem__(self, key, val):
        super().__setitem__(key, val)
        self.move_to_end(key)
        while len(self) > self.maxsize:
            del self[next(iter(self))]    # coldest (front) entry


@dataclasses.dataclass
class TripleStore:
    # (num_shards, shard_cap) int64, sorted ascending within & across shards
    keys_spo: torch.Tensor
    keys_ops: torch.Tensor
    # (num_shards + 1,) int64 region boundaries (splits[0] = -1)
    splits_spo: torch.Tensor
    splits_ops: torch.Tensor
    counts_spo: torch.Tensor  # (num_shards,) valid entries per shard
    counts_ops: torch.Tensor
    n_triples: int
    # mutation counter: part of layout_key, so every cache keyed on the
    # store misses after a mutation
    store_version: int = 0
    # host-side memo: flattened keys, host key copies, statistics, plans
    # and cascade closures keyed by (plan, cfg); LRU-bounded
    plan_cache: LRUCache = dataclasses.field(
        default_factory=LRUCache, repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.keys_spo.device

    @property
    def num_shards(self) -> int:
        return self.keys_spo.shape[0]

    @property
    def shard_cap(self) -> int:
        return self.keys_spo.shape[1]

    def keys(self, index: int) -> torch.Tensor:
        return self.keys_spo if index == SPO else self.keys_ops

    def flat_keys(self, index: int) -> torch.Tensor:
        key = ("flat_keys", index)
        if key not in self.plan_cache:
            self.plan_cache[key] = self.keys(index).reshape(-1)
        return self.plan_cache[key]

    def splits(self, index: int) -> torch.Tensor:
        return self.splits_spo if index == SPO else self.splits_ops

    @property
    def layout_key(self) -> tuple:
        """Hashable shard-layout identity: ``store_version`` + shard shape
        + the region boundaries of both indexes. Any cache keyed on the
        store includes this, so rebuilding, resharding or mutating the
        store can never reuse a stale plan."""
        ck = ("layout_key",)
        if ck not in self.plan_cache:
            self.plan_cache[ck] = (
                self.store_version,
                self.num_shards, self.shard_cap, self.n_triples,
                tuple(int(x) for x in self.splits_spo.cpu().tolist()),
                tuple(int(x) for x in self.splits_ops.cpu().tolist()))
        return self.plan_cache[ck]

    def bump_version(self) -> int:
        """Mutation barrier: advance ``store_version`` and drop every
        memoized artifact in ``plan_cache`` (key views, host copies,
        statistics, plans, cascades) — all derived from pre-mutation keys."""
        self.store_version += 1
        self.plan_cache.clear()
        return self.store_version

    def storage_bytes(self) -> int:
        return int(self.keys_spo.numel() + self.keys_ops.numel()) * 8


def range_intersects_region(lo, hi, excl_lo, incl_hi):
    """Does probe range [lo, hi) intersect region (excl_lo, incl_hi]?

    Exact, because store keys are unique and globally sorted: the range
    misses the region iff lo > incl_hi or hi <= excl_lo + 1. Works
    elementwise on numpy arrays or tensors."""
    return (lo <= incl_hi) & (hi > excl_lo + 1)


def _shard_sorted(keys: np.ndarray, num_shards: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Split a sorted key array into equal shards; return (padded, splits, counts)."""
    n = len(keys)
    cap = max(ceil_div(n, num_shards), 1)
    padded = np.full((num_shards, cap), INF_KEY, np.int64)
    splits = np.empty(num_shards + 1, np.int64)
    counts = np.zeros(num_shards, np.int64)
    splits[0] = np.int64(-1)
    for k in range(num_shards):
        lo, hi = k * cap, min((k + 1) * cap, n)
        cnt = max(hi - lo, 0)
        if cnt > 0:
            padded[k, :cnt] = keys[lo:hi]
        counts[k] = cnt
        splits[k + 1] = keys[hi - 1] if cnt > 0 else splits[k]
    splits[num_shards] = INF_KEY
    return padded, splits, counts


def store_from_numpy(keys_spo, keys_ops, splits_spo, splits_ops, counts_spo,
                     counts_ops, n_triples: int, store_version: int = 0,
                     device="cuda") -> TripleStore:
    """A store from index arrays held as numpy (for example another
    implementation's store, so both run over the same index)."""
    device = resolve_device(device, "build_store")
    t = lambda a: torch.tensor(np.asarray(a, np.int64), device=device)
    return TripleStore(
        keys_spo=t(keys_spo), keys_ops=t(keys_ops),
        splits_spo=t(splits_spo), splits_ops=t(splits_ops),
        counts_spo=t(counts_spo), counts_ops=t(counts_ops),
        n_triples=int(n_triples), store_version=int(store_version))


def build_store(triples: np.ndarray, num_shards: int = 1,
                device="cuda", tracer: Tracer | None = None) -> TripleStore:
    """triples: (N, 3) int32. Bulk load (the paper's Table 4 operation).
    The index tensors go to `device`; the default is the card, and asking
    for it on a host without CUDA raises. With a `tracer`, the load is a
    ``store.build`` span over ``store.sort`` (packing and sorting both
    orders on the host), ``store.dedup`` and ``store.upload`` (the
    shards' padding and the copy to `device`)."""
    device = resolve_device(device, "build_store")
    with optional_span(tracer, "store.build", triples=len(triples)):
        with optional_span(tracer, "store.sort"):
            s, p, o = triples[:, 0], triples[:, 1], triples[:, 2]
            k_spo = np.sort(pack3(s, p, o))
            k_ops = np.sort(pack3(o, p, s))
        if len(k_spo) and k_spo[-1] == INF_KEY:
            # (MAX_ID, MAX_ID, MAX_ID) packs to the INF_KEY padding
            # sentinel: indistinguishable from padding and unfindable. The
            # Dictionary reserves id MAX_ID so encoded data can never hit
            # this.
            raise ValueError("triple (MAX_ID, MAX_ID, MAX_ID) packs to the "
                             "INF_KEY sentinel and cannot be stored")
        with optional_span(tracer, "store.dedup"):   # RDF set semantics
            k_spo = np.unique(k_spo)
            k_ops = np.unique(k_ops)
        with optional_span(tracer, "store.upload"):
            spo, sp_splits, sp_counts = _shard_sorted(k_spo, num_shards)
            ops, op_splits, op_counts = _shard_sorted(k_ops, num_shards)
            return store_from_numpy(spo, ops, sp_splits, op_splits,
                                    sp_counts, op_counts, len(k_spo),
                                    device=device)
