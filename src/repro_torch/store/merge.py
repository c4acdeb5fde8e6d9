"""The mutable store's merged index views, built on the store's device.

One index of a ``MutableTripleStore`` is a sorted unique base (the last
compaction) and a sorted unique overlay (the ingests since), disjoint by
RDF set semantics. Its views are

  * the shard rows: ``(num_shards, base_cap + ovl_cap)``, row ``k`` the
    sorted union of base shard ``k`` (``build_store``'s equal slices) and
    the overlay keys routed to it (``side="left"`` against the base's
    region boundaries), ``INF_KEY``-padded; with the rows' region
    boundaries and counts;
  * the flat view: the whole union ascending, with one ``INF_KEY`` tail,
    as long as the rows together.

Two disjoint sorted arrays merge without a sort: base key ``i`` lands at
``i + rank(overlay, base[i])`` and overlay key ``j`` at
``j + rank(base, overlay[j])``, where ``rank`` is the left rank that the
hand-written searchsorted kernel computes (``kernels.ops.searchsorted``;
its plain version on a CPU tensor). Because routing keeps every overlay
key of shard ``k`` inside that shard's base region, the rows are
consecutive slices of that one merge: row ``k`` starts where rows
``0 .. k-1`` end.

The results equal the JAX package's numpy merge (``_merge_index`` and the
``flat_keys`` override of ``repro.store.mutable``) bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.planner import quantize_cap
from repro_torch.core.rdf import INF_KEY
from repro_torch.core.triple_store import _shard_sorted
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class BaseLayout:
    """``build_store``'s layout of one index's base: the shard capacity,
    region boundaries and counts of ``triple_store._shard_sorted``."""
    cap: int              # keys a base shard holds
    splits: np.ndarray    # (S + 1,) region boundaries, splits[0] = -1
    counts: np.ndarray    # (S,) base keys per shard


def base_layout(keys: np.ndarray, num_shards: int) -> BaseLayout:
    """The layout of sorted unique `keys` cut into `num_shards` equal
    shards."""
    padded, splits, counts = _shard_sorted(keys, num_shards)
    return BaseLayout(padded.shape[1], splits, counts)


def route_counts(overlay: np.ndarray, layout: BaseLayout) -> np.ndarray:
    """Overlay keys per shard: each key goes to the shard whose base
    region covers it (the first boundary at or above it)."""
    s = len(layout.counts)
    if len(overlay) == 0:
        return np.zeros(s, np.int64)
    assign = np.searchsorted(layout.splits[1:s], overlay, side="left")
    return np.bincount(assign, minlength=s).astype(np.int64)


def merge_disjoint(out: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor) -> None:
    """Write the union of sorted, mutually disjoint unique `a` and `b`
    into ``out[:len(a) + len(b)]`` (all three on one device): two
    rank-finds and two scatters; a copy when either side is empty."""
    na, nb = a.numel(), b.numel()
    if nb == 0 or na == 0:
        out[:na + nb] = a if nb == 0 else b
        return
    pos_a = ops.searchsorted(b, a).add_(torch.arange(na, device=a.device))
    pos_b = ops.searchsorted(a, b).add_(torch.arange(nb, device=b.device))
    out.index_copy_(0, pos_a, a)
    out.index_copy_(0, pos_b, b)


def merge_index(base: torch.Tensor, layout: BaseLayout,
                overlay: np.ndarray):
    """One index's views from its base (on the device, sorted unique,
    laid out as `layout`) and its overlay (on the host, sorted unique,
    disjoint from the base), built on the base's device.

    Returns ``(rows, splits, counts, flat)``: rows (S, base_cap + ovl_cap),
    splits (S + 1,), counts (S,) and the flat view (S * (base_cap +
    ovl_cap),), all int64; with one shard the flat view is the row."""
    dev = base.device
    s = len(layout.counts)
    ov_counts = route_counts(overlay, layout)
    # overlay headroom on the planner's capacity grid: the row width
    # changes only on grid steps
    width = layout.cap + quantize_cap(max(int(ov_counts.max()), 1))
    lens = layout.counts + ov_counts
    flat = torch.full((s * width,), INF_KEY, dtype=torch.int64, device=dev)
    merge_disjoint(flat, base, torch.from_numpy(overlay).to(dev))
    if s == 1:
        rows = flat.view(1, width)
    else:
        rows = torch.full((s, width), INF_KEY, dtype=torch.int64, device=dev)
        start = 0
        for k, n in enumerate(lens.tolist()):
            rows[k, :n] = flat[start:start + n]
            start += n
    # boundary k + 1 is the last key of row k, or of the nearest non-empty
    # row before it (-1 when there is none); boundary S is INF_KEY
    ends = np.maximum.accumulate(np.where(lens > 0, np.cumsum(lens), 0))[:-1]
    last = flat[torch.as_tensor(np.maximum(ends - 1, 0), device=dev)]
    splits = torch.cat([
        torch.tensor([-1], dtype=torch.int64, device=dev),
        torch.where(torch.as_tensor(ends > 0, device=dev), last, -1),
        torch.tensor([INF_KEY], dtype=torch.int64, device=dev)])
    counts = torch.as_tensor(lens, dtype=torch.int64, device=dev)
    return rows, splits, counts, flat
