"""Reduce-side (repartition) join baseline — the paper's comparison point.

Per iteration the pattern's full relation is scanned (map phase), then BOTH
the accumulated solution multiset and the relation are hash-partitioned by
join key across all shards (shuffle phase — full-relation network traffic,
``dist_reduce_step``), then joined locally (reduce phase: sort-merge). This
mirrors Pig's reduce-side join that PigSPARQL uses in the paper's
evaluation; on one shard there is no shuffle (``local_reduce_step``).
"""
from __future__ import annotations

import torch

from repro_torch.core.distributed import repartition
from repro_torch.core.mapsin import Bindings, compact, scan_pattern
from repro_torch.core.plan import make_plan

_INT32_MAX = 2 ** 31 - 1


def sort_merge_join(lt, lv, rt, rv, lkey_col: int, rkey_col: int,
                    extra_eq: list[tuple[int, int]], r_out_cols: list[int],
                    probe_cap: int, out_cap: int, found: list | None = None):
    """Local equi-join of two fixed-capacity row tables on one key column.

    Returns (table, valid, dropped) with columns = left cols + r_out_cols.
    The sort is stable, so equal keys keep their row order.
    """
    dev = lt.device
    rkey = torch.where(rv, rt[:, rkey_col], _INT32_MAX)
    order = torch.argsort(rkey, stable=True)
    rks, rts, rvs = rkey[order], rt[order], rv[order]
    lkey = lt[:, lkey_col].contiguous()
    lo = torch.searchsorted(rks, lkey)
    hi = torch.searchsorted(rks, lkey, right=True)
    idx = lo[:, None] + torch.arange(probe_cap, device=dev)[None]
    m = rks.shape[0]
    take = idx.clamp(max=m - 1)
    match = (idx < hi[:, None]) & lv[:, None] & rvs[take]
    missed = (hi - lo - probe_cap).clamp(min=0)
    rrows = rts[take]                                    # (L, cap, nvr)
    for la, ra in extra_eq:
        match = match & (lt[:, la][:, None] == rrows[..., ra])
    lrows = lt[:, None, :].expand(lt.shape[0], probe_cap, lt.shape[1])
    cols = [lrows] + [rrows[..., c][..., None] for c in r_out_cols]
    rows = torch.cat(cols, dim=-1).reshape(lt.shape[0] * probe_cap, -1)
    table, vmask, dropped = compact(rows, match.reshape(-1), out_cap,
                                    found=found)
    dropped = dropped + torch.where(lv, missed, 0).sum().to(torch.int32)
    return table, vmask, dropped


def _join_columns(bnd: Bindings, rel: Bindings, pattern):
    """(lcol, rcol, extra_eq, r_out, new_vars) of a reduce-side join of
    `bnd` with the scanned relation `rel` of `pattern`, on their first
    shared variable."""
    plan = make_plan(pattern, bnd.vars)
    shared = [v for v in plan.pattern.variables if v in bnd.vars]
    if not shared:
        raise ValueError("reduce-side join requires a shared variable")
    jvar = shared[0]
    extra_eq = [(bnd.vars.index(v), rel.vars.index(v)) for v in shared[1:]]
    r_out = [i for i, v in enumerate(rel.vars) if v not in bnd.vars]
    new_vars = bnd.vars + tuple(v for v in rel.vars if v not in bnd.vars)
    return (bnd.vars.index(jvar), rel.vars.index(jvar), extra_eq, r_out,
            new_vars)


def dist_reduce_step(bnd: Bindings, pattern, local_keys, scan_cap: int,
                     bucket_cap: int, probe_cap: int, out_cap: int,
                     comm, impl: str = "kernel") -> Bindings:
    """One reduce-side join iteration on a mesh (shuffle both sides, join
    in 'reduce'); `comm` is this shard's communicator."""
    rel = scan_pattern(pattern, local_keys, scan_cap, impl)
    lcol, rcol, extra_eq, r_out, new_vars = _join_columns(bnd, rel, pattern)
    # ---- shuffle phase: both relations cross the network ----
    lt, lv, dl = repartition(bnd.table, bnd.valid, bnd.table[:, lcol],
                             bucket_cap, comm)
    rt, rv, dr = repartition(rel.table, rel.valid, rel.table[:, rcol],
                             bucket_cap, comm)
    # ---- reduce phase: local sort-merge join ----
    table, vmask, dropped = sort_merge_join(
        lt, lv, rt, rv, lcol, rcol, extra_eq, r_out, probe_cap, out_cap)
    overflow = bnd.overflow + rel.overflow + dl + dr + dropped
    return Bindings(new_vars, table, vmask, overflow)


def local_reduce_step(bnd: Bindings, pattern, keys, scan_cap: int,
                      probe_cap: int, out_cap: int,
                      impl: str = "kernel",
                      found: list | None = None) -> Bindings:
    """Single-shard reduce-side join (no shuffle — functional baseline).
    `found` goes to the join's ``compact`` (mapsin.py)."""
    rel = scan_pattern(pattern, keys, scan_cap, impl)
    lcol, rcol, extra_eq, r_out, new_vars = _join_columns(bnd, rel, pattern)
    table, vmask, dropped = sort_merge_join(
        bnd.table, bnd.valid, rel.table, rel.valid, lcol, rcol, extra_eq,
        r_out, probe_cap, out_cap, found)
    return Bindings(new_vars, table, vmask, bnd.overflow + rel.overflow + dropped)
