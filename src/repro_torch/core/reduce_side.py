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
from repro_torch.core.mapsin import Bindings, scan_pattern
from repro_torch.core.plan import make_plan
from repro_torch.kernels import ops

_INT32_MAX = 2 ** 31 - 1


def sort_merge_join(lt, lv, rt, rv, lkey_col: int, rkey_col: int,
                    extra_eq: list[tuple[int, int]], r_out_cols: list[int],
                    probe_cap: int, out_cap: int, found: list | None = None,
                    impl: str = "kernel"):
    """Local equi-join of two fixed-capacity row tables on one key column.

    Returns (table, valid, dropped) with columns = left cols + r_out_cols.
    The sort is stable, so equal keys keep their row order. The merge
    after it is one ``ops.sort_merge_compact``: on the card, each left
    row's matches counted, scanned and written, with no (L, probe_cap)
    grid. When `found` is a list, it gets (over, L * probe_cap, out_cap)
    appended, as ``compact`` (mapsin.py) appends it over that grid.
    """
    rkey = torch.where(rv, rt[:, rkey_col], _INT32_MAX)
    order = torch.argsort(rkey, stable=True)
    rks, rts, rvs = rkey[order], rt[order], rv[order]
    table, vmask, dropped, over = ops.sort_merge_compact(
        rks, rts, rvs, lt, lv, lkey_col, extra_eq, r_out_cols, probe_cap,
        out_cap, impl)
    if found is not None:
        found.append((over, lt.shape[0] * probe_cap, out_cap))
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
        lt, lv, rt, rv, lcol, rcol, extra_eq, r_out, probe_cap, out_cap,
        impl=impl)
    overflow = bnd.overflow + rel.overflow + dl + dr + dropped
    return Bindings(new_vars, table, vmask, overflow)


def local_reduce_step(bnd: Bindings, pattern, keys, scan_cap: int,
                      probe_cap: int, out_cap: int,
                      impl: str = "kernel",
                      found: list | None = None) -> Bindings:
    """Single-shard reduce-side join (no shuffle — functional baseline).
    `found` goes to ``sort_merge_join``."""
    rel = scan_pattern(pattern, keys, scan_cap, impl)
    lcol, rcol, extra_eq, r_out, new_vars = _join_columns(bnd, rel, pattern)
    table, vmask, dropped = sort_merge_join(
        bnd.table, bnd.valid, rel.table, rel.valid, lcol, rcol, extra_eq,
        r_out, probe_cap, out_cap, found, impl)
    return Bindings(new_vars, table, vmask, bnd.overflow + rel.overflow + dropped)
