"""Reduce-side (repartition) join baseline — the paper's comparison point.

Per iteration the pattern's full relation is scanned (map phase), then the
accumulated solution multiset and the relation are joined locally by
sort-merge (reduce phase). This mirrors Pig's reduce-side join that
PigSPARQL uses in the paper's evaluation; on one shard there is no shuffle.
"""
from __future__ import annotations

import torch

from repro_torch.core.mapsin import Bindings, compact, scan_pattern
from repro_torch.core.plan import make_plan

_INT32_MAX = 2 ** 31 - 1


def sort_merge_join(lt, lv, rt, rv, lkey_col: int, rkey_col: int,
                    extra_eq: list[tuple[int, int]], r_out_cols: list[int],
                    probe_cap: int, out_cap: int):
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
    table, vmask, dropped = compact(rows, match.reshape(-1), out_cap)
    dropped = dropped + torch.where(lv, missed, 0).sum().to(torch.int32)
    return table, vmask, dropped


def local_reduce_step(bnd: Bindings, pattern, keys, scan_cap: int,
                      probe_cap: int, out_cap: int,
                      impl: str = "kernel") -> Bindings:
    """Single-shard reduce-side join (no shuffle — functional baseline)."""
    plan = make_plan(pattern, bnd.vars)
    rel = scan_pattern(pattern, keys, scan_cap, impl)
    shared = [v for v in plan.pattern.variables if v in bnd.vars]
    if not shared:
        raise ValueError("reduce-side join requires a shared variable")
    jvar = shared[0]
    lcol = bnd.vars.index(jvar)
    rcol = rel.vars.index(jvar)
    extra_eq = [(bnd.vars.index(v), rel.vars.index(v)) for v in shared[1:]]
    r_out = [i for i, v in enumerate(rel.vars) if v not in bnd.vars]
    table, vmask, dropped = sort_merge_join(
        bnd.table, bnd.valid, rel.table, rel.valid, lcol, rcol, extra_eq,
        r_out, probe_cap, out_cap)
    new_vars = bnd.vars + tuple(v for v in rel.vars if v not in bnd.vars)
    return Bindings(new_vars, table, vmask, bnd.overflow + rel.overflow + dropped)
