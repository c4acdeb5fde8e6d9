"""MAPSIN join — map-side index nested-loop join (paper §4), local primitives.

Everything here operates on one shard's data with static shapes:
  * ``Bindings`` — a fixed-capacity multiset of solution mappings
    (capacity + validity mask + overflow counter; overflow is surfaced,
    never silent).
  * ``scan_pattern``    — the distributed-table-scan input phase (§4.1)
  * ``probe``           — the index GET: binary-search range + gather + filter
  * ``mapsin_step``     — Algorithm 1 (one cascading iteration)
  * ``multiway_step``   — Algorithms 2+3 (star joins, single row-GET)

No function here syncs the host: every count stays a device tensor, and
``compact`` is gather-formulated (no ``nonzero``, no boolean indexing).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.core.plan import (PatternPlan, filter_columns, make_plan,
                                   probe_ranges, residual_values, row_range)
from repro_torch.core.rdf import unpack3
from repro_torch.kernels import ops


@dataclasses.dataclass
class Bindings:
    """Fixed-capacity multiset of solution mappings Omega."""
    vars: tuple[str, ...]
    table: torch.Tensor            # (cap, n_vars) int32
    valid: torch.Tensor            # (cap,) bool
    overflow: torch.Tensor         # () int32 — dropped rows (capacity misses)
    # (n_steps,) cumulative overflow after each cascade step; set by
    # core/bgp.py execute_local
    step_overflow: torch.Tensor | None = None

    @property
    def capacity(self) -> int:
        return self.table.shape[0]

    def count(self) -> torch.Tensor:
        return self.valid.sum(dtype=torch.int32)

    @classmethod
    def empty(cls, vars: Sequence[str], cap: int, device) -> "Bindings":
        return cls(tuple(vars),
                   torch.zeros((cap, len(vars)), dtype=torch.int32, device=device),
                   torch.zeros((cap,), dtype=torch.bool, device=device),
                   torch.zeros((), dtype=torch.int32, device=device))


def compact(rows: torch.Tensor, valid: torch.Tensor, out_cap: int,
            buf: torch.Tensor | None = None):
    """Pack valid rows (N, nv) to the front of a (out_cap, nv) buffer.

    Returns (table, valid_mask, n_dropped int32). When `buf` (a zeroed
    (out_cap, nv) tensor) is given, it supplies the padding slots.

    Gather-formulated: the running count c = cumsum(valid) is
    non-decreasing, so the source row of output slot p (the (p+1)-th valid
    row) is ``searchsorted(c, p, right)`` — out_cap rank-finds plus an
    out_cap-row gather, and no host sync.
    """
    dev = rows.device
    if buf is None:
        buf = torch.zeros((out_cap, rows.shape[1]), dtype=rows.dtype, device=dev)
    if valid.shape[0] == 0:
        return (buf, torch.zeros((out_cap,), dtype=torch.bool, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))
    c = torch.cumsum(valid, 0, dtype=torch.int32)          # running count
    total = c[-1]
    dropped = (total - out_cap).clamp(min=0)
    src = torch.searchsorted(
        c, torch.arange(out_cap, dtype=torch.int32, device=dev), right=True)
    src = src.clamp(max=valid.shape[0] - 1)
    vmask = torch.arange(out_cap, device=dev) < total.clamp(max=out_cap)
    out = torch.where(vmask[:, None], rows[src], buf)
    return out, vmask, dropped


# ---------------------------------------------------------------------------
# Index probes (HBase GET with predicate push-down)
# ---------------------------------------------------------------------------


def searchsorted(keys: torch.Tensor, queries: torch.Tensor,
                 impl: str = "kernel") -> torch.Tensor:
    """Index rank-find: the searchsorted kernel on the card for every
    kernel impl, the plain version otherwise (kernels/ops.py)."""
    return ops.searchsorted(keys, queries, impl)


def gather_range(keys: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                 cap: int, impl: str = "kernel"):
    """For each probe range, gather up to `cap` composite keys.

    keys: (M,) sorted int64 (INF padded). lo/hi: (B,).
    Returns (k (B, cap) int64, valid (B, cap) bool, n_missed (B,) int32).
    Slots past a range's end hold clamped-gather keys (masked by valid).
    """
    m = keys.shape[0]
    start = searchsorted(keys, lo, impl)
    end = searchsorted(keys, hi, impl)
    idx = start[:, None] + torch.arange(cap, device=keys.device)[None]
    k = keys[idx.clamp(max=m - 1)]
    valid = idx < end[:, None]
    missed = (end - start - cap).clamp(min=0).to(torch.int32)
    return k, valid, missed


def apply_residual(k: torch.Tensor, valid: torch.Tensor,
                   flt_vals: torch.Tensor, flt_mask: tuple[bool, bool, bool],
                   eq_positions=()) -> torch.Tensor:
    """Server-side filter: keep entries whose unpacked positions match."""
    t = unpack3(k)  # 3 x (B, cap)
    for pos in range(3):
        if flt_mask[pos]:
            valid = valid & (t[pos] == flt_vals[:, pos][:, None])
    for a, b in eq_positions:
        valid = valid & (t[a] == t[b])
    return valid


def probe(plan: PatternPlan, keys: torch.Tensor, table: torch.Tensor,
          row_valid: torch.Tensor, cap: int, impl: str = "kernel"):
    """The MAPSIN inner loop body: dynamic GET for each input mapping.

    Returns (matched keys (B, cap), match mask, missed counts (B,)) from
    the fused probe_gather (kernels/ops.py): the CUDA kernel on the card,
    its plain version otherwise. Match keys are 0 at invalid slots.
    """
    lo, hi = probe_ranges(plan, table)
    lo = torch.where(row_valid, lo, 0)
    hi = torch.where(row_valid, hi, 0)   # invalid rows probe an empty range
    flt, msk = residual_values(plan, table)
    return ops.probe_gather(keys, lo, hi, flt, cap, msk, plan.eq_positions,
                            impl)


def merge_bindings(bindings: Bindings, plan: PatternPlan, k: torch.Tensor,
                   match: torch.Tensor, missed: torch.Tensor,
                   out_cap: int) -> Bindings:
    """Merge mu_n with compatible mappings (Alg. 1 lines 11-17).

    Only the ORIGIN index plus the <= 3 newly bound columns are compacted;
    the surviving old columns are gathered once at the end. Origins of
    invalid output rows are the zero padding, so the gather stays in
    bounds.
    """
    bcap, cap = match.shape
    t = unpack3(k)
    origin = torch.arange(bcap, dtype=torch.int32,
                          device=k.device)[:, None].expand(bcap, cap)
    cols = [origin] + [t[pos].to(torch.int32) for _, pos in plan.out_vars]
    rows = torch.stack([c.reshape(-1) for c in cols], dim=1)
    valid = (match & bindings.valid[:, None]).reshape(-1)
    packed, vmask, dropped = compact(rows, valid, out_cap)
    table = bindings.table[packed[:, 0].long()]
    if plan.out_vars:
        table = torch.cat([table, packed[:, 1:]], dim=1)
    table = torch.where(vmask[:, None], table, 0)
    overflow = (bindings.overflow + dropped
                + torch.where(bindings.valid, missed, 0).sum().to(torch.int32))
    return Bindings(bindings.vars + plan.out_var_names, table, vmask, overflow)


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------


def scan_pattern(pattern, keys: torch.Tensor, out_cap: int,
                 impl: str = "kernel", scratch: Bindings | None = None) -> Bindings:
    """First-pattern input phase: scan the (locally stored) index slice.

    `scratch` (a zeroed Bindings of matching shape) supplies the output
    buffers. `impl` is accepted for a uniform step signature; the scan
    runs no kernel.
    """
    plan = make_plan(pattern, ())
    empty = torch.zeros((1, 0), dtype=torch.int32, device=keys.device)
    lo, hi = probe_ranges(plan, empty)
    flt, msk = residual_values(plan, empty)
    within = (keys >= lo[0]) & (keys < hi[0])
    within = apply_residual(keys[None, :], within[None, :], flt, msk,
                            plan.eq_positions)[0]
    t = unpack3(keys)
    cols = [t[pos][:, None] for _, pos in plan.out_vars]
    rows = (torch.cat(cols, dim=-1) if cols
            else torch.zeros((keys.shape[0], 0), dtype=torch.int64,
                             device=keys.device)).to(torch.int32)
    buf = scratch.table if scratch is not None else None
    table, vmask, dropped = compact(rows, within, out_cap, buf=buf)
    overflow = dropped.to(torch.int32)
    if scratch is not None:
        vmask = vmask | scratch.valid          # zeros; consumes the buffer
        overflow = overflow + scratch.overflow
    return Bindings(plan.out_var_names, table, vmask, overflow)


def mapsin_step(bindings: Bindings, pattern, keys: torch.Tensor,
                probe_cap: int, out_cap: int, impl: str = "kernel") -> Bindings:
    """One cascading MAPSIN iteration (Algorithm 1) on local data."""
    plan = make_plan(pattern, bindings.vars)
    k, match, missed = probe(plan, keys, bindings.table, bindings.valid,
                             probe_cap, impl)
    return merge_bindings(bindings, plan, k, match, missed, out_cap)


def multiway_step(bindings: Bindings, patterns: Sequence, keys: torch.Tensor,
                  row_cap: int, out_cap: int, impl: str = "kernel") -> Bindings:
    """Optimized multiway star join (Algorithm 3): ONE row-GET per input
    mapping answers all patterns sharing the join variable on the primary
    position; per-pattern predicate filters are applied to the fetched row.
    """
    plans = [make_plan(p, bindings.vars) for p in patterns]
    p0 = plans[0]
    if not all(pl.index == p0.index and len(pl.prefix) >= 1 and
               pl.prefix[0] == p0.prefix[0] for pl in plans):
        raise ValueError("multiway requires a shared primary-position join "
                         "variable")
    dev = keys.device
    lo, hi = row_range(p0, bindings.table)
    lo = torch.where(bindings.valid, lo, 0)
    hi = torch.where(bindings.valid, hi, 0)
    k, in_row, missed = gather_range(keys, lo, hi, row_cap, impl)

    out = bindings
    # row -> probe index; origins of invalid rows are the zero padding, so
    # k[cur_origin] stays in bounds
    cur_origin = torch.arange(bindings.capacity, dtype=torch.int32, device=dev)
    for plan in plans:
        flt, msk = residual_values(plan, bindings.table)
        # secondary/tertiary prefix components become residual filters on
        # the fetched row
        extra_vals, extra_msk = filter_columns(
            dict(enumerate(plan.prefix[1:], start=1)), bindings.table)
        match = apply_residual(k, in_row, flt, msk, plan.eq_positions)
        match = apply_residual(k, match, extra_vals, extra_msk)
        # expand current out rows against this pattern's matches
        co = cur_origin.long()
        km = k[co]                                 # (out_cap, row_cap)
        mm = match[co] & out.valid[:, None]
        t = unpack3(km)
        old = out.table[:, None, :].expand(out.capacity, row_cap,
                                           len(out.vars))
        new_cols = [t[pos][..., None].to(torch.int32)
                    for _, pos in plan.out_vars]
        ori = cur_origin[:, None, None].expand(out.capacity, row_cap, 1)
        rows = torch.cat([old] + new_cols + [ori], dim=-1)
        table, vmask, dropped = compact(
            rows.reshape(out.capacity * row_cap, -1), mm.reshape(-1), out_cap)
        cur_origin = table[:, -1]
        out = Bindings(out.vars + plan.out_var_names, table[:, :-1], vmask,
                       out.overflow + dropped)
    overflow = out.overflow + torch.where(
        bindings.valid, missed, 0).sum().to(torch.int32)
    return Bindings(out.vars, out.table, out.valid, overflow)
