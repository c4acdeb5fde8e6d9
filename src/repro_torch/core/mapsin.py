"""MAPSIN join — map-side index nested-loop join (paper §4), local primitives.

Everything here operates on one shard's data with static shapes:
  * ``Bindings`` — a fixed-capacity multiset of solution mappings
    (capacity + validity mask + overflow counter; overflow is surfaced,
    never silent).
  * ``scan_pattern``    — the distributed-table-scan input phase (§4.1)
  * ``probe``           — the index GET: binary-search range + gather + filter
  * ``mapsin_step``     — Algorithm 1 (one cascading iteration): the GET
                          and the merge in one ``probe_compact``
  * ``multiway_step``   — Algorithms 2+3 (star joins, single row-GET):
                          the row's rank-find, then each pattern's rows
                          in one ``multiway_compact``

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
            buf: torch.Tensor | None = None, found: list | None = None):
    """Pack valid rows (N, nv) to the front of a (out_cap, nv) buffer.

    Returns (table, valid_mask, n_dropped int32). When `buf` (a zeroed
    (out_cap, nv) tensor) is given, it supplies the padding slots. When
    `found` is a list, it gets (over, N, cut) appended: the valid rows
    before the out_cap cut are ``over + cut``, N the slots searched.
    `over`, a () int32 tensor, is the difference the dropped count is
    clamped from, so the count costs no operation and holds no buffer.

    Gather-formulated: the running count c = cumsum(valid) is
    non-decreasing, so the source row of output slot p (the (p+1)-th valid
    row) is ``searchsorted(c, p, right)`` — out_cap rank-finds plus an
    out_cap-row gather, and no host sync.
    """
    dev = rows.device
    if buf is None:
        buf = torch.zeros((out_cap, rows.shape[1]), dtype=rows.dtype, device=dev)
    if valid.shape[0] == 0:
        vmask = torch.zeros((out_cap,), dtype=torch.bool, device=dev)
        none = torch.zeros((), dtype=torch.int32, device=dev)
        if found is not None:
            found.append((none, 0, 0))
        return buf, vmask, none
    c = torch.cumsum(valid, 0, dtype=torch.int32)          # running count
    total = c[-1]
    over = total - out_cap               # rows past the cut (< 0: room)
    dropped = over.clamp(min=0)
    if found is not None:
        found.append((over, valid.shape[0], out_cap))
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
    start = searchsorted(keys, lo, impl)
    end = searchsorted(keys, hi, impl)
    k, valid = range_slots(keys, start, end, cap)
    return k, valid, range_missed(start, end, cap)


def range_slots(keys: torch.Tensor, start: torch.Tensor, end: torch.Tensor,
                cap: int):
    """The first `cap` keys of each rank range [start, end) (B,): (k (B,
    cap) int64, the clamped-gather key past a range's end; valid (B, cap)
    bool)."""
    idx = start[:, None] + torch.arange(cap, device=keys.device)[None]
    return keys[idx.clamp(max=keys.shape[0] - 1)], idx < end[:, None]


def range_missed(start: torch.Tensor, end: torch.Tensor,
                 cap: int) -> torch.Tensor:
    """(B,) int32: the keys of each rank range past its first `cap`."""
    return (end - start - cap).clamp(min=0).to(torch.int32)


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
    lo, hi, flt, msk = probe_inputs(plan, table, row_valid)
    return ops.probe_gather(keys, lo, hi, flt, cap, msk, plan.eq_positions,
                            impl)


def probe_inputs(plan: PatternPlan, table: torch.Tensor,
                 row_valid: torch.Tensor):
    """Each binding's GET: (lo, hi) (B,) int64, [0, 0) for an invalid row,
    and the residual values (B, 3) with their (3,) mask."""
    lo, hi = probe_ranges(plan, table)
    lo = torch.where(row_valid, lo, 0)
    hi = torch.where(row_valid, hi, 0)   # invalid rows probe an empty range
    flt, msk = residual_values(plan, table)
    return lo, hi, flt, msk


def merge_matches(table: torch.Tensor, k: torch.Tensor, match: torch.Tensor,
                  new_pos: tuple, out_cap: int, found: list | None = None):
    """The rows of the matches (B, cap) of bindings `table` (B, nv):
    (table (out_cap, nv + len(new_pos)), valid mask, n_dropped int32), each
    match's binding followed by its key's fields at `new_pos`, in (probe,
    slot) order, zeros past the kept rows.

    Only the ORIGIN index plus the <= 3 newly bound columns are compacted;
    the surviving old columns are gathered once at the end. Origins of
    invalid output rows are the zero padding, so the gather stays in
    bounds.
    """
    bcap, cap = match.shape
    t = unpack3(k)
    origin = torch.arange(bcap, dtype=torch.int32,
                          device=k.device)[:, None].expand(bcap, cap)
    cols = [origin] + [t[pos].to(torch.int32) for pos in new_pos]
    rows = torch.stack([c.reshape(-1) for c in cols], dim=1)
    packed, vmask, dropped = compact(rows, match.reshape(-1), out_cap,
                                     found=found)
    out = table[packed[:, 0].long()]
    if new_pos:
        out = torch.cat([out, packed[:, 1:]], dim=1)
    return torch.where(vmask[:, None], out, 0), vmask, dropped


def merge_bindings(bindings: Bindings, plan: PatternPlan, k: torch.Tensor,
                   match: torch.Tensor, missed: torch.Tensor,
                   out_cap: int, found: list | None = None) -> Bindings:
    """Merge mu_n with compatible mappings (Alg. 1 lines 11-17): the rows
    of ``merge_matches``, for the distributed steps, whose matches come
    from a collective (core/distributed.py)."""
    table, vmask, dropped = merge_matches(
        bindings.table, k, match & bindings.valid[:, None],
        tuple(pos for _, pos in plan.out_vars), out_cap, found)
    overflow = (bindings.overflow + dropped
                + torch.where(bindings.valid, missed, 0).sum().to(torch.int32))
    return Bindings(bindings.vars + plan.out_var_names, table, vmask, overflow)


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------


def scan_pattern(pattern, keys: torch.Tensor, out_cap: int,
                 impl: str = "kernel", scratch: Bindings | None = None,
                 found: list | None = None) -> Bindings:
    """First-pattern input phase: scan the (locally stored) index slice.

    `scratch` (a zeroed Bindings of matching shape) supplies the output
    buffers. `impl` is accepted for a uniform step signature; the scan
    runs no kernel. `found`, here and in the other steps, is passed to
    the ``compact`` that makes the step's rows.
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
    table, vmask, dropped = compact(rows, within, out_cap, buf=buf,
                                    found=found)
    overflow = dropped.to(torch.int32)
    if scratch is not None:
        vmask = vmask | scratch.valid          # zeros; consumes the buffer
        overflow = overflow + scratch.overflow
    return Bindings(plan.out_var_names, table, vmask, overflow)


def mapsin_step(bindings: Bindings, pattern, keys: torch.Tensor,
                probe_cap: int, out_cap: int, impl: str = "kernel",
                found: list | None = None) -> Bindings:
    """One cascading MAPSIN iteration (Algorithm 1) on local data: the GET
    and the merge in one ``probe_compact`` (kernels/ops.py), which on the
    card writes the step's rows with no (B, probe_cap) temporary."""
    plan = make_plan(pattern, bindings.vars)
    lo, hi, flt, msk = probe_inputs(plan, bindings.table, bindings.valid)
    table, vmask, dropped, over, missed = ops.probe_compact(
        keys, lo, hi, flt, bindings.table, probe_cap, out_cap, msk,
        plan.eq_positions, tuple(pos for _, pos in plan.out_vars), impl)
    if found is not None:
        found.append((over, bindings.capacity * probe_cap, out_cap))
    # an invalid binding probes [0, 0), so misses nothing
    overflow = bindings.overflow + dropped + missed.sum().to(torch.int32)
    return Bindings(bindings.vars + plan.out_var_names, table, vmask, overflow)


def multiway_step(bindings: Bindings, patterns: Sequence, keys: torch.Tensor,
                  row_cap: int, out_cap: int, impl: str = "kernel",
                  found: list | None = None) -> Bindings:
    """Optimized multiway star join (Algorithm 3): ONE row-GET per input
    mapping answers all patterns sharing the join variable on the primary
    position; per-pattern predicate filters are applied to the fetched row.

    The row-GET is its rank-find alone; each pattern's rows are then
    written from the index by one ``multiway_compact`` (kernels/ops.py),
    which on the card builds no (capacity, row_cap) temporary.
    """
    plans = [make_plan(p, bindings.vars) for p in patterns]
    p0 = plans[0]
    if not all(pl.index == p0.index and len(pl.prefix) >= 1 and
               pl.prefix[0] == p0.prefix[0] for pl in plans):
        raise ValueError("multiway requires a shared primary-position join "
                         "variable")
    lo, hi = row_range(p0, bindings.table)
    lo = torch.where(bindings.valid, lo, 0)
    hi = torch.where(bindings.valid, hi, 0)
    start = searchsorted(keys, lo, impl)
    end = searchsorted(keys, hi, impl)
    missed = range_missed(start, end, row_cap)
    out = bindings
    origin = torch.arange(bindings.capacity, dtype=torch.int32,
                          device=keys.device)
    for plan in plans:
        flt, msk, extra, extra_msk = star_filters(plan, bindings.table)
        table, vmask, dropped, over, origin = ops.multiway_compact(
            keys, start, end, flt, extra, origin, out.table, out.valid,
            row_cap, out_cap, msk, extra_msk, plan.eq_positions,
            tuple(pos for _, pos in plan.out_vars), impl)
        if found is not None:
            found.append((over, out.capacity * row_cap, out_cap))
        out = Bindings(out.vars + plan.out_var_names, table, vmask,
                       out.overflow + dropped)
    overflow = out.overflow + torch.where(
        bindings.valid, missed, 0).sum().to(torch.int32)
    return Bindings(out.vars, out.table, out.valid, overflow)


def star_filters(plan: PatternPlan, table: torch.Tensor):
    """One star pattern's tests on the fetched row of each binding of
    `table` (B, nv): (residual values (B, 3), their (3,) mask, the
    secondary and tertiary prefix components as values (B, 3), their
    mask); the prefix components were part of the GET key in the 2-way
    case."""
    flt, msk = residual_values(plan, table)
    extra, extra_msk = filter_columns(
        dict(enumerate(plan.prefix[1:], start=1)), table)
    return flt, msk, extra, extra_msk


def multiway_match(table: torch.Tensor, valid: torch.Tensor,
                   origin: torch.Tensor, k: torch.Tensor, in_row: torch.Tensor,
                   flt: torch.Tensor, flt_mask: tuple, extra: torch.Tensor,
                   extra_mask: tuple, eq_positions: tuple, new_pos: tuple,
                   out_cap: int, found: list | None = None):
    """One pattern of the multiway star join: the rows (table (R, nv),
    valid (R,)), each from the binding `origin` (R,) int32, expanded
    against the matches of that binding's fetched row (k, in_row) (B,
    row_cap) under the pattern's filters. Returns (table (out_cap, nv +
    len(new_pos)), valid mask, n_dropped int32, origin (out_cap,) int32):
    in (row, slot) order, each row followed by its match's fields at
    `new_pos`, zeros past the kept rows (so the origins stay in bounds).
    """
    match = apply_residual(k, in_row, flt, flt_mask, eq_positions)
    match = apply_residual(k, match, extra, extra_mask)
    co = origin.long()
    km = k[co]                                     # (R, row_cap)
    mm = match[co] & valid[:, None]
    t = unpack3(km)
    n, row_cap = mm.shape
    old = table[:, None, :].expand(n, row_cap, table.shape[1])
    new_cols = [t[pos][..., None].to(torch.int32) for pos in new_pos]
    ori = origin[:, None, None].expand(n, row_cap, 1)
    rows = torch.cat([old] + new_cols + [ori], dim=-1)
    packed, vmask, dropped = compact(rows.reshape(n * row_cap, -1),
                                     mm.reshape(-1), out_cap, found=found)
    return packed[:, :-1], vmask, dropped, packed[:, -1]


def multiway_merge(bindings: Bindings, plans: Sequence[PatternPlan],
                   k: torch.Tensor, in_row: torch.Tensor,
                   missed: torch.Tensor, out_cap: int,
                   found: list | None = None) -> Bindings:
    """The tail of the multiway star join after its row-GET (k, in_row,
    missed) (B, row_cap): ``multiway_match`` pattern by pattern, for the
    distributed steps (core/distributed.py), which fetch the row through
    a collective."""
    out = bindings
    origin = torch.arange(bindings.capacity, dtype=torch.int32,
                          device=k.device)
    for plan in plans:
        flt, msk, extra, extra_msk = star_filters(plan, bindings.table)
        table, vmask, dropped, origin = multiway_match(
            out.table, out.valid, origin, k, in_row, flt, msk, extra,
            extra_msk, plan.eq_positions,
            tuple(pos for _, pos in plan.out_vars), out_cap, found)
        out = Bindings(out.vars + plan.out_var_names, table, vmask,
                       out.overflow + dropped)
    overflow = out.overflow + torch.where(
        bindings.valid, missed, 0).sum().to(torch.int32)
    return Bindings(out.vars, out.table, out.valid, overflow)
