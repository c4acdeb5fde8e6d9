"""Pattern -> probe plan compilation (the paper's Table 3 index selection).

A ``PatternPlan`` is the static recipe for answering one triple pattern given
a multiset of solution mappings: which index (T_spo / T_ops), the bound key
prefix (-> one binary-search range = HBase GET/SCAN), residual equality
filters (-> server-side predicate push-down), and which index-order
positions feed which output variables.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.core.rdf import BITS, INF_KEY, Pattern, is_var, pack3
from repro_torch.core.triple_store import OPS, SPO

# value sources for prefix/filters: ("const", id) or ("var", binding column)
Source = tuple[str, int]


@dataclasses.dataclass(frozen=True)
class PatternPlan:
    pattern: Pattern
    index: int                         # SPO or OPS
    prefix: tuple[Source, ...]         # length 0..3, in index order
    residual: tuple[tuple[int, Source], ...]  # (index-order position, source)
    out_vars: tuple[tuple[str, int], ...]     # (var name, index-order position)
    eq_positions: tuple[tuple[int, int], ...]  # intra-pattern var repeats
    is_scan: bool                      # no bound prefix -> full SCAN

    @property
    def out_var_names(self) -> tuple[str, ...]:
        return tuple(v for v, _ in self.out_vars)


def _index_order(index: int, pattern: Pattern):
    s, p, o = pattern.terms
    return (s, p, o) if index == SPO else (o, p, s)


def make_plan(pattern: Pattern, domain: Sequence[str]) -> PatternPlan:
    """domain: variable names already bound (binding table columns)."""
    dom = {v: i for i, v in enumerate(domain)}

    def src(term) -> Source | None:
        if not is_var(term):
            return ("const", int(term))
        if term in dom:
            return ("var", dom[term])
        return None

    s_b, o_b = src(pattern.s), src(pattern.o)
    index = SPO if s_b is not None or o_b is None else OPS
    terms = _index_order(index, pattern)
    sources = [src(t) for t in terms]

    prefix: list[Source] = []
    for sc in sources:
        if sc is None:
            break
        prefix.append(sc)
    residual = tuple((i, sc) for i, sc in enumerate(sources)
                     if sc is not None and i >= len(prefix))

    out_vars: list[tuple[str, int]] = []
    eq: list[tuple[int, int]] = []
    seen: dict[str, int] = {}
    for i, t in enumerate(terms):
        if is_var(t) and t not in dom:
            if t in seen:
                eq.append((seen[t], i))
            else:
                seen[t] = i
                out_vars.append((t, i))
    return PatternPlan(pattern, index, tuple(prefix), residual,
                       tuple(out_vars), tuple(eq), is_scan=len(prefix) == 0)


def _resolve(source: Source, table: torch.Tensor) -> torch.Tensor:
    """table: (B, nv) int32 -> (B,) int64 values."""
    kind, v = source
    if kind == "const":
        return torch.full((table.shape[0],), v, dtype=torch.int64,
                          device=table.device)
    return table[:, v].to(torch.int64)


def next_prefix(lo: torch.Tensor, shift: int) -> torch.Tensor:
    """Exclusive upper bound of the composite-key range whose bound prefix
    ends `shift` bits above the bottom: ``lo + (1 << shift)``, saturated at
    INF_KEY.

    Plain addition carries correctly across fields; the one overflow
    (every bound field at MAX_ID, so the sum would be 2^63) saturates to
    INF_KEY, which as an exclusive bound still covers every storable key.
    The test is a saturating compare made before the addition, so nothing
    depends on signed wraparound on the device."""
    step = 1 << shift
    return torch.where(lo > INF_KEY - step,  # lo + step would pass 2^63 - 1
                       torch.full_like(lo, INF_KEY), lo + step)


def probe_ranges(plan: PatternPlan, table: torch.Tensor):
    """Compute per-binding [lo, hi) composite-key ranges. table: (B, nv)."""
    b = table.shape[0]
    zero = torch.zeros((b,), dtype=torch.int64, device=table.device)
    vals = [_resolve(s, table) for s in plan.prefix]
    plen = len(vals)
    if plen == 0:
        lo = zero
        hi = torch.full((b,), INF_KEY, dtype=torch.int64, device=table.device)
    elif plen == 1:
        lo = pack3(vals[0], zero, zero)
        hi = next_prefix(lo, 2 * BITS)
    elif plen == 2:
        lo = pack3(vals[0], vals[1], zero)
        hi = next_prefix(lo, BITS)
    else:
        lo = pack3(vals[0], vals[1], vals[2])
        hi = next_prefix(lo, 0)
    return lo, hi


def filter_columns(sources: dict[int, Source], table: torch.Tensor):
    """(B, 3) int64 values + (3,) bool mask over index-order positions:
    column `pos` is ``_resolve(sources[pos])``, or zeros where `pos` has no
    source. Built out of place with ``torch.stack``, so the cascade also
    runs under ``torch.func.vmap``."""
    zero = torch.zeros((table.shape[0],), dtype=torch.int64,
                       device=table.device)
    vals = torch.stack([_resolve(sources[pos], table) if pos in sources
                        else zero for pos in range(3)], dim=1)
    return vals, tuple(pos in sources for pos in range(3))


def residual_values(plan: PatternPlan, table: torch.Tensor):
    """(B, 3) filter values + (3,) bool mask over index-order positions."""
    return filter_columns(dict(plan.residual), table)


def row_range(plan: PatternPlan, table: torch.Tensor):
    """Whole-row range on the primary key only (multiway single-GET,
    paper Alg. 3): [pack(v, 0, 0), pack(v, 0, 0) + 2^42), with the same
    saturating bound as probe_ranges."""
    if not plan.prefix:
        raise ValueError("row_range needs a bound primary position")
    v = _resolve(plan.prefix[0], table)
    zero = torch.zeros_like(v)
    lo = pack3(v, zero, zero)
    return lo, next_prefix(lo, 2 * BITS)
