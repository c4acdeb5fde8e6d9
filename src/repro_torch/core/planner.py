"""Cost-based query planner: ``LogicalPlan`` -> ``PhysicalPlan`` IR.

A compiled ``PhysicalPlan`` is the single artifact the executors consume:
each step carries

  * its **operator** — ``scan | mapsin | multiway | reduce_side`` —
    chosen per join: ``multiway`` by the star-grouping rule,
    ``reduce_side`` as the fallback when the measured probe fan-out would
    blow the cap budget or the pattern has no usable index prefix;
  * its **capacities** (``Caps``) as static shape constants, on the
    shared ``{2^k, 3*2^(k-1)}`` quantization grid (``quantize_cap``);
  * a **cost estimate** from exact pattern cardinalities plus the
    group-fanout statistics of the sorted index — the join order is chosen
    by cost-based search (exhaustive left-deep for <= 6 patterns, greedy
    beyond).

Planning is host numpy over one host copy of each index, made once per
store and cached. ``explain(plan)`` renders the chosen order, operators,
caps and cost per step; with a ``stats`` list from an instrumented run it
also shows the actual row counts and per-step overflow.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.plan import make_plan, probe_ranges
from repro_torch.core.rdf import BITS, INF_KEY, Pattern, is_var
from repro_torch.core.triple_store import TripleStore
from repro_torch.obs.trace import Tracer, optional_span

# operator sets: the full planner vocabulary, and the subset a seeded
# template cascade can express (reduce_side re-scans relations with an
# empty domain, which a template cannot seed)
ALL_OPERATORS = ("scan", "mapsin", "multiway", "reduce_side")
ENGINE_OPERATORS = ("scan", "mapsin", "multiway")


@dataclasses.dataclass(frozen=True)
class Caps:
    """Static capacity budget — input to the planner, embedded per step."""
    scan_cap: int = 1 << 14      # relation scan capacity (per shard)
    probe_cap: int = 8           # matches per GET (per mapping); also the
                                 # a2a answer-leg capacity
    row_cap: int = 32            # row width for multiway single-GET
    out_cap: int = 1 << 14       # solution multiset capacity (per shard)
    bucket_cap: int = 1 << 12    # reduce-side shuffle bucket capacity
    a2a_bucket_cap: int = 0      # per-destination probe bucket capacity for
                                 # routed distributed probes (0 = measured)


def quantize_cap(cap: int) -> int:
    """Round a capacity UP onto the ``{2^k, 3*2^(k-1)}`` grid (8, 12, 16,
    24, 32, 48, ...): two sizes per octave bound the number of distinct
    shapes at < 50% capacity overshoot."""
    if cap <= 8:
        return 8
    k = 1 << (cap - 1).bit_length()            # next pow2 >= cap
    return (3 * k) // 4 if cap <= (3 * k) // 4 else k


def next_cap(cap: int) -> int:
    """The escalation successor of a capacity: the power of two STRICTLY
    above `cap` (floored at the grid minimum 8), so an escalation chain
    never repeats a cap and lands back on the ``quantize_cap`` grid."""
    return max(1 << int(cap).bit_length(), 8)


def escalate_caps(caps: Caps) -> Caps:
    """One overflow-escalation move: every truncating capacity advances to
    its ``next_cap``. All four row budgets move together — the overflow
    counter is cumulative across steps, so the escalation cannot tell a
    probe-cap drop from an out-cap drop. ``a2a_bucket_cap`` resets to 0."""
    return dataclasses.replace(
        caps, scan_cap=next_cap(caps.scan_cap),
        probe_cap=next_cap(caps.probe_cap), row_cap=next_cap(caps.row_cap),
        out_cap=next_cap(caps.out_cap), a2a_bucket_cap=0)


@dataclasses.dataclass(frozen=True)
class LogicalPlan:
    """What to answer: a conjunctive BGP, order-free."""
    patterns: tuple[Pattern, ...]


@dataclasses.dataclass(frozen=True)
class PlanStep:
    """One physical operator application with its static capacities."""
    kind: str                    # scan | mapsin | multiway | reduce_side
    patterns: tuple[Pattern, ...]
    caps: Caps
    est_in: int = 0              # estimated input mappings
    est_out: int = 0             # estimated output mappings
    est_fanout_max: int = 0      # estimated max matches per probe


@dataclasses.dataclass(frozen=True)
class PhysicalPlan:
    """The executable IR: ordered steps, each with operator + caps."""
    steps: tuple[PlanStep, ...]
    var_order: tuple[str, ...]   # final binding-column order
    cost: float                  # estimated total rows touched
    ordering: str                # cost | heuristic | given
    route_shards: int = 10       # hypothetical cluster for routed-traffic
                                 # measurement (paper's 10-node setup)

    @property
    def patterns(self) -> tuple[Pattern, ...]:
        return tuple(p for st in self.steps for p in st.patterns)


# ---------------------------------------------------------------------------
# Statistics (exact, from the sorted composite-key store; host-side, memoized)
# ---------------------------------------------------------------------------


def _host_keys(store: TripleStore, index: int) -> np.ndarray:
    """Host copy of one flattened index: one device->host copy per index,
    cached on the store."""
    ck = ("np_keys", index)
    if ck not in store.plan_cache:
        store.plan_cache[ck] = store.flat_keys(index).cpu().numpy()
    return store.plan_cache[ck]


def _host_fields(store: TripleStore, index: int):
    """Unpacked (pos0, pos1, pos2) int64 fields of the real (non-padding)
    keys of one index, in index order."""
    ck = ("np_fields", index)
    if ck not in store.plan_cache:
        keys = _host_keys(store, index)
        keys = keys[keys < INF_KEY]
        mask = np.int64((1 << BITS) - 1)
        store.plan_cache[ck] = ((keys >> (2 * BITS)) & mask,
                                (keys >> BITS) & mask, keys & mask)
    return store.plan_cache[ck]


def pattern_cardinality(store: TripleStore, pat: Pattern) -> int:
    """Exact result count for a pattern's constant key prefix — one binary
    search pair against the host copy of the index. Memoized per store."""
    ck = ("card", pat)
    if ck in store.plan_cache:
        return store.plan_cache[ck]
    plan = make_plan(pat, ())
    if not plan.prefix:
        n = store.n_triples
    else:
        lo, hi = probe_ranges(plan, torch.zeros((1, 0), dtype=torch.int32))
        keys = _host_keys(store, plan.index)
        n = int(np.searchsorted(keys, int(hi[0]))
                - np.searchsorted(keys, int(lo[0])))
    store.plan_cache[ck] = n
    return n


def relation_stats(store: TripleStore, pat: Pattern,
                   domain: Sequence[str],
                   tracer: Tracer | None = None) -> tuple[int, int, int]:
    """(rows, groups, max_group) of the pattern's relation under `domain`.

    ``rows``  — exact cardinality with EVERY constant applied;
    ``groups``/``max_group`` — the relation grouped by the index-order
                positions a probe would bind from the domain: the average
                group is the expected matches per probe and ``max_group``
                the worst-case probe fan-out (what sizes probe caps).

    One O(N) host pass per distinct (constants, var-positions) signature,
    memoized in the store's plan cache; with a `tracer`, each pass is a
    ``planner.relation_stats`` span."""
    plan = make_plan(pat, domain)
    consts = tuple(sorted(
        (pos, v) for pos, (kind, v) in
        list(enumerate(plan.prefix)) + list(plan.residual)
        if kind == "const"))
    varpos = tuple(sorted(
        pos for pos, (kind, _) in
        list(enumerate(plan.prefix)) + list(plan.residual) if kind == "var"))
    ck = ("relstats", plan.index, consts, varpos)
    if ck in store.plan_cache:
        return store.plan_cache[ck]
    with optional_span(tracer, "planner.relation_stats", index=plan.index):
        fields = _host_fields(store, plan.index)
        mask = np.ones(fields[0].shape, bool)
        for pos, v in consts:
            mask = mask & (fields[pos] == v)
        rows = int(mask.sum())
        if not varpos or rows == 0:
            out = (rows, 1 if rows else 0, rows)
        else:
            combo = np.zeros(rows, np.int64)
            for pos in varpos:
                combo = (combo << BITS) | fields[pos][mask]
            counts = np.unique(combo, return_counts=True)[1]
            out = (rows, int(len(counts)), int(counts.max()))
    store.plan_cache[ck] = out
    return out


# ---------------------------------------------------------------------------
# Join ordering: the legacy heuristic and the cost-based search
# ---------------------------------------------------------------------------


def order_patterns(patterns: Sequence[Pattern], reorder: bool = True,
                   store: TripleStore | None = None):
    """Variable-counting heuristic (paper §4.2): most selective first, then
    greedily prefer patterns connected to the bound domain. With a store,
    ties break on measured prefix-range cardinality."""
    pats = list(patterns)
    if not reorder:
        return pats

    def rank(p: Pattern):
        base = p.selectivity_rank()
        if store is not None:
            return base + (pattern_cardinality(store, p),)
        return base

    pats_sorted = sorted(pats, key=rank)
    out = [pats_sorted.pop(0)]
    domain = set(out[0].variables)
    while pats_sorted:
        connected = [p for p in pats_sorted if set(p.variables) & domain]
        nxt = min(connected or pats_sorted, key=rank)
        pats_sorted.remove(nxt)
        out.append(nxt)
        domain |= set(nxt.variables)
    return out


def _join_selectivity(store: TripleStore, pat: Pattern,
                      domain: Sequence[str],
                      tracer: Tracer | None = None) -> tuple[float, int, int]:
    """(avg matches per probe, relation rows, max probe fan-out) of `pat`
    joined against `domain`: rows/groups under the containment
    assumption; a pattern sharing no domain variable degrades to the full
    relation (cross product)."""
    rows, groups, mx = relation_stats(store, pat, domain, tracer)
    bound = set(pat.variables) & set(domain)
    avg = rows / groups if (bound and groups) else float(rows)
    return avg, rows, mx


def _order_cost(store: TripleStore, order: Sequence[Pattern],
                tracer: Tracer | None = None) -> float:
    """Estimated rows touched by a left-deep execution of `order`: scan
    rows + per-join (probes issued + rows produced)."""
    rows0, _, _ = relation_stats(store, order[0], (), tracer)
    est = float(rows0)
    cost = est
    domain = list(order[0].variables)
    for pat in order[1:]:
        avg, _, _ = _join_selectivity(store, pat, domain, tracer)
        out = est * avg
        cost += est + out
        est = out
        for v in pat.variables:
            if v not in domain:
                domain.append(v)
    return cost


_EXHAUSTIVE_LIMIT = 6    # <= 6 patterns: all left-deep orders (<= 720)


def cost_order(store: TripleStore, patterns: Sequence[Pattern],
               tracer: Tracer | None = None) -> tuple[list[Pattern], float]:
    """Cost-based join order: exhaustive left-deep search for small BGPs,
    greedy (min incremental cost among connected candidates) beyond.
    Deterministic: cost ties break on the original pattern order."""
    pats = list(patterns)
    if len(pats) <= 1:
        c = (float(relation_stats(store, pats[0], (), tracer)[0])
             if pats else 0.0)
        return pats, c
    if len(pats) <= _EXHAUSTIVE_LIMIT:
        best_key, best = None, None
        for perm in itertools.permutations(range(len(pats))):
            order = [pats[i] for i in perm]
            key = (_order_cost(store, order, tracer), perm)
            if best_key is None or key < best_key:
                best_key, best = key, order
        return best, best_key[0]
    # greedy: cheapest seed, then min incremental cost among connected
    remaining = list(range(len(pats)))
    first = min(remaining,
                key=lambda i: (relation_stats(store, pats[i], (), tracer)[0],
                               i))
    order = [pats[first]]
    remaining.remove(first)
    domain = list(pats[first].variables)
    est = float(relation_stats(store, pats[first], (), tracer)[0])
    cost = est
    while remaining:
        def incr(i):
            avg, _, _ = _join_selectivity(store, pats[i], domain, tracer)
            return est + est * avg
        connected = [i for i in remaining
                     if set(pats[i].variables) & set(domain)]
        nxt = min(connected or remaining, key=lambda i: (incr(i), i))
        avg, _, _ = _join_selectivity(store, pats[nxt], domain, tracer)
        cost += est + est * avg
        est = est * avg
        order.append(pats[nxt])
        remaining.remove(nxt)
        for v in pats[nxt].variables:
            if v not in domain:
                domain.append(v)
    return order, cost


# ---------------------------------------------------------------------------
# Operator selection + step construction
# ---------------------------------------------------------------------------


def _group_multiway(ordered: Sequence[Pattern], multiway: bool):
    """Star-grouping rule (paper Alg. 2/3): consecutive patterns sharing
    the primary-position join variable on the same index, producing only
    fresh variables, collapse into one multiway row-GET."""
    groups: list[tuple[str, tuple[Pattern, ...]]] = [("scan", (ordered[0],))]
    domain: list[str] = list(ordered[0].variables)
    i = 1
    while i < len(ordered):
        group = [ordered[i]]
        if multiway:
            plan_i = make_plan(ordered[i], domain)
            new_vars = set(plan_i.out_var_names)
            j = i + 1
            while j < len(ordered) and len(plan_i.prefix) >= 1:
                cand = make_plan(ordered[j], domain)
                same_row = (cand.index == plan_i.index and
                            len(cand.prefix) >= 1 and
                            cand.prefix[0] == plan_i.prefix[0])
                fresh = not (set(cand.out_var_names) & new_vars)
                uses_new = bool(set(ordered[j].variables) & new_vars)
                if not (same_row and fresh and not uses_new):
                    break
                group.append(ordered[j])
                new_vars |= set(cand.out_var_names)
                j += 1
        kind = "multiway" if len(group) > 1 else "mapsin"
        groups.append((kind, tuple(group)))
        for g in group:
            for v in g.variables:
                if v not in domain:
                    domain.append(v)
        i += len(group)
    return groups


def _step_out_vars(kind: str, patterns: tuple[Pattern, ...],
                   domain: list[str]) -> list[str]:
    """New binding columns a step appends, in the operator's own order
    (reduce_side scans its relation with an EMPTY domain, so its column
    order comes from the empty-domain plan, not the probe plan)."""
    out: list[str] = []
    seen = set(domain)
    for pat in patterns:
        if kind == "reduce_side":
            names = make_plan(pat, ()).out_var_names
        else:
            names = make_plan(pat, tuple(domain) + tuple(out)).out_var_names
        for v in names:
            if v not in seen:
                seen.add(v)
                out.append(v)
    return out


def compile_plan(store: TripleStore | None, patterns, caps: Caps = Caps(),
                 mode: str = "mapsin", ordering: str = "cost",
                 multiway: bool = True, reorder: bool = True,
                 operators: tuple[str, ...] = ALL_OPERATORS,
                 routing: str = "broadcast", num_shards: int = 0,
                 route_shards: int = 10,
                 tracer: Tracer | None = None) -> PhysicalPlan:
    """The LogicalPlan -> PhysicalPlan compiler.

    `patterns` may be a LogicalPlan or a Pattern sequence. `ordering` is
    "cost" (default; falls back to "heuristic" without a store) or
    "heuristic" (the variable-counting baseline); `reorder=False` keeps
    the given order. `mode="reduce"` forces every join step onto the
    reduce-side operator (the paper's comparison baseline); otherwise
    operators are chosen per step, restricted to `operators`.

    With `num_shards > 0` and `routing="a2a"` and `caps.a2a_bucket_cap
    == 0`, the per-step a2a capacities are embedded from measurement
    (``embed_a2a_caps``): one instrumented run of this plan, cached per
    plan on the store, sizes the per-destination probe buckets and the
    answer legs.

    With a `tracer`, a plan the store's plan cache does not hold is
    compiled inside a ``planner.compile`` span, each statistics pass it
    makes a ``planner.relation_stats`` child.
    """
    if isinstance(patterns, LogicalPlan):
        patterns = patterns.patterns
    patterns = tuple(patterns)
    if not patterns:
        raise ValueError("empty pattern list")
    if mode == "reduce" and "reduce_side" not in operators:
        raise ValueError("mode='reduce' needs the reduce_side operator — "
                         "it cannot be expressed under this operator set")
    ck = None
    if store is not None:
        ck = ("pplan", patterns, caps, mode, ordering, multiway, reorder,
              operators, routing, num_shards, route_shards)
        hit = store.plan_cache.get(ck)
        if hit is not None:
            return hit
    with optional_span(tracer, "planner.compile"):
        if not reorder:
            ordered, chosen = list(patterns), "given"
            cost = (_order_cost(store, ordered, tracer)
                    if store is not None else float("nan"))
        elif ordering == "cost" and store is not None:
            ordered, cost, chosen = (*cost_order(store, patterns, tracer),
                                     "cost")
        else:
            ordered = order_patterns(patterns, True, store)
            cost = (_order_cost(store, ordered, tracer)
                    if store is not None else float("nan"))
            chosen = "heuristic"

        groups = _group_multiway(ordered, multiway)
        steps: list[PlanStep] = []
        domain: list[str] = []
        var_order: list[str] = []
        est = 0.0
        for kind, pats in groups:
            est_in = est
            fan_max = 0
            if kind == "scan":
                est = (float(relation_stats(store, pats[0], (), tracer)[0])
                       if store is not None else 0.0)
            else:
                if mode == "reduce":
                    kind = "reduce_side"
                for pat in pats:
                    if store is None:
                        continue
                    avg, _, mx = _join_selectivity(store, pat, domain,
                                                   tracer)
                    est = est * avg
                    fan_max = max(fan_max, mx)
                if (kind == "mapsin" and mode != "reduce"
                        and "reduce_side" in operators and store is not None):
                    kind = _maybe_reduce_side(store, pats[0], domain, caps,
                                              tracer)
            scaps = caps
            if (kind == "reduce_side" and mode != "reduce"
                    and store is not None):
                # right-size the sort-merge per-row match budget: the merge
                # windows on the SINGLE join-key column, so the budget must
                # cover the relation's max group per join-key VALUE
                shared = [v for v in pats[0].variables if v in domain]
                fan_key = (relation_stats(store, pats[0], (shared[0],),
                                          tracer)[2]
                           if shared else fan_max)
                scaps = dataclasses.replace(
                    caps, probe_cap=max(caps.probe_cap,
                                        quantize_cap(min(max(fan_key, 1),
                                                         caps.out_cap))))
            clamp = lambda x: int(min(x, 1e18))
            steps.append(PlanStep(kind, pats, scaps, clamp(est_in),
                                  clamp(est), fan_max))
            new = _step_out_vars(kind, pats, domain)
            domain.extend(v for p in pats for v in p.variables
                          if v not in domain)
            var_order.extend(new)
        plan = PhysicalPlan(tuple(steps), tuple(var_order),
                            float(cost) if cost == cost else 0.0, chosen,
                            route_shards)
        # a positive a2a_bucket_cap is an explicit pin (the drop-free
        # override) — it skips the measurement pass entirely
        if (num_shards > 0 and routing == "a2a" and mode != "reduce"
                and caps.a2a_bucket_cap == 0 and store is not None):
            plan = embed_a2a_caps(store, plan, caps, num_shards)
    if ck is not None:
        store.plan_cache[ck] = plan
    return plan


def _maybe_reduce_side(store: TripleStore, pat: Pattern, domain: list[str],
                       caps: Caps, tracer: Tracer | None = None) -> str:
    """Per-step operator fallback: keep ``mapsin`` unless (a) the probe
    plan has NO bound key prefix — a residual-only join — or (b) the
    relation's measured max probe fan-out blows the probe-cap budget while
    the relation still fits a reduce-side scan. Both require a shared
    variable (sort-merge needs a join key)."""
    plan = make_plan(pat, domain)
    shared = [v for v in pat.variables if v in domain]
    if not shared:
        return "mapsin"
    if not plan.prefix:
        return "reduce_side"
    rows, _, mx = relation_stats(store, pat, domain, tracer)
    if mx > caps.probe_cap and rows <= caps.scan_cap:
        return "reduce_side"
    return "mapsin"


# ---------------------------------------------------------------------------
# Measured a2a capacity embedding
# ---------------------------------------------------------------------------


def embed_a2a_caps(store: TripleStore, plan: PhysicalPlan,
                   caps: Caps | None, num_shards: int) -> PhysicalPlan:
    """Embed measured a2a capacities into every join step of `plan`.

    One instrumented run of the plan (cached per (plan, S) on the store)
    measures, per join step, the max per-region probe load — which sizes
    the per-destination a2a probe buckets — and the max range-entry count
    any probe covers — which sizes the a2a answer return leg (min'd with
    the configured probe/row caps: never looser than the budget).
    ``out_cap`` stays the drop-free fallback when nothing was measurable
    (a single-step scan never probes) or when the tuning run overflowed:
    the sharded run keeps out_cap rows PER SHARD, so a truncated
    single-store measurement would under-size the buckets. With
    ``caps=None`` the drop-free bound is read off the plan's own step
    caps (a pre-compiled plan arriving via execute_sharded carries its
    budget in its steps)."""
    ck = ("a2a_embed", plan, num_shards)
    hit = store.plan_cache.get(ck)
    if hit is not None:
        return hit
    if caps is None:
        # the structural drop-free bound of THIS plan: a shard never
        # routes more probes per step than that step has input bindings
        out_caps = [st.caps.out_cap for st in plan.steps[1:]
                    if st.kind in ("mapsin", "multiway")]
        bound = max(out_caps) if out_caps else plan.steps[0].caps.out_cap
    else:
        bound = caps.out_cap
    from repro_torch.core import bgp  # bgp imports this module at top level
    stats: list = []
    probe = dataclasses.replace(plan, route_shards=num_shards)
    bnd = bgp.execute_local(store, probe, "mapsin", bgp.ExecConfig(),
                            stats=stats)
    loads = [st["deliveries_max_region"] for st in stats
             if st["kind"] not in ("scan", "reduce_side")
             and "deliveries_max_region" in st]
    overflowed = int(bnd.overflow) > 0
    if not loads or overflowed:
        bucket = bound
    else:
        bucket = min(max(max(loads), 8), bound)
    join_stats = [st for st in stats if st["kind"] != "scan"]
    steps = [plan.steps[0]]
    for st, stat in zip(plan.steps[1:], join_stats):
        scaps = dataclasses.replace(st.caps, a2a_bucket_cap=bucket)
        if not overflowed and st.kind in ("mapsin", "multiway"):
            measured = quantize_cap(max(stat.get("probe_len_max", 0), 1))
            if st.kind == "multiway":
                scaps = dataclasses.replace(
                    scaps, row_cap=min(measured, st.caps.row_cap))
            else:
                scaps = dataclasses.replace(
                    scaps, probe_cap=min(measured, st.caps.probe_cap))
        steps.append(dataclasses.replace(st, caps=scaps))
    out = dataclasses.replace(plan, steps=tuple(steps))
    store.plan_cache[ck] = out
    return out


# ---------------------------------------------------------------------------
# explain
# ---------------------------------------------------------------------------


def _fmt_term(t, decode: Callable | None) -> str:
    if is_var(t):
        return t
    if decode is not None:
        try:
            return f"<{decode(int(t))}>"
        except (IndexError, KeyError, ValueError):
            pass
    return f"<{int(t)}>"


def _fmt_pattern(p: Pattern, decode: Callable | None) -> str:
    return " ".join(_fmt_term(t, decode) for t in p.terms)


def explain(plan: PhysicalPlan, stats: list | None = None,
            decode: Callable | None = None) -> str:
    """Human-readable rendering of a PhysicalPlan: per step the operator,
    patterns, estimated in/out rows + max probe fan-out, and the embedded
    caps. With `stats` (the per-step dicts an instrumented execute_local
    appends) each step also shows ACTUAL output rows, the per-step
    overflow counter and the estimated-vs-actual drift. `decode` (e.g.
    Dictionary.term) renders constant ids as terms."""
    lines = [f"PhysicalPlan: {len(plan.steps)} steps, "
             f"ordering={plan.ordering}, est_cost={plan.cost:.0f}, "
             f"vars=({', '.join(plan.var_order)})"]
    for i, st in enumerate(plan.steps):
        pats = " | ".join(_fmt_pattern(p, decode) for p in st.patterns)
        c = st.caps
        if st.kind == "scan":
            caps_s = f"out={c.out_cap}"
        elif st.kind == "reduce_side":
            caps_s = (f"scan={c.scan_cap} probe={c.probe_cap} "
                      f"out={c.out_cap} bucket={c.bucket_cap}")
        elif st.kind == "multiway":
            caps_s = f"row={c.row_cap} out={c.out_cap} a2a={c.a2a_bucket_cap}"
        else:
            caps_s = (f"probe={c.probe_cap} out={c.out_cap} "
                      f"a2a={c.a2a_bucket_cap}")
        est = (f"est_out={st.est_out}" if st.kind == "scan"
               else f"est_in={st.est_in} est_out={st.est_out} "
                    f"fanout_max={st.est_fanout_max}")
        line = f"  [{i}] {st.kind:<11s} {{{pats}}}  {est}  caps: {caps_s}"
        if stats is not None and i < len(stats):
            act = stats[i]["n_out"]
            drift = (act / st.est_out if st.est_out
                     else (float("inf") if act else 1.0))
            line += (f"  actual: rows={act} "
                     f"overflow={stats[i].get('overflow', 0)} "
                     f"drift=x{drift:.2f}")
            if "wall_s" in stats[i]:
                line += f" wall={stats[i]['wall_s'] * 1e3:.2f}ms"
        lines.append(line)
    if stats is not None:
        est_final = plan.steps[-1].est_out if plan.steps else 0
        act_final = stats[-1]["n_out"] if stats else 0
        lines.append(f"  est cost {plan.cost:.0f}; final rows "
                     f"est={est_final} actual={act_final}")
        total_ovf = sum(st.get("overflow", 0) for st in stats)
        if total_ovf:
            lines.append(f"  !! {total_ovf} rows dropped by capacity "
                         f"truncation — raise the reported caps")
    return "\n".join(lines)
