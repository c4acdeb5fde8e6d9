"""BGP executors over the planner's ``PhysicalPlan`` IR: one device
(``execute_local``) and a mesh of region shards (``execute_sharded``).

Planning lives in ``core/planner.py``: ``compile_plan`` turns a pattern
list into a ``PhysicalPlan`` whose steps each carry their own operator
(``scan | mapsin | multiway | reduce_side``) and static capacities
(``Caps``). The executors consume a plan; passing a raw pattern sequence
compiles one on the spot. ``ExecConfig`` is runtime-only: kernel
``impl``, collective ``routing`` and the ``reorder`` escape hatch.

Execution model: the cascade — the first-pattern scan plus every step — is
one closure per (plan, cfg), cached on the store, run eagerly on the
store's device. The default path never syncs the host: every count stays
a device tensor, and the per-step overflow counters and valid-row counts
ride back as one small tensor. Host syncs happen only on the opt-in
``stats=`` path, which records the actual row counts, the per-step
overflow and the measured probe->region fan-out that feeds
``query_traffic_actual``. An optional ``tracer`` (``obs/trace.py``)
records the plan lookup and each step as spans; it syncs nothing either.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core import distributed as dist
from repro_torch.core import mapsin as ms
from repro_torch.core import reduce_side as rs
from repro_torch.core.plan import (by_index, make_plan, probe_ranges,
                                   row_range)
from repro_torch.core.planner import (  # noqa: F401  (re-exported API surface)
    ALL_OPERATORS, Caps, LogicalPlan, PhysicalPlan, PlanStep, _host_keys,
    compile_plan, explain, order_patterns, pattern_cardinality, quantize_cap)
from repro_torch.core.rdf import INF_KEY
from repro_torch.core.triple_store import (TripleStore, _shard_sorted,
                                           range_intersects_region)
from repro_torch.kernels.ops import IMPLS
from repro_torch.obs.trace import Tracer, clock, optional_span


ROUTINGS = ("broadcast", "a2a")


@dataclasses.dataclass(frozen=True)
class ExecConfig:
    """Runtime-only knobs. ``impl="kernel"`` runs the hand-written CUDA
    kernels on the card (their plain versions on the CPU); ``"torch"``
    forces the plain versions everywhere. ``routing`` picks the
    distributed GET's collective: ``"broadcast"`` or ``"a2a"``
    (point-to-point region routing)."""
    impl: str = "kernel"         # kernel | torch
    routing: str = "broadcast"   # dist_probe collective: broadcast | a2a
    reorder: bool = True         # False = execute patterns as given

    def __post_init__(self):
        if self.impl not in IMPLS:
            raise ValueError(f"ExecConfig.impl must be one of {IMPLS}, "
                             f"got {self.impl!r}")
        if self.routing not in ROUTINGS:
            raise ValueError(f"ExecConfig.routing must be one of "
                             f"{ROUTINGS}, got {self.routing!r}")


def as_plan(store: TripleStore | None, query, mode: str = "mapsin",
            cfg: ExecConfig = ExecConfig(), caps: Caps = Caps(),
            num_shards: int = 0, route_shards: int = 10,
            tracer: Tracer | None = None) -> PhysicalPlan:
    """Resolve a query argument (PhysicalPlan | LogicalPlan | patterns)
    into a PhysicalPlan."""
    if isinstance(query, PhysicalPlan):
        return query
    return compile_plan(store, query, caps, mode=mode, reorder=cfg.reorder,
                        routing=cfg.routing, num_shards=num_shards,
                        route_shards=route_shards, tracer=tracer)


# ---------------------------------------------------------------------------
# Traffic accounting (bytes shipped by the collectives; static formulas)
# ---------------------------------------------------------------------------


def step_traffic_bytes(step: PlanStep, mode: str, num_shards: int,
                       n_vars_before: int) -> int:
    """Global bytes crossing the interconnect for one step (padding
    included), from the step's OWN caps.

    Modes:
      mapsin         — broadcast GET: probe keys and match counts are
                       all-gathered, matches reduce-scattered home.
      mapsin_routed  — point-to-point GET: each probe travels to its owner
                       shard once and its matches travel back once.
      reduce         — shuffle BOTH relations (repartition join).
    """
    s, b = num_shards, step.caps.out_cap
    if s == 1 or step.kind == "scan":
        return 0
    cap = (step.caps.row_cap if step.kind == "multiway"
           else step.caps.probe_cap)
    if step.kind == "reduce_side":
        mode = "reduce"     # a hybrid plan's reduce step shuffles whatever
                            # the comparison mode prices the OTHER steps at
    if mode == "mapsin":
        keys = s * b * (8 + 8 + 24) * (s - 1)          # all_gather lo/hi/filters
        counts = s * (s * b) * 4 * (s - 1)             # all_gather counts
        matches = s * (s * b) * cap * 8                # psum_scatter ring pass
        return keys + counts + matches
    if mode == "mapsin_routed":
        keys = s * b * (8 + 8 + 4)                     # a2a probe records
        matches = s * b * cap * 8                      # a2a matches home
        return keys + matches
    # reduce-side: shuffle Omega and the scanned relation in full
    nv_left = n_vars_before
    per_rel = s * s * step.caps.bucket_cap * 4         # rows x int32 cols
    rounds = len(step.patterns)
    return rounds * (per_rel * (nv_left + 3) + per_rel)  # + validity bytes


def a2a_step_payload_bytes(bucket_cap: int, answer_cap: int,
                           num_shards: int) -> int:
    """Static per-shard a2a collective payload of ONE dist_probe round:
    per non-local destination, the probe bucket's (lo, hi) records out
    plus the answer return leg (answer_cap key slots + count + missed per
    bucket slot). The local diagonal block never crosses the network and
    is excluded. The one shared formula (the serving engine's traffic
    accounting calls it); the per-leg split lives next to the wire format
    itself (``distributed.a2a_leg_bytes``)."""
    probe, answer = dist.a2a_leg_bytes(bucket_cap, answer_cap, num_shards)
    return probe + answer


def query_traffic(query, mode: str, caps: Caps = Caps(),
                  num_shards: int = 1,
                  store: TripleStore | None = None) -> int:
    """Total modeled interconnect bytes for a query (paper's network
    metric). `query` may be a compiled PhysicalPlan or a pattern list
    (planned heuristically when no store supplies statistics)."""
    plan = as_plan(store, query, caps=caps)
    total = 0
    seen: set[str] = set()
    for st in plan.steps:
        total += step_traffic_bytes(st, mode, num_shards, len(seen))
        for p in st.patterns:
            seen.update(p.variables)
    return total


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------


def local_step(bnd: ms.Bindings, st: PlanStep, keys_spo, keys_ops,
               impl: str, found: list | None = None) -> ms.Bindings:
    """One join step of the local cascade (any step but the first
    pattern's scan) at the step's own caps: the operator the planner
    chose for it, on the index ``by_index`` picks. `found` goes to the
    step's ``compact`` calls (mapsin.py)."""
    c = st.caps
    if st.kind == "reduce_side":     # relation scanned fresh: empty domain
        for pat in st.patterns:
            bnd = rs.local_reduce_step(
                bnd, pat, by_index(pat, (), keys_spo, keys_ops), c.scan_cap,
                c.probe_cap, c.out_cap, impl, found)
        return bnd
    keys = by_index(st.patterns[0], bnd.vars, keys_spo, keys_ops)
    if st.kind == "multiway":
        return ms.multiway_step(bnd, st.patterns, keys, c.row_cap, c.out_cap,
                                impl, found)
    return ms.mapsin_step(bnd, st.patterns[0], keys, c.probe_cap, c.out_cap,
                          impl, found)


def _cascade_body(plan: PhysicalPlan, cfg: ExecConfig):
    """The whole-cascade computation:
    (keys_spo, keys_ops, scratch, tracer=None) -> (Bindings, counts).

    Each step runs the operator the planner chose for it, at the caps the
    plan embeds. `counts` is one (2 * n_steps,) int32 tensor: the
    CUMULATIVE overflow counter after each step, so overflow can be
    localized to its step without the instrumented run's host syncs, then
    each step's valid rows before its out_cap cut (what its output
    ``compact`` found among the slots it searched), less that cut. A
    `tracer` (a call argument, never part of the cached closure) records
    each step as a span named by its operator, with its index, its slots
    and its cut.
    """
    steps = plan.steps
    first = steps[0].patterns[0]
    first_vars = make_plan(first, ()).out_var_names
    names = tuple("bgp." + st.kind for st in steps)

    def fn(keys_spo, keys_ops, scratch, tracer: Tracer | None = None):
        bnd, ovfs, founds = None, [], []
        for i, st in enumerate(steps):
            found = []
            with optional_span(tracer, names[i], step=i) as sp:
                if st.kind == "scan":
                    bnd = ms.scan_pattern(
                        first, by_index(first, (), keys_spo, keys_ops),
                        st.caps.out_cap, cfg.impl, scratch=scratch,
                        found=found)
                else:
                    bnd = local_step(bnd, st, keys_spo, keys_ops, cfg.impl,
                                     found)
            ovfs.append(bnd.overflow)
            founds.append(found[-1][0])
            if sp is not None:
                sp.attrs.update(slots=found[-1][1], cut=found[-1][2])
        return bnd, torch.stack(ovfs + founds)

    return fn, first_vars


def _cascade_key(plan: PhysicalPlan, cfg: ExecConfig) -> tuple:
    return ("cascade", plan, cfg)


def _compiled_cascade(store: TripleStore, plan: PhysicalPlan,
                      cfg: ExecConfig):
    """The cascade closure for (plan, cfg), cached on the store."""
    key = _cascade_key(plan, cfg)
    hit = store.plan_cache.get(key)
    if hit is None:
        hit = _cascade_body(plan, cfg)
        store.plan_cache[key] = hit
    return hit


def _check_plan_mode(query, mode: str):
    """A compiled plan carries its own operators, so `mode` is only
    meaningful as a reduce-baseline request: asking for 'reduce' on a
    mapsin-compiled plan would silently time the wrong engine."""
    if not isinstance(query, PhysicalPlan):
        return
    if mode == "reduce" and any(st.kind in ("mapsin", "multiway")
                                for st in query.steps):
        raise ValueError("mode='reduce' with a compiled mapsin plan — "
                         "operators are baked into the plan; use "
                         "compile_plan(..., mode='reduce') for the baseline")


def execute_local(store: TripleStore, query, mode: str = "mapsin",
                  cfg: ExecConfig = ExecConfig(), caps: Caps = Caps(),
                  stats: list | None = None,
                  route_shards: int | None = None,
                  tracer: Tracer | None = None) -> ms.Bindings:
    """Single-shard execution on the store's device.

    `query` is a compiled ``PhysicalPlan`` or a raw pattern sequence
    (compiled cost-based on the spot — cached on the store). The default
    path runs the cached cascade with no host sync; the returned Bindings
    carries ``step_overflow``, the cumulative overflow after each step.
    When `stats` is a list (opt-in instrumentation, off the hot path), the
    cascade runs stepwise and appends per-step dicts with actual row
    counts, the per-step overflow and the measured probe->region fan-out.
    An explicit `route_shards` overrides the plan's measurement size.

    With a `tracer`, the call is a ``bgp.execute_local`` span, nested in
    whatever span is open on the tracer, over ``bgp.plan`` (the plan and
    the cascade closure from the store's plan cache; attribute ``hit``;
    the planner's spans inside it on a miss) and one span per cascade
    step: ``bgp.scan``, ``bgp.mapsin``, ``bgp.multiway`` or
    ``bgp.reduce_side``, with attributes ``step``, ``slots`` and
    ``cut``. The tracer adds no device operation and no host sync: the
    steps' valid rows stay on the device in the root's ``counts`` until
    ``read_step_counts``."""
    _check_plan_mode(query, mode)
    with optional_span(tracer, "bgp.execute_local") as root:
        with optional_span(tracer, "bgp.plan") as psp:
            seen = len(tracer.spans) if psp is not None else 0
            plan = as_plan(store, query, mode, cfg, caps,
                           route_shards=(10 if route_shards is None
                                         else route_shards),
                           tracer=tracer)
            if (route_shards is not None and isinstance(query, PhysicalPlan)
                    and plan.route_shards != route_shards):
                plan = dataclasses.replace(plan, route_shards=route_shards)
            if stats is not None:
                return _execute_local_instrumented(store, plan, cfg, stats)
            if psp is not None:
                # a plan compiled here recorded planner spans
                psp.attrs["hit"] = (len(tracer.spans) == seen
                                    and _cascade_key(plan, cfg)
                                    in store.plan_cache)
            fn, first_vars = _compiled_cascade(store, plan, cfg)
        scratch = ms.Bindings.empty(first_vars, plan.steps[0].caps.out_cap,
                                    store.device)
        bnd, counts = fn(store.flat_keys(0), store.flat_keys(1), scratch,
                         tracer)
        bnd.step_overflow = counts[:len(plan.steps)]
        if root is not None:
            root.attrs["counts"] = counts
    return bnd


def read_step_counts(tracer: Tracer) -> None:
    """Put ``found``, its valid rows before the out_cap cut, on each
    traced cascade step span. The counts ride in the small tensor each
    traced ``execute_local`` left on its root span (``counts``); they are
    copied here, one copy a call, after the traced work, which a copy
    during it would have made wait for the device."""
    counts = {sp.span_id: sp.attrs.pop("counts").tolist()
              for sp in tracer.spans
              if sp.name == "bgp.execute_local" and "counts" in sp.attrs}
    for sp in tracer.spans:
        c = counts.get(sp.parent_id)
        if c is not None and "step" in sp.attrs:
            sp.attrs["found"] = (c[len(c) // 2 + sp.attrs["step"]]
                                 + sp.attrs["cut"])


def _route_splits(store: TripleStore, index: int, s: int) -> np.ndarray:
    """Region boundaries for a hypothetical `s`-shard layout of the index:
    the stored splits when the store is already sharded that way, otherwise
    exactly what build_store would pick (same _shard_sorted rule)."""
    if s == store.num_shards:
        return store.splits(index).cpu().numpy()
    ck = ("route_splits", index, s)
    if ck not in store.plan_cache:
        keys = _host_keys(store, index)
        keys = keys[keys < INF_KEY]
        _, splits, _ = _shard_sorted(keys, s)
        store.plan_cache[ck] = splits
    return store.plan_cache[ck]


def _probe_fanout(store: TripleStore, plan, bnd: ms.Bindings, s: int,
                  whole_row: bool = False) -> tuple[int, int, int]:
    """Measured routing fan-out if each probe were routed only to shards
    whose key range it intersects. Returns (total deliveries, max
    per-region load, max range-entry count per probe)."""
    lo, hi = (row_range if whole_row else probe_ranges)(plan, bnd.table)
    lo, hi = lo.cpu().numpy(), hi.cpu().numpy()
    valid = bnd.valid.cpu().numpy()
    splits = _route_splits(store, plan.index, s)
    hits = range_intersects_region(lo[:, None], hi[:, None],
                                   splits[None, :-1], splits[None, 1:])
    per_region = hits[valid].sum(axis=0)
    keys = _host_keys(store, plan.index)
    lens = (np.searchsorted(keys, hi[valid])
            - np.searchsorted(keys, lo[valid]))
    return (int(per_region.sum()), int(per_region.max(initial=0)),
            int(lens.max(initial=0)))


def _execute_local_instrumented(store: TripleStore, plan: PhysicalPlan,
                                cfg: ExecConfig, stats: list):
    steps = plan.steps
    keys_spo, keys_ops = store.flat_keys(0), store.flat_keys(1)
    s_route = plan.route_shards
    t0 = clock()
    first = steps[0].patterns[0]
    bnd = ms.scan_pattern(first, by_index(first, (), keys_spo, keys_ops),
                          steps[0].caps.out_cap, cfg.impl)
    ovf_prev = int(bnd.overflow)
    ovf_cum = [ovf_prev]
    t1 = clock()
    # per-step wall stamps (t0/t1 on obs.trace.clock, the tracer's own
    # clock, wall_s the delta) ride the stats dicts only on this opt-in
    # path
    stats.append({"kind": "scan", "n_in": 0, "n_out": int(bnd.count()),
                  "nv": len(bnd.vars), "relation": int(bnd.count()),
                  "n_patterns": 1, "overflow": ovf_prev,
                  "t0": t0, "t1": t1, "wall_s": t1 - t0})
    for st in steps[1:]:
        c = st.caps
        t0 = clock()
        n_in, nv_in = int(bnd.count()), len(bnd.vars)
        deliveries = max_region = probe_len = 0
        if st.kind in ("mapsin", "multiway"):     # the GET's routing
            deliveries, max_region, probe_len = _probe_fanout(
                store, make_plan(st.patterns[0], bnd.vars), bnd, s_route,
                whole_row=st.kind == "multiway")
        bnd = local_step(bnd, st, keys_spo, keys_ops, cfg.impl)
        n_out = int(bnd.count())         # host sync: the step's work is done
        t1 = clock()                     # before the relation-scan extras
        rel = 0
        for pat in st.patterns:
            r = ms.scan_pattern(pat, by_index(pat, (), keys_spo, keys_ops),
                                c.scan_cap, cfg.impl)
            rel += int(r.count())
        ovf_now = int(bnd.overflow)
        stats.append({"kind": st.kind, "n_in": n_in,
                      "n_out": n_out, "nv": nv_in,
                      "relation": rel, "n_patterns": len(st.patterns),
                      "deliveries": deliveries, "route_shards": s_route,
                      "deliveries_max_region": max_region,
                      "probe_len_max": probe_len,
                      "overflow": ovf_now - ovf_prev,
                      "t0": t0, "t1": t1, "wall_s": t1 - t0})
        ovf_prev = ovf_now
        ovf_cum.append(ovf_now)
    bnd.step_overflow = torch.tensor(ovf_cum, dtype=torch.int32,
                                     device=store.device)
    return bnd


def query_traffic_actual(stats: list, mode: str, num_shards: int,
                         n_triples: int = 0) -> dict:
    """Data-movement bytes from ACTUAL row counts (vs the static-capacity
    model in query_traffic). Two components, mirroring the paper's setting:

    network — what crosses the interconnect per join step:
      mapsin_routed — each input mapping's 20 B probe record travels once
                      per region its key range intersects (the measured
                      "deliveries") and each match comes back once (12 B);
      mapsin        — broadcast GET: 44 B probe records x (S-1), matches
                      once;
      reduce        — Omega + the (already filtered) relation are shuffled.

    scanned — storage bytes read to produce the step's input:
      reduce        — no index: every pattern forces a full pass over the
                      dataset in the map phase;
      mapsin        — index GETs: ~log2(N) binary-search touches per probe
                      plus the matched entries only.
    """
    s = num_shards
    net = 0
    scanned = 0
    routed = broadcast = 0                 # probe records: routed vs x(S-1)
    logn = max(math.ceil(math.log2(max(n_triples, 2))), 1)
    for st in stats:
        rounds = 1 if st["kind"] == "multiway" else st["n_patterns"]
        if st["kind"] == "scan":
            if mode == "reduce":
                scanned += n_triples * 8          # full pass, no index
            else:
                scanned += st["n_out"] * 8 + logn * 8  # index range scan
            continue
        # a planner-selected reduce_side step shuffles and re-scans its
        # relation whatever the comparison mode
        if st["kind"] == "reduce_side" or mode not in ("mapsin",
                                                       "mapsin_routed"):
            row_l = st["nv"] * 4 + 4
            if s > 1:
                net += st["n_patterns"] * (st["n_in"] * row_l
                                           + st["relation"] * 16)
            scanned += st["n_patterns"] * n_triples * 8
            continue
        rec_routed, rec_bcast, match_b = 20, 44, 12
        deliv = (st["deliveries"] if st.get("route_shards") == s
                 and "deliveries" in st else st["n_in"])
        routed += deliv * rec_routed * rounds
        broadcast += st["n_in"] * rec_bcast * (s - 1) * rounds
        if mode == "mapsin_routed":
            if s > 1:
                net += deliv * rec_routed * rounds + st["n_out"] * match_b
            scanned += st["n_in"] * rounds * logn * 8 + st["n_out"] * 8
        else:  # mode == "mapsin" (broadcast probe records)
            if s > 1:
                net += (st["n_in"] * rec_bcast * (s - 1) * rounds
                        + st["n_out"] * match_b)
            scanned += st["n_in"] * rounds * logn * 8 + st["n_out"] * 8
    return {"network": net, "scanned": scanned, "total": net + scanned,
            "probe_bytes_routed": routed, "probe_bytes_broadcast": broadcast}


# ---------------------------------------------------------------------------
# Distributed executor (a mesh of region shards, core/collectives.py)
# ---------------------------------------------------------------------------


def apply_dist_step(bnd: ms.Bindings, st: PlanStep, keys_spo, keys_ops,
                    splits_spo, splits_ops, cfg: ExecConfig, comm,
                    batched: bool = False, fault=None,
                    with_check: bool = False):
    """One distributed cascade step (any step but the first pattern's
    scan) at the step's OWN caps, on the index ``by_index`` picks (this
    shard's keys, the store's region splits) — the one dispatch behind
    execute_sharded's per-shard body and the serving engine's batched
    template cascade (`batched=True` expects Bindings with a leading
    query axis and routes the whole batch through ONE collective round
    per step; a batched reduce_side step raises ValueError).
    `fault`/`with_check` hook the a2a answer-leg integrity machinery
    (serve/faults.py): with_check returns ``(Bindings, bad)`` and
    requires the batched a2a path."""
    c = st.caps
    if st.kind == "reduce_side":     # relation scanned fresh: empty domain
        if batched:
            raise ValueError("a batched (seeded template) cascade cannot "
                             "run reduce_side steps")
        for pat in st.patterns:
            bnd = rs.dist_reduce_step(
                bnd, pat, by_index(pat, (), keys_spo, keys_ops), c.scan_cap,
                c.bucket_cap, c.probe_cap, c.out_cap, comm, cfg.impl)
        return bnd
    keys = by_index(st.patterns[0], bnd.vars, keys_spo, keys_ops)
    splits = by_index(st.patterns[0], bnd.vars, splits_spo, splits_ops)
    extra = ({"fault": fault, "with_check": with_check}
             if batched and (fault is not None or with_check) else {})
    if st.kind == "multiway":
        fn = (dist.batched_dist_multiway_step if batched
              else dist.dist_multiway_step)
        return fn(bnd, st.patterns, keys, c.row_cap, c.out_cap, comm,
                  cfg.impl, shard_splits=splits, routing=cfg.routing,
                  bucket_cap=c.a2a_bucket_cap, **extra)
    fn = dist.batched_dist_mapsin_step if batched else dist.dist_mapsin_step
    return fn(bnd, st.patterns[0], keys, c.probe_cap, c.out_cap, comm,
              cfg.impl, shard_splits=splits, routing=cfg.routing,
              bucket_cap=c.a2a_bucket_cap, **extra)


def _sharded_fn(plan: PhysicalPlan, cfg: ExecConfig, splits_spo=None,
                splits_ops=None):
    """The per-shard body of `plan`: (comm, this shard's keys_spo row,
    keys_ops row) -> (table (out_cap, nv), valid, overflow (1,)). The
    splits are the store's device tensors, taken once per closure."""
    steps = plan.steps
    first = steps[0].patterns[0]

    def fn(comm, keys_spo, keys_ops):
        keys_spo = keys_spo.reshape(-1)
        keys_ops = keys_ops.reshape(-1)
        bnd = ms.scan_pattern(first, by_index(first, (), keys_spo, keys_ops),
                              steps[0].caps.out_cap, cfg.impl)
        for st in steps[1:]:
            bnd = apply_dist_step(bnd, st, keys_spo, keys_ops, splits_spo,
                                  splits_ops, cfg, comm)
        return bnd.table, bnd.valid, bnd.overflow[None]
    return fn


def execute_sharded(store: TripleStore, query, mesh, mode: str = "mapsin",
                    cfg: ExecConfig = ExecConfig(), axis: str = "data",
                    routing: str | None = None, caps: Caps = Caps()):
    """Distributed execution on `mesh` (``core/collectives.py``; the store
    sharded to the mesh size on `axis`, shard s holding row s of the
    store's key arrays). `query` is a PhysicalPlan or a pattern sequence
    (compiled cost-based with num_shards = the mesh size, so a2a
    capacities are embedded from measurement at compile time). Probes are
    routed via the stored region splits: with cfg.routing == "broadcast"
    every shard sees every probe and answers only ranges intersecting its
    slice; with "a2a" each probe record is shipped point-to-point to
    exactly the intersecting shards. `routing` overrides cfg.routing when
    given. Returns (table (S*cap, nv), valid, overflow (S,), vars)."""
    if routing is not None:
        cfg = dataclasses.replace(cfg, routing=routing)
    _check_plan_mode(query, mode)
    s = int(mesh.shape[axis])
    if store.num_shards != s:
        raise ValueError(f"store has {store.num_shards} shards but mesh "
                         f"axis {axis!r} has {s}")
    if mesh.device != store.device:
        raise ValueError(f"the mesh runs on {mesh.device}, the store is on "
                         f"{store.device}")
    plan = as_plan(store, query, mode, cfg, caps, num_shards=s)
    if (cfg.routing == "a2a"
            and any(st.kind in ("mapsin", "multiway")
                    and st.caps.a2a_bucket_cap == 0
                    for st in plan.steps[1:])):
        # pre-compiled plan without embedded a2a caps: embed now, with the
        # drop-free bound read off the plan's OWN steps (caps=None)
        from repro_torch.core.planner import embed_a2a_caps
        plan = embed_a2a_caps(store, plan, None, s)
    # one closure per (plan, cfg, mesh), cached on the store
    ck = ("sharded", plan, cfg, axis, mesh.fingerprint(axis))
    fn = store.plan_cache.get(ck)
    if fn is None:
        fn = _sharded_fn(plan, cfg, splits_spo=store.splits_spo,
                         splits_ops=store.splits_ops)
        store.plan_cache[ck] = fn
    keys_spo, keys_ops = store.keys_spo, store.keys_ops
    outs = mesh.run(lambda comm: fn(comm, keys_spo[comm.index],
                                    keys_ops[comm.index]))
    table, valid, overflow = (torch.cat(x) for x in zip(*outs))
    return table, valid, overflow, plan.var_order


def rows_set(table, valid, n_vars: int) -> set[tuple[int, ...]]:
    """Materialize valid rows as a python set (host-side, for comparisons)."""
    t = table.cpu().numpy()[valid.cpu().numpy()]
    if n_vars == 0:
        return set([()] if len(t) else [])
    return set(map(tuple, t[:, :n_vars].tolist()))
