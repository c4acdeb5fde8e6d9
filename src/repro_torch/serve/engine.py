"""Batched multi-query executor (DESIGN.md §5), on one device.

The serving observation: a production query stream is many instances of
FEW plan shapes — the same BGP template with different constants (every
tenant asks "students of <their> department"). The engine exploits that:

* ``plan_signature`` canonicalizes a planned query into a **template**
  (variables renamed in first-occurrence order, every distinct constant
  replaced by a pre-bound pseudo-variable slot ``?_kN``) plus the slot
  value vector. Queries with equal templates differ only in constants.
* The template cascade seeds the initial Bindings domain with the const
  slots as already-bound columns, so the UNCHANGED core primitives
  (``mapsin_step`` / ``multiway_step`` — ``make_plan`` resolves a slot
  exactly like any bound variable) execute it; ``torch.func.vmap`` over
  the slot vector turns one query's cascade into a whole batch of
  queries in ONE dispatch. Under ``vmap`` each index kernel launches
  once a step for the whole batch: the store is shared by every slot,
  so the kernels' vmap rules (``kernels/ops.py``) fold the batch into
  the query dimension.
* A shape-bucketing scheduler groups the mixed request stream by
  template, pads each bucket to a power-of-two batch (bounded set of
  batch shapes), runs one bucket per ``step()``, and applies admission
  control: ``submit`` rejects with ``EngineBusy`` beyond ``max_queue``,
  a dispatch takes at most ``max_batch`` requests; a ``min_batch`` /
  ``max_wait_s`` policy (aging override) can defer sub-batch dispatches
  so capacity near saturation is not burned on tiny batches. Built
  batched cascades live in an ``LRUCache`` so a many-template tenant mix
  cannot grow host memory forever.

* **Robustness layer** (DESIGN.md §7): a completed dispatch that
  reports nonzero overflow is not delivered truncated — the engine
  replans the query at geometrically escalated Caps (``escalate_caps``,
  bounded by ``max_escalations``) and re-enqueues it; the final attempt
  drops to the unrestricted planner's exact ``reduce_side`` fallback
  via ``execute_local``. Per-query deadlines shed expired queries with
  structured ``QueryTimeout`` results; a full queue sheds by priority
  (``QueryShed`` + ``retry_after``) before raising ``EngineBusy`` (which
  carries the compiled plan and the hint).

The engine runs on the store's device: the card for a CUDA store, the
CPU (with the kernels' plain versions) for a CPU store. The sharded
(mesh) engine of the JAX package, with its a2a capacity aggregation and
its fault injection, is not ported yet: a ``mesh``, a ``fault_plan`` or
``check_answers=True`` raises.

Results are per-slot Bindings — bit-identical row sets to
``execute_local`` on the same (patterns, cfg, caps). MAPSIN operators
only: reduce-side re-scans relations with an empty domain, which a
seeded-constant template cannot express — the engine compiles with
``planner.ENGINE_OPERATORS``, so under a truncating cap budget (probe
fan-out beyond probe_cap) ``execute_local``'s unrestricted planner may
switch a step to the exact reduce_side fallback while the engine
truncates (and surfaces it in ``QueryResult.overflow`` / ``.stats``);
with non-truncating caps the row sets are identical.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from collections import deque
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import mapsin as ms
from repro_torch.core.bgp import ExecConfig, execute_local
from repro_torch.core.mapsin import Bindings, apply_residual, compact
from repro_torch.core.plan import make_plan, probe_ranges, residual_values
from repro_torch.core.planner import (ENGINE_OPERATORS, Caps, PhysicalPlan,
                                      PlanStep, compile_plan, escalate_caps)
from repro_torch.core.rdf import Pattern, is_var, unpack3
from repro_torch.core.triple_store import LRUCache, TripleStore
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import Span, Tracer, spans_from_stats
from repro_torch.serve.sparql import ParsedQuery, parse_bgp

# engine lifecycle events (DESIGN.md §8): admission at DEBUG, shed /
# escalation / fallback / timeout at INFO. No handler is installed here —
# with default logging config the effective level is WARNING, so a
# healthy engine is silent.
log = logging.getLogger("repro_torch.serve")


class EngineBusy(RuntimeError):
    """Admission control: the request queue is at max_queue depth and no
    queued request has strictly lower priority than the incoming one.

    Carries the planning work the rejection would otherwise waste:
    ``plan`` is the compiled PhysicalPlan (a client-side retry submits it
    directly and skips replanning — the signature cache then skips even
    the canonicalization) and ``retry_after`` is the engine's estimate in
    seconds of when a slot frees up (measured per-dispatch service time x
    queue depth in dispatches), 0.0 before any dispatch has been timed."""

    def __init__(self, msg: str, plan: PhysicalPlan | None = None,
                 retry_after: float = 0.0):
        super().__init__(msg)
        self.plan = plan
        self.retry_after = retry_after


@dataclasses.dataclass(frozen=True)
class Template:
    """Canonical plan shape: steps over renamed variables + const slots.
    Steps are ``planner.PlanStep``s whose caps are the engine's BASE
    budget — any per-query embedded (tuned) caps are stripped so that
    same-shape queries with different measured fan-outs still share one
    compiled batched cascade (the per-query values ride the requests and
    are aggregated per dispatch)."""
    steps: tuple[PlanStep, ...]
    const_vars: tuple[str, ...]     # ("?_k0", ...) pre-bound slot columns

    @property
    def n_consts(self) -> int:
        return len(self.const_vars)


def plan_signature(store: TripleStore, patterns: Sequence[Pattern],
                   cfg: ExecConfig = ExecConfig(), caps: Caps = Caps(),
                   mode: str = "mapsin", plan: PhysicalPlan | None = None):
    """Compile the query (cost-based planner, engine operator set), then
    canonicalize the ordered steps.

    Returns ``(template, consts, var_order)``: the hashable Template (the
    bucket key — equal templates share one compiled batched cascade), the
    (n_consts,) int32 slot values, and the query's result variable order
    (original names, exactly ``execute_local``'s order). Repeated
    constants share a slot, which preserves multiway prefix[0] equality
    in the template exactly as in the concrete plan."""
    if plan is None:
        plan = compile_plan(store, patterns, caps, mode=mode,
                            reorder=cfg.reorder,
                            operators=ENGINE_OPERATORS)
    rename: dict[str, str] = {}
    slots: dict[int, int] = {}
    const_vals: list[int] = []

    def sub(term):
        if is_var(term):
            if term not in rename:
                rename[term] = f"?v{len(rename)}"
            return rename[term]
        cid = int(term)
        if cid not in slots:
            slots[cid] = len(const_vals)
            const_vals.append(cid)
        return f"?_k{slots[cid]}"

    tsteps = tuple(
        PlanStep(st.kind, tuple(Pattern(sub(p.s), sub(p.p), sub(p.o))
                                for p in st.patterns), caps)
        for st in plan.steps)
    template = Template(tsteps, tuple(f"?_k{i}"
                                      for i in range(len(const_vals))))
    return template, np.asarray(const_vals, np.int32), plan.var_order


def _seed_scan(pattern: Pattern, const_vars: tuple[str, ...],
               keys: torch.Tensor, consts: torch.Tensor, out_cap: int,
               impl: str, scratch: Bindings) -> Bindings:
    """First-pattern scan with the constant slots as an already-bound
    domain: ``scan_pattern`` generalized from an empty domain to a 1-row
    seed table carrying the slot values. The scan range/residuals come
    from the seed row; the output table carries the slot columns along
    (broadcast) so every later step resolves them like bound variables.
    ``scratch`` (a zeroed per-slot Bindings) supplies the padding.

    Fast path: a bound-prefix pattern with no residual filters is ONE
    range GET (searchsorted + out_cap-window gather) instead of a full
    pass over the key array — O(log N + cap) per batch slot, and
    row-for-row identical to the full scan: without residuals both take
    the first out_cap range entries in key order and surface the rest as
    overflow. Residual/equality filters force the full-scan path, where
    filtering must happen BEFORE the capacity cut — note that path
    materializes an O(N) row table PER BATCH SLOT under vmap, so
    scan-shaped first patterns are fine to serve occasionally but a
    stream of them on a large store wants small batches (it is also the
    one shape where batching buys nothing: the scan dominates)."""
    plan = make_plan(pattern, const_vars)
    seed = consts[None, :].to(torch.int32)             # (1, n_consts)
    lo, hi = probe_ranges(plan, seed)
    if plan.prefix and not plan.residual and not plan.eq_positions:
        k, valid, missed = ms.gather_range(keys, lo, hi, out_cap, impl)
        k, within = k[0], valid[0]                     # (out_cap,)
        dropped = missed[0]
    else:
        flt, msk = residual_values(plan, seed)
        within = (keys >= lo[0]) & (keys < hi[0])
        within = apply_residual(keys[None, :], within[None, :], flt, msk,
                                plan.eq_positions)[0]
        k, dropped = keys, None
    t = unpack3(k)
    n = k.shape[0]
    cols = ([consts[i].to(torch.int32).expand(n)[:, None]
             for i in range(len(const_vars))]
            + [t[pos].to(torch.int32)[:, None] for _, pos in plan.out_vars])
    rows = (torch.cat(cols, dim=-1) if cols
            else torch.zeros((n, 0), dtype=torch.int32, device=keys.device))
    table, vmask, ndrop = compact(rows, within, out_cap, buf=scratch.table)
    vmask = vmask | scratch.valid                      # zeros
    overflow = ((dropped if dropped is not None else ndrop).to(torch.int32)
                + scratch.overflow)
    return Bindings(const_vars + plan.out_var_names, table, vmask, overflow)


@dataclasses.dataclass
class QueryResult:
    request_id: int
    vars: tuple[str, ...]           # result columns (execute_local's order)
    rows: np.ndarray                # (n_valid, n_vars) int32 valid rows
    overflow: int
    select: tuple[str, ...] | None = None   # SPARQL projection, if any
    stats: dict | None = None       # per-step execution stats from the
                                    # batched cascade: {"kinds": (...),
                                    # "overflow_per_step": (...)} — the
                                    # truncation counters that localize an
                                    # undersized cap to the step that
                                    # dropped rows (never silent)

    def rows_set(self, var_order: Sequence[str] | None = None) -> set:
        vs = tuple(var_order) if var_order is not None else self.vars
        if not vs:
            return set([()] if len(self.rows) else [])
        perm = [self.vars.index(v) for v in vs]
        return set(tuple(int(r[i]) for i in perm) for r in self.rows)


@dataclasses.dataclass
class QueryTimeout(QueryResult):
    """Structured deadline-expiry result (DESIGN.md §7): the query was
    SHED, not answered — ``rows`` is always empty, never a truncated row
    set masquerading as complete. ``phase`` says where the deadline hit
    ("queued" — expired before any dispatch; "dispatch" — the batched
    cascade it rode finished past the deadline, or tripped the engine
    watchdog; "escalation" — expired while re-queued for an
    overflow-escalation retry). ``stats`` carries the partial per-step
    counters of the last completed attempt, if any."""
    phase: str = "queued"
    deadline_s: float = 0.0         # the absolute deadline (enq clock)
    waited_s: float = 0.0           # time from enqueue to expiry


@dataclasses.dataclass
class QueryShed(QueryResult):
    """Load-shedding result: the request was evicted from a full queue by
    a strictly higher-priority submit. ``retry_after`` is the engine's
    service-time-based hint in seconds for when to resubmit."""
    retry_after: float = 0.0


@dataclasses.dataclass
class _Request:
    rid: int
    tid: int                        # interned template id (the bucket key)
    template: Template
    consts: np.ndarray
    var_order: tuple[str, ...]
    select: tuple[str, ...] | None
    arrival: float | None = None    # harness-stamped, for latency accounting
    enq: float = 0.0                # enqueue clock (arrival if stamped, else
                                    # monotonic) — feeds the max_wait_s aging
    tuned: int = 0                  # this query's tuned a2a bucket cap
                                    # (0 = untuned / not applicable)
    step_caps: tuple | None = None  # measured per-join-step answer caps
    patterns: tuple | None = None   # original patterns (escalation replans)
    ecaps: Caps | None = None       # effective caps this attempt runs at
    attempt: int = 0                # completed overflow escalations so far
    deadline: float | None = None   # absolute deadline on the enq clock
    tenant: str | None = None       # shedding accounting key
    priority: int = 0               # higher wins under a full queue
    inexact_ok: bool = False        # bounded-inexact opt-in: serve capped
                                    # results + counters, never escalate
    prior_stats: dict | None = None  # last attempt's stats (timeout payload)
    est_cost: float = 0.0           # planner's estimated cost (span attrs)
    span: Span | None = None        # open root "query" trace span, if any
    tq0: float = 0.0                # tracer-clock stamp of this rung's
                                    # queue entry (-1.0 once its "queued"
                                    # span has been emitted)


def _pow2_at_least(n: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return b


_RUNG_NAMES = tuple(f"rung{i}" for i in range(8))


def _rung_name(attempt: int) -> str:
    return (_RUNG_NAMES[attempt] if attempt < len(_RUNG_NAMES)
            else f"rung{attempt}")


# shared attrs dict for the per-query admission span: a successful submit
# carries no per-query payload (the root "query" span holds it), so every
# submit span can alias ONE dict instead of allocating its own
_SUBMIT_ATTRS: dict = {}


class ServeEngine:
    """Shape-bucketing batched query engine over one TripleStore.

    ``submit`` (SPARQL text, ParsedQuery, or a Pattern sequence) enqueues
    a request; ``step`` dispatches ONE batched cascade for the fullest
    template bucket; ``drain``/``execute`` run to completion. Results are
    per-request ``QueryResult``s whose row sets equal ``execute_local``.

    ``min_batch``/``max_wait_s``: ``step`` defers while the fullest
    bucket is below ``min_batch`` UNLESS the oldest queued request has
    waited ``max_wait_s`` (then its bucket dispatches as-is) —
    latency-bounded batch aggregation; the defaults (1, 0.0) keep the
    greedy always-dispatch behavior. ``mesh``, ``axis``, ``fault_plan``,
    ``check_answers`` and ``fault_retries`` belong to the sharded engine,
    which is not ported yet: a mesh, a fault plan or checked answers
    raise ``ValueError``.
    """

    def __init__(self, store: TripleStore, dictionary=None,
                 cfg: ExecConfig = ExecConfig(), caps: Caps = Caps(),
                 mode: str = "mapsin",
                 max_batch: int = 32, max_queue: int = 256,
                 compile_cache_size: int = 32, starvation_limit: int = 4,
                 mesh=None, axis: str = "data",
                 min_batch: int = 1, max_wait_s: float = 0.0,
                 max_escalations: int = 3,
                 dispatch_timeout_s: float | None = None,
                 fault_plan=None, check_answers: bool | None = None,
                 fault_retries: int = 2,
                 tracer: Tracer | None = None,
                 metrics=None, name: str = "engine"):
        if mode != "mapsin":
            raise ValueError("ServeEngine serves the MAPSIN path only "
                             "(reduce-side re-scans need an empty domain)")
        if mesh is not None or fault_plan is not None or check_answers:
            raise ValueError("the sharded serving path (mesh, a2a fault "
                             "injection, answer-leg checksums) is not "
                             "ported yet")
        if min_batch > max_batch:
            raise ValueError("min_batch cannot exceed max_batch")
        self.store, self.dictionary = store, dictionary
        self.cfg, self.caps, self.mode = cfg, caps, mode
        self.max_batch, self.max_queue = max_batch, max_queue
        self.min_batch, self.max_wait_s = min_batch, max_wait_s
        self.max_escalations = max_escalations
        self.dispatch_timeout_s = dispatch_timeout_s
        # observability (DESIGN.md §8): `tracer` records query-lifecycle
        # spans (None = off — every hook is behind one `is not None`
        # test, so the default path does no extra work); `metrics` is the
        # registry lifecycle counters/histograms record into: None = the
        # process-global obs.REGISTRY, False = disabled (no-op registry),
        # or an explicit MetricsRegistry. Both are plain attributes — a
        # harness may attach/detach them on a warmed engine.
        self.tracer = tracer
        self.metrics_registry = (
            obs_metrics.REGISTRY if metrics is None
            else obs_metrics.NULL_REGISTRY if metrics is False else metrics)
        self.name = name
        self._step_span: Span | None = None
        self._t_first_dispatch: float | None = None
        self._t_last_dispatch: float | None = None
        self._compiled = LRUCache(compile_cache_size)
        self._signatures = LRUCache(max(4 * compile_cache_size, 64))
        # template interning: hashing a Template (a whole step tuple) per
        # scheduling decision is measurable python overhead at qps scale;
        # buckets key on a small int instead
        self._template_ids: dict[Template, int] = {}
        self._queue: deque[_Request] = deque()
        self._shed: list[QueryResult] = []   # shed/timeout results awaiting
                                             # delivery by the next step()
        self._next_rid = 0
        self.starvation_limit = starvation_limit
        self._head_skips = 0            # consecutive steps the oldest
                                        # request's bucket was passed over
        self.dispatches = 0             # batched cascade invocations
        self.dispatched_queries = 0     # requests served by them
        self._service_ewma = 0.0        # measured seconds per dispatch
        self.escalations = 0            # overflow-escalation re-dispatches
        self.fallbacks = 0              # exact reduce_side fallback runs
        self.timeouts = 0               # deadline-shed queries
        self.shed_by_tenant: dict = {}  # tenant -> evicted-request count

    # --- admission -------------------------------------------------------

    def pending(self) -> int:
        return len(self._queue)

    @property
    def metrics_registry(self):
        return self._metrics_registry

    @metrics_registry.setter
    def metrics_registry(self, reg) -> None:
        # the per-query fast path resolves each instrument ONCE and incs
        # through a direct handle (registry get-or-create is measurable at
        # qps scale); swapping registries invalidates those handles
        self._metrics_registry = reg
        self._m_requests: dict = {}      # tenant -> Counter
        self._m_tpl_hist: dict = {}      # tid -> latency Histogram
        self._m_ten_hist: dict = {}      # tenant -> latency Histogram
        self._m_depth = reg.gauge("serve_queue_depth")
        self._m_dispatches = reg.counter("serve_dispatches_total")
        self._m_disp_queries = reg.counter("serve_dispatched_queries_total")
        self._m_batch_hist = reg.histogram(
            "serve_batch_size", buckets=obs_metrics.DEFAULT_SIZE_BUCKETS)

    def metrics(self) -> dict:
        """JSON snapshot of the engine's metrics registry: counters,
        gauges, and histograms with estimated p50/p99 — per-template
        (``serve_template_latency_seconds``) and per-tenant
        (``serve_tenant_latency_seconds``) latency SLOs read straight
        off it. Refreshes the derived ``serve_qps`` gauge (dispatched
        queries over the first->last dispatch wall span) first. For
        Prometheus text exposition use
        ``engine.metrics_registry.to_prom_text()``. Empty when the
        engine was built with ``metrics=False``."""
        if (self._t_first_dispatch is not None
                and self._t_last_dispatch is not None
                and self._t_last_dispatch > self._t_first_dispatch):
            span = self._t_last_dispatch - self._t_first_dispatch
            self.metrics_registry.gauge("serve_qps", engine=self.name).set(
                self.dispatched_queries / span)
        return self.metrics_registry.to_dict()

    def _retry_after(self) -> float:
        """Resubmission hint in seconds: measured per-dispatch service
        time (EWMA) x queue depth in dispatches. 0.0 until a dispatch has
        been timed — an idle engine has nothing to wait for."""
        if self._service_ewma <= 0.0:
            return 0.0
        depth = max(1, -(-len(self._queue) // max(self.max_batch, 1)))
        return self._service_ewma * depth

    def _signature_for(self, patterns, caps: Caps, plan=None):
        """(tid, template, consts, var_order, tuned, step_caps, est_cost)
        for the query at a given cap budget, LRU-cached. cfg AND caps are
        part of the key: planning (ordering, multiway grouping, embedded
        capacities) depends on both, so a config change — or an
        overflow-escalated budget — must re-plan; a user-supplied plan
        keys on itself. est_cost is the planner's cost estimate, carried
        so traces can show estimated-vs-actual per query. The store's
        layout_key (which carries store_version) is part of the key too:
        a plan embeds MEASURED statistics and a2a capacities, so a
        post-ingest submit must re-plan rather than reuse a signature
        computed against the pre-ingest store."""
        sig_key = ("sig", plan if plan is not None else patterns,
                   self.cfg, caps, self.store.layout_key)
        hit = self._signatures.get(sig_key)
        self._last_plan_cached = hit is not None
        m = self.metrics_registry
        if hit is None:
            m.counter("serve_plan_cache_misses_total").inc()
            if plan is None:
                plan = self._compile(patterns, caps)
            template, consts, var_order = plan_signature(
                self.store, patterns, self.cfg, caps, self.mode, plan=plan)
            tid = self._template_ids.setdefault(template,
                                                len(self._template_ids))
            tuned, step_caps = self._plan_caps(plan, caps)
            hit = (tid, template, consts, var_order, tuned, step_caps,
                   float(plan.cost))
            self._signatures[sig_key] = hit
        else:
            m.counter("serve_plan_cache_hits_total").inc()
        return hit

    def submit(self, query, arrival: float | None = None,
               deadline_s: float | None = None, tenant: str | None = None,
               priority: int = 0, inexact_ok: bool = False) -> int:
        """Enqueue one query (SPARQL text, ParsedQuery, a compiled
        PhysicalPlan, or a Pattern sequence); returns its request id.
        Raises ValueError for malformed SPARQL / unknown terms / plans
        the template cascade cannot express (fail at the front door).

        QoS knobs (DESIGN.md §7): `deadline_s` bounds total time in the
        engine — an expired query is shed with a structured QueryTimeout
        instead of occupying batch slots. `priority` breaks admission
        ties under a full queue: instead of the EngineBusy cliff, a
        higher-priority submit evicts the lowest-priority queued request
        (delivered as a QueryShed result with a `retry_after` hint);
        equal-or-lower priority still raises EngineBusy — which now
        carries the compiled plan and the retry_after hint, so the
        rejected client's planning work is not wasted. `inexact_ok`
        opts into bounded-inexact degraded mode: an overflowed result is
        served as-is with its per-step overflow counters attached
        (stats["degraded"]) rather than escalated."""
        tr = self.tracer
        if tr is None:
            return self._submit(query, arrival, deadline_s, tenant,
                                priority, inexact_ok)
        t0 = tr.now()
        try:
            rid = self._submit(query, arrival, deadline_s, tenant,
                               priority, inexact_ok)
        except Exception as e:
            tr.record("submit", t0, tr.now(), outcome=type(e).__name__,
                      tenant=tenant)
            raise
        tr.spans.append(Span("submit", t0, tr.now(), "engine",
                             _SUBMIT_ATTRS))
        return rid

    def _submit(self, query, arrival: float | None = None,
                deadline_s: float | None = None, tenant: str | None = None,
                priority: int = 0, inexact_ok: bool = False) -> int:
        tr = self.tracer
        select = None
        plan = None
        if isinstance(query, str):
            if self.dictionary is None:
                raise ValueError("SPARQL text needs a Dictionary-equipped "
                                 "engine (dictionary=...)")
            query = parse_bgp(query, self.dictionary)
        if isinstance(query, ParsedQuery):
            select = query.select
            patterns = tuple(query.patterns)
        elif isinstance(query, PhysicalPlan):
            if any(st.kind == "reduce_side" for st in query.steps):
                raise ValueError("a seeded template cascade cannot express "
                                 "reduce_side steps — compile the plan with "
                                 "planner.ENGINE_OPERATORS")
            # the engine executes templates at ITS base budget; a plan
            # compiled with a larger budget would silently truncate more
            # than its own caps promise — reject at the front door
            over = [(i, dim) for i, st in enumerate(query.steps)
                    for dim in ("out_cap", "scan_cap", "probe_cap",
                                "row_cap")
                    if getattr(st.caps, dim) > getattr(self.caps, dim)]
            if over:
                raise ValueError(
                    f"plan caps exceed the engine budget at {over[:3]} — "
                    f"build the engine with caps >= the plan's, or compile "
                    f"the plan with the engine's caps")
            plan = query
            patterns = query.patterns
        else:
            patterns = tuple(query)
        if not patterns:
            raise ValueError("empty query")
        # signature BEFORE admission: a rejected submit still returns its
        # compiled plan (satellite: EngineBusy must not waste the planning
        # work), and the LRU keeps the cost at one dict probe on repeats
        tp0 = tr.now() if tr is not None else 0.0
        tid, template, consts, var_order, tuned, step_caps, est_cost = \
            self._signature_for(patterns, self.caps, plan=plan)
        if tr is not None and not self._last_plan_cached:
            # plan spans only where planning actually ran; a cache hit is
            # one dict probe, carried as `template` on the submit span
            tr.record("plan", tp0, tr.now(), template=tid,
                      est_cost=est_cost)
        m = self._metrics_registry
        if len(self._queue) >= self.max_queue:
            victim = None
            for r in self._queue:
                if r.priority < priority and (
                        victim is None
                        or (r.priority, -r.enq) < (victim.priority,
                                                   -victim.enq)):
                    victim = r
            if victim is None:
                m.counter("serve_busy_total").inc()
                log.info("busy: queue depth %d at max_queue (tenant=%s)",
                         len(self._queue), tenant)
                raise EngineBusy(
                    f"queue depth {len(self._queue)} at max_queue",
                    plan=(plan if plan is not None
                          else self._compile(patterns)),
                    retry_after=self._retry_after())
            # graceful degradation: evict the lowest-priority (most
            # recently enqueued among ties) request instead of cliffing
            self._queue.remove(victim)
            self._shed.append(QueryShed(
                victim.rid, victim.var_order,
                np.zeros((0, len(victim.var_order)), np.int32), 0,
                victim.select, victim.prior_stats,
                retry_after=self._retry_after()))
            self.shed_by_tenant[victim.tenant] = (
                self.shed_by_tenant.get(victim.tenant, 0) + 1)
            m.counter("serve_sheds_total", tenant=str(victim.tenant),
                      reason="priority").inc()
            log.info("shed rid=%d tenant=%s priority=%d (evicted by "
                     "priority=%d)", victim.rid, victim.tenant,
                     victim.priority, priority)
            if tr is not None and victim.span is not None:
                tv = tr.now()
                if victim.tq0 >= 0:
                    tr.record("queued", victim.tq0, tv, track="query",
                              parent=victim.span, async_id=victim.rid,
                              outcome="shed")
                tr.end(victim.span, outcome="shed")
                victim.span = None
        rid = self._next_rid
        self._next_rid += 1
        enq = arrival if arrival is not None else time.monotonic()
        deadline = None if deadline_s is None else enq + deadline_s
        root = None
        tq0 = 0.0
        if tr is not None:
            # root "query" span, opened inline (its "queued"/"rung"
            # children are materialized in bulk at dispatch time — the
            # per-query tracing budget is nanoseconds, DESIGN.md §8)
            attrs = {"template": tid, "tenant": tenant,
                     "est_cost": est_cost, "n_patterns": len(patterns)}
            if priority:
                attrs["priority"] = priority
            tq0 = tr.now()
            root = Span("query", tq0, None, "query", attrs, None, None, rid)
            tr._open[root.span_id] = root
        self._queue.append(_Request(
            rid, tid, template, consts, var_order, select, arrival, enq,
            tuned, step_caps, patterns=patterns, ecaps=self.caps,
            deadline=deadline, tenant=tenant, priority=priority,
            inexact_ok=inexact_ok, est_cost=est_cost, span=root, tq0=tq0))
        c = self._m_requests.get(tenant)
        if c is None:
            c = self._m_requests[tenant] = m.counter(
                "serve_requests_total", tenant=str(tenant))
        c.inc()
        self._m_depth.set(len(self._queue))
        log.debug("admit rid=%d template=t%d tenant=%s queue=%d",
                  rid, tid, tenant, len(self._queue))
        return rid

    # --- batched execution ----------------------------------------------

    def _compile(self, patterns, caps: Caps | None = None) -> PhysicalPlan:
        """Compile the query with the engine's operator set at `caps`
        (default: the engine's base budget; escalation passes the
        escalated one)."""
        caps = self.caps if caps is None else caps
        return compile_plan(self.store, patterns, caps, mode=self.mode,
                            reorder=self.cfg.reorder,
                            operators=ENGINE_OPERATORS)

    # Per-dispatch a2a capacities belong to the sharded engine; on one
    # device there is no a2a leg, so these give what the JAX package's
    # engine gives without a mesh.

    def _plan_caps(self, plan: PhysicalPlan,
                   caps: Caps | None = None) -> tuple:
        """Per-request a2a capacity values read off the plan: (bucket
        cap, per-join-step answer caps); (0, None) without a mesh."""
        return 0, None

    def _bucket_cap_for(self, reqs: list, batch: int) -> int:
        """Per-destination a2a probe-bucket capacity of one dispatch; 0
        without a mesh."""
        return 0

    def _step_caps_for(self, reqs: list, template: Template) -> tuple:
        """Per-join-step answer caps of one dispatch: without a mesh, the
        template's base probe/row caps."""
        return tuple(st.caps.row_cap if st.kind == "multiway"
                     else st.caps.probe_cap for st in template.steps[1:])

    def _compiled_batch(self, tid: int, template: Template, batch: int,
                        bucket_cap: int, step_caps: tuple):
        # full ExecConfig + store shard layout (+ the resolved
        # bucket/answer caps) key the cache: toggling impl/caps or
        # re-pointing at a rebuilt or mutated store can never reuse a
        # stale batched cascade
        key = ("batched", tid, batch, self.cfg, self.caps,
               self.store.layout_key, bucket_cap, step_caps)
        hit = self._compiled.get(key)
        m = self.metrics_registry
        if hit is None:
            m.counter("serve_compile_cache_misses_total").inc()
            tr = self.tracer
            tc0 = tr.now() if tr is not None else 0.0
            hit = self._build(template)
            if tr is not None:
                tr.record("compile", tc0, tr.now(), track="engine",
                          parent=self._step_span, template=tid, batch=batch)
            self._compiled[key] = hit
            m.gauge("serve_compile_cache_size").set(len(self._compiled))
        else:
            m.counter("serve_compile_cache_hits_total").inc()
        return hit

    def _build(self, template: Template):
        """The template cascade for one query, vmapped over the batch:
        (keys_spo, keys_ops, consts (batch, n_consts), scratch table,
        valid, overflow) -> (table (batch, out_cap, nv), valid (batch,
        out_cap), overflow (batch,), step_ovf (batch, n_steps)
        cumulative). PyTorch runs it eagerly, so nothing is compiled: the
        cache holds the closure, and each index kernel launches once a
        step for the whole batch (the kernels' vmap rules)."""
        impl = self.cfg.impl
        steps, const_vars = template.steps, template.const_vars
        first = steps[0].patterns[0]
        first_plan = make_plan(first, const_vars)
        scratch_vars = const_vars + first_plan.out_var_names

        def one(keys_spo, keys_ops, consts, s_table, s_valid, s_overflow):
            keys_of = lambda pat, dom: (
                keys_spo if make_plan(pat, dom).index == 0 else keys_ops)
            bnd = _seed_scan(first, const_vars, keys_of(first, const_vars),
                             consts, steps[0].caps.out_cap, impl,
                             Bindings(scratch_vars, s_table, s_valid,
                                      s_overflow))
            ovfs = [bnd.overflow]
            for st in steps[1:]:
                c = st.caps
                keys = keys_of(st.patterns[0], bnd.vars)
                if st.kind == "multiway":
                    bnd = ms.multiway_step(bnd, st.patterns, keys,
                                           c.row_cap, c.out_cap, impl)
                else:
                    bnd = ms.mapsin_step(bnd, st.patterns[0], keys,
                                         c.probe_cap, c.out_cap, impl)
                ovfs.append(bnd.overflow)
            # cumulative, per step
            return bnd.table, bnd.valid, bnd.overflow, torch.stack(ovfs)

        batched = torch.func.vmap(one, in_dims=(None, None, 0, 0, 0, 0))
        return batched, scratch_vars

    def _dispatch(self, tid: int, template: Template, batch: int,
                  consts: np.ndarray, bucket_cap: int, step_caps: tuple):
        """Run one batched cascade; returns numpy copies with a leading
        shard axis of 1, as the JAX package's engine does: tables (1,
        batch, out_cap, nv), valids (1, batch, out_cap), overflow (1,
        batch), step_ovf (1, batch, n_steps) cumulative. The results come
        to the host once per dispatch, not once per request."""
        fn, scratch_vars = self._compiled_batch(tid, template, batch,
                                                bucket_cap, step_caps)
        store = self.store
        out_cap = template.steps[0].caps.out_cap
        scratch = self._scratch(scratch_vars, batch, out_cap)
        # optional profiler bracket: lines the engine dispatch up with the
        # kernels on torch.profiler's timeline when the tracer was built
        # with torch_profiler=True; a nullcontext otherwise
        bracket = (self.tracer.device_bracket(
                       f"serve_dispatch/t{tid}b{batch}", store.device)
                   if self.tracer is not None else contextlib.nullcontext())
        with bracket:
            out = fn(store.flat_keys(0), store.flat_keys(1),
                     torch.as_tensor(consts, device=store.device),
                     scratch.table, scratch.valid, scratch.overflow)
            table, valid, overflow, step_ovf = (t.cpu().numpy() for t in out)
        return table[None], valid[None], overflow[None], step_ovf[None]

    def precompile(self, query, batches: Sequence[int] | None = None):
        """Build (and warm) the query's template cascade for the given
        batch sizes — default every power of two up to max_batch — by
        running it on zeroed constants. A serving deployment calls this
        from a traffic log at startup so no live request ever waits on a
        first run (the kernels are built at their first launch)."""
        if isinstance(query, str):
            if self.dictionary is None:
                raise ValueError("SPARQL text needs a Dictionary-equipped "
                                 "engine (dictionary=...)")
            query = parse_bgp(query, self.dictionary)
        patterns = tuple(query.patterns if isinstance(query, ParsedQuery)
                         else query)
        plan = self._compile(patterns)
        template, _, _ = plan_signature(self.store, patterns, self.cfg,
                                        self.caps, self.mode, plan=plan)
        tid = self._template_ids.setdefault(template, len(self._template_ids))
        tuned, step_caps = self._plan_caps(plan)
        if batches is None:
            batches = []
            b = 1
            while b <= self.max_batch:
                batches.append(b)
                b <<= 1
        for b in batches:
            # warm the uniform-batch cap sizes for this query's tuned caps
            fake = [_Request(-1, tid, template, None, (), None, tuned=tuned,
                             step_caps=step_caps) for _ in range(b)]
            self._dispatch(tid, template, b,
                           np.zeros((b, template.n_consts), np.int32),
                           self._bucket_cap_for(fake, b),
                           self._step_caps_for(fake, template))

    def _scratch(self, scratch_vars: tuple[str, ...], batch: int,
                 out_cap: int | None = None) -> Bindings:
        """Zeroed per-slot Bindings, fresh for each dispatch: the seed
        scan takes its padding from it, and no returned result aliases
        it."""
        cap = self.caps.out_cap if out_cap is None else out_cap
        dev = self.store.device
        return Bindings(
            scratch_vars,
            torch.zeros((batch, cap, len(scratch_vars)), dtype=torch.int32,
                        device=dev),
            torch.zeros((batch, cap), dtype=torch.bool, device=dev),
            torch.zeros((batch,), dtype=torch.int32, device=dev))

    def _exact_fallback(self, r: _Request) -> QueryResult:
        """The escalation chain's guaranteed-exact terminus: run the query
        through the UNRESTRICTED planner (reduce_side available — the
        operator a seeded template cascade cannot express) via
        execute_local, escalating caps until nothing truncates (bounded;
        caps double per try so the bound is generous). Single-store
        execution: exactness beats the batched path's throughput on the
        final attempt."""
        caps = escalate_caps(r.ecaps if r.ecaps is not None else self.caps)
        self.fallbacks += 1
        self.metrics_registry.counter("serve_fallbacks_total").inc()
        log.info("exact_fallback rid=%d after %d escalations", r.rid,
                 r.attempt)
        tr = self.tracer
        fsp = (tr.begin("exact_fallback", track="query", parent=r.span,
                        async_id=r.rid, attempt=r.attempt)
               if tr is not None and r.span is not None else None)
        tries = 0
        step_stats: list | None = None
        for _ in range(8):
            tries += 1
            # traced fallbacks run the instrumented path: per-step wall
            # stamps become cascade_step child spans (tracer clock ==
            # perf_counter, the stats path's stamp clock)
            step_stats = [] if fsp is not None else None
            bnd = execute_local(self.store, r.patterns, self.mode, self.cfg,
                                caps, stats=step_stats)
            if int(bnd.overflow) == 0:
                break
            caps = escalate_caps(caps)
        if fsp is not None:
            spans_from_stats(tr, step_stats, parent=fsp, track="query",
                             async_id=r.rid)
            tr.end(fsp, tries=tries, out_cap=caps.out_cap)
        rows = bnd.table.cpu().numpy()[bnd.valid.cpu().numpy()]
        ovf = bnd.step_overflow.cpu().numpy()
        stats = {"kinds": ("fallback",),
                 "overflow_per_step": tuple(
                     int(x) for x in np.diff(ovf, prepend=0)),
                 "fallback": "reduce_side", "attempt": r.attempt,
                 "caps": caps}
        return QueryResult(r.rid, tuple(bnd.vars), rows, int(bnd.overflow),
                           r.select, stats)

    def _escalate(self, r: _Request, stats: dict) -> None:
        """Re-enqueue an overflowed request at the escalated cap budget:
        replan (new signature/template — escalated plans ride the same
        LRU caches, so a hot heavy-hitter template pays each budget's
        compile once), keep identity/deadline/enq so total latency and
        deadline accounting span all attempts."""
        ecaps = escalate_caps(r.ecaps if r.ecaps is not None else self.caps)
        tid, template, consts, var_order, tuned, step_caps, est_cost = \
            self._signature_for(r.patterns, ecaps)
        self.escalations += 1
        self.metrics_registry.counter("serve_escalations_total").inc()
        log.info("escalate rid=%d attempt=%d out_cap %d -> %d", r.rid,
                 r.attempt + 1,
                 (r.ecaps or self.caps).out_cap, ecaps.out_cap)
        tr = self.tracer
        self._queue.append(dataclasses.replace(
            r, tid=tid, template=template, consts=consts,
            var_order=var_order, tuned=tuned, step_caps=step_caps,
            ecaps=ecaps, attempt=r.attempt + 1, prior_stats=stats,
            est_cost=est_cost, tq0=tr.now() if tr is not None else 0.0))

    def _timeout(self, r: _Request, phase: str, now: float,
                 stats: dict | None = None) -> QueryTimeout:
        self.timeouts += 1
        self.metrics_registry.counter("serve_timeouts_total",
                                      phase=phase).inc()
        log.info("timeout rid=%d phase=%s waited=%.4fs", r.rid, phase,
                 max(now - r.enq, 0.0))
        tr = self.tracer
        if tr is not None and r.span is not None:
            if r.tq0 >= 0:                # still queued: wait span first
                tr.record("queued", r.tq0, tr.now(), track="query",
                          parent=r.span, async_id=r.rid, outcome="timeout",
                          phase=phase)
            tr.end(r.span, outcome="timeout", phase=phase)
            r.span = None
        return QueryTimeout(
            r.rid, r.var_order, np.zeros((0, len(r.var_order)), np.int32),
            0, r.select, stats if stats is not None else r.prior_stats,
            phase=phase, deadline_s=r.deadline or 0.0,
            waited_s=max(now - r.enq, 0.0))

    def _run_bucket(self, reqs: list[_Request],
                    now: float | None = None) -> list[QueryResult]:
        template = reqs[0].template
        n = len(reqs)
        batch = min(_pow2_at_least(n), self.max_batch)
        consts = np.zeros((batch, template.n_consts), np.int32)
        for i, r in enumerate(reqs):
            consts[i] = r.consts
        for i in range(n, batch):                    # padding slots re-run
            consts[i] = reqs[0].consts               # request 0, discarded
        bucket_cap = self._bucket_cap_for(reqs, batch)
        step_caps = self._step_caps_for(reqs, template)
        tr = self.tracer
        m = self.metrics_registry
        tq = 0.0
        if tr is not None:
            # bulk-materialize the queued-wait spans: ONE clock read and a
            # shared attrs dict per phase — this loop sits on the per-query
            # hot path, whose whole budget is ~2% of service time (§8)
            tq = tr.now()
            q_attrs: dict[str, dict] = {}
            append = tr.spans.append
            for r in reqs:
                if r.span is not None and r.tq0 >= 0:
                    key = "escalation" if r.attempt else "admit"
                    at = q_attrs.get(key)
                    if at is None:
                        at = q_attrs[key] = {"phase": key, "batch": batch}
                    append(Span("queued", r.tq0, tq, "query", at, None,
                                r.span.span_id, r.rid))
                    r.tq0 = -1.0
        t0 = time.monotonic()
        dsp = (tr.begin("dispatch", track="engine", parent=self._step_span,
                        template=reqs[0].tid, batch=batch, n=n,
                        bucket_cap=bucket_cap)
               if tr is not None else None)
        # (S, batch, out_cap, nv) tables with S == 1
        tables, valids, overflow, step_ovf = self._dispatch(
            reqs[0].tid, template, batch, consts, bucket_cap, step_caps)
        if dsp is not None:
            tr.end(dsp)
        elapsed = time.monotonic() - t0
        a = 0.3                                       # service-time EWMA
        self._service_ewma = (elapsed if self._service_ewma == 0.0
                              else a * elapsed + (1 - a) * self._service_ewma)
        end_clock = (now if now is not None else t0) + elapsed
        watchdog = (self.dispatch_timeout_s is not None
                    and elapsed > self.dispatch_timeout_s)
        nk = template.n_consts
        kinds = tuple(st.kind for st in template.steps)
        self.dispatches += 1
        self.dispatched_queries += n
        tnow = time.monotonic()
        if self._t_first_dispatch is None:
            self._t_first_dispatch = tnow - elapsed
        self._t_last_dispatch = tnow
        self._m_dispatches.inc()
        self._m_disp_queries.inc(n)
        self._m_batch_hist.observe(n)
        # delivery: rung + root spans materialize HERE, one shared `td`
        # clock read and one shared attrs dict per (attempt, outcome) —
        # nothing span-shaped is allocated per query before this point
        td = tr.now() if tr is not None else 0.0
        r_shared: dict = {}
        results = []
        for i, r in enumerate(reqs):
            # cumulative per-step counters summed over shards -> deltas:
            # which step dropped rows (probe vs out-cap truncation locale)
            cum = step_ovf[:, i, :].sum(axis=0)
            per_step = tuple(int(x) for x in np.diff(cum, prepend=0))
            stats = {"kinds": kinds, "overflow_per_step": per_step,
                     "attempt": r.attempt}
            deadline_ok = (r.deadline is None
                           or (now is None and r.arrival is not None))
            if watchdog or (not deadline_ok and end_clock > r.deadline):
                # a dispatch that finishes past the deadline (or trips the
                # engine watchdog) is SHED — never a truncated row set
                # delivered as if complete
                if tr is not None and r.span is not None:
                    tr.spans.append(Span(
                        _rung_name(r.attempt), tq, td, "query",
                        {"attempt": r.attempt, "outcome": "timeout",
                         "batch": batch, "bucket_cap": bucket_cap},
                        None, r.span.span_id, r.rid))
                results.append(self._timeout(r, "dispatch", end_clock,
                                             stats))
                continue
            ovf = int(overflow[:, i].sum())
            if ovf > 0:
                m.counter("serve_overflow_rows_total").inc(ovf)
            if (ovf > 0 and not r.inexact_ok and self.max_escalations > 0
                    and r.patterns is not None):
                if r.attempt + 1 >= self.max_escalations:
                    if tr is not None and r.span is not None:
                        tr.spans.append(Span(
                            _rung_name(r.attempt), tq, td, "query",
                            {"attempt": r.attempt, "outcome": "fallback",
                             "overflow": ovf, "batch": batch,
                             "out_cap": (r.ecaps or self.caps).out_cap,
                             "bucket_cap": bucket_cap},
                            None, r.span.span_id, r.rid))
                    res = self._exact_fallback(r)
                    results.append(res)
                    if tr is not None and r.span is not None:
                        tr.end(r.span, outcome="ok", fallback=True,
                               rows=len(res.rows))
                        r.span = None
                else:
                    if tr is not None and r.span is not None:
                        tr.spans.append(Span(
                            _rung_name(r.attempt), tq, td, "query",
                            {"attempt": r.attempt, "outcome": "escalate",
                             "overflow": ovf, "batch": batch,
                             "out_cap": (r.ecaps or self.caps).out_cap,
                             "bucket_cap": bucket_cap},
                            None, r.span.span_id, r.rid))
                    self._escalate(r, stats)
                continue
            if ovf > 0 and r.inexact_ok:
                stats["degraded"] = True     # bounded-inexact, by request
            rows = np.concatenate([tables[s, i][valids[s, i]]
                                   for s in range(tables.shape[0])]
                                  )[:, nk:nk + len(r.var_order)]
            results.append(QueryResult(r.rid, r.var_order, rows, ovf,
                                       r.select, stats))
            outcome = "degraded" if stats.get("degraded") else "ok"
            root = r.span
            if tr is not None and root is not None:
                # rung spans mark the ABNORMAL ladder (escalated attempts,
                # degraded serves); a first-attempt clean query is fully
                # told by queued + root + the engine dispatch span, and
                # that hot path skips the extra allocation
                if r.attempt or outcome != "ok":
                    at = r_shared.get((r.attempt, outcome))
                    if at is None:
                        at = r_shared[(r.attempt, outcome)] = {
                            "attempt": r.attempt, "outcome": outcome,
                            "batch": batch, "bucket_cap": bucket_cap,
                            "out_cap": (r.ecaps or self.caps).out_cap}
                    tr.spans.append(Span(_rung_name(r.attempt), tq, td,
                                         "query", at, None, root.span_id,
                                         r.rid))
                # inline tr.end(root): skips the open-table membership
                # check and a second clock read on the hottest path
                del tr._open[root.span_id]
                root.t1 = td
                root.attrs["outcome"] = outcome
                root.attrs["rows"] = len(rows)
                if ovf:
                    root.attrs["overflow"] = ovf
                tr.spans.append(root)
                r.span = None
            # per-template / per-tenant latency SLO histograms — only
            # when enqueue and completion live on the same clock domain
            # (both harness-stamped or both monotonic)
            if (r.arrival is not None) == (now is not None):
                lat = max(end_clock - r.enq, 0.0)
                h = self._m_tpl_hist.get(r.tid)
                if h is None:
                    h = self._m_tpl_hist[r.tid] = m.histogram(
                        "serve_template_latency_seconds",
                        template=f"{self.name}:t{r.tid}")
                h.observe(lat)
                h = self._m_ten_hist.get(r.tenant)
                if h is None:
                    h = self._m_ten_hist[r.tenant] = m.histogram(
                        "serve_tenant_latency_seconds",
                        tenant=str(r.tenant))
                h.observe(lat)
        return results

    # --- scheduling ------------------------------------------------------

    def step(self, now: float | None = None,
             force: bool = False) -> list[QueryResult]:
        """Dispatch the fullest template bucket (at most max_batch
        requests) as one batched cascade; [] when the queue is empty.

        Dispatch policy (min_batch/max_wait_s): when the fullest bucket
        is below `min_batch`, the dispatch is DEFERRED (returns [] with
        requests still pending) so capacity near saturation is not burned
        on tiny batches — UNLESS the oldest queued request has already
        waited `max_wait_s` on the `now` clock (arrival-stamped requests
        use the harness clock, others time.monotonic), in which case its
        bucket dispatches as-is: the aging override bounds worst-case
        queueing latency at max_wait_s + one dispatch. `force=True`
        (drain) bypasses the policy. The defaults (min_batch=1) keep the
        greedy always-dispatch behavior.

        Anti-starvation aging: fullest-first alone would let a steady
        majority template starve a minority request forever. After the
        oldest queued request's bucket has been passed over
        `starvation_limit` consecutive steps, its bucket dispatches
        next regardless of size — latency is bounded by
        starvation_limit dispatches, throughput stays batch-greedy.

        Deadline sweep (DESIGN.md §7): before picking a bucket, every
        queued request whose absolute deadline has passed on the `now`
        clock is shed with a QueryTimeout (phase "queued", or
        "escalation" for an overflow-escalation retry) — expired queries
        never occupy batch slots. Results evicted by priority shedding
        (QueryShed) are delivered here too."""
        tr = self.tracer
        m = self.metrics_registry
        if tr is None:
            out = self._step(now, force)
        else:
            sp = self._step_span = tr.begin("step", track="engine")
            try:
                out = self._step(now, force)
            except Exception:
                tr.end(sp, outcome="error")
                raise
            finally:
                self._step_span = None
            tr.end(sp, delivered=len(out), queue=len(self._queue))
        self._m_depth.set(len(self._queue))
        m.tick()
        return out

    def _step(self, now: float | None = None,
              force: bool = False) -> list[QueryResult]:
        out: list[QueryResult] = list(self._shed)
        self._shed.clear()
        if not self._queue:
            return out
        clock = now if now is not None else time.monotonic()
        # clock-domain guard: arrival-stamped requests live on the harness
        # clock — only an explicit `now` can expire them (monotonic time
        # would instantly blow every replayed deadline)
        expired = [r for r in self._queue
                   if r.deadline is not None and clock >= r.deadline
                   and (now is not None or r.arrival is None)]
        if expired:
            gone = {r.rid for r in expired}
            self._queue = deque(r for r in self._queue
                                if r.rid not in gone)
            out.extend(self._timeout(
                r, "escalation" if r.attempt > 0 else "queued", clock)
                for r in expired)
            if not self._queue:
                return out
        buckets: dict[int, list[_Request]] = {}
        for r in self._queue:
            buckets.setdefault(r.tid, []).append(r)
        head_tid = self._queue[0].tid
        if self._head_skips >= self.starvation_limit:
            pick = buckets[head_tid]
        else:
            # fullest bucket first; FIFO within a bucket (deque order)
            pick = max(buckets.values(), key=len)
        if not force and len(pick) < self.min_batch:
            if clock - self._queue[0].enq < self.max_wait_s:
                return out                # defer: let the batch fill
            pick = buckets[head_tid]      # aged past max_wait_s: serve the
                                          # oldest request's bucket as-is
        chosen = pick[:self.max_batch]
        if chosen[0].tid == head_tid:
            self._head_skips = 0
        else:
            self._head_skips += 1
        taken = {r.rid for r in chosen}
        self._queue = deque(r for r in self._queue if r.rid not in taken)
        out.extend(self._run_bucket(chosen, now=now))
        return out

    def drain(self) -> list[QueryResult]:
        out: list[QueryResult] = []
        while self._queue or self._shed:
            out.extend(self.step(force=True))
        return out

    def execute(self, queries) -> list[QueryResult]:
        """Submit + drain a closed batch, results in input order."""
        rids = [self.submit(q) for q in queries]
        by_rid = {res.request_id: res for res in self.drain()}
        return [by_rid[rid] for rid in rids]
