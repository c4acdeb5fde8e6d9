"""The port's own spans and counters, for the per-layer metrics that read
them (`portbench/layer_metrics/`).

The window calls the port as `sut.ask` does, with no tracer. What the port
records from inside (a `repro_torch.obs.trace.Tracer` through
`build_store`, `parse_bgp`, `compile_plan` and `execute_local`) comes from
a replay after the window, on the window's own graph, queries and caps:

1. the graph loaded anew into a store with the tracer: its `store.build`
   span and the host sorts, dedups and upload inside;
2. each query of the mix once on that store, its plan cache cold: the
   `bgp.plan` spans that miss, with `planner.compile` and
   `planner.relation_stats` inside (the warm-up's first round);
3. `ROUNDS` closed-loop rounds of the queries, each a `request` span over
   the port's spans and a `copy_out` span, under torch.profiler; each
   kernel goes to the innermost span open when it was launched (its CUDA
   runtime launch event, found by correlation id), and each step's valid
   rows are read after the rounds.

A window metric is the replay's figure for each query, weighted by that
query's runs in the window, over the window's answers (the way
`roofline.py`'s bytes are counted). The replay prints to standard error
the clock's offset from the profiler's stamps, each query's device time
step by step, the rounds' idle time by span, and the tracer's cost. A
port that records no spans of its own gives no reading, and no replay.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import inspect
import statistics
import sys
import time

from portbench import sut

ROUNDS = 3           # profiled rounds of the mix's queries
COST_ROUNDS = 6      # unprofiled rounds, each query untraced and traced
STEPS = ("bgp.scan", "bgp.mapsin", "bgp.multiway", "bgp.reduce_side")
PROBE_STEPS = ("bgp.mapsin", "bgp.multiway")
REDUCE_STEPS = ("bgp.reduce_side",)
HOST_SPANS = ("sparql.parse", "bgp.plan")


def supported() -> bool:
    """Whether the port records spans of its own: `build_store`,
    `parse_bgp` and `execute_local` take a tracer."""
    sut.import_port()
    from repro_torch.core import bgp, triple_store
    from repro_torch.serve import sparql
    fns = (triple_store.build_store, sparql.parse_bgp, bgp.execute_local)
    return hasattr(bgp, "read_step_counts") and all(
        "tracer" in inspect.signature(f).parameters for f in fns)


@dataclasses.dataclass
class ProgramTrace:
    """A replay's record: the tracer's spans (their stamps in seconds on
    the profiler's clock), the profiled rounds' kernels as (name, start_ns,
    dur_ns, launch_ns or None) and every device operation as (start_ns,
    dur_ns), with the rounds' bounds in ns and how many there were."""
    spans: list
    kernels: list = dataclasses.field(default_factory=list)
    ops: list = dataclasses.field(default_factory=list)
    t0_ns: int = 0
    t1_ns: int = 0
    rounds: int = ROUNDS
    offset_ns: int = 0           # the profiler's clock less the span clock

    def by_id(self) -> dict:
        return {s.span_id: s for s in self.spans}

    def query_of(self, span, by_id: dict) -> str | None:
        """The `query` of the `request` span above `span`."""
        while span is not None and span.name != "request":
            span = by_id.get(span.parent_id)
        return None if span is None else span.attrs.get("query")

    def in_rounds(self, span) -> bool:
        return self.t0_ns <= _ns(span.t0) and _ns(span.t1) <= self.t1_ns

    def store_build_s(self) -> float | None:
        builds = [s.dur for s in self.spans if s.name == "store.build"]
        return sum(builds) if builds else None

    def planner_setup_s(self) -> float | None:
        """Host time of the plan lookups that missed the plan cache."""
        cold = [s.dur for s in self.spans
                if s.name == "bgp.plan" and s.attrs.get("hit") is False]
        return sum(cold) if cold else None

    def kernel_spans(self) -> list:
        """(kernel, the innermost span open at its launch or None)."""
        ks = sorted((k for k in self.kernels if k[3] is not None),
                    key=lambda k: k[3])
        spans = [(_ns(s.t0) + self.offset_ns, _ns(s.t1) + self.offset_ns, s)
                 for s in self.spans if s.t1 is not None]
        inner = innermost(spans, [k[3] for k in ks])
        return list(zip(ks, [x[2] if x else None for x in inner]))

    def per_query(self) -> dict:
        """{query: {field: value a run}} over the profiled rounds:
        `host_ms` (the front end and the plan lookup), `probe_device_ms`,
        `reduce_device_ms` (kernels launched in those steps; None without
        a device trace), `found` and `slots` (summed over the steps)."""
        by_id = self.by_id()
        out = collections.defaultdict(lambda: dict.fromkeys(
            ("host_ms", "probe_device_ms", "reduce_device_ms", "found",
             "slots"), 0.0))
        for s in self.spans:
            if not self.in_rounds(s):
                continue
            q = self.query_of(s, by_id)
            if q is None:
                continue
            row = out[q]
            if s.name in HOST_SPANS:
                row["host_ms"] += s.dur * 1e3
            if s.name in STEPS and "found" in s.attrs:
                row["found"] += s.attrs["found"]
                row["slots"] += s.attrs["slots"]
        for k, s in self.kernel_spans():
            q = self.query_of(s, by_id) if s is not None else None
            if q is None:
                continue
            if s.name in PROBE_STEPS:
                out[q]["probe_device_ms"] += k[2] / 1e6
            elif s.name in REDUCE_STEPS:
                out[q]["reduce_device_ms"] += k[2] / 1e6
        for row in out.values():
            for f in row:
                row[f] /= self.rounds
            if not self.kernels:
                row["probe_device_ms"] = row["reduce_device_ms"] = None
        return dict(out)

    def per_answer(self, window, field: str) -> float | None:
        """The field's value a run of each query, times that query's runs
        in the window, over the window's answers."""
        pq = self.per_query()
        runs = collections.Counter(r.key for r in window.requests
                                   if r.status == "ok")
        answered = window.answered_in_window()
        vals = [(n, pq[q][field]) for q, n in runs.items() if q in pq]
        if not answered or not vals or any(v is None for _, v in vals):
            return None
        return sum(n * v for n, v in vals) / answered

    def slot_fill(self, window) -> float | None:
        """Valid rows over the slots searched, in %, every step of the
        window (each query's steps times its runs)."""
        pq = self.per_query()
        runs = collections.Counter(r.key for r in window.requests
                                   if r.status == "ok")
        found = sum(n * pq[q]["found"] for q, n in runs.items() if q in pq)
        slots = sum(n * pq[q]["slots"] for q, n in runs.items() if q in pq)
        return 100.0 * found / slots if slots else None

    def idle_by_span(self) -> dict:
        """{label: s} of the rounds' idle device time, each gap labelled by
        the innermost span open at its middle."""
        busy: list = []
        for t0, d in sorted(self.ops):
            if busy and t0 <= busy[-1][1]:
                busy[-1][1] = max(busy[-1][1], t0 + d)
            else:
                busy.append([t0, t0 + d])
        edges = [self.t0_ns] + [x for iv in busy for x in iv] + [self.t1_ns]
        gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
        spans = [(_ns(s.t0) + self.offset_ns, _ns(s.t1) + self.offset_ns, s)
                 for s in self.spans if s.t1 is not None]
        inner = innermost(spans, [(a + b) // 2 for a, b in gaps])
        out: collections.Counter = collections.Counter()
        for (a, b), x in zip(gaps, inner):
            out[x[2].name if x else "outside any span"] += (b - a) / 1e9
        return dict(out.most_common())


def _ns(t: float) -> int:
    return round(t * 1e9)


def innermost(spans: list, points: list) -> list:
    """For each point (ascending), the innermost of `spans` ((t0, t1, x),
    the shortest with t0 <= point < t1) open at it, or None."""
    order = sorted(spans, key=lambda s: s[0])
    out, nxt, active = [], 0, []
    for p in points:
        while nxt < len(order) and order[nxt][0] <= p:
            active.append(order[nxt])
            nxt += 1
        active = [s for s in active if s[1] > p]
        out.append(min(active, key=lambda s: s[1] - s[0], default=None))
    return out


def ask(store, dictionary, text: str, caps, tracer, key: str):
    """`sut.ask` with the port's tracer: the query's spans under one
    `request` span. Returns the valid rows."""
    from repro_torch.core import ExecConfig, execute_local
    from repro_torch.serve import parse_bgp
    with tracer.span("request", query=key):
        pq = parse_bgp(text, dictionary, tracer=tracer)
        bnd = execute_local(store, pq.patterns, caps=caps,
                            cfg=ExecConfig(impl="kernel"), tracer=tracer)
        with tracer.span("copy_out"):
            rows = bnd.table[bnd.valid].cpu().numpy()
            int(bnd.overflow)
    return rows


class LaunchTrace:
    """`with LaunchTrace(torch) as lt:` records the block's CUDA work with
    torch.profiler: `lt.kernels` (name, start_ns, dur_ns, launch_ns or
    None) and `lt.ops` (start_ns, dur_ns) of every device operation, with
    the launch of each kernel from its CUDA runtime event. Before the
    block one launch of a kernel already loaded is bracketed between two
    reads of the span clock: `lt.offset_ns` is how far its runtime
    event's stamp lies outside the bracket (0 inside it), `lt.bracket_ns`
    the bracket's width."""

    def __init__(self, torch):
        self.torch = torch
        self.kernels: list = []
        self.ops: list = []
        self.offset_ns = 0
        self.bracket_ns = None

    def __enter__(self):
        from repro_torch.obs.trace import clock_ns
        torch = self.torch
        buf = torch.zeros(1, device="cuda")        # the fill kernel loaded
        prof = torch.profiler
        self._prof = prof.profile(activities=[prof.ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize()
        self._a = clock_ns()
        buf.fill_(1)                      # the session's first launch
        self._b = clock_ns()
        torch.cuda.synchronize()
        self.t0 = clock_ns()
        return self

    def __exit__(self, *exc):
        from repro_torch.obs.trace import clock_ns
        self.torch.cuda.synchronize()
        self.t1 = clock_ns()
        self._prof.__exit__(*exc)
        self.bracket_ns = self._b - self._a
        self.kernels, self.ops, r = read_events(
            self._prof.profiler.kineto_results.events(), self.t0, self.t1)
        if r is None:
            print("[program] clock: no launch before the rounds in the "
                  "trace; offset not measured", file=sys.stderr)
        else:
            self.offset_ns = (0 if self._a <= r <= self._b else
                              r - self._b if r > self._b else r - self._a)
            print(f"[program] clock: the bracketed launch's runtime event "
                  f"{r - self._a} ns after the bracket's start, bracket "
                  f"{self.bracket_ns} ns wide, offset {self.offset_ns} ns",
                  file=sys.stderr)
        return False


def read_events(events, t0: int, t1: int) -> tuple:
    """(kernels, ops, first) from Kineto's events: the kernels (name,
    start_ns, dur_ns, launch_ns or None) and device operations (start_ns,
    dur_ns) that started in [t0, t1], each kernel's launch the CUDA API
    call (`cuda...`/`cu...`) of its correlation id, and the stamp of the
    session's first kernel launch before t0 (None where there is none)."""
    launch, kernels, ops, first = {}, [], [], None
    for e in events:
        corr, name, start = e.correlation_id(), e.name(), e.start_ns()
        if "CUDA" not in str(e.device_type()):
            if corr and name.startswith("cu"):
                launch[corr] = min(start, launch.get(corr, start))
                if "Launch" in name and start < t0:
                    first = start if first is None else min(first, start)
            continue
        if not t0 <= start <= t1:
            continue
        ops.append((start, e.duration_ns()))
        if not name.startswith(("Memcpy", "Memset")):
            kernels.append((name, start, e.duration_ns(), corr))
    return ([(n, s, d, launch.get(c)) for n, s, d, c in kernels], ops,
            first)


def replay(loop, device: str) -> ProgramTrace:
    """The replay of the module's docstring over a closed loop's graph,
    queries and caps; on a CUDA `device` the rounds are profiled."""
    import torch
    from repro_torch.core import build_store
    from repro_torch.core.bgp import read_step_counts
    from repro_torch.obs.trace import Tracer, to_ns
    began = time.perf_counter()
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    tracer = Tracer()
    store = build_store(loop.graph.triples, device=device, tracer=tracer)
    queries = dict(sorted(loop.queries.items()))
    for key, text in queries.items():
        ask(store, loop.dictionary, text, loop.caps, tracer, key)
    sync()
    lt = LaunchTrace(torch) if on_card else None
    t0 = tracer.now()
    with lt if lt is not None else contextlib.nullcontext():
        for _ in range(ROUNDS):
            for key, text in queries.items():
                ask(store, loop.dictionary, text, loop.caps, tracer, key)
    t1 = tracer.now()
    read_step_counts(tracer)
    cost = tracer_cost(store, loop, queries, sync) if on_card else None
    del store
    if lt is None:
        pt = ProgramTrace(tracer.spans, [], [], to_ns(t0), to_ns(t1))
    else:
        pt = ProgramTrace(tracer.spans, lt.kernels, lt.ops, lt.t0, lt.t1,
                          offset_ns=lt.offset_ns)
    report(pt, cost)
    print(f"[program] replay {time.perf_counter() - began:.3f} s",
          file=sys.stderr)
    return pt


def tracer_cost(store, loop, queries: dict, sync) -> dict:
    """{query: (untraced, traced) median latency in ms}: each query run
    untraced and traced with a fresh tracer, in turns that swap their
    order each round, `COST_ROUNDS` times, no profiler on."""
    from repro_torch.obs.trace import Tracer
    from portbench.devtrace import Spans
    times = collections.defaultdict(lambda: ([], []))
    for n in range(COST_ROUNDS):
        for key, text in queries.items():
            for traced in ((False, True) if n % 2 == 0 else (True, False)):
                t0 = time.perf_counter()
                if traced:
                    ask(store, loop.dictionary, text, loop.caps, Tracer(),
                        key)
                else:
                    sut.ask(store, loop.dictionary, text, loop.caps,
                            Spans(False))
                sync()
                times[key][traced].append((time.perf_counter() - t0) * 1e3)
    return {k: (statistics.median(u), statistics.median(t))
            for k, (u, t) in times.items()}


def report(pt: ProgramTrace, cost: dict | None) -> None:
    """The replay's findings on standard error."""
    p = lambda s: print(f"[program] {s}", file=sys.stderr)
    hits = [s.attrs.get("hit") for s in pt.spans if s.name == "bgp.plan"]
    p(f"store.build {pt.store_build_s()} s; cold plan lookups "
      f"{pt.planner_setup_s()} s; plan cache {hits.count(True)} hits, "
      f"{hits.count(False)} misses")
    host = collections.defaultdict(list)
    for s in pt.spans:
        if s.name.startswith(("store.", "planner.")):
            host[s.name].append(s.dur)
    for name, ds in host.items():
        p(f"  {name}: {len(ds)} spans, {sum(ds):.6f} s")
    if pt.kernels:
        by_id = pt.by_id()
        steps = collections.defaultdict(float)
        labels = collections.Counter()
        for k, s in pt.kernel_spans():
            labels[s.name if s is not None else "outside any span"] += k[2]
            q = pt.query_of(s, by_id) if s is not None else None
            if q is not None and s.name in STEPS:
                steps[(q, s.attrs["step"], s.name)] += k[2] / 1e6 / pt.rounds
        total = sum(k[2] for k in pt.kernels)
        n_q = len({q for q, _, _ in steps}) or 1
        p(f"kernels: {len(pt.kernels)} in {pt.rounds} rounds, "
          f"{len(pt.kernels) / pt.rounds / n_q:.1f} a query; "
          f"{total / 1e9:.6f} s, by the innermost span at launch: "
          + ", ".join(f"{n} {100 * v / total:.2f}%"
                      for n, v in labels.most_common()))
        for (q, i, name), ms in sorted(steps.items()):
            p(f"  {q} step {i} {name}: {ms:.4f} device ms a run")
        idle = pt.idle_by_span()
        p(f"idle {sum(idle.values()):.6f} s of "
          f"{(pt.t1_ns - pt.t0_ns) / 1e9:.6f} s: "
          + ", ".join(f"{n} {v:.6f} s" for n, v in idle.items()))
    for q, row in sorted(pt.per_query().items()):
        p(f"  {q} a run: " + ", ".join(
            f"{f} {v:.6g}" if v is not None else f"{f} none"
            for f, v in row.items()))
    if cost:
        for q, (u, t) in sorted(cost.items()):
            p(f"  tracer cost {q}: untraced {u:.4f} ms, traced {t:.4f} ms")
        d = [t - u for u, t in cost.values()]
        p(f"tracer cost: median of the queries' traced less untraced "
          f"{statistics.median(d):.4f} ms")


def of(ctx) -> ProgramTrace | None:
    """The replay for a traced window's context, made at the first
    reader's call and kept on the context; None where the loop ran no
    port (a control) or the port records no spans of its own."""
    if not hasattr(ctx, "program_trace"):
        loop = ctx.loop
        ok = (all(hasattr(loop, a) for a in ("graph", "queries", "caps",
                                             "dictionary", "device"))
              and getattr(loop, "control", None) is None and supported())
        ctx.program_trace = replay(loop, loop.device) if ok else None
    return ctx.program_trace
