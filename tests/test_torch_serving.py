"""The port's batched serving engine against the JAX package's, stream by
stream.

The same numpy-seeded request streams go through ``repro.serve``'s
``ServeEngine`` (jnp path) and ``repro_torch.serve``'s (CPU stores, so the
kernels' plain versions run, folded by their vmap rules): per-request
results (type, rows, overflow, per-step overflow, stats), the dispatch,
escalation, fallback, timeout and shed counters, the compile-cache
counters and the span tree must be identical. The cases mirror the
single-device ones of tests/test_serving.py and tests/test_robustness.py
(not the mesh and FaultPlan ones: the sharded engine is not ported).
Timeouts run on a virtual clock (``arrival=`` / ``step(now=)``)."""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.obs as jobs
from repro.core.rdf import Pattern
from repro.data import lubm_like as j_lubm, sp2b_like as j_sp2b
from repro.serve import EngineBusy as JBusy, ServeEngine as JEngine

import repro_torch.obs as tobs
from repro_torch.core import (Caps, ExecConfig, build_store, compile_plan,
                              execute_local, execute_oracle, pattern_from,
                              rows_set)
from repro_torch.core.planner import ENGINE_OPERATORS
from repro_torch.data import lubm_like, sp2b_like
from repro_torch.data.rdf_gen import LUBM_SPARQL
from repro_torch.kernels import ops
from repro_torch.serve import (EngineBusy, QueryShed, QueryTimeout,
                               ServeEngine, plan_signature)

CAPS = dict(scan_cap=4096, out_cap=4096, probe_cap=16, row_cap=64)
TINY = dict(scan_cap=4096, out_cap=8, probe_cap=2, row_cap=4)
BENCH = dict(out_cap=128, probe_cap=32, row_cap=16)   # the serving bench's
CHAIN = [Pattern("?x", 101, "?y"), Pattern("?y", 102, "?z")]
LATENCY = ("serve_template_latency_seconds", "serve_tenant_latency_seconds")


def random_graph(rng, n=500, subjects=40, preds=5, objects=40):
    return np.stack([rng.randint(0, subjects, n),
                     rng.randint(100, 100 + preds, n),
                     rng.randint(0, objects, n)], 1).astype(np.int32)


@pytest.fixture(scope="module")
def graph():
    """One random graph (the reference tests' shape) in both packages."""
    tr = random_graph(np.random.RandomState(0))
    return dict(triples=tr, ts=build_store(tr, device="cpu"),
                js=jcore.build_store(tr), d=None, dj=None)


@pytest.fixture(scope="module")
def tenants():
    out = {}
    for name, tgen, jgen, arg in (("lubm", lubm_like, j_lubm, 1),
                                  ("sp2b", sp2b_like, j_sp2b, 120)):
        tr, d, _ = tgen(arg)
        trj, dj, _ = jgen(arg)
        out[name] = dict(triples=tr, d=d, dj=dj, arg=arg,
                         ts=build_store(tr, device="cpu"),
                         js=jcore.build_store(trj))
    return out


class FakeClock:
    def __init__(self):
        self._n = itertools.count()

    def __call__(self):
        return next(self._n) * 1e-3


def _tq(q):
    """A query of the JAX package's kind in the port's kind."""
    if isinstance(q, (str, jcore.PhysicalPlan)):
        return q
    return [pattern_from(p) for p in q]


class Pair:
    """One ServeEngine of each package with the same arguments; every call
    goes to both and their answers are compared."""

    def __init__(self, g, caps=CAPS, tracer=False, **kw):
        self.rt, self.rj = tobs.MetricsRegistry(), jobs.MetricsRegistry()
        self.tt = tobs.Tracer(clock=FakeClock()) if tracer else None
        self.tj = jobs.Tracer(clock=FakeClock()) if tracer else None
        self.t = ServeEngine(g["ts"], g["d"], caps=Caps(**caps),
                             metrics=self.rt, tracer=self.tt, **kw)
        self.j = JEngine(g["js"], g["dj"], caps=jcore.Caps(**caps),
                         metrics=self.rj, tracer=self.tj, **kw)

    def submit(self, q, **kw):
        a = self.t.submit(_tq(q), **kw)
        assert a == self.j.submit(q, **kw)
        return a

    def step(self, **kw):
        return same_results(self.t.step(**kw), self.j.step(**kw))

    def drain(self):
        return same_results(self.t.drain(), self.j.drain())

    def execute(self, qs):
        return same_results(self.t.execute([_tq(q) for q in qs]),
                            self.j.execute(qs))

    def precompile(self, q, **kw):
        self.t.precompile(_tq(q), **kw)
        self.j.precompile(q, **kw)

    def check(self):
        """Counters, queue and the registries (latency histograms by count:
        their values are wall times)."""
        for name in ("dispatches", "dispatched_queries", "escalations",
                     "fallbacks", "timeouts", "shed_by_tenant"):
            assert getattr(self.t, name) == getattr(self.j, name), name
        assert self.t.pending() == self.j.pending()
        assert len(self.t._compiled) == len(self.j._compiled)
        assert (self.t._service_ewma > 0) == (self.j._service_ewma > 0)
        st, sj = self.rt.to_dict(), self.rj.to_dict()
        assert st["counters"] == sj["counters"]
        assert st["gauges"] == sj["gauges"]
        assert st["histograms"].keys() == sj["histograms"].keys()
        for k, h in st["histograms"].items():
            if k.startswith(LATENCY):
                assert h["count"] == sj["histograms"][k]["count"], k
            else:
                assert h == sj["histograms"][k], k
        return st


def _stats(stats):
    if stats is None:
        return None
    return {k: dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v
            for k, v in stats.items()}


def same_results(got, want):
    """Port results equal the reference's: type, rows bit for bit,
    overflow, per-step overflow and the rest of stats."""
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert type(a).__name__ == type(b).__name__
        assert (a.request_id, a.vars, a.overflow, a.select) == (
            b.request_id, b.vars, b.overflow, b.select)
        assert a.rows.dtype == np.int32
        np.testing.assert_array_equal(a.rows, np.asarray(b.rows))
        assert _stats(a.stats) == _stats(b.stats)
        if isinstance(a, QueryTimeout):
            assert (a.phase, a.deadline_s) == (b.phase, b.deadline_s)
            if a.phase != "dispatch":        # else it holds a wall time
                assert a.waited_s == b.waited_s
        if isinstance(a, QueryShed):
            assert (a.retry_after > 0) == (b.retry_after > 0)
    return got


def _local_set(store, pats, caps, vars_want):
    bnd = execute_local(store, _tq(pats), "mapsin", caps=Caps(**caps))
    got = rows_set(bnd.table, bnd.valid, len(bnd.vars))
    perm = [bnd.vars.index(v) for v in vars_want]
    return set(tuple(r[i] for i in perm) for r in got)


# ---------------------------------------------------------------------------
# plan signatures (the bucket key)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pats", [
    [Pattern("?x", 101, 7), Pattern("?x", 102, "?y")],
    [Pattern("?s", 101, 9), Pattern("?s", 102, "?t")],
    [Pattern(3, 101, "?x"), Pattern(3, 102, "?y")],
    [Pattern("?x", 101, 7)],
], ids=str)
def test_plan_signature_matches_reference(graph, pats):
    from repro.serve import plan_signature as j_signature
    t, c, v = plan_signature(graph["ts"], _tq(pats), caps=Caps(**CAPS))
    tj, cj, vj = j_signature(graph["js"], pats, caps=jcore.Caps(**CAPS))
    assert t.const_vars == tj.const_vars and v == vj
    assert [(st.kind, tuple(pattern_from(p) for p in st.patterns),
             dataclasses.asdict(st.caps)) for st in t.steps] == [
        (st.kind, tuple(pattern_from(p) for p in st.patterns),
         dataclasses.asdict(st.caps)) for st in tj.steps]
    assert c.dtype == np.int32
    np.testing.assert_array_equal(c, np.asarray(cj))


# ---------------------------------------------------------------------------
# batched execution == reference == execute_local == oracle
# ---------------------------------------------------------------------------


def test_mixed_stream_matches_reference_local_and_oracle(graph):
    queries = [[Pattern("?x", 101, c), Pattern("?x", 102, "?y")]
               for c in (1, 5, 9, 13)]
    queries += [[Pattern(c, 103, "?a"), Pattern("?a", 104, "?b")]
                for c in (2, 7)]
    queries.append([Pattern("?x", 100, "?y"), Pattern("?y", 101, "?z")])
    e = Pair(graph, max_batch=4)
    results = e.execute(queries)
    e.check()
    assert e.t.dispatches == 3                    # one per template
    for pats, res in zip(queries, results):
        assert res.rows_set() == _local_set(graph["ts"], pats, CAPS,
                                            res.vars)
        want, ovars = execute_oracle(graph["triples"], _tq(pats))
        assert res.rows_set(ovars) == want and res.overflow == 0


def test_multiway_star_and_repeated_constant_templates(graph):
    star = [[Pattern("?x", 101, c), Pattern("?x", 102, "?a"),
             Pattern("?x", 103, "?b"), Pattern("?x", 104, "?c")]
            for c in (0, 3, 6, 11)]
    rep = [[Pattern(c, 101, "?x"), Pattern(c, 102, "?y")] for c in (3, 4)]
    e = Pair(graph, max_batch=4)
    results = e.execute(star + rep)
    e.check()
    assert e.t.dispatches == 2
    for pats, res in zip(star + rep, results):
        want, ovars = execute_oracle(graph["triples"], _tq(pats))
        assert res.rows_set(ovars) == want


@pytest.mark.parametrize("tenant", ["lubm", "sp2b"])
def test_seeded_stream_matches_reference(tenants, tenant):
    """The serving bench's request shapes with numpy-seeded constants, at
    its caps with escalation off: every result equals the reference's and
    the port's execute_local at the same caps."""
    g = tenants[tenant]
    stream = _stream(tenant, g["arg"], np.random.RandomState(0), 24)
    e = Pair(g, caps=BENCH, max_batch=4, max_queue=64, max_escalations=0)
    results = e.execute([[g["dj"].pattern(*t) for t in q] for q in stream])
    e.check()
    assert e.t.dispatches < len(stream)           # shapes actually shared
    for q, res in zip(stream, results):
        pats = [g["d"].pattern(*t) for t in q]
        assert res.rows_set() == _local_set(g["ts"], pats, BENCH, res.vars)


def test_lubm_sparql_text_stream(tenants):
    g = tenants["lubm"]
    caps = dict(scan_cap=1 << 15, out_cap=1 << 13, probe_cap=128, row_cap=64)
    e = Pair(g, caps=caps, max_batch=4)
    names = sorted(LUBM_SPARQL)
    results = e.execute([LUBM_SPARQL[n] for n in names])
    e.check()
    assert e.t.dispatches < len(names)
    for n, res in zip(names, results):
        assert len(res.rows) > 0, n


def test_overflow_is_surfaced_per_slot(graph):
    e = Pair(graph, caps=TINY, max_escalations=0)
    res = e.execute([CHAIN])[0]
    e.check()
    assert res.overflow > 0
    assert sum(res.stats["overflow_per_step"]) == res.overflow
    assert len(res.stats["overflow_per_step"]) == len(res.stats["kinds"])


# ---------------------------------------------------------------------------
# scheduler: bucketing, admission control, compile cache
# ---------------------------------------------------------------------------


def test_admission_control_queue_depth(graph):
    e = Pair(graph, max_queue=4)
    pats = [Pattern("?x", 101, 7)]
    for _ in range(4):
        e.submit(pats)
    with pytest.raises(EngineBusy):
        e.t.submit(_tq(pats))
    with pytest.raises(JBusy):
        e.j.submit(pats)
    e.drain()
    e.submit(pats)
    e.drain()
    e.check()


def test_per_bucket_max_batch_and_fullest_first(graph):
    e = Pair(graph, max_batch=4, max_queue=64)
    e.submit([Pattern("?x", 101, 3), Pattern("?x", 102, "?y")])
    for c in range(10):
        e.submit([Pattern("?x", 101, c % 13)])
    assert len(e.step()) == 4                     # the fuller bucket
    e.drain()
    st = e.check()
    assert e.t.dispatches == 4                    # 4 + 4 + 2 slots, then 1
    assert e.t.dispatched_queries == 11
    assert st["histograms"]["serve_batch_size"]["count"] == 4


def test_compile_cache_is_lru_bounded_and_keyed_on_caps(graph):
    shapes = [[Pattern("?x", 101, 1)],
              [Pattern("?x", 101, 2), Pattern("?x", 102, "?y")],
              [Pattern("?x", 100, "?y"), Pattern("?y", 103, "?z")]]
    e = Pair(graph, compile_cache_size=2)
    for pats in shapes:
        e.execute([pats])
    e.execute([shapes[0]])                        # evicted: built again
    st = e.check()
    assert len(e.t._compiled) == 2
    assert st["counters"]["serve_compile_cache_misses_total"] == 4
    for eng in (e.t, e.j):
        eng.caps = dataclasses.replace(eng.caps, probe_cap=8)
    e.execute([shapes[0]])                        # new caps: a new entry
    st = e.check()
    assert st["counters"]["serve_compile_cache_misses_total"] == 5


def test_precompile_warms_every_power_of_two(graph):
    e = Pair(graph, max_batch=4)
    pats = [Pattern("?x", 101, 7), Pattern("?x", 102, "?y")]
    e.precompile(pats)
    st = e.check()
    assert st["counters"]["serve_compile_cache_misses_total"] == 3
    assert e.t.dispatches == 0                    # warm-up is not traffic
    e.execute([[Pattern("?x", 101, c), Pattern("?x", 102, "?y")]
               for c in (1, 2, 3)])
    st = e.check()
    assert st["counters"]["serve_compile_cache_hits_total"] == 1


def test_engine_rejects_what_it_cannot_serve(graph):
    with pytest.raises(ValueError):
        ServeEngine(graph["ts"], caps=Caps(**CAPS), mode="reduce")
    with pytest.raises(ValueError, match="not ported"):
        ServeEngine(graph["ts"], mesh=object())
    with pytest.raises(ValueError, match="not ported"):
        ServeEngine(graph["ts"], fault_plan=object())
    with pytest.raises(ValueError, match="not ported"):
        ServeEngine(graph["ts"], check_answers=True)
    with pytest.raises(ValueError):
        ServeEngine(graph["ts"], max_batch=4, min_batch=8)
    eng = ServeEngine(graph["ts"], caps=Caps(**CAPS))     # no dictionary
    with pytest.raises(ValueError):
        eng.submit("SELECT ?x WHERE { ?x a <Student> . }")
    with pytest.raises(ValueError):
        eng.submit([])


def test_min_batch_defers_until_aged_and_drain_forces(graph):
    e = Pair(graph, max_batch=8, min_batch=4, max_wait_s=5.0)
    for c in (1, 2):
        e.submit([Pattern("?x", 101, c)], arrival=0.0)
    assert e.step(now=1.0) == []                  # below min_batch, young
    assert len(e.step(now=6.0)) == 2              # aged past max_wait_s
    for c in range(4):
        e.submit([Pattern("?x", 101, c)], arrival=10.0)
    assert len(e.step(now=10.0)) == 4             # min_batch met
    e.submit([Pattern("?x", 101, 3)], arrival=20.0)
    assert e.step(now=20.0) == []
    assert len(e.drain()) == 1
    e.check()


def test_minority_template_is_not_starved(graph):
    e = Pair(graph, max_batch=4, max_queue=256, starvation_limit=2)
    rid_min = e.submit([Pattern("?x", 100, "?y"), Pattern("?y", 103, "?z")])
    served_at = None
    for i in range(6):
        for c in range(5):
            e.submit([Pattern("?x", 101, (i * 5 + c) % 13)])
        if any(r.request_id == rid_min for r in e.step()):
            served_at = i
            break
    e.check()
    assert served_at is not None and served_at <= 2


def test_submit_accepts_physical_plan(graph):
    pats = [Pattern("?x", 101, 5), Pattern("?x", 102, "?y")]
    plan = compile_plan(graph["ts"], _tq(pats), Caps(**CAPS),
                        operators=ENGINE_OPERATORS)
    eng = ServeEngine(graph["ts"], caps=Caps(**CAPS))
    res = eng.execute([plan])[0]
    assert res.rows_set() == _local_set(graph["ts"], pats, CAPS, res.vars)
    big = compile_plan(graph["ts"], _tq(pats),
                       Caps(**dict(CAPS, out_cap=2 * CAPS["out_cap"])),
                       operators=ENGINE_OPERATORS)
    with pytest.raises(ValueError):
        eng.submit(big)
    bad = compile_plan(graph["ts"], _tq([Pattern(3, "?p", "?o"),
                                         Pattern("?x", "?p", "?y")]),
                       Caps(probe_cap=2))
    if any(st.kind == "reduce_side" for st in bad.steps):
        with pytest.raises(ValueError):
            eng.submit(bad)


# ---------------------------------------------------------------------------
# robustness: escalation, fallback, degraded mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("max_escalations", [1, 3])
def test_heavy_hitter_escalation_matches_reference_and_oracle(
        graph, max_escalations):
    want, ovars = execute_oracle(graph["triples"], _tq(CHAIN))
    assert len(want) > TINY["out_cap"]             # genuinely heavy
    e = Pair(graph, caps=TINY, max_escalations=max_escalations)
    res = e.execute([CHAIN])[0]
    e.check()
    assert res.rows_set(ovars) == want and res.overflow == 0
    assert e.t.escalations + e.t.fallbacks > 0
    assert e.t.escalations <= max_escalations - 1
    if max_escalations == 1:
        assert res.stats["fallback"] == "reduce_side"
        assert (e.t.fallbacks, e.t.escalations) == (1, 0)


def test_escalated_templates_reuse_compile_cache(graph):
    e = Pair(graph, caps=TINY)
    e.execute([CHAIN])
    compiled, d0 = len(e.t._compiled), e.t.dispatches
    e.execute([CHAIN])
    e.check()
    assert len(e.t._compiled) == compiled and e.t.dispatches > d0


def test_bounded_inexact_mode(graph):
    e = Pair(graph, caps=TINY)
    e.submit(CHAIN, inexact_ok=True)
    res = e.drain()
    e.check()
    assert res[0].overflow > 0 and res[0].stats["degraded"] is True
    assert e.t.escalations == 0 and e.t.fallbacks == 0


# ---------------------------------------------------------------------------
# deadlines (virtual clock) and the watchdog
# ---------------------------------------------------------------------------


def test_deadline_expired_while_queued(graph):
    e = Pair(graph)
    e.submit(CHAIN, arrival=0.0, deadline_s=0.5)
    out = e.step(now=1.0)
    e.check()
    assert isinstance(out[0], QueryTimeout) and out[0].phase == "queued"
    assert out[0].waited_s == pytest.approx(1.0) and e.t.dispatches == 0


def test_deadline_expired_mid_dispatch_and_during_escalation(graph):
    e = Pair(graph, caps=TINY)
    e.submit([Pattern("?x", 101, 7)], arrival=0.0, deadline_s=1e-12)
    out = e.step(now=0.0)                          # finishes past it
    assert isinstance(out[0], QueryTimeout) and out[0].phase == "dispatch"
    assert "overflow_per_step" in out[0].stats
    e.submit(CHAIN, arrival=0.0, deadline_s=1e6)
    assert e.step(now=0.0) == [] and e.t.escalations == 1
    out = e.step(now=2e6)                          # expires before retry
    e.check()
    assert isinstance(out[0], QueryTimeout) and out[0].phase == "escalation"
    assert sum(out[0].stats["overflow_per_step"]) > 0


def test_dispatch_watchdog(graph):
    e = Pair(graph, dispatch_timeout_s=0.0)
    e.submit(CHAIN)
    out = e.step()
    e.check()
    assert isinstance(out[0], QueryTimeout) and out[0].phase == "dispatch"


# ---------------------------------------------------------------------------
# graceful degradation: EngineBusy payload + priority shedding
# ---------------------------------------------------------------------------


def test_engine_busy_returns_plan_and_retry_after(graph):
    e = Pair(graph, max_queue=2)
    e.execute([CHAIN])                             # time one dispatch
    e.submit([Pattern("?x", 101, 7)])
    e.submit([Pattern("?x", 101, 8)])
    with pytest.raises(EngineBusy) as ei:
        e.t.submit(_tq(CHAIN))
    with pytest.raises(JBusy) as ej:
        e.j.submit(CHAIN)
    busy = ei.value
    assert busy.plan.patterns == tuple(_tq(CHAIN))
    assert busy.plan.patterns == tuple(pattern_from(p)
                                       for p in ej.value.plan.patterns)
    assert busy.retry_after > 0.0
    e.drain()
    rid = e.t.submit(busy.plan)
    assert rid == e.j.submit(ej.value.plan)
    e.drain()
    e.check()


def test_priority_shedding_with_tenant_accounting(graph):
    e = Pair(graph, max_queue=2)
    ra = e.submit([Pattern("?x", 101, 7)], tenant="bulk")
    rb = e.submit([Pattern("?x", 101, 8)], tenant="bulk")
    rc = e.submit([Pattern("?x", 101, 9)], tenant="paid", priority=5)
    with pytest.raises(EngineBusy):            # equal priority: no victim
        e.t.submit(_tq([Pattern("?x", 101, 5)]))
    with pytest.raises(JBusy):
        e.j.submit([Pattern("?x", 101, 5)])
    res = e.drain()
    e.check()
    shed = [r for r in res if isinstance(r, QueryShed)]
    assert [r.request_id for r in shed] == [rb]
    assert e.t.shed_by_tenant == {"bulk": 1}
    assert {r.request_id for r in res} == {ra, rb, rc}


# ---------------------------------------------------------------------------
# observability wiring
# ---------------------------------------------------------------------------


def _span_tree(tr):
    """(name, track, parent index, async id, attrs) of every span, in order;
    the stamps of execute_local's instrumented steps are wall times."""
    ids = {s.span_id: i for i, s in enumerate(tr.spans)}
    return [(s.name, s.track, ids.get(s.parent_id), s.async_id,
             None if s.name.startswith("cascade_step") else (s.t0, s.t1))
            for s in tr.spans]


def test_escalated_query_span_tree_matches_reference(graph, tmp_path):
    """A heavy query climbs five rungs of the escalation ladder: the same
    spans, parents, lanes, stamps (fake clock) and attrs in both."""
    e = Pair(graph, caps=TINY, max_escalations=8, tracer=True)
    res = e.execute([CHAIN])[0]
    e.check()
    assert e.t.escalations == 5 and e.t.fallbacks == 0
    assert e.tt.open_count == 0 and e.tj.open_count == 0
    assert _span_tree(e.tt) == _span_tree(e.tj)
    for a, b in zip(e.tt.spans, e.tj.spans):
        # the port's spans carry the reference's attrs, less the sharded
        # path's (fault epoch, retry, a2a bytes)
        assert a.attrs.items() <= b.attrs.items(), a.name
    names = {s.name for s in e.tt.spans}
    assert {"submit", "plan", "query", "queued", "step", "dispatch",
            "compile", "rung0", "rung4"} <= names
    assert res.rows.shape[1] == 3
    path = tmp_path / "trace.json"
    e.tt.export(str(path))
    events = tobs.load_chrome(str(path))
    assert {"query", "submit", "step", "dispatch"} <= {ev["name"]
                                                       for ev in events}


def test_exact_fallback_span_tree(graph):
    """The ladder's last rung falls back to execute_local's instrumented
    run, whose steps hang under the exact_fallback span (the shape
    tests/test_obs.py checks in the reference)."""
    tr = tobs.Tracer()
    reg = tobs.MetricsRegistry()
    eng = ServeEngine(graph["ts"], caps=Caps(**TINY), max_escalations=3,
                      tracer=tr, metrics=reg)
    res = eng.execute([_tq(CHAIN)])[0]
    assert tr.open_count == 0 and eng.fallbacks == 1
    by_id = {s.span_id: s for s in tr.spans}
    root, = tr.find("query")
    assert root.attrs["outcome"] == "ok" and root.attrs["fallback"] is True
    for s in tr.spans:
        if s.track == "query" and s is not root:
            p = s
            while p.parent_id is not None:
                p = by_id[p.parent_id]
            assert p is root and s.async_id == root.async_id, s.name
    rungs = sorted((s for s in tr.spans if s.name.startswith("rung")),
                   key=lambda s: s.attrs["attempt"])
    assert [s.attrs["outcome"] for s in rungs] == ["escalate", "escalate",
                                                   "fallback"]
    caps_seq = [s.attrs["out_cap"] for s in rungs]
    assert caps_seq == sorted(set(caps_seq))
    fb, = tr.find("exact_fallback")
    steps = [s for s in tr.spans if s.name.startswith("cascade_step")
             and s.parent_id == fb.span_id]
    assert steps and all(s.attrs.get("kind") for s in steps)
    for d in tr.find("dispatch"):
        assert by_id[d.parent_id].name == "step"
    snap = reg.to_dict()["counters"]
    assert snap["serve_escalations_total"] == len(rungs) - 1
    assert snap["serve_dispatches_total"] == len(tr.find("dispatch"))
    assert res.rows_set(("?x", "?y", "?z")) == execute_oracle(
        graph["triples"], _tq(CHAIN))[0]


def test_metrics_disabled_and_per_tenant_histograms(graph):
    before = tobs.REGISTRY.to_dict()
    eng = ServeEngine(graph["ts"], caps=Caps(**TINY), metrics=False)
    eng.execute([_tq(CHAIN)])
    assert tobs.REGISTRY.to_dict() == before
    assert eng.metrics() == {"counters": {}, "gauges": {}, "histograms": {}}
    e = Pair(graph, caps=BENCH, max_escalations=0)
    for tenant in ("alpha", "alpha", "beta"):
        e.submit(CHAIN, arrival=0.0, tenant=tenant)
        e.step(now=1.0)
    st = e.check()
    assert st["counters"]['serve_requests_total{tenant="alpha"}'] == 2
    h = st["histograms"]['serve_tenant_latency_seconds{tenant="alpha"}']
    assert h["count"] == 2 and h["p99"] >= h["p50"] > 0
    assert 'serve_qps{engine="engine"}' in e.t.metrics()["gauges"]


def test_serve_logger_lifecycle_events(graph, caplog):
    import logging
    eng = ServeEngine(graph["ts"], caps=Caps(**TINY),
                      metrics=tobs.MetricsRegistry())
    with caplog.at_level(logging.DEBUG, logger="repro_torch.serve"):
        eng.execute([_tq(CHAIN)])
    msgs = [r.message for r in caplog.records]
    assert any("admit" in m for m in msgs)
    assert any("escalat" in m for m in msgs)
    lg = logging.getLogger("repro_torch.serve")
    assert lg.handlers == [] and lg.getEffectiveLevel() >= logging.WARNING


# ---------------------------------------------------------------------------
# the fold: one call of each index op a step, whatever the batch
# ---------------------------------------------------------------------------


def test_dispatch_folds_once_per_step_whatever_the_batch(graph):
    """On the CPU the vmap rules run as on the card: each dispatch folds
    the same number of index-op calls at batch 1, 2 and 4."""
    eng = ServeEngine(graph["ts"], caps=Caps(**CAPS), max_batch=4)
    star = [Pattern("?x", 101, 3), Pattern("?x", 102, "?a"),
            Pattern("?x", 103, "?b")]
    chain = [Pattern(2, 103, "?a"), Pattern("?a", 104, "?b")]
    for pats in (star, chain):
        folds = set()
        for b in (1, 2, 4):
            before = dict(ops.vmap_folds)
            eng.precompile(_tq(pats), batches=[b])
            folds.add(tuple(ops.vmap_folds[k] - before[k]
                            for k in ("searchsorted", "probe_gather")))
        assert len(folds) == 1 and sum(next(iter(folds))) > 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_kernel_engine_matches_torch_engine_on_the_card(tenants):
    """impl="kernel" against impl="torch" on a CUDA store, request by
    request, and each template's dispatches launch the index kernels as
    often at every batch size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = tenants["lubm"]
    store = build_store(g["triples"], device="cuda")
    stream = _stream("lubm", 1, np.random.RandomState(1), 40)
    queries = [[g["d"].pattern(*t) for t in q] for q in stream]
    out, per_tid = {}, {}
    for impl in ("kernel", "torch"):
        eng = ServeEngine(store, cfg=ExecConfig(impl=impl), caps=Caps(**BENCH),
                          max_batch=4, max_queue=64, max_escalations=0,
                          metrics=False)
        orig = eng._dispatch

        def counted(tid, template, batch, *a, _orig=orig, _impl=impl):
            before = dict(ops.launches)
            res = _orig(tid, template, batch, *a)
            per_tid.setdefault((_impl, tid), set()).add(
                tuple(ops.launches[k] - before[k]
                      for k in ("searchsorted", "probe_gather")))
            return res
        eng._dispatch = counted
        out[impl] = eng.execute(queries)
    same_results(out["kernel"], out["torch"])
    for (impl, tid), counts in per_tid.items():
        assert len(counts) == 1, (impl, tid, counts)
        assert sum(next(iter(counts))) > 0 if impl == "kernel" else \
            counts == {(0, 0)}


# ---------------------------------------------------------------------------
# the serving bench's request shapes (benchmarks/bench_serving.py)
# ---------------------------------------------------------------------------

N_DEPT, N_PROF, N_COURSE = 12, 18, 24     # rdf_gen.lubm_like constants


def _stream(tenant, scale, rng, n):
    """`n` requests of the bench's shapes for one tenant, each a list of
    (s, p, o) term strings with constants drawn from `rng`."""
    u = lambda: rng.randint(scale)
    if tenant == "lubm":
        def course():
            return f"Course{rng.randint(N_COURSE)}.D{rng.randint(N_DEPT)}.U{u()}"

        def prof():
            return f"Prof{rng.randint(N_PROF)}.D{rng.randint(N_DEPT)}.U{u()}"
        shapes = [
            (3, lambda: [("?x", "rdf:type", "GraduateStudent"),
                         ("?x", "takesCourse", course())]),
            (3, lambda: [("?x", "rdf:type", "Publication"),
                         ("?x", "publicationAuthor", prof())]),
            (3, lambda: [("?x", "rdf:type", "Student"),
                         ("?x", "memberOf",
                          f"Dept{rng.randint(N_DEPT)}.U{u()}")]),
            (3, lambda: [("?p", "worksFor",
                          f"Dept{rng.randint(N_DEPT)}.U{u()}"),
                         ("?x", "advisor", "?p")]),
            (2, lambda: [("?y", "rdf:type", "Course"),
                         (prof(), "teacherOf", "?y"),
                         ("?x", "takesCourse", "?y"),
                         ("?x", "rdf:type", "Student")]),
            (1, lambda: [("?x", "rdf:type", "ResearchGroup"),
                         ("?x", "subOrganizationOf", f"Univ{u()}")]),
            (2, lambda: [("?x", "rdf:type", "Professor"),
                         ("?x", "worksFor",
                          f"Dept{rng.randint(N_DEPT)}.U{u()}"),
                         ("?x", "name", "?y1"), ("?x", "emailAddress", "?y2"),
                         ("?x", "telephone", "?y3")]),
        ]
    else:
        n_persons = max(scale // 3, 8)
        shapes = [
            (3, lambda: [("?a", "rdf:type", "Article"),
                         ("?a", "dc:title",
                          f"title{2 * rng.randint(scale // 2)}"),
                         ("?a", "dcterms:issued", "?yr")]),
            (3, lambda: [("?a", "dc:creator",
                          f"Person{rng.randint(n_persons)}"),
                         ("?a", "dc:title", "?t")]),
            (3, lambda: [("?s", "?pr", f"Person{rng.randint(n_persons)}")]),
        ]
    choices = [fn for w, fn in shapes for _ in range(w)]
    return [choices[rng.randint(len(choices))]() for _ in range(n)]
