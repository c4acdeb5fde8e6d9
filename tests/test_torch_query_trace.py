"""The port's ad hoc query path traced from inside, on the CPU.

A ``Tracer`` passed to ``parse_bgp``, ``execute_local`` and
``build_store`` records the front end, the plan lookup (``hit`` false on
a cold plan cache, true after), the planner's passes on a miss, one span
per cascade step named by its operator, and the store's build. Each
step's valid rows ride back in the tensor that carries the per-step
overflow, read after the work by ``read_step_counts``. A traced call
returns bit-identical results to an untraced one and dispatches the same
aten ops in the same order. Spans are stamped on the Unix clock that
torch.profiler stamps its events on."""
import time

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import Caps, build_store, compile_plan, execute_local
from repro_torch.core.bgp import read_step_counts
from repro_torch.data import lubm_like
from repro_torch.data.rdf_gen import LUBM_SPARQL
from repro_torch.obs.trace import Tracer, clock, clock_ns, to_ns
from repro_torch.serve import parse_bgp

CAPS = Caps(scan_cap=1 << 12, out_cap=1 << 12, probe_cap=128, row_cap=64)
QUERIES = sorted(LUBM_SPARQL)
STEPS = ("bgp.scan", "bgp.mapsin", "bgp.multiway", "bgp.reduce_side")


@pytest.fixture(scope="module")
def lubm():
    triples, d, _ = lubm_like(1)
    return {"triples": triples, "d": d}


def _run(store, lubm, name, mode, tracer=None):
    pq = parse_bgp(LUBM_SPARQL[name], lubm["d"])
    return execute_local(store, pq.patterns, mode=mode, caps=CAPS,
                         tracer=tracer)


def _new(tracer, n0):
    """The spans a call recorded, by name."""
    out: dict = {}
    for s in tracer.spans[n0:]:
        out.setdefault(s.name, []).append(s)
    return out


@pytest.mark.parametrize("mode", ["mapsin", "reduce"])
@pytest.mark.parametrize("name", QUERIES)
def test_spans_of_a_cold_then_a_warm_call(lubm, name, mode):
    store = build_store(lubm["triples"], device="cpu")
    tr = Tracer()
    plan = None
    for hit in (False, True):
        n0 = len(tr.spans)
        _run(store, lubm, name, mode, tr)
        got = _new(tr, n0)
        root, = got["bgp.execute_local"]
        lookup, = got["bgp.plan"]
        assert lookup.attrs["hit"] is hit and lookup.parent_id == root.span_id
        assert root.parent_id is None and tr.open_count == 0
        if plan is None:
            plan = compile_plan(store, parse_bgp(LUBM_SPARQL[name],
                                                 lubm["d"]).patterns, CAPS,
                                mode=mode)
        if hit:
            assert "planner.compile" not in got
            assert "planner.relation_stats" not in got
        else:
            comp, = got["planner.compile"]
            assert comp.parent_id == lookup.span_id
            assert got["planner.relation_stats"]
            assert all(s.parent_id == comp.span_id
                       for s in got["planner.relation_stats"])
        steps = sorted((s for n in STEPS for s in got.get(n, [])),
                       key=lambda s: s.attrs["step"])
        assert [s.name for s in steps] == ["bgp." + st.kind
                                           for st in plan.steps]
        assert [s.attrs["step"] for s in steps] == list(range(len(steps)))
        assert all(s.parent_id == root.span_id and s.attrs["slots"] > 0
                   for s in steps)
        assert lookup.t1 <= steps[0].t0 and steps[-1].t1 <= root.t1


@pytest.mark.parametrize("mode", ["mapsin", "reduce"])
@pytest.mark.parametrize("name", QUERIES)
def test_found_rows_equal_the_instrumented_counts(lubm, name, mode):
    store = build_store(lubm["triples"], device="cpu")
    pq = parse_bgp(LUBM_SPARQL[name], lubm["d"])
    stats: list = []
    bnd = execute_local(store, pq.patterns, mode=mode, caps=CAPS,
                        stats=stats)
    tr = Tracer()
    traced = execute_local(store, pq.patterns, mode=mode, caps=CAPS,
                           tracer=tr)
    read_step_counts(tr)
    steps = sorted((s for s in tr.spans if s.name in STEPS),
                   key=lambda s: s.attrs["step"])
    assert "counts" not in tr.find("bgp.execute_local")[0].attrs
    assert len(steps) == len(stats) and int(traced.overflow) == int(
        bnd.overflow)
    # counted before the out_cap cut, so never fewer than a step keeps
    assert all(s.attrs["found"] >= st["n_out"] for s, st in zip(steps, stats))
    if int(bnd.overflow) == 0:
        assert [s.attrs["found"] for s in steps] == [st["n_out"]
                                                     for st in stats]
    assert all(0 <= s.attrs["found"] <= s.attrs["slots"] for s in steps)
    assert steps[0].attrs["slots"] == store.flat_keys(0).numel()


@pytest.mark.parametrize("mode", ["mapsin", "reduce"])
@pytest.mark.parametrize("name", QUERIES)
def test_traced_results_are_bit_identical(lubm, name, mode):
    store = build_store(lubm["triples"], device="cpu")
    plain = _run(store, lubm, name, mode)
    traced = _run(store, lubm, name, mode, Tracer())
    assert plain.vars == traced.vars
    for f in ("table", "valid", "overflow", "step_overflow"):
        np.testing.assert_array_equal(getattr(plain, f).numpy(),
                                      getattr(traced, f).numpy(), err_msg=f)
    assert plain.step_overflow.shape == (len(traced.step_overflow),)


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("mode", ["mapsin", "reduce"])
@pytest.mark.parametrize("name", ["Q1", "Q4", "Q7", "Q8"])
def test_traced_and_untraced_calls_dispatch_the_same_ops(lubm, name, mode):
    store = build_store(lubm["triples"], device="cpu")
    _run(store, lubm, name, mode)                 # plan and closure cached
    seen = []
    for tracer in (None, Tracer(), None):
        with torch.no_grad(), _Ops() as rec:
            _run(store, lubm, name, mode, tracer)
        seen.append(rec.ops)
    assert seen[0] and seen[0] == seen[1] == seen[2]


def test_build_store_spans_and_the_same_store(lubm):
    tr = Tracer()
    traced = build_store(lubm["triples"], device="cpu", tracer=tr)
    plain = build_store(lubm["triples"], device="cpu")
    root, = tr.find("store.build")
    kids = [s for s in tr.spans if s.parent_id == root.span_id]
    assert [s.name for s in kids] == ["store.sort", "store.dedup",
                                      "store.upload"]
    assert root.attrs["triples"] == len(lubm["triples"])
    assert root.t0 <= kids[0].t0 and kids[-1].t1 <= root.t1
    for f in ("keys_spo", "keys_ops", "splits_spo", "splits_ops",
              "counts_spo", "counts_ops"):
        assert torch.equal(getattr(traced, f), getattr(plain, f)), f
    assert traced.n_triples == plain.n_triples


def test_parse_span_and_nesting_under_an_open_span(lubm):
    tr = Tracer()
    store = build_store(lubm["triples"], device="cpu")
    with tr.span("request") as req:
        pq = parse_bgp(LUBM_SPARQL["Q1"], lubm["d"], tracer=tr)
        execute_local(store, pq.patterns, caps=CAPS, tracer=tr)
    assert pq == parse_bgp(LUBM_SPARQL["Q1"], lubm["d"])
    parse, = tr.find("sparql.parse")
    root, = tr.find("bgp.execute_local")
    assert parse.parent_id == root.parent_id == req.span_id
    assert parse.t1 <= root.t0


def test_spans_are_on_the_unix_clock():
    before = time.time_ns()
    tr = Tracer()
    with tr.span("x"):
        pass
    after = time.time_ns()
    s, = tr.spans
    assert before - 1000 <= to_ns(s.t0) <= to_ns(s.t1) <= after + 1000
    assert abs(to_ns(clock()) - clock_ns()) < 10_000_000
    # a stamp converts back to the profiler's ns to within 1 us
    for ns in (before, after, before + 123_456_789):
        assert abs(to_ns(ns / 1e9) - ns) <= 1000


def test_the_instrumented_path_stamps_on_the_tracer_clock(lubm):
    store = build_store(lubm["triples"], device="cpu")
    pq = parse_bgp(LUBM_SPARQL["Q8"], lubm["d"])
    t0 = clock()
    stats: list = []
    execute_local(store, pq.patterns, caps=CAPS, stats=stats)
    t1 = clock()
    assert all(t0 <= st["t0"] <= st["t1"] <= t1 for st in stats)
    assert [st["t0"] for st in stats] == sorted(st["t0"] for st in stats)
