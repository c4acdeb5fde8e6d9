"""The port's observability layer against the JAX package's, call by call.

The same calls go through ``repro.obs`` and ``repro_torch.obs``: histogram
bounds and quantiles, registry labels, kinds and hooks, the null registry,
tracer nesting, double end and coverage, Chrome JSON export and load,
``validate_events`` and ``spans_from_stats``. Both run on a fake clock, so
the Prometheus text, the snapshots and the trace events must be equal."""
import itertools

import numpy as np
import pytest
import torch

import repro.obs as jobs
from repro.obs import trace as jtrace

import repro_torch.obs as tobs
from repro_torch.obs import trace as ttrace

PKGS = (jobs, tobs)


class FakeClock:
    """A clock that advances a fixed step per reading."""

    def __init__(self, step=0.001):
        self._n = itertools.count()
        self.step = step

    def __call__(self):
        return next(self._n) * self.step


def test_same_public_names():
    assert tobs.__all__ == jobs.__all__
    assert tobs.DEFAULT_LATENCY_BUCKETS == jobs.DEFAULT_LATENCY_BUCKETS
    assert tobs.DEFAULT_SIZE_BUCKETS == jobs.DEFAULT_SIZE_BUCKETS


@pytest.mark.parametrize("bounds", ["latency", "size", (1.0, 2.0, 4.0)],
                         ids=str)
def test_histogram_bounds_and_quantiles(bounds):
    rng = np.random.RandomState(3)
    vals = np.concatenate([rng.lognormal(-4, 2, 300), [0.0, 1.0, 2.0, 4.0,
                                                       1e6]])
    hs = []
    for pkg in PKGS:
        b = {"latency": pkg.DEFAULT_LATENCY_BUCKETS,
             "size": pkg.DEFAULT_SIZE_BUCKETS}.get(bounds, bounds)
        h = pkg.Histogram(b)
        for v in vals:
            h.observe(float(v))
        hs.append(h)
    j, t = hs
    assert t.bounds == j.bounds and t.counts == j.counts
    assert (t.sum, t.count, t.max) == (j.sum, j.count, j.max)
    assert t.cumulative() == j.cumulative()
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 0.999, 1.0):
        assert t.quantile(q) == j.quantile(q)
    assert tobs.Histogram().quantile(0.5) == jobs.Histogram().quantile(0.5)


@pytest.mark.parametrize("bad", [(2.0, 1.0), (1.0, 1.0)])
def test_histogram_rejects_bad_bounds(bad):
    for pkg in PKGS:
        with pytest.raises(ValueError):
            pkg.Histogram(bad)


def _registry_script(pkg):
    reg = pkg.MetricsRegistry()
    reg.counter("reqs_total", tenant="a").inc()
    reg.counter("reqs_total", tenant="a").inc(2)
    reg.counter("reqs_total", tenant="b").inc(0.5)
    reg.counter("plain_total").inc()
    reg.gauge("depth").set(7)
    reg.gauge("depth", engine="e1").inc(3)
    reg.gauge("depth", engine="e1").dec()
    h = reg.histogram("lat_seconds", template="e:t0")
    for v in (0.0001, 0.003, 0.02, 0.02, 7.5, 100.0):
        h.observe(v)
    reg.histogram("lat_seconds").observe(0.01)
    sz = reg.histogram("batch", buckets=pkg.DEFAULT_SIZE_BUCKETS)
    for v in (1, 3, 16, 300):
        sz.observe(v)
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("reqs_total")
    return reg


def test_registry_labels_snapshot_and_prometheus_text():
    j, t = (_registry_script(pkg) for pkg in PKGS)
    assert t.to_dict() == j.to_dict()
    assert t.to_prom_text() == j.to_prom_text()
    j.reset()
    t.reset()
    assert t.to_prom_text() == j.to_prom_text() == ""


def test_registry_hooks_fire_on_tick():
    seen = {pkg: [] for pkg in PKGS}
    fired = {pkg: [] for pkg in PKGS}
    for pkg in PKGS:
        reg = pkg.MetricsRegistry()
        reg.add_hook(10.0, lambda r, s=seen[pkg]: s.append(r.to_dict()))
        reg.add_hook(3.0, lambda r, s=seen[pkg]: s.append("fast"))
        for now in (0.0, 2.0, 5.0, 11.0, 12.0, 25.0):
            reg.counter("ticks_total").inc()
            fired[pkg].append(reg.tick(now=now))
    assert fired[tobs] == fired[jobs] == [0, 0, 1, 2, 0, 2]
    assert seen[tobs] == seen[jobs]


def test_null_registry_is_inert():
    for pkg in PKGS:
        null = pkg.NULL_REGISTRY
        assert isinstance(null, pkg.NullRegistry)
        assert isinstance(pkg.REGISTRY, pkg.MetricsRegistry)
        null.counter("x").inc()
        null.gauge("y", a="b").set(3)
        h = null.histogram("z")
        h.observe(1.0)
        assert (h.count, h.sum, h.quantile(0.5)) == (0, 0.0, 0.0)
        null.add_hook(1.0, lambda r: None)
        assert null.tick() == 0 and null.tick(now=1e9) == 0
        assert null.to_dict() == {"counters": {}, "gauges": {},
                                  "histograms": {}}
        assert null.to_prom_text() == ""


def _trace_script(pkg):
    """Nesting, double end, non-lexical and recorded spans, async lanes,
    attrs of every JSON kind; returns the tracer."""
    tr = pkg.Tracer(clock=FakeClock())
    with tr.span("outer", batch=4) as o:
        with tr.span("inner", tags=("a", 1, None)):
            pass
    inner = tr.find("inner")[0]
    assert inner.parent_id == o.span_id and inner.t1 >= inner.t0
    with pytest.raises(ValueError, match="already ended"):
        tr.end(o)
    root = tr.begin("query", track="query", async_id=7, tenant="t0")
    child = tr.begin("queued", track="query", parent=root, async_id=7)
    tr.end(child, phase="admit")
    tr.record("compile", 0.5, 0.75, parent=o, template=3, scale=3 + 4j)
    step = tr.begin("step")
    assert tr.open_count == 2
    tr.end(step, delivered=3)
    tr.end(root, outcome="ok")
    assert tr.open_count == 0 and tr.open_spans() == []
    return tr


def _span_fields(tr):
    ids = {s.span_id: i for i, s in enumerate(tr.spans)}
    return [(s.name, s.t0, s.t1, s.track, s.attrs, ids.get(s.parent_id),
             s.async_id) for s in tr.spans]


def test_tracer_nesting_events_and_coverage():
    j, t = (_trace_script(pkg) for pkg in PKGS)
    assert _span_fields(t) == _span_fields(j)
    assert t.to_events() == j.to_events()
    for a, b in ((0.0, 1.0), (0.0, 0.004), (0.002, 0.5), (1.0, 0.0)):
        assert t.coverage(a, b) == j.coverage(a, b)
        assert t.coverage(a, b, track="query") == j.coverage(a, b,
                                                              track="query")
    assert [s.name for s in t.find("query", track="query")] == ["query"]
    assert repr(t.spans[0]).startswith("Span('inner'")


def test_coverage_merges_overlaps():
    for pkg in PKGS:
        tr = pkg.Tracer(clock=lambda: 0.0)
        tr.record("a", 0.0, 0.6)
        tr.record("b", 0.4, 0.8)
        tr.record("c", 0.9, 1.0)
        tr.record("child", 0.8, 0.9, parent=tr.spans[0])  # not top level
        assert tr.coverage(0.0, 1.0) == pytest.approx(0.9)
        assert tr.coverage(0.0, 0.5) == pytest.approx(1.0)


def test_chrome_json_round_trip(tmp_path):
    docs = []
    for pkg, mod in ((jobs, jtrace), (tobs, ttrace)):
        path = tmp_path / f"{pkg.__name__}.json"
        tr = _trace_script(pkg)
        assert tr.export(str(path)) == str(path)
        events = mod.load_chrome(str(path))
        mod.validate_events(events)
        docs.append((path.read_text(), events))
    assert docs[0] == docs[1]


@pytest.mark.parametrize("events,match", [
    ("notalist", "not a list"),
    ([{"pid": 1, "ts": 0}], "malformed"),
    ([{"ph": "X", "pid": 1}], "missing ts"),
    ([{"ph": "X", "pid": 1, "ts": 0}], "without dur"),
    ([{"ph": "b", "pid": 1, "ts": 0, "cat": "q"}], "without id"),
    ([{"ph": "e", "pid": 1, "ts": 0, "cat": "q", "id": 1}], "before"),
    ([{"ph": "b", "pid": 1, "ts": 0, "cat": "q", "id": 1}], "unbalanced"),
])
def test_validate_events_rejects_the_same_events(events, match):
    for mod in (jtrace, ttrace):
        with pytest.raises(ValueError, match=match):
            mod.validate_events(events)
    for mod in (jtrace, ttrace):
        mod.validate_events([{"ph": "M", "pid": 1}])


def test_spans_from_stats():
    stats = [{"kind": "scan", "n_in": 0, "n_out": 5, "overflow": 0,
              "t0": 1.0, "t1": 1.5, "wall_s": 0.5},
             {"kind": "mapsin", "n_in": 5, "n_out": 9, "overflow": 2,
              "deliveries": 11, "probe_len_max": 4, "t0": 1.5, "t1": 2.0},
             {"kind": "multiway", "n_in": 9}]          # no stamps: skipped
    out = []
    for pkg, mod in ((jobs, jtrace), (tobs, ttrace)):
        tr = pkg.Tracer(clock=FakeClock())
        parent = tr.begin("exact_fallback", track="query", async_id=3)
        kids = mod.spans_from_stats(tr, stats, parent=parent, track="query",
                                    async_id=3)
        tr.end(parent)
        assert [s.parent_id for s in kids] == [parent.span_id] * 2
        out.append(tr.to_events())
    assert out[0] == out[1]


def test_device_bracket_is_off_by_default_and_records_when_on():
    tr = tobs.Tracer()
    assert tr.torch_profiler is False
    with tr.device_bracket("serve_dispatch/t0b1", "cpu"):
        pass
    on = tobs.Tracer(torch_profiler=True)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with on.device_bracket("serve_dispatch/t0b1", torch.device("cpu")):
            torch.ones(4).sum()
    assert any(e.key == "serve_dispatch/t0b1" for e in prof.key_averages())
