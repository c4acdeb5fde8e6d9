"""CPU tests of the readers of the port's own spans and counters
(`portbench/program_trace.py`): kernels put down to the innermost span
open at their launch, found by correlation id; idle gaps labelled by the
innermost span, a program span inside a harness span taking the label;
each of the six readers on made-up spans and kernels, and None where
there is nothing to read; the replay at a tiny scale through the port's
plain paths; and no tracer at all in a run with `--trace 0`."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from portbench import devtrace, layers, manifest, program_trace, rehearse
from portbench import window as win

ROOT = Path(__file__).resolve().parents[1]
READERS = ("planner_host_ms.adhoc", "planner_setup_s.adhoc",
           "store_build_s.adhoc", "mapsin_device_ms.adhoc",
           "reduce_side_device_ms.adhoc", "slot_fill.adhoc")
S = 1_000_000_000                 # ns in a second


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def _spans():
    """One store build, one cold plan lookup, and one run of Q8 in the
    profiled rounds [10 s, 20 s): parse, a warm plan lookup, a mapsin and
    a reduce-side step, the copy-out."""
    program_trace.sut.import_port()
    from repro_torch.obs.trace import Tracer
    tr = Tracer(clock=lambda: 0.0)
    build = tr.record("store.build", 1.0, 3.0)
    tr.record("store.sort", 1.0, 2.0, parent=build)
    tr.record("bgp.plan", 4.0, 4.5, hit=False)
    req = tr.record("request", 11.0, 19.0, query="Q8")
    tr.record("sparql.parse", 11.0, 11.5, parent=req)
    root = tr.record("bgp.execute_local", 11.5, 18.0, parent=req)
    tr.record("bgp.plan", 11.5, 12.0, parent=root, hit=True)
    tr.record("bgp.mapsin", 12.0, 14.0, parent=root, step=1, slots=100,
              found=4)
    tr.record("bgp.reduce_side", 14.0, 17.0, parent=root, step=2,
              slots=300, found=11)
    tr.record("copy_out", 18.0, 19.0, parent=req)
    return tr.spans


def _kernels():
    """(name, start, dur, launch): two launched in the mapsin step, one in
    the reduce-side step, one in the copy-out, one whose launch event is
    missing."""
    return [("probe_gather_kernel", 12 * S + 100, 3_000_000, 12 * S + 10),
            ("elementwise", 13 * S, 1_000_000, 12 * S + 500),
            ("sort", 15 * S, 5_000_000, 14 * S + 1),
            ("index", 18 * S + 100, 2_000_000, 18 * S + 5),
            ("lost", 16 * S, 7_000_000, None)]


def _window(keys=("Q8", "Q8")):
    reqs = [win.Request(k, "", 0.0, 0.5, "ok", ("?x",), np.zeros((1, 1)))
            for k in keys]
    return win.Window(reqs, 0.0, 1.0)


def _ctx(pt, window=None):
    tr = devtrace.DeviceTrace(None)
    tr.ops, tr.t0, tr.t1 = [], 0, 1
    ctx = layers.Context(None, window or _window(), tr, None,
                         "NVIDIA H100 80GB HBM3")
    ctx.program_trace = pt
    return ctx


def _pt(**kw):
    return program_trace.ProgramTrace(
        _spans(), kw.pop("kernels", _kernels()), kw.pop("ops", []),
        10 * S, 20 * S, rounds=1, **kw)


def test_innermost_takes_the_shortest_span_open_at_each_point():
    spans = [(0, 100, "request"), (10, 50, "execute"), (20, 30, "step"),
             (60, 70, "copy")]
    got = program_trace.innermost(spans, [5, 20, 29, 30, 55, 65, 100])
    assert [x[2] if x else None for x in got] == [
        "request", "step", "step", "execute", "request", "copy", None]


def test_kernels_go_to_the_innermost_span_at_their_launch():
    pt = _pt()
    names = [(k[0], s.name if s else None) for k, s in pt.kernel_spans()]
    assert names == [("probe_gather_kernel", "bgp.mapsin"),
                     ("elementwise", "bgp.mapsin"),
                     ("sort", "bgp.reduce_side"), ("index", "copy_out")]
    row = pt.per_query()["Q8"]
    assert row["probe_device_ms"] == pytest.approx(4.0)
    assert row["reduce_device_ms"] == pytest.approx(5.0)
    assert (row["found"], row["slots"]) == (15, 400)
    assert row["host_ms"] == pytest.approx(1000.0)   # parse + warm lookup


class _Event:
    def __init__(self, name, dev, start, dur, corr):
        self._v = (name, dev, start, dur, corr)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]


def test_launches_are_found_by_correlation_id():
    cpu, gpu = "DeviceType.CPU", "DeviceType.CUDA"
    events = [
        _Event("cudaDeviceSynchronize", cpu, 90, 1, 6),
        _Event("cudaLaunchKernel", cpu, 95, 2, 7),      # the bracketed one
        _Event("Lazy Function Loading", cpu, 96, 1, 7),
        _Event("fill", gpu, 97, 1, 7),
        _Event("cudaLaunchKernel", cpu, 110, 3, 8),
        _Event("Runtime Triggered Module Loading", cpu, 111, 3, 8),
        _Event("cudaMemcpyAsync", cpu, 130, 3, 9),
        _Event("probe_gather_kernel", gpu, 120, 10, 8),
        _Event("Memcpy DtoH (Device -> Pageable)", gpu, 140, 5, 9),
        _Event("searchsorted_kernel", gpu, 150, 4, 11),  # no launch event
        _Event("late", gpu, 500, 4, 12)]                 # after the window
    kernels, ops, spin = program_trace.read_events(events, 100, 400)
    assert kernels == [("probe_gather_kernel", 120, 10, 110),
                       ("searchsorted_kernel", 150, 4, None)]
    assert ops == [(120, 10), (140, 5), (150, 4)]
    assert spin == 95


def test_a_program_span_inside_a_harness_span_labels_the_gap():
    ops = [(10 * S, S), (11 * S + S // 2, S // 2), (12 * S, 6 * S),
           (19 * S, S // 2)]
    pt = _pt(ops=ops)
    idle = pt.idle_by_span()
    # [11, 11.5): the parse in the request; [18, 19): the copy-out;
    # [19.5, 20): no span
    assert idle == pytest.approx({"sparql.parse": 0.5, "copy_out": 1.0,
                                  "outside any span": 0.5})


def test_the_six_readers_read_the_program_trace():
    ctx = _ctx(_pt())
    read = {m: manifest.reader(m)(ctx) for m in READERS}
    assert read["planner_host_ms.adhoc"] == pytest.approx(1000.0)
    assert read["planner_setup_s.adhoc"] == pytest.approx(0.5)
    assert read["store_build_s.adhoc"] == pytest.approx(2.0)
    assert read["mapsin_device_ms.adhoc"] == pytest.approx(4.0)
    assert read["reduce_side_device_ms.adhoc"] == pytest.approx(5.0)
    assert read["slot_fill.adhoc"] == pytest.approx(100 * 15 / 400)
    # two runs of Q8, one of them overflowed: the time over one answer
    half = _window()
    half.requests[0].overflow = 1
    assert manifest.reader("mapsin_device_ms.adhoc")(
        _ctx(_pt(), half)) == pytest.approx(8.0)


def test_the_readers_give_none_where_there_is_nothing_to_read():
    for pt, window in ((None, None), (_pt(), _window(keys=()))):
        ctx = _ctx(pt, window)
        got = {m: manifest.reader(m)(ctx) for m in READERS}
        want_none = set(READERS) if pt is None else {
            "planner_host_ms.adhoc", "mapsin_device_ms.adhoc",
            "reduce_side_device_ms.adhoc", "slot_fill.adhoc"}
        assert {m for m, v in got.items() if v is None} == want_none
    no_kernels = _ctx(_pt(kernels=[]))
    assert manifest.reader("mapsin_device_ms.adhoc")(no_kernels) is None
    assert manifest.reader("slot_fill.adhoc")(no_kernels) is not None


class _ControlLoop:
    control = object()


def test_no_replay_without_a_port_loop_or_the_port_s_spans(monkeypatch):
    ctx = layers.Context(None, _window(), None, _ControlLoop(), "cpu")
    assert program_trace.of(ctx) is None
    assert program_trace.supported() is True
    from repro_torch.core import bgp
    monkeypatch.delattr(bgp, "read_step_counts")
    assert program_trace.supported() is False


def test_the_replay_at_a_tiny_scale_on_the_cpu():
    cell = rehearse.tiny_cell("lubm63.adhoc")
    graph = manifest.generator(cell.config["schema"]).generate(
        cell.config, 2**31 + 7)
    loop = manifest.kind("closed").Loop(cell, graph, 2**31 + 7, "cpu",
                                        devtrace.Spans(False))
    loop.setup()
    window = loop.run(0.2)
    ctx = layers.Context(None, window, None, loop, "cpu")
    pt = program_trace.of(ctx)
    assert program_trace.of(ctx) is pt
    read = {m: manifest.reader(m)(ctx) for m in READERS}
    assert read["store_build_s.adhoc"] > 0
    assert read["planner_setup_s.adhoc"] > 0
    assert read["planner_host_ms.adhoc"] > 0
    assert 0 < read["slot_fill.adhoc"] < 100
    assert read["mapsin_device_ms.adhoc"] is None     # no device trace
    assert set(pt.per_query()) == set(loop.queries)
    lookups = [s for s in pt.spans if s.name == "bgp.plan"]
    cold = [s for s in lookups if not s.attrs["hit"]]
    assert len(cold) == len(loop.queries)
    assert len(lookups) == len(loop.queries) * (1 + program_trace.ROUNDS)
    loop.close()


def test_a_run_with_trace_0_builds_no_tracer():
    script = (
        "import json\n"
        "from portbench import rehearse, sut\n"
        "sut.import_port()\n"
        "from repro_torch.obs import trace\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError('a tracer was built')\n"
        "trace.Tracer.__init__ = refuse\n"
        "r = rehearse.rehearse('lubm63.adhoc', 'none', seconds=0.2)\n"
        "print(json.dumps({'correct': r['correct'],"
        " 'metrics': sorted(r['metrics'])}))\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.splitlines()[-1])
    assert got["correct"] is True and "qps" in got["metrics"]
