"""Query-lifecycle span tracing (DESIGN.md §8).

A ``Tracer`` records named time intervals ("spans") with structured
attributes and exports them as Chrome trace-event JSON — the format
Perfetto (https://ui.perfetto.dev) and ``chrome://tracing`` load
directly. Two kinds of span, matching the two shapes of serving work:

* **track spans** (``async_id=None``) — engine-side work that happens
  strictly nested on a logical thread: ``submit``, ``step``,
  ``dispatch``, ``compile``, per-cascade-step work. Exported as ``ph:
  "X"`` complete events on one trace thread per ``track`` name.
* **async spans** (``async_id=<query rid>``) — per-query lifecycle
  intervals that OUTLIVE any single engine call: the root ``query``
  span (submit -> delivery), its ``queued`` waits and per-attempt
  ``rung`` spans. Exported as ``ph: "b"/"e"`` async event pairs keyed
  on the rid, so Perfetto renders each query as its own nested lane
  without one trace thread per request.

The tracer is deliberately dumb and allocation-light: ``begin``/``end``
append plain ``Span`` records stamped with ``clock`` (the Unix clock, in
seconds); nothing is formatted until ``export``. torch.profiler (Kineto)
stamps its host and device events on the same clock, in nanoseconds, so
``to_ns(span.t0)`` places a span on a device trace. The serving engine,
the SPARQL front end, the planner, ``execute_local`` and ``build_store``
take ``tracer=None`` by default and guard every hook with one ``is not
None`` test — the off path adds no work (overhead policy: DESIGN.md §8).
"""
from __future__ import annotations

import contextlib
import json
import time
from typing import Any, Callable


def clock_ns() -> int:
    """The one clock of every span, in ns: the Unix clock, the clock
    torch.profiler stamps its host and CUDA events on."""
    return time.time_ns()


def clock() -> float:
    """``clock_ns`` in seconds, the unit of a ``Span``'s stamps (a float
    holds a Unix time to a quarter of a microsecond)."""
    return time.time_ns() / 1e9


def to_ns(t: float) -> int:
    """A stamp of ``clock`` back in ``clock_ns``'s nanoseconds (within
    half a microsecond)."""
    return round(t * 1e9)


_NO_SPAN = contextlib.nullcontext()


def optional_span(tracer: "Tracer | None", name: str, **attrs: Any):
    """``tracer.span(name, **attrs)``, or, when `tracer` is None, a
    context that records nothing and yields None: a hook's one ``is not
    None`` test."""
    return _NO_SPAN if tracer is None else tracer.span(name, **attrs)


class Span:
    """One recorded interval. ``t1 is None`` while the span is open.

    A plain ``__slots__`` record, not a dataclass: span construction sits
    on the serving engine's per-query path, where the <= 2% tracing
    budget (DESIGN.md §8) is measured in hundreds of nanoseconds.
    ``span_id`` defaults to the object's identity — unique for the
    tracer's lifetime since every span stays referenced by its list."""

    __slots__ = ("name", "t0", "t1", "track", "attrs", "span_id",
                 "parent_id", "async_id")

    def __init__(self, name: str, t0: float, t1: float | None, track: str,
                 attrs: dict, span_id: int | None = None,
                 parent_id: int | None = None, async_id: int | None = None):
        self.name = name
        self.t0 = t0
        self.t1 = t1
        self.track = track
        self.attrs = attrs
        self.span_id = id(self) if span_id is None else span_id
        self.parent_id = parent_id
        self.async_id = async_id

    @property
    def dur(self) -> float:
        return (self.t1 if self.t1 is not None else self.t0) - self.t0

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, track={self.track!r}, "
                f"dur={self.dur:.6f}, attrs={self.attrs!r})")


class Tracer:
    """Span recorder with Chrome trace-event export.

    ``begin``/``end`` handle non-lexical spans (a query span opens in
    ``submit`` and closes in a later ``step``); the ``span`` context
    manager handles lexical ones and maintains a parent stack. Spans
    are stamped on ``clock`` unless another clock is given (the tests'
    fake clocks)."""

    def __init__(self, clock: Callable[[], float] = clock):
        self._clock = clock
        self.spans: list[Span] = []
        self._open: dict[int, Span] = {}
        self._stack: list[Span] = []

    # --- recording -------------------------------------------------------

    def now(self) -> float:
        return self._clock()

    def begin(self, name: str, track: str = "engine",
              parent: Span | None = None, async_id: int | None = None,
              **attrs: Any) -> Span:
        sp = Span(name, self._clock(), None, track, attrs, None,
                  parent.span_id if parent is not None else None, async_id)
        self._open[sp.span_id] = sp
        return sp

    def end(self, span: Span, **attrs: Any) -> Span:
        if span.span_id not in self._open:
            raise ValueError(f"span {span.name!r} already ended")
        del self._open[span.span_id]
        span.t1 = self._clock()
        if attrs:
            span.attrs.update(attrs)
        self.spans.append(span)
        return span

    def record(self, name: str, t0: float, t1: float, track: str = "engine",
               parent: Span | None = None, async_id: int | None = None,
               **attrs: Any) -> Span:
        """Append an already-measured interval (explicit stamps on this
        tracer's clock) — for callees that timed themselves."""
        sp = Span(name, t0, t1, track, attrs, None,
                  parent.span_id if parent is not None else None, async_id)
        self.spans.append(sp)
        return sp

    @contextlib.contextmanager
    def span(self, name: str, track: str = "engine",
             parent: Span | None = None, async_id: int | None = None,
             **attrs: Any):
        if parent is None and self._stack:
            parent = self._stack[-1]
        sp = self.begin(name, track, parent, async_id, **attrs)
        self._stack.append(sp)
        try:
            yield sp
        finally:
            self._stack.pop()
            self.end(sp)

    # --- introspection ---------------------------------------------------

    @property
    def open_count(self) -> int:
        return len(self._open)

    def open_spans(self) -> list[Span]:
        return list(self._open.values())

    def find(self, name: str, track: str | None = None) -> list[Span]:
        return [s for s in self.spans
                if s.name == name and (track is None or s.track == track)]

    def coverage(self, t0: float, t1: float, track: str = "engine") -> float:
        """Fraction of the wall interval [t0, t1] covered by the union of
        TOP-LEVEL (parentless) completed spans on `track` — the
        attributed-time metric behind the >= 95% acceptance gate. Child
        spans are excluded so nesting can never double-count."""
        if t1 <= t0:
            return 0.0
        ivs = sorted((max(s.t0, t0), min(s.t1, t1)) for s in self.spans
                     if s.track == track and s.parent_id is None
                     and s.t1 is not None and s.t1 > t0 and s.t0 < t1)
        covered, cur_lo, cur_hi = 0.0, None, None
        for lo, hi in ivs:
            if cur_hi is None or lo > cur_hi:
                if cur_hi is not None:
                    covered += cur_hi - cur_lo
                cur_lo, cur_hi = lo, hi
            else:
                cur_hi = max(cur_hi, hi)
        if cur_hi is not None:
            covered += cur_hi - cur_lo
        return covered / (t1 - t0)

    # --- Chrome trace-event export --------------------------------------

    def to_events(self) -> list[dict]:
        """Chrome trace events: one trace thread per distinct track name
        (``M``/thread_name metadata + ``X`` complete events, ts/dur in
        µs) plus ``b``/``e`` async pairs for per-query spans."""
        tids: dict[str, int] = {}
        events: list[dict] = []
        for track in sorted({s.track for s in self.spans}):
            tids[track] = len(tids) + 1
            events.append({"ph": "M", "pid": 1, "tid": tids[track],
                           "name": "thread_name", "args": {"name": track}})
        for s in self.spans:
            if s.t1 is None:
                continue
            args = _jsonable(s.attrs)
            if s.async_id is not None:
                common = {"pid": 1, "cat": s.track, "name": s.name,
                          "id": s.async_id}
                events.append({"ph": "b", "ts": s.t0 * 1e6, "args": args,
                               **common})
                events.append({"ph": "e", "ts": s.t1 * 1e6, **common})
            else:
                events.append({"ph": "X", "pid": 1, "tid": tids[s.track],
                               "cat": s.track, "name": s.name,
                               "ts": s.t0 * 1e6, "dur": s.dur * 1e6,
                               "args": args})
        return events

    def export(self, path: str) -> str:
        """Write the trace as a Perfetto-loadable JSON object; returns
        `path`. Open at https://ui.perfetto.dev -> "Open trace file"."""
        with open(path, "w") as f:
            json.dump({"traceEvents": self.to_events(),
                       "displayTimeUnit": "ms"}, f)
            f.write("\n")
        return path


def _jsonable(attrs: dict) -> dict:
    out = {}
    for k, v in attrs.items():
        if isinstance(v, (str, int, float, bool)) or v is None:
            out[k] = v
        elif isinstance(v, (tuple, list)):
            out[k] = [x if isinstance(x, (str, int, float, bool))
                      else str(x) for x in v]
        else:
            out[k] = str(v)
    return out


def load_chrome(path: str) -> list:
    """Load an exported trace back and return its event list; raises
    ValueError if the file is not schema-valid Chrome trace-event JSON
    (used by tests and the bench's artifact self-check)."""
    with open(path) as f:
        doc = json.load(f)
    events = doc.get("traceEvents")
    validate_events(events)
    return events


def validate_events(events) -> None:
    """Schema check: every event has ph/pid/ts (or is metadata), X events
    carry non-negative dur, and async b/e pairs balance per (cat, id)."""
    if not isinstance(events, list):
        raise ValueError("traceEvents is not a list")
    depth: dict[tuple, int] = {}
    for ev in events:
        if not isinstance(ev, dict) or "ph" not in ev or "pid" not in ev:
            raise ValueError(f"malformed event: {ev!r}")
        ph = ev["ph"]
        if ph == "M":
            continue
        if "ts" not in ev:
            raise ValueError(f"event missing ts: {ev!r}")
        if ph == "X":
            if ev.get("dur", -1) < 0:
                raise ValueError(f"X event without dur: {ev!r}")
        elif ph in ("b", "e"):
            key = (ev.get("cat"), ev.get("id"))
            if key[1] is None:
                raise ValueError(f"async event without id: {ev!r}")
            depth[key] = depth.get(key, 0) + (1 if ph == "b" else -1)
            if depth[key] < 0:
                raise ValueError(f"async 'e' before 'b' for {key}")
    bad = {k: d for k, d in depth.items() if d != 0}
    if bad:
        raise ValueError(f"unbalanced async spans: {bad}")


def spans_from_stats(tracer: Tracer, stats: list, parent: Span | None = None,
                     track: str = "engine",
                     async_id: int | None = None) -> list[Span]:
    """Convert the per-step dicts of an instrumented ``execute_local``
    run (which stamp ``t0``/``t1`` on ``clock``, the default tracer
    clock) into
    per-cascade-step child spans. Pass ``async_id`` when the parent
    lives on a per-query async lane so the children render in it."""
    out = []
    for i, st in enumerate(stats):
        if "t0" not in st or "t1" not in st:
            continue
        attrs = {k: st[k] for k in ("kind", "n_in", "n_out", "overflow",
                                    "deliveries", "probe_len_max")
                 if k in st}
        out.append(tracer.record(f"cascade_step[{i}]", st["t0"], st["t1"],
                                 track=track, parent=parent,
                                 async_id=async_id, **attrs))
    return out
