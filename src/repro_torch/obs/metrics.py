"""Serving metrics registry (DESIGN.md §8).

Prometheus-shaped primitives — ``Counter``, ``Gauge``, fixed-bucket
``Histogram`` — keyed by (name, labels) in a ``MetricsRegistry``.
``REGISTRY`` is the process-global default the serving engine records
into unless handed its own (tests) or ``metrics=False`` (disabled:
``NULL_REGISTRY``, every operation a no-op).

Snapshots come in two shapes: ``to_dict()`` (nested JSON — histograms
carry estimated p50/p99 so per-template / per-tenant latency SLOs read
straight off the snapshot) and ``to_prom_text()`` (Prometheus text
exposition: cumulative ``_bucket{le=...}`` counts + ``_sum``/``_count``).
``add_hook(interval_s, fn)`` registers a periodic snapshot callback the
engine ticks from ``step()``.

Quantiles are ESTIMATES, interpolated inside the bucket that crosses the
target rank — the standard histogram_quantile trade: O(n_buckets) memory
for bounded error set by the bucket grid, exact at bucket boundaries.
"""
from __future__ import annotations

import bisect
import time
from typing import Callable

# latency grid (seconds): ~1-2.5-5 per decade, 100µs .. 60s
DEFAULT_LATENCY_BUCKETS = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    1e-1, 2.5e-1, 5e-1, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, float("inf"))

# batch sizes / small counts: powers of two up to 256
DEFAULT_SIZE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, float("inf"))


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.value -= n


class Histogram:
    """Fixed-bucket histogram: ``bounds`` are ascending upper edges, the
    last must be +inf. ``observe`` is a bisect + two adds."""
    __slots__ = ("bounds", "counts", "sum", "count", "max")

    def __init__(self, bounds=DEFAULT_LATENCY_BUCKETS):
        bounds = tuple(float(b) for b in bounds)
        if not bounds or bounds[-1] != float("inf"):
            bounds = bounds + (float("inf"),)
        if list(bounds) != sorted(set(bounds)):
            raise ValueError(f"bucket bounds not strictly ascending: {bounds}")
        self.bounds = bounds
        self.counts = [0] * len(bounds)
        self.sum = 0.0
        self.count = 0
        self.max = 0.0

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1
        if v > self.max:
            self.max = v

    def quantile(self, q: float) -> float:
        """Estimated q-quantile by linear interpolation inside the
        crossing bucket; the +inf bucket reports the observed max."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        cum, lo = 0, 0.0
        for b, c in zip(self.bounds, self.counts):
            if c and cum + c >= target:
                if b == float("inf"):
                    return self.max
                return lo + (b - lo) * (target - cum) / c
            cum += c
            if b != float("inf"):
                lo = b
        return self.max

    def cumulative(self) -> list[tuple[float, int]]:
        out, cum = [], 0
        for b, c in zip(self.bounds, self.counts):
            cum += c
            out.append((b, cum))
        return out


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


def _label_str(lk: tuple) -> str:
    return ",".join(f'{k}="{v}"' for k, v in lk)


class MetricsRegistry:
    """Get-or-create instrument store. One instrument per (name, labels);
    a name is pinned to one kind (counter/gauge/histogram) at first use."""

    def __init__(self):
        self._instruments: dict[tuple, object] = {}
        self._kinds: dict[str, str] = {}
        self._hooks: list[list] = []     # [interval_s, next_due, fn]

    def _get(self, kind: str, name: str, labels: dict, make):
        have = self._kinds.setdefault(name, kind)
        if have != kind:
            raise ValueError(f"metric {name!r} already registered as {have}")
        key = (name, _label_key(labels))
        inst = self._instruments.get(key)
        if inst is None:
            inst = self._instruments[key] = make()
        return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels, Gauge)

    def histogram(self, name: str, buckets=None, **labels) -> Histogram:
        bounds = DEFAULT_LATENCY_BUCKETS if buckets is None else buckets
        return self._get("histogram", name, labels,
                         lambda: Histogram(bounds))

    # --- snapshots -------------------------------------------------------

    def to_dict(self) -> dict:
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        for (name, lk), inst in sorted(self._instruments.items()):
            key = f"{name}{{{_label_str(lk)}}}" if lk else name
            if isinstance(inst, Counter):
                out["counters"][key] = inst.value
            elif isinstance(inst, Gauge):
                out["gauges"][key] = inst.value
            else:
                out["histograms"][key] = {
                    "count": inst.count, "sum": inst.sum, "max": inst.max,
                    "p50": inst.quantile(0.50), "p99": inst.quantile(0.99),
                    "buckets": {("+Inf" if b == float("inf") else repr(b)): c
                                for b, c in inst.cumulative()},
                }
        return out

    def to_prom_text(self) -> str:
        lines: list[str] = []
        by_name: dict[str, list] = {}
        for (name, lk), inst in sorted(self._instruments.items()):
            by_name.setdefault(name, []).append((lk, inst))
        for name, insts in by_name.items():
            lines.append(f"# TYPE {name} {self._kinds[name]}")
            for lk, inst in insts:
                ls = _label_str(lk)
                if isinstance(inst, (Counter, Gauge)):
                    lines.append(f"{name}{{{ls}}} {inst.value:g}" if ls
                                 else f"{name} {inst.value:g}")
                else:
                    for b, cum in inst.cumulative():
                        le = "+Inf" if b == float("inf") else f"{b:g}"
                        sep = "," if ls else ""
                        lines.append(
                            f'{name}_bucket{{{ls}{sep}le="{le}"}} {cum}')
                    lines.append(f"{name}_sum{{{ls}}} {inst.sum:g}" if ls
                                 else f"{name}_sum {inst.sum:g}")
                    lines.append(f"{name}_count{{{ls}}} {inst.count}" if ls
                                 else f"{name}_count {inst.count}")
        return "\n".join(lines) + ("\n" if lines else "")

    # --- periodic snapshot hook -----------------------------------------

    def add_hook(self, interval_s: float,
                 fn: Callable[["MetricsRegistry"], None]) -> None:
        """Register `fn(registry)` to fire at most every `interval_s`
        seconds, evaluated on `tick()` (the engine ticks once per step —
        no background thread, so a quiet engine fires no hooks).  The
        first tick arms the interval in the caller's clock domain (wall
        by default, virtual when `tick(now=...)` is driven by a replay)."""
        self._hooks.append([interval_s, None, fn])

    def tick(self, now: float | None = None) -> int:
        now = time.monotonic() if now is None else now
        fired = 0
        for hook in self._hooks:
            if hook[1] is None:
                hook[1] = now + hook[0]
            elif now >= hook[1]:
                hook[1] = now + hook[0]
                hook[2](self)
                fired += 1
        return fired

    def reset(self) -> None:
        self._instruments.clear()
        self._kinds.clear()


class _NullInstrument:
    """Shared no-op stand-in for every instrument kind."""
    __slots__ = ()
    value = 0.0
    count = 0
    sum = 0.0
    max = 0.0

    def inc(self, n: float = 1.0) -> None: pass
    def dec(self, n: float = 1.0) -> None: pass
    def set(self, v: float) -> None: pass
    def observe(self, v: float) -> None: pass
    def quantile(self, q: float) -> float: return 0.0


class NullRegistry(MetricsRegistry):
    """Disabled registry: hands out one shared no-op instrument and
    snapshots empty — ``ServeEngine(metrics=False)`` uses this."""
    _null = _NullInstrument()

    def __init__(self):
        super().__init__()

    def counter(self, name, **labels): return self._null
    def gauge(self, name, **labels): return self._null
    def histogram(self, name, buckets=None, **labels): return self._null
    def add_hook(self, interval_s, fn): pass
    def tick(self, now=None): return 0


#: process-global default registry (the engine's ``metrics=None`` target)
REGISTRY = MetricsRegistry()

#: shared disabled registry (``metrics=False``)
NULL_REGISTRY = NullRegistry()
