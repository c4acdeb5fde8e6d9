"""The traced window: the device's operations from torch.profiler, the
harness's own host spans, and what is read from the two.

Only CUDA activity is recorded (kernels, copies and sets on the card, and
the runtime's calls), not every operator on the host, so a window of some
hundred thousand launches stays cheap to record and to read. The events
are read straight from the profiler's result, without building its
per-operator tables. Kineto stamps events on the Unix clock, so the host
spans are stamped with `time.time_ns()`.
"""
from __future__ import annotations

import collections
import time

class Spans:
    """The harness's host spans of one window: (name, t0_ns, t1_ns), or no
    record at all when the run is not traced."""

    def __init__(self, on: bool):
        self.on = on
        self.items: list = []

    def add(self, name: str, t0: int, t1: int) -> None:
        if self.on:
            self.items.append((name, t0, t1))


def now_ns() -> int:
    return time.time_ns()


class DeviceTrace:
    """`with DeviceTrace(torch) as tr:` records the device's operations of
    the block; afterwards `tr.ops` holds (name, kind, start_ns, dur_ns) of
    each, sorted by start, and `tr.t0`, `tr.t1` bound the window."""

    def __init__(self, torch):
        self.torch = torch
        self.ops: list = []

    def __enter__(self):
        prof = self.torch.profiler
        self._prof = prof.profile(activities=[prof.ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.torch.cuda.synchronize()
        self.t0 = now_ns()
        return self

    def __exit__(self, *exc):
        self.torch.cuda.synchronize()
        self.t1 = now_ns()
        self._prof.__exit__(*exc)
        ops = []
        for e in self._prof.profiler.kineto_results.events():
            if "CUDA" not in str(e.device_type()):
                continue                  # the host's side of the trace
            annotation = getattr(e, "is_user_annotation", None)
            if annotation is not None and annotation():
                continue
            name, t0 = e.name(), e.start_ns()
            kind = ("gpu_memcpy" if name.startswith("Memcpy") else
                    "gpu_memset" if name.startswith("Memset") else "kernel")
            if self.t0 <= t0 <= self.t1:
                ops.append((name, kind, t0, e.duration_ns()))
        ops.sort(key=lambda x: x[2])
        self.ops = ops
        return False

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def kernels(self) -> list:
        return [op for op in self.ops if op[1] == "kernel"]

    def busy_intervals(self) -> list:
        """The union of the device's operations as disjoint [t0, t1)."""
        out: list = []
        for _, _, t0, d in self.ops:
            t1 = t0 + d
            if out and t0 <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t1)
            else:
                out.append([t0, t1])
        return out

    def busy_s(self) -> float:
        return sum(t1 - t0 for t0, t1 in self.busy_intervals()) / 1e9

    def breakdown(self, spans: list, top: int = 10) -> dict:
        """The device operations that took most time, by name, and the idle
        time between them summed by the innermost host span open at the
        middle of each gap ("outside any span" where none is)."""
        by_op = collections.Counter()
        for name, _, _, d in self.ops:
            by_op[name] += d / 1e9
        gaps = collections.Counter()
        busy = self.busy_intervals()
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        starts = sorted(spans, key=lambda s: s[1])
        nxt, active = 0, []          # spans open at the sweep's point
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) // 2
            while nxt < len(starts) and starts[nxt][1] <= mid:
                active.append(starts[nxt])
                nxt += 1
            active = [s for s in active if s[2] > mid]
            inner = min(active, key=lambda s: s[2] - s[1], default=None)
            gaps[inner[0] if inner else "outside any span"] += (b - a) / 1e9
        return {"device_ops": [[n, s] for n, s in by_op.most_common(top)],
                "idle_gaps": [[n, s] for n, s in gaps.most_common(top)]}
