"""One measured window: its requests and the end-to-end metrics taken
from them on the host's clock."""
from __future__ import annotations

import dataclasses
import math

import numpy as np

@dataclasses.dataclass
class Request:
    key: str                      # the query it was made from
    text: str                     # its SPARQL text
    sent: float                   # when it was sent
    done: float | None = None     # when its rows were in host memory
    status: str = "pending"       # ok, or what kept it from an answer
    vars: tuple = ()
    rows: np.ndarray | None = None
    overflow: int = 0


@dataclasses.dataclass
class Window:
    requests: list
    t0: float                     # perf_counter at open and close
    t1: float

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def answered_in_window(self) -> int:
        return sum(r.status == "ok" and r.overflow == 0
                   for r in self.requests)

    def failed(self) -> int:
        return sum(r.status != "ok" for r in self.requests)

    def latencies(self) -> list:
        """Each request's latency in ms; one with no answer runs to the
        window's close."""
        return [((r.done if r.status == "ok" else self.t1) - r.sent) * 1e3
                for r in self.requests]

    def latencies_by_key(self) -> dict:
        out: dict = {}
        for r, ms in zip(self.requests, self.latencies()):
            out.setdefault(r.key, []).append(ms)
        return out


def nearest_rank(values: list, q: float) -> float:
    """The q-quantile by nearest rank: the smallest value with at least a
    share q of all values at or below it."""
    xs = sorted(values)
    return xs[max(math.ceil(q * len(xs)) - 1, 0)]


def end_to_end(win: Window) -> dict:
    """qps (exact answers in the window a second) and the latency median
    and 95th percentile over every request of the window, in ms, both by
    nearest rank. A request with no answer counts with the time to the
    window's close."""
    lat = win.latencies()
    return {"qps": win.answered_in_window() / win.seconds,
            "latency_p50_ms": nearest_rank(lat, 0.50),
            "latency_p95_ms": nearest_rank(lat, 0.95)}
