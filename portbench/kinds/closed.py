"""Closed loop: one client that sends its next query only when the answer
to the last is in host memory, as an analyst at a SPARQL prompt does.

The mix names the configuration's query set; each query runs once a round,
in an order shuffled from the seed. Every query goes through the front
end (`parse_bgp`), the cascade (`execute_local`, plans from the store's
plan cache after the warm-up) and the copy of its valid rows to the host.
A request's latency runs from when it was sent to that copy.

The window holds whole rounds: the round under way at `seconds` runs to
its end, and the window closes there. So every query of the set runs
equally often in it, and a percentile over all requests does not move
with how many requests of a round fell inside.
"""
from __future__ import annotations

import collections
import statistics
import sys
import time

from portbench import roofline, sut
from portbench.gen.common import rng_for
from portbench.window import Request, Window


class Loop:
    def __init__(self, cell, graph, seed: int, device: str, spans,
                 control=None):
        t = cell.traffic
        self.cell, self.graph, self.seed = cell, graph, seed
        self.device, self.spans = device, spans
        self.queries = dict(sorted(cell.config[t["queries"]].items()))
        self.control = control            # a Reference in the port's place

    def setup(self) -> None:
        t = self.cell.traffic
        if self.control is not None:
            return
        self.store, self.dictionary = sut.load(self.graph, self.device)
        self.caps = sut.caps(t["caps"])
        for k in range(t["warmup_rounds"]):
            t0 = time.perf_counter()
            for text in self.queries.values():
                self.ask(text)
            print(f"[setup] warm-up round {k}: "
                  f"{time.perf_counter() - t0:.3f} s", file=sys.stderr)

    def ask(self, text: str):
        if self.control is not None:
            return (*self.control.control_answer(
                text, self.cell.traffic["control_cap"]), 0)
        return sut.ask(self.store, self.dictionary, text, self.caps,
                       self.spans)

    def run(self, seconds: float) -> Window:
        rng = rng_for(self.seed ^ 0x0DE2)
        keys = list(self.queries)
        reqs = []
        t0 = time.perf_counter()
        t_end = t0 + seconds
        while time.perf_counter() < t_end:
            for i in rng.permutation(len(keys)):
                text = self.queries[keys[i]]
                issued = time.perf_counter()
                vars_, rows, ovf = self.ask(text)
                reqs.append(Request(keys[i], text, issued,
                                    time.perf_counter(), "ok", tuple(vars_),
                                    rows, ovf))
        win = Window(reqs, t0, time.perf_counter())
        for key, ms in sorted(win.latencies_by_key().items()):
            print(f"[window] {key}: {len(ms)} runs, median "
                  f"{statistics.median(ms):.3f} ms", file=sys.stderr)
        return win

    def op_bytes(self, window: Window, torch) -> dict:
        """{op: bytes} of the index kernels' calls in the window: each
        distinct query replayed once under a dispatch mode that records its
        calls, its bytes times the times it ran. The queries are fixed, so
        each run makes the same calls."""
        runs = collections.Counter(r.text for r in window.requests)
        total = dict.fromkeys(sut.OPS, 0)
        for text, n in runs.items():
            for op, args in sut.op_calls(lambda: self.ask(text)):
                total[op] += n * roofline.call_bytes(torch, op, args)
        return total

    def close(self) -> None:
        self.store = self.dictionary = None
