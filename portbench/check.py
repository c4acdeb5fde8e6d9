"""What decides `correct`: the answers of the window held against the plain
reference (`portbench/reference/bgp.py`), over the benchmark's own triples
and term table.

Both answers of a query are reduced to an order-free digest of the
multiset of their rows, over the variables sorted by name: the number of
rows and two sums (mod 2^64) of a 64-bit mix of each row. Every number
compared has the limit 0, since each answer has to be the exact answer
set:

- `wrong_answers`: compared answers whose digest differs from the
  reference's (a row lost, added, altered or doubled);
- `overflowed_answers`: answers that report rows dropped at a capacity.

The control (`control_answer`) is the reference with the guarantee broken
as a later change might be tempted to break it: each answer cut at a
capacity, the mix's `control_cap` rows.
"""
from __future__ import annotations

import numpy as np

from portbench.gen.common import rng_for
from portbench.reference import bgp

LIMITS = {"wrong_answers": 0, "overflowed_answers": 0}
_M1, _M2 = np.uint64(0xBF58476D1CE4E5B9), np.uint64(0x94D049BB133111EB)
_SALTS = (np.uint64(0x9E3779B97F4A7C15), np.uint64(0xD6E8FEB86659FD93))


def _mix(z: np.ndarray) -> np.ndarray:
    z = (z ^ (z >> np.uint64(30))) * _M1
    z = (z ^ (z >> np.uint64(27))) * _M2
    return z ^ (z >> np.uint64(31))


def digest(vars_: tuple, rows: np.ndarray) -> tuple:
    """(sorted variable names, row count, two row-hash sums)."""
    order = sorted(range(len(vars_)), key=lambda i: vars_[i])
    cols = np.asarray(rows, np.int64).reshape(len(rows), len(vars_))[:, order]
    cols = cols.astype(np.uint64)
    sums = []
    with np.errstate(over="ignore"):
        for salt in _SALTS:
            h = np.full(len(cols), salt, np.uint64)
            for j in range(cols.shape[1]):
                h = _mix(h ^ cols[:, j] + np.uint64(j + 1) * salt)
            sums.append(int(h.sum(dtype=np.uint64)))
    return (tuple(sorted(vars_)), len(cols), *sums)


class Reference:
    """The reference over one generated graph, with its answers cached by
    query text."""

    def __init__(self, graph):
        self.graph = graph
        self.index = bgp.Index(graph.triples)
        self._cache: dict = {}

    def answer(self, text: str) -> tuple:
        """(vars, rows) of a query."""
        if text not in self._cache:
            self._cache[text] = bgp.evaluate(self.index, bgp.parse(text),
                                             self.graph.term_id)
        return self._cache[text]

    def control_answer(self, text: str, cap: int) -> tuple:
        """The control's answer, worked out afresh for each request as the
        program's would be."""
        vars_, rows = bgp.evaluate(self.index, bgp.parse(text),
                                   self.graph.term_id)
        return vars_, rows[:cap]


def sample(requests: list, n: int | None, seed: int) -> list:
    """All requests, or `n` of them drawn from the seed."""
    if n is None or len(requests) <= n:
        return list(requests)
    pick = rng_for(seed).choice(len(requests), n, replace=False)
    return [requests[i] for i in sorted(pick)]


def judge(requests: list, ref: Reference, check_sample: int | None,
          seed: int) -> dict:
    """{name: value} of the numbers compared, with `compared`, the answers
    held against the reference."""
    out = dict.fromkeys(LIMITS, 0)
    answered = [r for r in requests if r.status == "ok"]
    out["overflowed_answers"] = sum(r.overflow > 0 for r in answered)
    want: dict = {}
    picked = sample(answered, check_sample, seed ^ 0xC4EC)
    for r in picked:
        if r.text not in want:
            want[r.text] = digest(*ref.answer(r.text))
        out["wrong_answers"] += digest(r.vars, r.rows) != want[r.text]
    out["compared"] = len(picked)
    return out


def verdict(numbers: dict) -> bool:
    return all(numbers[k] <= lim for k, lim in LIMITS.items())
