"""Brute-force BGP oracle (numpy only) — ground truth for tests.

Nested-loop evaluation: for every partial binding, every stored triple is
tested against the next pattern. The test over the triples is one numpy
mask per binding, so the oracle stays usable on a university-sized LUBM
graph; it shares no code with the engine.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core.rdf import Pattern, is_var


def match_pattern(triples: np.ndarray, pattern: Pattern,
                  binding: dict[str, int]):
    """Yield extended bindings for one pattern given a partial binding."""
    ok = np.ones(len(triples), bool)
    first: dict[str, int] = {}           # var -> first column it occupies
    for col, term in enumerate(pattern.terms):
        if not is_var(term):
            ok &= triples[:, col] == int(term)
        elif term in binding:
            ok &= triples[:, col] == binding[term]
        elif term in first:
            ok &= triples[:, col] == triples[:, first[term]]
        else:
            first[term] = col
    for row in triples[ok]:
        b = dict(binding)
        for var, col in first.items():
            b[var] = int(row[col])
        yield b


def execute_oracle(triples: np.ndarray, patterns: Sequence[Pattern],
                   var_order: Sequence[str] | None = None):
    """Full nested-loop evaluation; returns (set of rows, var order)."""
    triples = np.unique(np.asarray(triples), axis=0)
    bindings: list[dict[str, int]] = [{}]
    for pat in patterns:
        bindings = [b2 for b in bindings for b2 in match_pattern(triples, pat, b)]
    if var_order is None:
        var_order = []
        for pat in patterns:
            for v in pat.variables:
                if v not in var_order:
                    var_order.append(v)
    rows = set(tuple(b[v] for v in var_order) for b in bindings)
    return rows, tuple(var_order)
