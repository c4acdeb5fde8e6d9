"""The plain reference: basic graph patterns over id triples, in numpy.

It shares no code with the system under test. It reads SPARQL text with
its own small parser (`parse`), resolves constants through the benchmark's
own term table, keeps its own three sorted orders of the triples (SPO,
POS, OSP) and answers a pattern list by index nested-loop joins: each
pattern in turn, every bound position of it looked up as a range of one
sorted order, the ranges of all rows expanded at once.

A solution is a mapping of every variable of the pattern list; the answer
is the multiset of solutions, as rows of term ids in `vars` order.
"""
from __future__ import annotations

import numpy as np

RDF_TYPE = "rdf:type"
# the order whose key prefix covers each set of bound positions (0 s, 1 p,
# 2 o): SPO, POS, OSP
_ORDERS = ((0, 1, 2), (1, 2, 0), (2, 0, 1))


def _order_for(bound: frozenset) -> int:
    for k, order in enumerate(_ORDERS):
        if set(order[:len(bound)]) == bound:
            return k
    raise AssertionError(bound)


def parse(text: str) -> tuple[tuple[str, str, str], ...]:
    """(s, p, o) terms of a `[PREFIX p: <iri>]* SELECT ... WHERE { ... }`
    query whose tokens are separated by white space; a variable keeps its
    `?`, a constant is the term itself."""
    toks = text.split()
    prefixes, i = {}, 0
    while toks[i].upper() == "PREFIX":
        prefixes[toks[i + 1][:-1]] = toks[i + 2][1:-1]
        i += 3
    i = toks.index("{", i) + 1
    end = toks.index("}", i)

    def term(tok: str) -> str:
        if tok.startswith("?"):
            return tok
        if tok == "a":
            return RDF_TYPE
        if tok[0] in "<\"":
            return tok[1:-1]
        pfx, _, local = tok.partition(":")
        return prefixes[pfx] + local

    body = toks[i:end]
    pats = []
    while body:
        s, p, o, *body = body
        pats.append((term(s), term(p), term(o)))
        if body:
            if body[0] != ".":
                raise ValueError(f"expected '.', got {body[0]!r}")
            body = body[1:]
    return tuple(pats)


class Index:
    """The triples as three sorted int64 key arrays, one an order."""

    def __init__(self, triples: np.ndarray):
        t = np.asarray(triples, np.int64)
        # ids below `base`, so a key of three (< 2^21 - 1 each) fits int64
        self.base = int(t.max()) + 1 if len(t) else 1
        b = self.base
        self.keys = [np.unique((t[:, a] * b + t[:, c]) * b + t[:, d])
                     for a, c, d in _ORDERS]

    def _split(self, keys: np.ndarray, order: tuple) -> np.ndarray:
        """(n, 3) s, p, o columns of keys of one order."""
        b = self.base
        out = np.empty((len(keys), 3), np.int64)
        out[:, order[2]] = keys % b
        out[:, order[1]] = keys // b % b
        out[:, order[0]] = keys // (b * b)
        return out

    def _range(self, bound: dict, n: int):
        """(order, its keys, first and past-last match of each of n rows)."""
        k = _order_for(frozenset(bound))
        order, keys, b = _ORDERS[k], self.keys[k], self.base
        lo = np.zeros(n, np.int64)
        for pos in order:
            lo = lo * b + (bound[pos] if pos in bound else 0)
        span = b ** (3 - len(bound))
        return (order, keys, np.searchsorted(keys, lo),
                np.searchsorted(keys, lo + span))

    def lookup(self, bound: dict, n: int) -> tuple[np.ndarray, np.ndarray]:
        """All triples that agree with `bound` (position -> (n,) values):
        (row of each match in 0..n-1, (m, 3) matched triples)."""
        order, keys, start, stop = self._range(bound, n)
        cnt = stop - start
        row = np.repeat(np.arange(n), cnt)
        first = np.repeat(start - np.cumsum(cnt) + cnt, cnt)
        return row, self._split(keys[first + np.arange(len(row))], order)

    def count(self, bound: dict) -> int:
        """Matches of one set of bound positions (position -> value)."""
        _, _, start, stop = self._range(
            {k: np.array([v]) for k, v in bound.items()}, 1)
        return int(stop[0] - start[0])


def evaluate(index: Index, patterns, term_id) -> tuple[tuple, np.ndarray]:
    """(vars, rows): every solution of the pattern list, rows (m, len(vars))
    int64 in `vars` order (variables in order of first use). `term_id` maps
    a constant to its id, or None where the graph lacks it (no solution)."""
    pats = []
    for pat in patterns:
        ids = [t if t.startswith("?") else term_id(t) for t in pat]
        if any(x is None or (not isinstance(x, str) and x >= index.base)
               for x in ids):
            return _vars_of(patterns), np.zeros((0, len(_vars_of(patterns))),
                                                np.int64)
        pats.append(ids)
    consts = lambda p: {i: x for i, x in enumerate(p)
                        if not isinstance(x, str)}
    size = {id(p): index.count(consts(p)) for p in pats}
    vars_: list = []
    rows = np.zeros((1, 0), np.int64)
    todo = list(pats)
    while todo:
        # most positions bound first, then fewest matches on its constants
        def rank(p):
            nb = sum(not isinstance(x, str) or x in vars_ for x in p)
            return (-nb, size[id(p)])
        p = min(todo, key=rank)
        todo.remove(p)
        bound = {i: (np.full(len(rows), x) if not isinstance(x, str)
                     else rows[:, vars_.index(x)])
                 for i, x in enumerate(p)
                 if not isinstance(x, str) or x in vars_}
        row, m = index.lookup(bound, len(rows))
        keep = np.ones(len(row), bool)
        new: list = []
        for i, x in enumerate(p):
            if isinstance(x, str) and x not in vars_:
                if x in new:                   # a variable twice in p
                    keep &= m[:, i] == m[:, p.index(x)]
                else:
                    new.append(x)
        row, m = row[keep], m[keep]
        rows = np.concatenate(
            [rows[row]] + [m[:, [p.index(x)]] for x in new], axis=1)
        vars_.extend(new)
    names = _vars_of(patterns)
    return names, rows[:, [vars_.index(v) for v in names]]


def _vars_of(patterns) -> tuple:
    out: list = []
    for pat in patterns:
        for t in pat:
            if t.startswith("?") and t not in out:
                out.append(t)
    return tuple(out)
