"""What the schema generators share: the generated graph and vectorised
draws over segments (the members of each department, say)."""
from __future__ import annotations

import dataclasses

import numpy as np

RDF_TYPE = "rdf:type"


def rng_for(seed: int) -> np.random.Generator:
    """The generator of one run: any whole seed, negative or past 64 bits
    included, maps to one stream."""
    return np.random.default_rng(int(seed) % (1 << 64))


def draw(rng: np.random.Generator, lo_hi, n: int) -> np.ndarray:
    """`n` whole numbers drawn uniformly from the closed range [lo, hi]."""
    lo, hi = lo_hi
    return rng.integers(lo, hi + 1, n)


def seg_index(counts: np.ndarray) -> np.ndarray:
    """Each member's place in its segment, for segments of `counts` members
    laid out one after the other."""
    counts = np.asarray(counts, np.int64)
    starts = np.cumsum(counts) - counts
    return np.arange(counts.sum()) - np.repeat(starts, counts)


def distinct(rng: np.random.Generator, n, k, kmax: int) -> np.ndarray:
    """(rows, kmax) int64: row r holds k[r] distinct values drawn uniformly
    from [0, n[r]), then -1. The j-th value is drawn from the n - j values
    left and stepped past the row's earlier values in increasing order, as
    `rng.choice(n, k, replace=False)` draws one row."""
    n = np.asarray(n, np.int64)
    k = np.broadcast_to(np.asarray(k, np.int64), n.shape)
    if (k > n).any() or (k > kmax).any():
        raise ValueError("cannot draw more distinct values than there are")
    rows = len(n)
    out = np.empty((rows, kmax), np.int64)
    for j in range(kmax):
        x = rng.integers(0, np.maximum(n - j, 1), rows)
        for prev in np.sort(out[:, :j], axis=1).T:
            x += x >= prev
        out[:, j] = x
    out[np.arange(kmax)[None, :] >= k[:, None]] = -1
    return out


def pick(rng: np.random.Generator, counts: np.ndarray,
         k: np.ndarray) -> np.ndarray:
    """k[s] members of each segment s, drawn uniformly without replacement,
    for segments of `counts` members laid out one after the other: their
    indices, segment by segment, each segment's in a random order."""
    seg = np.repeat(np.arange(len(counts)), counts)
    order = np.lexsort((rng.random(len(seg)), seg))
    return order[seg_index(counts) < np.asarray(k)[seg]]


@dataclasses.dataclass
class Graph:
    """A generated RDF graph: distinct (N, 3) int32 id triples and the term
    of each id (`terms[i]` is the term whose id is i)."""
    triples: np.ndarray
    terms: list
    _ids: dict | None = dataclasses.field(default=None, repr=False)

    @property
    def n_terms(self) -> int:
        return len(self.terms)

    def term_id(self, term: str) -> int | None:
        """The id of a term, or None where the graph has no such term."""
        if self._ids is None:
            self._ids = {t: i for i, t in enumerate(self.terms)}
        return self._ids.get(term)


def triples_of(*groups) -> np.ndarray:
    """One (N, 3) int32 array from (s, p, o) groups of id arrays or ints."""
    cols = []
    for s, p, o in groups:
        n = max(np.size(s), np.size(p), np.size(o))
        cols.append(np.stack([np.broadcast_to(np.asarray(x, np.int64), (n,))
                              for x in (s, p, o)], axis=1))
    return np.concatenate(cols).astype(np.int32)
