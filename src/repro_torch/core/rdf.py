"""RDF terms, triple patterns and composite-key packing.

Terms are dictionary-encoded to int32 ids (< 2^21). A triple (s, p, o) packs
into one int64 composite key per index order — the sorted composite key IS
the index (HBase row key + column qualifier in one word), so a GET/SCAN is a
binary-search range over one int64 array and the payload is recovered by
unpacking.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Union

import numpy as np
import torch

BITS = 21
MAX_ID = (1 << BITS) - 1
INF_KEY = int(np.iinfo(np.int64).max)

Term = Union[str, int]  # "?x" variable, otherwise constant id (int)


def is_var(t: Term) -> bool:
    return isinstance(t, str)


def _as_i64(x, like_torch: bool, device=None):
    if like_torch:
        return torch.as_tensor(x, dtype=torch.int64, device=device)
    return np.asarray(x, np.int64)


def pack3(a, b, c):
    """Composite key of int64 tensors (when any argument is a tensor) or of
    numpy arrays."""
    tensors = [x for x in (a, b, c) if isinstance(x, torch.Tensor)]
    dev = tensors[0].device if tensors else None
    a, b, c = (_as_i64(x, bool(tensors), dev) for x in (a, b, c))
    return (a << (2 * BITS)) | (b << BITS) | c


def unpack3(key):
    """(pos0, pos1, pos2) int64 fields of composite keys (tensor or numpy)."""
    key = _as_i64(key, isinstance(key, torch.Tensor),
                  key.device if isinstance(key, torch.Tensor) else None)
    return ((key >> (2 * BITS)) & MAX_ID, (key >> BITS) & MAX_ID,
            key & MAX_ID)


@dataclasses.dataclass(frozen=True)
class Pattern:
    """SPARQL triple pattern; strings (conventionally '?x') are variables."""
    s: Term
    p: Term
    o: Term

    @property
    def terms(self) -> tuple[Term, Term, Term]:
        return (self.s, self.p, self.o)

    @property
    def variables(self) -> tuple[str, ...]:
        seen: list[str] = []
        for t in self.terms:
            if is_var(t) and t not in seen:
                seen.append(t)
        return tuple(seen)

    def n_vars(self) -> int:
        return len(self.variables)

    def selectivity_rank(self) -> tuple:
        """Variable-counting heuristic (paper §4.2): fewer variables first;
        among equals, bound subject > bound object > bound predicate."""
        bound_s = 0 if is_var(self.s) else 1
        bound_p = 0 if is_var(self.p) else 1
        bound_o = 0 if is_var(self.o) else 1
        return (-(bound_s + bound_p + bound_o),
                -(4 * bound_s + 2 * bound_o + bound_p))


class Dictionary:
    """Bidirectional term <-> id mapping (the dictionary-encoding frontend)."""

    def __init__(self):
        self._fwd: dict[str, int] = {}
        self._bwd: list[str] = []

    def id(self, term: str) -> int:
        if term not in self._fwd:
            i = len(self._bwd)
            # id MAX_ID is reserved: the triple (MAX_ID, MAX_ID, MAX_ID)
            # would pack to INF_KEY, the store's padding sentinel
            if i >= MAX_ID:
                raise ValueError("term dictionary overflow (>= 2^21 - 1 terms)")
            self._fwd[term] = i
            self._bwd.append(term)
        return self._fwd[term]

    def term(self, i: int) -> str:
        return self._bwd[i]

    def lookup(self, term: str) -> int | None:
        """Read-only id lookup (None when absent): query parsing must not
        mint ids, so an unknown constant is a parse-time error."""
        return self._fwd.get(term)

    def __len__(self) -> int:
        return len(self._bwd)

    def terms(self) -> list[str]:
        """Snapshot of the id -> term table (index i holds the term whose
        id is i)."""
        return list(self._bwd)

    def replay_term(self, idx: int, term: str) -> None:
        """Idempotently apply a logged dictionary append: assign `term` id
        `idx`. Replaying the same record twice is a no-op; a conflicting
        assignment or a gap is an error (ids are dense by construction)."""
        if idx < len(self._bwd):
            if self._bwd[idx] != term:
                raise ValueError(
                    f"dictionary replay conflict: id {idx} is "
                    f"{self._bwd[idx]!r}, log says {term!r}")
            return
        if idx != len(self._bwd):
            raise ValueError(
                f"dictionary replay gap: next id is {len(self._bwd)}, "
                f"log assigns {idx}")
        if idx >= MAX_ID:
            raise ValueError("term dictionary overflow (>= 2^21 - 1 terms)")
        self._fwd[term] = idx
        self._bwd.append(term)

    def encode_triples(self, triples: Iterable[tuple[str, str, str]]) -> np.ndarray:
        out = np.array([[self.id(s), self.id(p), self.id(o)]
                        for s, p, o in triples], np.int32)
        return out.reshape(-1, 3)

    def pattern(self, s: str, p: str, o: str) -> Pattern:
        """Strings starting with '?' stay variables, others are encoded."""
        conv = lambda t: t if t.startswith("?") else self.id(t)
        return Pattern(conv(s), conv(p), conv(o))


def pattern_from(p) -> Pattern:
    """This package's ``Pattern`` from any object with ``s``/``p``/``o``
    fields (e.g. another package's pattern), so plans compiled by either
    package compare field by field."""
    conv = lambda t: t if is_var(t) else int(t)
    return Pattern(conv(p.s), conv(p.p), conv(p.o))
