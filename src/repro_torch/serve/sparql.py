"""SPARQL BGP front-end: query text -> ``Pattern`` tuples (DESIGN.md §5).

Covers the fragment the paper evaluates — SELECT over a basic graph
pattern — with PREFIX declarations, IRIs, prefixed names, plain literals
and the ``a`` shorthand for rdf:type. Everything outside that fragment
(FILTER, OPTIONAL, UNION, ...) is rejected with a clean ``ValueError``
naming the offending construct, as is any constant term that is not in
the store's ``Dictionary``: query parsing never mints dictionary ids
(``Dictionary.lookup``), so an unknown term fails fast at the front door
instead of silently matching nothing.
"""
from __future__ import annotations

import dataclasses
import re

from repro_torch.core.rdf import Dictionary, Pattern
from repro_torch.obs.trace import Tracer, optional_span

# SPARQL keywords outside the BGP fragment -> named rejection
_NON_BGP = frozenset({
    "FILTER", "OPTIONAL", "UNION", "GRAPH", "MINUS", "BIND", "VALUES",
    "ORDER", "GROUP", "HAVING", "LIMIT", "OFFSET", "DISTINCT", "REDUCED",
    "ASK", "CONSTRUCT", "DESCRIBE", "INSERT", "DELETE", "SERVICE",
})

_TOKEN = re.compile(r"""
    (?P<ws>\s+|\#[^\n]*)                    # whitespace / comment
  | (?P<var>\?[A-Za-z_]\w*)
  | (?P<iri><[^<>\s]*>)
  | (?P<lit>"[^"\n]*")
  | (?P<pname>[A-Za-z_][\w\-]*?:[\w\-]+(?:\.[\w\-]+)*|:[\w\-]+(?:\.[\w\-]+)*)
  | (?P<pfxdecl>[A-Za-z_][\w\-]*:|:)      # 'pfx:' in a PREFIX declaration
  | (?P<word>[A-Za-z_]\w*)
  | (?P<punct>[{}.*;()])
""", re.X)


@dataclasses.dataclass(frozen=True)
class ParsedQuery:
    patterns: tuple[Pattern, ...]
    select: tuple[str, ...]       # projected variables ('?x', ...)
    text: str

    @property
    def variables(self) -> tuple[str, ...]:
        seen: list[str] = []
        for p in self.patterns:
            for v in p.variables:
                if v not in seen:
                    seen.append(v)
        return tuple(seen)


def _tokenize(text: str) -> list[tuple[str, str]]:
    toks: list[tuple[str, str]] = []
    pos = 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if m is None:
            raise ValueError(f"SPARQL: cannot tokenize at {text[pos:pos+20]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind != "ws":
            toks.append((kind, m.group()))
    return toks


class _Cursor:
    def __init__(self, toks):
        self.toks, self.i = toks, 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else (None, "")

    def next(self, expect_kind=None, expect_val=None, what=""):
        kind, val = self.peek()
        if kind is None:
            raise ValueError(f"SPARQL: unexpected end of query, expected {what}")
        if expect_kind is not None and kind != expect_kind:
            raise ValueError(f"SPARQL: expected {what or expect_kind}, "
                             f"got {val!r}")
        if expect_val is not None and val.upper() != expect_val:
            raise ValueError(f"SPARQL: expected {expect_val}, got {val!r}")
        self.i += 1
        return kind, val


def _check_non_bgp(val: str):
    if val.upper() in _NON_BGP:
        raise ValueError(f"SPARQL: {val.upper()} is not supported "
                         "(BGP-only fragment)")


_SCRUB = re.compile(r'<[^<>\s]*>|"[^"\n]*"|\?\w+|[A-Za-z_][\w\-]*:[\w\-.]*')
_KEYWORDS = re.compile(r"\b(" + "|".join(sorted(_NON_BGP)) + r")\b", re.I)


def _reject_non_bgp(text: str):
    """Name the offending construct BEFORE tokenizing: FILTER bodies etc.
    contain characters the BGP tokenizer rejects, and 'cannot tokenize
    at >' is a much worse error than 'FILTER is not supported'. IRIs,
    literals, variables and prefixed names are scrubbed first so a term
    that merely contains a keyword doesn't false-positive."""
    m = _KEYWORDS.search(_SCRUB.sub(" ", text))
    if m:
        _check_non_bgp(m.group())


def _resolve_const(term_str: str, d: Dictionary, what: str) -> int:
    tid = d.lookup(term_str)
    if tid is None:
        raise ValueError(f"SPARQL: {what} {term_str!r} is not a term of "
                         "this dataset (undeclared term)")
    return tid


def parse_bgp(text: str, d: Dictionary,
              tracer: Tracer | None = None) -> ParsedQuery:
    """Parse ``[PREFIX ...]* SELECT (?v... | *) WHERE { triples }`` into
    Patterns whose constants are resolved through ``d`` (read-only); with
    a `tracer`, inside a ``sparql.parse`` span."""
    with optional_span(tracer, "sparql.parse"):
        return _parse_bgp(text, d)


def _parse_bgp(text: str, d: Dictionary) -> ParsedQuery:
    _reject_non_bgp(text)
    cur = _Cursor(_tokenize(text))
    prefixes: dict[str, str] = {}

    # --- prologue: PREFIX declarations -------------------------------------
    while cur.peek()[0] == "word" and cur.peek()[1].upper() == "PREFIX":
        cur.next()
        kind, val = cur.next(what="prefix name ('pfx:')")
        if kind != "pfxdecl":
            raise ValueError(f"SPARQL: malformed PREFIX name {val!r}")
        name = val[:-1]
        k2, iri = cur.next(what="prefix IRI ('<...>')")
        if k2 != "iri":
            raise ValueError(f"SPARQL: PREFIX {name}: needs an <IRI>, "
                             f"got {iri!r}")
        prefixes[name] = iri[1:-1]

    # --- SELECT clause -----------------------------------------------------
    kind, val = cur.next(what="SELECT")
    if kind != "word" or val.upper() != "SELECT":
        _check_non_bgp(val)
        raise ValueError(f"SPARQL: expected SELECT, got {val!r}")
    select: list[str] = []
    star = False
    while True:
        kind, val = cur.peek()
        if kind == "var":
            select.append(val)
            cur.next()
        elif kind == "punct" and val == "*":
            star = True
            cur.next()
        else:
            break
    if not select and not star:
        raise ValueError("SPARQL: SELECT needs variables or *")

    kind, val = cur.next(what="WHERE")
    if kind != "word" or val.upper() != "WHERE":
        _check_non_bgp(val)
        raise ValueError(f"SPARQL: expected WHERE, got {val!r}")
    cur.next("punct", "{", what="'{'")

    # --- the BGP -----------------------------------------------------------
    def term(position: str):
        kind, val = cur.next(what=f"triple {position}")
        if kind == "var":
            return val
        if kind == "iri":
            return _resolve_const(val[1:-1], d, "IRI")
        if kind == "lit":
            return _resolve_const(val[1:-1], d, "literal")
        if kind == "pname":
            name, local = val.split(":", 1)
            if name not in prefixes:
                raise ValueError(f"SPARQL: unknown prefix {name!r}:"
                                 f" in {val!r}")
            return _resolve_const(prefixes[name] + local, d, "prefixed name")
        if kind == "word":
            if val == "a" and position == "predicate":
                return _resolve_const("rdf:type", d, "rdf:type ('a')")
            _check_non_bgp(val)
            raise ValueError(f"SPARQL: bare word {val!r} is not a valid "
                             f"triple {position}")
        raise ValueError(f"SPARQL: {val!r} is not a valid triple {position}")

    patterns: list[Pattern] = []
    while True:
        kind, val = cur.peek()
        if kind == "punct" and val == "}":
            cur.next()
            break
        if kind is None:
            raise ValueError("SPARQL: unterminated BGP (missing '}')")
        if kind == "word":
            _check_non_bgp(val)
        patterns.append(Pattern(term("subject"), term("predicate"),
                                term("object")))
        kind, val = cur.peek()
        if kind == "punct" and val in ".;":
            if val == ";":
                raise ValueError("SPARQL: predicate-object lists (';') are "
                                 "not supported; repeat the subject")
            cur.next()
    if not patterns:
        raise ValueError("SPARQL: empty basic graph pattern")
    if cur.peek()[0] is not None:
        _check_non_bgp(cur.peek()[1])
        raise ValueError(f"SPARQL: trailing input {cur.peek()[1]!r} after "
                         "the BGP (BGP-only fragment)")

    in_bgp: list[str] = []
    for p in patterns:
        for v in p.variables:
            if v not in in_bgp:
                in_bgp.append(v)
    if star:
        select = in_bgp
    for v in select:
        if v not in in_bgp:
            raise ValueError(f"SPARQL: selected variable {v} does not occur "
                             "in the BGP")
    return ParsedQuery(tuple(patterns), tuple(select), text)
