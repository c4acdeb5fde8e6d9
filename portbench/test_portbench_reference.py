"""CPU tests of the plain reference (`portbench/reference/bgp.py`): equal to
a brute-force evaluation on a few dozen triples, equal as row sets to the
port's `execute_local` on every query of the configuration at a small
scale, and its parser equal to the port's."""
from __future__ import annotations

import ast
import itertools
import json
from pathlib import Path

import numpy as np
import pytest

from portbench import check
from portbench.gen import lubm
from portbench.reference import bgp

BENCH = Path(__file__).resolve().parent
CAPS = dict(scan_cap=1 << 15, out_cap=1 << 15, probe_cap=64, row_cap=64)
SMALL = {"lubm63": {"universities": 1}}


def _config(name: str) -> dict:
    with open(BENCH / "configs" / f"{name}.json") as f:
        return json.load(f)


def _brute(triples: np.ndarray, patterns) -> tuple:
    """Every combination of one triple a pattern that binds consistently."""
    vars_ = bgp._vars_of(patterns)
    out = []
    for combo in itertools.product(triples.tolist(), repeat=len(patterns)):
        b: dict = {}
        ok = True
        for pat, tri in zip(patterns, combo):
            for t, v in zip(pat, tri):
                if t.startswith("?"):
                    if b.setdefault(t, v) != v:
                        ok = False
                elif int(t) != v:
                    ok = False
        if ok:
            out.append([b[v] for v in vars_])
    return vars_, np.array(out, np.int64).reshape(len(out), len(vars_))


def _random_bgp(rng, n_ids: int):
    terms = ["?a", "?b", "?c"] + [str(i) for i in range(n_ids)]
    n = rng.integers(1, 4)
    return tuple(tuple(terms[rng.integers(len(terms))] for _ in range(3))
                 for _ in range(n))


@pytest.mark.parametrize("seed", range(12))
def test_reference_equals_brute_force(seed):
    rng = np.random.default_rng(seed)
    triples = np.unique(rng.integers(0, 5, (36, 3)), axis=0)
    index = bgp.Index(triples)
    for _ in range(25):
        pats = _random_bgp(rng, 6)
        got = bgp.evaluate(index, pats, lambda t: int(t))
        want = _brute(triples, pats)
        assert check.digest(*got) == check.digest(*want), pats
        assert sorted(map(tuple, got[1].tolist())) == \
            sorted(map(tuple, want[1].tolist()))


def test_reference_multiset_and_repeated_variables():
    triples = np.array([[1, 2, 1], [1, 2, 3], [3, 2, 3], [4, 5, 1]])
    index = bgp.Index(triples)
    vars_, rows = bgp.evaluate(index, (("?x", "2", "?x"),), lambda t: int(t))
    assert vars_ == ("?x",) and sorted(rows[:, 0]) == [1, 3]
    vars_, rows = bgp.evaluate(index, (("?x", "?p", "?y"), ("?z", "5", "?x")),
                               lambda t: int(t))
    assert sorted(map(tuple, rows.tolist())) == [(1, 2, 1, 4), (1, 2, 3, 4)]
    # a constant the graph lacks matches nothing
    assert len(bgp.evaluate(index, (("?x", "9", "?y"),),
                            lambda t: int(t))[1]) == 0


def _port_run(graph, texts: dict) -> dict:
    from repro_torch.core import Caps, ExecConfig, build_store, execute_local
    from repro_torch.core.rdf import Dictionary
    from repro_torch.serve import parse_bgp
    d = Dictionary()
    for i, t in enumerate(graph.terms):
        d.replay_term(i, t)
    store = build_store(graph.triples, device="cpu")
    out = {}
    for name, text in texts.items():
        bnd = execute_local(store, parse_bgp(text, d).patterns,
                            caps=Caps(**CAPS), cfg=ExecConfig(impl="torch"))
        assert int(bnd.overflow) == 0, name
        out[name] = (tuple(bnd.vars), bnd.table[bnd.valid].numpy())
    return out


@pytest.mark.parametrize("name", ["lubm63"])
def test_reference_equals_the_ports_execute_local(name):
    cfg = _config(name)
    graph = lubm.generate({**cfg, **SMALL[name]}, 2**31 + 3)
    ref = check.Reference(graph)
    port = _port_run(graph, cfg["adhoc_queries"])
    for q, text in cfg["adhoc_queries"].items():
        vars_, rows = ref.answer(text)
        assert set(vars_) == set(port[q][0]), q
        perm = [port[q][0].index(v) for v in vars_]
        assert sorted(map(tuple, rows.tolist())) == sorted(
            map(tuple, port[q][1][:, perm].tolist())), q
        assert check.digest(vars_, rows) == check.digest(*port[q])
        assert len(rows) > 0, q


@pytest.mark.parametrize("name", ["lubm63"])
def test_parser_equals_the_ports(name):
    from repro_torch.core.rdf import Dictionary
    from repro_torch.serve import parse_bgp
    cfg = _config(name)
    graph = lubm.generate({**cfg, **SMALL[name]}, 1)
    d = Dictionary()
    for i, t in enumerate(graph.terms):
        d.replay_term(i, t)
    for text in cfg["adhoc_queries"].values():
        ours = [tuple(t if t.startswith("?") else graph.term_id(t) for t in p)
                for p in bgp.parse(text)]
        theirs = [p.terms for p in parse_bgp(text, d).patterns]
        assert ours == [tuple(t) for t in theirs], text


def test_reference_imports_nothing_of_the_port_or_jax():
    tree = ast.parse((BENCH / "reference" / "bgp.py").read_text())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)}
    assert {m.split(".")[0] for m in names} <= {"__future__", "numpy"}
