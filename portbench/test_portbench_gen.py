"""CPU tests of the benchmark's generator (`portbench/gen/`): UBA's profile
of LUBM's data held count by count, the same entities at every seed, every
query constant present, the term limit at the configured scale, and the
same bytes from the same seed."""
from __future__ import annotations

import json
import re
from pathlib import Path

import numpy as np
import pytest

from portbench.gen import common, lubm
from portbench.reference import bgp

CONFIGS = Path(__file__).resolve().parent / "configs"
MAX_ID = (1 << 21) - 1          # the port's reserved id: terms stay below it
SEEDS = (0, 7, 2**31 + 5, 3 * 2**40 + 1)


def _config(name: str = "lubm63", **scale) -> dict:
    with open(CONFIGS / f"{name}.json") as f:
        return {**json.load(f), **scale}


def _ids(g, pattern: str) -> np.ndarray:
    """Whether each id's term matches `pattern` (a regular expression)."""
    rx = re.compile(pattern)
    return np.array([rx.fullmatch(t) is not None for t in g.terms])


def _edges(g, pred: str) -> np.ndarray:
    return g.triples[g.triples[:, 1] == g.term_id(pred)]


def _typed(g, cls: str) -> np.ndarray:
    t = g.triples
    return t[(t[:, 1] == g.term_id("rdf:type")) & (t[:, 2] == g.term_id(cls))][:, 0]


def _dept(g, i: int) -> str:
    """The department part of an entity's term (`Department3.University0`)."""
    return re.search(r"Department\d+\.University\d+", g.terms[i]).group(0)


def _within(values, lo_hi) -> bool:
    values = np.asarray(values)
    return bool((values >= lo_hi[0]).all() and (values <= lo_hi[1]).all())


@pytest.mark.parametrize("n", [1, 3])
def test_lubm_counts_follow_the_uba_profile(n):
    cfg = _config(universities=n)
    prof = cfg["profile"]
    g = lubm.generate(cfg, 1)
    dept_of = {}
    for cls in (*lubm.RANKS, "UndergraduateStudent", "GraduateStudent",
                "ResearchGroup", "Course", "GraduateCourse"):
        mask = _ids(g, rf"{cls}\d+\.Department\d+\.University\d+")
        depts = [_dept(g, i) for i in np.flatnonzero(mask)]
        dept_of[cls] = dict(zip(*np.unique(depts, return_counts=True)))
    univ = [d.split(".")[1] for d in dept_of["FullProfessor"]]
    assert len(set(univ)) == n
    assert _within(np.unique(univ, return_counts=True)[1],
                   prof["departments"])
    depts = sorted(dept_of["FullProfessor"])
    for d in depts:
        fac = sum(dept_of[k][d] for k in lubm.RANKS)
        for k in lubm.RANKS:
            assert _within([dept_of[k][d]], prof["faculty"][k]), (d, k)
        assert _within([dept_of["ResearchGroup"][d]],
                       prof["research_groups"])
        ug, gr = dept_of["UndergraduateStudent"][d], dept_of["GraduateStudent"][d]
        assert ug % fac == 0 and _within([ug // fac],
                                         prof["undergraduates_per_faculty"])
        assert gr % fac == 0 and _within([gr // fac],
                                         prof["graduates_per_faculty"])
        assert _within([dept_of["Course"][d] / fac,
                        dept_of["GraduateCourse"][d] / fac], [1, 2])
    # publications a faculty member writes (its own, named under it), by rank
    own = np.array([g.terms[s].split(".", 1)[1] == g.terms[o]
                    for s, _, o in _edges(g, "publicationAuthor")])
    writers = _edges(g, "publicationAuthor")[own][:, 2]
    for k in lubm.RANKS:
        fac = np.flatnonzero(_ids(g, rf"{k}\d+\..*"))
        assert _within(np.bincount(writers, minlength=g.n_terms)[fac],
                       prof["publications"][k]), k
    assert len(np.unique(g.triples, axis=0)) == len(g.triples)


def test_lubm_links_follow_the_uba_profile():
    cfg = _config(universities=2)
    prof = cfg["profile"]
    g = lubm.generate(cfg, 3)
    ug, gr = _typed(g, "UndergraduateStudent"), _typed(g, "GraduateStudent")
    takes = np.bincount(_edges(g, "takesCourse")[:, 0], minlength=g.n_terms)
    assert _within(takes[ug], prof["courses_per_undergraduate"])
    assert _within(takes[gr], prof["courses_per_graduate"])
    grad_course = _ids(g, r"GraduateCourse\d+\..*")
    for s, _, o in _edges(g, "takesCourse")[::97]:
        assert _dept(g, s) == _dept(g, o)
        assert grad_course[o] == (s in set(gr.tolist()))
    # every graduate student and a fifth of undergraduates have an advisor,
    # a professor of their own department
    adv = _edges(g, "advisor")
    per = np.bincount(adv[:, 0], minlength=g.n_terms)
    assert (per[gr] == 1).all() and set(per[ug]) == {0, 1}
    assert abs(per[ug].sum() - len(ug) / 5) <= 2 * 25 * 2
    profs = set(_typed(g, "Professor").tolist())
    assert all(p in profs for p in adv[:, 2])
    assert all(_dept(g, s) == _dept(g, p) for s, _, p in adv[::31])
    # teaching assistants: one course each, no course twice
    ta = _edges(g, "teachingAssistantOf")
    assert len(np.unique(ta[:, 0])) == len(ta) == len(np.unique(ta[:, 2]))
    # co-authors: graduate students on their department's professors' papers
    co = _edges(g, "publicationAuthor")
    co = co[np.isin(co[:, 2], gr)]
    assert _within(np.bincount(co[:, 2], minlength=g.n_terms)[gr],
                   prof["publications_per_graduate"])
    assert all(_dept(g, p) == _dept(g, s) for p, _, s in co[::13])
    # the entailments the queries need
    assert set(_typed(g, "Student").tolist()) == set(ug.tolist()) | set(gr.tolist())
    assert len(_typed(g, "Person")) == len(ug) + len(gr) + sum(
        len(_typed(g, k)) for k in lubm.RANKS)
    assert len(_edges(g, "hasAlumnus")) > 0


@pytest.mark.parametrize("kmax", [2, 3, 5])
def test_distinct_draws_are_distinct_and_uniform(kmax):
    rng = common.rng_for(5)
    n = np.array([6, 9] * 100_000)
    k = np.array([kmax, kmax - 1] * 100_000)
    x = common.distinct(rng, n, k, kmax)
    assert ((x == -1) == (np.arange(kmax) >= k[:, None])).all()
    for row_n in (6, 9):
        rows = x[n == row_n]
        live = rows[rows[:, 0] >= 0]
        s = np.sort(np.where(live >= 0, live, -np.arange(1, kmax + 1)), axis=1)
        assert (s[:, 1:] != s[:, :-1]).all()
        v = live[live >= 0]
        assert v.max() < row_n
        assert np.allclose(np.bincount(v, minlength=row_n) / v.size,
                           1 / row_n, atol=0.01)


def test_pick_draws_k_distinct_members_of_each_segment():
    rng = common.rng_for(9)
    counts, k = np.array([5, 0, 7, 3]), np.array([2, 0, 7, 1])
    seg = np.repeat(np.arange(4), counts)
    hits = np.zeros(counts.sum())
    for _ in range(2000):
        got = common.pick(rng, counts, k)
        assert (np.bincount(seg[got], minlength=4) == k).all()
        assert len(np.unique(got)) == len(got)
        hits[got] += 1
    assert np.allclose(hits[:5] / 2000, 2 / 5, atol=0.05)
    assert (hits[5:12] == 2000).all()


def _constants(cfg: dict) -> list:
    out = []
    for text in cfg["adhoc_queries"].values():
        out += [t for pat in bgp.parse(text) for t in pat
                if not t.startswith("?")]
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_every_query_constant_exists(seed):
    cfg = _config(universities=2)
    g = lubm.generate(cfg, seed)
    assert all(g.term_id(c) is not None for c in _constants(cfg))


def test_configured_scale_stays_under_the_term_limit():
    cfg = _config()
    g = lubm.generate(cfg, 2**31 + 1)
    assert g.n_terms < MAX_ID
    assert g.triples.max() < MAX_ID and g.triples.min() >= 0
    assert all(g.term_id(c) is not None for c in _constants(cfg))


def test_same_seed_same_bytes_and_every_seed_the_same_entities():
    cfg = _config(universities=2)
    a, b = lubm.generate(cfg, 2**33 + 9), lubm.generate(cfg, 2**33 + 9)
    assert a.triples.tobytes() == b.triples.tobytes()
    assert a.terms == b.terms
    c = lubm.generate(cfg, 2**33 + 10)
    assert a.triples.tobytes() != c.triples.tobytes()
    assert a.terms == c.terms
    assert abs(len(a.triples) - len(c.triples)) < 1e-3 * len(a.triples)
