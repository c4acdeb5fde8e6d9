"""Synthetic RDF generators mirroring the paper's benchmarks.

`lubm_like(n_universities)` — university/department/professor/student graph
with the LUBM schema subset the paper's queries touch; selectivities mirror
LUBM's (point lookups on a named department vs. broad class scans).

`sp2b_like(scale)` — DBLP-style articles/inproceedings with author/cite
structure; less selective queries, like SP²Bench.

Both return (triples (N,3) int32, Dictionary, {query name: [Pattern, ...]})
with query sets matching the paper's evaluation tables (Appendix A/B).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.rdf import Dictionary, Pattern

RDF_TYPE = "rdf:type"


def _p(d: Dictionary, s: str, p: str, o: str, out: list):
    out.append((d.id(s), d.id(p), d.id(o)))


def lubm_like(n_universities: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    d = Dictionary()
    t: list[tuple[int, int, int]] = []
    n_dept, n_prof, n_stud, n_course = 12, 18, 120, 24
    for u in range(n_universities):
        uni = f"Univ{u}"
        _p(d, uni, RDF_TYPE, "University", t)
        for dep in range(n_dept):
            dept = f"Dept{dep}.U{u}"
            _p(d, dept, RDF_TYPE, "Department", t)
            _p(d, dept, "subOrganizationOf", uni, t)
            rg = f"ResearchGroup{dep}.U{u}"
            _p(d, rg, RDF_TYPE, "ResearchGroup", t)
            _p(d, rg, "subOrganizationOf", uni, t)
            courses = [f"Course{c}.D{dep}.U{u}" for c in range(n_course)]
            for c in courses:
                _p(d, c, RDF_TYPE, "Course", t)
            profs = []
            for pr in range(n_prof):
                kind = ("FullProfessor", "AssociateProfessor",
                        "AssistantProfessor")[pr % 3]
                prof = f"Prof{pr}.D{dep}.U{u}"
                profs.append(prof)
                _p(d, prof, RDF_TYPE, kind, t)
                _p(d, prof, RDF_TYPE, "Professor", t)
                _p(d, prof, "worksFor", dept, t)
                _p(d, prof, "name", f"name.{prof}", t)
                _p(d, prof, "emailAddress", f"email.{prof}", t)
                _p(d, prof, "telephone", f"tel.{prof}", t)
                for c in rng.choice(n_course, 2, replace=False):
                    _p(d, prof, "teacherOf", courses[c], t)
                pub = f"Publication{pr}.D{dep}.U{u}"
                _p(d, pub, RDF_TYPE, "Publication", t)
                _p(d, pub, "publicationAuthor", prof, t)
            for st in range(n_stud):
                kind = "GraduateStudent" if st % 5 == 0 else "UndergraduateStudent"
                stud = f"Student{st}.D{dep}.U{u}"
                _p(d, stud, RDF_TYPE, kind, t)
                _p(d, stud, RDF_TYPE, "Student", t)
                _p(d, stud, "memberOf", dept, t)
                _p(d, stud, "emailAddress", f"email.{stud}", t)
                for c in rng.choice(n_course, 3, replace=False):
                    _p(d, stud, "takesCourse", courses[c], t)
                if st % 4 == 0:
                    _p(d, stud, "advisor", profs[st % n_prof], t)
    triples = np.array(t, np.int32)

    q = d.pattern
    queries = {
        # Q1: selective point join — students taking a given course
        "Q1": [q("?x", RDF_TYPE, "GraduateStudent"),
               q("?x", "takesCourse", "Course0.D0.U0")],
        # Q3: publications of a given professor
        "Q3": [q("?x", RDF_TYPE, "Publication"),
               q("?x", "publicationAuthor", "Prof2.D0.U0")],
        # Q4: professor star — worksFor dept0 + name/email/tel (multiway)
        "Q4": [q("?x", RDF_TYPE, "Professor"),
               q("?x", "worksFor", "Dept0.U0"),
               q("?x", "name", "?y1"),
               q("?x", "emailAddress", "?y2"),
               q("?x", "telephone", "?y3")],
        # Q5: members of a given department
        "Q5": [q("?x", RDF_TYPE, "Student"),
               q("?x", "memberOf", "Dept0.U0")],
        # Q6: single-pattern class scan
        "Q6": [q("?x", RDF_TYPE, "Student")],
        # Q7: students taking a course of a given professor
        "Q7": [q("?y", RDF_TYPE, "Course"),
               q("Prof1.D0.U0", "teacherOf", "?y"),
               q("?x", "takesCourse", "?y"),
               q("?x", RDF_TYPE, "Student")],
        # Q8: students in departments of a given university, with email
        "Q8": [q("?y", RDF_TYPE, "Department"),
               q("?y", "subOrganizationOf", "Univ0"),
               q("?x", "memberOf", "?y"),
               q("?x", RDF_TYPE, "Student"),
               q("?x", "emailAddress", "?z")],
        # Q11: research groups of a given university
        "Q11": [q("?x", RDF_TYPE, "ResearchGroup"),
                q("?x", "subOrganizationOf", "Univ0")],
        # Q13: alumni-style — advisor edges of professors of Univ0's dept0
        "Q13": [q("?p", "worksFor", "Dept0.U0"),
                q("?x", "advisor", "?p")],
        # Q14: single-pattern broad scan
        "Q14": [q("?x", RDF_TYPE, "UndergraduateStudent")],
    }
    return triples, d, queries


# SPARQL text forms of the LUBM query set (serve/sparql.py round-trips
# these to exactly the hand-built Pattern lists above; constants are
# scale-independent — Dept0/Univ0/... exist at every n_universities >= 1)
_LUBM_HDR = "PREFIX rdf: <rdf:>\n"
LUBM_SPARQL = {
    "Q1": _LUBM_HDR + """SELECT ?x WHERE {
  ?x rdf:type <GraduateStudent> .
  ?x <takesCourse> <Course0.D0.U0> .
}""",
    "Q3": _LUBM_HDR + """SELECT ?x WHERE {
  ?x rdf:type <Publication> .
  ?x <publicationAuthor> <Prof2.D0.U0> .
}""",
    "Q4": _LUBM_HDR + """SELECT ?x ?y1 ?y2 ?y3 WHERE {
  ?x rdf:type <Professor> .
  ?x <worksFor> <Dept0.U0> .
  ?x <name> ?y1 .
  ?x <emailAddress> ?y2 .
  ?x <telephone> ?y3 .
}""",
    "Q5": _LUBM_HDR + """SELECT ?x WHERE {
  ?x rdf:type <Student> .
  ?x <memberOf> <Dept0.U0> .
}""",
    "Q6": _LUBM_HDR + "SELECT ?x WHERE { ?x rdf:type <Student> . }",
    "Q7": _LUBM_HDR + """SELECT ?x ?y WHERE {
  ?y rdf:type <Course> .
  <Prof1.D0.U0> <teacherOf> ?y .
  ?x <takesCourse> ?y .
  ?x rdf:type <Student> .
}""",
    "Q8": _LUBM_HDR + """SELECT ?x ?y ?z WHERE {
  ?y rdf:type <Department> .
  ?y <subOrganizationOf> <Univ0> .
  ?x <memberOf> ?y .
  ?x rdf:type <Student> .
  ?x <emailAddress> ?z .
}""",
    "Q11": _LUBM_HDR + """SELECT ?x WHERE {
  ?x rdf:type <ResearchGroup> .
  ?x <subOrganizationOf> <Univ0> .
}""",
    "Q13": _LUBM_HDR + """SELECT ?p ?x WHERE {
  ?p <worksFor> <Dept0.U0> .
  ?x <advisor> ?p .
}""",
    "Q14": _LUBM_HDR + "SELECT * WHERE { ?x a <UndergraduateStudent> . }",
}


def sp2b_like(n_articles: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    d = Dictionary()
    t: list[tuple[int, int, int]] = []
    n_persons = max(n_articles // 3, 8)
    persons = [f"Person{i}" for i in range(n_persons)]
    n_proc = max(n_articles // 40, 2)
    for i in range(n_articles):
        kind = "Article" if i % 2 == 0 else "Inproceedings"
        a = f"Doc{i}"
        _p(d, a, RDF_TYPE, kind, t)
        _p(d, a, "dc:title", f"title{i}", t)
        _p(d, a, "dcterms:issued", f"year{1940 + (i % 70)}", t)
        for au in rng.choice(n_persons, 1 + (i % 3), replace=False):
            _p(d, a, "dc:creator", persons[au], t)
        if kind == "Inproceedings":
            _p(d, a, "bench:booktitle", f"book{i % 50}", t)
            _p(d, a, "dcterms:partOf", f"Proc{i % n_proc}", t)
            _p(d, a, "rdfs:seeAlso", f"see{i}", t)
            _p(d, a, "swrc:pages", f"pages{i % 300}", t)
            _p(d, a, "foaf:homepage", f"http://doc{i}", t)
        else:
            _p(d, a, "swrc:journal", f"Journal{i % 40}", t)
            if i % 4 == 0:
                _p(d, a, "swrc:pages", f"pages{i % 300}", t)
        for c in rng.choice(n_articles, min(2, i % 3), replace=False):
            _p(d, a, "dcterms:references", f"Doc{c}", t)
    triples = np.array(t, np.int32)

    q = d.pattern
    queries = {
        # Q1: year of a specific title (3 patterns, one join var — multiway)
        "Q1": [q("?a", RDF_TYPE, "Article"),
               q("?a", "dc:title", "title0"),
               q("?a", "dcterms:issued", "?yr")],
        # Q2: the big inproceedings star (9 patterns in the paper; 8 here —
        # OPTIONAL dropped exactly like the paper's modified version)
        "Q2": [q("?p", RDF_TYPE, "Inproceedings"),
               q("?p", "dc:creator", "?author"),
               q("?p", "bench:booktitle", "?bt"),
               q("?p", "dc:title", "?title"),
               q("?p", "dcterms:partOf", "?proc"),
               q("?p", "rdfs:seeAlso", "?ee"),
               q("?p", "swrc:pages", "?pages"),
               q("?p", "foaf:homepage", "?url")],
        # Q3a: articles with a pages property (unselective join)
        "Q3a": [q("?a", RDF_TYPE, "Article"),
                q("?a", "swrc:pages", "?v")],
        # Q10: subject-of — all edges pointing at a person (?s ?p const)
        "Q10": [q("?s", "?pr", "Person0")],
    }
    return triples, d, queries


# SPARQL text forms of the SP²Bench query set (same round-trip contract
# as LUBM_SPARQL; the generator names its prefixes literally — e.g. the
# term "dc:title" — so each prefix maps to its own name + ':')
_SP2B_HDR = """PREFIX rdf: <rdf:>
PREFIX dc: <dc:>
PREFIX dcterms: <dcterms:>
PREFIX bench: <bench:>
PREFIX rdfs: <rdfs:>
PREFIX swrc: <swrc:>
PREFIX foaf: <foaf:>
"""
SP2B_SPARQL = {
    "Q1": _SP2B_HDR + """SELECT ?yr WHERE {
  ?a rdf:type <Article> .
  ?a dc:title "title0" .
  ?a dcterms:issued ?yr .
}""",
    "Q2": _SP2B_HDR + """SELECT * WHERE {
  ?p rdf:type <Inproceedings> .
  ?p dc:creator ?author .
  ?p bench:booktitle ?bt .
  ?p dc:title ?title .
  ?p dcterms:partOf ?proc .
  ?p rdfs:seeAlso ?ee .
  ?p swrc:pages ?pages .
  ?p foaf:homepage ?url .
}""",
    "Q3a": _SP2B_HDR + """SELECT ?a WHERE {
  ?a rdf:type <Article> .
  ?a swrc:pages ?v .
}""",
    "Q10": "SELECT ?s ?pr WHERE { ?s ?pr <Person0> . }",
}
