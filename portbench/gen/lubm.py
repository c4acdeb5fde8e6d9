"""LUBM's university graph as its generator, UBA, profiles it, vectorised:
the ranges are the configuration's `profile` (Guo, Pan and Heflin, J. Web
Semantics 3(2), 2005; the UBA profile of the generated data).

Each university has departments; each department full, associate and
assistant professors and lecturers (one full professor heads it), research
groups, and undergraduate and graduate students in a ratio to its faculty.
Each faculty member teaches courses and graduate courses (no course twice),
has a name, an e-mail address, a telephone number, a research interest,
three degrees from universities drawn out of `universities_for_degrees`,
works for the department and writes publications by rank. Each student has
a name, an e-mail address, a telephone number, a department and courses
(a graduate student graduate courses); every graduate student an advisor,
an undergraduate degree and publications of the department's professors
that it co-authors, some of them a teaching assistant of one course (each
course one at most) or a research assistant; some undergraduates an
advisor. An advisor is one of the department's professors.

Every count (departments, people, courses, publications, courses taken,
advisees, assistants) is drawn once from the configuration's `shape_seed`,
so every run's graph has the same entities and constants; the run's
seed draws every link (which courses, advisor, publications, universities,
research interest, head). The entailments the queries rely on are
materialised: a student is a Student, a professor a Professor, both a
Person, a graduate course a Course, a research group a sub-organisation
of its university too, a head works for its department, one who works
for a department is a member of it, and a university has an alumnus for
each degree from it.

Term ids are laid out in blocks (the vocabulary, universities, departments,
research groups, courses, graduate courses, faculty, publications,
undergraduates, graduates, e-mail addresses, then the names and research
interests, literals many entities share), not in order of first use.
"""
from __future__ import annotations

import numpy as np

from portbench.gen.common import (RDF_TYPE, Graph, distinct, draw, pick,
                                  seg_index, triples_of, rng_for)

RANKS = ("FullProfessor", "AssociateProfessor", "AssistantProfessor",
         "Lecturer")
TELEPHONE = '"xxx-xxx-xxxx"'
VOCAB = (RDF_TYPE, "University", "Department", "ResearchGroup", "Course",
         "GraduateCourse", *RANKS, "Professor", "Publication",
         "UndergraduateStudent", "GraduateStudent", "Student", "Person",
         "ResearchAssistant", "name", "subOrganizationOf", "worksFor",
         "headOf", "memberOf", "emailAddress", "telephone",
         "researchInterest", "undergraduateDegreeFrom", "mastersDegreeFrom",
         "doctoralDegreeFrom", "teacherOf", "takesCourse", "advisor",
         "teachingAssistantOf", "publicationAuthor", "hasAlumnus", TELEPHONE)


def _shape(prof: dict, n_univ: int, seed: int) -> dict:
    """Every count of the graph, from the shape seed."""
    r = rng_for(seed)
    s = {"n_dept": draw(r, prof["departments"], n_univ)}
    n_dep = int(s["n_dept"].sum())
    s["n_rank"] = np.stack([draw(r, prof["faculty"][k], n_dep)
                            for k in RANKS], axis=1)
    n_fac = s["n_rank"].sum(axis=1)
    s["n_rg"] = draw(r, prof["research_groups"], n_dep)
    s["n_ug"] = n_fac * draw(r, prof["undergraduates_per_faculty"], n_dep)
    s["n_gr"] = n_fac * draw(r, prof["graduates_per_faculty"], n_dep)
    s["n_ta"] = s["n_gr"] // draw(r, prof["graduates_per_teaching_assistant"],
                                  n_dep)
    s["n_ra"] = s["n_gr"] // draw(r, prof["graduates_per_research_assistant"],
                                  n_dep)
    s["n_adv"] = s["n_ug"] // prof["undergraduates_per_advisee"]
    F = int(n_fac.sum())
    rank = np.repeat(np.tile(np.arange(len(RANKS)), n_dep),
                     s["n_rank"].ravel())
    s["n_course"] = draw(r, prof["courses_per_faculty"], F)
    s["n_gcourse"] = draw(r, prof["graduate_courses_per_faculty"], F)
    lo = np.array([prof["publications"][k][0] for k in RANKS])
    hi = np.array([prof["publications"][k][1] for k in RANKS])
    s["n_pub"] = r.integers(lo[rank], hi[rank] + 1)
    s["n_take_ug"] = draw(r, prof["courses_per_undergraduate"],
                          int(s["n_ug"].sum()))
    s["n_take_gr"] = draw(r, prof["courses_per_graduate"],
                          int(s["n_gr"].sum()))
    s["n_pub_gr"] = draw(r, prof["publications_per_graduate"],
                         int(s["n_gr"].sum()))
    return s


def _starts(counts) -> np.ndarray:
    counts = np.asarray(counts, np.int64)
    return np.cumsum(counts) - counts


def generate(params: dict, seed: int) -> Graph:
    prof = params["profile"]
    n_univ = int(params["universities"])
    s = _shape(prof, n_univ, int(params["shape_seed"]))
    rng = rng_for(seed)
    v = {t: i for i, t in enumerate(VOCAB)}
    ar, rep = np.arange, np.repeat

    # --- the entities, segment by segment --------------------------------
    n_dept = s["n_dept"]
    D = int(n_dept.sum())
    dept_univ, dept_local = rep(ar(n_univ), n_dept), seg_index(n_dept)
    n_fac = s["n_rank"].sum(axis=1)
    n_prof = s["n_rank"][:, :3].sum(axis=1)        # faculty but lecturers
    fac_dept = rep(ar(D), n_fac)
    fac_rank = rep(np.tile(ar(len(RANKS)), D), s["n_rank"].ravel())
    fac_local = seg_index(s["n_rank"].ravel())     # its place in its rank
    fac_start = _starts(n_fac)
    rg_dept = rep(ar(D), s["n_rg"])
    crs_owner, gcrs_owner = (rep(ar(len(fac_dept)), s["n_course"]),
                             rep(ar(len(fac_dept)), s["n_gcourse"]))
    n_crs = np.bincount(fac_dept[crs_owner], minlength=D)
    n_gcrs = np.bincount(fac_dept[gcrs_owner], minlength=D)
    pub_owner = rep(ar(len(fac_dept)), s["n_pub"])
    pub_start = _starts(s["n_pub"])
    # the department's professors' publications lie together, first
    n_ppub = np.add.reduceat(np.where(fac_rank < 3, s["n_pub"], 0),
                             fac_start)
    ug_dept, gr_dept = rep(ar(D), s["n_ug"]), rep(ar(D), s["n_gr"])
    sizes = dict(univ=max(n_univ, prof["universities_for_degrees"]), dept=D,
                 rg=len(rg_dept), crs=len(crs_owner), gcrs=len(gcrs_owner),
                 fac=len(fac_dept), pub=len(pub_owner), ug=len(ug_dept),
                 gr=len(gr_dept))
    sizes["mail"] = sizes["fac"] + sizes["ug"] + sizes["gr"]
    base, nxt = {}, len(VOCAB)
    for k, n in sizes.items():
        base[k], nxt = nxt, nxt + n
    ids = {k: base[k] + ar(n) for k, n in sizes.items()}
    # shared literals: the names (a class and a number) and the interests
    locals_ = dict(University=ar(n_univ), Department=dept_local,
                   Course=seg_index(n_crs), GraduateCourse=seg_index(n_gcrs),
                   UndergraduateStudent=seg_index(s["n_ug"]),
                   GraduateStudent=seg_index(s["n_gr"]),
                   Publication=seg_index(s["n_pub"]),
                   **{k: fac_local[fac_rank == i]
                      for i, k in enumerate(RANKS)})
    name_base, names = {}, []
    for cls, loc in locals_.items():
        name_base[cls] = nxt + len(names)
        names += [f'"{cls}{i}"' for i in range(int(loc.max()) + 1)]
    nxt += len(names)
    interests = [f'"Research{i}"' for i in range(prof["research_interests"])]
    interest_base = nxt

    def name_of(cls, loc):
        return name_base[cls] + loc

    fac_name = np.empty(len(fac_dept), np.int64)
    for i, k in enumerate(RANKS):
        fac_name[fac_rank == i] = name_base[k] + fac_local[fac_rank == i]

    # --- the links, from the run's seed -----------------------------------
    takes_ug = distinct(rng, n_crs[ug_dept], s["n_take_ug"],
                        prof["courses_per_undergraduate"][1])
    takes_gr = distinct(rng, n_gcrs[gr_dept], s["n_take_gr"],
                        prof["courses_per_graduate"][1])
    co_pubs = distinct(rng, n_ppub[gr_dept], s["n_pub_gr"],
                       prof["publications_per_graduate"][1])
    advised = pick(rng, s["n_ug"], s["n_adv"])
    adv_ug = fac_start[ug_dept[advised]] + rng.integers(
        0, n_prof[ug_dept[advised]])
    adv_gr = fac_start[gr_dept] + rng.integers(0, n_prof[gr_dept])
    tas = pick(rng, s["n_gr"], s["n_ta"])
    ta_of = pick(rng, n_crs, s["n_ta"])        # one course each, none twice
    ras = pick(rng, s["n_gr"], s["n_ra"])
    heads = fac_start + rng.integers(0, s["n_rank"][:, 0])
    degrees = rng.integers(0, prof["universities_for_degrees"],
                           (len(fac_dept), 3))
    degree_gr = rng.integers(0, prof["universities_for_degrees"],
                             len(gr_dept))
    interest = interest_base + rng.integers(0, len(interests), len(fac_dept))

    t, U, Dp, F, G = v[RDF_TYPE], ids["univ"], ids["dept"], ids["fac"], ids["gr"]
    crs_start, gcrs_start = _starts(n_crs), _starts(n_gcrs)
    mail_fac = base["mail"] + ar(sizes["fac"])
    mail_ug = base["mail"] + sizes["fac"] + ar(sizes["ug"])
    mail_gr = base["mail"] + sizes["fac"] + sizes["ug"] + ar(sizes["gr"])

    def links(subj, table, to):
        row, col = np.nonzero(table >= 0)
        return subj[row], to(row, table[row, col])

    ug_s, ug_c = links(ids["ug"], takes_ug,
                       lambda r, c: ids["crs"][crs_start[ug_dept[r]] + c])
    gr_s, gr_c = links(G, takes_gr,
                       lambda r, c: ids["gcrs"][gcrs_start[gr_dept[r]] + c])
    co_a, co_p = links(G, co_pubs, lambda r, c: ids["pub"][
        pub_start[fac_start[gr_dept[r]]] + c])
    alumni = np.unique(np.concatenate([
        np.stack([U[degrees[:, k]], F], axis=1) for k in range(3)]
        + [np.stack([U[degree_gr], G], axis=1)]), axis=0)
    triples = triples_of(
        (U[:n_univ], t, v["University"]),
        (U[:n_univ], v["name"], name_of("University", ar(n_univ))),
        (Dp, t, v["Department"]),
        (Dp, v["name"], name_of("Department", dept_local)),
        (Dp, v["subOrganizationOf"], U[dept_univ]),
        (ids["rg"], t, v["ResearchGroup"]),
        (ids["rg"], v["subOrganizationOf"], Dp[rg_dept]),
        (ids["rg"], v["subOrganizationOf"], U[dept_univ[rg_dept]]),
        (ids["crs"], t, v["Course"]),
        (ids["crs"], v["name"], name_of("Course", seg_index(n_crs))),
        (ids["gcrs"], t, v["GraduateCourse"]),
        (ids["gcrs"], t, v["Course"]),
        (ids["gcrs"], v["name"], name_of("GraduateCourse", seg_index(n_gcrs))),
        (F, t, np.array([v[k] for k in RANKS])[fac_rank]),
        (F[fac_rank < 3], t, v["Professor"]),
        (F, t, v["Person"]),
        (F, v["name"], fac_name),
        (F, v["emailAddress"], mail_fac),
        (F, v["telephone"], v[TELEPHONE]),
        (F, v["researchInterest"], interest),
        (F, v["worksFor"], Dp[fac_dept]),
        (F, v["memberOf"], Dp[fac_dept]),
        (F[heads], v["headOf"], Dp),
        (F, v["undergraduateDegreeFrom"], U[degrees[:, 0]]),
        (F, v["mastersDegreeFrom"], U[degrees[:, 1]]),
        (F, v["doctoralDegreeFrom"], U[degrees[:, 2]]),
        (alumni[:, 0], v["hasAlumnus"], alumni[:, 1]),
        (F[crs_owner], v["teacherOf"], ids["crs"]),
        (F[gcrs_owner], v["teacherOf"], ids["gcrs"]),
        (ids["pub"], t, v["Publication"]),
        (ids["pub"], v["name"], name_of("Publication", seg_index(s["n_pub"]))),
        (ids["pub"], v["publicationAuthor"], F[pub_owner]),
        (co_p, v["publicationAuthor"], co_a),
        (ids["ug"], t, v["UndergraduateStudent"]),
        (ids["ug"], t, v["Student"]),
        (ids["ug"], t, v["Person"]),
        (ids["ug"], v["name"],
         name_of("UndergraduateStudent", seg_index(s["n_ug"]))),
        (ids["ug"], v["emailAddress"], mail_ug),
        (ids["ug"], v["telephone"], v[TELEPHONE]),
        (ids["ug"], v["memberOf"], Dp[ug_dept]),
        (ug_s, v["takesCourse"], ug_c),
        (ids["ug"][advised], v["advisor"], F[adv_ug]),
        (G, t, v["GraduateStudent"]),
        (G, t, v["Student"]),
        (G, t, v["Person"]),
        (G, v["name"], name_of("GraduateStudent", seg_index(s["n_gr"]))),
        (G, v["emailAddress"], mail_gr),
        (G, v["telephone"], v[TELEPHONE]),
        (G, v["memberOf"], Dp[gr_dept]),
        (G, v["undergraduateDegreeFrom"], U[degree_gr]),
        (gr_s, v["takesCourse"], gr_c),
        (G, v["advisor"], F[adv_gr]),
        (G[tas], v["teachingAssistantOf"], ids["crs"][ta_of]),
        (G[ras], t, v["ResearchAssistant"]),
    )

    # --- the term of each id ---------------------------------------------
    dstr = [f"Department{d}.University{u}"
            for d, u in zip(dept_local.tolist(), dept_univ.tolist())]

    def under(prefix, loc, dept):
        return [f"{prefix}{i}.{dstr[d]}"
                for i, d in zip(loc.tolist(), dept.tolist())]

    fstr = [f"{RANKS[r]}{i}" for r, i in zip(fac_rank.tolist(),
                                             fac_local.tolist())]
    fac_terms = [f"{p}.{dstr[d]}" for p, d in zip(fstr, fac_dept.tolist())]
    ug_loc, gr_loc = seg_index(s["n_ug"]), seg_index(s["n_gr"])

    def mails(prefixes, dept):
        return [f'"{p}@{dstr[d]}.edu"' for p, d in zip(prefixes, dept.tolist())]

    terms = [*VOCAB,
             *(f"University{u}" for u in range(sizes["univ"])),
             *dstr,
             *under("ResearchGroup", seg_index(s["n_rg"]), rg_dept),
             *under("Course", seg_index(n_crs), fac_dept[crs_owner]),
             *under("GraduateCourse", seg_index(n_gcrs), fac_dept[gcrs_owner]),
             *fac_terms,
             *(f"Publication{k}.{fac_terms[f]}" for k, f in
               zip(seg_index(s["n_pub"]).tolist(), pub_owner.tolist())),
             *under("UndergraduateStudent", ug_loc, ug_dept),
             *under("GraduateStudent", gr_loc, gr_dept),
             *mails(fstr, fac_dept),
             *mails([f"UndergraduateStudent{i}" for i in ug_loc.tolist()],
                    ug_dept),
             *mails([f"GraduateStudent{i}" for i in gr_loc.tolist()], gr_dept),
             *names, *interests]
    return Graph(triples, terms)
