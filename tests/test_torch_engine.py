"""The port's whole query path against the JAX package, query by query.

For every LUBM query (lubm_like(1)) and every SP²B query: the SPARQL text
parses to equal patterns, the compiled ``PhysicalPlan`` is equal field by
field, ``execute_local`` gives bit-identical Bindings to the reference's
``impl="jnp"`` cascade (and the row set equals the oracle's), the
instrumented ``stats`` dicts are equal apart from their timing keys, and
the traffic models agree."""
import dataclasses

import numpy as np
import pytest

import repro.core as jcore
from repro.core import bgp as jbgp
from repro.data import lubm_like as j_lubm, sp2b_like as j_sp2b
from repro.data.rdf_gen import LUBM_SPARQL as J_LUBM_SPARQL
from repro.serve import parse_bgp as j_parse

from repro_torch.core import bgp as tbgp
from repro_torch.core import (Caps, ExecConfig, build_store, compile_plan,
                              execute_local, execute_oracle, explain,
                              pattern_from, rows_set)
from repro_torch.data import lubm_like, sp2b_like
from repro_torch.data.rdf_gen import LUBM_SPARQL, SP2B_SPARQL
from repro_torch.serve import parse_bgp

CAPS = dict(scan_cap=1 << 12, out_cap=1 << 12, probe_cap=128, row_cap=64)
TIMING = {"t0", "t1", "wall_s"}
CASES = [("lubm", q) for q in LUBM_SPARQL] + [("sp2b", q) for q in SP2B_SPARQL]


@pytest.fixture(scope="module")
def data():
    out = {}
    for name, tgen, jgen, arg, texts in (
            ("lubm", lubm_like, j_lubm, 1, LUBM_SPARQL),
            ("sp2b", sp2b_like, j_sp2b, 200, SP2B_SPARQL)):
        tr, d, _ = tgen(arg)
        trj, dj, _ = jgen(arg)
        out[name] = dict(triples=tr, d=d, dj=dj, texts=texts,
                         ts=build_store(tr, device="cpu"),
                         js=jcore.build_store(trj))
    return out


def _plan_fields(plan):
    """A PhysicalPlan of either package as plain comparable values."""
    return (tuple((st.kind, tuple(pattern_from(p) for p in st.patterns),
                   dataclasses.asdict(st.caps), st.est_in, st.est_out,
                   st.est_fanout_max) for st in plan.steps),
            plan.var_order, plan.cost, plan.ordering, plan.route_shards)


def _same_bindings(tb, jb):
    assert tb.vars == tuple(jb.vars)
    for name in ("table", "valid", "overflow", "step_overflow"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)),
                                      err_msg=name)


def test_lubm_text_forms_match_reference():
    assert LUBM_SPARQL == J_LUBM_SPARQL


@pytest.mark.parametrize("ds,query", CASES)
@pytest.mark.parametrize("mode", ["mapsin", "reduce"])
def test_query_matches_reference(data, ds, query, mode):
    x = data[ds]
    text = x["texts"][query]
    pq, jq = parse_bgp(text, x["d"]), j_parse(text, x["dj"])
    assert pq.patterns == tuple(pattern_from(p) for p in jq.patterns)
    assert pq.select == jq.select
    plan = compile_plan(x["ts"], list(pq.patterns), Caps(**CAPS), mode=mode)
    jplan = jcore.compile_plan(x["js"], list(jq.patterns),
                               jcore.Caps(**CAPS), mode=mode)
    assert _plan_fields(plan) == _plan_fields(jplan)
    assert explain(plan) == jcore.explain(jplan)

    bnd = execute_local(x["ts"], plan, mode)
    jbnd = jcore.execute_local(x["js"], jplan, mode,
                               jcore.ExecConfig(impl="jnp"))
    _same_bindings(bnd, jbnd)
    if mode == "mapsin":
        assert int(bnd.overflow) == 0
        want, _ = execute_oracle(x["triples"], plan.patterns, bnd.vars)
        assert rows_set(bnd.table, bnd.valid, len(bnd.vars)) == want
    for traffic_mode in ("mapsin", "mapsin_routed", "reduce"):
        assert (tbgp.query_traffic(plan, traffic_mode, num_shards=10)
                == jbgp.query_traffic(jplan, traffic_mode, num_shards=10))


@pytest.mark.parametrize("ds,query", CASES)
def test_instrumented_stats_match_reference(data, ds, query):
    x = data[ds]
    pats = list(parse_bgp(x["texts"][query], x["d"]).patterns)
    jpats = list(j_parse(x["texts"][query], x["dj"]).patterns)
    stats, jstats = [], []
    bnd = execute_local(x["ts"], pats, caps=Caps(**CAPS),
                        cfg=ExecConfig(impl="torch"), stats=stats)
    jbnd = jcore.execute_local(x["js"], jpats, caps=jcore.Caps(**CAPS),
                               stats=jstats)
    _same_bindings(bnd, jbnd)
    strip = lambda ss: [{k: v for k, v in s.items() if k not in TIMING}
                        for s in ss]
    assert strip(stats) == strip(jstats)
    for mode in ("mapsin", "mapsin_routed", "reduce"):
        assert (tbgp.query_traffic_actual(stats, mode, 10, x["ts"].n_triples)
                == jbgp.query_traffic_actual(jstats, mode, 10,
                                             x["js"].n_triples))


def test_cascade_cached_per_plan_and_impl(data):
    x = data["lubm"]
    pats = list(parse_bgp(x["texts"]["Q8"], x["d"]).patterns)
    plan = compile_plan(x["ts"], pats, Caps(**CAPS))
    a = execute_local(x["ts"], plan, cfg=ExecConfig(impl="kernel"))
    b = execute_local(x["ts"], plan, cfg=ExecConfig(impl="torch"))
    for name in ("table", "valid", "overflow", "step_overflow"):
        assert np.array_equal(getattr(a, name).numpy(), getattr(b, name).numpy())
    keys = [k for k in x["ts"].plan_cache if k[0] == "cascade" and k[1] == plan]
    assert len(keys) == 2
    with pytest.raises(ValueError):
        execute_local(x["ts"], plan, "reduce")


def test_parse_errors_match_reference(data):
    x = data["lubm"]
    for text in ("SELECT ?x WHERE { ?x <nope> ?y . }",
                 "SELECT ?x WHERE { ?x a <Student> . FILTER(?x) }",
                 "SELECT ?z WHERE { ?x a <Student> . }"):
        with pytest.raises(ValueError) as got:
            parse_bgp(text, x["d"])
        with pytest.raises(ValueError) as want:
            j_parse(text, x["dj"])
        assert str(got.value) == str(want.value)
