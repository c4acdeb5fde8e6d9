"""End-to-end driver for the PyTorch port (the paper's kind of workload =
query serving): generate a LUBM-like dataset, pose the paper's benchmark
queries AS SPARQL TEXT through the serve front-end (serve/sparql.py),
execute with both engines, verify against the oracle, print the
comparison table.

    PYTHONPATH=src python examples/torch_sparql_lubm.py [n_universities]
        [--device cuda|cpu]
    PYTHONPATH=src python examples/torch_sparql_lubm.py 1 --sparql \\
        'SELECT ?x WHERE { ?x a <Professor> . ?x <worksFor> <Dept0.U0> . }'
    PYTHONPATH=src python examples/torch_sparql_lubm.py 1 --explain [--sparql Q]

With --sparql the given query (text or a path to a .rq/.sparql file) is
parsed, executed, and its rows printed with dictionary-decoded terms.
With --explain NOTHING executes: the compiled ``PhysicalPlan`` (cost-based
join order, per-step operator, caps, cost estimates) is printed for the
ad-hoc --sparql query, or for every built-in query when --sparql is
absent. Without either flag, every built-in query runs from its text form
in data/rdf_gen.py:LUBM_SPARQL (each parse is also asserted equal to the
hand-built Pattern list). The store lives on the CUDA card unless
``--device cpu`` is given; the kernels run there, their plain versions on
the CPU.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402

from repro_torch.core import (Caps, build_store, compile_plan,  # noqa: E402
                              execute_local, execute_oracle, explain,
                              query_traffic, rows_set)
from repro_torch.data import lubm_like  # noqa: E402
from repro_torch.data.rdf_gen import LUBM_SPARQL  # noqa: E402
from repro_torch.serve import parse_bgp  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("n_universities", type=int, nargs="?", default=1)
ap.add_argument("--sparql", default=None, help="query text or a file")
ap.add_argument("--explain", action="store_true")
ap.add_argument("--device", default="cuda")
args = ap.parse_args()
sparql_text = args.sparql
if sparql_text is not None and os.path.exists(sparql_text):
    with open(sparql_text) as f:
        sparql_text = f.read()
n_univ = args.n_universities

triples, d, hand_built = lubm_like(n_univ)
print(f"LUBM-like x{n_univ}: {len(triples):,} triples, {len(d):,} terms")
store = build_store(triples, num_shards=1, device=args.device)
# probe_cap must hold Q8's memberOf fan-out (120 students per department);
# at 16 the probe truncates (surfaced as overflow) and Q8 reported inexact
caps = Caps(scan_cap=1 << 16, out_cap=1 << 16, probe_cap=128, row_cap=64)

if args.explain:
    # print the physical plan(s), execute nothing
    if sparql_text is not None:
        queries = {"ad-hoc": list(parse_bgp(sparql_text, d).patterns)}
    else:
        queries = {name: list(parse_bgp(text, d).patterns)
                   for name, text in LUBM_SPARQL.items()}
    for name, pats in queries.items():
        plan = compile_plan(store, pats, caps)
        print(f"\n== {name} ==")
        print(explain(plan, decode=d.term))
    sys.exit(0)

if sparql_text is not None:
    pq = parse_bgp(sparql_text, d)           # ValueError on bad input
    bnd = execute_local(store, list(pq.patterns), "mapsin", caps=caps)
    got = rows_set(bnd.table, bnd.valid, len(bnd.vars))
    sel = [bnd.vars.index(v) for v in pq.select]
    print("  ".join(pq.select))
    for row in sorted(got):
        print("  ".join(d.term(row[i]) for i in sel))
    print(f"-- {len(got)} rows, overflow={int(bnd.overflow)}")
    sys.exit(0)


def sync() -> None:
    if store.device.type == "cuda":
        torch.cuda.synchronize(store.device)


print(f"{'query':6s} {'rows':>6s} {'mapsin':>9s} {'reduce':>9s} "
      f"{'speedup':>8s} {'net-ratio':>9s}  exact")
for qname, text in LUBM_SPARQL.items():
    pats = list(parse_bgp(text, d).patterns)     # the front-end is the path
    assert pats == hand_built[qname], f"{qname}: text form drifted"
    times = {}
    for mode in ("mapsin", "reduce"):
        fn = lambda m=mode: execute_local(store, pats, m, caps=caps)
        fn()  # warm-up
        sync()
        t0 = time.perf_counter()
        bnd = fn()
        sync()
        times[mode] = time.perf_counter() - t0
    got = rows_set(bnd.table, bnd.valid, len(bnd.vars))
    want, ovars = execute_oracle(triples, pats)
    if tuple(bnd.vars) != ovars:
        perm = [bnd.vars.index(v) for v in ovars]
        got = set(tuple(r[i] for i in perm) for r in got)
    net = (query_traffic(pats, "reduce", caps, 10, store=store)
           / max(query_traffic(pats, "mapsin_routed", caps, 10,
                               store=store), 1))
    print(f"{qname:6s} {len(got):6d} {times['mapsin']*1e3:8.1f}m "
          f"{times['reduce']*1e3:8.1f}m {times['reduce']/times['mapsin']:8.2f} "
          f"{net:9.1f}  {got == want}")
