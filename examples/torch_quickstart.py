"""Quickstart for the PyTorch port: build an RDF store, run a SPARQL BGP
with the MAPSIN join.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cuda|cpu]

The store's indexes live on the CUDA card unless ``--device cpu`` is given.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.core import (Caps, Dictionary, build_store,  # noqa: E402
                              execute_local, query_traffic, rows_set)

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

# --- the paper's running example (Section 2.1 RDF graph) -------------------
d = Dictionary()
triples = d.encode_triples([
    ("Article1", "title", "PigSPARQL"),
    ("Article1", "year", "2011"),
    ("Article1", "author", "Alex"),
    ("Article1", "author", "Martin"),
    ("Article2", "title", "RDFPath"),
    ("Article2", "year", "2011"),
    ("Article2", "author", "Martin"),
    ("Article2", "author", "Alex"),
    ("Article2", "cite", "Article1"),
])
store = build_store(triples, num_shards=1, device=args.device)

# --- Query 1 from the paper: title + author + year of every article --------
query = [
    d.pattern("?article", "title", "?title"),
    d.pattern("?article", "author", "?author"),
    d.pattern("?article", "year", "?year"),
]
caps = Caps(out_cap=1024, probe_cap=8, row_cap=16)
result = execute_local(store, query, mode="mapsin", caps=caps)
rows = rows_set(result.table, result.valid, len(result.vars))
print("vars:", result.vars)
for row in sorted(rows):
    print("  ", tuple(d.term(v) for v in row))

# --- the paper's network argument, in bytes (10-shard cluster model) --------
for mode in ("mapsin_routed", "mapsin", "reduce"):
    print(f"{mode:15s} modeled interconnect bytes: "
          f"{query_traffic(query, mode, caps, num_shards=10, store=store):,}")
