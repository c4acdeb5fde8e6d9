"""The system under test: every call the harness makes into the port
(`repro_torch`), and nothing else of it. The harness hands it the
generated triples and term table and reads back answer rows, counters,
spans and kernel names."""
from __future__ import annotations

import sys
import time

from portbench.devtrace import now_ns
from portbench.manifest import ROOT

OPS = ("searchsorted", "probe_gather")   # the index kernels' custom ops


def import_port():
    """The port's package, from the checkout's `src`."""
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    import repro_torch
    return repro_torch


def build_kernels_for_queries() -> None:
    """Build (or load from `build/kernels/`) only the two index kernels: a
    query cell launches no attention kernel."""
    import_port()
    from repro_torch.kernels import _build
    _build.SOURCES = tuple(s for s in _build.SOURCES if s in OPS)
    _build.build_all()
    print(f"[setup] kernels {_build.build_seconds:.3f} s", file=sys.stderr)


def load(graph, device: str):
    """(store, dictionary): both sorted indexes on `device`, and the term
    dictionary the front end resolves constants with."""
    import_port()
    from repro_torch.core import build_store
    from repro_torch.core.rdf import Dictionary
    t0 = time.perf_counter()
    d = Dictionary()
    for i, term in enumerate(graph.terms):
        d.replay_term(i, term)
    t1 = time.perf_counter()
    store = build_store(graph.triples, device=device)
    print(f"[setup] Dictionary {t1 - t0:.3f} s, build_store "
          f"{time.perf_counter() - t1:.3f} s", file=sys.stderr)
    return store, d


def caps(values: dict):
    from repro_torch.core import Caps
    return Caps(**values)


def ask(store, dictionary, text: str, caps, spans):
    """One ad hoc query: parse, run the cascade (the hand-written kernels on
    the card, their plain versions on the CPU), copy the valid rows to the
    host. Returns (vars, rows, overflow)."""
    from repro_torch.core import ExecConfig, execute_local
    from repro_torch.serve import parse_bgp
    t0 = now_ns()
    pq = parse_bgp(text, dictionary)
    t1 = now_ns()
    bnd = execute_local(store, pq.patterns, caps=caps,
                        cfg=ExecConfig(impl="kernel"))
    t2 = now_ns()
    rows = bnd.table[bnd.valid].cpu().numpy()
    ovf = int(bnd.overflow)
    t3 = now_ns()
    spans.add("parse_bgp", t0, t1)
    spans.add("execute_local", t1, t2)
    spans.add("copy_out", t2, t3)
    return bnd.vars, rows, ovf


def op_calls(fn):
    """Run `fn()` and return the index kernels' calls it made, as (op
    name, its arguments), seen by a dispatch mode (the byte count of a
    call reads only its arguments)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    calls = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ns, _, name = func.name().partition("::")
            if ns == "repro_torch" and name.split(".")[0] in OPS:
                calls.append((name.split(".")[0], args))
            return func(*args, **(kwargs or {}))

    with torch.no_grad(), Record():
        fn()
    return calls
