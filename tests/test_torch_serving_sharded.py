"""The port's sharded serving engine against the JAX package's.

The same numpy-seeded request streams go through ``repro.serve``'s
``ServeEngine`` bound to a JAX mesh (shard_map) and ``repro_torch.serve``'s
bound to a ``LocalMesh`` of CPU threads: per-request results (rows,
overflow, per-step overflow, stats, ``fault_unrecovered``), the dispatch,
payload and fault counters, the metrics and the span tree with every
dispatch span's attributes (epoch, retry, faults, bucket_cap,
probe_bytes, answer_bytes, bad) must be identical. At one shard the
reference runs in this process on its one device; at eight it runs once,
in one module-scoped subprocess with eight forced host devices. Also:
``FaultPlan`` draws, the engine's refusals, and the sharded engine over a
``MutableTripleStore`` across ingests."""
import dataclasses
import itertools
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import repro.core as jcore
import repro.obs as jobs
from repro.core.rdf import Pattern
from repro.serve import Fault as JFault, FaultPlan as JFaultPlan
from repro.serve import ServeEngine as JEngine
from repro.serve import faults as jfaults

import repro_torch.obs as tobs
from repro_torch.core import (Caps, ExecConfig, LocalMesh, build_store,
                              execute_local, execute_oracle, pattern_from,
                              rows_set)
from repro_torch.serve import Fault, FaultPlan, ServeEngine
from repro_torch.serve import faults as tfaults
from repro_torch.store import MutableTripleStore

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
CAPS = dict(out_cap=2048, probe_cap=64, row_cap=64)   # test_multidevice's
COUNTERS = ("dispatches", "dispatched_queries", "a2a_payload_bytes",
            "fault_epoch", "corrupt_detected", "fault_redispatches",
            "escalations", "fallbacks", "timeouts")


def graph(seed: int, n: int = 800) -> np.ndarray:
    rng = np.random.RandomState(seed)
    return np.stack([rng.randint(0, 60, n), rng.randint(100, 105, n),
                     rng.randint(0, 60, n)], 1).astype(np.int32)


def mixed_queries():
    """test_multidevice.py's batched-serving stream: a join template, a
    bound-subject template and a multiway star template."""
    qs = [[("?x", 101, c), ("?x", 102, "?y")] for c in (1, 5, 9, 13, 17, 21)]
    qs += [[(c, 103, "?a"), ("?a", 104, "?b")] for c in (2, 7, 11)]
    qs += [[("?x", 101, c), ("?x", 102, "?a"), ("?x", 103, "?b")]
           for c in (3, 8)]
    return qs


def chaos_queries():
    """test_multidevice.py's chaos stream."""
    qs = [[("?x", 101, c), ("?x", 102, "?y")] for c in (1, 5, 9, 13)]
    return qs + [[("?x", 101, "?y"), ("?y", 102, "?z")]]


def _jp(q):
    return [Pattern(*t) for t in q]


def _tp(q):
    return [pattern_from(Pattern(*t)) for t in q]


class FakeClock:
    def __init__(self):
        self._n = itertools.count()

    def __call__(self):
        return next(self._n) * 1e-3


def _jsonable(x):
    return json.loads(json.dumps(x, default=lambda o: (
        dataclasses.asdict(o) if dataclasses.is_dataclass(o)
        else o.item() if hasattr(o, "item") else str(o))))


def summary(eng, results, tracer, registry) -> dict:
    """What both packages' engines must agree on, as JSON values."""
    ids = {s.span_id: i for i, s in enumerate(tracer.spans)}
    snap = registry.to_dict()
    return _jsonable(dict(
        results=[dict(rid=r.request_id, type=type(r).__name__,
                      vars=list(r.vars), rows=np.asarray(r.rows).tolist(),
                      overflow=int(r.overflow), stats=r.stats)
                 for r in results],
        counters={k: getattr(eng, k) for k in COUNTERS},
        metrics=dict(counters=snap["counters"], gauges=snap["gauges"]),
        spans=[(s.name, s.track, ids.get(s.parent_id), s.async_id, s.t0,
                s.t1, s.attrs) for s in tracer.spans]))


STREAMS = {
    # name: (graph seed, routing, engine kwargs, queries)
    "a2a": (5, "a2a", dict(max_batch=8), mixed_queries()),
    "broadcast": (5, "broadcast", dict(max_batch=8), mixed_queries()),
    "one_shot": (11, "a2a", dict(fault_retries=2), chaos_queries()),
    "sampled_faults": (11, "a2a", dict(fault_retries=4), chaos_queries()),
    "saturated": (11, "a2a", dict(fault_retries=2, max_escalations=0),
                  chaos_queries()[-1:]),
}


def fault_plan(mod, name: str, num_shards: int):
    """The stream's FaultPlan from the module `mod` (either package's
    serve.faults)."""
    if name == "sampled_faults":
        return mod.FaultPlan.sample(3, num_shards=num_shards, n_steps=1,
                                    rate=0.10, horizon=16)
    if name == "saturated":
        return mod.FaultPlan((mod.Fault(0, num_shards // 4, "corrupt",
                                        epoch=0),), period=1)
    if name == "one_shot":           # benchmarks/bench_serving.py's canary
        return mod.FaultPlan((mod.Fault(0, 0, "drop", epoch=0),
                              mod.Fault(0, min(1, num_shards - 1),
                                        "corrupt", epoch=1)))
    return None


def run_port(name: str, store, mesh, num_shards: int) -> dict:
    seed, routing, kw, queries = STREAMS[name]
    tracer, reg = tobs.Tracer(clock=FakeClock()), tobs.MetricsRegistry()
    eng = ServeEngine(store, cfg=ExecConfig(impl="torch", routing=routing),
                      caps=Caps(**CAPS), mesh=mesh, tracer=tracer,
                      metrics=reg,
                      fault_plan=fault_plan(tfaults, name, num_shards), **kw)
    res = eng.execute([_tp(q) for q in queries])
    return summary(eng, res, tracer, reg)


def run_reference(name: str, store, mesh, num_shards: int) -> dict:
    seed, routing, kw, queries = STREAMS[name]
    tracer, reg = jobs.Tracer(clock=FakeClock()), jobs.MetricsRegistry()
    eng = JEngine(store, cfg=jcore.ExecConfig(routing=routing),
                  caps=jcore.Caps(**CAPS), mesh=mesh, tracer=tracer,
                  metrics=reg,
                  fault_plan=fault_plan(jfaults, name, num_shards), **kw)
    res = eng.execute([_jp(q) for q in queries])
    return summary(eng, res, tracer, reg)


def same(got: dict, want: dict, label):
    assert got["counters"] == want["counters"], label
    assert len(got["results"]) == len(want["results"]), label
    for a, b in zip(got["results"], want["results"]):
        assert a == b, (label, a["rid"])
    assert got["metrics"] == want["metrics"], label
    assert len(got["spans"]) == len(want["spans"]), label
    for a, b in zip(got["spans"], want["spans"]):
        assert a == b, (label, a[0])


# ---------------------------------------------------------------------------
# one shard: the reference's in-process one-device mesh
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def one_shard():
    from jax.sharding import Mesh
    out = {}
    for seed in (5, 11):
        tr = graph(seed)
        out[seed] = (build_store(tr, 1, device="cpu"), jcore.build_store(tr, 1))
    return dict(stores=out, jmesh=Mesh(np.array(jax.devices()[:1]),
                                       ("data",)))


@pytest.mark.parametrize("name", list(STREAMS))
def test_one_shard_engine_matches_reference(one_shard, name):
    seed = STREAMS[name][0]
    ts, js = one_shard["stores"][seed]
    got = run_port(name, ts, LocalMesh(1, device="cpu"), 1)
    want = run_reference(name, js, one_shard["jmesh"], 1)
    same(got, want, name)
    if name == "one_shot":
        assert got["counters"]["corrupt_detected"] >= 2
    if name == "saturated":
        assert all(r["stats"].get("fault_unrecovered")
                   for r in got["results"])


def test_precompile_ships_no_payload():
    ts = build_store(graph(5), 2, device="cpu")   # one shard ships nothing
    eng = ServeEngine(ts, cfg=ExecConfig(impl="torch", routing="a2a"),
                      caps=Caps(**CAPS), mesh=LocalMesh(2, device="cpu"),
                      max_batch=4, metrics=False)
    eng.precompile(_tp(mixed_queries()[0]))
    assert eng.a2a_payload_bytes == 0 and len(eng._compiled) == 3
    eng.execute([_tp(mixed_queries()[0])])
    assert eng.a2a_payload_bytes > 0


# ---------------------------------------------------------------------------
# eight shards: the reference in one subprocess with eight host devices
# ---------------------------------------------------------------------------

_REFERENCE = textwrap.dedent("""
    import json, sys
    import numpy as np, jax
    from jax.sharding import Mesh
    sys.path.insert(0, sys.argv[2])
    import test_torch_serving_sharded as t
    from repro.core import build_store
    mesh = Mesh(np.array(jax.devices()[:8]), ("data",))
    out = {}
    for name, (seed, _, _, _) in t.STREAMS.items():
        store = build_store(t.graph(seed), num_shards=8)
        out[name] = t.run_reference(name, store, mesh, 8)
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
""")


@pytest.fixture(scope="module")
def reference8(tmp_path_factory):
    path = tmp_path_factory.mktemp("serve8") / "ref.json"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    out = subprocess.run(
        [sys.executable, "-c", _REFERENCE, str(path),
         os.path.dirname(os.path.abspath(__file__))],
        env=env, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(path.read_text())


@pytest.mark.parametrize("name", list(STREAMS))
def test_eight_shard_engine_matches_reference(reference8, name):
    seed = STREAMS[name][0]
    got = run_port(name, build_store(graph(seed), 8, device="cpu"),
                   LocalMesh(8, device="cpu"), 8)
    same(got, reference8[name], name)
    c = got["counters"]
    if name in ("a2a", "broadcast"):
        assert c["dispatches"] == 3                   # one per template
        assert (c["a2a_payload_bytes"] > 0) == (name == "a2a")
    if name in ("one_shot", "sampled_faults"):
        assert c["corrupt_detected"] > 0 and c["fault_redispatches"] > 0
        assert not any(r["stats"].get("fault_unrecovered")
                       for r in got["results"])
    if name == "saturated":
        assert c["corrupt_detected"] >= 3
        assert got["results"][0]["stats"]["fault_unrecovered"]


@pytest.mark.parametrize("name", ["a2a", "one_shot", "saturated"])
def test_eight_shard_rows_are_never_wrong(name):
    """Every complete result equals execute_local; a quarantined one is
    marked and a subset of it."""
    seed, _, _, queries = STREAMS[name]
    tr = graph(seed)
    got = run_port(name, build_store(tr, 8, device="cpu"),
                   LocalMesh(8, device="cpu"), 8)
    store1 = build_store(tr, 1, device="cpu")
    for q, r in zip(queries, got["results"]):
        bnd = execute_local(store1, _tp(q), caps=Caps(**CAPS))
        want = rows_set(bnd.table, bnd.valid, len(bnd.vars))
        perm = [r["vars"].index(v) for v in bnd.vars]
        rows = {tuple(row[i] for i in perm) for row in r["rows"]}
        if r["stats"].get("fault_unrecovered"):
            assert rows <= want
        else:
            assert rows == want and r["overflow"] == 0


# ---------------------------------------------------------------------------
# fault plans and refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_fault_plan_sample_matches_reference(seed):
    for shards, steps, rate, horizon in ((8, 2, 0.01, 32), (8, 1, 0.10, 16),
                                         (2, 2, 0.30, 8)):
        got = FaultPlan.sample(seed, shards, n_steps=steps, rate=rate,
                               horizon=horizon)
        want = JFaultPlan.sample(seed, shards, n_steps=steps, rate=rate,
                                 horizon=horizon)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        for e in range(horizon + 3):
            assert got.selection(e, steps) == want.selection(e, steps)
            assert got.delay_s_at(e) == want.delay_s_at(e)
    with pytest.raises(ValueError):
        Fault(0, 0, "melt")
    with pytest.raises(ValueError):
        JFault(0, 0, "melt")
    plan = FaultPlan((Fault(0, 1, "delay", epoch=2, delay_s=0.5),), period=4)
    assert plan.delay_s_at(6) == 0.5 and plan.at(6, 0) == ((), ())


def test_engine_refusals_match_reference(one_shard):
    ts, js = one_shard["stores"][5]
    jmesh, tmesh = one_shard["jmesh"], LocalMesh(1, device="cpu")
    two = build_store(graph(5), 2, device="cpu")
    two_j = jcore.build_store(graph(5), 2)
    cases = [
        # (port kwargs, reference kwargs)
        (dict(fault_plan=FaultPlan()), dict(fault_plan=JFaultPlan())),
        (dict(check_answers=True), dict(check_answers=True)),
        (dict(mesh=tmesh, fault_plan=FaultPlan()),
         dict(mesh=jmesh, fault_plan=JFaultPlan())),
        (dict(mesh=tmesh, check_answers=True),
         dict(mesh=jmesh, check_answers=True)),
    ]
    for tkw, jkw in cases:
        with pytest.raises(ValueError):
            ServeEngine(ts, **tkw)
        with pytest.raises(ValueError):
            JEngine(js, **jkw)
    with pytest.raises(ValueError, match="shards"):
        ServeEngine(two, mesh=tmesh)
    with pytest.raises(ValueError):
        JEngine(two_j, mesh=jmesh)
    # accepted: an a2a mesh with a plan, and check_answers defaulting on
    a2a = ExecConfig(impl="torch", routing="a2a")
    eng = ServeEngine(ts, cfg=a2a, mesh=tmesh, fault_plan=FaultPlan())
    jeng = JEngine(js, cfg=jcore.ExecConfig(routing="a2a"), mesh=jmesh,
                   fault_plan=JFaultPlan())
    assert eng.check_answers and jeng.check_answers
    assert not ServeEngine(ts, cfg=a2a, mesh=tmesh).check_answers


# ---------------------------------------------------------------------------
# the sharded engine over a mutable store
# ---------------------------------------------------------------------------

JOIN = [("?x", 1, "?y"), ("?y", 2, "?z")]
STORE_CAPS = dict(scan_cap=4096, out_cap=4096, probe_cap=16, row_cap=64)


def ingest_batches(seed, n_batches, per_batch, ids=30, preds=4):
    """The reference tests' join-friendly ingest workload."""
    r = np.random.RandomState(seed)
    return [np.stack([r.randint(0, ids, per_batch),
                      r.randint(0, preds, per_batch),
                      r.randint(0, ids, per_batch)], 1).astype(np.int32)
            for _ in range(n_batches)]


@pytest.mark.parametrize("shards", [1, 4])
def test_sharded_engine_serves_across_ingests(tmp_path, shards):
    """tests/test_store_mutable.py's case, at one shard and at four: after
    every ingest the engine answers over the new layout, equal to the
    oracle on the acked triples, on both routings."""
    st = MutableTripleStore.create(str(tmp_path / "s"), num_shards=shards,
                                   overlay_limit=32, device="cpu")
    mesh = LocalMesh(shards, device="cpu")
    engines = [ServeEngine(st, cfg=ExecConfig(impl="torch", routing=r),
                           caps=Caps(**STORE_CAPS), mesh=mesh, metrics=False)
               for r in ("a2a", "broadcast")]
    acked = []
    try:
        for b in ingest_batches(13, 4, 20):
            st.ingest(b)
            acked.append(b)
            want, ovars = execute_oracle(np.concatenate(acked), _tp(JOIN))
            for eng in engines:
                res = eng.execute([_tp(JOIN)])[0]
                assert res.rows_set(ovars) == want and res.overflow == 0
    finally:
        st.close()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_kernel_engine_matches_torch_engine_on_the_card():
    """Eight shards on one card under the canary's faults: impl="kernel"
    and impl="torch" deliver the same rows, stats and detections."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    store = build_store(graph(11), 8, device="cuda")
    mesh = LocalMesh(8, device="cuda")
    out = {}
    for impl in ("kernel", "torch"):
        eng = ServeEngine(store, cfg=ExecConfig(impl=impl, routing="a2a"),
                          caps=Caps(**CAPS), mesh=mesh, max_batch=8,
                          metrics=False,
                          fault_plan=fault_plan(tfaults, "one_shot", 8))
        res = eng.execute([_tp(q) for q in chaos_queries()])
        out[impl] = ([(r.vars, r.rows.tolist(), r.overflow, r.stats)
                      for r in res], eng.corrupt_detected,
                     eng.fault_redispatches)
    assert out["kernel"] == out["torch"]
    assert out["kernel"][1] > 0
