"""Every way the port runs one compiled plan, held to the JAX package's
``execute_local``.

One hand-built plan holds each kind of step: a scan, a multiway star, a
mapsin step whose GETs pass ``probe_cap`` (so it overflows) and a
reduce-side step. Seven ways of running it — ``execute_local`` cached,
traced and with ``stats=``; ``execute_sharded`` broadcast and a2a over
two shards; ``ServeEngine`` local and sharded, these two on the plan
without its reduce-side step, which a seeded template cannot express —
each give the reference's rows and its cumulative overflow after every
step, bit for bit. The sharded paths keep each shard's rows apart, so
their rows are compared in sorted order and their overflow summed over
the shards; they give the cumulative overflow of a step as the overflow
of the plan cut after it."""
import numpy as np
import pytest

import repro.core as jcore
from repro.core.rdf import Pattern as JPattern

from repro_torch.core import (Caps, ExecConfig, LocalMesh, build_store,
                              execute_local, execute_sharded)
from repro_torch.core.bgp import apply_dist_step, read_step_counts
from repro_torch.core.planner import PhysicalPlan, PlanStep
from repro_torch.core.rdf import Pattern
from repro_torch.kernels import ops
from repro_torch.obs.trace import Tracer
from repro_torch.serve.engine import ServeEngine

# one caps for every step: probe_cap 4 cuts the GETs of the fat ?a rows
# (10 objects each); no other step reaches a cap
CAPS = dict(scan_cap=512, out_cap=512, probe_cap=4, row_cap=16,
            bucket_cap=512)
STEPS = (("scan", (("?x", 101, "?y"),)),
         ("multiway", (("?y", 102, "?a"), ("?y", 103, "?b"))),
         ("mapsin", (("?a", 104, "?c"),)),
         ("reduce_side", (("?x", 105, "?d"),)))
VARS = ("?x", "?y", "?a", "?b", "?c", "?d")
PATHS = ("cached", "traced", "stats", "sharded-broadcast", "sharded-a2a",
         "engine", "engine-sharded")


def graph() -> np.ndarray:
    """40 ?x with an advisor ?y of 10, each ?y with two ?a and one or two
    ?b, 20 ?a with 1-3 ?c (every fifth with 10), each ?x with 1-2 ?d."""
    tr = [(x, 101, 200 + x % 10) for x in range(40)]
    for y in range(200, 210):
        tr += [(y, 102, 300 + (2 * y + j) % 20) for j in range(2)]
        tr += [(y, 103, 400 + (3 * y + j) % 7) for j in range(1 + y % 2)]
    for a in range(300, 320):
        tr += [(a, 104, 500 + (a * 7 + k) % 40)
               for k in range(10 if a % 5 == 0 else 1 + a % 3)]
    for x in range(40):
        tr += [(x, 105, 600 + (x + k) % 13) for k in range(1 + x % 2)]
    return np.asarray(tr, np.int32)


def _plan(steps, pattern, caps, plan_type, step_type):
    """The plan of `steps` in either package's types."""
    out = tuple(step_type(kind, tuple(pattern(*p) for p in pats), caps)
                for kind, pats in steps)
    nv = 2 + sum(len(p) for _, p in steps[1:])
    return plan_type(out, VARS[:nv], 0.0, "given")


def _plans(n_steps):
    return (_plan(STEPS[:n_steps], Pattern, Caps(**CAPS), PhysicalPlan,
                  PlanStep),
            _plan(STEPS[:n_steps], JPattern, jcore.Caps(**CAPS),
                  jcore.PhysicalPlan, jcore.PlanStep))


@pytest.fixture(scope="module")
def data():
    tr = graph()
    return dict(ts=build_store(tr, device="cpu"),
                ts2=build_store(tr, 2, device="cpu"),
                js=jcore.build_store(tr))


def _rows(table, valid, nv):
    return np.asarray(table)[np.asarray(valid)][:, :nv]


def _sorted(rows):
    return rows[np.lexsort(rows.T[::-1])] if len(rows) else rows


def _reference(data, n_steps):
    jb = jcore.execute_local(data["js"], _plans(n_steps)[1],
                             cfg=jcore.ExecConfig(impl="jnp"))
    return (tuple(jb.vars), _rows(jb.table, jb.valid, len(jb.vars)),
            np.asarray(jb.step_overflow))


def _local(data, path):
    plan = _plans(4)[0]
    tr = Tracer() if path == "traced" else None
    stats = [] if path == "stats" else None
    bnd = execute_local(data["ts"], plan, stats=stats, tracer=tr)
    if tr is not None:
        read_step_counts(tr)
        steps = [sp for sp in tr.spans if "step" in sp.attrs]
        assert [sp.name for sp in steps] == ["bgp." + k for k, _ in STEPS]
        assert steps[-1].attrs["found"] == int(bnd.count())
    if stats is not None:
        assert [s["kind"] for s in stats] == [k for k, _ in STEPS]
    return (bnd.vars, _rows(bnd.table, bnd.valid, len(bnd.vars)),
            bnd.step_overflow.numpy())


def _sharded(data, routing):
    cfg = ExecConfig(routing=routing)
    mesh = LocalMesh(2, device="cpu")
    ovf = []
    for n in range(1, 5):
        t, v, o, vars_ = execute_sharded(data["ts2"], _plans(n)[0], mesh,
                                         cfg=cfg)
        ovf.append(int(o.sum()))
    return tuple(vars_), _sorted(_rows(t, v, len(vars_))), np.asarray(ovf)


def _engine(data, sharded):
    store = data["ts2"] if sharded else data["ts"]
    eng = ServeEngine(store, caps=Caps(**CAPS), max_escalations=0,
                      mesh=LocalMesh(2, device="cpu") if sharded else None,
                      metrics=False)
    eng.submit(_plans(3)[0])
    (res,) = eng.drain()
    ovf = np.cumsum(res.stats["overflow_per_step"])
    assert res.overflow == ovf[-1]
    return tuple(res.vars), (_sorted(res.rows) if sharded else res.rows), ovf


@pytest.mark.parametrize("path", PATHS)
def test_every_path_matches_reference(data, path):
    if path.startswith("engine"):
        want = _reference(data, 3)
        got = _engine(data, path == "engine-sharded")
    elif path.startswith("sharded"):
        want = _reference(data, 4)
        got = _sharded(data, path.split("-")[1])
    else:
        want = _reference(data, 4)
        got = _local(data, path)
    vars_, rows, ovf = want
    assert got[0] == vars_
    if path.startswith("sharded") or path == "engine-sharded":
        rows = _sorted(rows)
    assert got[1].dtype == np.int32
    np.testing.assert_array_equal(got[1], rows)
    np.testing.assert_array_equal(got[2], ovf)
    # the plan is the one this file means: rows, and the mapsin step cut
    assert len(rows) and ovf[1] == 0 < ovf[2]


@pytest.mark.parametrize("routing", ["broadcast", "a2a"])
def test_broadcast_lookup_runs_the_probe_gather_op(data, routing,
                                                   monkeypatch):
    """The broadcast GET answers through ``ops.probe_gather``; the a2a
    answer leg ships raw range entries and does not."""
    calls = []
    real = ops.probe_gather

    def counted(*args, **kw):
        calls.append(args[4])
        return real(*args, **kw)

    monkeypatch.setattr(ops, "probe_gather", counted)
    plan = _plans(3)[0]
    execute_sharded(data["ts2"], plan, LocalMesh(2, device="cpu"),
                    cfg=ExecConfig(routing=routing))
    if routing == "a2a":
        assert calls == []
    else:   # each shard, each GET: the multiway row, the mapsin step
        assert sorted(calls) == [4, 4, 16, 16]


def test_batched_reduce_side_step_is_refused(data):
    """A seeded template cascade has no empty domain to re-scan from."""
    step = _plans(4)[0].steps[-1]
    keys = data["ts"].flat_keys(0)
    with pytest.raises(ValueError, match="reduce_side"):
        apply_dist_step(None, step, keys, keys, None, None, ExecConfig(),
                        None, batched=True)
