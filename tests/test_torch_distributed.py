"""The port's distributed path (core/collectives.py, core/distributed.py,
execute_sharded) against the JAX package's.

The same numpy-seeded stores go through ``repro.core.execute_sharded``
(shard_map over a JAX mesh, jnp path) and ``repro_torch.core.execute_sharded``
(a ``LocalMesh`` of CPU threads, the kernels' plain versions): per-shard
tables, valid masks, overflow counters and variable orders must be equal bit
for bit, on both routings and the reduce-side baseline. At one shard the
reference runs in this process on its one device; at eight it runs once, in
one module-scoped subprocess with eight forced host devices (the flag must
never reach this process). The wire-format helpers, the checksum and the
embedded a2a plan caps are compared function by function, and the
``ProcessGroupMesh`` over four gloo ranks against ``LocalMesh(4)``."""
import dataclasses
import json
import os
import socket
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import repro.core as jcore
from repro.core import bgp as jbgp
from repro.core import distributed as jdist
from repro.core.rdf import Pattern
from repro.data import lubm_like as j_lubm

from repro_torch.core import (Caps, ExecConfig, LocalMesh, build_store,
                              compile_plan, execute_local, execute_oracle,
                              execute_sharded, pattern_from, rows_set)
from repro_torch.core import bgp as tbgp
from repro_torch.core import distributed as tdist
from repro_torch.core.planner import ENGINE_OPERATORS
from repro_torch.core.rdf import BITS, MAX_ID, pack3
from repro_torch.core.triple_store import range_intersects_region
from repro_torch.kernels import ops

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SRC = os.path.join(ROOT, "src")
HUB = 70
CHAIN = [Pattern("?x", 101, "?y"), Pattern("?y", 102, "?z")]
STAR = [Pattern("?x", 101, "?y"), Pattern("?y", 102, "?z"),
        Pattern("?y", 103, "?w")]
# the fat row (300 objects of HUB) is wider than probe_cap and row_cap: the
# probe truncates, and both packages must count the same misses
FAT_CAPS = dict(scan_cap=1024, out_cap=1024, probe_cap=64, row_cap=64,
                bucket_cap=512)
# benchmarks/bench_distributed.py's caps: no truncation at lubm_like(1)
LUBM_CAPS = dict(scan_cap=1 << 14, out_cap=1 << 12, probe_cap=64,
                 row_cap=64, bucket_cap=1 << 11)
LUBM_QUERIES = ("Q1", "Q4", "Q7", "Q14")
RUNS = (("mapsin", "broadcast"), ("mapsin", "a2a"), ("reduce", "broadcast"))


def fat_graph() -> np.ndarray:
    """tests/test_multidevice.py's random 600-triple store, with a fat
    rdf:type-style row (HUB) whose range spans several regions."""
    rng = np.random.RandomState(3)
    tr = np.stack([rng.randint(0, 60, 600), rng.randint(100, 105, 600),
                   rng.randint(0, 60, 600)], 1)
    fat = np.stack([np.full(300, HUB), np.full(300, 102),
                    np.arange(300) % 90], 1)
    link = np.stack([rng.randint(0, 60, 200), np.full(200, 101),
                     np.full(200, HUB)], 1)
    return np.concatenate([tr, fat, link]).astype(np.int32)


def _pats(qs):
    return [pattern_from(p) for p in qs]


def _sharded(store, pats, mesh, mode, routing, caps):
    t, v, o, vars_ = execute_sharded(store, _pats(pats), mesh, mode,
                                     ExecConfig(impl="torch",
                                                routing=routing),
                                     caps=Caps(**caps))
    return t.numpy(), v.numpy(), o.numpy(), tuple(vars_)


def _same(got, want, label):
    t, v, o, vars_ = got
    tj, vj, oj, vj_vars = want
    assert vars_ == tuple(vj_vars), label
    assert t.dtype == np.int32 and v.dtype == np.bool_, label
    np.testing.assert_array_equal(t, np.asarray(tj), err_msg=label)
    np.testing.assert_array_equal(v, np.asarray(vj), err_msg=label)
    np.testing.assert_array_equal(o, np.asarray(oj), err_msg=label)


# ---------------------------------------------------------------------------
# the wire format, function by function
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,s,cap", [(50, 4, 8), (64, 8, 64), (1, 3, 2), (0, 4, 8)])
def test_bucket_rows_matches_reference(n, s, cap):
    rng = np.random.RandomState(n + s)
    send = rng.rand(n, s) < 0.4
    keys = rng.randint(0, 1 << 62, n, dtype=np.int64)
    rows = rng.randint(0, 1000, (n, 3)).astype(np.int32)
    valid = rng.rand(n) < 0.7
    got = tdist.bucket_rows(torch.from_numpy(send), cap,
                            [torch.from_numpy(keys), torch.from_numpy(rows),
                             torch.from_numpy(valid)])
    want = jdist.bucket_rows(jnp.asarray(send), cap,
                             [jnp.asarray(keys), jnp.asarray(rows),
                              jnp.asarray(valid)])
    for a, b in zip(got[0], want[0]):
        assert a.dtype == torch.from_numpy(np.asarray(b)).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[1].dtype == torch.int32 and got[2].dtype == torch.int32


def test_leg_checksum_wraps_as_the_reference():
    """Keys near MAX_ID: the weighted sum leaves int64, and both packages
    keep the same low 64 bits (two's-complement wraparound)."""
    rng = np.random.RandomState(7)
    s, cap, p = 3, 4, 5
    top = int(pack3(np.int64(MAX_ID), np.int64(MAX_ID), np.int64(MAX_ID - 1)))
    ans = (top - rng.randint(0, 1000, (s, cap, p))).astype(np.int64) + 1
    ans[0, 0, :2] = 0                                   # empty slots
    cnt = rng.randint(0, p + 1, (s, cap)).astype(np.int32)
    miss = rng.randint(0, 50, (s, cap)).astype(np.int32)
    w = (2 * np.arange(cap * p) + 1).reshape(cap, p)
    exact = [sum(int(a) * int(b) for a, b in zip(ans[i].ravel(), w.ravel()))
             * 1000003 for i in range(s)]
    assert all(abs(x) >= 1 << 63 for x in exact)        # the sum wraps
    for answerer in (2, np.arange(s)):
        got = tdist._leg_checksum(torch.from_numpy(ans), torch.from_numpy(cnt),
                                  torch.from_numpy(miss),
                                  torch.as_tensor(answerer)
                                  if isinstance(answerer, np.ndarray)
                                  else answerer)
        want = jdist._leg_checksum(jnp.asarray(ans), jnp.asarray(cnt),
                                   jnp.asarray(miss), jnp.asarray(answerer))
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("batch,s", [(1, 1), (8, 8), (100, 3), (4096, 8),
                                     (16384, 64)])
def test_wire_sizes_match_reference(batch, s):
    assert tdist.auto_bucket_cap(batch, s) == jdist.auto_bucket_cap(batch, s)
    for cap in (1, 8, 64):
        assert tdist.a2a_leg_bytes(batch, cap, s) == jdist.a2a_leg_bytes(
            batch, cap, s)
        assert tbgp.a2a_step_payload_bytes(batch, cap, s) == \
            jbgp.a2a_step_payload_bytes(batch, cap, s)


@pytest.fixture(scope="module")
def lubm8():
    tr, _, qs = j_lubm(1)
    return dict(triples=tr, qs=qs, ts=build_store(tr, 8, device="cpu"),
                js=jcore.build_store(tr, num_shards=8))


@pytest.mark.parametrize("q", LUBM_QUERIES)
def test_embedded_a2a_caps_match_reference(lubm8, q):
    pats = lubm8["qs"][q]
    got = compile_plan(lubm8["ts"], _pats(pats), Caps(**LUBM_CAPS),
                       routing="a2a", num_shards=8)
    want = jcore.compile_plan(lubm8["js"], pats, jcore.Caps(**LUBM_CAPS),
                              routing="a2a", num_shards=8)
    assert got.var_order == want.var_order and got.cost == want.cost
    assert [(st.kind, dataclasses.asdict(st.caps), st.est_in, st.est_out,
             st.est_fanout_max) for st in got.steps] == [
        (st.kind, dataclasses.asdict(st.caps), st.est_in, st.est_out,
         st.est_fanout_max) for st in want.steps]
    # a single-device plan is unchanged by the new arguments
    assert compile_plan(lubm8["ts"], _pats(pats), Caps(**LUBM_CAPS)) == \
        compile_plan(lubm8["ts"], _pats(pats), Caps(**LUBM_CAPS),
                     routing="a2a")


# ---------------------------------------------------------------------------
# one shard: the reference's in-process one-device mesh
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fat1():
    tr = fat_graph()
    from jax.sharding import Mesh
    return dict(triples=tr, ts=build_store(tr, 1, device="cpu"),
                js=jcore.build_store(tr, 1),
                mesh=Mesh(np.array(jax.devices()[:1]), ("data",)))


@pytest.mark.parametrize("mode,routing", RUNS)
@pytest.mark.parametrize("qname", ["chain", "star"])
def test_one_shard_matches_reference(fat1, qname, mode, routing):
    pats = CHAIN if qname == "chain" else STAR
    got = _sharded(fat1["ts"], pats, LocalMesh(1, device="cpu"), mode,
                   routing, FAT_CAPS)
    want = jcore.execute_sharded(fat1["js"], pats, fat1["mesh"], mode,
                                 jcore.ExecConfig(routing=routing),
                                 caps=jcore.Caps(**FAT_CAPS))
    _same(got, want, (qname, mode, routing))


# ---------------------------------------------------------------------------
# eight shards: the reference in one subprocess with eight host devices
# ---------------------------------------------------------------------------

_REFERENCE = textwrap.dedent("""
    import json, sys
    import numpy as np, jax
    from jax.sharding import Mesh
    from repro.core import Caps, ExecConfig, build_store, execute_sharded
    from repro.core.rdf import Pattern
    from repro.data import lubm_like
    spec = json.loads(sys.argv[1])
    mesh = Mesh(np.array(jax.devices()[:8]), ("data",))
    tr_lubm, _, qs = lubm_like(1)
    stores = {"fat": np.load(spec["fat"]), "lubm": tr_lubm}
    built = {k: build_store(v, num_shards=8) for k, v in stores.items()}
    queries = {"chain": spec["chain"], "star": spec["star"]}
    term = lambda t: t if isinstance(t, str) else int(t)
    queries.update({q: [[term(p.s), term(p.p), term(p.o)] for p in qs[q]]
                    for q in spec["lubm_queries"]})
    out = {"triples_lubm": tr_lubm}
    meta = {"patterns": queries, "vars": {}}
    for i, (store, q, mode, routing) in enumerate(spec["cases"]):
        pats = [Pattern(*p) for p in queries[q]]
        caps = Caps(**spec["caps"][store])
        t, v, o, vars_ = execute_sharded(built[store], pats, mesh, mode,
                                         ExecConfig(routing=routing),
                                         caps=caps)
        out[f"t{i}"], out[f"v{i}"], out[f"o{i}"] = (np.asarray(t),
                                                    np.asarray(v),
                                                    np.asarray(o))
        meta["vars"][str(i)] = list(vars_)
    np.savez(spec["out"], **out)
    print(json.dumps(meta))
""")

CASES8 = ([("fat", q, m, r) for q in ("chain", "star") for m, r in RUNS]
          + [("lubm", q, m, r) for q in LUBM_QUERIES for m, r in RUNS])


def _terms(pats):
    return [[t if isinstance(t, str) else int(t) for t in (p.s, p.p, p.o)]
            for p in pats]


@pytest.fixture(scope="module")
def reference8(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref8")
    fat = fat_graph()
    np.save(d / "fat.npy", fat)
    spec = dict(fat=str(d / "fat.npy"), out=str(d / "ref.npz"),
                chain=_terms(CHAIN), star=_terms(STAR),
                lubm_queries=list(LUBM_QUERIES), cases=CASES8,
                caps={"fat": FAT_CAPS, "lubm": LUBM_CAPS})
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    out = subprocess.run([sys.executable, "-c", _REFERENCE, json.dumps(spec)],
                         env=env, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    meta = json.loads(out.stdout.strip().splitlines()[-1])
    arrays = dict(np.load(d / "ref.npz"))
    return dict(meta=meta, arrays=arrays, fat=fat,
                stores={"fat": build_store(fat, 8, device="cpu"),
                        "lubm": build_store(arrays["triples_lubm"], 8,
                                            device="cpu")})


@pytest.mark.parametrize("i", range(len(CASES8)),
                         ids=["-".join(c) for c in CASES8])
def test_eight_shards_match_reference(reference8, i):
    store, q, mode, routing = CASES8[i]
    pats = [Pattern(*p) for p in reference8["meta"]["patterns"][q]]
    caps = FAT_CAPS if store == "fat" else LUBM_CAPS
    got = _sharded(reference8["stores"][store], pats,
                   LocalMesh(8, device="cpu"), mode, routing, caps)
    a = reference8["arrays"]
    _same(got, (a[f"t{i}"], a[f"v{i}"], a[f"o{i}"],
                reference8["meta"]["vars"][str(i)]), CASES8[i])
    if store == "lubm" and mode == "mapsin":
        # no truncation at the bench's caps: the rows equal one shard's
        assert int(got[2].sum()) == 0
        bnd = execute_local(build_store(a["triples_lubm"], 1, device="cpu"),
                            _pats(pats), caps=Caps(**caps))
        want = rows_set(bnd.table, bnd.valid, len(bnd.vars))
        perm = [got[3].index(v) for v in bnd.vars]
        rows = rows_set(torch.from_numpy(got[0]), torch.from_numpy(got[1]),
                        len(got[3]))
        assert {tuple(r[k] for k in perm) for r in rows} == want


def test_fat_row_spans_regions_and_routings_agree(reference8):
    """The fat row's range crosses region boundaries (the multi-destination
    fan-out), and a2a and broadcast give the same rows."""
    st = reference8["stores"]["fat"]
    lo = pack3(np.int64(HUB), np.int64(0), np.int64(0))
    sp = st.splits_spo.numpy()
    assert int(range_intersects_region(lo, lo + (1 << (2 * BITS)),
                                       sp[:-1], sp[1:]).sum()) >= 2
    a = reference8["arrays"]
    for q in ("chain", "star"):
        idx = {r: CASES8.index(("fat", q, "mapsin", r))
               for r in ("broadcast", "a2a")}
        sets = {r: rows_set(torch.from_numpy(a[f"t{i}"]),
                            torch.from_numpy(a[f"v{i}"]),
                            len(reference8["meta"]["vars"][str(i)]))
                for r, i in idx.items()}
        assert sets["a2a"] == sets["broadcast"] and sets["a2a"]


# ---------------------------------------------------------------------------
# the meshes themselves
# ---------------------------------------------------------------------------


def _collectives(comm):
    """Each collective once, on int64, int32 and bool inputs built from
    the shard index."""
    n, me = comm.size, comm.index
    x = torch.arange(n * 3, dtype=torch.int64).reshape(n, 3) * 10 + me
    b = (torch.arange(n * 2) % (me + 2) == 0).reshape(n * 2)
    return (comm.all_to_all(x), comm.all_to_all(b),
            comm.all_gather(x[0]), comm.all_gather(b),
            comm.psum(x.to(torch.int32)), comm.psum_scatter(x),
            torch.tensor([comm.index, comm.size]))


def test_local_mesh_collectives_follow_jax_semantics():
    n = 4
    outs = LocalMesh(n, device="cpu").run(_collectives)
    xs = [torch.arange(n * 3, dtype=torch.int64).reshape(n, 3) * 10 + s
          for s in range(n)]
    for me, (a2a, a2a_b, ag, ag_b, ps, pss, idx) in enumerate(outs):
        assert idx.tolist() == [me, n]
        torch.testing.assert_close(a2a, torch.stack([x[me] for x in xs]))
        torch.testing.assert_close(ag, torch.stack([x[0] for x in xs]))
        assert ag_b.shape == (n, n * 2) and ag_b.dtype == torch.bool
        assert a2a_b.dtype == torch.bool
        assert ps.dtype == torch.int32
        torch.testing.assert_close(ps, sum(x.to(torch.int32) for x in xs))
        torch.testing.assert_close(pss, sum(xs)[me:me + 1])


def test_failing_shard_raises_and_does_not_hang():
    mesh = LocalMesh(4, device="cpu", timeout=60.0)

    def body(comm):
        x = comm.all_gather(torch.ones(2))
        if comm.index == 2:
            raise KeyError("shard 2 failed")
        return comm.psum(x)

    t0 = time.monotonic()
    with pytest.raises(KeyError, match="shard 2 failed"):
        mesh.run(body)
    assert time.monotonic() - t0 < 30                # aborted, not timed out
    # a shard that skips a rendezvous breaks it at the timeout
    quick = LocalMesh(3, device="cpu", timeout=0.5)
    with pytest.raises(TimeoutError):
        quick.run(lambda comm: comm.psum(torch.ones(1))
                  if comm.index else None)
    # the mesh stays usable after a failure
    assert [int(t) for t in mesh.run(lambda c: c.psum(torch.ones(())))] == \
        [4] * 4
    assert not [t for t in threading.enumerate()
                if t.name.startswith("shard")]


def test_threads_lose_no_count_and_no_exchange():
    """More shards than cores and a tiny switch interval: every shard's
    vmapped rank-finds are counted (the counters' lock), and every
    rendezvous returns the right sums."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        n, rounds = 16, 40
        keys = torch.arange(0, 1000, 3, dtype=torch.int64)
        before = ops.vmap_folds["searchsorted"]

        def body(comm):
            total = 0
            for r in range(rounds):
                q = torch.full((2, 5), comm.index + r, dtype=torch.int64)
                torch.func.vmap(lambda x: ops.searchsorted(keys, x))(q)
                total += int(comm.psum(torch.tensor(comm.index + r)))
            return torch.tensor(total)

        out = LocalMesh(n, device="cpu", timeout=120.0).run(body)
    finally:
        sys.setswitchinterval(old)
    want = sum(sum(s + r for s in range(n)) for r in range(rounds))
    assert [int(t) for t in out] == [want] * n
    assert ops.vmap_folds["searchsorted"] - before == n * rounds


_GLOO_WORKER = textwrap.dedent("""
    import sys
    import numpy as np, torch, torch.distributed as td
    from repro_torch.core import (Caps, ExecConfig, ProcessGroupMesh,
                                  Pattern, build_store, execute_sharded)
    rank, port, fat, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
    td.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                          rank=rank, world_size=4)
    try:
        # like every entry point of the port, the mesh is on the card
        # unless the caller asks for the CPU
        if torch.cuda.is_available():
            assert ProcessGroupMesh().device.type == "cuda"
        else:
            try:
                ProcessGroupMesh()
            except RuntimeError as e:
                assert "CUDA is not available" in str(e), e
            else:
                raise AssertionError("ProcessGroupMesh() took the CPU")
        mesh = ProcessGroupMesh(device="cpu")
        store = build_store(np.load(fat), 4, device="cpu")
        res = {}
        for qn, pats in (("chain", [Pattern("?x", 101, "?y"),
                                    Pattern("?y", 102, "?z")]),
                         ("star", [Pattern("?x", 101, "?y"),
                                   Pattern("?y", 102, "?z"),
                                   Pattern("?y", 103, "?w")])):
            for mode, routing in (("mapsin", "broadcast"), ("mapsin", "a2a"),
                                  ("reduce", "broadcast")):
                t, v, o, _ = execute_sharded(
                    store, pats, mesh, mode,
                    ExecConfig(impl="torch", routing=routing),
                    caps=Caps(scan_cap=1024, out_cap=1024, probe_cap=64,
                              row_cap=64, bucket_cap=512))
                key = f"{qn}-{mode}-{routing}"
                res[key + "-t"], res[key + "-v"], res[key + "-o"] = (
                    t.numpy(), v.numpy(), o.numpy())
        np.savez(out, **res)
    finally:
        td.destroy_process_group()
""")


def test_process_group_mesh_gloo_matches_local_mesh(tmp_path):
    fat = fat_graph()
    np.save(tmp_path / "fat.npy", fat)
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=SRC)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _GLOO_WORKER, str(r), str(port),
         str(tmp_path / "fat.npy"), str(tmp_path / f"r{r}.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(4)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=300)
            errs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0] * 4, "\n".join(errs)[-4000:]
    store = build_store(fat, 4, device="cpu")
    mesh = LocalMesh(4, device="cpu")
    ranks = [dict(np.load(tmp_path / f"r{r}.npz")) for r in range(4)]
    for qn, pats in (("chain", CHAIN), ("star", STAR)):
        for mode, routing in RUNS:
            key = f"{qn}-{mode}-{routing}"
            want = _sharded(store, pats, mesh, mode, routing, FAT_CAPS)
            for res in ranks:                       # every rank has all shards
                for k, w in zip("tvo", want[:3]):
                    np.testing.assert_array_equal(res[f"{key}-{k}"], w,
                                                  err_msg=key)


def test_sharded_refuses_a_mismatched_mesh(fat1):
    with pytest.raises(ValueError, match="shards"):
        execute_sharded(fat1["ts"], _pats(CHAIN), LocalMesh(2, device="cpu"))
    with pytest.raises(ValueError, match="routing"):
        ExecConfig(routing="ring")
    with pytest.raises(ValueError, match="reduce"):
        plan = compile_plan(fat1["ts"], _pats(CHAIN), Caps(**FAT_CAPS),
                            operators=ENGINE_OPERATORS)
        execute_sharded(fat1["ts"], plan, LocalMesh(1, device="cpu"),
                        "reduce")


def test_sharded_closure_is_cached_per_mesh(fat1):
    """One closure per (plan, cfg, axis, mesh fingerprint) on the store."""
    st = build_store(fat1["triples"], 1, device="cpu")
    for _ in range(2):
        execute_sharded(st, _pats(CHAIN), LocalMesh(1, device="cpu"),
                        cfg=ExecConfig(impl="torch"), caps=Caps(**FAT_CAPS))
    keys = [k for k in st.plan_cache if k[0] == "sharded"]
    assert len(keys) == 1 and keys[0][-1] == LocalMesh(
        1, device="cpu").fingerprint("data")
    execute_sharded(st, _pats(CHAIN), LocalMesh(1, device="cpu"),
                    cfg=ExecConfig(impl="torch", routing="a2a"),
                    caps=Caps(**FAT_CAPS))
    assert len([k for k in st.plan_cache if k[0] == "sharded"]) == 2


def test_oracle_rows_at_generous_caps():
    """Eight shards, both routings, no truncation: the oracle's rows."""
    rng = np.random.RandomState(3)
    tr = np.stack([rng.randint(0, 60, 600), rng.randint(100, 105, 600),
                   rng.randint(0, 60, 600)], 1).astype(np.int32)
    store = build_store(tr, 8, device="cpu")
    want, ovars = execute_oracle(tr, _pats(CHAIN))
    mesh = LocalMesh(8, device="cpu")
    caps = dict(out_cap=2048, probe_cap=32, bucket_cap=1024)
    for mode, routing in RUNS:
        t, v, o, vars_ = _sharded(store, CHAIN, mesh, mode, routing, caps)
        perm = [vars_.index(x) for x in ovars]
        got = {tuple(r[i] for i in perm)
               for r in rows_set(torch.from_numpy(t), torch.from_numpy(v),
                                 len(vars_))}
        assert got == want and int(o.sum()) == 0, (mode, routing)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_kernel_mesh_matches_torch_mesh_on_the_card(lubm8):
    """Eight shards on one card: impl="kernel" equals impl="torch" on every
    routing, the searchsorted kernel is launched by the answer phase, and
    the broadcast GET launches the probe_gather kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    store = build_store(lubm8["triples"], 8, device="cuda")
    mesh = LocalMesh(8, device="cuda")
    broadcast_gets = 0
    for q in LUBM_QUERIES:
        pats = _pats(lubm8["qs"][q])
        for mode, routing in RUNS:
            out = {}
            for impl in ("kernel", "torch"):
                before = ops.launches["searchsorted"]
                gets0 = ops.launches["probe_gather"]
                out[impl] = execute_sharded(
                    store, pats, mesh, mode,
                    ExecConfig(impl=impl, routing=routing),
                    caps=Caps(**LUBM_CAPS))
                launched = ops.launches["searchsorted"] - before
                gets = ops.launches["probe_gather"] - gets0
                if impl == "torch":
                    assert launched == 0 and gets == 0
                elif routing == "broadcast":
                    broadcast_gets += gets
            for a, b in zip(out["kernel"][:3], out["torch"][:3]):
                assert torch.equal(a, b), (q, mode, routing)
    assert broadcast_gets > 0
