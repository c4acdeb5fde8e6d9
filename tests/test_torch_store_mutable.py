"""The port's durable mutable store against the JAX package's.

The same numpy-seeded ingest sequences go through ``repro.store`` and
``repro_torch.store`` (CPU device, so the merge's rank-finds take the
searchsorted kernel's plain version): after every ingest and flush the
two stores must agree bit for bit on every index array, split, count and
flat view, on their counters and versions, on their MANIFEST, WAL and
snapshot files, and on their metrics. A directory written by either
package recovers in the other to the same arrays, after clean closes,
WAL truncations and injected crashes. The device merge is held against
the reference's numpy merge on its edge cases, and the port's serving
engine over a mutable store against the JAX engine."""
import json
import os
import shutil

import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core.planner import (pattern_cardinality as j_card,
                                relation_stats as j_relstats)
from repro.obs.metrics import MetricsRegistry as JRegistry
from repro.serve import ServeEngine as JEngine
from repro.serve import faults as jfaults
from repro.store import mutable as jmut
from repro.store import wal as jwal

from repro_torch.core import (Caps, Pattern, compile_plan, execute_local,
                              execute_oracle, rows_set)
from repro_torch.core.planner import pattern_cardinality, relation_stats
from repro_torch.core.rdf import INF_KEY, MAX_ID
from repro_torch.kernels import ops
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serve import ServeEngine
from repro_torch.serve import faults as tfaults
from repro_torch.store import MutableTripleStore, merge
from repro_torch.store import mutable as tmut
from repro_torch.store import wal as twal

CAPS = dict(scan_cap=4096, out_cap=4096, probe_cap=16, row_cap=64)
JOIN = (Pattern("?x", 1, "?y"), Pattern("?y", 2, "?z"))
SCAN = (Pattern("?x", 1, "?y"),)
ARRAYS = ("keys_spo", "keys_ops", "splits_spo", "splits_ops", "counts_spo",
          "counts_ops")
COUNTERS = ("n_triples", "store_version", "overlay_depth", "flush_count",
            "acked_seq", "wal_bytes", "layout_key")


def batches(seed, n_batches, per_batch, ids=30, preds=4):
    """The reference tests' join-friendly ingest workload."""
    r = np.random.RandomState(seed)
    return [np.stack([r.randint(0, ids, per_batch),
                      r.randint(0, preds, per_batch),
                      r.randint(0, ids, per_batch)], 1).astype(np.int32)
            for _ in range(n_batches)]


def create_both(tmp_path, **kw):
    """(port store, reference store) created side by side with the same
    arguments, in tmp_path/t and tmp_path/j."""
    return (MutableTripleStore.create(str(tmp_path / "t"), device="cpu",
                                      **kw),
            jmut.MutableTripleStore.create(str(tmp_path / "j"), **kw))


def assert_same_arrays(ts, js):
    for name in ARRAYS:
        got = getattr(ts, name)
        assert got.dtype == torch.int64 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(js, name)),
                                      err_msg=name)
    for index in (0, 1):
        np.testing.assert_array_equal(ts.flat_keys(index).numpy(),
                                      np.asarray(js.flat_keys(index)),
                                      err_msg=f"flat_keys({index})")
    for name in ("_bk_spo", "_bk_ops", "_ov_spo", "_ov_ops"):
        np.testing.assert_array_equal(getattr(ts, name), getattr(js, name),
                                      err_msg=name)


def assert_same_store(ts, js):
    assert_same_arrays(ts, js)
    for name in COUNTERS:
        assert getattr(ts, name) == getattr(js, name), name


def files_of(root):
    """{name: bytes} of a store directory, snapshots as their arrays."""
    out = {}
    for name in sorted(os.listdir(root)):
        path = os.path.join(root, name)
        if name.endswith(".npz"):
            with np.load(path) as snap:
                out[name] = {k: snap[k].tolist() for k in snap.files}
        else:
            out[name] = open(path, "rb").read()
    return out


def metric_values(reg):
    out = reg.to_dict()
    out["gauges"].pop("store_recovery_seconds", None)
    return out


# ---------------------------------------------------------------------------
# the WAL
# ---------------------------------------------------------------------------


def write_log(mod, path, n=6, sync_every=2):
    w = mod.WalWriter(path)
    for i, b in enumerate(batches(7, n, 5)):
        w.append(mod.REC_TRIPLES, mod.encode_triples_payload(b))
        if i % 3 == 1:
            w.append(mod.REC_DICT, mod.encode_dict_payload(
                [(i, f"term-{i}"), (i + 1, "ünïcødé ✓")]))
        if i % sync_every == 1:
            w.sync()
    w.close()


def test_wal_bytes_identical_and_read_back_in_both(tmp_path):
    tp, jp = str(tmp_path / "t.log"), str(tmp_path / "j.log")
    write_log(twal, tp)
    write_log(jwal, jp)
    data = open(tp, "rb").read()
    assert data == open(jp, "rb").read() and len(data) > 0
    for path in (tp, jp):
        assert twal.read_wal(path) == jwal.read_wal(path)
        assert twal.read_wal(path, 3) == jwal.read_wal(path, 3)
    for mod in (twal, jwal):
        assert mod.MAGIC == 0x57414C31 and mod.HEADER_SIZE == 17
    records, _, last = twal.read_wal(tp)
    assert last == len(records) - 1
    for _seq, rec_type, payload in records:
        if rec_type == twal.REC_DICT:
            assert twal.decode_dict_payload(payload) == \
                jwal.decode_dict_payload(payload)
        else:
            np.testing.assert_array_equal(
                twal.decode_triples_payload(payload),
                jwal.decode_triples_payload(payload))


def _corrupt(data: bytes, kind: str) -> bytes:
    """The log with one fault after its first records: a torn tail, a
    flipped payload byte, a bad magic, or a record whose sequence goes
    backwards (a copy of the first record appended again)."""
    recs = list(jwal.scan_records(data))
    off = recs[3][0]
    if kind == "torn":
        return data[:off + jwal.HEADER_SIZE + 5]
    if kind == "crc":
        b = bytearray(data)
        b[off + jwal.HEADER_SIZE + 2] ^= 0xFF
        return bytes(b)
    if kind == "magic":
        b = bytearray(data)
        b[off] ^= 0x01
        return bytes(b)
    assert kind == "backward"
    first = data[:recs[1][0]]
    return data[:off] + first + data[off:]


@pytest.mark.parametrize("kind", ["torn", "crc", "magic", "backward"])
def test_scan_records_stop_rules_agree(tmp_path, kind):
    path = str(tmp_path / "w.log")
    write_log(jwal, path)
    bad = _corrupt(open(path, "rb").read(), kind)
    got = list(twal.scan_records(bad))
    assert got == list(jwal.scan_records(bad)) and len(got) == 3
    for cut in range(0, len(bad) + 1, 7):
        assert list(twal.scan_records(bad[:cut])) == \
            list(jwal.scan_records(bad[:cut]))
    open(path, "wb").write(bad)
    assert twal.read_wal(path) == jwal.read_wal(path)


@pytest.mark.parametrize("writer_pkg", ["torch", "jax"])
def test_writer_repairs_torn_tail_and_drops_unsynced(tmp_path, writer_pkg):
    """Reopening a log with a torn tail truncates it to the valid prefix
    and continues the sequence; drop_unsynced cuts back to the last
    fsync. Both packages leave the same bytes."""
    mod = twal if writer_pkg == "torch" else jwal
    sizes = {}
    for pkg, m in (("t", twal), ("j", jwal)):
        path = str(tmp_path / f"{pkg}.log")
        write_log(mod, path)
        data = open(path, "rb").read()
        open(path, "wb").write(data[:-3])           # tear the last record
        w = m.WalWriter(path)
        w.append(m.REC_TRIPLES, m.encode_triples_payload([[1, 2, 3]]))
        w.sync()
        w.append(m.REC_TRIPLES, m.encode_triples_payload([[4, 5, 6]]))
        w.drop_unsynced()
        w.append(m.REC_TRIPLES, m.encode_triples_payload([[7, 8, 9]]))
        w.sync()
        sizes[pkg] = (w.next_seq, w.synced_bytes)
        w.close()
    assert sizes["t"] == sizes["j"]
    assert open(str(tmp_path / "t.log"), "rb").read() == \
        open(str(tmp_path / "j.log"), "rb").read()
    assert twal.read_wal(str(tmp_path / "t.log")) == \
        jwal.read_wal(str(tmp_path / "j.log"))


# ---------------------------------------------------------------------------
# the store, step by step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shards", [1, 3])
def test_ingest_and_flush_sequence_matches_reference(tmp_path, shards):
    """Ingests that force flushes, a tiny base under three shards (one
    shard empty), explicit flushes, duplicates and string triples: after
    every step the stores, their directories and metrics are equal."""
    treg, jreg = MetricsRegistry(), JRegistry()
    ts = MutableTripleStore.create(str(tmp_path / "t"), num_shards=shards,
                                   overlay_limit=16, metrics=treg,
                                   device="cpu")
    js = jmut.MutableTripleStore.create(str(tmp_path / "j"),
                                        num_shards=shards, overlay_limit=16,
                                        metrics=jreg)

    def check():
        assert_same_store(ts, js)
        assert files_of(tmp_path / "t") == files_of(tmp_path / "j")
        assert metric_values(treg) == metric_values(jreg)

    check()
    tiny = np.array([[1, 1, 1], [2, 1, 2], [3, 1, 3], [4, 1, 4]], np.int32)
    for st in (ts, js):
        st.ingest(tiny)
        st.flush()
    check()
    if shards == 3:                                 # 4 keys in shards of 2
        assert ts.counts_spo.tolist() == [2, 2, 0]
    steps = [("ingest", b) for b in batches(0, 8, 20)]
    steps += [("ingest", tiny), ("flush", None), ("flush", None)]
    steps += [("terms", [("alice", "knows", "bob"), ("bob", "knows", "x")])]
    steps += [("ingest", b) for b in batches(1, 3, 40)]
    for kind, arg in steps:
        for st in (ts, js):
            if kind == "ingest":
                st.ingest(arg)
            elif kind == "flush":
                st.flush()
            else:
                st.ingest_terms(arg)
        check()
    assert ts.flush_count > 3
    assert treg.counter("store_compaction_total").value == ts.flush_count
    ts.close()
    js.close()


@pytest.mark.parametrize("direction", ["jax->torch", "torch->jax"])
def test_cross_package_reopen(tmp_path, direction):
    """A directory written by one package opens in the other to the same
    arrays and counters as when it opens in the package that wrote it."""
    writer = (jmut.MutableTripleStore if direction == "jax->torch"
              else MutableTripleStore)
    kw = {"device": "cpu"} if writer is MutableTripleStore else {}
    root = str(tmp_path / "s")
    st = writer.create(root, num_shards=3, overlay_limit=16, **kw)
    for b in batches(3, 8, 20):
        st.ingest(b)
    st.ingest_terms([("carol", "knows", "dave")])
    st.close()
    for open_kw in ({}, {"overlay_limit": 16}):
        ts = MutableTripleStore.open(root, device="cpu", **open_kw)
        ts.close()
        js = jmut.MutableTripleStore.open(root, **open_kw)
        js.close()
        assert_same_store(ts, js)
        assert ts.dictionary.terms() == js.dictionary.terms()


def _record_boundaries(root):
    with open(os.path.join(root, "MANIFEST.json")) as f:
        man = json.load(f)
    data = open(os.path.join(root, man["wal"]), "rb").read()
    bounds = [0]
    for off, _seq, _t, payload in jwal.scan_records(data, man["start_seq"]):
        bounds.append(off + jwal.HEADER_SIZE + len(payload) + 4)
    return man, data, bounds


def test_truncation_sweep_recovers_the_same_arrays(tmp_path):
    """Every record boundary and cuts inside every record (mid-header,
    mid-payload, mid-crc) of a WAL over a snapshot: both packages
    recover the same arrays, and the torn tail is repaired to the same
    bytes."""
    root = str(tmp_path / "s")
    st = MutableTripleStore.create(root, num_shards=2, overlay_limit=4096,
                                   device="cpu")
    for b in batches(4, 3, 12):
        st.ingest(b)
    st.flush()
    for b in batches(5, 4, 12):
        st.ingest(b)
    st.close()
    man, data, bounds = _record_boundaries(root)
    assert len(bounds) == 5 and bounds[-1] == len(data)
    cuts = set(bounds)
    for lo, hi in zip(bounds, bounds[1:]):
        cuts.update([lo + 3, lo + jwal.HEADER_SIZE + 1, hi - 2])
    for cut in sorted(cuts):
        stores = {}
        for pkg in ("t", "j"):
            work = str(tmp_path / f"{pkg}{cut}")
            shutil.copytree(root, work)
            with open(os.path.join(work, man["wal"]), "wb") as f:
                f.write(data[:cut])
            stores[pkg] = (MutableTripleStore.open(work, device="cpu")
                           if pkg == "t" else
                           jmut.MutableTripleStore.open(work))
            stores[pkg].close()
        assert_same_store(stores["t"], stores["j"])
        assert files_of(tmp_path / f"t{cut}") == files_of(tmp_path / f"j{cut}")


@pytest.mark.parametrize("seed", range(6))
def test_injected_crash_recovers_the_same_prefix(tmp_path, seed):
    """DurabilityFaultPlan.sample(seed) draws the reference's fault; the
    crash hits both packages at the same record, leaves the same bytes,
    and each directory recovers in both packages to the oracle over the
    acked batches."""
    tplan = tfaults.DurabilityFaultPlan.sample(seed, horizon=8)
    jplan = jfaults.DurabilityFaultPlan.sample(seed, horizon=8)
    assert [(f.record, f.torn_bytes, f.lose_unsynced) for f in tplan.faults] \
        == [(f.record, f.torn_bytes, f.lose_unsynced) for f in jplan.faults]
    ts, js = create_both(tmp_path, num_shards=2, overlay_limit=32)
    ts._wal.fault_plan, js._wal.fault_plan = tplan, jplan
    acked, msgs = [], {}
    for pkg, st, exc in (("t", ts, tfaults.SimulatedCrash),
                         ("j", js, jfaults.SimulatedCrash)):
        n = 0
        with pytest.raises(exc) as info:
            for b in batches(seed, 10, 8):
                st.ingest(b)
                n += 1
        msgs[pkg] = (str(info.value), n)
        acked = batches(seed, 10, 8)[:n]
    assert msgs["t"] == msgs["j"]
    assert files_of(tmp_path / "t") == files_of(tmp_path / "j")
    survivors = (np.concatenate(acked) if acked
                 else np.zeros((0, 3), np.int32))
    want, ovars = execute_oracle(survivors, SCAN)
    for pkg in ("t", "j"):
        root = str(tmp_path / pkg)
        t2 = MutableTripleStore.open(root, device="cpu")
        j2 = jmut.MutableTripleStore.open(root)
        assert_same_store(t2, j2)
        bnd = execute_local(t2, SCAN, caps=Caps(**CAPS))
        assert rows_set(bnd.table, bnd.valid, len(bnd.vars)) == want
        t2.close()
        j2.close()


def test_rejected_batches_and_existing_store(tmp_path):
    ts, js = create_both(tmp_path)
    for bad in (np.zeros((0, 3), np.int32), np.array([[-1, 0, 0]]),
                np.array([[0, MAX_ID + 1, 0]]),
                np.array([[MAX_ID] * 3])):
        for st in (ts, js):
            with pytest.raises(ValueError):
                st.ingest(bad)
    assert_same_store(ts, js)
    assert ts.wal_bytes == 0 and ts.n_triples == 0
    ts.close()
    js.close()
    with pytest.raises(ValueError):
        MutableTripleStore.create(str(tmp_path / "j"), device="cpu")


def test_default_device_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the error is for hosts without it")
    root = str(tmp_path / "s")
    with pytest.raises(RuntimeError, match="CUDA"):
        MutableTripleStore.create(root)
    assert not os.path.exists(root)                # refused before any write
    MutableTripleStore.create(root, device="cpu").close()
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="CUDA"):
            MutableTripleStore.open(root, **kw)


# ---------------------------------------------------------------------------
# the device merge against the reference's numpy merge
# ---------------------------------------------------------------------------


def _keys(rng, n, lo, hi):
    return np.unique(rng.randint(lo, hi, n).astype(np.int64))[:n]


def _merge_case(case, rng):
    """(base, overlay): sorted unique, disjoint int64 key arrays."""
    allk = _keys(rng, 300, 1000, 10 ** 6)
    if case == "empty base":
        return allk[:0], allk[:40]
    if case == "empty overlay":
        return allk[:200], allk[:0]
    if case == "both empty":
        return allk[:0], allk[:0]
    if case == "overlay beyond every base key":
        return allk[:200], allk[200:260]
    if case == "overlay below every base key":
        return allk[60:260], allk[:60]
    if case == "one key each":
        return allk[1:2], allk[:1]
    mask = rng.rand(len(allk)) < 0.3                  # "interleaved"
    return allk[~mask], allk[mask]


MERGE_CASES = ["empty base", "empty overlay", "both empty",
               "overlay beyond every base key",
               "overlay below every base key", "one key each", "interleaved"]


@pytest.mark.parametrize("shards", [1, 3, 8])
@pytest.mark.parametrize("case", MERGE_CASES)
def test_merge_index_matches_reference(case, shards, monkeypatch):
    base, ov = _merge_case(case, np.random.RandomState(11))
    ref = jmut.MutableTripleStore.__new__(jmut.MutableTripleStore)
    ref._num_shards = shards
    want_rows, want_splits, want_counts = ref._merge_index(base, ov)
    want_flat = np.full(want_rows.size, INF_KEY, np.int64)
    want_flat[:len(base) + len(ov)] = jmut._merge_disjoint(base, ov)

    calls = []
    real = ops.searchsorted
    monkeypatch.setattr(ops, "searchsorted", lambda k, q, *a: (
        calls.append((k.numel(), q.numel())) or real(k, q, *a)))
    layout = merge.base_layout(base, shards)
    rows, splits, counts, flat = merge.merge_index(
        torch.from_numpy(base), layout, ov)
    for got, want in ((rows, want_rows), (splits, want_splits),
                      (counts, want_counts), (flat, want_flat)):
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)
    # the INF tail is exactly the padding
    assert int((flat == INF_KEY).sum()) == flat.numel() - len(base) \
        - len(ov)
    # two rank-finds when both sides hold keys, none when one is empty
    assert calls == ([(len(ov), len(base)), (len(base), len(ov))]
                     if len(base) and len(ov) else [])
    if shards == 1:
        assert rows.data_ptr() == flat.data_ptr()   # not built twice


def test_batch_larger_than_overlay_limit_escalates_width(tmp_path):
    """One batch alone past the limit (into an empty overlay) cannot be
    flushed away: the row width escalates a grid step, as in the
    reference; the next batch flushes it."""
    ts, js = create_both(tmp_path, num_shards=3, overlay_limit=8)
    for b in batches(12, 2, 60):
        ts.ingest(b)
        js.ingest(b)
        assert_same_store(ts, js)
    assert ts.flush_count == 1 and ts.overlay_depth > 8
    assert ts.shard_cap > ts._layouts[0].cap + 8
    ts.close()
    js.close()


def test_refresh_launches_two_rank_finds_per_index(tmp_path, monkeypatch):
    """An ingest into a non-empty base rebuilds both indexes with two
    rank-finds each (4 in all); one that first flushes adds none (the
    refresh after a flush has an empty overlay)."""
    ts = MutableTripleStore.create(str(tmp_path / "s"), num_shards=2,
                                   overlay_limit=1 << 10, device="cpu")
    b0, b1, b2 = batches(13, 3, 30)
    ts.ingest(b0)
    ts.flush()
    calls = []
    real = ops.searchsorted
    monkeypatch.setattr(ops, "searchsorted", lambda k, q, *a: (
        calls.append(q.numel()) or real(k, q, *a)))
    ts.ingest(b1)
    assert len(calls) == 4
    ts.overlay_limit = 1
    calls.clear()
    ts.ingest(b2)
    assert ts.flush_count == 2 and len(calls) == 4
    ts.close()


# ---------------------------------------------------------------------------
# the serving engine and the planner over a mutable store
# ---------------------------------------------------------------------------


def _rows(bnd, ovars):
    """The row set of either package's Bindings, columns in `ovars`."""
    rs = rows_set if isinstance(bnd.table, torch.Tensor) else jcore.rows_set
    got = rs(bnd.table, bnd.valid, len(bnd.vars))
    if tuple(bnd.vars) != tuple(ovars):
        perm = [list(bnd.vars).index(v) for v in ovars]
        got = set(tuple(r[i] for i in perm) for r in got)
    return got


def test_engine_never_reuses_preingest_cascade(tmp_path):
    treg, jreg = MetricsRegistry(), JRegistry()
    ts = MutableTripleStore.create(str(tmp_path / "t"), num_shards=1,
                                   overlay_limit=4096, metrics=treg,
                                   device="cpu")
    js = jmut.MutableTripleStore.create(str(tmp_path / "j"), num_shards=1,
                                        overlay_limit=4096, metrics=jreg)
    first = np.array([[1, 1, 2], [2, 2, 3]], np.int32)
    ts.ingest(first)
    js.ingest(first)
    teng = ServeEngine(ts, caps=Caps(**CAPS), metrics=treg)
    jeng = JEngine(js, caps=jcore.Caps(**CAPS), metrics=jreg)
    pats = list(JOIN)
    miss = "serve_compile_cache_misses_total"
    want = {(1, 2, 3)}
    for step in range(3):
        if step == 2:
            for st in (ts, js):
                st.ingest(np.array([[5, 1, 2]], np.int32))
            want = {(1, 2, 3), (5, 2, 3)}
        misses = treg.counter(miss).value
        tres, jres = teng.execute([pats])[0], jeng.execute([pats])[0]
        assert tres.rows_set(("?x", "?y", "?z")) == want
        assert jres.rows_set(("?x", "?y", "?z")) == want
        assert treg.counter(miss).value == jreg.counter(miss).value
        # a repeat without mutation reuses the cascade; the post-ingest
        # submit compiles a new one
        assert (treg.counter(miss).value > misses) == (step != 1)
    ts.close()
    js.close()


def test_plan_cache_and_relstats_invalidated_on_mutation(tmp_path):
    ts, js = create_both(tmp_path, num_shards=1)
    b = batches(9, 1, 40)[0]
    ts.ingest(b)
    js.ingest(b)
    pat = Pattern("?x", 1, "?y")
    card1, stats1 = pattern_cardinality(ts, pat), relation_stats(ts, pat, ())
    assert card1 == j_card(js, pat)
    assert stats1 == j_relstats(js, pat, ())
    assert ("card", pat) in ts.plan_cache
    extra = np.array([[25, 1, 26], [26, 1, 27]], np.int32)
    ts.ingest(extra)
    js.ingest(extra)
    assert ("card", pat) not in ts.plan_cache      # wholesale clear
    card2, stats2 = pattern_cardinality(ts, pat), relation_stats(ts, pat, ())
    assert card2 == card1 + 2 == j_card(js, pat)
    assert stats2[0] == stats1[0] + 2 and stats2 == j_relstats(js, pat, ())
    ts.close()
    js.close()


def test_stale_plan_still_exact_after_mutation(tmp_path):
    ts, js = create_both(tmp_path, num_shards=1)
    acked = [batches(10, 1, 40)[0], batches(11, 1, 40)[0]]
    ts.ingest(acked[0])
    js.ingest(acked[0])
    stale = compile_plan(ts, JOIN, Caps(**CAPS))
    jstale = jcore.compile_plan(js, JOIN, jcore.Caps(**CAPS))
    ts.ingest(acked[1])
    js.ingest(acked[1])
    want, ovars = execute_oracle(np.concatenate(acked), JOIN)
    got = _rows(execute_local(ts, stale), ovars)
    assert got == want and len(want) > 0
    assert got == _rows(jcore.execute_local(js, jstale), ovars)
    ts.close()
    js.close()


def test_dictionary_grows_durably(tmp_path):
    ts, js = create_both(tmp_path, num_shards=1, overlay_limit=8)
    for st in (ts, js):
        st.ingest_terms([("alice", "knows", "bob"), ("bob", "knows", "carol")])
        st.ingest_terms([("carol", "knows", "alice"),
                         ("alice", "likes", "jazz")])
        st.flush()                                 # terms fold into snapshot
        st.ingest_terms([("dave", "knows", "alice")])   # terms in the new WAL
        st.close()
    assert files_of(tmp_path / "t") == files_of(tmp_path / "j")
    t2 = MutableTripleStore.open(str(tmp_path / "t"), device="cpu")
    j2 = jmut.MutableTripleStore.open(str(tmp_path / "j"))
    terms = ts.dictionary.terms()
    assert t2.dictionary.terms() == j2.dictionary.terms() == terms
    assert_same_store(t2, j2)
    pats = (t2.dictionary.pattern("?a", "knows", "?b"),)
    want, ovars = execute_oracle(t2.dictionary.encode_triples(
        [("alice", "knows", "bob"), ("bob", "knows", "carol"),
         ("carol", "knows", "alice"), ("dave", "knows", "alice")]), pats)
    teng = ServeEngine(t2, t2.dictionary, caps=Caps(**CAPS), metrics=False)
    jeng = JEngine(j2, j2.dictionary, caps=jcore.Caps(**CAPS), metrics=False)
    text = "SELECT ?a ?b WHERE { ?a <knows> ?b . }"
    assert teng.execute([text])[0].rows_set(ovars) == want and len(want) == 4
    assert jeng.execute([text])[0].rows_set(ovars) == want
    assert _rows(execute_local(t2, pats, caps=Caps(**CAPS)), ovars) == want
    t2.close()
    j2.close()


@pytest.mark.gpu
def test_cuda_store_matches_cpu_and_launches_the_kernel(tmp_path):
    """On the card: the same sequence into a CUDA and a CPU store gives
    the same arrays, and an ingest whose refresh has a base and an
    overlay launches the searchsorted kernel twice per index (none while
    the base is empty)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cu = MutableTripleStore.create(str(tmp_path / "c"), num_shards=3,
                                   overlay_limit=64, device="cuda")
    cp = MutableTripleStore.create(str(tmp_path / "p"), num_shards=3,
                                   overlay_limit=64, device="cpu")
    merged = 0
    for b in batches(14, 12, 30):
        ops.reset_launches()
        cu.ingest(b)
        cp.ingest(b)
        both = len(cp._bk_spo) > 0 and len(cp._ov_spo) > 0
        assert ops.launches["searchsorted"] == (4 if both else 0)
        merged += both
        for name in ARRAYS:
            assert torch.equal(getattr(cu, name).cpu(), getattr(cp, name))
        for index in (0, 1):
            assert torch.equal(cu.flat_keys(index).cpu(), cp.flat_keys(index))
    assert cu.flush_count > 0 and merged > 0
    cu.close()
    cp.close()
