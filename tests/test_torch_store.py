"""The port's store, key packing and probe ranges against the JAX package.

Same numpy inputs into both packages; every output is integer and must be
bit-identical."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as jcore
from repro.core import plan as jplan
from repro.core import rdf as jrdf
from repro.data import lubm_like as j_lubm, sp2b_like as j_sp2b

from repro_torch.core import plan as tplan
from repro_torch.core import rdf as trdf
from repro_torch.core.triple_store import (LRUCache, build_store,
                                           range_intersects_region,
                                           store_from_numpy)
from repro_torch.data import lubm_like as t_lubm, sp2b_like as t_sp2b

MAX_ID = trdf.MAX_ID
EDGE_IDS = [0, MAX_ID - 1, MAX_ID]
ARRAYS = ("keys_spo", "keys_ops", "splits_spo", "splits_ops", "counts_spo",
          "counts_ops")


def _assert_same_store(ts, js):
    for name in ARRAYS:
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)),
                                      err_msg=name)
        assert getattr(ts, name).dtype == torch.int64
    assert ts.n_triples == js.n_triples
    assert ts.layout_key == js.layout_key


@pytest.mark.parametrize("shards", [1, 3, 8])
@pytest.mark.parametrize("gen", ["lubm", "sp2b"])
def test_build_store_matches_reference(gen, shards):
    if gen == "lubm":
        tr, d, _ = t_lubm(1)
        trj, dj, _ = j_lubm(1)
    else:
        tr, d, _ = t_sp2b(300)
        trj, dj, _ = j_sp2b(300)
    np.testing.assert_array_equal(tr, trj)      # same generator, same seed
    assert d.terms() == dj.terms()
    ts = build_store(tr, num_shards=shards, device="cpu")
    js = jcore.build_store(trj, num_shards=shards)
    _assert_same_store(ts, js)
    assert ts.num_shards == shards and ts.shard_cap == js.shard_cap
    assert ts.storage_bytes() == js.storage_bytes()


def test_store_from_numpy_round_trip():
    tr, _, _ = j_sp2b(120)
    js = jcore.build_store(tr, num_shards=3)
    js.bump_version()
    ts = store_from_numpy(*(np.asarray(getattr(js, a)) for a in ARRAYS),
                          js.n_triples, store_version=js.store_version,
                          device="cpu")
    _assert_same_store(ts, js)
    assert ts.store_version == 1
    for index in (0, 1):
        np.testing.assert_array_equal(ts.flat_keys(index).numpy(),
                                      np.asarray(js.flat_keys(index)))


def test_build_store_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the error is for hosts without it")
    tr = np.asarray([[1, 2, 3]], np.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_store(tr)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_store(tr, device="cuda")


def test_inf_key_collision_rejected():
    with pytest.raises(ValueError):
        build_store(np.asarray([[MAX_ID] * 3], np.int32), device="cpu")


def test_bump_version_clears_caches():
    ts = build_store(np.asarray([[1, 2, 3], [4, 5, 6]], np.int32), device="cpu")
    key0 = ts.layout_key
    ts.flat_keys(0)
    assert len(ts.plan_cache) == 2
    assert ts.bump_version() == 1
    assert len(ts.plan_cache) == 0 and ts.layout_key != key0


def test_lru_cache_evicts_coldest():
    c = LRUCache(2)
    c["a"], c["b"] = 1, 2
    assert c["a"] == 1                   # refresh "a"
    c["c"] = 3
    assert list(c) == ["a", "c"]
    with pytest.raises(ValueError):
        LRUCache(0)


@pytest.mark.parametrize("seed", range(3))
def test_pack_unpack_match_reference(seed):
    rng = np.random.RandomState(seed)
    a, b, c = (rng.randint(0, MAX_ID + 1, 500) for _ in range(3))
    want = np.asarray(jrdf.pack3(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c)))
    got = trdf.pack3(torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(c))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(trdf.pack3(a, b, c), want)      # numpy path
    for g, w in zip(trdf.unpack3(got), jrdf.unpack3(jnp.asarray(want))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _ranges_both(pattern, table, domain):
    tp = tplan.make_plan(trdf.pattern_from(pattern), domain)
    jp = jplan.make_plan(pattern, domain)
    assert tp.index == jp.index and tp.prefix == jp.prefix
    assert tp.residual == jp.residual and tp.out_vars == jp.out_vars
    assert tp.eq_positions == jp.eq_positions and tp.is_scan == jp.is_scan
    tt = torch.as_tensor(table, dtype=torch.int32)
    jt = jnp.asarray(table, jnp.int32)
    return tp, jp, tt, jt


@pytest.mark.parametrize("v", EDGE_IDS)
@pytest.mark.parametrize("shape", ["prefix1", "prefix2", "prefix3",
                                   "var_prefix", "scan"])
def test_probe_ranges_match_reference_at_edges(shape, v):
    pattern, domain = {
        "prefix1": (jrdf.Pattern(v, "?p", "?o"), ()),
        "prefix2": (jrdf.Pattern(v, v, "?o"), ()),
        "prefix3": (jrdf.Pattern(v, v, v), ()),
        "var_prefix": (jrdf.Pattern("?x", 9, "?z"), ("?x",)),
        "scan": (jrdf.Pattern("?s", 4, "?o"), ()),
    }[shape]
    table = np.full((3, len(domain)), v, np.int32)
    tp, jp, tt, jt = _ranges_both(pattern, table, domain)
    for got, want in zip(tplan.probe_ranges(tp, tt), jplan.probe_ranges(jp, jt)):
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    flt_t, msk_t = tplan.residual_values(tp, tt)
    flt_j, msk_j = jplan.residual_values(jp, jt)
    assert msk_t == msk_j
    np.testing.assert_array_equal(flt_t.numpy(), np.asarray(flt_j))
    if tp.prefix:
        for got, want in zip(tplan.row_range(tp, tt), jplan.row_range(jp, jt)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shift", [0, 21, 42])
def test_next_prefix_saturates_like_reference(shift):
    lo = np.array([0, 1, MAX_ID << 42, (MAX_ID << 42) | (MAX_ID << 21),
                   trdf.INF_KEY - (1 << shift), trdf.INF_KEY - (1 << shift) + 1,
                   trdf.INF_KEY], np.int64)
    got = tplan.next_prefix(torch.as_tensor(lo), shift).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jplan.next_prefix(jnp.asarray(lo), shift)))
    assert got[-1] == trdf.INF_KEY


def test_range_intersects_region_on_tensors():
    rng = np.random.RandomState(4)
    lo = np.sort(rng.randint(0, 1000, 50)).astype(np.int64)
    hi = lo + rng.randint(0, 50, 50)
    splits = np.array([-1, 200, 500, 999, trdf.INF_KEY], np.int64)
    want = jcore.triple_store.range_intersects_region(
        lo[:, None], hi[:, None], splits[None, :-1], splits[None, 1:])
    got = range_intersects_region(
        torch.as_tensor(lo)[:, None], torch.as_tensor(hi)[:, None],
        torch.as_tensor(splits)[None, :-1], torch.as_tensor(splits)[None, 1:])
    np.testing.assert_array_equal(got.numpy(), want)


def test_dictionary_matches_reference():
    td, jd = trdf.Dictionary(), jrdf.Dictionary()
    triples = [("a", "p", "b"), ("b", "p", "c"), ("a", "q", "a")]
    np.testing.assert_array_equal(td.encode_triples(triples),
                                  jd.encode_triples(triples))
    assert td.terms() == jd.terms() and td.lookup("zz") is None
    td.replay_term(5, "d")
    td.replay_term(5, "d")                       # idempotent
    with pytest.raises(ValueError):
        td.replay_term(0, "not-a")
    assert td.pattern("?x", "p", "c") == trdf.pattern_from(jd.pattern("?x", "p", "c"))
