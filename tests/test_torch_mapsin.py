"""The port's MAPSIN operators, fuzzed against the JAX package's jnp path.

Each operator gets the same numpy inputs in both packages; tables, masks
and overflow counters must be bit-identical (match keys compared where
valid: the jnp path leaves clamped-gather keys in invalid slots, the
port's probe writes 0 there). The reference operators run under
``jax.jit``, as the JAX package's cascade runs them: one compile per
static setting and shape instead of one per primitive."""
import functools

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as jcore
from repro.core import mapsin as jms
from repro.core import plan as jplan
from repro.core import reduce_side as jrs
from repro.core.rdf import Pattern

from repro_torch.core import mapsin as tms
from repro_torch.core import plan as tplan
from repro_torch.core import reduce_side as trs
from repro_torch.core.rdf import pattern_from
from repro_torch.core.triple_store import build_store

P = 100  # predicate ids 100..103


def _stores(seed, n=400, ids=25):
    """`n` distinct random triples: the index has one shape for every
    seed, so the reference compiles once per static setting."""
    rng = np.random.RandomState(seed)
    code = rng.choice(ids * 4 * ids, n, replace=False)
    s, p, o = np.unravel_index(code, (ids, 4, ids))
    tr = np.stack([s, p + P, o], 1).astype(np.int32)
    return tr, build_store(tr, device="cpu"), jcore.build_store(tr)


def _bindings(vars, table, valid, overflow=0):
    t = tms.Bindings(tuple(vars), torch.as_tensor(table, dtype=torch.int32),
                     torch.as_tensor(valid), torch.tensor(overflow,
                                                          dtype=torch.int32))
    j = jms.Bindings(tuple(vars), jnp.asarray(table, jnp.int32),
                     jnp.asarray(valid), jnp.asarray(overflow, jnp.int32))
    return t, j


@functools.cache
def _jit(fn, static):
    """The reference operator `fn` under jax.jit, with the positional
    arguments `static` (patterns, plans, caps) static."""
    return jax.jit(fn, static_argnums=static)


def _same(tb, jb):
    assert tb.vars == tuple(jb.vars)
    assert tb.table.dtype == torch.int32 and tb.valid.dtype == torch.bool
    assert tb.overflow.dtype == torch.int32 and tb.overflow.dim() == 0
    np.testing.assert_array_equal(tb.table.numpy(), np.asarray(jb.table))
    np.testing.assert_array_equal(tb.valid.numpy(), np.asarray(jb.valid))
    assert int(tb.overflow) == int(jb.overflow)


@pytest.mark.parametrize("n,nv,out_cap,p", [(0, 2, 8, 0.5), (50, 2, 8, 0.5),
                                            (50, 3, 64, 0.3), (300, 0, 16, 0.7),
                                            (200, 1, 256, 1.0)])
def test_compact(n, nv, out_cap, p):
    rng = np.random.RandomState(n + nv)
    rows = rng.randint(-5, 100, (n, nv)).astype(np.int32)
    valid = rng.rand(n) < p
    got = tms.compact(torch.as_tensor(rows), torch.as_tensor(valid), out_cap)
    want = _jit(jms.compact, (2,))(jnp.asarray(rows), jnp.asarray(valid),
                                   out_cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2].dtype == torch.int32


SCANS = [Pattern("?x", P + 1, "?y"), Pattern("?x", "?p", "?x"),
         Pattern(5, "?p", "?o"), Pattern("?s", "?p", "?o"),
         Pattern("?x", P + 1, 7), Pattern("?s", "?p", 3)]


@pytest.mark.parametrize("pat", SCANS, ids=str)
@pytest.mark.parametrize("out_cap", [8, 512])
def test_scan_pattern(pat, out_cap):
    _, ts, js = _stores(1)
    for index in (0, 1):
        got = tms.scan_pattern(pattern_from(pat), ts.flat_keys(index), out_cap,
                               impl="torch")
        want = _jit(jms.scan_pattern, (0, 2))(pat, js.flat_keys(index),
                                              out_cap)
        _same(got, want)


PROBES = [(Pattern("?x", P + 1, "?y"), ("?x",)),
          (Pattern("?y", P + 2, "?z"), ("?x", "?y")),
          (Pattern("?z", "?p", "?x"), ("?x",)),        # OPS index, residual
          (Pattern("?x", P, "?x"), ("?w",)),           # cartesian + eq
          (Pattern("?x", P + 3, 4), ("?x",)),          # prefix 3
          (Pattern("?a", "?p", "?x"), ("?x", "?a"))]   # residual-only prefix


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("pat,domain", PROBES, ids=lambda x: str(x))
def test_probe_and_merge(seed, pat, domain):
    tr, ts, js = _stores(seed)
    rng = np.random.RandomState(seed + 10)
    b, cap, out_cap = 40, 8, 128     # one shape for both seeds
    table = rng.randint(0, 27, (b, len(domain))).astype(np.int32)
    valid = rng.rand(b) < 0.8
    tb, jb = _bindings(domain, table, valid, overflow=3)
    tp = tplan.make_plan(pattern_from(pat), domain)
    jp = jplan.make_plan(pat, domain)
    tk, tm, tmiss = tms.probe(tp, ts.flat_keys(tp.index), tb.table, tb.valid,
                              cap, impl="torch")
    jk, jm, jmiss = jms.probe(jp, js.flat_keys(jp.index), jb.table, jb.valid,
                              cap)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(
        tk.numpy(), np.where(np.asarray(jm), np.asarray(jk), 0))
    np.testing.assert_array_equal(tmiss.numpy(), np.asarray(jmiss))
    # the merge on identical inputs, and the whole step
    for oc in (out_cap, 8):
        _same(tms.merge_bindings(tb, tp, tk, tm, tmiss, oc),
              jms.merge_bindings(jb, jp, jk, jm, jmiss, oc))
        _same(tms.mapsin_step(tb, pattern_from(pat), ts.flat_keys(tp.index),
                              cap, oc, impl="torch"),
              jms.mapsin_step(jb, pat, js.flat_keys(jp.index), cap, oc))


STARS = [(Pattern("?x", P + 1, "?a"), Pattern("?x", P + 2, "?b")),
         (Pattern("?x", P + 1, "?a"), Pattern("?x", P + 3, 4),
          Pattern("?x", "?q", "?c")),
         (Pattern("?x", P, "?x"), Pattern("?x", P + 2, "?b"))]


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("star", STARS, ids=lambda s: f"{len(s)}pats")
@pytest.mark.parametrize("row_cap,out_cap", [(8, 256), (4, 16)])
def test_multiway_step(seed, star, row_cap, out_cap):
    _, ts, js = _stores(seed, ids=15)
    rng = np.random.RandomState(seed + 20)
    b = 30
    table = rng.randint(0, 16, (b, 1)).astype(np.int32)
    valid = rng.rand(b) < 0.8
    tb, jb = _bindings(("?x",), table, valid)
    got = tms.multiway_step(tb, [pattern_from(p) for p in star],
                            ts.flat_keys(0), row_cap, out_cap, impl="torch")
    want = _jit(jms.multiway_step, (1, 3, 4))(jb, tuple(star),
                                              js.flat_keys(0), row_cap, out_cap)
    _same(got, want)


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("pat", [Pattern("?y", P + 2, "?z"),
                                 Pattern("?z", P + 1, "?x"),
                                 Pattern("?x", "?q", "?y")], ids=str)
@pytest.mark.parametrize("probe_cap,out_cap", [(8, 512), (2, 32)])
def test_local_reduce_step(seed, pat, probe_cap, out_cap):
    _, ts, js = _stores(seed)
    first = Pattern("?x", P + 1, "?y")
    tb = tms.scan_pattern(pattern_from(first), ts.flat_keys(0), 256)
    index = tplan.make_plan(pattern_from(pat), ()).index
    got = trs.local_reduce_step(tb, pattern_from(pat), ts.flat_keys(index),
                                512, probe_cap, out_cap)
    jb = _jit(jms.scan_pattern, (0, 2))(first, js.flat_keys(0), 256)
    want = _jit(jrs.local_reduce_step, (1, 3, 4, 5))(
        jb, pat, js.flat_keys(index), 512, probe_cap, out_cap)
    _same(got, want)


def test_sort_merge_join_is_stable():
    """Equal join keys keep their row order (jnp.argsort is stable)."""
    lt = np.array([[1, 0], [2, 0]], np.int32)
    rt = np.array([[2, 9], [1, 8], [2, 7], [1, 6], [2, 5]], np.int32)
    lv, rv = np.ones(2, bool), np.array([1, 1, 1, 1, 0], bool)
    got = trs.sort_merge_join(torch.as_tensor(lt), torch.as_tensor(lv),
                              torch.as_tensor(rt), torch.as_tensor(rv), 0, 0,
                              [], [1], 4, 8)
    want = jax.jit(lambda a, b, c, d: jrs.sort_merge_join(
        a, b, c, d, 0, 0, [], [1], 4, 8))(jnp.asarray(lt), jnp.asarray(lv),
                                          jnp.asarray(rt), jnp.asarray(rv))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0][:4, 2].tolist() == [8, 6, 9, 7]


def _slots(seed, n_slots=3, b=20):
    """`n_slots` binding tables over (?k, ?x): ?k a predicate id, as a
    template's constant slot is a bound column."""
    rng = np.random.RandomState(seed)
    table = np.stack([rng.randint(P, P + 4, (n_slots, b)),
                      rng.randint(0, 25, (n_slots, b))], -1).astype(np.int32)
    return (torch.as_tensor(table), torch.as_tensor(rng.rand(n_slots, b) < 0.8),
            torch.zeros(n_slots, dtype=torch.int32))


def _per_slot_equal(step, slots):
    """`step` (Bindings -> Bindings) under torch.func.vmap over the slots
    equals `step` on each slot alone."""
    table, valid, ovf = slots
    vars_ = ("?k", "?x")

    def one(t, v, o):
        out = step(tms.Bindings(vars_, t, v, o))
        return out.table, out.valid, out.overflow

    got = torch.func.vmap(one)(table, valid, ovf)
    for i in range(table.shape[0]):
        want = one(table[i], valid[i], ovf[i])
        for g, w in zip(got, want):
            assert torch.equal(g[i], w)


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_multiway_step_vmaps_with_a_slot_in_the_prefix(impl):
    """A template's constant slot is a bound column, so it can be a
    secondary prefix component of a star pattern: its filter column is
    per slot, which an in-place write into a shared zero tensor cannot
    hold under vmap."""
    _, ts, _ = _stores(0)
    star = [Pattern("?x", "?k", "?a"), Pattern("?x", P + 1, "?b")]
    _per_slot_equal(lambda bnd: tms.multiway_step(
        bnd, [pattern_from(p) for p in star], ts.flat_keys(0), 8, 64, impl),
        _slots(1))


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_mapsin_step_vmaps_with_a_slot_residual(impl):
    """The slot as a residual filter (residual_values) under vmap."""
    _, ts, _ = _stores(0)
    pat = pattern_from(Pattern("?x", "?q", "?k"))
    _per_slot_equal(lambda bnd: tms.mapsin_step(
        bnd, pat, ts.flat_keys(0), 8, 64, impl), _slots(2))
