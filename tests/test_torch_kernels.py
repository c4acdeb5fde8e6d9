"""The port's kernels' plain versions against the JAX package's Pallas
kernels (interpret mode) and jnp path, and the dispatch rules.

The cases mirror tests/test_kernels_searchsorted.py and
tests/test_probe_gather.py at small sizes; all outputs are integers and
must be bit-identical. The CUDA kernels themselves run only on a card:
their case is marked ``gpu`` and skips elsewhere."""
import functools

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro  # noqa: F401  (enables x64 for the reference)
from repro.core import reduce_side as jrs
from repro.core.mapsin import apply_residual as j_apply_residual
from repro.core.mapsin import gather_range as j_gather_range
from repro.core.rdf import BITS, MAX_ID, pack3
from repro.kernels import ops as jops

from repro_torch.core import reduce_side as trs
from repro_torch.core.bgp import ExecConfig
from repro_torch.kernels import ops
from repro_torch.kernels.probe_gather import (multiway_compact_cuda,
                                              probe_compact_cuda,
                                              probe_gather_cuda,
                                              sort_merge_compact_cuda)
from repro_torch.kernels.searchsorted import searchsorted_cuda

T = torch.as_tensor


@pytest.mark.parametrize("m,q", [(1, 1), (100, 7), (1000, 257), (5000, 333)])
def test_searchsorted_plain_matches_reference(m, q, rng):
    keys = np.sort(pack3(rng.randint(0, 2000, m), rng.randint(0, 50, m),
                         rng.randint(0, 2000, m)))
    qs = pack3(rng.randint(0, 2100, q), rng.randint(0, 55, q),
               rng.randint(0, 2100, q))
    got = ops.searchsorted(T(keys), T(qs))
    assert got.dtype == torch.int64
    pallas = np.asarray(jops.searchsorted(jnp.asarray(keys), jnp.asarray(qs)))
    np.testing.assert_array_equal(got.numpy(), pallas)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jnp.searchsorted(jnp.asarray(keys),
                                                 jnp.asarray(qs))))


def test_searchsorted_boundary_duplicates_and_sentinels():
    inf = np.iinfo(np.int64).max
    keys = np.array([5, 5, 5, 7, 7, 9, inf, inf], np.int64)
    qs = np.array([0, 4, 5, 6, 7, 8, 9, 10, inf], np.int64)
    got = ops.searchsorted(T(keys), T(qs)).numpy()
    np.testing.assert_array_equal(got, np.searchsorted(keys, qs))
    np.testing.assert_array_equal(
        got, np.asarray(jops.searchsorted(jnp.asarray(keys), jnp.asarray(qs),
                                          block_k=64, block_q=32)))


def _both(keys, lo, hi, flt, msk, eq, cap):
    """(port plain, Pallas interpret, jnp path with 0 at invalid slots)."""
    got = ops.probe_gather(T(keys), T(lo), T(hi), T(flt), cap, msk, eq)
    pallas = jops.probe_gather(jnp.asarray(keys), jnp.asarray(lo),
                               jnp.asarray(hi), jnp.asarray(flt), cap=cap,
                               flt_mask=msk, eq_positions=eq)
    k, valid, missed = j_gather_range(jnp.asarray(keys), jnp.asarray(lo),
                                      jnp.asarray(hi), cap)
    valid = j_apply_residual(k, valid, jnp.asarray(flt), msk, eq)
    ref = (jnp.where(valid, k, 0), valid, missed)
    return got, pallas, ref


def _check(keys, lo, hi, flt, msk, eq, cap):
    got, pallas, ref = _both(keys, lo, hi, flt, msk, eq, cap)
    assert got[0].dtype == torch.int64 and got[1].dtype == torch.bool
    assert got[2].dtype == torch.int32
    for want in (pallas, ref):
        for g, w, what in zip(got, want, ("keys", "valid", "missed")):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=what)
    return got


@pytest.mark.parametrize("seed", range(5))
def test_probe_gather_random_equivalence(seed):
    rng = np.random.RandomState(seed)
    m, b = 1000, 96           # one shape for every seed: one compile each
    cap = int(rng.choice([1, 2, 8, 16]))
    keys = np.sort(pack3(rng.randint(0, 40, m), rng.randint(0, 6, m),
                         rng.randint(0, 40, m)))
    v = rng.randint(0, 45, b).astype(np.int64)
    z = np.zeros(b, np.int64)
    lo, hi = pack3(v, z, z), pack3(v + 1, z, z)
    p2 = rng.randint(0, 6, b).astype(np.int64)
    two = rng.rand(b) < 0.3
    lo = np.where(two, pack3(v, p2, z), lo)
    hi = np.where(two, pack3(v, p2 + 1, z), hi)
    empty = rng.rand(b) < 0.2
    lo, hi = np.where(empty, 0, lo), np.where(empty, 0, hi)
    flt = np.zeros((b, 3), np.int64)
    flt[:, 2] = rng.randint(0, 40, b)
    flt[:, 1] = rng.randint(0, 6, b)
    msk = (False, bool(seed % 3 == 2), bool(seed % 2))
    _check(keys, lo, hi, flt, msk, (), cap)


def test_probe_gather_fat_row_overflow():
    n = 500
    keys = np.sort(pack3(np.zeros(n, np.int64), np.arange(n) % 3,
                         np.arange(n) % 170))
    z = np.zeros(4, np.int64)
    lo = pack3(z, z, z)
    hi = pack3(np.ones(4, np.int64), z, z)
    got = _check(keys, lo, hi, np.zeros((4, 3), np.int64), (False,) * 3, (), 8)
    assert int(got[2].min()) > 0                     # the spill is surfaced


def test_probe_gather_empty_and_degenerate_ranges():
    keys = np.sort(pack3(np.array([1, 1, 2, 5]), np.array([0, 1, 0, 2]),
                         np.array([3, 4, 5, 6])))
    lo = np.array([0, pack3(3, 0, 0), pack3(9, 0, 0), pack3(2, 0, 0)], np.int64)
    hi = np.array([0, pack3(4, 0, 0), pack3(10, 0, 0), pack3(1, 0, 0)], np.int64)
    _check(keys, lo, hi, np.zeros((4, 3), np.int64), (False,) * 3, (), 4)


def _distinct_keys(rng, sizes, n):
    """`n` distinct sorted keys with fields below `sizes`: the same count
    for every seed, so the reference compiles once per static option."""
    code = np.sort(rng.choice(int(np.prod(sizes)), n, replace=False))
    s, p, o = np.unravel_index(code, sizes)
    return pack3(s.astype(np.int64), p.astype(np.int64), o.astype(np.int64))


@pytest.mark.parametrize("eq", [((0, 2),), ((0, 1),), ((1, 2),),
                                ((0, 1), (0, 2))])
def test_probe_gather_eq_positions(eq):
    rng = np.random.RandomState(7)
    keys = _distinct_keys(rng, (6, 6, 6), 150)
    b = 30
    v = rng.randint(0, 7, b).astype(np.int64)
    z = np.zeros(b, np.int64)
    got = _check(keys, pack3(v, z, z), pack3(v + 1, z, z),
                 np.zeros((b, 3), np.int64), (False,) * 3, eq, 16)
    assert bool(got[1].any())


@pytest.mark.parametrize("fm", range(8))
def test_probe_gather_all_filter_masks(fm):
    rng = np.random.RandomState(11 + fm)
    keys = _distinct_keys(rng, (20, 4, 5), 300)
    b = 40
    lo = np.where(rng.rand(b) < 0.8, 0, pack3(rng.randint(0, 20, b), 0, 0))
    hi = np.full(b, np.iinfo(np.int64).max)      # whole-index ranges
    flt = np.stack([rng.randint(0, 20, b), rng.randint(0, 4, b),
                    rng.randint(0, 5, b)], 1).astype(np.int64)
    msk = tuple(bool(fm >> i & 1) for i in range(3))
    _check(keys, lo.astype(np.int64), hi, flt, msk, (), 64)


def test_dispatch_on_the_cpu_uses_the_plain_versions():
    keys = T(np.arange(0, 100, 3, dtype=np.int64))
    q = T(np.array([0, 4, 99], np.int64))
    before = dict(ops.launches)
    np.testing.assert_array_equal(ops.searchsorted(keys, q, "kernel").numpy(),
                                  ops.searchsorted(keys, q, "torch").numpy())
    flt = torch.zeros((3, 3), dtype=torch.int64)
    a = ops.probe_gather(keys, q, q + 10, flt, 4, impl="kernel")
    b = ops.probe_gather(keys, q, q + 10, flt, 4, impl="torch")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert ops.launches == before                # no kernel ran
    with pytest.raises(ValueError):
        ops.searchsorted(keys, q, "pallas")
    with pytest.raises(ValueError):
        ExecConfig(impl="jnp")


def test_cuda_wrappers_reject_host_tensors():
    keys = torch.arange(10, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        searchsorted_cuda(keys, keys)
    with pytest.raises(ValueError, match="CUDA"):
        probe_gather_cuda(keys, keys, keys, torch.zeros((10, 3),
                                                        dtype=torch.int64), 8)
    with pytest.raises(ValueError, match="CUDA"):
        probe_compact_cuda(keys, keys[None], keys[None],
                           torch.zeros((1, 10, 3), dtype=torch.int64),
                           torch.zeros((1, 10, 2), dtype=torch.int32), 8, 16)
    flt = torch.zeros((1, 10, 3), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        multiway_compact_cuda(keys, keys[None], keys[None], flt, flt,
                              torch.zeros((1, 10), dtype=torch.int32),
                              torch.zeros((1, 10, 2), dtype=torch.int32),
                              torch.ones((1, 10), dtype=torch.bool), 8, 16)


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [8, 33, 128])
def test_cuda_kernels_match_plain(cap):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.RandomState(cap)
    m, b = 20000, 700
    keys = np.unique(pack3(rng.randint(0, 500, m), rng.randint(0, 5, m),
                           rng.randint(0, 9, m)))
    v = rng.randint(0, 505, b).astype(np.int64)
    z = np.zeros(b, np.int64)
    lo, hi = pack3(v, z, z), pack3(v + 1, z, z)
    lo[::7], hi[::7] = 0, 0
    hi[3::11] = lo[3::11] - 1
    flt = np.stack([v, rng.randint(0, 5, b), rng.randint(0, 9, b)], 1)
    dev = torch.device("cuda")
    tk, tl, th, tf = (T(x, device=dev) for x in (keys, lo, hi, flt))
    np.testing.assert_array_equal(
        ops.searchsorted(tk, tl, "kernel").cpu().numpy(),
        ops.searchsorted(tk, tl, "torch").cpu().numpy())
    for fm in range(8):
        msk = tuple(bool(fm >> i & 1) for i in range(3))
        for eq in ((), ((1, 2),)):
            got = ops.probe_gather(tk, tl, th, tf, cap, msk, eq, "kernel")
            want = ops.probe_gather(tk, tl, th, tf, cap, msk, eq, "torch")
            for g, w in zip(got, want):
                assert torch.equal(g, w)


def _fold_inputs(n=3, b=40, seed=5):
    rng = np.random.RandomState(seed)
    keys = np.unique(pack3(rng.randint(0, 60, 3000), rng.randint(0, 4, 3000),
                           rng.randint(0, 9, 3000)))
    v = rng.randint(0, 62, (n, b)).astype(np.int64)
    z = np.zeros_like(v)
    lo, hi = pack3(v, z, z), pack3(v + 1, z, z)
    flt = np.stack([v, rng.randint(0, 4, (n, b)), rng.randint(0, 9, (n, b))],
                   -1)
    return T(keys), T(lo), T(hi), T(flt)


@pytest.mark.parametrize("bdim", [0, 1])
def test_vmap_folds_the_batch_into_one_call(bdim):
    """vmap over the index ops equals the calls slot by slot, and each
    vmapped call is folded once (one launch on a card) whatever the batch
    dim's position."""
    keys, lo, hi, flt = _fold_inputs()
    n = lo.shape[0]
    mv = lambda x: x.movedim(0, bdim).contiguous()
    before = dict(ops.vmap_folds), dict(ops.launches)
    got = torch.func.vmap(lambda q: ops.searchsorted(keys, q),
                          in_dims=bdim)(mv(lo))
    for i in range(n):
        assert torch.equal(got[i], ops.searchsorted(keys, lo[i]))
    pg = torch.func.vmap(
        lambda a, c, f: ops.probe_gather(keys, a, c, f, 8, (True, True, False),
                                         ((1, 2),)),
        in_dims=(bdim, bdim, bdim))(mv(lo), mv(hi), mv(flt))
    for i in range(n):
        want = ops.probe_gather(keys, lo[i], hi[i], flt[i], 8,
                                (True, True, False), ((1, 2),))
        for g, w in zip(pg, want):
            assert torch.equal(g[i], w)
    assert ops.vmap_folds["searchsorted"] == before[0]["searchsorted"] + 1
    assert ops.vmap_folds["probe_gather"] == before[0]["probe_gather"] + 1
    assert ops.launches == before[1]             # the CPU runs no kernel


def test_vmap_rule_shares_unbatched_inputs_and_refuses_batched_keys():
    keys, lo, hi, flt = _fold_inputs()
    got = torch.func.vmap(lambda a, c: ops.probe_gather(
        keys, a, c, flt[0], 8, (True, False, False)))(lo, hi)
    for i in range(lo.shape[0]):
        want = ops.probe_gather(keys, lo[i], hi[i], flt[0], 8,
                                (True, False, False))
        for g, w in zip(got, want):
            assert torch.equal(g[i], w)
    stacked = keys.expand(3, -1)
    with pytest.raises(ValueError, match="shared"):
        torch.func.vmap(lambda k: ops.searchsorted(k, lo[0]))(stacked)
    # the plain route vmaps natively: no fold
    before = dict(ops.vmap_folds)
    torch.func.vmap(lambda q: ops.searchsorted(keys, q, "torch"))(lo)
    assert ops.vmap_folds == before


# --- probe_compact: the GET and the merge in one op -------------------------

NEW_POS = [(), (2,), (1, 2), (0, 1, 2)]


def _compact_inputs(seed=13, b=48):
    """Bindings probing every kind of range: one- and two-field prefixes,
    the whole index (past any cap: missed), [0, 0) (an invalid binding)
    and hi < lo (degenerate), over keys with few distinct fields, so
    residuals and repeats match often."""
    rng = np.random.RandomState(seed)
    keys = _distinct_keys(rng, (12, 4, 12), 300)
    v = rng.randint(0, 13, b).astype(np.int64)
    p = rng.randint(0, 5, b).astype(np.int64)
    z = np.zeros(b, np.int64)
    kind = np.arange(b) % 5
    lo = np.where(kind == 1, pack3(v, p, z), pack3(v, z, z))
    hi = np.where(kind == 1, pack3(v, p + 1, z), pack3(v + 1, z, z))
    lo = np.where(kind == 2, 0, lo)
    hi = np.where(kind == 2, np.iinfo(np.int64).max, hi)
    lo, hi = np.where(kind == 3, 0, lo), np.where(kind == 3, 0, hi)
    hi = np.where(kind == 4, lo - 3, hi)
    flt = np.stack([rng.randint(0, 12, b), rng.randint(0, 4, b),
                    rng.randint(0, 12, b)], 1).astype(np.int64)
    table = rng.randint(0, 1000, (b, 2)).astype(np.int32)
    return keys, lo, hi, flt, table


def _compact_reference(keys, lo, hi, flt, table, cap, out_cap, msk, eq,
                       new_pos):
    """The JAX package's jnp GET, then the merge row by row in numpy: each
    match in (probe, slot) order, its binding and its key's fields at
    `new_pos`; the first `out_cap` kept."""
    k, valid, missed = j_gather_range(jnp.asarray(keys), jnp.asarray(lo),
                                      jnp.asarray(hi), cap)
    valid = np.asarray(j_apply_residual(k, valid, jnp.asarray(flt), msk, eq))
    k = np.asarray(k)
    rows = [list(table[i]) + [(k[i, c] >> ((2 - q) * BITS)) & MAX_ID
                              for q in new_pos]
            for i, c in zip(*np.nonzero(valid))]
    kept = min(len(rows), out_cap)
    out = np.zeros((out_cap, table.shape[1] + len(new_pos)), np.int32)
    if kept:
        out[:kept] = np.asarray(rows[:kept])
    return (out, np.arange(out_cap) < kept, max(len(rows) - out_cap, 0),
            len(rows) - out_cap, np.asarray(missed))


@pytest.mark.parametrize("out_cap", [512, 3])
@pytest.mark.parametrize("eq", [(), ((1, 2),), ((0, 2),), ((0, 1), (0, 2))])
@pytest.mark.parametrize("fm", range(8))
def test_probe_compact_plain_matches_reference(fm, eq, out_cap):
    """Both routes of ``probe_compact`` on the CPU (the plain version, and
    the custom op whose CPU implementation it is) against the JAX
    package's GET and a merge written out row by row: every filter mask
    and repeat set, each kind of range, an out_cap cut."""
    keys, lo, hi, flt, table = _compact_inputs()
    msk = tuple(bool(fm >> i & 1) for i in range(3))
    new_pos = NEW_POS[fm % 4]
    want = _compact_reference(keys, lo, hi, flt, table, 16, out_cap, msk, eq,
                              new_pos)
    for impl in ("torch", "kernel"):
        got = ops.probe_compact(T(keys), T(lo), T(hi), T(flt), T(table), 16,
                                out_cap, msk, eq, new_pos, impl)
        assert [g.dtype for g in got] == [torch.int32, torch.bool,
                                          torch.int32, torch.int32,
                                          torch.int32]
        assert got[2].dim() == got[3].dim() == 0
        for g, w, what in zip(got, want, ("table", "valid", "dropped", "over",
                                          "missed")):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"{impl} {what}")
    assert (want[2] > 0) == (out_cap == 3) or fm > 0   # 3 cuts, 512 not


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("out_cap", [1024, 5])
@pytest.mark.parametrize("bdim", [0, 1])
def test_probe_compact_vmap_compacts_each_slot_alone(bdim, out_cap, shared):
    """vmap over probe_compact equals the calls slot by slot, each slot cut
    at its own out_cap, with the batch folded into one call of the op
    (one launch on a card); a binding table shared by every slot too."""
    keys, lo, hi, flt = _fold_inputs()
    n, b = lo.shape
    table = T(np.random.RandomState(3).randint(0, 99, (n, b, 2)),
              dtype=torch.int32)
    if shared:
        table = table[0]
    mv = lambda x: x.movedim(0, bdim).contiguous()
    before = dict(ops.vmap_folds), dict(ops.launches)
    call = lambda a, c, f, t: ops.probe_compact(
        keys, a, c, f, t, 8, out_cap, (True, False, False), (), (1, 2))
    got = torch.func.vmap(call, in_dims=(bdim, bdim, bdim,
                                         None if shared else bdim))(
        mv(lo), mv(hi), mv(flt), table if shared else mv(table))
    for i in range(n):
        want = call(lo[i], hi[i], flt[i], table if shared else table[i])
        for g, w in zip(got, want):
            assert torch.equal(g[i], w)
    assert ops.vmap_folds["probe_compact"] == before[0]["probe_compact"] + 1
    assert ops.launches == before[1]             # the CPU runs no kernel
    assert bool(got[1].any()) and (out_cap > 5 or int(got[2].min()) > 0)


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [8, 33, 128, 256])
def test_cuda_probe_compact_matches_plain(cap):
    """The CUDA kernels against the plain version, bit for bit: every filter
    mask, three repeat sets, each kind of range, an out_cap that cuts and
    one that does not, one slot and three slots folded under vmap."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    keys, lo, hi, flt, table = (T(x, device=dev)
                                for x in _compact_inputs(cap, 600))
    for fm in range(8):
        msk = tuple(bool(fm >> i & 1) for i in range(3))
        for eq in ((), ((1, 2),), ((0, 2),)):
            for out_cap in (1 << 14, 37):
                args = (keys, lo, hi, flt, table, cap, out_cap, msk, eq,
                        NEW_POS[fm % 4])
                got = ops.probe_compact(*args, "kernel")
                want = ops.probe_compact(*args, "torch")
                for g, w in zip(got, want):
                    assert torch.equal(g, w), (fm, eq, out_cap)
    slots = [x.reshape(3, -1, *x.shape[1:]) for x in (lo, hi, flt, table)]
    call = lambda impl: lambda a, c, f, t: ops.probe_compact(
        keys, a, c, f, t, cap, 37, (True, False, False), (), (1, 2), impl)
    got = torch.func.vmap(call("kernel"))(*slots)
    for i in range(3):
        want = call("torch")(*(x[i] for x in slots))
        for g, w in zip(got, want):
            assert torch.equal(g[i], w)


# --- multiway_compact: one star pattern's rows from the row-GET's ranks ----

# the prefix components' masks a star plan can give (position 1, 1 and 2)
# and one more
EXTRA_MASKS = [0, 2, 6, 5]


def _star_inputs(seed=17, b=60, r=120):
    """(the op's inputs, (lo, hi)): the ranks of each binding's row
    [lo, hi) (subjects 0 and 1 own rows longer than any cap: missed; every
    fifth binding [0, 0), an invalid one), residual and prefix values over
    few distinct fields (so they match often), and r rows with origins in
    every binding, about a fifth of them invalid."""
    rng = np.random.RandomState(seed)
    fat = np.arange(80) + 3
    keys = np.unique(np.concatenate([
        _distinct_keys(rng, (13, 3, 4), 120),
        pack3(np.arange(80) % 2, fat, fat % 4)]))
    v = rng.randint(0, 14, b).astype(np.int64)
    z = np.zeros(b, np.int64)
    lo, hi = pack3(v, z, z), pack3(v + 1, z, z)
    lo[::5], hi[::5] = 0, 0
    start, end = np.searchsorted(keys, lo), np.searchsorted(keys, hi)
    flt = np.stack([v, rng.randint(0, 3, b), rng.randint(0, 4, b)], 1)
    extra = np.stack([v, rng.randint(0, 3, b), rng.randint(0, 4, b)], 1)
    origin = rng.randint(0, b, r).astype(np.int32)
    table = rng.randint(0, 1000, (r, 2)).astype(np.int32)
    valid = rng.rand(r) < 0.8
    return (keys, start, end, flt, extra, origin, table, valid), (lo, hi)


@functools.cache
def _star_gathered():
    """`_star_inputs()` and the JAX package's row-GET of them (k, in_row)
    at row_cap 16, shared by every case."""
    inputs, (lo, hi) = _star_inputs()
    k, in_row, _ = j_gather_range(jnp.asarray(inputs[0]), jnp.asarray(lo),
                                  jnp.asarray(hi), 16)
    return inputs, k, in_row


def _fields(key):
    return [(int(key) >> ((2 - q) * BITS)) & MAX_ID for q in range(3)]


def _star_rows(keys, start, end, flt, extra, origin, table, valid, row_cap,
               msk, xmsk, eq, new_pos):
    """One star pattern row by row in numpy: each valid row, then each key
    among the first `row_cap` of its origin's range that passes the
    pattern's tests, in (row, slot) order: [(row, origin)]."""
    rows = []
    for i in np.nonzero(valid)[0]:
        o = origin[i]
        for key in keys[start[o]:min(end[o], start[o] + row_cap)]:
            f = _fields(key)
            if all(f[q] == flt[o, q] for q in range(3) if msk[q]) and all(
                    f[q] == extra[o, q] for q in range(3) if xmsk[q]) and all(
                    f[a] == f[c] for a, c in eq):
                rows.append((list(table[i]) + [f[q] for q in new_pos], o))
    return rows


def _cut(rows, out_cap, width):
    """multiway_compact's outputs of the rows [(row, origin)]: the first
    `out_cap` kept, zeros after."""
    kept = min(len(rows), out_cap)
    out = np.zeros((out_cap, width), np.int32)
    ori = np.zeros(out_cap, np.int32)
    for n, (row, o) in enumerate(rows[:kept]):
        out[n], ori[n] = row, o
    return (out, np.arange(out_cap) < kept, max(len(rows) - out_cap, 0),
            len(rows) - out_cap, ori)


@pytest.mark.parametrize("out_cap", [1024, 7])
@pytest.mark.parametrize("eq", [(), ((1, 2),), ((0, 2),), ((0, 1), (0, 2))])
@pytest.mark.parametrize("xm", EXTRA_MASKS)
@pytest.mark.parametrize("fm", range(8))
def test_multiway_compact_plain_matches_reference(fm, xm, eq, out_cap):
    """Both routes of ``multiway_compact`` on the CPU (the plain version,
    and the custom op whose CPU implementation it is) against a star join
    written out row by row, whose rows are also those of the JAX
    package's row-GET and residual filters: every residual mask, the
    prefix components' masks, repeat sets, rows longer than row_cap,
    invalid bindings and rows, a cut at out_cap."""
    inputs, k, match = _star_gathered()
    keys, start, end, flt, extra, origin, table, valid = inputs
    msk = tuple(bool(fm >> i & 1) for i in range(3))
    xmsk = tuple(bool(xm >> i & 1) for i in range(3))
    new_pos = NEW_POS[(fm + xm) % 4]
    rows = _star_rows(*inputs, 16, msk, xmsk, eq, new_pos)
    match = j_apply_residual(k, match, jnp.asarray(flt), msk, eq)
    match = np.asarray(j_apply_residual(k, match, jnp.asarray(extra), xmsk))
    k = np.asarray(k)
    assert rows == [(list(table[i]) + [_fields(k[o, c])[q] for q in new_pos],
                     o) for i, o in enumerate(origin) if valid[i]
                    for c in np.nonzero(match[o])[0]]
    want = _cut(rows, out_cap, table.shape[1] + len(new_pos))
    for impl in ("torch", "kernel"):
        got = ops.multiway_compact(*(T(x) for x in inputs), 16, out_cap, msk,
                                   xmsk, eq, new_pos, impl)
        assert [g.dtype for g in got] == [torch.int32, torch.bool,
                                          torch.int32, torch.int32,
                                          torch.int32]
        assert got[2].dim() == got[3].dim() == 0
        for g, w, what in zip(got, want, ("table", "valid", "dropped", "over",
                                          "origin")):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"{impl} {what}")
    assert (end - start > 16).any() and not valid.all()


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("out_cap", [1024, 5])
@pytest.mark.parametrize("bdim", [0, 1])
def test_multiway_compact_vmap_compacts_each_slot_alone(bdim, out_cap,
                                                        shared):
    """vmap over multiway_compact equals the calls slot by slot, each slot
    cut at its own out_cap, with the batch folded into one call of the op
    (one launch on a card); origins shared by every slot too, as the
    first pattern's are."""
    keys, lo, hi, flt = _fold_inputs()
    n, b = lo.shape
    start, end = (torch.searchsorted(keys, x) for x in (lo, hi))
    rng = np.random.RandomState(4)
    origin = T(rng.randint(0, b, (n, 2 * b)), dtype=torch.int32)
    if shared:
        origin = origin[0]
    table = T(rng.randint(0, 99, (n, 2 * b, 2)), dtype=torch.int32)
    valid = T(rng.rand(n, 2 * b) < 0.8)
    mv = lambda x: x.movedim(0, bdim).contiguous()
    before = dict(ops.vmap_folds), dict(ops.launches)
    call = lambda s, e, f, o, t, v: ops.multiway_compact(
        keys, s, e, f, f, o, t, v, 8, out_cap, (True, False, False),
        (False, True, False), (), (1, 2))
    got = torch.func.vmap(call, in_dims=(bdim,) * 3 + (
        None if shared else bdim, bdim, bdim))(
        mv(start), mv(end), mv(flt), origin if shared else mv(origin),
        mv(table), mv(valid))
    for i in range(n):
        want = call(start[i], end[i], flt[i],
                    origin if shared else origin[i], table[i], valid[i])
        for g, w in zip(got, want):
            assert torch.equal(g[i], w)
    assert ops.vmap_folds["multiway_compact"] == (
        before[0]["multiway_compact"] + 1)
    assert ops.launches == before[1]             # the CPU runs no kernel
    assert bool(got[1].any()) and (out_cap > 5 or int(got[2].min()) > 0)


@pytest.mark.gpu
@pytest.mark.parametrize("row_cap", [8, 33, 64, 256])
def test_cuda_multiway_compact_matches_plain(row_cap):
    """The CUDA kernels against the plain version, bit for bit: every
    residual mask, the prefix components' masks, three repeat sets, rows
    longer than row_cap, invalid bindings and rows, an out_cap that cuts
    and one that does not, one slot and three slots folded under vmap."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    inputs = [T(x, device=dev) for x in _star_inputs(row_cap, 600, 900)[0]]
    for fm in range(8):
        msk = tuple(bool(fm >> i & 1) for i in range(3))
        for xm in EXTRA_MASKS:
            xmsk = tuple(bool(xm >> i & 1) for i in range(3))
            for eq in ((), ((1, 2),), ((0, 2),)):
                for out_cap in (1 << 16, 37):
                    args = (*inputs, row_cap, out_cap, msk, xmsk, eq,
                            NEW_POS[(fm + xm) % 4])
                    got = ops.multiway_compact(*args, "kernel")
                    want = ops.multiway_compact(*args, "torch")
                    for g, w in zip(got, want):
                        assert torch.equal(g, w), (fm, xm, eq, out_cap)
    keys, per_b, per_r = inputs[0], inputs[1:5], inputs[5:]
    slots = ([x.reshape(3, -1, *x.shape[1:]) for x in per_b]
             + [x.reshape(3, -1, *x.shape[1:]) for x in per_r])
    slots[4] = slots[4] % 200                    # origins within a slot
    call = lambda impl: lambda *a: ops.multiway_compact(
        keys, *a, row_cap, 37, (False, False, True), (False, True, False), (),
        (2,), impl)
    got = torch.func.vmap(call("kernel"))(*slots)
    for i in range(3):
        want = call("torch")(*(x[i] for x in slots))
        for g, w in zip(got, want):
            assert torch.equal(g[i], w)


# --- sort_merge_compact: the reduce-side join's merge after its sort --------

# (extra_eq, r_out_cols) of a join on left column 0 = right column 1: no
# further shared variable, one, and two (every right column then shared)
JOINS = [((), (0, 2)), (((1, 0),), (2,)), (((1, 0), (2, 2)), ())]


def _join_inputs(seed=23, l=40, m=60, ids=6):
    """Left (l, 3) and right (m, 3) int32 tables over few distinct values,
    so keys repeat past small probe caps and the extra equalities match
    often; about a fifth of the rows on each side invalid."""
    rng = np.random.RandomState(seed)
    lt = rng.randint(0, ids, (l, 3)).astype(np.int32)
    rt = rng.randint(0, ids, (m, 3)).astype(np.int32)
    return lt, rng.rand(l) < 0.8, rt, rng.rand(m) < 0.8


def _sorted_right(rt, rv, rkey_col=1):
    """The reduce phase's sort: keys of invalid rows set to INT32_MAX, a
    stable argsort. Returns (rks, rts, rvs)."""
    rkey = np.where(rv, rt[:, rkey_col], np.iinfo(np.int32).max)
    order = np.argsort(rkey, kind="stable")
    return rkey[order].astype(np.int32), rt[order], rv[order]


def _merge_rows(rks, rts, rvs, lt, lv, extra_eq, r_out, probe_cap):
    """The sort-merge written out row by row: each valid left row, then
    each valid right row among the first `probe_cap` of its key's equal
    range that passes the extra equalities. Returns (rows, missed)."""
    rows, missed = [], 0
    for i in np.nonzero(lv)[0]:
        lo = np.searchsorted(rks, lt[i, 0], "left")
        hi = np.searchsorted(rks, lt[i, 0], "right")
        missed += max(hi - lo - probe_cap, 0)
        for j in range(lo, min(hi, lo + probe_cap)):
            if rvs[j] and all(lt[i, a] == rts[j, c] for a, c in extra_eq):
                rows.append(list(lt[i]) + [rts[j, c] for c in r_out])
    return rows, missed


@pytest.mark.parametrize("out_cap", [4096, 4])
@pytest.mark.parametrize("probe_cap", [3, 16])
@pytest.mark.parametrize("join", range(len(JOINS)))
def test_sort_merge_compact_plain_matches_reference(join, probe_cap, out_cap):
    """Both routes of ``sort_merge_compact`` on the CPU (the plain version,
    and the custom op whose CPU implementation it is) against the
    sort-merge written out row by row, and ``sort_merge_join`` against the
    JAX package's: no, one and two extra equalities, invalid rows on both
    sides, key groups longer than probe_cap (missed), an out_cap cut,
    `found`, `dropped` and `over`; no kernel launched."""
    extra_eq, r_out = JOINS[join]
    lt, lv, rt, rv = _join_inputs()
    rks, rts, rvs = _sorted_right(rt, rv)
    rows, missed = _merge_rows(rks, rts, rvs, lt, lv, extra_eq, r_out,
                               probe_cap)
    kept = min(len(rows), out_cap)
    want = np.zeros((out_cap, 3 + len(r_out)), np.int32)
    if kept:
        want[:kept] = rows[:kept]
    over = len(rows) - out_cap
    ref = jax.jit(lambda a, b, c, d: jrs.sort_merge_join(
        a, b, c, d, 0, 1, list(extra_eq), list(r_out), probe_cap,
        out_cap))(*(jnp.asarray(x) for x in (lt, lv, rt, rv)))
    before = dict(ops.launches)
    for impl in ("torch", "kernel"):
        got = ops.sort_merge_compact(T(rks), T(rts), T(rvs), T(lt), T(lv), 0,
                                     extra_eq, r_out, probe_cap, out_cap,
                                     impl)
        assert [g.dtype for g in got] == [torch.int32, torch.bool,
                                          torch.int32, torch.int32]
        for g, w, what in zip(got, (want, np.arange(out_cap) < kept,
                                    max(over, 0) + missed, over),
                              ("table", "valid", "dropped", "over")):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"{impl} {what}")
        found = []
        table, valid, dropped = trs.sort_merge_join(
            T(lt), T(lv), T(rt), T(rv), 0, 1, list(extra_eq), list(r_out),
            probe_cap, out_cap, found, impl)
        for g, w in zip((table, valid, dropped), ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert [(int(o), n, c) for o, n, c in found] == [
            (over, lt.shape[0] * probe_cap, out_cap)]
    assert ops.launches == before                # the CPU runs no kernel
    assert rows and not lv.all() and not rvs.all()
    assert (missed > 0) == (probe_cap == 3) and (over > 0) == (out_cap == 4)


def test_sort_merge_compact_without_left_rows():
    """No left row: nothing kept, nothing dropped, over -out_cap (no row
    found) on both routes."""
    _, _, rt, rv = _join_inputs()
    lt = np.zeros((0, 3), np.int32)
    for impl in ("torch", "kernel"):
        got = ops.sort_merge_compact(*(T(x) for x in _sorted_right(rt, rv)),
                                     T(lt), T(np.zeros(0, bool)), 0, (),
                                     (0, 2), 4, 8, impl)
        assert not got[0].any() and not got[1].any()
        assert (int(got[2]), int(got[3])) == (0, -8)
        found = []
        trs.sort_merge_join(T(lt), T(np.zeros(0, bool)), T(rt), T(rv), 0, 1,
                            [], [0, 2], 4, 8, found, impl)
        assert [(int(o), n, c) for o, n, c in found] == [(-8, 0, 8)]


def test_cuda_sort_merge_wrapper_rejects_host_tensors():
    lt, lv, rt, rv = (T(x) for x in _join_inputs())
    with pytest.raises(ValueError, match="CUDA"):
        sort_merge_compact_cuda(rt[:, 1].contiguous(), rt, rv, lt, lv, 0, (),
                                (0, 2), 4, 16)


@pytest.mark.gpu
@pytest.mark.parametrize("probe_cap", [3, 33, 64, 1024])
def test_cuda_sort_merge_compact_matches_plain(probe_cap):
    """The CUDA kernels against the plain version, bit for bit: no, one and
    two extra equalities, invalid rows on both sides, key groups longer
    than probe_cap, an out_cap that cuts and one that does not, and
    ``sort_merge_join`` on both routes with its `found`."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    lt, lv, rt, rv = (T(x, device=dev)
                      for x in _join_inputs(probe_cap, 3000, 5000, 40))
    sorted_right = [T(x, device=dev) for x in _sorted_right(
        *(x.cpu().numpy() for x in (rt, rv)))]
    before = ops.launches["sort_merge_compact"]
    calls = 0
    for extra_eq, r_out in JOINS:
        for out_cap in (1 << 16, 37):
            args = (*sorted_right, lt, lv, 0, extra_eq, r_out, probe_cap,
                    out_cap)
            got = ops.sort_merge_compact(*args, "kernel")
            want = ops.sort_merge_compact(*args, "torch")
            for g, w in zip(got, want):
                assert torch.equal(g, w), (extra_eq, out_cap)
            runs = []
            for impl in ("kernel", "torch"):
                found = []
                out = trs.sort_merge_join(lt, lv, rt, rv, 0, 1, list(extra_eq),
                                          list(r_out), probe_cap, out_cap,
                                          found, impl)
                runs.append((out, [(int(o), n, c) for o, n, c in found]))
            for g, w in zip(runs[0][0], runs[1][0]):
                assert torch.equal(g, w)
            assert runs[0][1] == runs[1][1]
            calls += 2
    assert ops.launches["sort_merge_compact"] - before == calls
