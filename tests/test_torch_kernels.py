"""The port's kernels' plain versions against the JAX package's Pallas
kernels (interpret mode) and jnp path, and the dispatch rules.

The cases mirror tests/test_kernels_searchsorted.py and
tests/test_probe_gather.py at small sizes; all outputs are integers and
must be bit-identical. The CUDA kernels themselves run only on a card:
their case is marked ``gpu`` and skips elsewhere."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro  # noqa: F401  (enables x64 for the reference)
from repro.core.mapsin import apply_residual as j_apply_residual
from repro.core.mapsin import gather_range as j_gather_range
from repro.core.rdf import pack3
from repro.kernels import ops as jops

from repro_torch.core.bgp import ExecConfig
from repro_torch.kernels import ops
from repro_torch.kernels.probe_gather import probe_gather_cuda
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
