"""The searchsorted kernel's index arithmetic, modelled in numpy on the CPU.

``csrc/searchsorted.cu`` cannot run here, so a numpy model of what it
computes stands in for it: per warp of ``LANES`` queries (lanes past the
end take lane 0's query), the choice between the cooperative search (a
warp whose queries are all equal, or every warp with ``path`` TOGETHER,
one distinct value after another) and the per-lane one, the
(``LANES`` + 1)-ary ballot-count steps of the cooperative search, and the
per-lane search's segment choice in the table of every S-th key and its
binary search inside the segment.
The model reads its parameters from ``kernels/searchsorted.py``
(``launch_params``), which passes the same values to the kernel.

Every case holds the model against numpy, ``jnp.searchsorted``, the JAX
package's Pallas kernel in interpret mode and the port's plain version;
all outputs are integer ranks and must be equal. Each case family has one
array shape, so the reference compiles once per family. The same families
run on the card against the plain version in the ``gpu``-marked test."""
import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro  # noqa: F401  (enables x64 for the reference)
from repro.core.rdf import pack3
from repro.kernels import ops as jops

from repro_torch.kernels import ops
from repro_torch.kernels import searchsorted as ss

INF = np.iinfo(np.int64).max
T = torch.as_tensor
SMALL_TABLE = 8        # a table this small puts segment edges everywhere


def model_warp_rank(keys, v, lanes):
    """The cooperative search of one value: (rank, steps)."""
    lo, n, steps = 0, len(keys), 0
    lane = np.arange(lanes)
    while n > 0:
        step = n // (lanes + 1) + 1
        p = lo + (lane + 1) * step - 1
        inside = p < lo + n
        below = np.zeros(lanes, bool)
        below[inside] = keys[p[inside]] < v
        c = int(below.sum())                 # __popc(__ballot_sync(...))
        assert below[:c].all(), "pivots below v must be a prefix of lanes"
        nxt = lo + c * step
        n = min(step - 1, lo + n - nxt)
        lo = nxt
        steps += 1
    return lo, steps


def model_lower_bound(a, n, x):
    lo = 0
    while n > 0:
        half = n >> 1
        if a[lo + half] < x:
            lo, n = lo + half + 1, n - half - 1
        else:
            n = half
    return lo


def model_lane_rank(keys, table, seg_log2, x):
    """One lane's search: its segment from the table, then inside it."""
    c = model_lower_bound(table, len(table), x)
    if c == 0:
        return 0
    a = ((c - 1) << seg_log2) + 1
    e = min(c << seg_log2, len(keys))
    return a + model_lower_bound(keys[a:e], e - a, x)


def model(keys, queries, seg_log2, path, lanes=ss.LANES):
    """(ranks, warps on the cooperative path, warps on the per-lane path,
    most cooperative steps taken for one value)."""
    m = len(keys)
    t = 0 if m == 0 else ((m - 1) >> seg_log2) + 1
    table = keys[::1 << seg_log2]
    assert len(table) == t
    out = np.empty(len(queries), np.int64)
    together = apart = most = 0
    for w0 in range(0, len(queries), lanes):
        x = queries[w0:w0 + lanes]
        lane_x = np.concatenate([x, np.full(lanes - len(x), x[0])])
        values = list(dict.fromkeys(lane_x.tolist()))   # in lane order
        if path == ss.TOGETHER or (path == ss.AUTO and len(values) == 1):
            together += 1
            for v in values:
                r, steps = model_warp_rank(keys, v, lanes)
                most = max(most, steps)
                out[w0:w0 + len(x)][x == v] = r
        else:
            apart += 1
            out[w0:w0 + len(x)] = [model_lane_rank(keys, table, seg_log2, q)
                                   for q in x]
    return out, together, apart, most


# ---------------------------------------------------------------------------
# case families: (keys, queries) from a seed; one shape per family
# ---------------------------------------------------------------------------


def _keys(rng, m, pad=0):
    """`m` sorted distinct packed keys, then `pad` INF_KEY entries."""
    code = np.sort(rng.choice(40 * 6 * 40, m, replace=False))
    s, p, o = np.unravel_index(code, (40, 6, 40))
    k = pack3(s.astype(np.int64), p.astype(np.int64), o.astype(np.int64))
    return np.concatenate([k, np.full(pad, INF, np.int64)])


def _near(rng, keys, n):
    """Queries at, just below and just above keys, never below 0 or past
    INF_KEY (the reference unpacks both into 21-bit fields)."""
    k = keys[rng.randint(0, len(keys), n)]
    d = rng.randint(-1, 2, n)
    q = k + d
    return np.where((k == INF) & (d > 0), INF,
                    np.where((k == 0) & (d < 0), 0, q)).astype(np.int64)


def _per_warp(rng, pool, q, lanes, lo, hi):
    """`q` queries, each warp drawing from lo..hi distinct values of pool."""
    out = []
    for _ in range(0, q, lanes):
        vals = pool[rng.randint(0, len(pool), rng.randint(lo, hi + 1))]
        out.append(vals[rng.randint(0, len(vals), lanes)])
    return np.concatenate(out)[:q]


def fam_all_zero(rng):                 # the multiway step: invalid rows -> 0
    return _keys(rng, 1000, 24), np.zeros(333, np.int64)


def fam_q4_like(rng):                  # a few valid rows first, then zeros
    keys = _keys(rng, 1000, 24)
    q = np.zeros(333, np.int64)
    q[:18] = _near(rng, keys[:-24], 18)
    return keys, q


def fam_all_equal_key(rng):            # all equal, to a key in the middle
    keys = _keys(rng, 1000, 24)
    return keys, np.full(333, keys[517], np.int64)


def fam_few_per_warp(rng):             # 1-4 distinct values in each warp
    keys = _keys(rng, 1000, 24)
    return keys, _per_warp(rng, _near(rng, keys, 64), 333, ss.LANES, 1, 4)


def fam_five_to_eight(rng):            # more distinct values a warp
    keys = _keys(rng, 1000, 24)
    return keys, _per_warp(rng, _near(rng, keys, 64), 333, ss.LANES, 5, 8)


def fam_all_distinct(rng):
    keys = _keys(rng, 1000, 24)
    return keys, _near(rng, keys, 333)


def fam_long_runs(rng):
    """Runs of equal keys longer than a small table's segment, crossing
    its edges, and the INF_KEY padding as one long run."""
    vals = np.sort(rng.choice(np.arange(1, 500, dtype=np.int64) * 7, 9,
                              replace=False))
    lens = rng.permutation([90, 70, 40, 30, 30, 25, 20, 15, 10])
    keys = np.concatenate([np.repeat(vals, lens), np.full(70, INF, np.int64)])
    pool = np.concatenate([vals, vals - 1, vals + 1, [0, INF, INF - 1]])
    return keys, pool[rng.randint(0, len(pool), 333)]


def fam_inf_queries(rng):
    keys = _keys(rng, 1000, 24)
    q = _near(rng, keys, 333)
    q[rng.rand(333) < 0.5] = INF
    return keys, q


def fam_below_all(rng):
    keys = np.concatenate([_keys(rng, 1000) + pack3(1, 0, 0),  # all above
                           np.full(24, INF, np.int64)])         # (0, *, *)
    q = pack3(np.zeros(333, np.int64), rng.randint(0, 6, 333),
              rng.randint(0, 40, 333))
    q[::3] = 0
    return keys, q


def fam_m1(rng):
    keys = np.array([pack3(3, 2, 1)], np.int64)
    pool = np.array([0, keys[0] - 1, keys[0], keys[0] + 1, INF], np.int64)
    return keys, pool[rng.randint(0, 5, 100)]


def fam_m31(rng):
    keys = _keys(rng, 29, 2)
    return keys, np.concatenate([_near(rng, keys, 90), [0, INF, INF, 0]])


def fam_m_not_multiple(rng):           # 1001 keys: the last segment is short
    keys = _keys(rng, 1001, 0)
    return keys, np.concatenate([_near(rng, keys, 330), keys[-1:] + 1,
                                 keys[-3:-2], [INF]])


FAMILIES = {f.__name__[4:]: f for f in (
    fam_all_zero, fam_q4_like, fam_all_equal_key, fam_few_per_warp,
    fam_five_to_eight, fam_all_distinct, fam_long_runs, fam_inf_queries,
    fam_below_all, fam_m1, fam_m31, fam_m_not_multiple)}
_refs: dict = {}


def family(name):
    """(keys, queries, np.searchsorted ranks), checked once per family
    against jnp.searchsorted, the Pallas kernel in interpret mode and the
    port's plain version."""
    if name not in _refs:
        keys, q = FAMILIES[name](
            np.random.RandomState(17 + list(FAMILIES).index(name)))
        keys, q = keys.astype(np.int64), q.astype(np.int64)
        assert np.all(keys[:-1] <= keys[1:]) and q.min() >= 0
        want = np.searchsorted(keys, q)
        jk, jq = jnp.asarray(keys), jnp.asarray(q)
        np.testing.assert_array_equal(np.asarray(jnp.searchsorted(jk, jq)),
                                      want)
        np.testing.assert_array_equal(
            np.asarray(jops.searchsorted(jk, jq, interpret=True)), want)
        got = ops.searchsorted(T(keys), T(q), "torch")
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)
        _refs[name] = keys, q, want
    return _refs[name]


PATHS = {"auto": ss.AUTO, "apart": ss.APART, "together": ss.TOGETHER}


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("table_max", [ss.TABLE_MAX, SMALL_TABLE],
                         ids=["table", "small-table"])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_model_matches_references(name, table_max, path):
    keys, q, want = family(name)
    got, together, apart, most = model(
        keys, q, *ss.launch_params(len(keys), table_max, PATHS[path]))
    np.testing.assert_array_equal(got, want)
    warps = -(-len(q) // ss.LANES)
    assert together + apart == warps
    if path == "apart":
        assert together == 0
    if path == "together":
        assert apart == 0
    # 33-ary: the range shrinks to at most ceil((n + 1) / 33) - 1 each step
    n, bound = len(keys), 0
    while n > 0:
        n, bound = n // (ss.LANES + 1), bound + 1
    assert most <= bound


@pytest.mark.parametrize("name,path", [
    ("all_zero", "together"),
    ("q4_like", "both"),
    ("all_equal_key", "together"),
    ("few_per_warp", "both"),
    ("five_to_eight", "apart"),
    ("all_distinct", "apart")])
def test_auto_picks_the_path(name, path):
    """AUTO ranks a warp together exactly when its queries are equal."""
    keys, q, _ = family(name)
    _, together, apart, _ = model(keys, q, *ss.launch_params(len(keys)))
    assert {"together": apart == 0, "apart": together == 0,
            "both": together > 0 and apart > 0}[path]


def test_cooperative_steps_at_the_main_path_size():
    """Q4's rank-find: 5,174,800 keys in 5 dependent steps, the last over
    consecutive keys, against 23 for a binary search."""
    keys = np.arange(5_174_800, dtype=np.int64) * 3
    for v in (0, 1, keys[2_600_001], keys[-1], keys[-1] + 1, INF):
        r, steps = model_warp_rank(keys, v, ss.LANES)
        assert r == np.searchsorted(keys, v) and steps <= 5


@pytest.mark.parametrize("m", [0, 1, 31, 4096, 4097, 8193, 5_174_800,
                               4_204_096])
def test_segment_log2_is_the_least_power_of_two(m):
    s = ss.segment_log2(m)
    assert -(-m // (1 << s)) <= ss.TABLE_MAX
    assert s == 0 or -(-m // (1 << (s - 1))) > ss.TABLE_MAX
    assert ss.launch_params(m) == (s, ss.AUTO)


def test_wrapper_passes_the_models_parameters(monkeypatch):
    """searchsorted_cuda hands the kernel launch_params(M): the values the
    model above runs with."""
    seen = []

    def fake(*args):
        seen.append(args)
        return 0

    monkeypatch.setattr(ss, "check_tensor", lambda *a, **k: None)
    monkeypatch.setattr(ss, "_fn", lambda: fake)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0})())
    keys = torch.arange(5000, dtype=torch.int64)
    ss.searchsorted_cuda(keys, keys[:7])
    assert seen[0][5:7] == ss.launch_params(5000)
    assert seen[0][1] == 5000 and seen[0][3] == 7


def test_wrapper_refuses_positions_past_32_bits(monkeypatch):
    """The kernel's positions are 32-bit: a key array whose last segment
    ends at 2^32 or later raises before any launch."""
    def never(*args):
        raise AssertionError("launched")

    monkeypatch.setattr(ss, "check_tensor", lambda *a, **k: None)
    monkeypatch.setattr(ss, "_fn", lambda: never)
    keys = torch.arange(5000, dtype=torch.int64)
    with pytest.raises(ValueError, match="32-bit positions"):
        ss.launch(keys, keys[:7], 32, ss.AUTO)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(FAMILIES))
def test_cuda_kernel_matches_plain(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    keys, q, want = family(name)
    dev = torch.device("cuda")
    tk, tq = T(keys, device=dev), T(q, device=dev)
    plain = ops.searchsorted(tk, tq, "torch").cpu().numpy()
    np.testing.assert_array_equal(plain, want)
    np.testing.assert_array_equal(ss.searchsorted_cuda(tk, tq).cpu().numpy(),
                                  want)
    for table_max in (ss.TABLE_MAX, SMALL_TABLE):
        for path in PATHS:
            got = ss.launch(tk, tq, *ss.launch_params(len(keys), table_max,
                                                      PATHS[path]))
            np.testing.assert_array_equal(got.cpu().numpy(), want,
                                          err_msg=f"{table_max} {path}")
