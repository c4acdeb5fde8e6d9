"""Distributed MAPSIN execution over a mesh of region shards
(``core/collectives.py``).

Every function here runs inside one shard's body of ``mesh.run`` and takes
that shard's communicator ``comm`` where the JAX package takes its mesh
axis name; the collectives are ``comm``'s.

Traffic model (the paper's network argument):
  MAPSIN step   — ship ONLY probe keys and ONLY matching tuples, two ways:
      routing="broadcast" — all_gather(probe keys) + psum_scatter(matches):
                  every shard sees every probe and answers the ones whose
                  range intersects its region. Pays O(S) on the key leg.
      routing="a2a"       — point-to-point dispatch: each probe record
                  (lo/hi; the residual filters stay on the origin shard,
                  which applies them after the round trip) is bucketed by
                  the region(s) its range intersects (the stored splits)
                  and shipped with all_to_all only to those shards; raw
                  range entries ride a second all_to_all home, keyed on
                  the sender's bucket slots. This is the paper's HBase
                  region-server GET: O(B) probe bytes, independent of the
                  cluster size.
  reduce-side   — all_to_all(BOTH full relations) (see reduce_side.py)

The store is range-sharded; a probe whose key range spans several shards
(fat rows, the `rdf:type` problem) is answered by every intersecting shard
and the per-shard match counts are offset-composed, so results concatenate
exactly once. Both routings keep that invariant: per-shard matches are
packed in key order and offsets compose in shard (= global key) order, so
the two paths produce bit-identical Bindings.

Shard indices are host ints here (``comm.index``), so the fault hooks
choose their branch on the host. No function syncs the host.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.common import ceil_div
from repro_torch.core.mapsin import (Bindings, apply_residual, gather_range,
                                     merge_bindings, multiway_merge,
                                     probe_inputs)
from repro_torch.core.plan import make_plan, row_range
from repro_torch.core.triple_store import range_intersects_region
from repro_torch.kernels import ops


def _my_region(shard_splits, comm):
    """This shard's (last-key-of-previous-shard, last-own-key] bounds from
    the stored region boundaries (the store's (S + 1,) splits tensor)."""
    if shard_splits is None:
        return None
    me = comm.index
    return shard_splits[me], shard_splits[me + 1]


def bucket_rows(send: torch.Tensor, cap: int, payload: Sequence[torch.Tensor]):
    """Pack records into per-destination send buckets (the shared bucketing
    machinery behind `repartition` and the a2a probe dispatch).

    send: (n, S) bool — record i is addressed to destination s; a record may
    target several destinations (the fat-row fan-out) or none (invalid /
    masked rows). payload: tensors shaped (n,) or (n, k), packed together.

    Returns (bufs, slot, dropped):
      bufs    — one (S, cap[, k]) buffer per payload tensor, records packed
                to the front of each destination bucket in row order;
      slot    — (n, S) int32, the in-bucket position each (record, dest)
                copy landed at, == cap for copies not shipped (dropped or
                not addressed) — the sender's receipt, used to claim
                answers that come back in bucket order;
      dropped — (n,) int32 count of addressed-but-dropped copies per record
                (bucket overflow; surfaced, never silent).

    Gather-formulated: slot j of destination d takes the record whose
    running count for d reaches j + 1 (a rank-find over the counts), so
    nothing is scattered and no two writes meet; the counts run along the
    record axis of an (S, n) layout, the fast direction of a scan.
    """
    n, s = send.shape
    dev = send.device
    cum = torch.cumsum(send.t().contiguous(), 1, dtype=torch.int32)  # (S, n)
    rank = cum.t() - 1                                        # (n, S)
    keep = send & (rank < cap)
    slot = torch.where(keep, rank, cap)                       # cap == spill
    want = torch.arange(1, cap + 1, dtype=torch.int32,
                        device=dev).expand(s, cap).contiguous()
    src = torch.searchsorted(cum, want)                       # (S, cap)
    filled = src < n                                          # j < count
    src = src.clamp(max=max(n - 1, 0))
    bufs = []
    for p in payload:
        extra = tuple(p.shape[1:])
        fmask = filled.reshape((s, cap) + (1,) * len(extra))
        val = (p[src] if n else
               torch.zeros((s, cap) + extra, dtype=p.dtype, device=dev))
        bufs.append(torch.where(fmask, val, torch.zeros((), dtype=p.dtype,
                                                         device=dev)))
    dropped = (send & ~keep).sum(1, dtype=torch.int32)
    return bufs, slot, dropped


_SALT = 0x9E3779B97F4A7C15 - (1 << 64)        # golden-ratio mix, as int64


def _leg_checksum(ans, cnt, miss, answerer):
    """Salted positional checksum of one shard's outgoing answer blocks.

    ans (S, cap, P) int64, cnt/miss (S, cap) int32 -> (S,) int64, one
    checksum per destination block. Position-sensitive (odd weights per
    slot, so swapped or shifted entries change the sum) and salted with
    the ANSWERER's shard id (a host int, or an (S,) tensor of them), so a
    zeroed block (dropped packets) can never reproduce the checksum of a
    legitimately empty answer. int64 arithmetic wraps two's-complement,
    as in the JAX package, so both compute the same bits."""
    s, cap, p = ans.shape
    dev = ans.device
    w = (2 * torch.arange(cap * p, dtype=torch.int64, device=dev)
         + 1).reshape(cap, p)
    wc = 2 * torch.arange(cap, dtype=torch.int64, device=dev) + 1
    h = ((ans * w[None]).sum((1, 2)) * 1000003
         + (cnt.long() * wc[None]).sum(1) * 8191
         + (miss.long() * (wc + 7)[None]).sum(1))
    salt = torch.as_tensor(answerer, dtype=torch.int64, device=dev) + 1
    return h + salt * _SALT


def auto_bucket_cap(batch: int, num_shards: int) -> int:
    """Default per-destination probe bucket capacity: 2x the uniform share
    (skew headroom), floored at 32, never beyond `batch` (a shard never
    receives more than one copy of each probe, so `batch` is exact)."""
    return min(batch, max(ceil_div(2 * batch, num_shards), 32))


def a2a_leg_bytes(bucket_cap: int, answer_cap: int,
                  num_shards: int) -> tuple[int, int]:
    """Static per-shard a2a payload of ONE dist_probe round, split by
    wire leg: ``(probe_leg, answer_leg)`` bytes. The probe leg ships the
    per-destination (lo, hi) bucket records out; the answer leg returns
    ``answer_cap`` key slots + count + missed per bucket slot. The local
    diagonal block never crosses the network and is excluded.
    ``bgp.a2a_step_payload_bytes`` sums the two legs."""
    s = num_shards
    probe = (s - 1) * bucket_cap * (8 + 8)
    answer = (s - 1) * bucket_cap * (answer_cap * 8 + 4 + 4)
    return probe, answer


def _dist_probe_a2a(lo, hi, flt, msk, eq_positions, local_keys,
                    probe_cap: int, comm, impl: str, splits,
                    bucket_cap: int, fault=None, with_check: bool = False):
    """Point-to-point routed GET (the paper's region-server RPC).

    Four phases, two all_to_all rounds, zero all_gathers:
      1. route   — (B, S) hit matrix from the stored region boundaries,
                   each probe record — just (lo, hi) — bucketed per
                   destination region with `bucket_rows`;
      2. ship    — one all_to_all moves every bucket to its region server;
      3. answer  — local rank-find + range gather on the received records
                   (the searchsorted kernel, twice); the in-range mask of a
                   sorted-range gather is a front-aligned prefix, so the
                   answer block needs no compaction;
      4. return  — a second all_to_all routes (raw range entries, counts,
                   missed) back; the sender claims them by its recorded
                   bucket slots, offset-composes counts in shard (= global
                   key) order — gather-formulated: source block + in-block
                   position per OUTPUT slot — and applies the residual
                   filters it kept.

    Truncation semantics match the local ``probe()``: the first probe_cap
    RANGE entries are considered and the rest are surfaced as missed.
    Bucket overflow (more probes routed to one region than `bucket_cap`)
    drops the spilled copies and surfaces them in the missed counts.

    Answer-leg integrity (`with_check=True`): every answering shard ships
    a salted positional checksum per outgoing answer block; the origin
    recomputes it over what arrived and ZEROES any mismatched block before
    its keys can enter a result — rows can go missing (surfaced via the
    extra `bad` output, which the serving engine retries on) but never
    come out wrong. `fault` is the chaos hook: a static
    ``(drop_shards, corrupt_shards)`` pair naming answering shards whose
    outgoing legs are zeroed (checksum included: lost packets) or
    value-perturbed AFTER checksumming (wire corruption). Returns a 4th
    element ``bad`` — this origin shard's count of quarantined blocks —
    iff `with_check`.
    """
    S = comm.size
    dev = lo.device
    send = range_intersects_region(lo[:, None], hi[:, None],
                                   splits[None, :-1], splits[None, 1:])
    send = send & (hi > lo)[:, None]
    (slo, shi), slot, drop_cnt = bucket_rows(send, bucket_cap, [lo, hi])
    # --- ship probe records point-to-point (keys-only traffic, O(B)) ---
    rlo = comm.all_to_all(slo).reshape(S * bucket_cap)
    rhi = comm.all_to_all(shi).reshape(S * bucket_cap)
    # --- answer locally (each record was routed here on purpose) ---
    k, valid, missed = gather_range(local_keys, rlo, rhi, probe_cap, impl)
    cnt = valid.sum(-1, dtype=torch.int32)             # prefix length
    ans = torch.where(valid, k + 1, 0)                 # front-aligned; 0 == empty
    ans_b = ans.reshape(S, bucket_cap, probe_cap)
    cnt_b = cnt.reshape(S, bucket_cap)
    miss_b = missed.reshape(S, bucket_cap)
    drop_sh, corrupt_sh = fault if fault is not None else ((), ())
    if with_check or drop_sh or corrupt_sh:
        me = comm.index
        chk = _leg_checksum(ans_b, cnt_b, miss_b, me)  # (S,) per dest block
        if me in corrupt_sh:      # wire corruption: perturb AFTER checksumming
            ans_b = ans_b + (ans_b > 0)
        if me in drop_sh:         # lost packets: data AND checksum zeroed
            ans_b = torch.zeros_like(ans_b)
            cnt_b = torch.zeros_like(cnt_b)
            miss_b = torch.zeros_like(miss_b)
            chk = torch.zeros_like(chk)
    # --- route raw range entries home (matches-only traffic) ---
    ANS = comm.all_to_all(ans_b)
    CNT = comm.all_to_all(cnt_b)
    MISS = comm.all_to_all(miss_b)
    bad = torch.zeros((), dtype=torch.int32, device=dev)
    if with_check:
        # the return a2a puts answerer s's block at position s: recompute
        # each block's checksum with THAT shard's salt and quarantine
        # (zero) mismatches before any key can reach a result row
        CHK = comm.all_to_all(chk)                     # (S,) chk_s[me]
        got = _leg_checksum(ANS, CNT, MISS,
                            torch.arange(S, dtype=torch.int64, device=dev))
        blk_ok = got == CHK                            # (S,)
        bad = (~blk_ok).sum(dtype=torch.int32)
        ANS = torch.where(blk_ok[:, None, None], ANS, 0)
        CNT = torch.where(blk_ok[:, None], CNT, 0)
        MISS = torch.where(blk_ok[:, None], MISS, 0)
    # claim this shard's answers by bucket slot (block s answered shard s)
    dest = torch.arange(S, device=dev)[None, :]
    claim_ok = slot < bucket_cap                       # dropped copies -> 0
    sl = slot.clamp(max=bucket_cap - 1).long()
    cnt_bs = torch.where(claim_ok, CNT[dest, sl], 0)   # (B, S)
    miss_bs = torch.where(claim_ok, MISS[dest, sl], 0)
    # --- offset-compose counts in shard (= global key) order ---
    # resolve each OUTPUT slot p to its (source block, in-block position)
    # from the counts alone, then gather the B x probe_cap selected entries
    # straight out of the a2a answer buffer
    cum = torch.cumsum(cnt_bs, 1)                      # (B, S)
    off = cum - cnt_bs
    total = cum[:, -1]
    p = torch.arange(probe_cap, device=dev)[None, :]   # output slots (1, P)
    src = (cum[:, :, None] <= p[:, None, :]).sum(1)    # (B, P) source block
    src = src.clamp(max=S - 1)
    j = p - off.gather(1, src)                         # in-block position
    slot_sel = sl.gather(1, src)                       # (B, P) bucket slot
    mine = ANS.reshape(S * bucket_cap * probe_cap)[
        (src * bucket_cap + slot_sel) * probe_cap + j]
    mine = torch.where(p < total[:, None], mine, 0)
    mv = mine > 0
    mk = torch.where(mv, mine - 1, 0)
    # --- residual predicate filtering, applied by the origin shard ---
    mv = apply_residual(mk, mv, flt, msk, eq_positions)
    my_missed = (miss_bs.sum(1) + (total - probe_cap).clamp(min=0)
                 + drop_cnt).to(torch.int32)
    if with_check:
        return mk, mv, my_missed, bad
    return mk, mv, my_missed


def dist_probe(lo, hi, flt, msk, eq_positions, local_keys, probe_cap: int,
               comm, impl: str = "kernel", region=None,
               routing: str = "broadcast", splits=None, bucket_cap: int = 0,
               fault=None, with_check: bool = False):
    """Distributed GET: ship probe keys, answer locally, scatter matches
    back to origin shards. lo/hi: (B,) local probes. Returns (k (B, cap),
    valid (B, cap), missed (B,)) on the origin shard.

    routing="a2a" (requires `splits`, the full (S+1,) region boundaries)
    dispatches each probe only to the shards its range intersects via
    _dist_probe_a2a. The broadcast body below is the validated reference;
    both return identical results.

    With `region` = this shard's (excl_lo, incl_hi] key bounds, probes
    whose [lo, hi) range cannot intersect the local slice are masked to
    empty BEFORE the rank-find / residual / compaction work — the
    region-server routing HBase gives the paper for free. Exact: keys are
    unique and globally sorted across shards."""
    if routing == "a2a":
        if splits is None:
            raise ValueError("routing='a2a' needs the stored region splits")
        S = comm.size
        cap = bucket_cap if bucket_cap > 0 else auto_bucket_cap(lo.shape[0], S)
        return _dist_probe_a2a(lo, hi, flt, msk, eq_positions, local_keys,
                               probe_cap, comm, impl, splits, cap,
                               fault=fault, with_check=with_check)
    if routing != "broadcast":
        raise ValueError(f"unknown routing {routing!r}")
    if fault is not None or with_check:
        raise ValueError("fault injection / answer-leg checksums hook the "
                         "a2a answer leg — routing='broadcast' has none")
    S = comm.size
    B = lo.shape[0]
    me = comm.index
    dev = lo.device
    # --- ship probe keys (keys-only traffic) ---
    LO = comm.all_gather(lo).reshape(S * B)
    HI = comm.all_gather(hi).reshape(S * B)
    FLT = comm.all_gather(flt).reshape(S * B, 3)
    if region is not None:   # split-aware routing: answer only what we own
        hit = range_intersects_region(LO, HI, *region)
        LO = torch.where(hit, LO, 0)
        HI = torch.where(hit, HI, 0)
    # --- local index lookups (each shard answers its key range): the
    # fused GET, whose keys at invalid slots the write below masks ---
    k, valid, missed = ops.probe_gather(local_keys, LO, HI, FLT, probe_cap,
                                        msk, eq_positions, impl)
    cnt = valid.sum(-1, dtype=torch.int32)                       # (S*B,)
    # --- compose per-shard offsets so concatenation is exact ---
    CNT = comm.all_gather(cnt)                                   # (S, S*B)
    offset = torch.where(torch.arange(S, device=dev)[:, None] < me,
                         CNT, 0).sum(0)
    total = CNT.sum(0)                                           # (S*B,)
    pos = torch.cumsum(valid, -1) - 1 + offset[:, None]
    keep = valid & (pos < probe_cap)
    slot = torch.where(keep, pos, probe_cap)
    buf = torch.zeros((S * B, probe_cap + 1), dtype=torch.int64, device=dev)
    # rows that are not kept all write 0 to the cut spill column
    buf[torch.arange(S * B, device=dev)[:, None], slot] = torch.where(
        keep, k + 1, 0)                                          # +1: 0 == empty
    buf = buf[:, :probe_cap].reshape(S, B, probe_cap)
    # --- ship matches back (matches-only traffic) ---
    mine = comm.psum_scatter(buf).reshape(B, probe_cap)
    mv = mine > 0
    mk = torch.where(mv, mine - 1, 0)
    MISS = comm.psum(missed) + (total - probe_cap).clamp(min=0)
    my_missed = MISS[me * B:(me + 1) * B]
    return mk, mv, my_missed.to(torch.int32)


def dist_mapsin_step(bnd: Bindings, pattern, local_keys, probe_cap: int,
                     out_cap: int, comm, impl: str = "kernel",
                     shard_splits=None, routing: str = "broadcast",
                     bucket_cap: int = 0) -> Bindings:
    """Algorithm 1, distributed: Omega stays in place; only keys + matches move."""
    plan = make_plan(pattern, bnd.vars)
    lo, hi, flt, msk = probe_inputs(plan, bnd.table, bnd.valid)
    k, valid, missed = dist_probe(lo, hi, flt, msk, plan.eq_positions,
                                  local_keys, probe_cap, comm, impl,
                                  region=_my_region(shard_splits, comm),
                                  routing=routing, splits=shard_splits,
                                  bucket_cap=bucket_cap)
    return merge_bindings(bnd, plan, k, valid, missed, out_cap)


def dist_multiway_step(bnd: Bindings, patterns: Sequence, local_keys,
                       row_cap: int, out_cap: int, comm,
                       impl: str = "kernel", shard_splits=None,
                       routing: str = "broadcast",
                       bucket_cap: int = 0) -> Bindings:
    """Algorithm 3, distributed: ONE row-GET round answers all star patterns
    (saves n-1 collective rounds — the paper's n-1 GETs per mapping); the
    local merge is ``mapsin.multiway_merge``."""
    plans = [make_plan(p, bnd.vars) for p in patterns]
    lo, hi = row_range(plans[0], bnd.table)
    lo = torch.where(bnd.valid, lo, 0)
    hi = torch.where(bnd.valid, hi, 0)
    no_flt = torch.zeros((bnd.capacity, 3), dtype=torch.int64,
                         device=lo.device)
    k, in_row, missed = dist_probe(lo, hi, no_flt, (False,) * 3, (),
                                   local_keys, row_cap, comm, impl,
                                   region=_my_region(shard_splits, comm),
                                   routing=routing, splits=shard_splits,
                                   bucket_cap=bucket_cap)
    return multiway_merge(bnd, plans, k, in_row, missed, out_cap)


# ---------------------------------------------------------------------------
# Batched distributed steps (leading query axis — the sharded serving path)
# ---------------------------------------------------------------------------
#
# A serving batch is Q independent queries of one template. The (Q, cap)
# probe set is FLATTENED to one (Q*cap,) record vector, routed through a
# single dist_probe (one all_to_all pair on the a2a path — the whole batch
# shares the collective), and the strictly-local merge is vmapped back
# over the query axis. Bit-identical to running dist_probe per query:
# routing, answering and offset composition are per-record and
# order-preserving, so flattening only concatenates independent probe sets.


def _vmap_merge(merge, bnd: Bindings, *xs) -> Bindings:
    """``merge(Bindings, *x) -> Bindings`` over the leading query axis of
    batched Bindings (table (Q, cap, nv), valid (Q, cap), overflow (Q,))
    and of `xs`, under ``torch.func.vmap``."""
    out_vars = []

    def one(table, valid, overflow, *x):
        b = merge(Bindings(bnd.vars, table, valid, overflow), *x)
        out_vars.append(b.vars)
        return b.table, b.valid, b.overflow

    t, v, o = torch.func.vmap(one)(bnd.table, bnd.valid, bnd.overflow, *xs)
    return Bindings(out_vars[0], t, v, o)


def dist_probe_batched(lo, hi, flt, msk, eq_positions, local_keys,
                       probe_cap: int, comm, impl: str = "kernel",
                       region=None, routing: str = "broadcast", splits=None,
                       bucket_cap: int = 0, fault=None,
                       with_check: bool = False):
    """dist_probe over a leading query axis: lo/hi (Q, B), flt (Q, B, 3).
    ONE collective round serves all Q queries; with routing="a2a" the
    per-destination `bucket_cap` is sized for the whole flattened batch.
    Returns (k (Q, B, cap), valid (Q, B, cap), missed (Q, B)); with
    ``with_check`` a scalar `bad` (quarantined answer-block count) is
    appended."""
    q, b = lo.shape
    out = dist_probe(
        lo.reshape(q * b), hi.reshape(q * b), flt.reshape(q * b, 3), msk,
        eq_positions, local_keys, probe_cap, comm, impl, region=region,
        routing=routing, splits=splits, bucket_cap=bucket_cap,
        fault=fault, with_check=with_check)
    k, valid, missed = out[:3]
    shaped = (k.reshape(q, b, probe_cap), valid.reshape(q, b, probe_cap),
              missed.reshape(q, b))
    return shaped + (out[3],) if with_check else shaped


def batched_dist_mapsin_step(bnd: Bindings, pattern, local_keys,
                             probe_cap: int, out_cap: int, comm,
                             impl: str = "kernel", shard_splits=None,
                             routing: str = "broadcast",
                             bucket_cap: int = 0, fault=None,
                             with_check: bool = False):
    """dist_mapsin_step over batched Bindings (table (Q, cap, nv), valid
    (Q, cap), overflow (Q,)): one shared collective round, vmapped local
    merge. With ``with_check`` returns ``(Bindings, bad)``."""
    q, cap, nv = bnd.table.shape
    plan = make_plan(pattern, bnd.vars)
    lo, hi, flt, msk = probe_inputs(plan, bnd.table.reshape(q * cap, nv),
                                    bnd.valid.reshape(q * cap))
    out = dist_probe_batched(
        lo.reshape(q, cap), hi.reshape(q, cap), flt.reshape(q, cap, 3), msk,
        plan.eq_positions, local_keys, probe_cap, comm, impl,
        region=_my_region(shard_splits, comm), routing=routing,
        splits=shard_splits, bucket_cap=bucket_cap,
        fault=fault, with_check=with_check)
    merged = _vmap_merge(
        lambda b, kk, vv, mm: merge_bindings(b, plan, kk, vv, mm, out_cap),
        bnd, *out[:3])
    return (merged, out[3]) if with_check else merged


def batched_dist_multiway_step(bnd: Bindings, patterns: Sequence, local_keys,
                               row_cap: int, out_cap: int, comm,
                               impl: str = "kernel", shard_splits=None,
                               routing: str = "broadcast",
                               bucket_cap: int = 0, fault=None,
                               with_check: bool = False):
    """dist_multiway_step over batched Bindings: the single row-GET round
    is shared by the whole batch, the per-pattern merge tail is vmapped.
    With ``with_check`` returns ``(Bindings, bad)``."""
    q, cap, nv = bnd.table.shape
    plans = [make_plan(p, bnd.vars) for p in patterns]
    flat = bnd.table.reshape(q * cap, nv)
    lo, hi = row_range(plans[0], flat)
    v = bnd.valid.reshape(q * cap)
    lo = torch.where(v, lo, 0).reshape(q, cap)
    hi = torch.where(v, hi, 0).reshape(q, cap)
    no_flt = torch.zeros((q, cap, 3), dtype=torch.int64, device=lo.device)
    out = dist_probe_batched(
        lo, hi, no_flt, (False,) * 3, (), local_keys, row_cap, comm, impl,
        region=_my_region(shard_splits, comm), routing=routing,
        splits=shard_splits, bucket_cap=bucket_cap,
        fault=fault, with_check=with_check)
    merged = _vmap_merge(
        lambda b, kk, rr, mm: multiway_merge(b, plans, kk, rr, mm, out_cap),
        bnd, *out[:3])
    return (merged, out[3]) if with_check else merged


# ---------------------------------------------------------------------------
# Repartitioning (the reduce-side shuffle primitive)
# ---------------------------------------------------------------------------


def repartition(table: torch.Tensor, valid: torch.Tensor, key: torch.Tensor,
                bucket_cap: int, comm):
    """Hash-partition rows by key across shards (the shuffle phase): a row
    goes to shard ``key % S`` (term ids are non-negative, so torch's `%`
    and jnp's agree).

    Returns (table (S*cap, nv), valid, dropped) — rows received by this
    shard, and the rows dropped by bucket overflow on every shard.
    """
    S = comm.size
    nv = table.shape[1]
    send = valid[:, None] & (key[:, None] % S
                             == torch.arange(S, device=key.device)[None, :])
    (buf, vbuf), _, drop_cnt = bucket_rows(send, bucket_cap, [table, valid])
    # the shuffle: BOTH relations cross the network in full
    recv = comm.all_to_all(buf)
    vrecv = comm.all_to_all(vbuf)
    return (recv.reshape(S * bucket_cap, nv), vrecv.reshape(S * bucket_cap),
            comm.psum(drop_cnt.sum(dtype=torch.int32)))
