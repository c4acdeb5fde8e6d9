"""The fused MAPSIN GET: the plain PyTorch version and the launch of the
hand-written CUDA kernel (``csrc/probe_gather.cu``).

For B probe ranges [lo, hi) over the sorted int64 index, both return
  k      (B, cap) int64 — the first `cap` keys of each range, 0 where invalid;
  valid  (B, cap) bool  — in range, equal to the residual values at the
                          `flt_mask` positions, and equal across every
                          `eq_positions` repeat;
  missed (B,) int32     — max(rank(hi) - rank(lo) - cap, 0), residual-free;
the contract of the TPU kernel ``repro.kernels.ops.probe_gather``.

``probe_compact`` is the GET with the MAPSIN merge behind it: for a
binding table (B, nv) int32 it returns the step's rows themselves,
  table   (out_cap, nv + len(new_pos)) int32 — in (probe, slot) order, each
          match's binding followed by its key's fields at `new_pos`, the
          first `out_cap` kept and zeros after them;
  valid   (out_cap,) bool; dropped () int32, the matches past out_cap;
  over    () int32, the matches less out_cap; missed (B,) as above;
what ``core/mapsin.py`` ``merge_bindings`` makes of ``probe_gather``'s
outputs, with no (B, cap) temporary on the card: its kernels count each
probe's matches, scan the counts and write the rows (``csrc/
probe_gather.cu``). Its plain version is that composition.

``multiway_compact`` is one pattern of the multiway star join: for rows
(table (R, nv) int32, valid (R,)), each from the binding origin[r] whose
fetched row is the rank range [start, end) of that binding, it returns
  table   (out_cap, nv + len(new_pos)) int32 — in (row, slot) order, each
          row with a key among the first `row_cap` of its range that
          passes the pattern's residual, prefix and repeat tests,
          followed by that key's fields at `new_pos`; zeros after the
          first `out_cap`;
  valid   (out_cap,) bool; dropped () int32; over () int32 as above;
  origin  (out_cap,) int32, each kept row's binding, zeros after;
what ``core/mapsin.py`` ``multiway_match`` makes of the gathered row,
with no (R, row_cap) temporary on the card: the same count, scan and
emit. Its plain version is that composition.

``sort_merge_compact`` is the reduce phase's merge of the reduce-side
join after its sort: for right rows (rts (M, nvr) int32, rvs (M,)) in
the order of their sorted int32 join keys rks (M,) and left rows (lt (L,
nvl) int32, lv (L,)), it returns
  table   (out_cap, nvl + len(r_out_cols)) int32 — in (left row, window)
          order: each valid left row's columns, then `r_out_cols` of one
          valid right row among the first `probe_cap` whose key equals
          the left row's at `lkey_col`, each `extra_eq` pair (left
          column, right column) equal; zeros after the first `out_cap`;
  valid   (out_cap,) bool; over () int32, the matches less out_cap;
  dropped () int32, max(over, 0) plus each valid left row's equal keys
          past probe_cap;
what ``core/reduce_side.py`` ``sort_merge_join`` made of its (L,
probe_cap) window grid and ``compact``, with no grid on the card: the
same count, scan and emit. Its plain version is that grid.
``kernels/ops.py`` chooses between the versions.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.searchsorted import check_tensor

# intra-pattern repeat (a, b), a < b -> its bit in the kernel's eq_mask
_EQ_BIT = {(0, 1): 1, (0, 2): 2, (1, 2): 4}


def encode_masks(flt_mask: tuple, eq_positions: tuple) -> tuple[int, int]:
    """(fmask, eq_mask): the kernel's bit masks of the residual positions
    and of the intra-pattern repeats."""
    if len(flt_mask) != 3:
        raise ValueError(f"probe_gather: flt_mask needs 3 flags, got {flt_mask}")
    eq_mask = 0
    for a, c in eq_positions:
        pair = (min(a, c), max(a, c))
        if pair not in _EQ_BIT:
            raise ValueError(f"probe_gather: bad eq position pair {(a, c)}")
        eq_mask |= _EQ_BIT[pair]
    return sum(1 << p for p in range(3) if flt_mask[p]), eq_mask


def decode_masks(fmask: int, eq_mask: int) -> tuple[tuple, tuple]:
    """(flt_mask, eq_positions) of `encode_masks`' bit masks."""
    return (tuple(bool(fmask >> p & 1) for p in range(3)),
            tuple(pair for pair, bit in _EQ_BIT.items() if eq_mask & bit))


def probe_gather_plain(keys: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                       flt: torch.Tensor, cap: int,
                       flt_mask: tuple = (False, False, False),
                       eq_positions: tuple = ()):
    """The plain version: the ``gather_range`` + ``apply_residual``
    composition of core/mapsin.py, with 0 written at invalid slots."""
    # imported here: core/mapsin.py imports this package at its top level
    from repro_torch.core.mapsin import apply_residual, gather_range
    k, valid, missed = gather_range(keys, lo, hi, cap, impl="torch")
    valid = apply_residual(k, valid, flt, flt_mask, eq_positions)
    return torch.where(valid, k, 0), valid, missed


@functools.cache               # argument types are set once per process
def _fn():
    fn = _build.library("probe_gather").probe_gather_i64
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def probe_gather_cuda(keys: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                      flt: torch.Tensor, cap: int,
                      flt_mask: tuple = (False, False, False),
                      eq_positions: tuple = ()):
    """Launch the CUDA kernel on the current stream. keys: (M,) int64
    sorted; lo/hi: (B,) int64; flt: (B, 3) int64; all contiguous on one
    CUDA device. Returns (k, valid, missed) as described above."""
    # imported here: importing core/ runs core/bgp.py, which imports ops
    from repro_torch.core.rdf import BITS
    check_tensor(keys, "keys", torch.int64, (None,))
    dev = keys.device
    check_tensor(lo, "lo", torch.int64, (None,), dev)
    b = lo.shape[0]
    check_tensor(hi, "hi", torch.int64, (b,), dev)
    check_tensor(flt, "flt", torch.int64, (b, 3), dev)
    if not 1 <= int(cap) < 2 ** 31:
        raise ValueError(f"probe_gather: cap must be in [1, 2^31), got {cap}")
    fmask, eq_mask = encode_masks(flt_mask, eq_positions)
    cap = int(cap)
    k = torch.empty((b, cap), dtype=torch.int64, device=dev)
    valid = torch.empty((b, cap), dtype=torch.bool, device=dev)
    missed = torch.empty((b,), dtype=torch.int32, device=dev)
    if b == 0:
        return k, valid, missed
    fn = _fn()
    with torch.cuda.device(dev):
        rc = fn(keys.data_ptr(), keys.numel(), lo.data_ptr(), hi.data_ptr(),
                flt.data_ptr(), b, cap, fmask, eq_mask, BITS, k.data_ptr(),
                valid.data_ptr(), missed.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"probe_gather kernel launch failed: CUDA error {rc}")
    return k, valid, missed


def probe_compact_plain(keys: torch.Tensor, lo: torch.Tensor,
                        hi: torch.Tensor, flt: torch.Tensor,
                        table: torch.Tensor, cap: int, out_cap: int,
                        flt_mask: tuple = (False, False, False),
                        eq_positions: tuple = (), new_pos: tuple = ()):
    """The plain version: ``probe_gather_plain``, then ``merge_bindings``'
    arithmetic (core/mapsin.py ``merge_matches``). Returns (table, valid,
    dropped, over, missed) as described above."""
    from repro_torch.core.mapsin import merge_matches
    k, match, missed = probe_gather_plain(keys, lo, hi, flt, cap, flt_mask,
                                          eq_positions)
    out, valid, dropped = merge_matches(table, k, match, new_pos, out_cap)
    over = match.sum(dtype=torch.int32) - out_cap
    return out, valid, dropped, over, missed


@functools.cache
def _compact_fns():
    lib = _build.library("probe_gather")
    count, emit = lib.probe_count_i64, lib.probe_emit_i64
    p, i64, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    count.argtypes = [p, i64, p, p, p, i64, i, i, i, i, p, p, p, p]
    emit.argtypes = [p, i64, p, p, i, p, p, p, i64, i64, i, i, i, i, i, i,
                     p, p, p, p, p]
    count.restype = emit.restype = ctypes.c_int
    return count, emit


def probe_compact_cuda(keys: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                       flt: torch.Tensor, table: torch.Tensor, cap: int,
                       out_cap: int, flt_mask: tuple = (False, False, False),
                       eq_positions: tuple = (), new_pos: tuple = ()):
    """Launch probe_compact's kernels on the current stream for S slots of
    B probes, each slot compacted into its own out_cap rows. keys: (M,)
    int64 sorted; lo/hi: (S, B) int64; flt: (S, B, 3) int64; table: (S, B,
    nv) int32; all contiguous on one CUDA device. Returns (table (S,
    out_cap, w), valid (S, out_cap), dropped (S,), over (S,), missed (S,
    B)), each slot as described above."""
    from repro_torch.core.rdf import BITS
    check_tensor(keys, "keys", torch.int64, (None,))
    dev = keys.device
    check_tensor(lo, "lo", torch.int64, (None, None), dev)
    s, b = lo.shape
    check_tensor(hi, "hi", torch.int64, (s, b), dev)
    check_tensor(flt, "flt", torch.int64, (s, b, 3), dev)
    check_tensor(table, "table", torch.int32, (s, b, None), dev)
    cap, out_cap = int(cap), int(out_cap)
    if not 1 <= cap < 2 ** 31 or not 0 <= out_cap < 2 ** 31:
        raise ValueError(f"probe_compact: cap must be in [1, 2^31) and "
                         f"out_cap in [0, 2^31), got {cap} and {out_cap}")
    if b * cap >= 2 ** 31 or s > 65535:
        raise ValueError(f"probe_compact: a slot's B * cap must stay below "
                         f"2^31 and the slots at most 65535, got B={b}, "
                         f"cap={cap}, {s} slots")
    if len(new_pos) > 3 or any(q not in (0, 1, 2) for q in new_pos):
        raise ValueError(f"probe_compact: bad new positions {new_pos}")
    fmask, eq_mask = encode_masks(flt_mask, eq_positions)
    nv = table.shape[2]
    out = torch.empty((s, out_cap, nv + len(new_pos)), dtype=torch.int32,
                      device=dev)
    valid = torch.empty((s, out_cap), dtype=torch.bool, device=dev)
    dropped = torch.empty((s,), dtype=torch.int32, device=dev)
    over = torch.empty((s,), dtype=torch.int32, device=dev)
    missed = torch.empty((s, b), dtype=torch.int32, device=dev)
    if s * b == 0:
        out.zero_()
        valid.zero_()
        dropped.zero_()
        over.fill_(-out_cap)
        return out, valid, dropped, over, missed
    start = torch.empty((s, b), dtype=torch.int64, device=dev)
    count = torch.empty((s, b), dtype=torch.int32, device=dev)
    count_fn, emit_fn = _compact_fns()
    stream = torch.cuda.current_stream(dev).cuda_stream
    packed = sum(q << (2 * i) for i, q in enumerate(new_pos))
    with torch.cuda.device(dev):
        rc = count_fn(keys.data_ptr(), keys.numel(), lo.data_ptr(),
                      hi.data_ptr(), flt.data_ptr(), s * b, cap, fmask,
                      eq_mask, BITS, start.data_ptr(), count.data_ptr(),
                      missed.data_ptr(), stream)
        if rc == 0:
            incl = torch.cumsum(count, dim=1, dtype=torch.int32)
            rc = emit_fn(keys.data_ptr(), keys.numel(), flt.data_ptr(),
                         table.data_ptr(), nv, start.data_ptr(),
                         count.data_ptr(), incl.data_ptr(), s, b, out_cap,
                         fmask, eq_mask, BITS, packed, len(new_pos),
                         out.data_ptr(), valid.data_ptr(), dropped.data_ptr(),
                         over.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"probe_compact kernel launch failed: CUDA error "
                           f"{rc}")
    return out, valid, dropped, over, missed


def multiway_compact_plain(keys: torch.Tensor, start: torch.Tensor,
                           end: torch.Tensor, flt: torch.Tensor,
                           extra: torch.Tensor, origin: torch.Tensor,
                           table: torch.Tensor, valid: torch.Tensor,
                           row_cap: int, out_cap: int,
                           flt_mask: tuple = (False, False, False),
                           extra_mask: tuple = (False, False, False),
                           eq_positions: tuple = (), new_pos: tuple = ()):
    """The plain version: the first `row_cap` keys of each binding's
    range (core/mapsin.py ``range_slots``), then ``multiway_match``.
    Returns (table, valid, dropped, over, origin) as described above."""
    from repro_torch.core.mapsin import multiway_match, range_slots
    k, in_row = range_slots(keys, start, end, row_cap)
    out, vmask, dropped, ori = multiway_match(
        table, valid, origin, k, in_row, flt, flt_mask, extra, extra_mask,
        eq_positions, new_pos, out_cap)
    # the rows found are the kept ones and the dropped ones
    over = vmask.sum(dtype=torch.int32) + dropped - out_cap
    return out, vmask, dropped, over, ori


@functools.cache
def _multiway_fns():
    lib = _build.library("probe_gather")
    count, emit = lib.multiway_count_i64, lib.multiway_emit_i64
    p, i64, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    count.argtypes = [p, p, p, p, p, p, p, i64, i64, i64, i, i, i, i, i, p, p]
    emit.argtypes = [p, p, p, p, p, p, p, i, p, p, i64, i64, i64, i, i, i, i,
                     i, i, i, i, p, p, p, p, p, p]
    count.restype = emit.restype = ctypes.c_int
    return count, emit


def multiway_compact_cuda(keys: torch.Tensor, start: torch.Tensor,
                          end: torch.Tensor, flt: torch.Tensor,
                          extra: torch.Tensor, origin: torch.Tensor,
                          table: torch.Tensor, valid: torch.Tensor,
                          row_cap: int, out_cap: int,
                          flt_mask: tuple = (False, False, False),
                          extra_mask: tuple = (False, False, False),
                          eq_positions: tuple = (), new_pos: tuple = ()):
    """Launch multiway_compact's kernels on the current stream for S slots,
    each of B bindings and R rows compacted into its own out_cap rows.
    keys: (M,) int64 sorted; start/end: (S, B) int64 ranks; flt/extra:
    (S, B, 3) int64; origin: (S, R) int32; table: (S, R, nv) int32;
    valid: (S, R) bool; all contiguous on one CUDA device. Returns (table
    (S, out_cap, w), valid (S, out_cap), dropped (S,), over (S,), origin
    (S, out_cap)), each slot as described above."""
    from repro_torch.core.rdf import BITS
    check_tensor(keys, "keys", torch.int64, (None,))
    dev = keys.device
    check_tensor(start, "start", torch.int64, (None, None), dev)
    s, b = start.shape
    check_tensor(end, "end", torch.int64, (s, b), dev)
    check_tensor(flt, "flt", torch.int64, (s, b, 3), dev)
    check_tensor(extra, "extra", torch.int64, (s, b, 3), dev)
    check_tensor(origin, "origin", torch.int32, (s, None), dev)
    r = origin.shape[1]
    check_tensor(table, "table", torch.int32, (s, r, None), dev)
    check_tensor(valid, "valid", torch.bool, (s, r), dev)
    row_cap, out_cap = int(row_cap), int(out_cap)
    if not 1 <= row_cap < 2 ** 31 or not 0 <= out_cap < 2 ** 31:
        raise ValueError(f"multiway_compact: row_cap must be in [1, 2^31) "
                         f"and out_cap in [0, 2^31), got {row_cap} and "
                         f"{out_cap}")
    if r * row_cap >= 2 ** 31 or s > 65535:
        raise ValueError(f"multiway_compact: a slot's R * row_cap must stay "
                         f"below 2^31 and the slots at most 65535, got "
                         f"R={r}, row_cap={row_cap}, {s} slots")
    if len(new_pos) > 3 or any(q not in (0, 1, 2) for q in new_pos):
        raise ValueError(f"multiway_compact: bad new positions {new_pos}")
    fmask, eq_mask = encode_masks(flt_mask, eq_positions)
    xmask, _ = encode_masks(extra_mask, ())
    nv = table.shape[2]
    out = torch.empty((s, out_cap, nv + len(new_pos)), dtype=torch.int32,
                      device=dev)
    out_valid = torch.empty((s, out_cap), dtype=torch.bool, device=dev)
    dropped = torch.empty((s,), dtype=torch.int32, device=dev)
    over = torch.empty((s,), dtype=torch.int32, device=dev)
    out_origin = torch.empty((s, out_cap), dtype=torch.int32, device=dev)
    if s * r == 0:
        for x in (out, out_valid, dropped, out_origin):
            x.zero_()
        over.fill_(-out_cap)
        return out, out_valid, dropped, over, out_origin
    count = torch.empty((s, r), dtype=torch.int32, device=dev)
    count_fn, emit_fn = _multiway_fns()
    stream = torch.cuda.current_stream(dev).cuda_stream
    packed = sum(q << (2 * i) for i, q in enumerate(new_pos))
    with torch.cuda.device(dev):
        rc = count_fn(keys.data_ptr(), start.data_ptr(), end.data_ptr(),
                      flt.data_ptr(), extra.data_ptr(), origin.data_ptr(),
                      valid.data_ptr(), s * r, r, b, row_cap, fmask, xmask,
                      eq_mask, BITS, count.data_ptr(), stream)
        if rc == 0:
            incl = torch.cumsum(count, dim=1, dtype=torch.int32)
            rc = emit_fn(keys.data_ptr(), start.data_ptr(), end.data_ptr(),
                         flt.data_ptr(), extra.data_ptr(), origin.data_ptr(),
                         table.data_ptr(), nv, count.data_ptr(),
                         incl.data_ptr(), s, r, b, row_cap, out_cap, fmask,
                         xmask, eq_mask, BITS, packed, len(new_pos),
                         out.data_ptr(), out_valid.data_ptr(),
                         out_origin.data_ptr(), dropped.data_ptr(),
                         over.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"multiway_compact kernel launch failed: CUDA "
                           f"error {rc}")
    return out, out_valid, dropped, over, out_origin


def sort_merge_compact_plain(rks: torch.Tensor, rts: torch.Tensor,
                             rvs: torch.Tensor, lt: torch.Tensor,
                             lv: torch.Tensor, lkey_col: int,
                             extra_eq: tuple, r_out_cols: tuple,
                             probe_cap: int, out_cap: int):
    """The plain version: each left row's window of `probe_cap` slots
    into the sorted relation, the right rows gathered into the (L,
    probe_cap) grid, then core/mapsin.py ``compact``. Returns (table,
    valid, dropped, over) as described above."""
    from repro_torch.core.mapsin import compact
    dev = lt.device
    lkey = lt[:, lkey_col].contiguous()
    lo = torch.searchsorted(rks, lkey)
    hi = torch.searchsorted(rks, lkey, right=True)
    idx = lo[:, None] + torch.arange(probe_cap, device=dev)[None]
    m = rks.shape[0]
    take = idx.clamp(max=m - 1)
    match = (idx < hi[:, None]) & lv[:, None] & rvs[take]
    missed = (hi - lo - probe_cap).clamp(min=0)
    rrows = rts[take]                                    # (L, cap, nvr)
    for la, ra in extra_eq:
        match = match & (lt[:, la][:, None] == rrows[..., ra])
    lrows = lt[:, None, :].expand(lt.shape[0], probe_cap, lt.shape[1])
    cols = [lrows] + [rrows[..., c][..., None] for c in r_out_cols]
    rows = torch.cat(cols, dim=-1).reshape(lt.shape[0] * probe_cap,
                                           lt.shape[1] + len(r_out_cols))
    table, vmask, dropped = compact(rows, match.reshape(-1), out_cap)
    dropped = dropped + torch.where(lv, missed, 0).sum().to(torch.int32)
    over = match.sum(dtype=torch.int32) - out_cap
    return table, vmask, dropped, over


def _columns(cols, width: int, what: str) -> int:
    """`cols` (at most 3, each below `width`) packed eight bits each."""
    if len(cols) > 3 or any(not 0 <= c < width for c in cols):
        raise ValueError(f"sort_merge_compact: bad {what} {tuple(cols)} "
                         f"for {width} columns")
    return sum(int(c) << (8 * i) for i, c in enumerate(cols))


@functools.cache
def _sort_merge_fns():
    lib = _build.library("probe_gather")
    count, emit = lib.sort_merge_count_i32, lib.sort_merge_emit_i32
    p, i64, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    count.argtypes = [p, i64, p, i, p, p, i, p, i64, i, i, i, i, i, p, p, p]
    emit.argtypes = [p, i, p, p, i, i64, p, p, p, i, i, i, i, i, i, p, p, p,
                     p, p]
    count.restype = emit.restype = ctypes.c_int
    return count, emit


def sort_merge_compact_cuda(rks: torch.Tensor, rts: torch.Tensor,
                            rvs: torch.Tensor, lt: torch.Tensor,
                            lv: torch.Tensor, lkey_col: int,
                            extra_eq: tuple, r_out_cols: tuple,
                            probe_cap: int, out_cap: int):
    """Launch sort_merge_compact's kernels on the current stream. rks: (M,)
    int32 sorted; rts: (M, nvr) int32; rvs: (M,) bool; lt: (L, nvl) int32;
    lv: (L,) bool; all contiguous on one CUDA device, nvl and nvr below
    256, at most 3 extra_eq pairs and 3 r_out_cols. Returns (table,
    valid, dropped, over) as described above."""
    check_tensor(rks, "rks", torch.int32, (None,))
    dev = rks.device
    m = rks.shape[0]
    check_tensor(rts, "rts", torch.int32, (m, None), dev)
    check_tensor(rvs, "rvs", torch.bool, (m,), dev)
    check_tensor(lt, "lt", torch.int32, (None, None), dev)
    l, nvl = lt.shape
    check_tensor(lv, "lv", torch.bool, (l,), dev)
    nvr = rts.shape[1]
    probe_cap, out_cap = int(probe_cap), int(out_cap)
    if not 1 <= probe_cap < 2 ** 31 or not 0 <= out_cap < 2 ** 31:
        raise ValueError(f"sort_merge_compact: probe_cap must be in [1, "
                         f"2^31) and out_cap in [0, 2^31), got {probe_cap} "
                         f"and {out_cap}")
    if l * probe_cap >= 2 ** 31 or m >= 2 ** 31 or max(nvl, nvr) > 255:
        raise ValueError(f"sort_merge_compact: L * probe_cap and M must stay "
                         f"below 2^31 and the widths below 256, got L={l}, "
                         f"probe_cap={probe_cap}, M={m}, widths {nvl}, {nvr}")
    if not 0 <= lkey_col < nvl:
        raise ValueError(f"sort_merge_compact: bad key column {lkey_col}")
    eq_left = _columns([a for a, _ in extra_eq], nvl, "extra_eq")
    eq_right = _columns([c for _, c in extra_eq], nvr, "extra_eq")
    r_out = _columns(r_out_cols, nvr, "r_out_cols")
    w = nvl + len(r_out_cols)
    out = torch.empty((out_cap, w), dtype=torch.int32, device=dev)
    valid = torch.empty((out_cap,), dtype=torch.bool, device=dev)
    dropped = torch.empty((), dtype=torch.int32, device=dev)
    over = torch.empty((), dtype=torch.int32, device=dev)
    if l == 0:
        for x in (out, valid, dropped):
            x.zero_()
        over.fill_(-out_cap)
        return out, valid, dropped, over
    cm = torch.empty((2 * l,), dtype=torch.int32, device=dev)
    win = torch.empty((2 * l,), dtype=torch.int32, device=dev)
    count_fn, emit_fn = _sort_merge_fns()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = count_fn(rks.data_ptr(), m, rts.data_ptr(), nvr, rvs.data_ptr(),
                      lt.data_ptr(), nvl, lv.data_ptr(), l, int(lkey_col),
                      probe_cap, len(extra_eq), eq_left, eq_right,
                      cm.data_ptr(), win.data_ptr(), stream)
        if rc == 0:
            # the counts, then the missed rows: one scan gives both sums
            incl = torch.cumsum(cm, dim=0, dtype=torch.int32)
            rc = emit_fn(rts.data_ptr(), nvr, rvs.data_ptr(), lt.data_ptr(),
                         nvl, l, cm.data_ptr(), incl.data_ptr(),
                         win.data_ptr(), out_cap, len(extra_eq), eq_left,
                         eq_right, r_out, len(r_out_cols), out.data_ptr(),
                         valid.data_ptr(), dropped.data_ptr(),
                         over.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"sort_merge_compact kernel launch failed: CUDA "
                           f"error {rc}")
    return out, valid, dropped, over
