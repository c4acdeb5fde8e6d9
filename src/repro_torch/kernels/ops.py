"""Dispatching wrappers around the hand-written kernels, with their launch
counters.

``impl="kernel"`` (the default) launches the CUDA kernel for a CUDA tensor,
or raises; for a tensor on the CPU, where the kernel cannot run, it takes
the plain PyTorch version. ``impl="torch"`` takes the plain version on any
device. There is no fallback from a failed launch.

The index kernels are ``torch.library`` custom ops,
``repro_torch::searchsorted``, ``repro_torch::probe_gather``,
``repro_torch::probe_compact`` (the GET and the MAPSIN merge in one: its
two kernels and the scan between them, one launch in ``launches``) and
``repro_torch::multiway_compact`` (one star pattern's rows from the
multiway row-GET's ranks, built the same way) and
``repro_torch::sort_merge_compact`` (the reduce-side join's merge after
its sort, built the same way): the CPU implementation is the plain
version and the CUDA one the kernel's launch.
Each but sort_merge_compact (the serving engine runs no reduce-side
step) has a ``torch.func.vmap`` rule for the serving engine, which runs one
query's cascade under ``vmap`` for a whole batch of same-template queries:
the store's keys are shared by every slot, so the rule folds the batch
into the query dimension and launches once for the batch (``vmap_folds``
counts the folded calls). The plain route vmaps natively.

``launches`` counts kernel launches by name: each wrapper adds one where it
launches its kernel and nowhere else, so a run can show that it went
through the kernels. ``flash_attention_variants`` splits flash_attention's
launches, counted in the same place, by the kernel that ran
(``kernels/flash_attention.py variant``). The counters are shared by the
threads of a ``LocalMesh`` (``core/collectives.py``), one a shard, so
every count goes through one lock.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import probe_gather as _pg
from repro_torch.kernels import searchsorted as _ss

IMPLS = ("kernel", "torch")

launches = {"searchsorted": 0, "probe_gather": 0, "probe_compact": 0,
            "multiway_compact": 0, "sort_merge_compact": 0,
            "flash_attention": 0}
# flash_attention's launches by kernel: "wgmma" (tensor cores) or "simt"
flash_attention_variants = {"wgmma": 0, "simt": 0}
# calls of a vmap rule that folded a batch into one call of the op
vmap_folds = {"searchsorted": 0, "probe_gather": 0, "probe_compact": 0,
              "multiway_compact": 0}
_count_lock = threading.Lock()


def _count(counts: dict, name: str, n: int = 1) -> None:
    with _count_lock:
        counts[name] += n


def reset_launches() -> None:
    for counts in (launches, flash_attention_variants, vmap_folds):
        for name in counts:
            counts[name] = 0


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")


def _use_kernel(impl: str, t: torch.Tensor) -> bool:
    _check_impl(impl)
    return impl == "kernel" and t.device.type != "cpu"


def _fold(x: torch.Tensor, bdim: int | None, n: int) -> torch.Tensor:
    """`x` of n slots, its batch dim `bdim` (None: shared by every slot)
    moved to the front and folded into its first dim, contiguous."""
    x = x.expand(n, *x.shape) if bdim is None else x.movedim(bdim, 0)
    return x.reshape(n * x.shape[1], *x.shape[2:]).contiguous()


def _slot_shape(x: torch.Tensor, bdim: int | None) -> torch.Size:
    """The shape of one slot of `x` (all of it when unbatched)."""
    return x.shape if bdim is None else x.movedim(bdim, 0).shape[1:]


def _shared_keys(name: str, in_dims) -> None:
    if in_dims[0] is not None:
        raise ValueError(f"{name}: the keys are shared by every slot of a "
                         f"batch and cannot be batched under vmap")


# --- searchsorted ---------------------------------------------------------


@torch.library.custom_op("repro_torch::searchsorted", mutates_args=(),
                         device_types="cpu")
def _searchsorted_op(keys: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    return _ss.searchsorted_plain(keys, queries)


@_searchsorted_op.register_kernel("cuda")
def _searchsorted_launch(keys: torch.Tensor,
                         queries: torch.Tensor) -> torch.Tensor:
    out = _ss.searchsorted_cuda(keys, queries)
    _count(launches, "searchsorted", int(queries.numel() > 0))
    return out


@_searchsorted_op.register_fake
def _(keys, queries):
    return torch.empty_like(queries)


def _searchsorted_vmap(info, in_dims, keys, queries):
    _shared_keys("searchsorted", in_dims)
    n = info.batch_size
    flat = _fold(queries, in_dims[1], n)
    _count(vmap_folds, "searchsorted")
    return _searchsorted_op(keys, flat).view(
        n, *_slot_shape(queries, in_dims[1])), 0


_searchsorted_op.register_vmap(_searchsorted_vmap)


def searchsorted(keys: torch.Tensor, queries: torch.Tensor,
                 impl: str = "kernel") -> torch.Tensor:
    """Left ranks (int64) of packed int64 queries in sorted packed keys."""
    _check_impl(impl)
    if impl == "torch":
        return _ss.searchsorted_plain(keys, queries)
    return _searchsorted_op(keys, queries)


# --- probe_gather -----------------------------------------------------------


@torch.library.custom_op("repro_torch::probe_gather", mutates_args=(),
                         device_types="cpu")
def _probe_gather_op(keys: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                     flt: torch.Tensor, cap: int, fmask: int,
                     eq_mask: int) -> tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    return _pg.probe_gather_plain(keys, lo, hi, flt, cap,
                                  *_pg.decode_masks(fmask, eq_mask))


@_probe_gather_op.register_kernel("cuda")
def _probe_gather_launch(keys, lo, hi, flt, cap, fmask, eq_mask):
    out = _pg.probe_gather_cuda(keys, lo, hi, flt, cap,
                                *_pg.decode_masks(fmask, eq_mask))
    _count(launches, "probe_gather", int(lo.numel() > 0))
    return out


@_probe_gather_op.register_fake
def _(keys, lo, hi, flt, cap, fmask, eq_mask):
    b = lo.shape[0]
    return (lo.new_empty((b, cap)), lo.new_empty((b, cap), dtype=torch.bool),
            lo.new_empty((b,), dtype=torch.int32))


def _probe_gather_vmap(info, in_dims, keys, lo, hi, flt, cap, fmask, eq_mask):
    _shared_keys("probe_gather", in_dims)
    n = info.batch_size
    b = _slot_shape(lo, in_dims[1])[0]
    folded = [_fold(x, d, n) for x, d in zip((lo, hi, flt), in_dims[1:4])]
    _count(vmap_folds, "probe_gather")
    k, valid, missed = _probe_gather_op(keys, *folded, cap, fmask, eq_mask)
    return ((k.view(n, b, cap), valid.view(n, b, cap), missed.view(n, b)),
            (0, 0, 0))


_probe_gather_op.register_vmap(_probe_gather_vmap)


def probe_gather(keys: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                 flt: torch.Tensor, cap: int,
                 flt_mask: tuple = (False, False, False),
                 eq_positions: tuple = (), impl: str = "kernel"):
    """Fused MAPSIN probe on packed int64 keys. Returns (k (B, cap) int64
    match keys, 0 where invalid; valid (B, cap) bool; missed (B,) int32)."""
    _check_impl(impl)
    if impl == "torch":
        return _pg.probe_gather_plain(keys, lo, hi, flt, cap, flt_mask,
                                      eq_positions)
    return _probe_gather_op(keys, lo, hi, flt, int(cap),
                            *_pg.encode_masks(flt_mask, eq_positions))


# --- probe_compact ----------------------------------------------------------
# The op takes a leading slot dimension, S slots of B probes each compacted
# into its own out_cap rows, so that its vmap rule folds a batch into S.


@torch.library.custom_op("repro_torch::probe_compact", mutates_args=(),
                         device_types="cpu")
def _probe_compact_op(keys: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                      flt: torch.Tensor, table: torch.Tensor, cap: int,
                      out_cap: int, fmask: int, eq_mask: int,
                      new_pos: list[int]) -> tuple[torch.Tensor, torch.Tensor,
                                                   torch.Tensor, torch.Tensor,
                                                   torch.Tensor]:
    masks = _pg.decode_masks(fmask, eq_mask)
    slots = [_pg.probe_compact_plain(keys, lo[i], hi[i], flt[i], table[i], cap,
                                     out_cap, *masks, tuple(new_pos))
             for i in range(lo.shape[0])]
    return tuple(torch.stack(x) for x in zip(*slots))


@_probe_compact_op.register_kernel("cuda")
def _probe_compact_launch(keys, lo, hi, flt, table, cap, out_cap, fmask,
                          eq_mask, new_pos):
    out = _pg.probe_compact_cuda(keys, lo, hi, flt, table, cap, out_cap,
                                 *_pg.decode_masks(fmask, eq_mask),
                                 tuple(new_pos))
    _count(launches, "probe_compact", int(lo.numel() > 0))
    return out


@_probe_compact_op.register_fake
def _(keys, lo, hi, flt, table, cap, out_cap, fmask, eq_mask, new_pos):
    s, b = lo.shape
    i32 = dict(dtype=torch.int32)
    return (lo.new_empty((s, out_cap, table.shape[2] + len(new_pos)), **i32),
            lo.new_empty((s, out_cap), dtype=torch.bool),
            lo.new_empty((s,), **i32), lo.new_empty((s,), **i32),
            lo.new_empty((s, b), **i32))


def _probe_compact_vmap(info, in_dims, keys, lo, hi, flt, table, cap, out_cap,
                        fmask, eq_mask, new_pos):
    _shared_keys("probe_compact", in_dims)
    n = info.batch_size
    s = _slot_shape(lo, in_dims[1])[0]
    folded = [_fold(x, d, n) for x, d in zip((lo, hi, flt, table),
                                             in_dims[1:5])]
    _count(vmap_folds, "probe_compact")
    outs = _probe_compact_op(keys, *folded, cap, out_cap, fmask, eq_mask,
                             new_pos)
    return tuple(o.view(n, s, *o.shape[1:]) for o in outs), (0,) * 5


_probe_compact_op.register_vmap(_probe_compact_vmap)


def probe_compact(keys: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                  flt: torch.Tensor, table: torch.Tensor, cap: int,
                  out_cap: int, flt_mask: tuple = (False, False, False),
                  eq_positions: tuple = (), new_pos: tuple = (),
                  impl: str = "kernel"):
    """The MAPSIN GET and merge of bindings `table` (B, nv) int32 probing
    [lo, hi) (invalid bindings [0, 0)): (table (out_cap, nv +
    len(new_pos)) int32, valid (out_cap,) bool, dropped () int32, over ()
    int32, missed (B,) int32), equal to ``merge_bindings`` over
    ``probe_gather``'s outputs (kernels/probe_gather.py)."""
    _check_impl(impl)
    if impl == "torch":
        return _pg.probe_compact_plain(keys, lo, hi, flt, table, cap, out_cap,
                                       flt_mask, eq_positions, new_pos)
    outs = _probe_compact_op(
        keys, lo[None].contiguous(), hi[None].contiguous(),
        flt[None].contiguous(), table[None].contiguous(), int(cap),
        int(out_cap), *_pg.encode_masks(flt_mask, eq_positions),
        list(new_pos))
    return tuple(o[0] for o in outs)


# --- multiway_compact -------------------------------------------------------
# A leading slot dimension as for probe_compact: S slots, each of B
# bindings (start, end, flt, extra) and R rows (origin, table, valid).


@torch.library.custom_op("repro_torch::multiway_compact", mutates_args=(),
                         device_types="cpu")
def _multiway_compact_op(keys: torch.Tensor, start: torch.Tensor,
                         end: torch.Tensor, flt: torch.Tensor,
                         extra: torch.Tensor, origin: torch.Tensor,
                         table: torch.Tensor, valid: torch.Tensor,
                         row_cap: int, out_cap: int, fmask: int, xmask: int,
                         eq_mask: int, new_pos: list[int]
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                    torch.Tensor, torch.Tensor]:
    flt_mask, eq_positions = _pg.decode_masks(fmask, eq_mask)
    extra_mask = _pg.decode_masks(xmask, 0)[0]
    slots = [_pg.multiway_compact_plain(
        keys, start[i], end[i], flt[i], extra[i], origin[i], table[i],
        valid[i], row_cap, out_cap, flt_mask, extra_mask, eq_positions,
        tuple(new_pos)) for i in range(start.shape[0])]
    return tuple(torch.stack(x) for x in zip(*slots))


@_multiway_compact_op.register_kernel("cuda")
def _multiway_compact_launch(keys, start, end, flt, extra, origin, table,
                             valid, row_cap, out_cap, fmask, xmask, eq_mask,
                             new_pos):
    flt_mask, eq_positions = _pg.decode_masks(fmask, eq_mask)
    out = _pg.multiway_compact_cuda(
        keys, start, end, flt, extra, origin, table, valid, row_cap, out_cap,
        flt_mask, _pg.decode_masks(xmask, 0)[0], eq_positions, tuple(new_pos))
    _count(launches, "multiway_compact", int(valid.numel() > 0))
    return out


@_multiway_compact_op.register_fake
def _(keys, start, end, flt, extra, origin, table, valid, row_cap, out_cap,
      fmask, xmask, eq_mask, new_pos):
    s = start.shape[0]
    return (table.new_empty((s, out_cap, table.shape[2] + len(new_pos))),
            valid.new_empty((s, out_cap)), table.new_empty((s,)),
            table.new_empty((s,)), origin.new_empty((s, out_cap)))


def _multiway_compact_vmap(info, in_dims, keys, start, end, flt, extra,
                           origin, table, valid, row_cap, out_cap, fmask,
                           xmask, eq_mask, new_pos):
    _shared_keys("multiway_compact", in_dims)
    n = info.batch_size
    s = _slot_shape(start, in_dims[1])[0]
    folded = [_fold(x, d, n) for x, d in zip(
        (start, end, flt, extra, origin, table, valid), in_dims[1:8])]
    _count(vmap_folds, "multiway_compact")
    outs = _multiway_compact_op(keys, *folded, row_cap, out_cap, fmask, xmask,
                                eq_mask, new_pos)
    return tuple(o.view(n, s, *o.shape[1:]) for o in outs), (0,) * 5


_multiway_compact_op.register_vmap(_multiway_compact_vmap)


def multiway_compact(keys: torch.Tensor, start: torch.Tensor,
                     end: torch.Tensor, flt: torch.Tensor, extra: torch.Tensor,
                     origin: torch.Tensor, table: torch.Tensor,
                     valid: torch.Tensor, row_cap: int, out_cap: int,
                     flt_mask: tuple = (False, False, False),
                     extra_mask: tuple = (False, False, False),
                     eq_positions: tuple = (), new_pos: tuple = (),
                     impl: str = "kernel"):
    """One star pattern of the multiway join: the rows (table (R, nv)
    int32, valid (R,)), each from the binding origin (R,) int32 whose
    fetched row is the rank range [start, end) (B,) int64, expanded
    against the range's first `row_cap` keys that pass the residual values
    flt (B, 3) at `flt_mask`, the prefix components extra (B, 3) at
    `extra_mask` and the repeats: (table (out_cap, nv + len(new_pos))
    int32, valid (out_cap,) bool, dropped () int32, over () int32, origin
    (out_cap,) int32), equal to ``multiway_match`` over the gathered row
    (kernels/probe_gather.py)."""
    _check_impl(impl)
    if impl == "torch":
        return _pg.multiway_compact_plain(
            keys, start, end, flt, extra, origin, table, valid, row_cap,
            out_cap, flt_mask, extra_mask, eq_positions, new_pos)
    fmask, eq_mask = _pg.encode_masks(flt_mask, eq_positions)
    outs = _multiway_compact_op(
        keys, *(x[None].contiguous() for x in (start, end, flt, extra, origin,
                                              table, valid)),
        int(row_cap), int(out_cap), fmask, _pg.encode_masks(extra_mask, ())[0],
        eq_mask, list(new_pos))
    return tuple(o[0] for o in outs)


# --- sort_merge_compact -----------------------------------------------------


@torch.library.custom_op("repro_torch::sort_merge_compact", mutates_args=(),
                         device_types="cpu")
def _sort_merge_compact_op(rks: torch.Tensor, rts: torch.Tensor,
                           rvs: torch.Tensor, lt: torch.Tensor,
                           lv: torch.Tensor, lkey_col: int,
                           eq_left: list[int], eq_right: list[int],
                           r_out_cols: list[int], probe_cap: int,
                           out_cap: int) -> tuple[torch.Tensor, torch.Tensor,
                                                  torch.Tensor, torch.Tensor]:
    return _pg.sort_merge_compact_plain(
        rks, rts, rvs, lt, lv, lkey_col, tuple(zip(eq_left, eq_right)),
        tuple(r_out_cols), probe_cap, out_cap)


@_sort_merge_compact_op.register_kernel("cuda")
def _sort_merge_compact_launch(rks, rts, rvs, lt, lv, lkey_col, eq_left,
                               eq_right, r_out_cols, probe_cap, out_cap):
    out = _pg.sort_merge_compact_cuda(
        rks, rts, rvs, lt, lv, lkey_col, tuple(zip(eq_left, eq_right)),
        tuple(r_out_cols), probe_cap, out_cap)
    _count(launches, "sort_merge_compact", int(lv.numel() > 0))
    return out


@_sort_merge_compact_op.register_fake
def _(rks, rts, rvs, lt, lv, lkey_col, eq_left, eq_right, r_out_cols,
      probe_cap, out_cap):
    return (lt.new_empty((out_cap, lt.shape[1] + len(r_out_cols))),
            lv.new_empty((out_cap,)), lt.new_empty(()), lt.new_empty(()))


def sort_merge_compact(rks: torch.Tensor, rts: torch.Tensor,
                       rvs: torch.Tensor, lt: torch.Tensor, lv: torch.Tensor,
                       lkey_col: int, extra_eq, r_out_cols, probe_cap: int,
                       out_cap: int, impl: str = "kernel"):
    """The reduce-side join's merge after its sort: left rows (lt (L, nvl)
    int32, lv (L,)) against right rows (rts (M, nvr) int32, rvs (M,)) in
    the order of their sorted int32 keys rks (M,), on the left column
    `lkey_col` and the (left, right) column pairs `extra_eq`: (table
    (out_cap, nvl + len(r_out_cols)) int32, valid (out_cap,) bool, dropped
    () int32, over () int32), equal to the (L, probe_cap) window grid and
    ``compact`` of ``sort_merge_compact_plain`` (kernels/probe_gather.py)."""
    _check_impl(impl)
    extra_eq, r_out_cols = tuple(extra_eq), tuple(r_out_cols)
    if impl == "torch":
        return _pg.sort_merge_compact_plain(rks, rts, rvs, lt, lv, lkey_col,
                                            extra_eq, r_out_cols, probe_cap,
                                            out_cap)
    return _sort_merge_compact_op(
        rks.contiguous(), rts.contiguous(), rvs.contiguous(), lt.contiguous(),
        lv.contiguous(), int(lkey_col), [int(a) for a, _ in extra_eq],
        [int(c) for _, c in extra_eq], [int(c) for c in r_out_cols],
        int(probe_cap), int(out_cap))


def _flash_attention_forward(q, k, v, causal, scale, impl):
    if not _use_kernel(impl, q):
        return _fa.flash_attention_plain(q, k, v, causal, scale)
    out = _fa.flash_attention_cuda(q, k, v, causal, scale)
    if q.numel() > 0:
        _count(launches, "flash_attention")
        _count(flash_attention_variants, _fa.variant(q))
    return out


class _FlashAttention(torch.autograd.Function):
    """The forward of ``flash_attention`` with the plain backward: a
    recompute under checkpointing runs the forward (and launches the
    kernel) again."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, impl):
        o = _flash_attention_forward(q, k, v, causal, scale, impl)
        ctx.save_for_backward(q, k, v, o)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = _fa.flash_attention_backward_plain(q, k, v, o, do,
                                                        ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: float | None = None,
                    impl: str = "kernel") -> torch.Tensor:
    """Forward attention, q (b, sq, h, e) against k, v (b, skv, g, e);
    returns (b, sq, h, e) in q's dtype. Causal needs sq <= skv: with the
    end-aligned mask a query row before the first key has nothing to
    attend to. Differentiable: where grad mode is on and an input requires
    grad, the output's backward is ``flash_attention_backward_plain``."""
    if causal and q.shape[1] > k.shape[1]:
        raise ValueError(f"causal attention needs sq <= skv, got sq="
                         f"{q.shape[1]} and skv={k.shape[1]}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, scale, impl)
    return _flash_attention_forward(q, k, v, causal, scale, impl)
