"""Dispatching wrappers around the hand-written kernels, with their launch
counters.

``impl="kernel"`` (the default) launches the CUDA kernel for a CUDA tensor,
or raises; for a tensor on the CPU, where the kernel cannot run, it takes
the plain PyTorch version. ``impl="torch"`` takes the plain version on any
device. There is no fallback from a failed launch.

The two index kernels are ``torch.library`` custom ops,
``repro_torch::searchsorted`` and ``repro_torch::probe_gather``: the CPU
implementation is the plain version and the CUDA one the kernel's launch.
Each has a ``torch.func.vmap`` rule for the serving engine, which runs one
query's cascade under ``vmap`` for a whole batch of same-template queries:
the store's keys are shared by every slot, so the rule folds the batch
into the query dimension and launches once for the batch (``vmap_folds``
counts the folded calls). The plain route vmaps natively.

``launches`` counts kernel launches by name: each wrapper adds one where it
launches its kernel and nowhere else, so a run can show that it went
through the kernels. ``flash_attention_variants`` splits flash_attention's
launches, counted in the same place, by the kernel that ran
(``kernels/flash_attention.py variant``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import probe_gather as _pg
from repro_torch.kernels import searchsorted as _ss

IMPLS = ("kernel", "torch")

launches = {"searchsorted": 0, "probe_gather": 0, "flash_attention": 0}
# flash_attention's launches by kernel: "wgmma" (tensor cores) or "simt"
flash_attention_variants = {"wgmma": 0, "simt": 0}
# calls of a vmap rule that folded a batch into one call of the op
vmap_folds = {"searchsorted": 0, "probe_gather": 0}


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
    launches["searchsorted"] += int(queries.numel() > 0)
    return out


@_searchsorted_op.register_fake
def _(keys, queries):
    return torch.empty_like(queries)


def _searchsorted_vmap(info, in_dims, keys, queries):
    _shared_keys("searchsorted", in_dims)
    n = info.batch_size
    flat = _fold(queries, in_dims[1], n)
    vmap_folds["searchsorted"] += 1
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
    launches["probe_gather"] += int(lo.numel() > 0)
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
    vmap_folds["probe_gather"] += 1
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: float | None = None,
                    impl: str = "kernel") -> torch.Tensor:
    """Forward attention, q (b, sq, h, e) against k, v (b, skv, g, e);
    returns (b, sq, h, e) in q's dtype. Causal needs sq <= skv: with the
    end-aligned mask a query row before the first key has nothing to
    attend to."""
    if causal and q.shape[1] > k.shape[1]:
        raise ValueError(f"causal attention needs sq <= skv, got sq="
                         f"{q.shape[1]} and skv={k.shape[1]}")
    if not _use_kernel(impl, q):
        return _fa.flash_attention_plain(q, k, v, causal, scale)
    out = _fa.flash_attention_cuda(q, k, v, causal, scale)
    if q.numel() > 0:
        launches["flash_attention"] += 1
        flash_attention_variants[_fa.variant(q)] += 1
    return out
