"""Dispatching wrappers around the hand-written kernels, with their launch
counters.

``impl="kernel"`` (the default) launches the CUDA kernel for a CUDA tensor,
or raises; for a tensor on the CPU, where the kernel cannot run, it takes
the plain PyTorch version. ``impl="torch"`` takes the plain version on any
device. There is no fallback from a failed launch.

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


def reset_launches() -> None:
    for counts in (launches, flash_attention_variants):
        for name in counts:
            counts[name] = 0


def _use_kernel(impl: str, t: torch.Tensor) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return impl == "kernel" and t.device.type != "cpu"


def searchsorted(keys: torch.Tensor, queries: torch.Tensor,
                 impl: str = "kernel") -> torch.Tensor:
    """Left ranks (int64) of packed int64 queries in sorted packed keys."""
    if not _use_kernel(impl, keys):
        return _ss.searchsorted_plain(keys, queries)
    out = _ss.searchsorted_cuda(keys, queries)
    launches["searchsorted"] += int(queries.numel() > 0)
    return out


def probe_gather(keys: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                 flt: torch.Tensor, cap: int,
                 flt_mask: tuple = (False, False, False),
                 eq_positions: tuple = (), impl: str = "kernel"):
    """Fused MAPSIN probe on packed int64 keys. Returns (k (B, cap) int64
    match keys, 0 where invalid; valid (B, cap) bool; missed (B,) int32)."""
    if not _use_kernel(impl, keys):
        return _pg.probe_gather_plain(keys, lo, hi, flt, cap, flt_mask,
                                      eq_positions)
    out = _pg.probe_gather_cuda(keys, lo, hi, flt, cap, flt_mask, eq_positions)
    launches["probe_gather"] += int(lo.numel() > 0)
    return out


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
