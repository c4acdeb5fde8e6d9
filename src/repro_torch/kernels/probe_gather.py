"""The fused MAPSIN GET: the plain PyTorch version and the launch of the
hand-written CUDA kernel (``csrc/probe_gather.cu``).

For B probe ranges [lo, hi) over the sorted int64 index, both return
  k      (B, cap) int64 — the first `cap` keys of each range, 0 where invalid;
  valid  (B, cap) bool  — in range, equal to the residual values at the
                          `flt_mask` positions, and equal across every
                          `eq_positions` repeat;
  missed (B,) int32     — max(rank(hi) - rank(lo) - cap, 0), residual-free;
the contract of the TPU kernel ``repro.kernels.ops.probe_gather``.
``kernels/ops.py`` chooses between them.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.searchsorted import check_tensor

# intra-pattern repeat (a, b), a < b -> its bit in the kernel's eq_mask
_EQ_BIT = {(0, 1): 1, (0, 2): 2, (1, 2): 4}


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
    if len(flt_mask) != 3:
        raise ValueError(f"probe_gather: flt_mask needs 3 flags, got {flt_mask}")
    eq_mask = 0
    for a, c in eq_positions:
        pair = (min(a, c), max(a, c))
        if pair not in _EQ_BIT:
            raise ValueError(f"probe_gather: bad eq position pair {(a, c)}")
        eq_mask |= _EQ_BIT[pair]
    fmask = sum(1 << p for p in range(3) if flt_mask[p])
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
