"""Rank-find over the sorted composite-key index: the plain PyTorch version
and the launch of the hand-written CUDA kernel (``csrc/searchsorted.cu``).

Both compute, for each int64 query, its left rank in the sorted int64 key
array (the number of keys strictly below it) and return int64 ranks: the
contract of the TPU kernel ``repro.kernels.ops.searchsorted`` on packed
keys. ``kernels/ops.py`` chooses between them.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build


def searchsorted_plain(keys: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """The plain version: ``torch.searchsorted`` (side left)."""
    return torch.searchsorted(keys, queries)


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype,
                 shape: tuple, device: torch.device | None = None) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of this dtype and shape
    (None in `shape` matches any extent), on `device` when one is given."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device.type != "cuda" or (device is not None and t.device != device):
        raise ValueError(f"{name}: expected a CUDA tensor on "
                         f"{device or 'any CUDA device'}, got one on {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(
            want is not None and got != want
            for got, want in zip(t.shape, shape)):
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


@functools.cache               # argument types are set once per process
def _fn():
    fn = _build.library("searchsorted").searchsorted_i64
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def searchsorted_cuda(keys: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream. keys: (M,) int64
    sorted; queries: (Q,) int64; both contiguous on one CUDA device.
    Returns (Q,) int64 ranks."""
    check_tensor(keys, "keys", torch.int64, (None,))
    check_tensor(queries, "queries", torch.int64, (None,), keys.device)
    out = torch.empty_like(queries)
    if queries.numel() == 0:
        return out
    fn = _fn()
    with torch.cuda.device(keys.device):
        rc = fn(keys.data_ptr(), keys.numel(), queries.data_ptr(),
                queries.numel(), out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"searchsorted kernel launch failed: CUDA error {rc}")
    return out
