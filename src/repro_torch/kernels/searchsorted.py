"""Rank-find over the sorted composite-key index: the plain PyTorch version
and the launch of the hand-written CUDA kernel (``csrc/searchsorted.cu``).

Both compute, for each int64 query, its left rank in the sorted int64 key
array (the number of keys strictly below it) and return int64 ranks: the
contract of the TPU kernel ``repro.kernels.ops.searchsorted`` on packed
keys. ``kernels/ops.py`` chooses between them.

The kernel's parameters are set here and passed to it at each launch
(``launch_params``), so the CPU model of its index arithmetic
(``tests/test_torch_searchsorted.py``) reads the same values:

- ``LANES``: lanes of a warp. A warp whose queries are all equal ranks
  that value with all its lanes, a (``LANES`` + 1)-ary search; otherwise
  each lane ranks its own query. ``path`` forces one search on every warp
  (``APART``, or ``TOGETHER``: each distinct value of a warp in turn), so
  that tests reach both on any input; the wrapper passes ``AUTO``.
- ``TABLE_MAX``: most entries of the shared-memory table of every S-th key
  that a lane's own search starts from; S is the least power of two that
  keeps the table within it (``segment_log2``). A larger table saves
  steps for distinct queries but costs every block that needs it one
  strided load an entry.

The kernel's key positions are 32-bit (faster than 64-bit on the card),
so ``launch`` refuses a key array of ``2**32 - S - LANES`` keys or more;
the TPU kernel's ranks are int32, a tighter limit still.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

LANES = 32
TABLE_MAX = 4096
AUTO, APART, TOGETHER = 0, 1, 2         # the kernel's `path`


def segment_log2(m: int, table_max: int = TABLE_MAX) -> int:
    """log2 of the segment S: the least power of two with ceil(m / S) <=
    table_max."""
    s = 0
    while (m + (1 << s) - 1) >> s > table_max:
        s += 1
    return s


def launch_params(m: int, table_max: int = TABLE_MAX,
                  path: int = AUTO) -> tuple[int, int]:
    """(seg_log2, path): the kernel's arguments beside its tensors, for
    `m` keys."""
    return segment_log2(m, table_max), path


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
                   ctypes.c_int64, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def searchsorted_cuda(keys: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream. keys: (M,) int64
    sorted; queries: (Q,) int64; both contiguous on one CUDA device.
    Returns (Q,) int64 ranks."""
    return launch(keys, queries, *launch_params(keys.numel()))


def launch(keys: torch.Tensor, queries: torch.Tensor, seg_log2: int,
           path: int) -> torch.Tensor:
    """`searchsorted_cuda` with the kernel's parameters given (tests pass
    a small segment, so that a small key array crosses many, and force
    each path)."""
    check_tensor(keys, "keys", torch.int64, (None,))
    check_tensor(queries, "queries", torch.int64, (None,), keys.device)
    if keys.numel() + (1 << seg_log2) + LANES >= 1 << 32:
        raise ValueError(f"keys: {keys.numel()} keys at segments of "
                         f"2^{seg_log2} pass the kernel's 32-bit positions")
    out = torch.empty_like(queries)
    if queries.numel() == 0:
        return out
    fn = _fn()
    with torch.cuda.device(keys.device):
        rc = fn(keys.data_ptr(), keys.numel(), queries.data_ptr(),
                queries.numel(), out.data_ptr(), seg_log2, path,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"searchsorted kernel launch failed: CUDA error {rc}")
    return out
