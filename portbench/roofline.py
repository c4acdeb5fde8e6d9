"""The yardstick of the kernels' rooflines: the card's published peaks and
the bytes each index kernel's call needs, counted from the call's own
arguments whatever implements it (frozen copies of the counts that
`chip_smoke.py` used, so a later change of the program cannot move them).

Each input byte is counted once and each output byte once, with what the
data makes each call touch: a rank-find's search paths, a probe's range
of keys."""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit
PEAKS = {"NVIDIA H100": {"hbm_bytes_per_s": 3.35e12}}


def hbm_bytes_per_s(device_name: str) -> float:
    for key, peaks in PEAKS.items():
        if device_name.startswith(key):
            return peaks["hbm_bytes_per_s"]
    raise KeyError(f"no peak for {device_name!r}")


def searchsorted_bytes(torch, keys, queries) -> int:
    """Each query read and each rank written once, and the keys on the
    search paths of the distinct queries, but no more than the whole key
    array (the paths share their keys)."""
    m = keys.numel()
    depth = max(m, 1).bit_length()
    distinct = torch.unique(queries).numel()
    return queries.numel() * 16 + min(distinct * depth, m) * 8


def probe_gather_bytes(torch, keys, lo, hi, flt, cap: int, fmask: int) -> int:
    """Each probe's lo and hi read once, both searches of each live probe
    (lo < hi), the filter values at the filtered positions of each probe
    whose range holds a key, the in-range keys the slots take, and the
    outputs (keys, flags, missed counts) written once."""
    b = lo.numel()
    if b == 0:
        return 0
    start = torch.searchsorted(keys, lo)
    end = torch.searchsorted(keys, hi)
    in_range = int((end - start).clamp(min=0, max=cap).sum())
    live = int((lo < hi).sum())
    nonempty = int((end > start).sum())
    depth = max(keys.numel(), 1).bit_length()
    n_flt = bin(int(fmask) & 7).count("1")
    return (b * 16 + live * 2 * depth * 8 + nonempty * n_flt * 8
            + in_range * 8 + b * cap * 9 + b * 4)


def call_bytes(torch, op: str, args) -> int:
    """The bytes of one recorded call of an index kernel's op."""
    if op == "searchsorted":
        return searchsorted_bytes(torch, args[0], args[1])
    keys, lo, hi, flt, cap, fmask, _ = args
    return probe_gather_bytes(torch, keys, lo, hi, flt, cap, fmask)
