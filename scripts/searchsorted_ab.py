#!/usr/bin/env python3
"""Time builds of the searchsorted kernel side by side on one NVIDIA GPU.

    python3 scripts/searchsorted_ab.py [--variant NAME OLD NEW]...
                                       [--source NAME PATH]... [--seed S]

Builds ``src/repro_torch/csrc/searchsorted.cu`` as it stands ("src"), each
``--variant`` (that source with the text OLD, which must occur once,
replaced by NEW) and each ``--source`` (another .cu with the same C entry
point ``searchsorted_i64``), one nvcc process each, into the git-ignored
``build/ab/``. Then, at three inputs, it checks every build bit for bit
against ``torch.searchsorted`` and times each with chip_smoke.py's
``cuda_ms``, in order and then in reverse (A B ... B A), with
``torch.searchsorted`` among them:

- Q4-like: 5,174,800 sorted keys and 2^20 queries, 18 of them keys and
  the rest key 0 (the multiway step's first rank-find in LUBM Q4);
- fuzz and "1-4 distinct a warp": chip_smoke.py's searchsorted_inputs.

Prints ptxas's register line for each build and the card's name and power
limit. Exits non-zero if a build fails or disagrees.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke  # noqa: E402

Q4_KEYS = 5_174_800


def build(sources: dict) -> dict:
    """name -> ctypes entry point, compiled in parallel."""
    from repro_torch.kernels import _build
    out_dir = ROOT / "build" / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        digest = hashlib.sha256(text.encode()).hexdigest()[:16]
        src = out_dir / f"{name}-{digest}.cu"
        lib = out_dir / f"lib{name}-{digest}.so"
        src.write_text(text)
        procs[name] = lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed:\n{log}")
        for line in log.splitlines():
            if "Used" in line:
                print(f"[build] {name}: {line.split(':', 1)[-1].strip()}")
        fn = ctypes.CDLL(str(lib)).searchsorted_i64
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def caller(torch, fn, keys, q):
    """A function that ranks q in keys with this build's entry point, at
    the wrapper's parameters."""
    from repro_torch.kernels import searchsorted as ss
    params = ss.launch_params(keys.numel())
    out = torch.empty_like(q)

    def run():
        rc = fn(keys.data_ptr(), keys.numel(), q.data_ptr(), q.numel(),
                out.data_ptr(), *params,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return out
    return run


def q4_like(torch, rdf, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda hi, k: torch.randint(0, hi, (k,), generator=g, device="cuda")
    n = Q4_KEYS + 100_000
    keys = torch.unique(rdf.pack3(r(rdf.MAX_ID, n), r(64, n),
                                  r(rdf.MAX_ID, n)))[:Q4_KEYS].contiguous()
    q = torch.zeros(1 << 20, dtype=torch.int64, device="cuda")
    q[:18] = keys[r(Q4_KEYS, 18)]
    return keys, q


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--variant", nargs=3, action="append", default=[],
                   metavar=("NAME", "OLD", "NEW"))
    p.add_argument("--source", nargs=2, action="append", default=[],
                   metavar=("NAME", "PATH"))
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core import rdf

    base = (ROOT / "src/repro_torch/csrc/searchsorted.cu").read_text()
    sources = {"src": base}
    for name, old, new in args.variant:
        if base.count(old) != 1:
            raise SystemExit(f"{name}: {old!r} occurs {base.count(old)} "
                             f"times in the source, not once")
        sources[name] = base.replace(old, new)
    for name, path in args.source:
        sources[name] = Path(path).read_text()
    fns = build(sources)

    keys, queries, sets = chip_smoke.searchsorted_inputs(torch, rdf, args.seed)
    shapes = {"Q4-like": q4_like(torch, rdf, args.seed),
              "fuzz": (keys, queries),
              "1-4 distinct a warp": sets["1-4 distinct a warp"]}
    bad = 0
    for label, (kk, qq) in shapes.items():
        want = torch.searchsorted(kk, qq)
        runs = {name: caller(torch, fn, kk, qq) for name, fn in fns.items()}
        for name, run in runs.items():
            d = int((run() != want).sum())
            bad += d
            if d:
                print(f"MISMATCH {label} {name}: {d}")
        runs["torch.searchsorted"] = lambda: torch.searchsorted(kk, qq)
        order = list(runs) + list(reversed(runs))
        ms = {name: [] for name in runs}
        for name in order:
            ms[name].append(chip_smoke.cuda_ms(torch, runs[name]))
        print(f"== {label}: M={kk.numel()} Q={qq.numel()} "
              f"distinct={torch.unique(qq).numel()}")
        for name, t in ms.items():
            print(f"   {name:20s} ms={t[0]:.6f} {t[1]:.6f}")
    print(chip_smoke.nvidia_smi_line())
    print(f"mismatches={bad}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
