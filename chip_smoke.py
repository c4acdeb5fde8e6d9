#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--universities N] [--seed S]

Phases, in order; any failure exits non-zero and prints no result line:
  1. device  — the card's name and power limit, torch and CUDA versions;
  2. build   — compile the hand-written CUDA kernels (nvcc, sm_90a);
  3. kernels — each kernel against its plain PyTorch version on the card,
               bit-identical on fuzzed inputs, with timings;
  4. main path at full size — LUBM-like data at N universities (default
               400: about 5.17 M triples), every LUBM query through
               parse_bgp -> compile_plan -> execute_local with
               impl="kernel" and impl="torch" (bit-identical, no
               overflow), the kernels' launch counters checked, and each
               kernel timed at the inputs the main path gives it;
  5. exactness — row sets against the oracle at small scale;
  6. summary  — the kernels line, the memory line, the card line, and the
               result line as the last line.
It needs a CUDA device and the repository's src/ beside it.
"""
from __future__ import annotations

import argparse
import inspect
import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet: 80 GB HBM3 at 3.35 TB/s
CAPS_MAIN = dict(scan_cap=1 << 20, out_cap=1 << 20, probe_cap=128, row_cap=64)
CAPS_SMALL = dict(scan_cap=1 << 12, out_cap=1 << 12, probe_cap=128, row_cap=64)
KERNELS = {
    "searchsorted": dict(route="cuda",
                         source="src/repro_torch/csrc/searchsorted.cu",
                         replaces="src/repro/kernels/searchsorted.py:70"),
    "probe_gather": dict(route="cuda",
                         source="src/repro_torch/csrc/probe_gather.cu",
                         replaces="src/repro/kernels/probe_gather.py:140"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def cuda_ms(torch, fn, iters: int = 10, warmup: int = 2) -> float:
    """Device time of one call: CUDA events around `iters` calls queued
    behind a spin kernel, so the host has enqueued them all before the
    card reaches the first and the calls run back to back (no host
    launch gaps in the span)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)       # ~25 ms of spinning at ~2 GHz
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def device_events(torch, fn, reps: int):
    """(host ms per call, [device-side profiler averages]) over `reps`
    calls traced by torch.profiler; the device side holds the kernels'
    and copies' own durations, without the gaps between them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    return wall, [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0]


def wall_ms(torch, fn, runs: int = 5) -> float:
    """Median host time of one call that ends in a device sync, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions on fuzzed inputs
# ---------------------------------------------------------------------------


def fuzz_searchsorted(torch, ops, rdf, seed: int) -> dict:
    """About 4 M sorted unique keys with INF_KEY padding; queries: exact
    hits, neighbours, 0, INF_KEY, fields at MAX_ID, random."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    n = 4_200_000
    r = lambda hi, k: torch.randint(0, hi, (k,), generator=g, device=dev)
    keys = torch.unique(rdf.pack3(r(rdf.MAX_ID, n), r(64, n), r(rdf.MAX_ID, n)))
    keys = torch.cat([keys, torch.full((4096,), rdf.INF_KEY, device=dev,
                                       dtype=torch.int64)])
    real = keys[:-4096]
    pick = real[r(real.numel(), 1 << 19)]
    edge = torch.tensor(
        [0, 1, rdf.INF_KEY, rdf.INF_KEY - 1,
         int(rdf.pack3(rdf.MAX_ID, 0, 0)),
         int(rdf.pack3(rdf.MAX_ID, rdf.MAX_ID, rdf.MAX_ID - 1)),
         int(rdf.pack3(0, rdf.MAX_ID, rdf.MAX_ID)),
         int(rdf.pack3(rdf.MAX_ID - 1, rdf.MAX_ID, rdf.MAX_ID))],
        dtype=torch.int64, device=dev)
    k = 1 << 18
    queries = torch.cat([pick, pick - 1, pick + 1, edge,
                         rdf.pack3(r(rdf.MAX_ID + 1, k), r(65, k),
                                   r(rdf.MAX_ID + 1, k))])
    got = ops.searchsorted(keys, queries, impl="kernel")
    want = ops.searchsorted(keys, queries, impl="torch")
    torch.cuda.synchronize()
    mism = int((got != want).sum())
    err = int((got - want).abs().max())
    ms = cuda_ms(torch, lambda: ops.searchsorted(keys, queries, "kernel"))
    plain = cuda_ms(torch, lambda: ops.searchsorted(keys, queries, "torch"))
    lib = cuda_ms(torch, lambda: torch.searchsorted(keys, queries))
    log(f"[kernels] searchsorted: M={keys.numel()} Q={queries.numel()} "
        f"mismatches={mism} ms={ms:.6f} plain_ms={plain:.6f} "
        f"library_ms={lib:.6f}")
    return {"mismatches": mism, "max_abs_err": err}


def fuzz_probe_gather(torch, ops, rdf, seed: int) -> dict:
    """All eight flt_mask combinations, with and without eq_positions, fat
    rows (range > cap), empty, degenerate (lo >= hi) and invalid-row
    ranges, caps from 8 to 256."""
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    dev = "cuda"
    m = 200_000
    r = lambda hi, n: torch.randint(0, hi, (n,), generator=g, device=dev)
    # few distinct fields so residuals and repeats match often; subjects 0
    # and 1 own fat rows (hundreds of keys, more than most caps)
    s = torch.cat([r(3000, m), torch.zeros(3000, dtype=torch.int64,
                                           device=dev),
                   torch.ones(700, dtype=torch.int64, device=dev)])
    o = torch.where(s <= 1, r(400, s.numel()), r(8, s.numel()))
    keys = torch.unique(rdf.pack3(s, r(6, s.numel()), o))
    keys = torch.cat([keys, torch.full((100,), rdf.INF_KEY, device=dev,
                                       dtype=torch.int64)])
    b = 5000
    v = r(3005, b)
    p = r(7, b)
    zero = torch.zeros_like(v)
    lo1 = rdf.pack3(v, zero, zero)
    lo2 = rdf.pack3(v, p, zero)
    kind = r(6, b)
    lo = torch.where(kind == 1, lo2, lo1)
    hi = torch.where(kind == 1, lo2 + (1 << rdf.BITS), lo1 + (1 << (2 * rdf.BITS)))
    lo = torch.where(kind == 2, 0, lo)                       # invalid row
    hi = torch.where(kind == 2, 0, hi)
    hi = torch.where(kind == 3, lo - 5, hi)                  # degenerate
    lo = torch.where(kind == 4, 0, lo)                       # whole index
    hi = torch.where(kind == 4, rdf.INF_KEY, hi)
    flt = torch.stack([r(3005, b), r(7, b), r(9, b)], 1).contiguous()
    lo, hi = lo.contiguous(), hi.contiguous()
    mism = cases = 0
    for cap in (8, 12, 33, 64, 128, 256):
        for fm in range(8):
            msk = tuple(bool(fm >> i & 1) for i in range(3))
            for eq in ((), ((0, 2),), ((1, 2),), ((0, 1), (0, 2))):
                got = ops.probe_gather(keys, lo, hi, flt, cap, msk, eq, "kernel")
                want = ops.probe_gather(keys, lo, hi, flt, cap, msk, eq, "torch")
                cases += 1
                mism += sum(int((x != y).sum()) for x, y in zip(got, want))
    torch.cuda.synchronize()
    log(f"[kernels] probe_gather: {cases} cases (caps 8..256, 8 flt masks, "
        f"4 eq sets), M={keys.numel()} B={b} mismatches={mism}")
    return {"mismatches": mism, "max_abs_err": 0 if mism == 0 else None}


# ---------------------------------------------------------------------------
# phase 4: the main path at full size
# ---------------------------------------------------------------------------


def first_call_args(ops, name: str, run) -> dict:
    """The arguments the main path gives the wrapper `ops.<name>` on its
    first call during `run()`, by name: the wrapper is swapped for one
    that records its arguments and calls through, then restored."""
    orig = getattr(ops, name)
    sig = inspect.signature(orig)
    seen = []

    def record(*a, **kw):
        if not seen:
            bound = sig.bind(*a, **kw)
            bound.apply_defaults()
            seen.append(dict(bound.arguments))
        return orig(*a, **kw)

    setattr(ops, name, record)
    try:
        run()
    finally:
        setattr(ops, name, orig)
    if not seen:
        raise RuntimeError(f"the main path never called ops.{name}")
    return seen[0]


def run_main_path(torch, args, failures: list) -> dict:
    from repro_torch.core import (Caps, ExecConfig, build_store, compile_plan,
                                  execute_local, rows_set)
    from repro_torch.data.rdf_gen import LUBM_SPARQL, lubm_like
    from repro_torch.kernels import ops
    from repro_torch.serve import parse_bgp

    t0 = time.perf_counter()
    triples, d, _ = lubm_like(args.universities, seed=args.seed)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    store = build_store(triples, num_shards=1, device="cuda")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    log(f"[main] LUBM-like x{args.universities}: {len(triples):,} triples, "
        f"{len(d):,} terms; generate {t_gen:.1f} s, build_store "
        f"{t_build:.1f} s; index {store.storage_bytes() / 1e6:.1f} MB on "
        f"the card")
    caps = Caps(**CAPS_MAIN)
    kern, plain = ExecConfig(impl="kernel"), ExecConfig(impl="torch")
    plans, rplans = {}, {}
    t0 = time.perf_counter()
    for name, text in LUBM_SPARQL.items():
        pats = list(parse_bgp(text, d).patterns)
        plans[name] = compile_plan(store, pats, caps)
        rplans[name] = compile_plan(store, pats, caps, mode="reduce")
    log(f"[main] planning (host numpy statistics) {time.perf_counter() - t0:.1f} s")

    # the main path: every count to 0 just before, read just after
    per_query = {}
    ops.reset_launches()
    for name, plan in plans.items():
        before = dict(ops.launches)
        bk = execute_local(store, plan, cfg=kern)
        torch.cuda.synchronize()
        launches = {k: ops.launches[k] - before[k] for k in before}
        per_query[name] = dict(
            plan=plan, bk=bk, launches=launches,
            ms=wall_ms(torch, lambda: execute_local(store, plan, cfg=kern)))
    main_launches = dict(ops.launches)
    log(f"[main] kernel launches over the main path: {main_launches}")
    for k, n in main_launches.items():
        if n <= 0:
            failures.append(f"main path never launched the {k} kernel")

    ops.reset_launches()
    for name, rec in per_query.items():
        plan = rec["plan"]
        rec["bt"] = execute_local(store, plan, cfg=plain)
        rec["ms_torch"] = wall_ms(
            torch, lambda: execute_local(store, plan, cfg=plain))
    torch.cuda.synchronize()
    if any(ops.launches.values()):
        failures.append(f"impl='torch' launched kernels: {ops.launches}")

    # the paper's comparison: every join step on the reduce-side operator
    for name, rec in per_query.items():
        rplan = rplans[name]
        run = lambda: execute_local(store, rplan, "reduce", cfg=kern)
        rec["ovf_reduce"] = int(run().overflow)
        rec["ms_reduce"] = wall_ms(torch, run)

    log(f"{'query':6s} {'steps':34s} {'rows':>7s} {'kernel_ms':>10s} "
        f"{'torch_ms':>10s} {'reduce_ms':>10s} {'ss':>3s} {'pg':>3s}  identical")
    for name, rec in per_query.items():
        bk, bt = rec["bk"], rec["bt"]
        same = (bk.vars == bt.vars and torch.equal(bk.table, bt.table)
                and torch.equal(bk.valid, bt.valid)
                and torch.equal(bk.overflow, bt.overflow)
                and torch.equal(bk.step_overflow, bt.step_overflow))
        rows = len(rows_set(bk.table, bk.valid, len(bk.vars)))
        ovf = int(bk.overflow)
        if not same:
            failures.append(f"{name}: impl='kernel' and impl='torch' differ")
        if ovf != 0:
            failures.append(f"{name}: overflow {ovf} at the main caps")
        kinds = "+".join(st.kind for st in rec["plan"].steps)
        note = (f"  (reduce overflow {rec['ovf_reduce']})"
                if rec["ovf_reduce"] else "")
        log(f"{name:6s} {kinds:34s} {rows:7d} {rec['ms']:10.3f} "
            f"{rec['ms_torch']:10.3f} {rec['ms_reduce']:10.3f} "
            f"{rec['launches']['searchsorted']:3d} "
            f"{rec['launches']['probe_gather']:3d}  {same}{note}")
    for name in ("Q1", "Q4", "Q8"):
        if name in plans:
            profile_query(torch, lambda p=plans[name]: execute_local(
                store, p, cfg=kern), name)
    return dict(store=store, plans=plans, launches=main_launches,
                per_query=per_query)


def profile_query(torch, run, name: str, reps: int = 3) -> None:
    """Where one query's time goes: device time by kernel (torch.profiler)
    against the host clock. Informational: a profiler that cannot trace
    the card here is reported, not failed."""
    try:
        wall, events = device_events(torch, run, reps)
    except Exception as e:                   # noqa: BLE001 — reported below
        log(f"[profile] {name}: unavailable ({type(e).__name__}: {e})")
        return
    dev = sum(e.self_device_time_total for e in events) / 1e3 / reps
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    log(f"[profile] {name}: host {wall:.3f} ms/run (profiler on), device "
        f"busy {dev:.3f} ms/run ({100 * dev / wall:.1f}%, idle "
        f"{100 * (1 - dev / wall):.1f}%); top device time: " + "; ".join(
            f"{e.key[:60]} {e.self_device_time_total / 1e3 / reps:.3f} ms"
            f" x{e.count // reps}" for e in top))


def time_kernels(torch, main: dict, fuzz: dict) -> list:
    """Each kernel at the inputs the main path gives it, recorded from one
    execute_local run: the first rank-find of the first query with a
    multiway step, and the first GET of the first query with a mapsin
    step."""
    from repro_torch.core import ExecConfig, execute_local
    from repro_torch.kernels import ops
    store, plans = main["store"], main["plans"]
    fz = {k: fuzz.get(k, {"mismatches": 0, "max_abs_err": 0}) for k in KERNELS}
    kern = ExecConfig(impl="kernel")
    out = []

    def args_of(kernel: str, kind: str):
        name = next(n for n, p in plans.items()
                    if any(st.kind == kind for st in p.steps))
        run = lambda: execute_local(store, plans[name], cfg=kern)
        return name, first_call_args(ops, kernel, run)

    name, x = args_of("searchsorted", "multiway")
    keys, q = x["keys"], x["queries"]
    got = ops.searchsorted(keys, q, "kernel")
    want = ops.searchsorted(keys, q, "torch")
    err = int((got - want).abs().max())
    t_k = cuda_ms(torch, lambda: ops.searchsorted(keys, q, "kernel"))
    t_p = cuda_ms(torch, lambda: ops.searchsorted(keys, q, "torch"))
    t_l = cuda_ms(torch, lambda: torch.searchsorted(keys, q))
    # what this run's data needs: each query read and each rank written
    # once, and the keys on the search paths of the distinct queries
    depth = max(keys.numel(), 1).bit_length()
    nbytes = q.numel() * 16 + torch.unique(q).numel() * depth * 8
    out.append(dict(name="searchsorted", **KERNELS["searchsorted"],
                    launches=main["launches"]["searchsorted"],
                    max_abs_err=max(err, fz["searchsorted"]["max_abs_err"]),
                    mismatches=fz["searchsorted"]["mismatches"]
                    + int((got != want).sum()),
                    ms=t_k, plain_ms=t_p,
                    bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                    library_ms=t_l,
                    shape=f"{name}, first multiway rank-find: "
                          f"M={keys.numel()} Q={q.numel()} "
                          f"distinct={torch.unique(q).numel()}"))

    name, x = args_of("probe_gather", "mapsin")
    keys, lo, hi, flt, cap = x["keys"], x["lo"], x["hi"], x["flt"], x["cap"]
    msk = x["flt_mask"]
    args = (keys, lo, hi, flt, cap, msk, x["eq_positions"])
    got = ops.probe_gather(*args, "kernel")
    want = ops.probe_gather(*args, "torch")
    err = int((got[0] - want[0]).abs().max())
    mism = sum(int((a != b).sum()) for a, b in zip(got, want))
    t_k = cuda_ms(torch, lambda: ops.probe_gather(*args, "kernel"))
    t_p = cuda_ms(torch, lambda: ops.probe_gather(*args, "torch"), iters=3)
    b = lo.numel()
    start = torch.searchsorted(keys, lo)
    end = torch.searchsorted(keys, hi)
    in_range = int((end - start).clamp(min=0, max=cap).sum())
    live = int((lo < hi).sum())
    nonempty = int((end > start).sum())
    depth = max(keys.numel(), 1).bit_length()
    # what this run's data needs: each probe's lo and hi read once, both
    # searches of each live probe (lo < hi), the filter values at the
    # flt_mask positions of each probe whose range holds a key, the
    # in-range keys the slots take, and the outputs (keys, flags, missed)
    # written once
    nbytes = (b * 16 + live * 2 * depth * 8 + nonempty * sum(msk) * 8
              + in_range * 8 + b * cap * 9 + b * 4)
    out.append(dict(name="probe_gather", **KERNELS["probe_gather"],
                    launches=main["launches"]["probe_gather"],
                    max_abs_err=err, mismatches=fz["probe_gather"]["mismatches"]
                    + mism, ms=t_k, plain_ms=t_p,
                    bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                    library_ms=None,
                    shape=f"{name}, first mapsin GET: M={keys.numel()} B={b} "
                          f"cap={cap} flt_mask={msk} live_probes={live} "
                          f"nonempty_probes={nonempty} "
                          f"in_range_keys={in_range}"))
    for k in out:
        log(f"[timing] {k['name']}: {k['shape']}: ms={k['ms']:.6f} "
            f"plain_ms={k['plain_ms']:.6f} bound_ms={k['bound_ms']:.6f} "
            f"library_ms={k['library_ms']}")
    return out


# ---------------------------------------------------------------------------
# phase 5: exactness against the oracle
# ---------------------------------------------------------------------------


def check_oracle(torch, failures: list) -> None:
    from repro_torch.core import (Caps, ExecConfig, build_store, compile_plan,
                                  execute_local, execute_oracle, rows_set)
    from repro_torch.data.rdf_gen import (LUBM_SPARQL, SP2B_SPARQL, lubm_like,
                                          sp2b_like)
    from repro_torch.serve import parse_bgp
    caps = Caps(**CAPS_SMALL)
    for label, (triples, d, _), texts in (
            ("lubm_like(1)", lubm_like(1), LUBM_SPARQL),
            ("sp2b_like(200)", sp2b_like(200), SP2B_SPARQL)):
        store = build_store(triples, device="cuda")
        ok = 0
        for name, text in texts.items():
            plan = compile_plan(store, list(parse_bgp(text, d).patterns), caps)
            bnd = execute_local(store, plan, cfg=ExecConfig(impl="kernel"))
            got = rows_set(bnd.table, bnd.valid, len(bnd.vars))
            # the plan's order keeps the nested-loop oracle tractable
            want, _ = execute_oracle(triples, plan.patterns, bnd.vars)
            if got != want or int(bnd.overflow) != 0:
                failures.append(f"oracle: {label} {name}: {len(got)} rows, "
                                f"oracle {len(want)}, overflow "
                                f"{int(bnd.overflow)}")
            else:
                ok += 1
        log(f"[oracle] {label}: {ok}/{len(texts)} queries equal the oracle")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--universities", type=int, default=400)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not (SRC / "repro_torch" / "__init__.py").exists():
        print(f"chip_smoke: the port is missing ({SRC / 'repro_torch'})",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.core import rdf
    from repro_torch.kernels import _build, ops

    failures: list[str] = []
    card = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    _build.build_all()
    log(f"[build] nvcc, both kernels in parallel: {_build.build_seconds:.1f} s")
    for name, text in _build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    # each phase reports its own failure and the next one still runs
    fuzz = {}
    try:
        fuzz["searchsorted"] = fuzz_searchsorted(torch, ops, rdf, args.seed)
        fuzz["probe_gather"] = fuzz_probe_gather(torch, ops, rdf, args.seed)
        for k, rec in fuzz.items():
            if rec["mismatches"]:
                failures.append(f"{k}: {rec['mismatches']} mismatches "
                                f"against the plain version")
    except Exception:
        failures.append(f"phase kernels:\n{traceback.format_exc()}")

    kernels = []
    torch.cuda.reset_peak_memory_stats()
    try:
        main_run = run_main_path(torch, args, failures)
        kernels = time_kernels(torch, main_run, fuzz)
        for k in kernels:
            if k["mismatches"]:
                failures.append(f"{k['name']}: mismatches at the main "
                                f"path's inputs")
        del main_run
    except Exception:
        failures.append(f"phase main path:\n{traceback.format_exc()}")
    peak = torch.cuda.max_memory_allocated()

    try:
        check_oracle(torch, failures)
    except Exception:
        failures.append(f"phase exactness:\n{traceback.format_exc()}")

    print(json.dumps({"kernels": kernels}), flush=True)
    log(f"memory: max_memory_allocated {peak} bytes "
        f"({peak / 2 ** 30:.2f} GiB) over the main path")
    if failures:
        for f in failures:
            print(f"FAILED: {f}", file=sys.stderr)
        return 1
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
