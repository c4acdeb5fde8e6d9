#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--universities N] [--seed S]

Phases, in order; any failure exits non-zero and prints no result line:
  1. device  — the card's name and power limit, torch and CUDA versions;
  2. build   — compile the hand-written CUDA kernels (nvcc, sm_90a, one
               process per source) with ptxas's registers and spills per
               kernel, the wgmma attention kernel's shared memory and the
               HGMMA instructions in its SASS (where cuobjdump exists);
  3. kernels — each kernel against its plain PyTorch version on the card:
               the index kernels bit-identical on fuzzed inputs, with
               timings (searchsorted also on duplicate-heavy query sets,
               runs of equal keys across its table's segments, INF_KEY
               and below-every-key queries and small key arrays, at the
               wrapper's parameters and at a small table with each path
               forced; timed at the mostly distinct queries and at 1-4
               distinct a warp beside a streaming floor: a stub kernel
               that reads each query and writes 0); flash_attention
               within 2e-5 (float32) / 2e-2 (bfloat16), and within
               2^-12 / 2^-5 of each row's largest output, over head
               dims, GQA groupings, masks and ragged lengths, its
               cases counted by the kernel that ran (wgmma for bf16 at
               e 64 and 128, simt otherwise);
  4. main path at full size — LUBM-like data at N universities (default
               400: about 5.17 M triples), every LUBM query through
               parse_bgp -> compile_plan -> execute_local with
               impl="kernel" and impl="torch" (bit-identical, no
               overflow), the kernels' launch counters checked, and each
               kernel timed at the inputs the main path gives it;
  5. engine serving — two tenants' batched ServeEngines (serve/engine.py)
               on the card: the main path's LUBM-like store and an
               SP2B-like one (sp2b_like(24000)), the serving bench's
               stream (192 requests from the seed, its caps, max_batch
               16, escalation off) with impl="kernel": every request
               equal to execute_local (rows and overflow) and to
               impl="torch" engines, each dispatch launching the index
               kernels as often as one query of its template at every
               batch size (the vmap fold), then the saturated replay's
               queries/s beside the sequential execute_local loop,
               average batch, latency and dispatch p50/p99, peak memory,
               the device's busy share over a replay, an escalating run
               against the oracle, and a traced replay whose Chrome
               trace (build/TRACE_serving.json) validates;
  6. exactness — row sets against the oracle at small scale;
  7. LM serving at full width — yi-6b (32 layers, d 4096, bf16) with
               weights from the seed: a batch of 4 prompts of 4000 tokens
               prefilled and 32 tokens decoded greedily through
               launch/serve.py's loop with attention_impl="kernel" (32
               flash_attention launches per prefill, all on the wgmma
               kernel, none in decode), then teacher-forced against
               attention_impl="torch"; prefill ms, tokens/s, decode
               ms/token, peak memory, and the kernel timed on the first
               layer's own (q, k, v) beside SDPA, with its TFLOP/s, its
               share of the bound and both errors (absolute and per
               row) against the plain version;
  8. summary  — the kernels line, the memory line, the card line, and the
               result line as the last line.
It needs a CUDA device and the repository's src/ beside it.
"""
from __future__ import annotations

import argparse
import inspect
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet: 80 GB HBM3 at 3.35 TB/s
BF16_FLOPS = 989.4e12          # H100 SXM data sheet: dense bf16 tensor cores
F32_FLOPS = 66.9e12            # H100 SXM data sheet: float32 outside tensor cores
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_kernels_attention.py
# beside it, an error that scales with the output: max |kernel - plain| in
# a row over max |plain| in that row, four bf16 ulps of the row's largest
# element (a kv tile lost or taken twice moves a long row far more)
ATTN_ROW_TOL = {"float32": 2 ** -12, "bfloat16": 2 ** -5}
LM_BATCH, LM_PROMPT, LM_DECODE = 4, 4000, 32
LOGIT_TOL = 5e-2               # max |kernel - torch| <= LOGIT_TOL * max |logits|
CAPS_MAIN = dict(scan_cap=1 << 20, out_cap=1 << 20, probe_cap=128, row_cap=64)
CAPS_SMALL = dict(scan_cap=1 << 12, out_cap=1 << 12, probe_cap=128, row_cap=64)
KERNELS = {
    "searchsorted": dict(route="cuda",
                         source="src/repro_torch/csrc/searchsorted.cu",
                         replaces="src/repro/kernels/searchsorted.py:70"),
    "probe_gather": dict(route="cuda",
                         source="src/repro_torch/csrc/probe_gather.cu",
                         replaces="src/repro/kernels/probe_gather.py:140"),
    "flash_attention": dict(route="cuda",
                            source="src/repro_torch/csrc/flash_attention.cu",
                            replaces="src/repro/kernels/flash_attention.py:73"),
}


# The streaming floor of a rank-find, for timing beside the searchsorted
# kernel: read each query once, write a rank of 0. Built from this string
# into the kernels' build directory; it is measurement, not part of the port.
FLOOR_CU = r"""
#include <cstdint>
#include <cuda_runtime.h>
__global__ void floor_kernel(const int64_t* __restrict__ q, int64_t nq,
                             int64_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  int64_t x;
  asm volatile("ld.global.nc.b64 %0, [%1];" : "=l"(x) : "l"(q + i));
  (void)x;
  out[i] = 0;
}
extern "C" int floor_i64(const void* q, int64_t nq, void* out, void* stream) {
  if (nq <= 0) return 0;
  const int threads = 256;
  floor_kernel<<<static_cast<unsigned int>((nq + threads - 1) / threads),
                 threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(q), nq, static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
"""


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


def wgmma_smem_bytes(e: int) -> int:
    """Dynamic shared memory of one block of csrc/flash_attention.cu's
    wgmma kernel (its `tc::smem_bytes`): Q (128 x e bf16), two stages of K
    and V (128 x e bf16 each), three 8-byte mbarriers, and 1024 bytes of
    slack to align the base for the 128-byte swizzle."""
    return 1024 + 128 * e * 2 * 5 + 3 * 8


def row_rel_err(got, want) -> float:
    """max over rows of max |got - want| / max |want| in that row."""
    d = (got.float() - want.float()).abs().amax(-1)
    return float((d / want.float().abs().amax(-1).clamp(min=1e-30)).max())


def start_floor_build(_build):
    """Start nvcc on FLOOR_CU (beside the kernels' own builds); returns
    a function that waits for it and gives floor(queries, out)."""
    import ctypes
    import hashlib
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    digest = hashlib.sha256((FLOOR_CU + " ".join(_build.NVCC_FLAGS))
                            .encode()).hexdigest()[:16]
    src = _build.BUILD_DIR / f"searchsorted_floor-{digest}.cu"
    lib = _build.BUILD_DIR / f"libsearchsorted_floor-{digest}.so"
    proc = None
    if not lib.exists():
        src.write_text(FLOOR_CU)
        proc = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                                 str(lib), str(src)], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    def finish():
        if proc is not None:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"floor stub build failed:\n{out}")
        fn = ctypes.CDLL(str(lib)).floor_i64
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def floor(torch, q, out):
            rc = fn(q.data_ptr(), q.numel(), out.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"floor stub launch failed: CUDA error {rc}")
        return floor
    return finish


def report_build(_build) -> None:
    """ptxas's registers, spills and static shared memory for each kernel
    entry, its warnings, the wgmma kernel's dynamic shared memory, and the
    count of HGMMA (wgmma) instructions in the attention library's SASS."""
    import re
    for name, text in _build.build_log.items():
        entry = spill = ""
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:                    # a short label from the mangled name
                kern = re.search(r"[a-z_]+kernel", m.group(1))
                kind = ("bf16" if "nv_bfloat16" in m.group(1) else
                        "f32" if re.search(r"kernelIf", m.group(1)) else "")
                dim = re.search(r"Li(\d+)E", m.group(1))
                entry = ((kern.group(0) if kern else m.group(1))
                         + (f"<{kind}, e={dim.group(1)}>" if dim else ""))
            elif "warning" in line.lower() or "Performance Loss" in line:
                log(f"[build] {name}: {line.strip()}")
            elif "spill" in line:
                spill = line.strip()
            elif entry and "Used" in line:
                log(f"[build] {name}: {entry}: "
                    f"{line.split(':', 1)[-1].strip()}; {spill}")
    log(f"[build] flash_attention wgmma kernel: dynamic shared memory "
        f"{wgmma_smem_bytes(128)} bytes a block at e 128, "
        f"{wgmma_smem_bytes(64)} at e 64")
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(cuobjdump).exists():
        log("[build] cuobjdump not found: SASS not inspected")
        return
    lib = _build._lib_path("flash_attention")
    out = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=120)
    log(f"[build] flash_attention SASS ({cuobjdump}): "
        f"{out.stdout.count('HGMMA')} HGMMA instructions")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions on fuzzed inputs
# ---------------------------------------------------------------------------


def searchsorted_bound_ms(torch, keys, q) -> float:
    """What this input needs: each query read and each rank written once,
    and the keys on the binary-search paths of its distinct queries, but
    no more than the whole key array (the paths share their keys)."""
    m = keys.numel()
    depth = max(m, 1).bit_length()
    nbytes = q.numel() * 16 + min(torch.unique(q).numel() * depth, m) * 8
    return nbytes / HBM_BYTES_PER_S * 1e3


def time_searchsorted(torch, ops, floor, keys, q, label: str) -> dict:
    """The kernel, its plain version, torch.searchsorted and the streaming
    floor on one input, one after the other, with the bound and the
    kernel's table (entries, segment, shared memory)."""
    from repro_torch.kernels import searchsorted as ss
    out = torch.empty_like(q)
    t_f = cuda_ms(torch, lambda: floor(torch, q, out))
    t_k = cuda_ms(torch, lambda: ops.searchsorted(keys, q, "kernel"))
    t_l = cuda_ms(torch, lambda: torch.searchsorted(keys, q))
    t_p = cuda_ms(torch, lambda: ops.searchsorted(keys, q, "torch"))
    bound = searchsorted_bound_ms(torch, keys, q)
    m = keys.numel()
    seg = ss.segment_log2(m)
    entries = -(-m // (1 << seg))
    rec = dict(ms=t_k, plain_ms=t_p, library_ms=t_l, floor_ms=t_f,
               bound_ms=bound, distinct=torch.unique(q).numel())
    log(f"[timing] searchsorted {label}: M={m} Q={q.numel()} "
        f"distinct={rec['distinct']}: ms={t_k:.6f} library_ms={t_l:.6f} "
        f"plain_ms={t_p:.6f} floor_ms={t_f:.6f} bound_ms={bound:.6f} "
        f"({100 * bound / t_k:.1f}% of the bound; floor "
        f"{100 * bound / t_f:.1f}%); kernel faster than "
        f"torch.searchsorted: {t_k < t_l}; table {entries} entries of "
        f"S={1 << seg} keys, {entries * 8} bytes of shared memory")
    return rec


def searchsorted_inputs(torch, rdf, seed: int):
    """(keys, queries, sets). keys: about 4 M sorted unique keys with
    INF_KEY padding; queries: exact hits, neighbours, 0, INF_KEY, fields at
    MAX_ID, random (mostly distinct: the per-lane path). sets: name ->
    (keys, queries), duplicate-heavy (2^20 equal queries, 1-4 distinct a
    warp, the multiway step's few valid rows before zeros), runs of equal
    keys longer than the table's segment, INF_KEY queries, queries below
    every key, and key arrays of 1, 31, 32, 33 and 100,001 keys."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    n = 4_200_000
    r = lambda hi, k: torch.randint(0, hi, (k,), generator=g, device=dev)
    inf = lambda k: torch.full((k,), rdf.INF_KEY, device=dev, dtype=torch.int64)
    keys = torch.unique(rdf.pack3(r(rdf.MAX_ID, n), r(64, n), r(rdf.MAX_ID, n)))
    keys = torch.cat([keys, inf(4096)])
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

    sets = {}
    q20 = 1 << 20
    sets["2^20 equal"] = (keys, real[123456].repeat(q20))
    sets["2^20 zeros"] = (keys, torch.zeros(q20, dtype=torch.int64, device=dev))
    warps = q20 // 32
    pool = torch.cat([pick[:64], pick[:64] + 1])
    per = r(4, warps)[:, None]                   # 1-4 distinct a warp
    sel = torch.minimum(r(4, q20).view(warps, 32), per)
    sets["1-4 distinct a warp"] = (
        keys, pool[r(pool.numel(), warps * 4).view(warps, 4).gather(1, sel)]
        .reshape(-1).contiguous())
    few = torch.zeros(q20, dtype=torch.int64, device=dev)
    few[:18] = pick[:18]
    sets["18 valid rows, then zeros"] = (keys, few)
    vals = torch.sort(r(1 << 40, 3000))[0] + 1
    runs = torch.cat([torch.repeat_interleave(vals, r(5000, 3000) + 1),
                      inf(4096)])
    sets["runs longer than S"] = (runs, torch.cat(
        [vals, vals - 1, vals + 1, vals[r(3000, 200_000)],
         torch.tensor([0, rdf.INF_KEY], device=dev)]))
    sets["INF_KEY queries"] = (keys, torch.where(r(2, 100_003) == 0,
                                                 rdf.INF_KEY, pick[:100_003]))
    sets["below every key"] = (keys[1000:],
                               pick[:50_000].clamp(max=int(keys[999])))
    for m in (1, 31, 32, 33, 100_001):
        small = torch.sort(r(1000, m))[0]
        sets[f"M={m}"] = (small, torch.cat([r(1002, 777), small, torch.zeros(
            64, dtype=torch.int64, device=dev), inf(3)]))
    return keys, queries, sets


def fuzz_searchsorted(torch, ops, rdf, seed: int, floor) -> dict:
    """searchsorted_inputs' queries and every one of its sets, each at the
    wrapper's parameters and at a small table with each path forced, all
    bit-identical to the plain version; the mostly distinct queries and
    the 1-4 distinct a warp set timed."""
    from repro_torch.kernels import searchsorted as ss
    keys, queries, sets = searchsorted_inputs(torch, rdf, seed)
    got = ops.searchsorted(keys, queries, impl="kernel")
    want = ops.searchsorted(keys, queries, impl="torch")
    torch.cuda.synchronize()
    mism = int((got != want).sum())
    err = int((got - want).abs().max())
    time_searchsorted(torch, ops, floor, keys, queries,
                      "fuzz (mostly distinct)")
    time_searchsorted(torch, ops, floor, *sets["1-4 distinct a warp"],
                      "1-4 distinct a warp")
    cases = bad = 0
    for name, (kk, qq) in sets.items():
        want = ops.searchsorted(kk, qq, impl="torch")
        outs = [ops.searchsorted(kk, qq, impl="kernel")]
        for table_max in (ss.TABLE_MAX, 8):
            for path in (ss.AUTO, ss.APART, ss.TOGETHER):
                outs.append(ss.launch(kk, qq, *ss.launch_params(
                    kk.numel(), table_max, path)))
        for o in outs:
            cases += 1
            d = int((o != want).sum())
            err = max(err, int((o - want).abs().max()))
            if d:
                bad += d
                log(f"[kernels] searchsorted MISMATCH: {name}: {d}")
    torch.cuda.synchronize()
    log(f"[kernels] searchsorted: M={keys.numel()} Q={queries.numel()} "
        f"mismatches={mism}; duplicate-heavy and boundary sets "
        f"{list(sets)}: {cases} runs (wrapper; tables of TABLE_MAX and 8 "
        f"entries x paths AUTO, APART, TOGETHER), mismatches={bad}")
    return {"mismatches": mism + bad, "max_abs_err": err}


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


def fuzz_flash_attention(torch, ops, seed: int) -> dict:
    """float32 and bfloat16; head dims 16..128; (h, g) of (4, 4), (8, 2),
    (32, 4); causal with sq == skv, causal with sq < skv (end-aligned),
    non-causal with sq != skv; lengths 1, 63, 65, 1000 and the like (not
    multiples of the 64- or 128-row tiles). randn inputs; a case fails
    above the reference test's tolerance or above ATTN_ROW_TOL of a row's
    largest output, and the fuzz fails unless each case ran on the kernel
    that kernels/flash_attention.py's rule names."""
    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    lengths = {"causal sq==skv": [(1, 1), (63, 63), (65, 65), (1000, 1000)],
               "causal sq<skv": [(1, 65), (63, 1000), (65, 130), (1, 1000)],
               "non-causal sq!=skv": [(65, 63), (1000, 1), (63, 1000),
                                      (1, 65)]}
    worst = {"float32": 0.0, "bfloat16": 0.0}
    worst_row = dict(worst)
    cases = misses = 0
    before = dict(ops.flash_attention_variants)
    expect = {"wgmma": 0, "simt": 0}
    for dname, dt in (("float32", torch.float32),
                      ("bfloat16", torch.bfloat16)):
        for e in (16, 32, 64, 128):
            for h, kvh in ((4, 4), (8, 2), (32, 4)):
                for mode, sq, skv in ((m, a, c) for m, ps in lengths.items()
                                      for a, c in ps):
                    b = 2 if h < 32 else 1
                    r = lambda *shape: torch.randn(
                        shape, generator=g, device="cuda").to(dt)
                    q, k, v = r(b, sq, h, e), r(b, skv, kvh, e), r(b, skv, kvh, e)
                    causal = mode.startswith("causal")
                    expect["wgmma" if dt == torch.bfloat16 and e in (64, 128)
                           else "simt"] += 1
                    got = ops.flash_attention(q, k, v, causal, impl="kernel")
                    want = ops.flash_attention(q, k, v, causal, impl="torch")
                    err = float((got.float() - want.float()).abs().max())
                    row = row_rel_err(got, want)
                    cases += 1
                    worst[dname] = max(worst[dname], err)
                    worst_row[dname] = max(worst_row[dname], row)
                    if not (err <= ATTN_TOL[dname]
                            and row <= ATTN_ROW_TOL[dname]):
                        misses += 1
                        log(f"[kernels] flash_attention MISS: {dname} e={e} "
                            f"h={h} g={kvh} {mode} sq={sq} skv={skv} "
                            f"max_abs_err={err} row_rel_err={row}")
    torch.cuda.synchronize()
    by_variant = {k: n - before[k] for k, n in ops.flash_attention_variants.items()}
    log(f"[kernels] flash_attention: {cases} cases (f32/bf16, e 16..128, "
        f"(h,g) (4,4)/(8,2)/(32,4), 3 masks, ragged lengths), by kernel "
        f"{by_variant} (wgmma: bf16 at e 64 and 128), max_abs_err "
        f"f32={worst['float32']:.3e} bf16={worst['bfloat16']:.3e}, "
        f"row_rel_err f32={worst_row['float32']:.3e} "
        f"bf16={worst_row['bfloat16']:.3e} (bounds {ATTN_ROW_TOL['float32']:.3e}"
        f" / {ATTN_ROW_TOL['bfloat16']:.3e}), misses={misses}")
    if by_variant != expect:
        misses += 1
        log(f"[kernels] flash_attention MISS: the fuzz's launches by kernel "
            f"{by_variant}, want {expect}")
    return {"mismatches": misses, "max_abs_err": max(worst.values())}


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
    for k in ("searchsorted", "probe_gather"):
        if main_launches[k] <= 0:
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
    return dict(store=store, d=d, plans=plans, launches=main_launches,
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


def time_kernels(torch, main: dict, fuzz: dict, floor) -> list:
    """Each kernel at the inputs the main path gives it, recorded from one
    execute_local run: the first rank-find of the first query with a
    multiway step (beside the streaming floor), and the first GET of the
    first query with a mapsin step."""
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
    t = time_searchsorted(torch, ops, floor, keys, q,
                          f"{name}, first multiway rank-find")
    out.append(dict(name="searchsorted", **KERNELS["searchsorted"],
                    launches=main["launches"]["searchsorted"],
                    max_abs_err=max(err, fz["searchsorted"]["max_abs_err"]),
                    mismatches=fz["searchsorted"]["mismatches"]
                    + int((got != want).sum()),
                    ms=t["ms"], plain_ms=t["plain_ms"],
                    bound_ms=t["bound_ms"], bound_by="bytes",
                    library_ms=t["library_ms"], floor_ms=t["floor_ms"],
                    shape=f"{name}, first multiway rank-find: "
                          f"M={keys.numel()} Q={q.numel()} "
                          f"distinct={t['distinct']}"))

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
    for k in out[1:]:                  # searchsorted's: time_searchsorted
        log(f"[timing] {k['name']}: {k['shape']}: ms={k['ms']:.6f} "
            f"plain_ms={k['plain_ms']:.6f} bound_ms={k['bound_ms']:.6f} "
            f"library_ms={k['library_ms']}")
    return out


# ---------------------------------------------------------------------------
# phase 5: the batched serving engine
# ---------------------------------------------------------------------------

# the serving bench's stream (benchmarks/bench_serving.py): its caps, 192
# requests from seed 0 at max_batch 16, escalation off for the identity
# checks; the SP2B-like tenant at the largest scale whose generation takes
# about 15 s on the host (the generator is quadratic in its scale)
SERVE_CAPS = dict(out_cap=128, probe_cap=32, row_cap=16)
SERVE_REQUESTS, SERVE_MAX_BATCH = 192, 16
SP2B_SCALE = 24_000
N_DEPT, N_PROF, N_COURSE = 12, 18, 24     # rdf_gen.lubm_like constants
# the heavy-hitter escalation case of tests/test_robustness.py
ESC_CAPS = dict(scan_cap=4096, out_cap=8, probe_cap=2, row_cap=4)


def serving_shapes(tenant: str, scale: int, rng) -> list:
    """(name, weight, sampler) of the serving bench's request shapes; a
    sampler draws the constants from `rng` and returns (s, p, o) terms."""
    u = lambda: rng.randint(scale)
    dept = lambda: f"Dept{rng.randint(N_DEPT)}.U{u()}"
    if tenant == "lubm":
        course = lambda: f"Course{rng.randint(N_COURSE)}.D{rng.randint(N_DEPT)}.U{u()}"
        prof = lambda: f"Prof{rng.randint(N_PROF)}.D{rng.randint(N_DEPT)}.U{u()}"
        return [
            ("lubm_q1", 3, lambda: [("?x", "rdf:type", "GraduateStudent"),
                                    ("?x", "takesCourse", course())]),
            ("lubm_q3", 3, lambda: [("?x", "rdf:type", "Publication"),
                                    ("?x", "publicationAuthor", prof())]),
            ("lubm_q5", 3, lambda: [("?x", "rdf:type", "Student"),
                                    ("?x", "memberOf", dept())]),
            ("lubm_q13", 3, lambda: [("?p", "worksFor", dept()),
                                     ("?x", "advisor", "?p")]),
            ("lubm_q7", 2, lambda: [("?y", "rdf:type", "Course"),
                                    (prof(), "teacherOf", "?y"),
                                    ("?x", "takesCourse", "?y"),
                                    ("?x", "rdf:type", "Student")]),
            ("lubm_q11", 1, lambda: [("?x", "rdf:type", "ResearchGroup"),
                                     ("?x", "subOrganizationOf",
                                      f"Univ{u()}")]),
            ("lubm_q4star", 2, lambda: [("?x", "rdf:type", "Professor"),
                                        ("?x", "worksFor", dept()),
                                        ("?x", "name", "?y1"),
                                        ("?x", "emailAddress", "?y2"),
                                        ("?x", "telephone", "?y3")]),
        ]
    n_persons = max(scale // 3, 8)
    return [
        ("sp2b_title", 3, lambda: [("?a", "rdf:type", "Article"),
                                   ("?a", "dc:title",
                                    f"title{2 * rng.randint(scale // 2)}"),
                                   ("?a", "dcterms:issued", "?yr")]),
        ("sp2b_author", 3, lambda: [("?a", "dc:creator",
                                     f"Person{rng.randint(n_persons)}"),
                                    ("?a", "dc:title", "?t")]),
        ("sp2b_person", 3, lambda: [("?s", "?pr",
                                     f"Person{rng.randint(n_persons)}")]),
    ]


def serving_stream(tenants: dict, n: int, rng) -> list:
    """`n` requests (tenant, shape name, patterns), shapes by weight."""
    choices = [(t, name, fn) for t, x in tenants.items()
               for name, w, fn in x["shapes"] for _ in range(w)]
    out = []
    for _ in range(n):
        t, name, fn = choices[rng.randint(len(choices))]
        out.append((t, name, [tenants[t]["d"].pattern(*x) for x in fn()]))
    return out


def replay(engines: dict, reqs: list) -> dict:
    """The saturated replay: every request queued at time 0, then the
    engine with the deepest queue steps until all are served, on a
    virtual clock advanced by each step's wall time. Returns the results
    by (tenant, rid), each request's latency (s), each dispatch's wall
    time (s), the wall time of the whole replay and the dispatches."""
    now, lat, step_s, out = 0.0, [], [], {}
    d0 = sum(e.dispatches for e in engines.values())
    t_all = time.perf_counter()
    for tenant, _, pats in reqs:
        engines[tenant].submit(pats, arrival=0.0, tenant=tenant)
    while any(e.pending() for e in engines.values()):
        busiest = max(engines, key=lambda t: engines[t].pending())
        t0 = time.perf_counter()
        results = engines[busiest].step(now=now)
        dt = time.perf_counter() - t0
        now += dt
        step_s.append(dt)
        for r in results:
            out[(busiest, r.request_id)] = r
            lat.append(now)
    return dict(results=out, lat=lat, step_s=step_s,
                wall=time.perf_counter() - t_all,
                dispatches=sum(e.dispatches for e in engines.values()) - d0)


def pct(xs: list, q: float) -> float:
    xs = sorted(xs)
    return xs[min(int(q * len(xs)), len(xs) - 1)] if xs else float("nan")


def enumerate_requests(reqs: list) -> dict:
    """(tenant, rid) -> request: each engine numbers its own submits."""
    out, nxt = {}, {}
    for t, name, pats in reqs:
        out[(t, nxt.get(t, 0))] = (t, name, pats)
        nxt[t] = nxt.get(t, 0) + 1
    return out


def seed_launches(template) -> int:
    """searchsorted launches of the seed scan of a template: its range
    GET (two rank-finds) on a bound prefix without residual filters,
    none on the full-scan path."""
    from repro_torch.core.plan import make_plan
    plan = make_plan(template.steps[0].patterns[0], template.const_vars)
    return 2 if plan.prefix and not plan.residual and not plan.eq_positions \
        else 0


def run_engine_serving(torch, args, lubm: dict, failures: list) -> None:
    """Two tenants' ServeEngines on the card: the LUBM-like store of the
    main path and an SP2B-like one, the serving bench's stream through
    them with impl="kernel" (the phase's main path), each request held
    against execute_local and against impl="torch" engines, each
    dispatch's launches against one execute_local of its template, then
    the saturated replay timed beside the sequential execute_local loop,
    an escalating run against the oracle and a traced replay."""
    import numpy as np

    from repro_torch.core import (Caps, ExecConfig, build_store,
                                  compile_plan, execute_local,
                                  execute_oracle, rows_set)
    from repro_torch.core.rdf import Pattern
    from repro_torch.data import sp2b_like
    from repro_torch.kernels import ops
    from repro_torch.obs import MetricsRegistry, Tracer
    from repro_torch.obs.trace import load_chrome, validate_events
    from repro_torch.serve import ServeEngine

    t0 = time.perf_counter()
    st, sd, _ = sp2b_like(SP2B_SCALE, seed=args.seed)
    t_gen = time.perf_counter() - t0
    tenants = {
        "lubm": dict(store=lubm["store"], d=lubm["d"],
                     n=lubm["store"].n_triples, scale=args.universities),
        "sp2b": dict(store=build_store(st, device="cuda"), d=sd,
                     n=len(st), scale=SP2B_SCALE)}
    log(f"[serve] tenants: lubm_like({args.universities}) "
        f"{tenants['lubm']['n']:,} triples (the main path's store); "
        f"sp2b_like({SP2B_SCALE}) {len(st):,} triples, generated in "
        f"{t_gen:.1f} s")
    rng = np.random.RandomState(args.seed)
    for t, x in tenants.items():
        x["shapes"] = serving_shapes(t, x["scale"], rng)
    reqs = serving_stream(tenants, SERVE_REQUESTS, rng)
    caps = Caps(**SERVE_CAPS)
    kern, plain = ExecConfig(impl="kernel"), ExecConfig(impl="torch")

    def engines(cfg):
        return {t: ServeEngine(x["store"], x["d"], cfg=cfg, caps=caps,
                               max_batch=SERVE_MAX_BATCH,
                               max_queue=4 * SERVE_REQUESTS,
                               compile_cache_size=64, max_escalations=0,
                               metrics=MetricsRegistry(), name=t)
                for t, x in tenants.items()}

    # the main path: counts to 0 just before, read just after; each
    # dispatch's launches recorded by template and batch
    eng = engines(kern)
    per_dispatch = []
    for t, e in eng.items():
        def counted(tid, template, batch, *a, _orig=e._dispatch, _t=t):
            before = dict(ops.launches)
            out = _orig(tid, template, batch, *a)
            per_dispatch.append((_t, tid, template, batch, tuple(
                ops.launches[k] - before[k]
                for k in ("searchsorted", "probe_gather"))))
            return out
        e._dispatch = counted
    ops.reset_launches()
    first = replay(eng, reqs)
    serve_launches, folds = dict(ops.launches), dict(ops.vmap_folds)
    for e in eng.values():
        del e._dispatch
    log(f"[serve] main path (2 engines, impl='kernel', {SERVE_REQUESTS} "
        f"requests, first run): {first['dispatches']} dispatches, kernel "
        f"launches {serve_launches}, vmap folds {folds}, "
        f"{first['wall']:.3f} s")
    for k in ("searchsorted", "probe_gather"):
        if serve_launches[k] <= 0:
            failures.append(f"serve: the engine never launched the {k} "
                            f"kernel")

    # each request against execute_local at the same caps
    local, ok_local = {}, 0
    for rid, (t, name, pats) in enumerate_requests(reqs).items():
        key = (t, tuple(pats))
        if key not in local:
            bnd = execute_local(tenants[t]["store"], pats, "mapsin", cfg=kern,
                                caps=caps)
            local[key] = (rows_set(bnd.table, bnd.valid, len(bnd.vars)),
                          tuple(bnd.vars), int(bnd.overflow))
        want, vars_, ovf = local[key]
        got = first["results"][rid]
        if got.rows_set(vars_) == want and got.overflow == ovf:
            ok_local += 1
        else:
            failures.append(f"serve: {t} {name} rid {rid[1]}: "
                            f"{len(got.rows)} rows, overflow {got.overflow}; "
                            f"execute_local {len(want)} rows, overflow {ovf}")

    # impl="kernel" against impl="torch" engines, request by request
    ops.reset_launches()
    plain_run = replay(engines(plain), reqs)
    if any(ops.launches.values()):
        failures.append(f"serve: impl='torch' engines launched kernels: "
                        f"{ops.launches}")
    ok_plain = 0
    for rid, got in first["results"].items():
        want = plain_run["results"].get(rid)
        if (want is not None and got.vars == want.vars
                and got.overflow == want.overflow and got.stats == want.stats
                and np.array_equal(got.rows, want.rows)):
            ok_plain += 1
        else:
            failures.append(f"serve: {rid}: the kernel and torch engines "
                            f"differ")
    overflowed = sum(r.overflow > 0 for r in first["results"].values())
    log(f"[serve] identity: {ok_local}/{SERVE_REQUESTS} requests equal "
        f"execute_local (rows and overflow, same caps), {ok_plain}/"
        f"{SERVE_REQUESTS} equal the impl='torch' engines; {overflowed} "
        f"requests report overflow at the bench's caps")

    # each dispatch launches as often as one query of its template
    by_tid: dict = {}
    for t, tid, template, batch, got in per_dispatch:
        by_tid.setdefault((t, tid), (template, {}))[1].setdefault(
            batch, set()).add(got)
    members = {}
    for (t, name, pats) in reqs:
        tid = eng[t]._signature_for(tuple(pats), caps)[0]
        members.setdefault((t, tid), pats)
    lines = []
    for (t, tid), (template, seen) in sorted(by_tid.items()):
        plan = eng[t]._compile(tuple(members[(t, tid)]))
        before = dict(ops.launches)
        execute_local(tenants[t]["store"], plan, cfg=kern)
        torch.cuda.synchronize()
        one = (ops.launches["searchsorted"] - before["searchsorted"]
               + seed_launches(template),
               ops.launches["probe_gather"] - before["probe_gather"])
        counts = set().union(*seen.values())
        lines.append(f"{t}:t{tid} {'+'.join(st.kind for st in template.steps)}"
                     f" batches {sorted(seen)} -> {sorted(counts)} "
                     f"(execute_local + seed: {one})")
        if counts != {one}:
            failures.append(f"serve: {t} template t{tid}: launches per "
                            f"dispatch {sorted(counts)} at batches "
                            f"{sorted(seen)}, one query launches {one}")
    log("[serve] launches (searchsorted, probe_gather) per dispatch by "
        "template: " + "; ".join(lines))

    # saturated replay on warmed engines beside the sequential loop
    for t, _, pats in reqs:
        eng[t].precompile(pats)
    torch.cuda.reset_peak_memory_stats()
    sat = replay(eng, reqs)
    peak = torch.cuda.max_memory_allocated()

    # the sequential loop from the patterns (planning inside the loop, as
    # the JAX bench times it: a run plans again whatever the store's LRU
    # plan cache no longer holds), then over plans compiled before it
    def sequential(items):
        t0 = time.perf_counter()
        for t, q in items:
            execute_local(tenants[t]["store"], q, "mapsin", cfg=kern,
                          caps=caps)
            torch.cuda.synchronize()
        return time.perf_counter() - t0
    seq_s = sequential([(t, pats) for t, _, pats in reqs])
    plans = [(t, compile_plan(tenants[t]["store"], pats, caps))
             for t, _, pats in reqs]
    seq_plan_s = sequential(plans)
    qps, qps_plan = SERVE_REQUESTS / sat["wall"], SERVE_REQUESTS / seq_plan_s
    avg_batch = SERVE_REQUESTS / max(sat["dispatches"], 1)
    log(f"[serve] saturated: engine {qps:.1f} queries/s ({sat['wall']:.4f} "
        f"s for {SERVE_REQUESTS}); sequential execute_local loop from "
        f"patterns {SERVE_REQUESTS / seq_s:.1f} queries/s ({seq_s:.4f} s), "
        f"from compiled plans {qps_plan:.1f} ({seq_plan_s:.4f} s); "
        f"engine over compiled-plan loop {qps / qps_plan:.3f}x; store plan "
        f"caches " + ", ".join(f"{t} {len(x['store'].plan_cache)}/"
                               f"{x['store'].plan_cache.maxsize} entries"
                               for t, x in tenants.items())
        + f"; {sat['dispatches']} dispatches, average "
        f"batch {avg_batch:.2f}; request latency p50 "
        f"{1e3 * pct(sat['lat'], 0.5):.3f} ms, p99 "
        f"{1e3 * pct(sat['lat'], 0.99):.3f} ms (all queued at 0); dispatch "
        f"wall p50 {1e3 * pct(sat['step_s'], 0.5):.3f} ms, p99 "
        f"{1e3 * pct(sat['step_s'], 0.99):.3f} ms; peak memory "
        f"{peak} bytes ({peak / 2 ** 30:.3f} GiB)")
    profile_query(torch, lambda: replay(eng, reqs), "engine replay", reps=1)
    profile_query(torch, lambda: sequential(plans),
                  "sequential loop over compiled plans", reps=1)

    # the escalation ladder against the oracle, at small scale
    g = np.random.RandomState(args.seed)
    tr = np.stack([g.randint(0, 40, 500), g.randint(100, 105, 500),
                   g.randint(0, 40, 500)], 1).astype(np.int32)
    chain = [Pattern("?x", 101, "?y"), Pattern("?y", 102, "?z")]
    e_esc = ServeEngine(build_store(tr, device="cuda"), caps=Caps(**ESC_CAPS),
                        metrics=False)
    res = e_esc.execute([chain])[0]
    want, ovars = execute_oracle(tr, chain)
    esc_ok = (res.rows_set(ovars) == want and res.overflow == 0
              and e_esc.escalations + e_esc.fallbacks > 0)
    log(f"[serve] escalation: heavy-hitter chain at out_cap "
        f"{ESC_CAPS['out_cap']}: {e_esc.escalations} escalations, "
        f"{e_esc.fallbacks} fallbacks, {len(res.rows)} rows, oracle "
        f"{len(want)}: equal {esc_ok}")
    if not esc_ok:
        failures.append("serve: the escalating run differs from the oracle")

    # a traced replay: Chrome trace under build/, schema-checked
    tracer, reg = Tracer(), MetricsRegistry()
    for e in eng.values():
        e.tracer, e.metrics_registry = tracer, reg
    w0 = tracer.now()
    traced = replay(eng, reqs)
    w1 = tracer.now()
    for e in eng.values():
        e.tracer = None
    coverage = tracer.coverage(w0, w1, track="engine")
    path = Path(__file__).resolve().parent / "build" / "TRACE_serving.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    tracer.export(str(path))
    events = load_chrome(str(path))
    validate_events(events)
    hist = reg.to_dict()["histograms"]
    p99 = {t: hist[f'serve_tenant_latency_seconds{{tenant="{t}"}}']["p99"]
           for t in tenants}
    log(f"[serve] trace: {path.relative_to(path.parents[1])}, "
        f"{len(events)} events, valid; span coverage of the engine track "
        f"{coverage:.4f}; traced replay {SERVE_REQUESTS / traced['wall']:.1f}"
        f" queries/s; tenant latency p99 (registry, virtual clock) "
        + ", ".join(f"{t} {1e3 * v:.3f} ms" for t, v in p99.items()))


# ---------------------------------------------------------------------------
# phase 6: exactness against the oracle
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


# ---------------------------------------------------------------------------
# phase 7: LM serving at full width
# ---------------------------------------------------------------------------


def sdpa_backends(torch, sdpa) -> str:
    """Device ms of scaled_dot_product_attention restricted to each fused
    backend, so the default call's time can be matched to the backend it
    chose. Informational."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    out = []
    for name in ("FLASH_ATTENTION", "CUDNN_ATTENTION", "EFFICIENT_ATTENTION"):
        try:
            with sdpa_kernel([getattr(SDPBackend, name)]):
                out.append(f"{name.lower()} {cuda_ms(torch, sdpa, iters=5):.6f} ms")
        except (RuntimeError, AttributeError) as e:
            out.append(f"{name.lower()} unavailable ({str(e).splitlines()[0][:60]})")
    return "; ".join(out)


def run_lm_serving(torch, args, failures: list) -> dict:
    """yi-6b at full width through launch/serve.py's greedy loop with the
    flash-attention kernel; then kernel against plain, teacher-forced on
    the kernel run's tokens; then the kernel at the first layer's inputs."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model

    cfg = get_config("yi-6b")
    model = build_model(cfg, "cuda")
    t0 = time.perf_counter()
    params = model.init_params(args.seed)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    rng = np.random.RandomState(args.seed)
    toks = torch.as_tensor(
        rng.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT)),
        dtype=torch.int32, device="cuda")
    log(f"[lm] {cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, heads "
        f"{cfg.num_heads}/{cfg.num_kv_heads} x {cfg.resolved_head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.param_dtype}; "
        f"{cfg.n_params() / 1e9:.3f} B params; init_params "
        f"{t_init:.2f} s; prompts {LM_BATCH} x {LM_PROMPT}, {LM_DECODE} "
        f"decode steps")

    # the main path: counts to 0 just before, read just after
    ops.reset_launches()
    ids, t_prefill_first, t_decode = generate(model, params, toks, LM_DECODE)
    lm_launches = dict(ops.launches)
    log(f"[lm] main path (launch/serve.py generate): kernel launches "
        f"{lm_launches}; first prefill {t_prefill_first * 1e3:.3f} ms, "
        f"decode {t_decode * 1e3:.3f} ms/token")
    lm_variants = dict(ops.flash_attention_variants)
    log(f"[lm] flash_attention launches by kernel: {lm_variants}")
    if lm_launches["flash_attention"] != cfg.num_layers:
        failures.append(f"lm: {lm_launches['flash_attention']} flash_attention "
                        f"launches in one prefill + decode, want "
                        f"{cfg.num_layers}")
    if lm_variants != {"wgmma": cfg.num_layers, "simt": 0}:
        failures.append(f"lm: flash_attention launches by kernel "
                        f"{lm_variants}, want all {cfg.num_layers} on wgmma")

    # teacher-forced: both impls see the kernel run's tokens
    model_t = build_model(dataclasses.replace(cfg, attention_impl="torch"),
                          "cuda")
    runs = {}
    for name, m in (("kernel", model), ("torch", model_t)):
        ops.reset_launches()
        logits, cache = m.prefill(params, {"tokens": toks})
        after_prefill = ops.launches["flash_attention"]
        steps = [logits.float()]
        for i in range(LM_DECODE - 1):
            logits, cache = m.decode_step(params, cache, ids[:, i:i + 1].to(torch.int32))
            steps.append(logits.float())
        torch.cuda.synchronize()
        want = cfg.num_layers if name == "kernel" else 0
        if ops.flash_attention_variants != {"wgmma": want, "simt": 0}:
            failures.append(f"lm {name}: flash_attention launches by kernel "
                            f"{ops.flash_attention_variants}, want {want} "
                            f"wgmma")
        if after_prefill != want or ops.launches["flash_attention"] != want:
            failures.append(f"lm {name}: flash_attention launches "
                            f"{after_prefill} after prefill, "
                            f"{ops.launches['flash_attention']} after decode;"
                            f" want {want} and {want}")
        runs[name] = torch.stack(steps)          # (steps, b, vocab)
        del cache
    kern, plain = runs["kernel"], runs["torch"]
    same_ids = bool(torch.equal(kern.argmax(-1).T, ids))
    scale = float(kern.abs().max())
    err = (kern - plain).abs().amax(dim=(1, 2))
    worst = float(err.max())
    agree = int((plain.argmax(-1).T == ids).sum())
    log(f"[lm] kernel vs torch, teacher-forced: max|logits| {scale:.4f}; "
        f"max|delta| prefill {float(err[0]):.5f}, over all "
        f"prefill + {LM_DECODE - 1} decode steps {worst:.5f} (bound {LOGIT_TOL} x max|logits| = "
        f"{LOGIT_TOL * scale:.5f}); greedy ids agree {agree}/{ids.numel()}; "
        f"kernel rerun reproduces the generated ids: {same_ids}")
    if not (math.isfinite(scale) and worst <= LOGIT_TOL * scale):
        failures.append(f"lm: kernel and torch logits differ by {worst} "
                        f"(bound {LOGIT_TOL * scale})")
    if not same_ids:
        failures.append("lm: the kernel rerun did not reproduce the ids")
    del runs, kern, plain, model_t

    # prefill time (median of 3 after a warm-up that records layer 0's args)
    batch = {"tokens": toks}
    x = first_call_args(ops, "flash_attention",
                        lambda: model.prefill(params, batch))
    t_prefill = wall_ms(torch, lambda: model.prefill(params, batch), runs=3)
    tok_s = LM_BATCH * LM_PROMPT / (t_prefill / 1e3)
    log(f"[lm] prefill {LM_BATCH}x{LM_PROMPT}: {t_prefill:.3f} ms (median "
        f"of 3), {tok_s:.1f} tokens/s; decode {t_decode * 1e3:.3f} "
        f"ms/token ({LM_BATCH} sequences)")
    logits, cache = model.prefill(params, batch)
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    profile_query(torch, lambda: model.prefill(params, batch), "lm prefill",
                  reps=1)
    profile_query(torch, lambda: model.decode_step(params, cache, tok),
                  "lm decode step")
    del cache
    kernel = time_flash_attention(torch, ops, x)
    kernel["launches"] = lm_launches["flash_attention"]
    return dict(kernel=kernel, prefill_ms=t_prefill, tokens_per_s=tok_s,
                decode_ms=t_decode * 1e3, init_s=t_init)


def time_flash_attention(torch, ops, x: dict) -> dict:
    """The kernel, its plain version and SDPA on layer 0's (q, k, v)."""
    import torch.nn.functional as F
    q, k, v, causal = x["q"], x["k"], x["v"], x["causal"]
    b, sq, h, e = q.shape
    skv = k.shape[1]
    got = ops.flash_attention(q, k, v, causal, impl="kernel")
    want = ops.flash_attention(q, k, v, causal, impl="torch")
    err = float((got.float() - want.float()).abs().max())
    row = row_rel_err(got, want)
    dname = "bfloat16" if q.dtype == torch.bfloat16 else "float32"
    t_k = cuda_ms(torch, lambda: ops.flash_attention(q, k, v, causal, impl="kernel"),
                  iters=5, warmup=1)
    t_p = cuda_ms(torch, lambda: ops.flash_attention(q, k, v, causal, impl="torch"),
                  iters=3, warmup=1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                  enable_gqa=True)
    t_l = cuda_ms(torch, sdpa, iters=10)
    lib_out = sdpa().transpose(1, 2)
    sdpa_err = float((lib_out.float() - want.float()).abs().max())
    sdpa_row = row_rel_err(lib_out, want)
    del lib_out
    backend = sdpa_backends(torch, sdpa)
    # what these inputs need: every unmasked (q, k) pair costs 2 flops in
    # q.k and 2 in p.v per head dim; q, k, v read once, o written once
    if causal:
        off = skv - sq
        pairs = sum(min(max(i + off + 1, 0), skv) for i in range(sq))
    else:
        pairs = sq * skv
    flops = 4 * b * h * e * pairs
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    t_ops, t_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    rec = dict(name="flash_attention", **KERNELS["flash_attention"],
               max_abs_err=err, mismatches=int(not (
                   err <= ATTN_TOL[dname] and row <= ATTN_ROW_TOL[dname])),
               ms=t_k, plain_ms=t_p, bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               library_ms=t_l,
               shape=f"yi-6b prefill layer 0: q {tuple(q.shape)} k/v "
                     f"{tuple(k.shape)} {dname} causal={causal}; "
                     f"{flops:.4e} flops ({t_ops:.6f} ms at the bf16 "
                     f"tensor peak, {flops / F32_FLOPS * 1e3:.6f} ms at "
                     f"the f32 peak), {nbytes:.4e} bytes ({t_bytes:.6f} "
                     f"ms); SDPA by backend: {backend}")
    log(f"[timing] flash_attention: {rec['shape']}: ms={t_k:.6f} "
        f"plain_ms={t_p:.6f} bound_ms={rec['bound_ms']:.6f} "
        f"({rec['bound_by']}) library_ms={t_l:.6f}; kernel "
        f"{flops / t_k / 1e9:.1f} TFLOP/s, {100 * rec['bound_ms'] / t_k:.1f}% "
        f"of the bound (SDPA {flops / t_l / 1e9:.1f} TFLOP/s); max_abs_err "
        f"against the plain version: kernel {err:.3e}, SDPA {sdpa_err:.3e}; "
        f"row_rel_err: kernel {row:.3e}, SDPA {sdpa_row:.3e} (bound "
        f"{ATTN_ROW_TOL[dname]:.3e})")
    return rec


def phase_done(name: str, t0: float) -> float:
    now = time.perf_counter()
    log(f"[phase] {name}: {now - t0:.1f} s")
    return now


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

    # true float32 in the plain versions' matrix products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    floor_ready = start_floor_build(_build)
    _build.build_all()
    floor = floor_ready()
    log(f"[build] nvcc, {len(_build.SOURCES)} kernels in parallel: "
        f"{_build.build_seconds:.1f} s wall")
    report_build(_build)

    # each phase reports its own failure and the next one still runs
    fuzz = {}
    try:
        fuzz["searchsorted"] = fuzz_searchsorted(torch, ops, rdf, args.seed,
                                                 floor)
        fuzz["probe_gather"] = fuzz_probe_gather(torch, ops, rdf, args.seed)
        fuzz["flash_attention"] = fuzz_flash_attention(torch, ops, args.seed)
        for k, rec in fuzz.items():
            if rec["mismatches"]:
                failures.append(f"{k}: {rec['mismatches']} mismatches "
                                f"against the plain version")
    except Exception:
        failures.append(f"phase kernels:\n{traceback.format_exc()}")
    t_phase = phase_done("build + kernels", t_phase)

    kernels = []
    lubm = None
    torch.cuda.reset_peak_memory_stats()
    try:
        main_run = run_main_path(torch, args, failures)
        lubm = dict(store=main_run["store"], d=main_run["d"])
        kernels = time_kernels(torch, main_run, fuzz, floor)
        for k in kernels:
            if k["mismatches"]:
                failures.append(f"{k['name']}: mismatches at the main "
                                f"path's inputs")
        del main_run
    except Exception:
        failures.append(f"phase main path:\n{traceback.format_exc()}")
    peak = torch.cuda.max_memory_allocated()
    t_phase = phase_done("LUBM main path", t_phase)

    # the serving engine over the main path's store (not built twice)
    if lubm is None:
        failures.append("phase engine serving: no LUBM store from the "
                        "main path")
    else:
        try:
            run_engine_serving(torch, args, lubm, failures)
        except Exception:
            failures.append(f"phase engine serving:\n{traceback.format_exc()}")
    del lubm
    torch.cuda.empty_cache()
    t_phase = phase_done("engine serving", t_phase)

    try:
        check_oracle(torch, failures)
    except Exception:
        failures.append(f"phase exactness:\n{traceback.format_exc()}")
    t_phase = phase_done("exactness", t_phase)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        lm = run_lm_serving(torch, args, failures)
        fz = fuzz.get("flash_attention", {"mismatches": 0, "max_abs_err": 0})
        k = lm["kernel"]
        k["mismatches"] += fz["mismatches"]
        k["max_abs_err"] = max(k["max_abs_err"], fz["max_abs_err"])
        if k["mismatches"]:
            failures.append("flash_attention: mismatches against the plain "
                            "version")
        kernels.append(k)
    except Exception:
        failures.append(f"phase LM serving:\n{traceback.format_exc()}")
    lm_peak = torch.cuda.max_memory_allocated()
    phase_done("LM serving", t_phase)

    print(json.dumps({"kernels": kernels}), flush=True)
    log(f"memory: max_memory_allocated {peak} bytes "
        f"({peak / 2 ** 30:.2f} GiB) over the main path; {lm_peak} bytes "
        f"({lm_peak / 2 ** 30:.2f} GiB) over LM serving")
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
