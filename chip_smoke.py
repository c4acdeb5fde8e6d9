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
               overflow), the kernels' launch counters checked, each
               query's all-reduce-side plan equal on both impls with
               one sort_merge_compact launch a pattern, and each kernel
               timed at the inputs the main path gives it; then Q8 of the
               benchmark cell lubm63.adhoc on the cell's own data
               (portbench's generator) and caps: its one reduce-side step
               launches sort_merge_compact once, bit-identical to
               impl="torch" with no overflow, the op timed at that step's
               inputs beside their byte bound;
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
  6. ingest  — the durable mutable store (store/) on the card, as the
               JAX package's loading bench drives it, at the main path's
               scale: half the main path's triples preloaded and flushed,
               the rest in 4 waves (overlay limit 2^16, one shard) into a
               store under build/ingest/ (real fsyncs), Q1/Q4 served
               between waves by a ServeEngine (max_batch 8, the bench's
               caps) beside the main path's store under an identical
               engine; every refresh of the device views (two
               searchsorted launches an index) timed and held bit for
               bit against the numpy merge; preload and wave triples/s,
               flush s, qps of both stores, overlay_qps_ratio, p99,
               host time by function, peak memory; every LUBM query on
               the mutable store (impl="kernel" and "torch") equal to
               the main path's; the kernel timed at the merge's shapes;
               recovery at scale exact; a SIGKILL canary (a child
               process, `--crash-child`) and a DurabilityFaultPlan crash
               each recovered to a prefix holding every ack;
  7. distributed — the main path's triples in an 8-shard store on a
               LocalMesh(8) (eight region servers in one process, one
               thread a shard, on the one card): every LUBM query through
               execute_sharded, mapsin on routings a2a and broadcast x
               impl "kernel" and "torch" and the reduce-side baseline,
               each against execute_local on the main path's store (rows;
               mapsin overflow 0; reduce overflow reported; the reduce
               run's sort_merge_compact launches, one a shard a
               reduce-side pattern), per-query
               caps read off the plan's measured step sizes, wall ms,
               static payload bytes a shard, searchsorted launches and
               peak memory a query; searchsorted timed and held bit for
               bit at the answer phase's own inputs; the serving bench's
               sharded stream (160 requests, a2a, max_batch 16) through
               ServeEngine(mesh=...) against the sequential
               execute_sharded loop and execute_local; its 1% FaultPlan
               row and the drop + corrupt canary (no wrong row in a
               complete result); the sharded engine over an 8-shard
               MutableTripleStore across ingests (cut to lubm_like(4))
               against the oracle;
  8. exactness — row sets against the oracle at small scale;
  9. LM serving at full width — yi-6b (32 layers, d 4096, bf16) with
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
  10. LM families at full width — qwen3-8b (36 layers, qk-norm),
               pixtral-12b (40; 256 patch embeddings + 3744 text tokens),
               musicgen-large (48; 4 codebooks) and dbrx-132b (MoE, 16
               experts top-4; 8 of its 40 layers), bf16, weights from the
               seed, each freed before the next: 4 prompts of 4000
               positions (dbrx 2048) prefilled and 32 tokens decoded
               through generate with the kernel (one wgmma launch a layer
               a prefill, none in decode), teacher-forced against the
               plain version under the logits gate; for dbrx the plain
               version and a plain model of the kernel's bf16 rounding
               take the kernel run's expert ids, the kernel held to
               twice the model (logits, router probabilities) and each
               routing the plain run would take otherwise a near-tie,
               the free-running routing reported, and the dropped share
               a MoE layer; prefill ms and tokens/s,
               decode ms/token beside the weight-read floor, peak memory,
               and the kernel at layer 0's (q, k, v) beside SDPA;
  11. LM MLA — deepseek-v3-671b at full width (d 7168, 128 heads,
               q_lora 1536, kv_lora 512, dn 128, dr 64, dv 128, 256
               experts top-8 + 1 shared, bf16, weights from the seed) cut
               to its 3 dense layers, 1 MoE layer and the MTP module
               (53.45 GB): (a) 4 prompts of 4000 tokens prefilled and 32
               tokens decoded through generate (the latent cache, the
               absorbed decode): prefill ms and tokens/s, decode ms/token
               beside the time to read what decode reads, peak memory;
               (b) no kernel launched (MLA reaches none in either
               package); (c) blockwise MLA against the naive yardstick on
               layer 0's own inputs (1 x 2048) under the family shapes'
               attention bound, both timed; (d) prefill(1 x 1024) +
               decode_step against prefill(1 x 1025) under the decode
               run's routing, no pair dropped, within the logits gate, the
               first run free of host syncs; (e) the loss with MTP under
               no_grad: ce, aux and mtp_ce finite, loss = ce + 1e-3 aux +
               0.1 mtp_ce; (f) the float8 cache cast on the card equal to
               the CPU's bit for bit;
  12. LM recurrent — recurrentgemma-9b whole (38 layers: RG-LRU blocks
               and local attention, window 2048, 16/1 heads x 256; 10.445
               B params, bf16, weights from the seed): (a) 4 prompts of
               4096 tokens (twice the window) and 32 greedy steps through
               generate: prefill ms and tokens/s, decode ms/token beside
               the time to read what decode reads, peak memory, a
               profiled prefill and decode step; (b) no kernel launched
               (flash attention has no window and no head dim 256); (c)
               local_attention against naive_attention(window=2048) on
               the first attention layer's own inputs (1 x 4096) under
               phase 11 (c)'s bounds; (d) rg_lru_scan against a float32
               step-by-step recurrence on the first recurrent layer's
               gates (1 x 4096 x 4096), rtol 2e-5, atol 1e-5, TF32 off;
               (e) prefill(1 x 4096) + decode_step against prefill(1 x
               4097) within the logits gate, free of host syncs, the step
               writing slot 0 of every attention layer's rotating cache;
               a windowed attention(impl="kernel") on bf16 CUDA tensors
               launching no flash kernel and equal to local_attention bit
               for bit; then xlstm-125m whole (12 layers, sLSTM at 5 and
               11): (a), (b) at 4 x 2048, (c) mlstm_chunkwise against the
               token-by-token mlstm_decode on layer 0's inputs within
               2e-4, (d) prefill(1 x 2048) + decode_step against
               prefill(1 x 2049), free of host syncs;
  13. LM training at full width — yi-6b's width (d 4096, 32/4 heads x
               128, d_ff 11008, vocab 64000, bf16) cut to 16 layers,
               batch 2 x 4096 from batch_for_step, remat "names", through
               runtime.Trainer.run for 6 steps (the first a warm-up, the
               last profiled): per step ms, tokens/s, loss, grad norm, lr
               and flash_attention launches (2 a layer: forward and
               recompute, all wgmma), model FLOPs and their share of the
               bf16 peak, peak memory, the profiled step's device busy
               share with the attention backward, GEMMs, cross-entropy and
               AdamW named; the first step's loss, grad norm and every
               gradient leaf with attention_impl="kernel" against "torch";
               the kernel at layer 0's training (q, k, v) beside SDPA and
               the plain backward's time there, the plain backward against
               autograd of the plain forward; determinism; a bit-exact
               crash-resume on one full-width layer (1 x 1024, 6 steps,
               checkpoint every 4, killed at 5) with checkpoint write and
               load GB/s; `python -m repro_torch.launch.train --smoke`;
  14. LM family training at full width — qwen3-8b, deepseek-7b, yi-34b
               and pixtral-12b cut to 2 layers, musicgen-large to 4
               (2 x 4096 positions), dbrx-132b to 1 (2 x 2048),
               recurrentgemma-9b to one macro of 3 layers (2 x 4096),
               xlstm-125m whole (2 x 2048), each freed before the next:
               (a) runtime.Trainer.run for 4 steps (a warm-up, 2 timed,
               1 profiled): step ms, tokens/s, model FLOPs of the
               family's active matrices and attention or cells and
               their share of the bf16 peak, peak memory, busy share,
               the profiled step's ranges, flash_attention launches a
               step (2 a layer for the GQA families, all wgmma; 0 for
               the recurrent ones), every loss and grad norm finite and
               every leaf moved; (b) step 0: the GQA families' kernel
               against the plain attention beside a plain model of the
               kernel's rounding (phase 13's gates; dbrx under the
               kernel run's routing, its router's probabilities too),
               the recurrent families' bf16 against float32 at the same
               weights (loss within 1%, gradients' cosine >= 0.99; for
               xlstm, whose gradients a bf16-sized change of the weights
               moves to cosine ~0.2, that cosine is reported and the
               bounds hold the card's float32 run against the CPU's on
               1 x 512 positions); (c) two identical step-0 runs equal
               bit for bit under deterministic algorithms; (d) xlstm's
               bit-exact crash-resume (1 x 128); each GQA family's kernel
               timed at layer 0's training (q, k, v) beside SDPA and the
               plain backward; deepseek-v3-671b at 1 dense layer + MTP
               (14.05 B params, 1 x 4096) through loss_and_grads only (no
               room for moments): twice bit for bit, loss = ce + 1e-3 aux
               + 0.1 mtp_ce, every leaf finite, the mtp leaves nonzero, no
               kernel launched, and one SGD step (stochastically rounded
               to bf16) lowering the loss by at least half its
               first-order decrease;
  15. sharding and launch — qwen3-8b (vocab 151,936, d 4096, bf16,
               weights from the seed): (a) its embedding table (1.24 GB)
               looked up vocab-sharded by mapsin_embed over LocalMesh(8) on
               `model` for 4 x 4000 ids, equal to the dense gather bit for
               bit, both timed, the lookup's extra memory; (b) 4 of its
               layers, a 4 x 4000 prefill with a data 1 x model 8 mesh and
               its rules and one without: logits equal bit for bit, one
               wgmma flash launch a layer each, no graph recorded under
               no_grad, the sharded lookup run (LocalMesh runs on `model`)
               in the mesh run and not in the other; (c) 2 layers through
               Trainer.run for 3 steps at 2 x 4096 with the mesh and rules
               and without: every step's metrics and the final parameters
               equal bit for bit, step ms of both, the flash launches (2 a
               layer a step), the sharded lookup run on the mesh alone; (d) (c)'s
               parameters saved and loaded onto the shardings of
               make_rules(make_mesh_for(8, model_par=4)): every block of
               its sharding's shape, shard 0's bytes equal to
               sharded_bytes_per_device, the rebuilt tree and a save from
               the mesh loaded with no mesh equal bit for bit, GB/s each
               way; (e) `python -m repro_torch.launch.dryrun --all --mesh
               both` (FlopCounterMode on meta tensors, one process a host
               core) and `python -m repro_torch.launch.roofline` on its
               reports: cells counted, seconds, each cell's counted flops
               over the cost model's, and the cost
               model's one-GPU terms for phase 13's yi-6b beside its
               measured step;
  16. summary — the kernels line, the memory line, the card line, and the
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
import types
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
# the LM families' (heads, kv heads): qwen3-8b and pixtral-12b, dbrx-132b,
# yi-34b, deepseek-7b and musicgen-large
FAMILY_HEADS = ((32, 8), (48, 8), (56, 8), (32, 32))
CAPS_MAIN = dict(scan_cap=1 << 20, out_cap=1 << 20, probe_cap=128, row_cap=64)
CAPS_SMALL = dict(scan_cap=1 << 12, out_cap=1 << 12, probe_cap=128, row_cap=64)
KERNELS = {
    "searchsorted": dict(route="cuda",
                         source="src/repro_torch/csrc/searchsorted.cu",
                         replaces="src/repro/kernels/searchsorted.py:70"),
    "probe_gather": dict(route="cuda",
                         source="src/repro_torch/csrc/probe_gather.cu",
                         replaces="src/repro/kernels/probe_gather.py:140"),
    # the GET and the MAPSIN merge in one (probe_count_kernel, a scan,
    # probe_emit_kernel): replaces no TPU kernel, but probe_gather's call
    # and merge_bindings' capacity-sized temporaries in mapsin_step
    "probe_compact": dict(route="cuda",
                          source="src/repro_torch/csrc/probe_gather.cu",
                          replaces=None),
    # one star pattern's rows from the row-GET's ranks (multiway_count_kernel,
    # a scan, multiway_emit_kernel): replaces no TPU kernel, but
    # multiway_merge's (capacity, row_cap) temporaries in multiway_step
    "multiway_compact": dict(route="cuda",
                             source="src/repro_torch/csrc/probe_gather.cu",
                             replaces=None),
    # the reduce-side join's merge after its sort (sort_merge_count_kernel,
    # a scan, sort_merge_emit_kernel): replaces no TPU kernel, but
    # sort_merge_join's (L, probe_cap) window grid and its compact
    "sort_merge_compact": dict(route="cuda",
                               source="src/repro_torch/csrc/probe_gather.cu",
                               replaces=None),
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


def device_totals(torch, prof) -> list:
    """The device events of a trace summed by name, as the profiler's
    key_averages() gives them (key, self_device_time_total in us, count),
    read from the raw trace in one pass: building the profiler's event
    tree for key_averages() takes minutes over the 10^5-10^6 events of a
    host-bound run."""
    from torch.autograd import DeviceType
    tot: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            t = tot.setdefault(e.name(), [0.0, 0])
            t[0] += e.duration_ns() / 1e3
            t[1] += 1
    return [types.SimpleNamespace(key=k, self_device_time_total=us, count=n)
            for k, (us, n) in tot.items() if us > 0]


def device_events(torch, fn, reps: int):
    """(host ms per call, [device-side profiler sums by name]) over `reps`
    calls traced by torch.profiler; the device side holds the kernels'
    and copies' own durations, without the gaps between them."""
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
    return wall, device_totals(torch, prof)


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


def probe_fuzz_inputs(torch, rdf, seed: int):
    """(keys, lo, hi, flt, g): fat rows (range > cap), empty, degenerate
    (lo >= hi), invalid-row and whole-index ranges, and the generator."""
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
    return keys, lo.contiguous(), hi.contiguous(), flt, g


def fuzz_probe_gather(torch, ops, rdf, seed: int) -> dict:
    """All eight flt_mask combinations, with and without eq_positions, over
    every kind of range of `probe_fuzz_inputs`, caps from 8 to 256."""
    keys, lo, hi, flt, _ = probe_fuzz_inputs(torch, rdf, seed)
    b = lo.numel()
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


def fuzz_probe_compact(torch, ops, rdf, seed: int) -> dict:
    """probe_compact's kernels against its plain version, bit for bit, on
    `probe_fuzz_inputs`' ranges with a binding table of 3 columns: caps
    from 8 to 256, 8 flt masks, 4 eq sets, 0 to 3 new fields, an out_cap
    that holds every match and one that cuts; then 4 slots under vmap."""
    keys, lo, hi, flt, g = probe_fuzz_inputs(torch, rdf, seed)
    b = lo.numel()
    table = torch.randint(0, 1 << 20, (b, 3), generator=g, device="cuda",
                          dtype=torch.int32)
    news = ((), (2,), (1, 2), (0, 1, 2))
    mism = cases = 0
    for cap in (8, 12, 33, 64, 128, 256):
        for fm in range(8):
            msk = tuple(bool(fm >> i & 1) for i in range(3))
            for eq in ((), ((0, 2),), ((1, 2),), ((0, 1), (0, 2))):
                for out_cap in (b * cap, 1000):
                    args = (keys, lo, hi, flt, table, cap, out_cap, msk, eq,
                            news[(fm + cap) % 4])
                    got = ops.probe_compact(*args, "kernel")
                    want = ops.probe_compact(*args, "torch")
                    cases += 1
                    mism += sum(int((x != y).sum()) for x, y in zip(got, want))
    slots = [x[:4000].reshape(4, 1000, *x.shape[1:])
             for x in (lo, hi, flt, table)]
    call = lambda impl: lambda a, c, f, t: ops.probe_compact(
        keys, a, c, f, t, 64, 500, (False, True, False), (), (0, 2), impl)
    got = torch.func.vmap(call("kernel"))(*slots)
    for i in range(4):
        want = call("torch")(*(x[i] for x in slots))
        mism += sum(int((x[i] != y).sum()) for x, y in zip(got, want))
    torch.cuda.synchronize()
    log(f"[kernels] probe_compact: {cases} cases (caps 8..256, 8 flt masks, "
        f"4 eq sets, out_cap all or 1000) + 4 slots under vmap, "
        f"M={keys.numel()} B={b} mismatches={mism}")
    return {"mismatches": mism, "max_abs_err": 0 if mism == 0 else None}


def fuzz_multiway_compact(torch, ops, rdf, seed: int) -> dict:
    """multiway_compact's kernels against its plain version, bit for bit,
    on `probe_fuzz_inputs`' ranges as the bindings' rows (fat, empty,
    degenerate, invalid and whole-index), a second set of filter values
    for the prefix components, and 8000 rows of 3 columns with origins in
    every binding, a fifth of them invalid: row caps from 8 to 256, 8
    residual masks, 3 prefix masks, 4 eq sets, 0 to 3 new fields, an
    out_cap that holds every row and one that cuts; then 4 slots under
    vmap."""
    keys, lo, hi, flt, g = probe_fuzz_inputs(torch, rdf, seed)
    b, r, dev = lo.numel(), 8000, "cuda"
    start = ops.searchsorted(keys, lo, "torch")
    end = ops.searchsorted(keys, hi, "torch")
    ri = lambda hi_, n: torch.randint(0, hi_, (n,), generator=g, device=dev)
    extra = torch.stack([ri(3005, b), ri(7, b), ri(9, b)], 1).contiguous()
    origin = ri(b, r).to(torch.int32)
    table = torch.randint(0, 1 << 20, (r, 3), generator=g, device=dev,
                          dtype=torch.int32)
    valid = torch.rand(r, generator=g, device=dev) < 0.8
    rows = (start, end, flt, extra, origin, table, valid)
    news = ((), (2,), (1, 2), (0, 1, 2))
    mism = cases = 0
    for row_cap in (8, 12, 33, 64, 128, 256):
        for fm in range(8):
            msk = tuple(bool(fm >> i & 1) for i in range(3))
            for xm in (0, 2, 6):
                xmsk = tuple(bool(xm >> i & 1) for i in range(3))
                for eq in ((), ((0, 2),), ((1, 2),), ((0, 1), (0, 2))):
                    for out_cap in (r * row_cap, 1000):
                        args = (keys, *rows, row_cap, out_cap, msk, xmsk, eq,
                                news[(fm + xm + row_cap) % 4])
                        got = ops.multiway_compact(*args, "kernel")
                        want = ops.multiway_compact(*args, "torch")
                        cases += 1
                        mism += sum(int((x != y).sum())
                                    for x, y in zip(got, want))
    slots = [x[:4000].reshape(4, 1000, *x.shape[1:]) for x in rows[:4]] + [
        x.reshape(4, 2000, *x.shape[1:]) for x in rows[4:]]
    slots[4] = slots[4] % 1000                   # origins within a slot
    call = lambda impl: lambda *a: ops.multiway_compact(
        keys, *a, 64, 500, (False, False, True), (False, True, False), (),
        (0, 2), impl)
    got = torch.func.vmap(call("kernel"))(*slots)
    for i in range(4):
        want = call("torch")(*(x[i] for x in slots))
        mism += sum(int((x[i] != y).sum()) for x, y in zip(got, want))
    torch.cuda.synchronize()
    log(f"[kernels] multiway_compact: {cases} cases (row caps 8..256, 8 flt "
        f"masks, 3 prefix masks, 4 eq sets, out_cap all or 1000) + 4 slots "
        f"under vmap, M={keys.numel()} B={b} R={r} mismatches={mism}")
    return {"mismatches": mism, "max_abs_err": 0 if mism == 0 else None}


# (extra_eq, r_out_cols) of a join on left column 0 = right column 1: no
# further shared variable, one, and two (every right column then shared)
SORT_MERGE_JOINS = (((), (0, 2)), (((1, 0),), (2,)), (((1, 0), (2, 2)), ()))


def fuzz_sort_merge_compact(torch, ops, seed: int) -> dict:
    """sort_merge_compact's kernels against its plain version, bit for bit:
    20,000 left rows against 30,000 right rows of 3 int32 columns over 400
    join keys (a tenth of the right rows on one key, past every cap:
    missed), a fifth of each side invalid, the right side sorted as
    sort_merge_join sorts it: probe caps from 3 to 1024, no, one and two
    extra equalities, an out_cap that holds every match and one that
    cuts; then sort_merge_join on both routes, `found` included."""
    from repro_torch.core.reduce_side import sort_merge_join
    g = torch.Generator(device="cuda").manual_seed(seed + 11)
    ri = lambda hi, *shape: torch.randint(0, hi, shape, generator=g,
                                          device="cuda", dtype=torch.int32)
    l, m = 20000, 30000
    lt, rt = ri(400, l, 3), ri(400, m, 3)
    lt[:, 1:], rt[:, 0] = lt[:, 1:] % 7, rt[:, 0] % 7
    rt[:, 2] %= 7
    rt[: m // 10, 1] = 5                       # one key past every cap
    lv = torch.rand(l, generator=g, device="cuda") < 0.8
    rv = torch.rand(m, generator=g, device="cuda") < 0.8
    rkey = torch.where(rv, rt[:, 1], 2 ** 31 - 1)
    order = torch.argsort(rkey, stable=True)
    right = (rkey[order], rt[order].contiguous(), rv[order])
    mism = cases = 0
    for cap in (3, 8, 33, 64, 128, 1024):
        for extra_eq, r_out in SORT_MERGE_JOINS:
            for out_cap in (1 << 22, 1000):
                args = (*right, lt, lv, 0, extra_eq, r_out, cap, out_cap)
                got = ops.sort_merge_compact(*args, impl="kernel")
                want = ops.sort_merge_compact(*args, impl="torch")
                cases += 1
                mism += sum(int((x != y).sum()) for x, y in zip(got, want))
                runs = []
                for impl in ("kernel", "torch"):
                    found = []
                    out = sort_merge_join(lt, lv, rt, rv, 0, 1, list(extra_eq),
                                          list(r_out), cap, out_cap, found,
                                          impl)
                    runs.append((out, [(int(o), n, c) for o, n, c in found]))
                mism += sum(int((x != y).sum())
                            for x, y in zip(runs[0][0], runs[1][0]))
                mism += int(runs[0][1] != runs[1][1])
    torch.cuda.synchronize()
    log(f"[kernels] sort_merge_compact: {cases} cases (probe caps 3..1024, "
        f"0-2 extra equalities, out_cap all or 1000), each also through "
        f"sort_merge_join, L={l} M={m} mismatches={mism}")
    return {"mismatches": mism, "max_abs_err": 0 if mism == 0 else None}


def fuzz_flash_attention(torch, ops, seed: int) -> dict:
    """float32 and bfloat16; head dims 16..128; (h, g) of (4, 4), (8, 2),
    (32, 4), and at e 64 and 128 the LM families' (32, 8), (48, 8), (56, 8)
    and (32, 32) (GQA ratios 4, 6, 7 and 1); causal with sq == skv, causal
    with sq < skv (end-aligned),
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
            for h, kvh in ((4, 4), (8, 2), (32, 4)) + (
                    FAMILY_HEADS if e in (64, 128) else ()):
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
        f"(h,g) (4,4)/(8,2)/(32,4), at e 64/128 also "
        f"{'/'.join(f'({h},{g})' for h, g in FAMILY_HEADS)}, 3 masks, "
        f"ragged lengths), by kernel "
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


def all_call_args(ops, name: str, run, most: int | None = None) -> list:
    """The arguments of every call (the first `most`, where given) of the
    wrapper `ops.<name>` during `run()`, in order, by name: the wrapper is
    swapped for one that records its arguments and calls through, then
    restored (the shards of a mesh call it from threads of their own)."""
    orig = getattr(ops, name)
    sig = inspect.signature(orig)
    seen = []

    def record(*a, **kw):
        if most is None or len(seen) < most:
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
        raise RuntimeError(f"the run never called ops.{name}")
    return seen


def first_call_args(ops, name: str, run) -> dict:
    """The arguments the main path gives the wrapper `ops.<name>` on its
    first call during `run()`, by name (`all_call_args`)."""
    return all_call_args(ops, name, run)[0]


def run_main_path(torch, args, failures: list) -> dict:
    from repro_torch.core import (Caps, ExecConfig, build_store, compile_plan,
                                  execute_local, mapsin, rows_set)
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

    # the main path: every count to 0 just before, read just after; the
    # local steps never call multiway_merge (the distributed steps' tail)
    per_query = {}
    merges = []
    orig_merge = mapsin.multiway_merge

    def counted_merge(*a, **kw):
        merges.append(1)
        return orig_merge(*a, **kw)

    mapsin.multiway_merge = counted_merge
    ops.reset_launches()
    try:
        for name, plan in plans.items():
            before = dict(ops.launches)
            bk = execute_local(store, plan, cfg=kern)
            torch.cuda.synchronize()
            launches = {k: ops.launches[k] - before[k] for k in before}
            per_query[name] = dict(
                plan=plan, bk=bk, launches=launches,
                ms=wall_ms(torch, lambda: execute_local(store, plan,
                                                        cfg=kern)))
    finally:
        mapsin.multiway_merge = orig_merge
    main_launches = dict(ops.launches)
    log(f"[main] kernel launches over the main path: {main_launches}; "
        f"multiway_merge calls: {len(merges)}")
    for k in ("searchsorted", "probe_compact", "multiway_compact"):
        if main_launches[k] <= 0:
            failures.append(f"main path never launched the {k} kernel")
    if main_launches["probe_gather"]:
        failures.append("main path launched probe_gather: mapsin_step's GET "
                        "is probe_compact's")
    if merges:
        failures.append("main path called multiway_merge: multiway_step's "
                        "patterns are multiway_compact's")

    ops.reset_launches()
    for name, rec in per_query.items():
        plan = rec["plan"]
        rec["bt"] = execute_local(store, plan, cfg=plain)
        rec["ms_torch"] = wall_ms(
            torch, lambda: execute_local(store, plan, cfg=plain))
    torch.cuda.synchronize()
    if any(ops.launches.values()):
        failures.append(f"impl='torch' launched kernels: {ops.launches}")

    # the paper's comparison: every join step on the reduce-side operator,
    # one sort_merge_compact launch a pattern, equal to impl="torch"
    for name, rec in per_query.items():
        rplan = rplans[name]
        run = lambda: execute_local(store, rplan, "reduce", cfg=kern)
        before = ops.launches["sort_merge_compact"]
        rk = run()
        torch.cuda.synchronize()
        n = ops.launches["sort_merge_compact"] - before
        want = sum(len(st.patterns) for st in rplan.steps
                   if st.kind == "reduce_side")
        if n != want:
            failures.append(f"{name} reduce: {n} sort_merge_compact "
                            f"launches, {want} reduce-side patterns")
        rt = execute_local(store, rplan, "reduce", cfg=plain)
        if not (torch.equal(rk.table, rt.table)
                and torch.equal(rk.valid, rt.valid)
                and torch.equal(rk.overflow, rt.overflow)):
            failures.append(f"{name} reduce: impl='kernel' and impl='torch' "
                            f"differ")
        rec["ovf_reduce"] = int(rk.overflow)
        rec["ms_reduce"] = wall_ms(torch, run)

    log(f"{'query':6s} {'steps':34s} {'rows':>7s} {'kernel_ms':>10s} "
        f"{'torch_ms':>10s} {'reduce_ms':>10s} {'ss':>3s} {'pc':>3s} "
        f"{'mc':>3s}  identical")
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
            f"{rec['launches']['probe_compact']:3d} "
            f"{rec['launches']['multiway_compact']:3d}  {same}{note}")
    for name in ("Q1", "Q4", "Q8"):
        if name in plans:
            profile_query(torch, lambda p=plans[name]: execute_local(
                store, p, cfg=kern), name)
    return dict(store=store, d=d, triples=triples, plans=plans,
                launches=main_launches, per_query=per_query)


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


def check_probe_gather(torch, ops, x: dict) -> dict:
    """probe_gather's kernel against its plain version at one call's
    recorded arguments `x` (`all_call_args`), both timed, beside the bound
    of the bytes this input needs."""
    keys, lo, hi, flt, cap = x["keys"], x["lo"], x["hi"], x["flt"], x["cap"]
    msk, eq = x["flt_mask"], x["eq_positions"]
    args = (keys, lo, hi, flt, cap, msk, eq)
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
    needed = (b * 16 + live * 2 * depth * 8 + nonempty * sum(msk) * 8
              + in_range * 8 + b * 4)
    nbytes = needed + b * cap * 9
    return dict(max_abs_err=err, mismatches=mism, ms=t_k, plain_ms=t_p,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, b=b, live=live,
                in_range=in_range, needed=needed,
                shape=f"M={keys.numel()} B={b} cap={cap} flt_mask={msk} "
                      f"live_probes={live} nonempty_probes={nonempty} "
                      f"in_range_keys={in_range}")


def time_kernels(torch, main: dict, fuzz: dict, floor) -> list:
    """Each kernel at the inputs the main path gives it, recorded from one
    execute_local run: the first rank-find of the first query with a
    multiway step (beside the streaming floor), the first mapsin step of
    the first query with one: probe_compact, and probe_gather at the same
    GET, and multiway_compact over every pattern of the first multiway
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

    name, x = args_of("probe_compact", "mapsin")
    keys, lo, hi, flt, cap = x["keys"], x["lo"], x["hi"], x["flt"], x["cap"]
    msk, eq, table = x["flt_mask"], x["eq_positions"], x["table"]
    g = check_probe_gather(torch, ops, x)
    b, live, in_range, needed = g["b"], g["live"], g["in_range"], g["needed"]
    out.append(dict(name="probe_gather", **KERNELS["probe_gather"],
                    launches=main["launches"]["probe_gather"],
                    max_abs_err=g["max_abs_err"],
                    mismatches=fz["probe_gather"]["mismatches"]
                    + g["mismatches"], ms=g["ms"], plain_ms=g["plain_ms"],
                    bound_ms=g["bound_ms"], bound_by="bytes",
                    library_ms=None,
                    shape=f"{name}, first mapsin GET: {g['shape']}"))

    # probe_compact at the same step: the GET and the merge in one
    out_cap, new_pos = x["out_cap"], tuple(x["new_pos"])
    cargs = (keys, lo, hi, flt, table, cap, out_cap, msk, eq, new_pos)
    got = ops.probe_compact(*cargs, "kernel")
    want = ops.probe_compact(*cargs, "torch")
    err = int((got[0] - want[0]).abs().max())
    mism = sum(int((a != b).sum()) for a, b in zip(got, want))
    t_k = cuda_ms(torch, lambda: ops.probe_compact(*cargs, "kernel"))
    t_p = cuda_ms(torch, lambda: ops.probe_compact(*cargs, "torch"), iters=3)
    total = int(got[3]) + out_cap
    kept = min(total, out_cap)
    w = table.shape[1] + len(new_pos)
    # the same inputs as probe_gather's (less its outputs), the bindings of
    # the kept rows read once, the step's table and flags written once
    nbytes = needed + kept * table.shape[1] * 4 + out_cap * (w * 4 + 1)
    out.append(dict(name="probe_compact", **KERNELS["probe_compact"],
                    launches=main["launches"]["probe_compact"],
                    max_abs_err=err, mismatches=fz["probe_compact"]["mismatches"]
                    + mism, ms=t_k, plain_ms=t_p,
                    bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                    library_ms=None,
                    shape=f"{name}, first mapsin step: M={keys.numel()} B={b} "
                          f"cap={cap} out_cap={out_cap} nv={table.shape[1]} "
                          f"new={new_pos} live_probes={live} "
                          f"in_range_keys={in_range} matches={total}"))

    # multiway_compact over the patterns of the first multiway step
    name = next(n for n, p in plans.items()
                if any(st.kind == "multiway" for st in p.steps))
    calls = all_call_args(ops, "multiway_compact", lambda: execute_local(
        store, plans[name], cfg=kern))
    n_pat = len(next(st for st in plans[name].steps
                     if st.kind == "multiway").patterns)
    calls = [{k: v for k, v in x.items() if k != "impl"}
             for x in calls[:n_pat]]
    step = lambda impl: [ops.multiway_compact(**x, impl=impl) for x in calls]
    err = mism = 0
    for got, want in zip(step("kernel"), step("torch")):
        err = max(err, int((got[0] - want[0]).abs().max()))
        mism += sum(int((a != b).sum()) for a, b in zip(got, want))
    t_k = cuda_ms(torch, lambda: step("kernel"))
    t_p = cuda_ms(torch, lambda: step("torch"), iters=3)
    nbytes = found = 0
    for x, got in zip(calls, step("kernel")):
        valid, origin = x["valid"], x["origin"].long()
        live = origin[valid]
        n_in = (x["end"][live] - x["start"][live]).clamp(
            min=0, max=x["row_cap"])
        n_flt = (sum(x["flt_mask"]) + sum(x["extra_mask"])) * int(
            (n_in > 0).sum())
        kept = int(got[1].sum())
        found += int(got[3]) + x["out_cap"]
        w = got[0].shape[1]
        # each row's flag, each valid row's origin, ranks and filter values,
        # the in-range keys of its range, the kept rows' columns read once;
        # the pattern's table, flags and origins written once
        nbytes += (valid.numel() + live.numel() * (4 + 16) + n_flt * 8
                   + int(n_in.sum()) * 8 + kept * x["table"].shape[1] * 4
                   + x["out_cap"] * (w * 4 + 1 + 4))
    out.append(dict(name="multiway_compact", **KERNELS["multiway_compact"],
                    launches=main["launches"]["multiway_compact"],
                    max_abs_err=err,
                    mismatches=fz["multiway_compact"]["mismatches"] + mism,
                    ms=t_k, plain_ms=t_p,
                    bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                    library_ms=None,
                    shape=f"{name}, first multiway step, {n_pat} patterns: "
                          f"M={calls[0]['keys'].numel()} "
                          f"B={calls[0]['start'].numel()} "
                          f"row_cap={calls[0]['row_cap']} "
                          f"out_cap={calls[0]['out_cap']} "
                          f"valid_rows={[int(x['valid'].sum()) for x in calls]} "
                          f"rows_found={found}"))
    for k in out[1:]:                  # searchsorted's: time_searchsorted
        log(f"[timing] {k['name']}: {k['shape']}: ms={k['ms']:.6f} "
            f"plain_ms={k['plain_ms']:.6f} bound_ms={k['bound_ms']:.6f} "
            f"library_ms={k['library_ms']}")
    return out


# the benchmark cell whose Q8 joins `?x memberOf ?y` reduce-side: its
# configuration (data) and traffic mix (caps), read from portbench/
REDUCE_CELL = ("lubm63", "adhoc", "Q8")


def check_reduce_side(torch, args, fuzz: dict, failures: list) -> dict:
    """Q8 of the benchmark cell `lubm63.adhoc` on the card: the cell's own
    data (portbench's LUBM generator at its configuration, links from the
    seed) and caps, under which the planner joins `?x memberOf ?y`
    reduce-side (probe_cap 1024, out_cap 2^20). Its run must launch
    sort_merge_compact once, and equal impl="torch" bit for bit with no
    overflow; both runs' wall ms and peak memory; then the op against its
    plain version at the inputs that run gives it, both timed, beside the
    bytes those inputs need. Returns the op's kernel record."""
    from portbench.gen import lubm as lubm_gen
    from repro_torch.core import (Caps, ExecConfig, build_store, compile_plan,
                                  execute_local)
    from repro_torch.core.rdf import Dictionary
    from repro_torch.kernels import ops
    from repro_torch.serve import parse_bgp

    config_name, traffic, query = REDUCE_CELL
    root = Path(__file__).resolve().parent / "portbench"
    config = json.loads((root / "configs" / f"{config_name}.json").read_text())
    mix = json.loads((root / "traffic" / f"{traffic}.json").read_text())
    t0 = time.perf_counter()
    graph = lubm_gen.generate(config, args.seed)
    d = Dictionary()
    for i, term in enumerate(graph.terms):
        d.replay_term(i, term)
    store = build_store(graph.triples, device="cuda")
    torch.cuda.synchronize()
    cell = f"{config_name}.{traffic} {query}"
    log(f"[reduce] {config_name} (portbench's generator, seed {args.seed}): "
        f"{len(graph.triples):,} triples, {len(graph.terms):,} terms, on "
        f"the card in {time.perf_counter() - t0:.1f} s")
    plan = compile_plan(store, list(parse_bgp(
        config["adhoc_queries"][query], d).patterns), Caps(**mix["caps"]))
    steps = [(st.kind, len(st.patterns), st.caps.probe_cap, st.caps.out_cap)
             for st in plan.steps]
    n_red = sum(n for kind, n, _, _ in steps if kind == "reduce_side")
    if n_red != 1:
        failures.append(f"{cell}: {n_red} reduce-side patterns in its plan "
                        f"{steps}, want 1")
    kern, plain = ExecConfig(impl="kernel"), ExecConfig(impl="torch")
    runs = {}
    for cfg in (kern, plain):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        before = ops.launches["sort_merge_compact"]
        out = execute_local(store, plan, cfg=cfg)
        torch.cuda.synchronize()
        runs[cfg.impl] = dict(
            out=out, peak=torch.cuda.max_memory_allocated() - resident,
            launches=ops.launches["sort_merge_compact"] - before,
            ms=wall_ms(torch, lambda c=cfg: execute_local(store, plan, cfg=c)))
    bk, bt = runs["kernel"]["out"], runs["torch"]["out"]
    same = (bk.vars == bt.vars and torch.equal(bk.table, bt.table)
            and torch.equal(bk.valid, bt.valid)
            and torch.equal(bk.overflow, bt.overflow)
            and torch.equal(bk.step_overflow, bt.step_overflow))
    if not same:
        failures.append(f"{cell}: impl='kernel' and impl='torch' differ")
    if int(bk.overflow):
        failures.append(f"{cell}: overflow {int(bk.overflow)}")
    if (runs["kernel"]["launches"], runs["torch"]["launches"]) != (n_red, 0):
        failures.append(f"{cell}: sort_merge_compact launched "
                        f"{runs['kernel']['launches']} times by the kernel "
                        f"run and {runs['torch']['launches']} by the plain "
                        f"one, want {n_red} and 0")
    log(f"[reduce] {cell}: steps (kind, patterns, probe_cap, out_cap) "
        f"{steps}; {int(bk.valid.sum())} rows, overflow "
        f"{int(bk.overflow)}, kernel==torch {same}; wall ms kernel "
        f"{runs['kernel']['ms']:.3f}, torch {runs['torch']['ms']:.3f}; peak "
        f"bytes above the resident ones kernel {runs['kernel']['peak']}, torch "
        f"{runs['torch']['peak']}; sort_merge_compact launches a run "
        f"{runs['kernel']['launches']} / {runs['torch']['launches']}")

    profile_query(torch, lambda: execute_local(store, plan, cfg=kern), cell)
    x = first_call_args(ops, "sort_merge_compact",
                        lambda: execute_local(store, plan, cfg=kern))
    x = {k: v for k, v in x.items() if k != "impl"}
    got = ops.sort_merge_compact(**x, impl="kernel")
    want = ops.sort_merge_compact(**x, impl="torch")
    err = int((got[0] - want[0]).abs().max())
    mism = sum(int((a != b).sum()) for a, b in zip(got, want))
    t_k = cuda_ms(torch, lambda: ops.sort_merge_compact(**x, impl="kernel"))
    t_p = cuda_ms(torch, lambda: ops.sort_merge_compact(**x, impl="torch"),
                  iters=3)
    rks, lt, lv = x["rks"], x["lt"], x["lv"]
    cap, out_cap = x["probe_cap"], x["out_cap"]
    n_eq, n_out = len(x["extra_eq"]), len(x["r_out_cols"])
    m, (l, nvl) = rks.numel(), lt.shape
    key = lt[:, x["lkey_col"]][lv].contiguous()
    n_in = (torch.searchsorted(rks, key, right=True)
            - torch.searchsorted(rks, key)).clamp(max=cap)
    live, windows = int((n_in > 0).sum()), int(n_in.sum())
    total = int(got[3]) + out_cap
    kept = min(total, out_cap)
    w = nvl + n_out
    # what this input needs: each left row's flag, each valid row's key and
    # both searches, the live rows' columns and the flags and compared
    # columns of their windows' rows, the kept matches' right columns, and
    # the step's table and flags written once
    depth = max(m, 1).bit_length()
    nbytes = (l + key.numel() * (4 + 2 * depth * 4) + live * nvl * 4
              + windows * (1 + 4 * n_eq) + kept * n_out * 4
              + out_cap * (w * 4 + 1))
    fz = fuzz.get("sort_merge_compact", {"mismatches": 0})
    rec = dict(name="sort_merge_compact", **KERNELS["sort_merge_compact"],
               launches=runs["kernel"]["launches"], max_abs_err=err,
               mismatches=fz["mismatches"] + mism, ms=t_k, plain_ms=t_p,
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
               library_ms=None, q8_kernel_ms=runs["kernel"]["ms"],
               q8_torch_ms=runs["torch"]["ms"],
               q8_peak_bytes=runs["kernel"]["peak"],
               q8_torch_peak_bytes=runs["torch"]["peak"],
               shape=f"{cell}, reduce-side step: M={m} L={l} nvl={nvl} "
                     f"probe_cap={cap} out_cap={out_cap} extra_eq={n_eq} "
                     f"r_out={n_out} valid_left={key.numel()} "
                     f"live_left={live} window_rows={windows} "
                     f"matches={total}")
    log(f"[timing] sort_merge_compact: {rec['shape']}: ms={t_k:.6f} "
        f"plain_ms={t_p:.6f} bound_ms={rec['bound_ms']:.6f} "
        f"mismatches={mism}")
    del store
    torch.cuda.empty_cache()
    return rec


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
                for k in ("searchsorted", "probe_compact",
                          "multiway_compact"))))
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
    for k in ("searchsorted", "probe_compact"):
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
               ops.launches["probe_compact"] - before["probe_compact"],
               ops.launches["multiway_compact"] - before["multiway_compact"])
        counts = set().union(*seen.values())
        lines.append(f"{t}:t{tid} {'+'.join(st.kind for st in template.steps)}"
                     f" batches {sorted(seen)} -> {sorted(counts)} "
                     f"(execute_local + seed: {one})")
        if counts != {one}:
            failures.append(f"serve: {t} template t{tid}: launches per "
                            f"dispatch {sorted(counts)} at batches "
                            f"{sorted(seen)}, one query launches {one}")
    log("[serve] launches (searchsorted, probe_compact, multiway_compact) per "
        "dispatch by template: " + "; ".join(lines))

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
# phase 6: the durable mutable store, ingesting while it serves
# ---------------------------------------------------------------------------

# the JAX package's loading bench (benchmarks/bench_loading.py): its
# ingest-while-serving parameters and caps, and its SIGKILL canary
INGEST_CAPS = dict(scan_cap=1 << 15, out_cap=1 << 15, probe_cap=64,
                   row_cap=64)
INGEST_WAVES, INGEST_PRELOAD, INGEST_OVERLAY_LIMIT = 4, 0.5, 1 << 16
INGEST_QUERIES, INGEST_PER_WAVE, INGEST_MAX_BATCH = ("Q1", "Q4"), 24, 8
CANARY_SHARDS, CANARY_OVERLAY_LIMIT, CANARY_ACKS = 2, 256, 6
CANARY_MAX_BATCHES, CANARY_TIMEOUT_S = 5000, 180
STORE_ARRAYS = ("keys_spo", "keys_ops", "splits_spo", "splits_ops",
                "counts_spo", "counts_ops")


def numpy_merge(bk, ov, num_shards: int) -> dict:
    """One index's views the way the JAX package builds them on the host
    (repro/store/mutable.py `_merge_index` and its `flat_keys`): the base
    cut by `_shard_sorted` (twice: once more for the overlay's depth),
    each row sorted from base shard + routed overlay, the flat view
    sorted from base + overlay."""
    import numpy as np

    from repro_torch.core.planner import quantize_cap
    from repro_torch.core.rdf import INF_KEY
    from repro_torch.core.triple_store import _shard_sorted
    s = num_shards
    base_pad, base_splits, _ = _shard_sorted(bk, s)
    cap = base_pad.shape[1]
    assign = (np.searchsorted(_shard_sorted(bk, s)[1][1:s], ov, side="left")
              if len(ov) else np.zeros(0, np.int64))
    depth = int(np.bincount(assign, minlength=s).max()) if len(ov) else 0
    width = cap + quantize_cap(max(depth, 1))
    rows = np.full((s, width), INF_KEY, np.int64)
    counts = np.zeros(s, np.int64)
    splits = np.empty(s + 1, np.int64)
    splits[0] = -1
    for k in range(s):
        m = np.sort(np.concatenate([bk[k * cap:min((k + 1) * cap, len(bk))],
                                    ov[assign == k]]))
        rows[k, :len(m)] = m
        counts[k] = len(m)
        splits[k + 1] = m[-1] if len(m) else splits[k]
    splits[s] = INF_KEY
    flat = np.full(rows.size, INF_KEY, np.int64)
    merged = np.concatenate([bk, ov])
    merged.sort()
    flat[:len(merged)] = merged
    return dict(keys=rows, splits=splits, counts=counts, flat=flat)


def watch_refreshes(torch, st, ops, log_to: list) -> None:
    """Time every refresh of the store's device views (both indexes, CUDA
    events around the store's own `_merged_arrays`) and count its
    searchsorted launches; keep its inputs and outputs in `log_to` for
    `check_refreshes`, outside the timed window."""
    orig = st._merged_arrays

    def timed():
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        before = ops.launches["searchsorted"]
        a.record()
        out = orig()
        b.record()
        torch.cuda.synchronize()
        log_to.append(dict(
            ms=a.elapsed_time(b),
            launches=ops.launches["searchsorted"] - before,
            base=(st._bk_spo, st._bk_ops), ovl=(st._ov_spo, st._ov_ops),
            base_dev=st._bk_dev, views=out, flat=st._flat))
        return out
    st._merged_arrays = timed


def check_refreshes(torch, refreshes: list, num_shards: int) -> list:
    """Each recorded refresh against `numpy_merge` on the same host
    arrays: bit-identical rows, splits, counts and flat views. Adds the
    numpy merge's host ms and its ms with the upload of the four views
    to the card (what the JAX package's refresh does), and drops the
    tensors."""
    import numpy as np
    out = []
    for r in refreshes:
        t0 = time.perf_counter()
        ref = [numpy_merge(bk, ov, num_shards)
               for bk, ov in zip(r["base"], r["ovl"])]
        np_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        for x in ref:
            for v in x.values():
                torch.from_numpy(v).to("cuda")
        torch.cuda.synchronize()
        up_ms = (time.perf_counter() - t0) * 1e3
        equal = True
        for i, (name, x) in enumerate(zip(("spo", "ops"), ref)):
            for field in ("keys", "splits", "counts"):
                got = r["views"][f"{field}_{name}"].cpu().numpy()
                equal &= bool(np.array_equal(got, x[field]))
            equal &= bool(np.array_equal(r["flat"][i].cpu().numpy(),
                                         x["flat"]))
        out.append(dict(ms=r["ms"], numpy_ms=np_ms,
                        numpy_upload_ms=np_ms + up_ms,
                        launches=r["launches"], equal=equal,
                        base=len(r["base"][0]), ovl=len(r["ovl"][0]),
                        inputs=(r["base"][0], r["base_dev"][0],
                                r["ovl"][0])))
    refreshes.clear()
    return out


def rows_canon(torch, bnd, vars_) -> set:
    """The row set of `bnd` with its columns in the order `vars_`."""
    from repro_torch.core import rows_set
    got = rows_set(bnd.table, bnd.valid, len(bnd.vars))
    if tuple(bnd.vars) != tuple(vars_):
        perm = [list(bnd.vars).index(v) for v in vars_]
        got = set(tuple(r[i] for i in perm) for r in got)
    return got


def canary_batch(rng):
    """One batch of the canary's deterministic stream (bench_loading.py
    `_crash_child`)."""
    import numpy as np
    return np.stack([rng.randint(0, 64, 32), rng.randint(0, 8, 32),
                     rng.randint(0, 64, 32)], 1).astype(np.int32)


def crash_child(store_dir: str, seed: int) -> int:
    """The canary's child: the port's store on the card ingests the
    deterministic stream and prints `acked <i>` after each fsync, until
    the parent kills it (or the stream's bound ends)."""
    import numpy as np

    from repro_torch.store import MutableTripleStore
    st = MutableTripleStore.create(store_dir, num_shards=CANARY_SHARDS,
                                   overlay_limit=CANARY_OVERLAY_LIMIT,
                                   device="cuda")
    rng = np.random.RandomState(seed)
    for i in range(CANARY_MAX_BATCHES):
        st.ingest(canary_batch(rng))
        print(f"acked {i}", flush=True)
    st.close()
    return 0


def recovered_prefix(torch, st, batches_of, most: int):
    """The number of batches of a deterministic stream whose union is
    the recovered store's content (None if no prefix up to `most` is),
    after checking that the store's device flat views hold that content."""
    import numpy as np

    from repro_torch.core.rdf import INF_KEY, pack3
    got = np.sort(np.concatenate([st._bk_spo, st._ov_spo]))
    for index, host in ((0, got),
                        (1, np.sort(np.concatenate([st._bk_ops,
                                                    st._ov_ops])))):
        flat = st.flat_keys(index).cpu().numpy()
        if not (np.array_equal(flat[:len(host)], host)
                and bool((flat[len(host):] == INF_KEY).all())):
            raise AssertionError(f"the device flat view {index} is not "
                                 f"the recovered content")
    keys = np.zeros(0, np.int64)
    for i in range(most + 1):
        if np.array_equal(got, keys):
            return i
        b = batches_of(i)
        keys = np.union1d(keys, pack3(b[:, 0], b[:, 1], b[:, 2]))
    return None


def run_crash_canary(torch, args, root: Path, failures: list) -> None:
    """bench_loading.py's SIGKILL canary with the port on the card, then
    one in-process DurabilityFaultPlan.sample(seed) crash: each recovered
    store holds a prefix of its batch stream with every acked batch."""
    import signal
    import threading

    import numpy as np

    from repro_torch.obs import MetricsRegistry
    from repro_torch.serve import DurabilityFaultPlan, SimulatedCrash
    from repro_torch.store import MutableTripleStore

    store_dir = root / "canary"
    child = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--crash-child",
         str(store_dir), str(args.seed)], stdout=subprocess.PIPE, text=True,
        cwd=str(Path(__file__).resolve().parent))
    watchdog = threading.Timer(CANARY_TIMEOUT_S, child.kill)
    watchdog.start()
    acked = 0
    try:
        for line in child.stdout:
            if line.startswith("acked "):
                acked = int(line.split()[1]) + 1
            if acked >= CANARY_ACKS:
                break
        child.send_signal(signal.SIGKILL)        # mid-stream, no cleanup
        child.wait()
    finally:
        watchdog.cancel()
        if child.poll() is None:
            child.kill()
            child.wait()
        child.stdout.close()
    if acked < CANARY_ACKS:
        failures.append(f"ingest canary: the child acked {acked} batches "
                        f"before it ended (rc {child.returncode})")
        return
    reg = MetricsRegistry()
    st = MutableTripleStore.open(str(store_dir),
                                 overlay_limit=CANARY_OVERLAY_LIMIT,
                                 metrics=reg, device="cuda")
    rec_ms = reg.gauge("store_recovery_seconds").value * 1e3
    rng = np.random.RandomState(args.seed)
    stream = []

    def batches_of(i):
        while len(stream) <= i:
            stream.append(canary_batch(rng))
        return stream[i]
    prefix = recovered_prefix(torch, st, batches_of, acked + 64)
    ok = prefix is not None and prefix >= acked
    log(f"[ingest] canary: child killed (SIGKILL) after {acked} acks; "
        f"recovered {st.n_triples} triples = the first {prefix} batches of "
        f"the stream; recovery {rec_ms:.3f} ms; prefix holds every ack: {ok}")
    st.close()
    if not ok:
        failures.append(f"ingest canary: acked {acked} batches, recovered "
                        f"prefix {prefix}")

    plan = DurabilityFaultPlan.sample(args.seed, horizon=8)
    fdir = str(root / "fault")
    st = MutableTripleStore.create(fdir, num_shards=CANARY_SHARDS,
                                   overlay_limit=32, fault_plan=plan,
                                   device="cuda")
    frng = np.random.RandomState(args.seed + 1)
    fstream = [canary_batch(frng) for _ in range(16)]
    n_acked, crash = 0, None
    try:
        for b in fstream:
            st.ingest(b)
            n_acked += 1
    except SimulatedCrash as e:
        crash = str(e)
    del st                                       # a dead process's heap
    reg = MetricsRegistry()
    st = MutableTripleStore.open(fdir, metrics=reg, device="cuda")
    prefix = recovered_prefix(torch, st, lambda i: fstream[i],
                              len(fstream) - 1)
    ok = crash is not None and prefix is not None and prefix >= n_acked
    log(f"[ingest] fault plan {plan.faults[0]}: {crash}; acked {n_acked} "
        f"batches, recovered the first {prefix}; recovery "
        f"{reg.gauge('store_recovery_seconds').value * 1e3:.3f} ms; prefix "
        f"holds every ack: {ok}")
    st.close()
    if not ok:
        failures.append(f"ingest fault plan: crash {crash!r}, acked "
                        f"{n_acked}, recovered prefix {prefix}")


def run_ingest(torch, args, lubm: dict, floor, failures: list) -> dict:
    """The loading bench's ingest-while-serving on the card at the main
    path's scale: half the main path's triples preloaded and flushed, the
    rest in waves into a MutableTripleStore (one shard, overlay limit
    2^16) served by a ServeEngine (Q1, Q4, max_batch 8; a warm-up a wave
    outside the timed window, 24 timed queries a wave) beside the main
    path's store under an identical engine. Every refresh of the device
    views is timed and held against the numpy merge; then every LUBM
    query on both stores, the recovery and the crash canary. Returns the
    searchsorted launches and mismatches of the phase's path, and the
    kernel's times at the merge's shapes."""
    import cProfile
    import pstats

    import numpy as np

    from repro_torch.core import Caps, ExecConfig, execute_local
    from repro_torch.core.rdf import INF_KEY
    from repro_torch.data.rdf_gen import LUBM_SPARQL
    from repro_torch.kernels import ops
    from repro_torch.obs import MetricsRegistry
    from repro_torch.serve import ServeEngine, parse_bgp
    from repro_torch.store import MutableTripleStore
    from repro_torch.store.merge import base_layout, merge_index

    root = Path(__file__).resolve().parent / "build" / "ingest"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    try:
        tr, d, base = lubm["triples"], lubm["d"], lubm["store"]
        n = len(tr)
        preload = int(n * INGEST_PRELOAD)
        chunk = max((n - preload) // INGEST_WAVES, 1)
        pats = {q: list(parse_bgp(LUBM_SPARQL[q], d).patterns)
                for q in INGEST_QUERIES}
        caps = Caps(**INGEST_CAPS)
        if any(int(execute_local(base, p, caps=caps).overflow)
               for p in pats.values()):
            failures.append(f"ingest: {'/'.join(INGEST_QUERIES)} overflow "
                            f"at the loading bench's caps")
        log(f"[ingest] lubm_like({args.universities}): {n:,} triples; "
            f"preload {preload:,}, {INGEST_WAVES} waves of {chunk:,}; "
            f"overlay_limit {INGEST_OVERLAY_LIMIT}; queries "
            f"{'/'.join(INGEST_QUERIES)} at the loading bench's caps "
            f"{caps}; store directory {root.relative_to(root.parents[1])} "
            f"(fsyncs on the host's disk)")

        torch.cuda.reset_peak_memory_stats()
        refreshes, flush_s = [], []
        st = MutableTripleStore.create(str(root / "store"), num_shards=1,
                                       overlay_limit=INGEST_OVERLAY_LIMIT,
                                       metrics=MetricsRegistry(),
                                       device="cuda")
        watch_refreshes(torch, st, ops, refreshes)
        orig_flush = st.flush

        def timed_flush():
            t0 = time.perf_counter()
            orig_flush()
            flush_s.append(time.perf_counter() - t0)
        st.flush = timed_flush

        # the main path: counts to 0 just before, read just after
        ops.reset_launches()
        t0 = time.perf_counter()
        st.ingest(tr[:preload])
        preload_s = time.perf_counter() - t0
        st.flush()
        peak = torch.cuda.max_memory_allocated()
        checked = check_refreshes(torch, refreshes, 1)
        torch.cuda.reset_peak_memory_stats()
        eng = ServeEngine(st, d, caps=caps, max_batch=INGEST_MAX_BATCH,
                          metrics=MetricsRegistry(), name="mutable")
        ingest_s, recompile_s, lat = 0.0, 0.0, []
        prof = cProfile.Profile()
        for w in range(INGEST_WAVES):
            lo = preload + w * chunk
            hi = min(lo + chunk, n) if w < INGEST_WAVES - 1 else n
            t0 = time.perf_counter()
            prof.enable()
            st.ingest(tr[lo:hi])
            prof.disable()
            ingest_s += time.perf_counter() - t0
            t0 = time.perf_counter()
            for p in pats.values():               # warm: this version
                eng.execute([p])
            recompile_s += time.perf_counter() - t0
            for i in range(INGEST_PER_WAVE):
                p = pats[INGEST_QUERIES[i % len(INGEST_QUERIES)]]
                t0 = time.perf_counter()
                eng.execute([p])
                lat.append(time.perf_counter() - t0)
            # the peak of the store's own work (the main path's store and
            # this wave's recorded views included), not of the check's
            peak = max(peak, torch.cuda.max_memory_allocated())
            checked += check_refreshes(torch, refreshes, 1)
            torch.cuda.reset_peak_memory_stats()
        ingest_launches = ops.launches["searchsorted"]
        if not (st.n_triples > 0 and st.overlay_depth > 0):
            failures.append("ingest: the timed waves did not serve from a "
                            "populated overlay")

        for i, r in enumerate(checked):
            log(f"[ingest] refresh {i}: base {r['base']:,} + overlay "
                f"{r['ovl']:,} keys a view: device merge (both indexes) "
                f"{r['ms']:.3f} ms, searchsorted launches {r['launches']}; "
                f"numpy merge {r['numpy_ms']:.3f} ms, with the upload "
                f"{r['numpy_upload_ms']:.3f} ms; bit-identical {r['equal']}")
        bad = [i for i, r in enumerate(checked) if not r["equal"]]
        if bad:
            failures.append(f"ingest: device merges {bad} differ from the "
                            f"numpy merge")
        # two rank-finds an index where both sides hold keys, none where
        # one is empty (a copy)
        want = [4 if r["base"] and r["ovl"] else 0 for r in checked]
        if [r["launches"] for r in checked] != want or not any(want):
            failures.append(f"ingest: searchsorted launches per refresh "
                            f"{[r['launches'] for r in checked]}, expected "
                            f"{want}")
        ingested = n - preload
        mut_qps = len(lat) / sum(lat)
        p99_ms = float(np.percentile(np.array(lat) * 1e3, 99))

        beng = ServeEngine(base, d, caps=caps, max_batch=INGEST_MAX_BATCH,
                           metrics=MetricsRegistry(), name="immutable")
        for p in pats.values():
            beng.execute([p])
        blat = []
        for i in range(INGEST_PER_WAVE * INGEST_WAVES):
            p = pats[INGEST_QUERIES[i % len(INGEST_QUERIES)]]
            t0 = time.perf_counter()
            beng.execute([p])
            blat.append(time.perf_counter() - t0)
        imm_qps = len(blat) / sum(blat)
        log(f"[ingest] preload {preload / preload_s:,.0f} triples/s "
            f"({preload:,} in {preload_s:.3f} s); waves "
            f"{ingested / ingest_s:,.0f} triples/s ({ingested:,} in "
            f"{ingest_s:.3f} s); flushes {st.flush_count} ("
            + ", ".join(f"{s:.3f}" for s in flush_s) + " s); recompile "
            f"{recompile_s:.3f} s; overlay depth {st.overlay_depth:,}; "
            f"n_triples {st.n_triples:,}; searchsorted launches "
            f"{ingest_launches} over the path; peak memory {peak} bytes "
            f"({peak / 2 ** 30:.3f} GiB)")
        log(f"[ingest] serving: mutable {mut_qps:.1f} queries/s, p99 "
            f"{p99_ms:.3f} ms; immutable {imm_qps:.1f} queries/s, p99 "
            f"{float(np.percentile(np.array(blat) * 1e3, 99)):.3f} ms; "
            f"overlay_qps_ratio {mut_qps / imm_qps:.3f}")
        bk, base_dev, ovl = checked[-1]["inputs"]
        layout = base_layout(bk, 1)
        profile_query(torch, lambda: merge_index(base_dev, layout, ovl),
                      f"device merge of one index (base {len(bk):,} + "
                      f"overlay {len(ovl):,} keys)")
        stats = pstats.Stats(prof)
        top = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:8]
        log("[ingest] host time of the wave ingests by function (cProfile, "
            "own time): " + "; ".join(
                f"{Path(f).name}:{ln}({fn}) {tt:.3f} s x{nc}"
                for (f, ln, fn), (_, nc, tt, _ct, _) in top))

        # gates: the views, every LUBM query, the engine's rows
        same_flat = True
        for index in (0, 1):
            want = base.flat_keys(index)
            got = st.flat_keys(index)
            same_flat &= bool(torch.equal(got[:want.numel()], want)
                              and bool((got[want.numel():] == INF_KEY).all()))
        if not same_flat or st.n_triples != base.n_triples:
            failures.append("ingest: the mutable store's flat views differ "
                            "from the main path's")
        big = Caps(**CAPS_MAIN)
        differ = []
        for name, text in LUBM_SPARQL.items():
            q = list(parse_bgp(text, d).patterns)
            want = execute_local(base, q, cfg=ExecConfig(impl="kernel"),
                                 caps=big)
            wrows = rows_canon(torch, want, want.vars)
            for impl in ("kernel", "torch"):
                got = execute_local(st, q, cfg=ExecConfig(impl=impl),
                                    caps=big)
                if (rows_canon(torch, got, want.vars) != wrows
                        or int(got.overflow) != int(want.overflow)):
                    differ.append(f"{name}/{impl}")
        if differ:
            failures.append(f"ingest: queries on the mutable store differ "
                            f"from the main path's: {differ}")
        eng_ok = True
        for name, p in pats.items():
            res = eng.execute([p])[0]
            lm = rows_canon(torch, execute_local(st, p, caps=caps), res.vars)
            li = rows_canon(torch, execute_local(base, p, caps=caps),
                            res.vars)
            eng_ok &= res.rows_set() == lm == li
        if not eng_ok:
            failures.append("ingest: the engine's Q1/Q4 rows differ from "
                            "execute_local on the stores")
        log(f"[ingest] gates: flat views equal the main path's (real keys, "
            f"INF tail) {same_flat}; {len(LUBM_SPARQL)} LUBM queries x "
            f"(kernel, torch) equal to the main path's rows and overflow: "
            f"{not differ}; engine Q1/Q4 = execute_local on both stores: "
            f"{eng_ok}; device merges bit-identical {len(checked) - len(bad)}"
            f"/{len(checked)}")

        # recovery at scale
        before = {a: getattr(st, a) for a in STORE_ARRAYS}
        before_flat = st._flat
        st.close()
        reg = MetricsRegistry()
        st2 = MutableTripleStore.open(str(root / "store"),
                                      overlay_limit=INGEST_OVERLAY_LIMIT,
                                      metrics=reg, device="cuda")
        rec_s = reg.gauge("store_recovery_seconds").value
        rec_ok = (all(torch.equal(getattr(st2, a), v)
                      for a, v in before.items())
                  and all(torch.equal(a, b)
                          for a, b in zip(st2._flat, before_flat)))
        log(f"[ingest] recovery: store_recovery_seconds {rec_s:.6f} "
            f"({rec_s * 1e3:.3f} ms) for {st2.n_triples:,} triples (WAL "
            f"replays {st2.overlay_depth:,} overlay keys); index tensors "
            f"equal to before the close: {rec_ok}")
        if not rec_ok:
            failures.append("ingest: the reopened store's index tensors "
                            "differ from before the close")
        st2.close()
        del st, st2, eng, before, before_flat

        # the kernel at the merge's shapes: the last refresh's base into
        # its overlay and the overlay into the base
        ovl_dev = torch.from_numpy(ovl).to("cuda")
        timings, mism = {}, len(bad)
        for label, keys, q in (("base into overlay", ovl_dev, base_dev),
                               ("overlay into base", base_dev, ovl_dev)):
            got = ops.searchsorted(keys, q, "kernel")
            if not torch.equal(got, ops.searchsorted(keys, q, "torch")):
                mism += 1
                failures.append(f"ingest: searchsorted {label} differs "
                                f"from its plain version")
            timings[label] = time_searchsorted(
                torch, ops, floor, keys, q, f"merge, {label}")

        run_crash_canary(torch, args, root, failures)
        return dict(launches=ingest_launches, mismatches=mism,
                    merge_timings=timings)
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 7: the distributed path, eight region shards on the card
# ---------------------------------------------------------------------------

# the JAX package's distributed benches at their shard count
# (benchmarks/bench_distributed.py NUM_SHARDS, bench_serving.py
# SHARDED_SHARDS): eight region servers in one process, on one card
DIST_SHARDS = 8
DIST_RUNS = 5                  # timed runs of a (query, routing), median
# the sharded serving stream (bench_serving.py _sharded_mesh_main): its
# shapes, 160 requests drawn from 3 variants a shape, the serving caps,
# max_batch 16, routing a2a, escalation off
SHARDED_SHAPES = ("lubm_q1", "lubm_q3", "lubm_q5", "lubm_q13", "lubm_q4star")
SHARDED_REQUESTS, SHARDED_VARIANTS = 160, 3
# the sharded engine over a mutable store checks cache and layout handling
# across ingests, not scale: lubm_like(4) in 4 shuffled waves, overlay
# limit 2^11 a shard (flushes from the second wave on)
DIST_MUTABLE_SCALE, DIST_MUTABLE_WAVES = 4, 4
DIST_MUTABLE_LIMIT = 1 << 11
DIST_MUTABLE_QUERIES = ("Q1", "Q3", "Q4", "Q5", "Q13")
DIST_MUTABLE_CAPS = dict(out_cap=1 << 12, probe_cap=128, row_cap=64)


def dist_caps(caps_main: dict, stats: list, num_shards: int) -> tuple:
    """(mapsin caps, reduce caps, broadcast bytes) of one query for the
    sharded runs, from its instrumented run on the main path's store.

    out_cap holds the query's largest step output: a shard never holds
    more rows of a step than the whole query does. probe_cap and row_cap
    stay the main path's, so the planner picks the same operators (a2a's
    are then embedded from measurement). The broadcast step holds about
    S^2 x out_cap x cap x 8 bytes across the mesh (the all-gathered
    probes' gathered keys); that is the reckoning. The reduce side scans
    each relation whole on its shard (scan_cap holds the largest) and
    ships rows in buckets of 2R/S, at most 2^13 a destination, so that its
    sort-merge expansion (S x bucket_cap x probe_cap rows a shard) stays
    near 8.4 M rows a shard; a relation past that overflows, as the
    reference's does at its bench caps, and is reported."""
    from repro_torch.core import Caps
    from repro_torch.core.planner import quantize_cap
    out_cap = quantize_cap(max([st["n_out"] for st in stats] + [8]))
    caps = Caps(scan_cap=out_cap, out_cap=out_cap,
                probe_cap=caps_main["probe_cap"],
                row_cap=caps_main["row_cap"])
    joins = [st for st in stats if st["kind"] != "scan"]
    rel = max([st["relation"] for st in joins] + [8])
    rcaps = Caps(scan_cap=quantize_cap(rel), out_cap=out_cap,
                 probe_cap=caps_main["probe_cap"],
                 row_cap=caps_main["row_cap"],
                 bucket_cap=min(quantize_cap(-(-2 * rel // num_shards)),
                                1 << 13))
    cap = max([caps.row_cap if st["kind"] == "multiway" else caps.probe_cap
               for st in joins] + [0])
    return caps, rcaps, num_shards ** 2 * out_cap * cap * 8


def dist_payload_bytes(plan, routing: str, num_shards: int) -> int:
    """Static bytes one shard ships per execution through the probe
    collectives, from the plan's own step caps (bench_distributed.py's
    payload_bytes; the local block never crosses the network)."""
    from repro_torch.core.bgp import a2a_step_payload_bytes
    from repro_torch.core.distributed import auto_bucket_cap
    s, total = num_shards, 0
    for st in plan.steps:
        if st.kind == "scan":
            continue
        b = st.caps.out_cap
        cap = st.caps.row_cap if st.kind == "multiway" else st.caps.probe_cap
        if routing == "a2a":
            bc = st.caps.a2a_bucket_cap or auto_bucket_cap(b, s)
            total += a2a_step_payload_bytes(bc, cap, s)
        else:
            total += ((s - 1) * b * (8 + 8 + 24) + (s - 1) * s * b * 4
                      + (s - 1) * b * cap * 8)
    return total


def counted(torch, ops, tally: dict, run):
    """``run()`` alone with the launch counts: they are set to 0 just
    before it and read just after, and added to `tally`. Only runs of the
    distributed path (execute_sharded, the sharded engine) go through
    here; their checks, oracles, ingests and timed repeats run outside, so
    `tally` counts the path's launches and nothing else. Returns
    (run's result, its launches by kernel)."""
    ops.reset_launches()
    out = run()
    torch.cuda.synchronize()
    for k, v in ops.launches.items():
        tally[k] = tally.get(k, 0) + v
    return out, dict(ops.launches)


def run_distributed(torch, args, lubm: dict, floor, failures: list) -> dict:
    """The distributed path on the card: an 8-shard store of the main
    path's triples on a LocalMesh(8) (eight region servers, one card).
    (a) every LUBM query through execute_sharded, mapsin on both routings
    x impl "kernel" and "torch", and the reduce-side baseline, held
    against execute_local on the main path's store; (b) the sharded
    serving stream through ServeEngine(mesh=...) against the sequential
    execute_sharded loop; (c) the 1% fault rows and the drop + corrupt
    canary; (d) the sharded engine over a MutableTripleStore(8 shards)
    across ingests, against the oracle. Returns the searchsorted and
    probe_gather launches of the path's counted runs (`counted`), the
    mismatches of each kernel at the answer phase's recorded inputs and
    its times there: a2a answers through gather_range's searchsorted,
    broadcast through probe_gather."""
    from repro_torch.core import (Caps, ExecConfig, LocalMesh, build_store,
                                  compile_plan, execute_local,
                                  execute_sharded)
    from repro_torch.data.rdf_gen import LUBM_SPARQL
    from repro_torch.kernels import ops
    from repro_torch.serve import parse_bgp

    dev = "cuda"
    card = nvidia_smi_line()
    S = DIST_SHARDS
    tr, d, base = lubm["triples"], lubm["d"], lubm["store"]
    t0 = time.perf_counter()
    store = build_store(tr, num_shards=S, device=dev)
    mesh = LocalMesh(S, device=dev)
    torch.cuda.synchronize()
    log(f"[dist] lubm_like({args.universities}): {store.n_triples:,} "
        f"triples in {S} region shards of {store.shard_cap:,} keys an "
        f"index, LocalMesh({S}) on {mesh.device} (one thread a shard, one "
        f"stream); build_store {time.perf_counter() - t0:.1f} s ({card})")
    kern = ExecConfig(impl="kernel")
    mism = 0
    tally = {"a": {}, "b-c": {}, "d": {}}

    # (a) execute_sharded, query by query: each checked run counted alone
    t_a = time.perf_counter()
    per_query, answer_inputs = {}, {}
    for name, text in LUBM_SPARQL.items():
        pats = list(parse_bgp(text, d).patterns)
        stats: list = []
        wb = execute_local(base, compile_plan(base, pats, Caps(**CAPS_MAIN)),
                           cfg=kern, stats=stats)
        want = rows_canon(torch, wb, wb.vars)
        caps, rcaps, bcast_bytes = dist_caps(CAPS_MAIN, stats, S)
        torch.cuda.reset_peak_memory_stats()
        rec = dict(rows=len(want), caps=caps, rcaps=rcaps,
                   bcast_bytes=bcast_bytes)
        sets = {}
        for routing in ("a2a", "broadcast"):
            # timed first: its warm-up run plans (and, for a2a, measures
            # the embedded caps); the checked runs below find the plan
            cfg = ExecConfig(impl="kernel", routing=routing)
            rec[f"{routing}_ms"] = wall_ms(
                torch, lambda c=cfg: execute_sharded(store, pats, mesh,
                                                     "mapsin", c, caps=caps),
                runs=DIST_RUNS)
            outs = {}
            for impl in ("kernel", "torch"):
                cfg = ExecConfig(impl=impl, routing=routing)
                outs[impl], n = counted(
                    torch, ops, tally["a"],
                    lambda c=cfg: execute_sharded(store, pats, mesh,
                                                  "mapsin", c, caps=caps))
                rec[f"ss_{routing}_{impl}"] = n["searchsorted"]
                rec[f"pg_{routing}_{impl}"] = n["probe_gather"]
            t, v, o, vars_ = outs["kernel"]
            same = all(torch.equal(a, b) for a, b in
                       zip(outs["kernel"][:3], outs["torch"][:3]))
            ovf = int(o.sum())
            got = rows_canon(torch, _bnd(t, v, vars_), wb.vars)
            sets[routing] = got
            if not same:
                failures.append(f"dist: {name} {routing}: impl 'kernel' and "
                                f"'torch' differ")
            if ovf:
                failures.append(f"dist: {name} {routing}: overflow {ovf}")
            if got != want:
                failures.append(f"dist: {name} {routing}: {len(got)} rows, "
                                f"execute_local {len(want)}")
            rec[f"{routing}_same"] = same
            plan = compile_plan(store, pats, caps, routing=routing,
                                num_shards=S if routing == "a2a" else 0)
            rec[f"{routing}_payload"] = dist_payload_bytes(plan, routing, S)
        if sets["a2a"] != sets["broadcast"]:
            failures.append(f"dist: {name}: a2a and broadcast rows differ")
        rec["reduce_ms"] = wall_ms(torch, lambda: execute_sharded(
            store, pats, mesh, "reduce", kern, caps=rcaps), runs=1)
        (t, v, o, vars_), n = counted(
            torch, ops, tally["a"], lambda: execute_sharded(
                store, pats, mesh, "reduce", kern, caps=rcaps))
        rec["smc"] = n["sort_merge_compact"]
        rec["reduce_ovf"] = int(o.sum())
        if rec["reduce_ovf"] == 0 and rows_canon(
                torch, _bnd(t, v, vars_), wb.vars) != want:
            failures.append(f"dist: {name} reduce: rows differ from "
                            f"execute_local without overflow")
        rec["peak"] = torch.cuda.max_memory_allocated()
        rec["kinds"] = "+".join(st["kind"] for st in stats)
        per_query[name] = rec
        if any(st["kind"] != "scan" for st in stats):
            answer_inputs[name] = (pats, caps)
            if rec["ss_a2a_kernel"] <= 0:
                failures.append(f"dist: {name} a2a: execute_sharded never "
                                f"launched the searchsorted kernel")
            if rec["pg_broadcast_kernel"] <= 0:
                failures.append(f"dist: {name} broadcast: execute_sharded "
                                f"never launched the probe_gather kernel")
            if rec["smc"] <= 0 or rec["smc"] % S:
                failures.append(f"dist: {name} reduce: {rec['smc']} "
                                f"sort_merge_compact launches, not one a "
                                f"shard a reduce-side pattern")
    t_a = time.perf_counter() - t_a
    tag = f"({card})"
    log(f"[dist] (a) execute_sharded, {len(per_query)} queries: "
        f"{t_a:.1f} s; a2a/broadcast ms: median of {DIST_RUNS} after a "
        f"warm-up; reduce ms: one run after a warm-up; ss/pg: searchsorted "
        f"launches of one checked a2a kernel run, probe_gather launches of "
        f"one checked broadcast kernel run, each counted alone; smc: "
        f"sort_merge_compact launches of the checked reduce run {tag}")
    log(f"[dist] {'query':5s} {'steps':28s} {'rows':>6s} {'out_cap':>7s} "
        f"{'a2a_ms':>9s} {'bcast_ms':>9s} {'ratio':>6s} {'reduce_ms':>9s} "
        f"{'a2a_B':>9s} {'bcast_B':>11s} {'ss/pg':>9s} {'smc':>4s} "
        f"{'peak_GiB':>8s}")
    for name, r in per_query.items():
        note = (f" reduce overflow {r['reduce_ovf']} (caps scan "
                f"{r['rcaps'].scan_cap}, bucket {r['rcaps'].bucket_cap})"
                if r["reduce_ovf"] else "")
        log(f"[dist] {name:5s} {r['kinds']:28s} {r['rows']:6d} "
            f"{r['caps'].out_cap:7d} {r['a2a_ms']:9.3f} "
            f"{r['broadcast_ms']:9.3f} "
            f"{r['broadcast_ms'] / r['a2a_ms']:6.2f} {r['reduce_ms']:9.3f} "
            f"{r['a2a_payload']:9d} {r['broadcast_payload']:11d} "
            f"{r['ss_a2a_kernel']:4d}/{r['pg_broadcast_kernel']:<4d} "
            f"{r['smc']:4d} {r['peak'] / 2 ** 30:8.3f} kernel==torch "
            f"{r['a2a_same'] and r['broadcast_same']}; broadcast "
            f"reckoning {r['bcast_bytes'] / 2 ** 30:.3f} GiB{note} {tag}")
    log(f"[dist] execute_sharded: kernel launches of (a)'s checked runs "
        f"(mapsin: 2 routings x 2 impls; reduce: 1), each counted alone "
        f"{tally['a']} {tag}")

    # each kernel at the answer phase's own inputs, recorded from a real
    # run of the query with the widest join input: a2a's rank-find of the
    # shard that answers the most distinct probes, broadcast's fused GET of
    # the shard that answers the most live probes
    name = max(answer_inputs, key=lambda n: per_query[n]["caps"].out_cap)
    pats, caps = answer_inputs[name]
    run = lambda routing: lambda: execute_sharded(
        store, pats, mesh, "mapsin", ExecConfig(impl="kernel",
                                                routing=routing), caps=caps)
    timings = {}
    calls = all_call_args(ops, "searchsorted", run("a2a"))
    x = max(calls, key=lambda a: int(torch.unique(a["queries"]).numel()))
    keys, q = x["keys"].contiguous(), x["queries"].contiguous()
    got = ops.searchsorted(keys, q, "kernel")
    if not torch.equal(got, ops.searchsorted(keys, q, "torch")):
        mism += 1
        failures.append(f"dist: searchsorted at {name}'s a2a answer phase "
                        f"differs from its plain version")
    timings[f"{name} a2a answer phase"] = time_searchsorted(
        torch, ops, floor, keys, q, f"{name}, a2a answer phase of one shard")
    calls = all_call_args(ops, "probe_gather", run("broadcast"))
    x = max(calls, key=lambda a: int((a["lo"] < a["hi"]).sum()))
    g = check_probe_gather(torch, ops, x)
    if g["mismatches"]:
        failures.append(f"dist: probe_gather at {name}'s broadcast answer "
                        f"phase differs from its plain version in "
                        f"{g['mismatches']} entries")
    log(f"[timing] probe_gather {name}, broadcast answer phase of one "
        f"shard: {g['shape']}: ms={g['ms']:.6f} plain_ms={g['plain_ms']:.6f}"
        f" bound_ms={g['bound_ms']:.6f} ({100 * g['bound_ms'] / g['ms']:.1f}%"
        f" of the bound) {tag}")
    pg_timings = {f"{name} broadcast answer phase": g}

    # (b)-(d): the engine's runs counted alone, as in (a)
    count = lambda part, run: counted(torch, ops, tally[part], run)
    for part, run in (
            ("b-c", lambda: run_sharded_serving(
                torch, args, dict(store=store, mesh=mesh, base=base, d=d,
                                  card=card), count, failures)),
            ("d", lambda: run_sharded_mutable(torch, args, mesh, card,
                                              count, failures))):
        t0 = time.perf_counter()
        run()
        log(f"[dist] ({part}) {time.perf_counter() - t0:.1f} s; kernel "
            f"launches of its sharded-engine runs, each counted alone "
            f"{tally[part]} {tag}")
    total = sum(t.get("searchsorted", 0) for t in tally.values())
    pg = sum(t.get("probe_gather", 0) for t in tally.values())
    if any(t.get(k, 0) for t in tally.values()
           for k in ("probe_compact", "multiway_compact")):
        failures.append("dist: a counted run launched probe_compact or "
                        "multiway_compact, which the distributed path never "
                        "runs: the counts hold launches from outside the "
                        "path")
    if tally["b-c"].get("probe_gather", 0) or tally["d"].get(
            "probe_gather", 0):
        failures.append("dist: an a2a engine run launched probe_gather, "
                        "which only the broadcast routing runs")
    if total <= 0:
        failures.append("dist: the distributed path never launched the "
                        "searchsorted kernel")
    if pg <= 0:
        failures.append("dist: the broadcast routing never launched the "
                        "probe_gather kernel")
    return dict(launches=total, mismatches=mism, answer_timings=timings,
                pg_launches=pg, pg_mismatches=g["mismatches"],
                pg_answer_timings=pg_timings)


def _bnd(table, valid, vars_):
    """execute_sharded's (table, valid, vars) as a Bindings for rows_canon."""
    from repro_torch.core.mapsin import Bindings
    return Bindings(tuple(vars_), table, valid, None)


def run_sharded_serving(torch, args, x: dict, count, failures: list) -> None:
    """(b) the sharded serving stream through ServeEngine(mesh=...) and
    the per-query execute_sharded loop, every result against
    execute_local on the main path's store; (c) the 1% fault row and the
    drop + corrupt canary. Every checked engine run goes through
    ``count("b-c", run)`` (`counted`)."""
    import numpy as np

    from repro_torch.core import (Caps, ExecConfig, compile_plan,
                                  execute_local, execute_sharded)
    from repro_torch.core.bgp import a2a_step_payload_bytes
    from repro_torch.obs import MetricsRegistry
    from repro_torch.serve import Fault, FaultPlan, ServeEngine

    store, mesh, base, d, card = (x["store"], x["mesh"], x["base"], x["d"],
                                  x["card"])
    tag = f"({card})"
    S = DIST_SHARDS
    caps = Caps(**SERVE_CAPS)
    cfg = ExecConfig(impl="kernel", routing="a2a")
    rng = np.random.RandomState(args.seed)
    shapes = [s for s in serving_shapes("lubm", args.universities, rng)
              if s[0] in SHARDED_SHAPES]
    pools = {name: [[d.pattern(*t) for t in fn()]
                    for _ in range(SHARDED_VARIANTS)]
             for name, _, fn in shapes}
    names = [name for name, _, _ in shapes]
    reqs = [pools[names[rng.randint(len(names))]][
        rng.randint(SHARDED_VARIANTS)] for _ in range(SHARDED_REQUESTS)]
    n = len(reqs)

    def engine(**kw):
        return ServeEngine(store, d, cfg, caps=caps, mesh=mesh,
                           max_batch=SERVE_MAX_BATCH, max_queue=4 * n,
                           compile_cache_size=64, max_escalations=0,
                           metrics=MetricsRegistry(), **kw)

    local = {}

    def check(batch, results, label, allow_quarantine=False) -> tuple:
        """(exact, quarantined, overflow) over `results` against
        execute_local on the main path's store; a quarantined result
        (fault_unrecovered) must be marked and a subset."""
        ok = unrec = ovf = 0
        for pats, res in zip(batch, results):
            key = tuple(pats)
            if key not in local:
                bnd = execute_local(base, pats, "mapsin", cfg=cfg, caps=caps)
                local[key] = (rows_canon(torch, bnd, bnd.vars),
                              tuple(bnd.vars), int(bnd.overflow))
            want, vars_, lovf = local[key]
            got = res.rows_set(vars_)
            ovf += res.overflow
            if (res.stats or {}).get("fault_unrecovered"):
                unrec += 1
                if not (allow_quarantine and got <= want):
                    failures.append(f"dist: {label}: a quarantined result "
                                    f"holds rows outside execute_local's")
            elif got == want:
                ok += 1
            else:
                failures.append(f"dist: {label}: {len(got)} rows, "
                                f"execute_local {len(want)} (overflow "
                                f"{res.overflow}, local {lovf})")
        return ok, unrec, ovf

    eng = engine()
    # the plans first, outside the counted runs: a2a's embedded caps come
    # from an instrumented execute_local a distinct query (on the store,
    # so every engine below finds them)
    for p in {tuple(p): p for p in reqs}:
        eng._compile(p)
    t0 = time.perf_counter()
    results, n_launch = count("b-c", lambda: eng.execute(reqs))  # warm-up
    ss = n_launch["searchsorted"]
    warm_s = time.perf_counter() - t0
    ok, _, ovf = check(reqs, results, "sharded engine")
    if ss <= 0:
        failures.append("dist: the sharded engine's dispatches never "
                        "launched the searchsorted kernel")

    def run_seq(batch):
        for pats in batch:
            execute_sharded(store, pats, mesh, "mapsin", cfg, caps=caps)
        torch.cuda.synchronize()

    # warm the plans and closures: once a distinct query
    run_seq(list({tuple(p): p for p in reqs}.values()))
    d0, q0, p0 = eng.dispatches, eng.dispatched_queries, eng.a2a_payload_bytes
    t0 = time.perf_counter()
    eng.execute(reqs)
    torch.cuda.synchronize()
    sat_b = time.perf_counter() - t0
    dispatches = eng.dispatches - d0
    avg_batch = (eng.dispatched_queries - q0) / max(dispatches, 1)
    bytes_b = (eng.a2a_payload_bytes - p0) / n
    t0 = time.perf_counter()
    run_seq(reqs)
    sat_s = time.perf_counter() - t0

    def seq_bytes(pats) -> int:
        plan = compile_plan(store, pats, caps, routing="a2a", num_shards=S)
        return sum(a2a_step_payload_bytes(
            st.caps.a2a_bucket_cap,
            st.caps.row_cap if st.kind == "multiway" else st.caps.probe_cap,
            S) for st in plan.steps[1:] if st.kind in ("mapsin", "multiway"))
    bytes_s = float(np.mean([seq_bytes(p) for p in reqs]))
    log(f"[dist] sharded engine (bench_serving.py's sharded stream, "
        f"{'/'.join(SHARDED_SHAPES)}, {n} requests from "
        f"{len(local)} distinct, caps {SERVE_CAPS}, max_batch "
        f"{SERVE_MAX_BATCH}, a2a, escalation off): {ok}/{n} equal "
        f"execute_local, overflow {ovf}; first run {warm_s:.3f} s, "
        f"searchsorted launches {ss} over its {eng.dispatches} dispatches; "
        f"engine {n / sat_b:.1f} queries/s ({sat_b:.4f} s), sequential "
        f"execute_sharded loop {n / sat_s:.1f} queries/s ({sat_s:.4f} s), "
        f"speedup {sat_s / sat_b:.3f}x; {dispatches} dispatches, average "
        f"batch {avg_batch:.2f}; a2a payload a query {bytes_b:.0f} B "
        f"batched, {bytes_s:.0f} B sequential, ratio "
        f"{bytes_b / max(bytes_s, 1e-9):.3f} {tag}")
    profile_query(torch, lambda: eng.execute(reqs), "sharded engine replay",
                  reps=1)

    # (c) the 1% fault row: bench_serving.py's sampled plan (seed + 17,
    # resampled until a step-0 fault exists), replayed over one epoch
    # window from the first step-0 fault, warmed first
    def replay(e):
        """(results in request order, latencies, span) of one pass of
        `reqs` through `e`, a forced step at a time."""
        lat, now, got = [], 0.0, {}
        ids = [e.submit(pats, arrival=0.0) for pats in reqs]
        while e.pending():
            t0 = time.perf_counter()
            res = e.step(force=True)
            torch.cuda.synchronize()
            now += time.perf_counter() - t0
            lat.extend(now for _ in res)
            got.update((r.request_id, r) for r in res)
        return [got[i] for i in ids], lat, now

    fseed = args.seed + 17
    while True:
        fp = FaultPlan.sample(fseed, S, n_steps=2, rate=0.01, horizon=32)
        step0 = [f.epoch for f in fp.faults if f.step == 0]
        if step0:
            break
        fseed += 1
    feng = engine(fault_plan=fp, fault_retries=4)
    first, _ = count("b-c", lambda: feng.execute(reqs))
    _, unrec_first, _ = check(reqs, first, "1% fault engine, first run",
                              allow_quarantine=True)
    start = min(step0)
    feng.fault_epoch = start
    (warm, _, _), _ = count("b-c", lambda: replay(feng))
    check(reqs, warm, "1% fault window, warm-up", allow_quarantine=True)
    feng.fault_epoch = start
    det0, red0 = feng.corrupt_detected, feng.fault_redispatches
    (fres, lat_f, span_f), _ = count("b-c", lambda: replay(feng))
    detected = feng.corrupt_detected - det0
    redisp = feng.fault_redispatches - red0
    fok, unrec, _ = check(reqs, fres, "1% fault window",
                          allow_quarantine=True)
    _, lat_c, span_c = replay(eng)
    p99 = lambda xs: float(np.percentile(np.asarray(xs) * 1e3, 99))
    if detected <= 0:
        failures.append("dist: the 1% fault window detected no fault")
    log(f"[dist] 1% faults (FaultPlan.sample seed {fseed}, {len(fp.faults)} "
        f"faults over 32 epochs, check_answers, fault_retries 4): window "
        f"from epoch {start}: detected {detected}, redispatches {redisp}, "
        f"{fok}/{n} equal execute_local, unrecovered {unrec} (every "
        f"result checked; the first run, epochs 0 on: unrecovered "
        f"{unrec_first}); {n / span_f:.1f} queries/s "
        f"against {n / span_c:.1f} clean; p99 {p99(lat_f):.3f} ms against "
        f"{p99(lat_c):.3f} ms clean, ratio "
        f"{p99(lat_f) / max(p99(lat_c), 1e-9):.3f} {tag}")

    # the drop + corrupt canary (bench_serving.py _chaos_mesh_main's plan:
    # shard 0 drops at epoch 0, then a shard corrupts at epoch 1) on one
    # dispatch of lubm_q13's variants. A dropped leg is always detected
    # (its checksum is zeroed too); a corrupted leg only where it carries
    # an answer (+1 on the nonzero keys of an empty block changes no bit),
    # so the corrupting shard is the first from shard 1 on whose
    # corruption alone this dispatch detects, probed shard by shard
    creqs = pools["lubm_q13"]
    probe_eng = lambda fp: ServeEngine(
        store, d, cfg, caps=caps, mesh=mesh, max_batch=4, fault_plan=fp,
        fault_retries=0, max_escalations=0, metrics=MetricsRegistry())
    answering = []
    for s in list(range(1, S)) + [0]:
        e = probe_eng(FaultPlan((Fault(0, s, "corrupt", epoch=0),)))
        e.execute(creqs)
        if e.corrupt_detected:
            answering.append(s)
            break
    corrupt = answering[0] if answering else 1
    canary = FaultPlan((Fault(0, 0, "drop", epoch=0),
                        Fault(0, corrupt, "corrupt", epoch=1)))
    ceng = ServeEngine(store, d, cfg, caps=caps, mesh=mesh, max_batch=4,
                       fault_plan=canary, max_escalations=0,
                       metrics=MetricsRegistry())
    cres, _ = count("b-c", lambda: ceng.execute(creqs))
    cok, cunrec, _ = check(creqs, cres, "drop + corrupt canary")
    if (ceng.corrupt_detected < S + 1 or ceng.fault_redispatches < 2
            or cunrec or cok != len(creqs)):
        failures.append(f"dist: canary: detected {ceng.corrupt_detected}, "
                        f"redispatches {ceng.fault_redispatches}, "
                        f"unrecovered {cunrec}, {cok}/{len(creqs)} exact")
    log(f"[dist] drop + corrupt canary (shard 0 drops at epoch 0, shard "
        f"{corrupt} corrupts at epoch 1; {len(creqs)} lubm_q13 requests, "
        f"{ceng.dispatches} dispatch(es)): detected "
        f"{ceng.corrupt_detected} blocks (want {S} dropped + at least 1 "
        f"corrupted), redispatches {ceng.fault_redispatches}, "
        f"{cok}/{len(creqs)} equal execute_local, unrecovered {cunrec} "
        f"{tag}")


def run_sharded_mutable(torch, args, mesh, card: str, count,
                        failures: list) -> None:
    """(d) the sharded engine over a MutableTripleStore of DIST_SHARDS
    shards across ingests: after each wave every query's answer equals
    the oracle on the acked triples (cut to lubm_like(DIST_MUTABLE_SCALE):
    the check is of caches and layouts, not of scale). The engine's runs
    go through ``count("d", run)`` (`counted`); the ingests' merges do
    not."""
    import numpy as np

    from repro_torch.core import Caps, ExecConfig, execute_oracle
    from repro_torch.data import lubm_like
    from repro_torch.data.rdf_gen import LUBM_SPARQL
    from repro_torch.obs import MetricsRegistry
    from repro_torch.serve import ServeEngine, parse_bgp
    from repro_torch.store import MutableTripleStore

    root = Path(__file__).resolve().parent / "build" / "dist_mutable"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    tr, d, _ = lubm_like(DIST_MUTABLE_SCALE, seed=args.seed)
    tr = tr[np.random.RandomState(args.seed).permutation(len(tr))]
    waves = np.array_split(tr, DIST_MUTABLE_WAVES)
    try:
        st = MutableTripleStore.create(str(root / "store"),
                                       num_shards=DIST_SHARDS,
                                       overlay_limit=DIST_MUTABLE_LIMIT,
                                       dictionary=d, device=mesh.device)
        eng = ServeEngine(st, d, ExecConfig(impl="kernel", routing="a2a"),
                          caps=Caps(**DIST_MUTABLE_CAPS), mesh=mesh,
                          metrics=MetricsRegistry())
        pats = {q: list(parse_bgp(LUBM_SPARQL[q], d).patterns)
                for q in DIST_MUTABLE_QUERIES}
        acked, lines, ok = [], [], 0
        for w, batch in enumerate(waves):
            t0 = time.perf_counter()
            st.ingest(batch)
            ingest_s = time.perf_counter() - t0
            acked.append(batch)
            # the plans of this store version first, outside the counted
            # run (a2a's embedded caps come from an instrumented
            # execute_local); the engine's plan order keeps the oracle
            # tractable
            orders = {q: eng._compile(tuple(p)).patterns
                      for q, p in pats.items()}
            t0 = time.perf_counter()
            results, n_launch = count("d", lambda: eng.execute(
                list(pats.values())))
            ss = n_launch["searchsorted"]
            serve_s = time.perf_counter() - t0
            if ss <= 0:
                failures.append(f"dist: mutable wave {w}: the sharded "
                                f"engine never launched the searchsorted "
                                f"kernel")
            now = np.concatenate(acked)
            for q, res in zip(pats, results):
                want, ovars = execute_oracle(now, orders[q])
                if res.rows_set(ovars) != want or res.overflow:
                    failures.append(f"dist: mutable wave {w} {q}: "
                                    f"{len(res.rows)} rows, oracle "
                                    f"{len(want)}, overflow {res.overflow}")
                else:
                    ok += 1
            lines.append(f"wave {w}: +{len(batch):,} triples in "
                         f"{ingest_s:.3f} s (version {st.store_version}, "
                         f"flushes {st.flush_count}), {len(pats)} queries "
                         f"in {serve_s:.3f} s")
        st.close()
        total = DIST_MUTABLE_WAVES * len(pats)
        if st.flush_count == 0:
            failures.append("dist: the mutable store never flushed")
        log(f"[dist] sharded engine over MutableTripleStore({DIST_SHARDS} "
            f"shards, overlay limit {DIST_MUTABLE_LIMIT}; cut to "
            f"lubm_like({DIST_MUTABLE_SCALE}), {len(tr):,} triples in "
            f"{DIST_MUTABLE_WAVES} shuffled waves; a2a, caps "
            f"{DIST_MUTABLE_CAPS}): {ok}/{total} answers equal the oracle "
            f"on the acked triples; {eng.dispatches} dispatches; "
            + "; ".join(lines) + f" ({card})")
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 8: exactness against the oracle
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
# phase 9: LM serving at full width
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


def time_flash_attention(torch, ops, x: dict,
                         label: str = "yi-6b prefill layer 0",
                         card: str = "", step_tol: bool = False) -> dict:
    """The kernel, its plain version and SDPA on layer 0's (q, k, v).
    With `step_tol`, a bf16 output's absolute bound is at least one bf16
    step of its largest element (2^-7 x max|o|): ATTN_TOL is the
    reference test's bound for O(1) outputs, and an output of 4 or more
    rounds in steps of 2^-5, above it (SDPA's error there is the same)."""
    import torch.nn.functional as F
    q, k, v, causal = x["q"], x["k"], x["v"], x["causal"]
    b, sq, h, e = q.shape
    skv = k.shape[1]
    got = ops.flash_attention(q, k, v, causal, impl="kernel")
    want = ops.flash_attention(q, k, v, causal, impl="torch")
    err = float((got.float() - want.float()).abs().max())
    row = row_rel_err(got, want)
    dname = "bfloat16" if q.dtype == torch.bfloat16 else "float32"
    tol = ATTN_TOL[dname]
    if step_tol and dname == "bfloat16":
        tol = max(tol, 2 ** -7 * float(want.float().abs().max()))
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
                   err <= tol and row <= ATTN_ROW_TOL[dname])),
               ms=t_k, plain_ms=t_p, bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               library_ms=t_l,
               shape=f"{label}: q {tuple(q.shape)} k/v "
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
        f"against the plain version: kernel {err:.3e}, SDPA {sdpa_err:.3e} "
        f"(bound {tol:.3e}); "
        f"row_rel_err: kernel {row:.3e}, SDPA {sdpa_row:.3e} (bound "
        f"{ATTN_ROW_TOL[dname]:.3e})" + (f"; {card}" if card else ""))
    return rec


# ---------------------------------------------------------------------------
# phase 10: the other LM families at full width
# ---------------------------------------------------------------------------

# (arch, layers run, text positions a prompt): every config at its full
# published width, 4 prompts, LM_DECODE greedy steps. pixtral's prompt is
# its 256 patch embeddings and 3744 text tokens (4000 positions), musicgen's
# 4000 frames of 4 codebooks. dbrx is cut to 8 of its 40 layers: its plain
# teacher-forced run materialises (4, 48, 2048, 2048) float32 scores and
# probabilities (3.2 GB each) beside 54.6 GB of bf16 weights.
FAMILY_RUNS = (("qwen3-8b", 36, 4000), ("pixtral-12b", 40, 3744),
               ("musicgen-large", 48, 4000), ("dbrx-132b", 8, 2048))
# Top-k routing is discontinuous: a token that takes another expert gets
# another MoE output (with random weights it dwarfs the residual stream),
# and through attention every later token of its sequence moves, so a
# free-running plain run drifts from the kernel's at depth however small
# the kernel's error (a plain model of the kernel's one rounding,
# `rounded_p`, drifts as far). So the MoE comparison teacher-forces the
# routing too: the plain run and the model take the kernel run's expert
# ids at every (layer, token), computing their own probabilities and
# weights. Even so the model amplifies the one rounding past LOGIT_TOL:
# on an H100 the model moved dbrx's logits (8 layers) by 7.08% of
# max|logits|, the kernel by 7.88%. So the kernel may move the logits,
# and the router's probabilities (max|dp|), at most MOE_MODEL_RATIO times
# as far from the plain run as the model does (the training phase's
# TRAIN_GRAD_RATIO). Where the plain run's own top-k differs from the
# kernel's ids, its k-th and (k+1)-th probabilities lie within |dp_i| +
# |dp_j| <= 2 max|dp| of each other: each such routing must be a near-tie
# within MOE_MODEL_RATIO x 2 x the model's max|dp|. The free-running runs
# are reported.
MOE_MODEL_RATIO = 2.0


def watch_moe(torch, moe, calls: dict, forced: list | None = None):
    """Swap moe.router_topk and moe.moe_ffn for wrappers that record each
    call's expert ids and router probabilities (recomputed from the call's
    inputs as router_topk computes them) and each layer's dropped share;
    with `forced` (another run's records), call i routes to forced[i]'s
    ids, weighted by this run's own probabilities. Returns a function that
    puts the originals back. Measurement only: the package is unchanged."""
    topk, ffn = moe.router_topk, moe.moe_ffn

    def route(x, w, top_k, num_experts):
        out = topk(x, w, top_k, num_experts)
        probs = torch.softmax(torch.einsum("td,de->te", x.float(), w.float()),
                              dim=-1)
        i = len(calls["route"])
        calls["route"].append((out[1], probs))
        if forced is None:
            return out
        ids = forced[i][0]
        weights = probs.gather(-1, ids)
        weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
        return weights, ids, out[2]

    def layer(x, params, **kw):
        out = ffn(x, params, **kw)
        calls["dropped"].append(out[2])
        return out

    moe.router_topk, moe.moe_ffn = route, layer

    def restore():
        moe.router_topk, moe.moe_ffn = topk, ffn
    return restore


def routing_blocks(torch, ref: list, other: list, layers: int, top_k: int):
    """Per step (the prefill, then each decode step) the (layers, T) masks
    of routings whose own top-k sets differ between two runs, the `ref`
    run's gap between its k-th and (k+1)-th probabilities, and max|dp|."""
    out = []
    for i in range(0, len(ref), layers):
        diff, gap, dp = [], [], []
        for (ids_r, p_r), (ids_o, p_o) in zip(ref[i:i + layers],
                                               other[i:i + layers]):
            diff.append((ids_r.sort(-1).values != ids_o.sort(-1).values).any(-1))
            top = p_r.sort(-1, descending=True).values
            gap.append(top[:, top_k - 1] - top[:, top_k])
            dp.append((p_r - p_o).abs().amax(-1))
        out.append(tuple(torch.stack(t) for t in (diff, gap, dp)))
    return out


def token_rows(torch, blocks: list, s_text: int):
    """(steps, b): whether the token behind each logits row (each prompt's
    last position at step 0, the token fed at decode step j) routed
    differently at any layer."""
    d0 = blocks[0][0].any(0).reshape(LM_BATCH, s_text)[:, -1]
    return torch.stack([d0] + [d.any(0) for d, _, _ in blocks[1:]])


def check_routing(torch, arch: str, routes: dict, err_free: dict,
                  layers: int, top_k: int, s_text: int, card: str,
                  failures: list) -> None:
    """The routing of the kernel run against the plain run's own top-k
    under the kernel's routing, beside the plain model of the kernel's
    rounding (see MOE_MODEL_RATIO); then the free-running runs, reported."""
    tag = f"[family {arch}]"
    forced = {name: routing_blocks(torch, routes["torch"], routes[name],
                                   layers, top_k)
              for name in ("kernel", "model")}
    n = sum(d.numel() for d, _, _ in forced["kernel"])
    n_diff = {k: sum(int(d.sum()) for d, _, _ in bl) for k, bl in forced.items()}
    eps = {k: max(float(dp.max()) for _, _, dp in bl) for k, bl in forced.items()}
    gaps = torch.cat([gap[d] for d, gap, _ in forced["kernel"]])
    worst = float(gaps.max()) if gaps.numel() else 0.0
    bound = MOE_MODEL_RATIO * 2 * eps["model"]
    log(f"{tag} routing under the kernel run's expert ids: the plain run's "
        f"own top-{top_k} differs at {n_diff['kernel']} of {n} (layer, token) "
        f"routings, the model's at {n_diff['model']}; max|dp| against the "
        f"plain run: kernel {eps['kernel']:.3e}, model {eps['model']:.3e} "
        f"(bound {MOE_MODEL_RATIO} x model); the differing routings' plain "
        f"gap between the k-th and (k+1)-th probabilities: max {worst:.3e} "
        f"(bound {MOE_MODEL_RATIO} x 2 x {eps['model']:.3e} = {bound:.3e}); "
        f"{card}")
    if not eps["kernel"] <= MOE_MODEL_RATIO * eps["model"]:
        failures.append(f"{arch}: the kernel moves the router's "
                        f"probabilities by {eps['kernel']}, the model of its "
                        f"rounding by {eps['model']}")
    if worst > bound:
        failures.append(f"{arch}: a routing that differs has plain gap "
                        f"{worst}, not a near-tie (bound {bound})")
    # free-running: each run routes by its own probabilities, reported
    free = {name: routing_blocks(torch, routes["torch free"], routes[name],
                                 layers, top_k)
            for name in ("kernel", "model free")}
    parts = []
    for name, bl in free.items():
        diff = sum(int(d.sum()) for d, _, _ in bl)
        first = sum(int((d & (d.int().cumsum(0) == 1)).sum()) for d, _, _ in bl)
        moved = token_rows(torch, bl, s_text)
        err = err_free[name]
        alike = err[~moved]
        parts.append(
            f"{name.split()[0]} {diff} routings differ ({first} a token's "
            f"first), logits max|delta| {float(err.max()):.5f}, over the "
            f"{int(alike.numel())} (sequence, step) rows whose token routed "
            f"alike {float(alike.max()) if alike.numel() else 0.0:.5f}")
    log(f"{tag} free-running routing against the free plain run (reported, "
        f"not gated): " + "; ".join(parts))


def serve_family(torch, args, arch: str, layers: int, s_text: int,
                 card: str, failures: list) -> dict:
    """One config through launch/serve.py's generate with the kernel (the
    main path: counts to 0 just before, read just after), then kernel
    against plain teacher-forced on the kernel run's ids, the prefill and
    decode times, peak memory, and the kernel at layer 0's (q, k, v)."""
    import dataclasses

    import numpy as np

    from repro_torch.common import param_bytes, param_count
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model, moe
    from repro_torch.models.transformer import VIT_DIM

    t_start = time.perf_counter()
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=layers)
    tag = f"[family {arch}]"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, "cuda")
    t0 = time.perf_counter()
    params = model.init_params(args.seed)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    wbytes = param_bytes(params)
    rng = np.random.RandomState(args.seed)
    shape = (LM_BATCH, s_text)
    if cfg.family == "audio":
        shape += (cfg.num_codebooks,)
    toks = torch.as_tensor(rng.randint(0, cfg.vocab_size, shape),
                           dtype=torch.int32, device="cuda")
    batch = {"tokens": toks}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.as_tensor(
            rng.randn(LM_BATCH, cfg.num_patches, VIT_DIM),
            dtype=torch.float32, device="cuda")
    n_pos = s_text + cfg.num_patches
    log(f"{tag} {cfg.family}: {layers} of {full.num_layers} layers, d "
        f"{cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads} x "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}"
        + (f", {cfg.num_experts} experts top-{cfg.top_k} (moe_d_ff "
           f"{cfg.moe_d_ff}, capacity_factor {cfg.capacity_factor})"
           if cfg.num_experts else "")
        + (", qk-norm" if cfg.qk_norm else "")
        + (f", {cfg.num_codebooks} codebooks" if cfg.num_codebooks else "")
        + f"; {param_count(params) / 1e9:.3f} B params, {wbytes} bytes "
        f"bf16; init_params {t_init:.2f} s; prompts {LM_BATCH} x {n_pos} "
        f"positions" + (f" ({cfg.num_patches} patch embeddings + {s_text} "
                        f"text tokens)" if cfg.num_patches else "")
        + f", {LM_DECODE} decode steps")

    # the main path: counts to 0 just before, read just after
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    ids, t_first, t_decode = generate(model, params, toks, LM_DECODE,
                                      batch.get("patch_embeds"))
    launches = dict(ops.launches)
    variants = dict(ops.flash_attention_variants)
    serve_peak = torch.cuda.max_memory_allocated()
    log(f"{tag} main path (launch/serve.py generate): kernel launches "
        f"{launches}, by kernel {variants}; first prefill "
        f"{t_first * 1e3:.3f} ms, decode {t_decode * 1e3:.3f} ms/token; "
        f"peak memory {serve_peak} bytes ({serve_peak / 2 ** 30:.2f} GiB)")
    if launches["flash_attention"] != layers:
        failures.append(f"{arch}: {launches['flash_attention']} "
                        f"flash_attention launches in one prefill + decode, "
                        f"want {layers}")
    if variants != {"wgmma": layers, "simt": 0}:
        failures.append(f"{arch}: flash_attention launches by kernel "
                        f"{variants}, want all {layers} on wgmma")

    # teacher-forced on the kernel run's ids: the kernel (a rerun, which
    # must give the same ids) and the plain version; for a MoE model the
    # plain version and the plain model of the kernel's one rounding under
    # the kernel run's routing, then both free-running (MOE_MODEL_RATIO)
    model_t = build_model(dataclasses.replace(cfg, attention_impl="torch"),
                          "cuda")
    runs, routes, dropped = {}, {}, []
    specs = [("kernel", model, False, False), ("torch", model_t, False, True)]
    if cfg.num_experts:
        specs += [("model", model_t, True, True),
                  ("torch free", model_t, False, False),
                  ("model free", model_t, True, False)]
    plain_fa = fa.flash_attention_plain
    for name, m, rounded, force in specs:
        calls = {"route": [], "dropped": []}
        restore = watch_moe(torch, moe, calls,
                            routes["kernel"] if force else None)
        if rounded:
            fa.flash_attention_plain = rounded_p(torch, fa)
        ops.reset_launches()
        try:
            logits, cache = m.prefill(params, batch)
            after_prefill = ops.launches["flash_attention"]
            steps = [logits.float()]
            for i in range(LM_DECODE - 1):
                logits, cache = m.decode_step(params, cache,
                                              ids[:, i:i + 1].to(torch.int32))
                steps.append(logits.float())
            torch.cuda.synchronize()
        finally:
            restore()
            fa.flash_attention_plain = plain_fa
        want = layers if name == "kernel" else 0
        if (after_prefill, ops.launches["flash_attention"]) != (want, want) \
                or ops.flash_attention_variants != {"wgmma": want, "simt": 0}:
            failures.append(f"{arch} {name}: flash_attention launches "
                            f"{after_prefill} after prefill, "
                            f"{ops.launches['flash_attention']} after decode "
                            f"(by kernel {ops.flash_attention_variants}); want "
                            f"{want} and {want}, all wgmma")
        runs[name] = torch.stack(steps)         # (steps, b, [K,] vocab)
        routes[name] = calls["route"]
        if name == "kernel":
            dropped = [float(d) for d in calls["dropped"][:layers]]
        del cache, steps, logits
    kern, plain = runs["kernel"], runs["torch"]
    same_ids = bool(torch.equal(kern.argmax(-1).transpose(0, 1), ids))
    scale = float(kern.abs().max())

    def delta(a, b):                                   # (steps, b)
        return (a - b).abs().flatten(2).amax(-1)
    err = delta(kern, plain)
    worst = float(err.max())
    bound, what = LOGIT_TOL * scale, f"{LOGIT_TOL} x max|logits|"
    if cfg.num_experts:
        log(f"{tag} dropped share at prefill by MoE layer: "
            + ", ".join(f"{d:.5f}" for d in dropped))
        check_routing(torch, arch, routes,
                      {"kernel": delta(kern, runs["torch free"]),
                       "model free": delta(runs["model free"],
                                           runs["torch free"])},
                      layers, cfg.top_k, s_text, card, failures)
        model_worst = float(delta(runs["model"], plain).max())
        bound = MOE_MODEL_RATIO * model_worst
        what = (f"{MOE_MODEL_RATIO} x the model's {model_worst:.5f}, "
                f"{model_worst / scale:.4f} of max|logits|")
    hit = plain.argmax(-1).transpose(0, 1) == ids
    agree_ids = int((hit.all(-1) if cfg.family == "audio" else hit).sum())
    log(f"{tag} kernel vs torch, teacher-forced"
        + (" (routing too)" if cfg.num_experts else "")
        + f": max|logits| {scale:.4f}; max|delta| prefill "
        f"{float(err[0].max()):.5f}, over all prefill + {LM_DECODE - 1} "
        f"decode steps {worst:.5f}, {worst / scale:.4f} of max|logits| "
        f"(bound {what} = {bound:.5f}); greedy ids agree "
        f"{agree_ids}/{ids.shape[0] * ids.shape[1]}; kernel rerun reproduces "
        f"the generated ids: {same_ids}")
    if not (math.isfinite(scale) and worst <= bound):
        failures.append(f"{arch}: kernel and torch logits differ by {worst} "
                        f"(bound {what} = {bound})")
    if not same_ids:
        failures.append(f"{arch}: the kernel rerun did not reproduce the ids")
    peak = torch.cuda.max_memory_allocated()
    del runs, kern, plain, model_t, routes

    # prefill time (median of 3 after a warm-up that records layer 0's args)
    x = first_call_args(ops, "flash_attention",
                        lambda: model.prefill(params, batch))
    t_prefill = wall_ms(torch, lambda: model.prefill(params, batch), runs=3)
    tok_s = LM_BATCH * n_pos / (t_prefill / 1e3)
    floor = wbytes / HBM_BYTES_PER_S * 1e3
    log(f"{tag} prefill {LM_BATCH}x{n_pos}: {t_prefill:.3f} ms (median of "
        f"3), {tok_s:.1f} tokens/s; decode {t_decode * 1e3:.3f} ms/token "
        f"({LM_BATCH} sequences; reading every weight once a step takes "
        f"{floor:.3f} ms at 3.35 TB/s); peak memory {peak} bytes "
        f"({peak / 2 ** 30:.2f} GiB) with the plain reference, {serve_peak} "
        f"({serve_peak / 2 ** 30:.2f} GiB) serving alone; {card}")
    logits, cache = model.prefill(params, batch)
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    profile_query(torch, lambda: model.prefill(params, batch),
                  f"{arch} prefill", reps=1)
    profile_query(torch, lambda: model.decode_step(params, cache, tok),
                  f"{arch} decode step")
    del cache, logits
    rec = time_flash_attention(torch, ops, x, f"{arch} prefill layer 0", card,
                               step_tol=True)
    del x, params, model
    torch.cuda.empty_cache()
    log(f"{tag} {time.perf_counter() - t_start:.1f} s")
    return dict(kernel=rec, launches=launches["flash_attention"],
                prefill_ms=t_prefill, tokens_per_s=tok_s,
                decode_ms=t_decode * 1e3, decode_floor_ms=floor,
                peak=peak, serve_peak=serve_peak)


def run_lm_families(torch, args, card: str, failures: list) -> dict:
    """Every FAMILY_RUNS config through `serve_family`, freeing each model
    before the next; a config that fails is reported and the next runs."""
    out = {}
    for arch, layers, s_text in FAMILY_RUNS:
        try:
            out[arch] = serve_family(torch, args, arch, layers, s_text, card,
                                     failures)
        except Exception:
            failures.append(f"phase LM families, {arch}:\n"
                            f"{traceback.format_exc()}")
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 11: deepseek-v3-671b (MLA, 256 experts, MTP) at full width
# ---------------------------------------------------------------------------

# deepseek-v3-671b at its published width, bf16, cut to 4 of its 61 layers
# (the 3 dense layers and 1 MoE layer) plus the MTP module: 53.45 GB of
# weights (embed 1.853, dense layers 3.501, MoE layer 23.018, lm_head 1.853,
# mtp 23.224). Two MoE layers with MTP would be 76.5 GB, no room for the
# activations; five layers without MTP would leave MTP off the card.
MLA_ARCH, MLA_LAYERS = "deepseek-v3-671b", 4
MLA_SEQ = 2048       # (c): one sequence, blockwise MLA against the naive one
MLA_CONSIST = 1024   # (d) prefill + one decode step, (e) the MTP loss
# (f): float8_e4m3fn's edges and subnormals (k x 2^-9), each signed
F8_EDGES = (448.0, 463.9, 464.0, 464.1, math.inf, math.nan, 2.0 ** -10) + \
    tuple(k * 2.0 ** -9 for k in range(1, 8))


def check_mla_attention(torch, attn_lib, x: dict, card: str,
                        failures: list) -> dict:
    """(c) mla_prefill_attention against mla_naive_attention on the first
    sequence's first MLA_SEQ positions of layer 0's own inputs `x` (the
    naive run's float32 scores are (1, h, MLA_SEQ, MLA_SEQ)), under the
    bound time_flash_attention holds at the family shapes; both timed."""
    q, ckv, kpe = (x[n][:1, :MLA_SEQ].contiguous() for n in ("q", "ckv", "k_pe"))
    wk, wv, scale = x["kv_b_k"], x["kv_b_v"], x["scale"]

    def blockwise():
        return attn_lib.mla_prefill_attention(
            q, ckv, kpe, wk, wv, scale=scale, block_q=x["block_q"],
            block_kv=x["block_kv"])

    def naive():
        return attn_lib.mla_naive_attention(q, ckv, kpe, wk, wv, scale=scale)

    got, want = blockwise(), naive()
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    at = [int(i) for i in torch.unravel_index(diff.argmax(), diff.shape)]
    row = row_rel_err(got, want)
    top = float(want.float().abs().max())
    tol = max(ATTN_TOL["bfloat16"], 2 ** -7 * top)
    del got, want, diff
    t_block = cuda_ms(torch, blockwise, iters=3, warmup=1)
    t_naive = cuda_ms(torch, naive, iters=3, warmup=1)
    h, e, ev = q.shape[2], q.shape[3], wv.shape[-1]
    flops = 2 * h * (e + ev) * MLA_SEQ * (MLA_SEQ + 1) // 2
    log(f"[mla] (c) layer 0, 1 x {MLA_SEQ} positions, {h} heads, qk {e}, v "
        f"{ev}, bf16: blockwise against naive max_abs_err {err:.3e} at "
        f"(b, s, h, v) {tuple(at)} (bound max(2e-2, 2^-7 x max|o| "
        f"{top:.4f}) = {tol:.3e}), row_rel_err {row:.3e} (bound "
        f"{ATTN_ROW_TOL['bfloat16']:.3e}); blockwise {t_block:.3f} ms, naive "
        f"{t_naive:.3f} ms ({flops:.4e} flops of causal scores and values: "
        f"{flops / t_block / 1e9:.1f} and {flops / t_naive / 1e9:.1f} "
        f"TFLOP/s); {card}")
    if not (err <= tol and row <= ATTN_ROW_TOL["bfloat16"]):
        failures.append(f"mla (c): blockwise and naive MLA differ by {err} "
                        f"(bound {tol}), row {row}")
    return dict(max_abs_err=err, row_rel_err=row, blockwise_ms=t_block,
                naive_ms=t_naive)


def check_mla_decode(torch, model, params, rng, card: str,
                     failures: list) -> dict:
    """(d) prefill(1 x MLA_CONSIST) + decode_step(the next token) against
    the last logits of prefill(1 x MLA_CONSIST + 1), at a capacity factor
    at which every expert takes every token (no pair dropped), the longer
    run routed as the decode run routed (`watch_moe`); the first run
    under torch.cuda's sync debug mode "error": a host sync raises."""
    import dataclasses

    from repro_torch.models import build_model, moe
    cfg = model.cfg
    roomy = build_model(dataclasses.replace(
        cfg, capacity_factor=cfg.num_experts / cfg.top_k), "cuda")
    seq = torch.as_tensor(rng.randint(0, cfg.vocab_size, (1, MLA_CONSIST + 1)),
                          dtype=torch.int32, device="cuda")
    head, nxt = {"tokens": seq[:, :MLA_CONSIST]}, seq[:, MLA_CONSIST:]
    calls = {"route": [], "dropped": []}
    restore = watch_moe(torch, moe, calls)
    mode = torch.cuda.get_sync_debug_mode()
    synced = ""
    try:
        torch.cuda.set_sync_debug_mode("error")
        try:
            _, cache = roomy.prefill(params, head)
            got, _ = roomy.decode_step(params, cache, nxt)
        except RuntimeError as e:                # a host sync: rerun, report
            synced = str(e).splitlines()[0]
            torch.cuda.set_sync_debug_mode(mode)
            calls["route"].clear()
            calls["dropped"].clear()
            _, cache = roomy.prefill(params, head)
            got, _ = roomy.decode_step(params, cache, nxt)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
        restore()
    del cache
    if synced:
        failures.append(f"mla (d): prefill + decode_step synchronised with "
                        f"the host: {synced}")
    if len(calls["route"]) != 2:
        raise RuntimeError(f"mla (d): {len(calls['route'])} routings, want "
                           f"2 (one MoE layer, two runs)")
    ids = torch.cat([calls["route"][0][0], calls["route"][1][0]])
    calls_long = {"route": [], "dropped": []}
    restore = watch_moe(torch, moe, calls_long, [(ids, None)])
    try:
        want, _ = roomy.prefill(params, {"tokens": seq})
    finally:
        restore()
    own = calls_long["route"][0][0]
    differ = int((own.sort(-1).values != ids.sort(-1).values).any(-1).sum())
    dropped = [float(d) for d in calls["dropped"] + calls_long["dropped"]]
    got, want = got.float(), want.float()
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    log(f"[mla] (d) prefill(1 x {MLA_CONSIST}) + decode_step against "
        f"prefill(1 x {MLA_CONSIST + 1}), capacity_factor "
        f"{roomy.cfg.capacity_factor:g}, the longer run routed as the decode "
        f"run (its own top-{cfg.top_k} differs at {differ} of "
        f"{own.shape[0]} tokens): max|logits| {scale:.4f}, max|delta| "
        f"{err:.5f}, {err / scale:.4f} of max|logits| (bound {LOGIT_TOL}); "
        f"dropped share by run {dropped}; host syncs under debug mode "
        f"'error': {synced or 'none'}; {card}")
    if not (math.isfinite(scale) and err <= LOGIT_TOL * scale):
        failures.append(f"mla (d): decode and prefill logits differ by {err} "
                        f"(bound {LOGIT_TOL * scale})")
    if any(dropped):
        failures.append(f"mla (d): pairs dropped {dropped}; the comparison "
                        f"needs none")
    return dict(rel_err=err / scale, dropped=dropped)


def check_mla_mtp(torch, model, params, rng, card: str, failures: list) -> dict:
    """(e) one model.loss under no_grad on 1 x MLA_CONSIST tokens, labels
    the next tokens: ce, aux and mtp_ce finite, and the loss equal to
    ce + router_aux_weight * aux + 0.1 * mtp_ce."""
    cfg = model.cfg
    seq = torch.as_tensor(rng.randint(0, cfg.vocab_size, (1, MLA_CONSIST + 1)),
                          dtype=torch.int32, device="cuda")
    batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
    t0 = time.perf_counter()
    with torch.no_grad():
        loss, met = model.loss(params, batch)
        torch.cuda.synchronize()
    t_loss = (time.perf_counter() - t0) * 1e3
    total = met["ce"] + cfg.router_aux_weight * met["aux"] + 0.1 * met["mtp_ce"]
    vals = {k: float(v) for k, v in dict(met, loss=loss).items()}
    same = bool(torch.equal(loss, total))
    log(f"[mla] (e) loss on 1 x {MLA_CONSIST} under no_grad ({t_loss:.1f} ms "
        f"host): loss {vals['loss']:.6f}, ce {vals['ce']:.6f}, aux "
        f"{vals['aux']:.6f}, mtp_ce {vals['mtp_ce']:.6f}; loss == ce + "
        f"{cfg.router_aux_weight:g} x aux + 0.1 x mtp_ce: {same}; {card}")
    if not all(math.isfinite(v) for v in vals.values()):
        failures.append(f"mla (e): a loss term is not finite: {vals}")
    if not same:
        failures.append(f"mla (e): loss {vals['loss']} is not ce + "
                        f"{cfg.router_aux_weight} aux + 0.1 mtp_ce "
                        f"({float(total)})")
    return vals


def check_f8_cast(torch, card: str, failures: list) -> None:
    """(f) common.cache_cast to float8_e4m3fn on the card against the CPU,
    bit for bit, from float32 and from bfloat16 (the same source bits on
    both sides)."""
    from repro_torch.common import cache_cast
    vals = torch.tensor(F8_EDGES + tuple(-v for v in F8_EDGES))
    for src in (torch.float32, torch.bfloat16):
        v = vals.to(src)
        cpu = cache_cast(v, torch.float8_e4m3fn).view(torch.uint8)
        dev = cache_cast(v.to("cuda"), torch.float8_e4m3fn).view(torch.uint8).cpu()
        same = bool(torch.equal(cpu, dev))
        log(f"[mla] (f) float8 cache cast from {str(src)[6:]}: card "
            f"{dev.tolist()}, CPU {cpu.tolist()}: equal {same}; {card}")
        if not same:
            failures.append(f"mla (f): the float8 cast from {src} differs "
                            f"between the card and the CPU")


def run_lm_mla(torch, args, card: str, failures: list) -> dict:
    """deepseek-v3-671b at full width cut to MLA_LAYERS layers plus MTP:
    (a) 4 prompts of 4000 tokens and 32 greedy steps through
    launch/serve.py's generate (the main path), prefill and decode timed
    beside the time to read what decode reads; (b) its kernel launches,
    which must be 0 (MLA reaches no kernel in either package); then
    (c)-(f) (check_mla_attention, check_mla_decode, check_mla_mtp,
    check_f8_cast)."""
    import dataclasses

    import numpy as np

    from repro_torch.common import param_bytes, param_count
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import attention as attn_lib
    from repro_torch.models import build_model

    t_start = time.perf_counter()
    full = get_config(MLA_ARCH)
    cfg = dataclasses.replace(full, num_layers=MLA_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, "cuda")
    t0 = time.perf_counter()
    params = model.init_params(args.seed)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    parts = {k: param_bytes(params[k]) for k in
             ("embed", "dense_layers", "moe_layers", "lm_head", "mtp")}
    read = parts["lm_head"] + parts["dense_layers"] + parts["moe_layers"]
    floor = read / HBM_BYTES_PER_S * 1e3
    log(f"[mla] {MLA_ARCH}: {MLA_LAYERS} of {full.num_layers} layers "
        f"({cfg.first_dense_layers} dense at d_ff {cfg.dense_d_ff}, "
        f"{MLA_LAYERS - cfg.first_dense_layers} MoE: {cfg.num_experts} "
        f"experts top-{cfg.top_k} + {cfg.num_shared_experts} shared, moe_d_ff "
        f"{cfg.moe_d_ff}) + MTP {cfg.mtp_depth}; d {cfg.d_model}, {cfg.num_heads} "
        f"heads, q_lora {cfg.q_lora_rank}, kv_lora {cfg.kv_lora_rank}, dn "
        f"{cfg.qk_nope_head_dim}, dr {cfg.qk_rope_head_dim}, dv "
        f"{cfg.v_head_dim}, vocab {cfg.vocab_size}, {cfg.param_dtype}; "
        f"{param_count(params) / 1e9:.3f} B params, {param_bytes(params)} "
        f"bytes (" + ", ".join(f"{k} {v}" for k, v in parts.items())
        + f"); init_params {t_init:.2f} s; prompts {LM_BATCH} x {LM_PROMPT}, "
        f"{LM_DECODE} decode steps")
    rng = np.random.RandomState(args.seed)
    toks = torch.as_tensor(rng.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT)),
                           dtype=torch.int32, device="cuda")
    batch = {"tokens": toks}

    # (a), (b) the main path: counts to 0 just before, read just after
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    ids, t_first, t_decode = generate(model, params, toks, LM_DECODE)
    launches = dict(ops.launches)
    serve_peak = torch.cuda.max_memory_allocated()
    log(f"[mla] (b) main path (launch/serve.py generate): kernel launches "
        f"{launches} (want 0: MLA reaches no kernel); first prefill "
        f"{t_first * 1e3:.3f} ms, decode {t_decode * 1e3:.3f} ms/token; "
        f"peak memory {serve_peak} bytes ({serve_peak / 2 ** 30:.2f} GiB); "
        f"{card}")
    if any(launches.values()):
        failures.append(f"mla (b): kernel launches {launches}, want none")
    if not (ids.shape == (LM_BATCH, LM_DECODE) and int(ids.min()) >= 0
            and int(ids.max()) < cfg.vocab_size):
        failures.append(f"mla (a): generated ids {tuple(ids.shape)} out of "
                        f"range")

    # prefill time (median of 3 after a warm-up that records layer 0's
    # MLA inputs)
    x = first_call_args(attn_lib, "mla_prefill_attention",
                        lambda: model.prefill(params, batch))
    t_prefill = wall_ms(torch, lambda: model.prefill(params, batch), runs=3)
    tok_s = LM_BATCH * LM_PROMPT / (t_prefill / 1e3)
    logits, cache = model.prefill(params, batch)
    if not bool(torch.isfinite(logits).all()):
        failures.append("mla (a): prefill logits are not finite")
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    profile_query(torch, lambda: model.prefill(params, batch),
                  f"{MLA_ARCH} prefill", reps=1)
    profile_query(torch, lambda: model.decode_step(params, cache, tok),
                  f"{MLA_ARCH} decode step")
    del cache, logits
    peak = torch.cuda.max_memory_allocated()
    log(f"[mla] (a) prefill {LM_BATCH}x{LM_PROMPT}: {t_prefill:.3f} ms "
        f"(median of 3), {tok_s:.1f} tokens/s; decode {t_decode * 1e3:.3f} "
        f"ms/token ({LM_BATCH} sequences; reading what decode reads, lm_head, "
        f"the dense layers and the MoE layer's {cfg.num_experts} experts, "
        f"{read} bytes, takes {floor:.3f} ms at 3.35 TB/s; MTP's "
        f"{parts['mtp']} bytes are not read); peak memory {serve_peak} bytes "
        f"({serve_peak / 2 ** 30:.2f} GiB) serving, {peak} "
        f"({peak / 2 ** 30:.2f} GiB) with the timing and profiles; {card}")

    attn = check_mla_attention(torch, attn_lib, x, card, failures)
    del x
    cons = check_mla_decode(torch, model, params, rng, card, failures)
    mtp = check_mla_mtp(torch, model, params, rng, card, failures)
    check_f8_cast(torch, card, failures)
    peak = torch.cuda.max_memory_allocated()
    del params, model
    torch.cuda.empty_cache()
    log(f"[mla] phase peak memory {peak} bytes ({peak / 2 ** 30:.2f} GiB); "
        f"{time.perf_counter() - t_start:.1f} s; {card}")
    return dict(launches=launches, prefill_ms=t_prefill, tokens_per_s=tok_s,
                decode_ms=t_decode * 1e3, decode_floor_ms=floor,
                serve_peak=serve_peak, peak=peak, attention=attn,
                consistency=cons, mtp=mtp)


# ---------------------------------------------------------------------------
# phase 12: the recurrent families at full width
# ---------------------------------------------------------------------------

# recurrentgemma-9b whole (38 layers, 10.445 B params, 20.89 GB in bf16)
# at 4 x 4096: twice its 2048-position window, since the rotating window
# cache agrees with a longer prefill only where the prompt is a multiple
# of the window (ROADMAP, known behaviour 14); xlstm-125m whole at 4 x
# 2048, its training context (arXiv:2405.04517).
RG_ARCH, RG_PROMPT = "recurrentgemma-9b", 4096
XL_ARCH, XL_PROMPT = "xlstm-125m", 2048
SCAN_TOL = dict(rtol=2e-5, atol=1e-5)    # tests/test_recurrent_cells.py:21
MLSTM_TOL = 2e-4                         # tests/test_recurrent_cells.py:44-60
WINDOW_SHAPE = (1, 4096, 32, 8, 128, 2048)  # b, s, h, g, e, window: yi-6b's heads


def serve_recurrent(torch, args, arch: str, prompt: int, tag: str,
                    card: str, failures: list) -> dict:
    """(a) 4 prompts of `prompt` tokens and 32 greedy steps through
    launch/serve.py's generate, the main path, with the kernel counts set
    to 0 just before and read just after (b: every count must stay 0, the
    flash kernel's too); prefill ms (median of 3), tokens/s, decode
    ms/token beside the time to read what decode reads, peak memory, and a
    profiled prefill and decode step. Returns the model, its weights and
    the numbers."""
    import numpy as np

    from repro_torch.common import param_bytes, param_count
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model

    cfg = get_config(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, "cuda")
    t0 = time.perf_counter()
    params = model.init_params(args.seed)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    # what one decode step reads of the weights: all of them but the
    # embedding table, of which it reads a row (unless it is the tied head)
    read, what = param_bytes(params), "every weight, the tied embedding as the head"
    if "lm_head" in params:
        read -= param_bytes(params["embed"])
        what = "every weight but the embedding table"
    floor = read / HBM_BYTES_PER_S * 1e3
    log(f"[{tag}] {arch}: {cfg.num_layers} layers (all), d {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads, vocab {cfg.vocab_size}, "
        f"{cfg.param_dtype}; {param_count(params) / 1e9:.3f} B params, "
        f"{param_bytes(params)} bytes; init_params {t_init:.2f} s; prompts "
        f"{LM_BATCH} x {prompt}, {LM_DECODE} decode steps")
    rng = np.random.RandomState(args.seed)
    toks = torch.as_tensor(rng.randint(0, cfg.vocab_size, (LM_BATCH, prompt)),
                           dtype=torch.int32, device="cuda")
    batch = {"tokens": toks}

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    ids, t_first, t_decode = generate(model, params, toks, LM_DECODE)
    launches = dict(ops.launches)
    serve_peak = torch.cuda.max_memory_allocated()
    log(f"[{tag}] (b) main path (launch/serve.py generate): kernel launches "
        f"{launches} (want 0: the {cfg.family} family reaches no kernel); "
        f"first prefill {t_first * 1e3:.3f} ms, decode "
        f"{t_decode * 1e3:.3f} ms/token; {card}")
    if any(launches.values()):
        failures.append(f"{tag} (b): kernel launches {launches}, want none")
    if not (ids.shape == (LM_BATCH, LM_DECODE) and int(ids.min()) >= 0
            and int(ids.max()) < cfg.vocab_size):
        failures.append(f"{tag} (a): generated ids {tuple(ids.shape)} out of "
                        f"range")

    t_prefill = wall_ms(torch, lambda: model.prefill(params, batch), runs=3)
    tok_s = LM_BATCH * prompt / (t_prefill / 1e3)
    logits, cache = model.prefill(params, batch)
    if not bool(torch.isfinite(logits).all()):
        failures.append(f"{tag} (a): prefill logits are not finite")
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    profile_query(torch, lambda: model.prefill(params, batch),
                  f"{arch} prefill", reps=1)
    profile_query(torch, lambda: model.decode_step(params, cache, tok),
                  f"{arch} decode step")
    del cache, logits
    log(f"[{tag}] (a) prefill {LM_BATCH}x{prompt}: {t_prefill:.3f} ms (median "
        f"of 3), {tok_s:.1f} tokens/s; decode {t_decode * 1e3:.3f} ms/token "
        f"({LM_BATCH} sequences; reading what decode reads, {what}, "
        f"{read} bytes, takes {floor:.3f} ms at 3.35 TB/s); peak memory "
        f"{serve_peak} bytes "
        f"({serve_peak / 2 ** 30:.2f} GiB) serving; {card}")
    return dict(model=model, params=params, rng=rng, batch=batch,
                launches=launches,
                prefill_ms=t_prefill, tokens_per_s=tok_s,
                decode_ms=t_decode * 1e3, decode_floor_ms=floor,
                serve_peak=serve_peak)


def attention_caches(model, cache) -> list:
    """Every attention layer's k and v cache of a RecurrentGemmaLM cache,
    (b, W, g, e) views, in layer order."""
    pat = model.cfg.block_pattern
    bufs = []
    if "macros" in cache:
        for m in range(model.n_macro):
            for i, t in enumerate(pat):
                if t == "attn":
                    bufs.extend(buf[m] for buf in cache["macros"][f"b{i}"])
    for j in range(model.n_tail):
        if pat[j] == "attn":
            bufs.extend(cache[f"tail{j}"])
    return bufs


def free_running(torch, run, tag: str, what: str, failures: list):
    """run() under torch.cuda's sync debug mode "error" (a host sync
    raises); on a sync, the failure is recorded and run() repeated with
    the mode restored."""
    mode = torch.cuda.get_sync_debug_mode()
    try:
        torch.cuda.set_sync_debug_mode("error")
        try:
            return run(), "none"
        except RuntimeError as e:
            synced = str(e).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    failures.append(f"{tag}: {what} synchronised with the host: {synced}")
    return run(), synced


def check_consistency(torch, model, params, rng, prompt: int, tag: str,
                      card: str, failures: list, watch=None) -> dict:
    """prefill(1 x prompt) + decode_step(the next token) against the last
    logits of prefill(1 x prompt + 1), the first run free of host syncs
    (`free_running`), within the logits gate. `watch(cache)`, where
    given, runs between the prefill and the step and returns a check of
    the cache for after it."""
    cfg = model.cfg
    seq = torch.as_tensor(rng.randint(0, cfg.vocab_size, (1, prompt + 1)),
                          dtype=torch.int32, device="cuda")
    after = []

    def run():
        _, cache = model.prefill(params, {"tokens": seq[:, :prompt]})
        if watch is not None:
            after.append(watch(cache))
        got, _ = model.decode_step(params, cache, seq[:, prompt:])
        return got

    got, synced = free_running(torch, run, f"{tag} (consistency)",
                               "prefill + decode_step", failures)
    want, _ = model.prefill(params, {"tokens": seq})
    got, want = got.float(), want.float()
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    log(f"[{tag}] prefill(1 x {prompt}) + decode_step against prefill(1 x "
        f"{prompt + 1}): max|logits| {scale:.4f}, max|delta| {err:.5f}, "
        f"{err / scale:.4f} of max|logits| (bound {LOGIT_TOL}); host syncs "
        f"under debug mode 'error': {synced}; {card}")
    if not (math.isfinite(scale) and err <= LOGIT_TOL * scale):
        failures.append(f"{tag}: decode and prefill logits differ by {err} "
                        f"(bound {LOGIT_TOL * scale})")
    out = dict(rel_err=err / scale)
    if after:
        out["after"] = after[-1]
    return out


def check_local_attention(torch, attn_lib, x: dict, window: int, card: str,
                          failures: list) -> dict:
    """(c) local_attention against naive_attention(window=...) on the
    first sequence of the first attention layer's own (q, k, v), under
    the bounds phase 11 (c) holds the blockwise MLA to; both timed."""
    q, k, v = (x[n][:1].contiguous() for n in ("q", "k", "v"))
    block_q = x["block_q"]

    def local():
        return attn_lib.local_attention(q, k, v, window=window, block_q=block_q)

    def naive():
        return attn_lib.naive_attention(q, k, v, window=window)

    got, want = local(), naive()
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    row = row_rel_err(got, want)
    top = float(want.float().abs().max())
    tol = max(ATTN_TOL["bfloat16"], 2 ** -7 * top)
    del got, want, diff
    t_local = cuda_ms(torch, local, iters=3, warmup=1)
    t_naive = cuda_ms(torch, naive, iters=3, warmup=1)
    s, h, e = q.shape[1], q.shape[2], q.shape[3]
    pairs = sum(min(i + 1, window) for i in range(s))
    flops = 4 * h * e * pairs
    log(f"[rg] (c) local attention, first attention layer, 1 x {s}, "
        f"{h}/{k.shape[2]} heads x {e}, window {window}, block_q {block_q}, "
        f"{q.dtype}: against naive max_abs_err {err:.3e} (bound max(2e-2, "
        f"2^-7 x max|o| {top:.4f}) = {tol:.3e}), row_rel_err {row:.3e} "
        f"(bound {ATTN_ROW_TOL['bfloat16']:.3e}); local {t_local:.3f} ms, "
        f"naive {t_naive:.3f} ms ({flops:.4e} flops of windowed scores and "
        f"values); {card}")
    if not (err <= tol and row <= ATTN_ROW_TOL["bfloat16"]):
        failures.append(f"rg (c): local and naive attention differ by {err} "
                        f"(bound {tol}), row {row}")
    return dict(max_abs_err=err, row_rel_err=row, local_ms=t_local,
                naive_ms=t_naive)


def check_scan(torch, rec, x: dict, card: str, failures: list) -> dict:
    """(d) rg_lru_scan against a float32 step-by-step recurrence on the
    first sequence of the first recurrent layer's own gates (b_in, log_a),
    TF32 off, under tests/test_recurrent_cells.py's bounds."""
    u, log_a = x["u"][:1].contiguous(), x["log_a"][:1].contiguous()
    got = rec.rg_lru_scan(u, log_a, None)
    a = torch.exp(log_a)
    h = torch.zeros_like(u[:, 0])
    want = torch.empty_like(u)
    for t in range(u.shape[1]):
        h = a[:, t] * h + u[:, t]
        want[:, t] = h
    err = (got - want).abs()
    excess = float((err / (SCAN_TOL["atol"] + SCAN_TOL["rtol"] * want.abs())).max())
    t_scan = cuda_ms(torch, lambda: rec.rg_lru_scan(u, log_a, None), iters=3,
                     warmup=1)
    log(f"[rg] (d) rg_lru_scan, first recurrent layer, {tuple(u.shape)} "
        f"float32 (TF32 {torch.backends.cuda.matmul.allow_tf32}): against "
        f"the step-by-step recurrence max_abs_err {float(err.max()):.3e}, "
        f"max |h| {float(want.abs().max()):.4f}, largest error over "
        f"atol {SCAN_TOL['atol']:g} + rtol {SCAN_TOL['rtol']:g} x |h|: "
        f"{excess:.4f} (bound 1); scan {t_scan:.3f} ms; {card}")
    if not excess <= 1.0:
        failures.append(f"rg (d): rg_lru_scan is {excess} x the bound from "
                        f"the recurrence")
    return dict(max_abs_err=float(err.max()), bound_share=excess,
                scan_ms=t_scan)


def check_windowed_dispatch(torch, args, attn_lib, ops, card: str,
                            failures: list) -> dict:
    """A windowed TransformerLM call: attention(..., impl="kernel",
    window=W) on bf16 CUDA tensors at yi-6b's heads launches no flash
    kernel and equals local_attention bit for bit."""
    b, s, h, g, e, w = WINDOW_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    q, k, v = (torch.randn((b, s, n, e), generator=gen, device="cuda",
                           dtype=torch.bfloat16) for n in (h, g, g))
    ops.reset_launches()
    got = attn_lib.attention(q, k, v, impl="kernel", window=w)
    launches = dict(ops.launches)
    same = bool(torch.equal(got, attn_lib.local_attention(q, k, v, window=w)))
    log(f"[rg] windowed dispatch attention(impl='kernel', window {w}) at "
        f"{b} x {s}, {h}/{g} heads x {e}, bf16: kernel launches {launches} "
        f"(want 0), equal to local_attention bit for bit: {same}; {card}")
    if any(launches.values()) or not same:
        failures.append(f"windowed dispatch: launches {launches}, equal {same}")
    return dict(launches=launches, same=same)


def run_lm_recurrent(torch, args, card: str, failures: list) -> dict:
    """recurrentgemma-9b at full width and depth: (a), (b)
    (serve_recurrent), (c) check_local_attention, (d) check_scan, (e)
    check_consistency at 1 x 4096 with the step's write to slot
    4096 % 2048 = 0 of every attention layer's cache; the windowed
    dispatch; then xlstm-125m at full width and depth: (a), (b), (c)
    mlstm_chunkwise against the token-by-token mlstm_decode on layer 0's
    inputs, (d) check_consistency at 1 x 2048."""
    from repro_torch.kernels import ops
    from repro_torch.models import attention as attn_lib
    from repro_torch.models import recurrent as rec
    from repro_torch.models import xlstm

    t_start = time.perf_counter()
    out = {}
    rg = serve_recurrent(torch, args, RG_ARCH, RG_PROMPT, "rg", card, failures)
    model, params, batch = rg.pop("model"), rg.pop("params"), rg.pop("batch")
    # the first layer's inputs only: every layer's scan inputs are 14 GB
    xa = all_call_args(attn_lib, "local_attention",
                       lambda: model.prefill(params, batch), most=1)[0]
    rg["attention"] = check_local_attention(torch, attn_lib, xa,
                                            model.cfg.window_size, card,
                                            failures)
    del xa
    xs = all_call_args(rec, "rg_lru_scan",
                       lambda: model.prefill(params, batch), most=1)[0]
    rg["scan"] = check_scan(torch, rec, xs, card, failures)
    del xs
    W = model.cfg.window_size
    slot = RG_PROMPT % W

    def watch(cache):
        """Copies every attention layer's k and v cache; returns what
        reads, after the step, the slots each one changed in."""
        bufs = attention_caches(model, cache)
        before = [buf.clone() for buf in bufs]
        return lambda: [tuple(torch.nonzero((buf != old).flatten(2).any(-1)
                                            .any(0)).flatten().tolist())
                        for buf, old in zip(bufs, before)]

    cons = check_consistency(torch, model, params, rg["rng"], RG_PROMPT, "rg",
                             card, failures, watch)
    slots = cons.pop("after")()
    log(f"[rg] (e) slots the step wrote in the {len(slots)} attention "
        f"caches (k and v of each attention layer): {sorted(set(slots))} "
        f"(want [({slot},)]: {RG_PROMPT} % {W}); {card}")
    if set(slots) != {(slot,)}:
        failures.append(f"rg (e): the decode step wrote slots "
                        f"{sorted(set(slots))}, want only {slot} in every "
                        f"attention layer")
    rg["consistency"] = cons
    out["window"] = check_windowed_dispatch(torch, args, attn_lib, ops, card,
                                            failures)
    rg["peak"] = torch.cuda.max_memory_allocated()
    del model, params, batch
    torch.cuda.empty_cache()
    t_rg = time.perf_counter() - t_start
    out[RG_ARCH] = rg

    xl = serve_recurrent(torch, args, XL_ARCH, XL_PROMPT, "xl", card, failures)
    model, params, batch = xl.pop("model"), xl.pop("params"), xl.pop("batch")
    x = all_call_args(xlstm, "mlstm_chunkwise",
                      lambda: model.prefill(params, batch), most=1)[0]
    q, k, v, li, lf = (x[n][:1].contiguous() for n in
                       ("q", "k", "v", "log_i", "log_f"))
    got, _ = xlstm.mlstm_chunkwise(q, k, v, li, lf)
    b, s, h, e = q.shape
    state = (q.new_zeros((b, h, e, e)), q.new_zeros((b, h, e)),
             q.new_full((b, h), xlstm.M_INIT))
    want = torch.empty_like(got)
    for t in range(s):
        want[:, t], state = xlstm.mlstm_decode(q[:, t], k[:, t], v[:, t],
                                               li[:, t], lf[:, t], state)
    err = (got - want).abs()
    excess = float((err / (MLSTM_TOL + MLSTM_TOL * want.abs())).max())
    log(f"[xl] (c) mlstm_chunkwise (chunk {xlstm.CHUNK}) against the "
        f"token-by-token mlstm_decode, layer 0, {tuple(q.shape)} float32: "
        f"max_abs_err {float(err.max()):.3e}, max |out| "
        f"{float(want.abs().max()):.4f}, largest error over {MLSTM_TOL:g} + "
        f"{MLSTM_TOL:g} x |out|: {excess:.4f} (bound 1); {card}")
    if not excess <= 1.0:
        failures.append(f"xl (c): mlstm_chunkwise is {excess} x the bound "
                        f"from the recurrence")
    xl["mlstm"] = dict(max_abs_err=float(err.max()), bound_share=excess)
    del x, q, k, v, li, lf, got, want, state
    xl["consistency"] = check_consistency(torch, model, params, xl["rng"],
                                          XL_PROMPT, "xl", card, failures)
    xl["peak"] = torch.cuda.max_memory_allocated()
    del model, params, batch
    torch.cuda.empty_cache()
    out[XL_ARCH] = xl
    t_all = time.perf_counter() - t_start
    log(f"[rec] phase peak memory {max(rg['peak'], xl['peak'])} bytes; "
        f"{t_all:.1f} s ({RG_ARCH} {t_rg:.1f} s, {XL_ARCH} "
        f"{t_all - t_rg:.1f} s); {card}")
    return out


# ---------------------------------------------------------------------------
# phase 13: LM training at full width
# ---------------------------------------------------------------------------

# yi-6b at full width cut to 16 of its 32 layers: with float32 moments all
# 32 layers hold 72.7 GB of params, bf16 grads and moments before any
# activation; 16 layers (3.294 B params) hold 39.5 GB. train_4k's 4096
# positions, 2 of its 256 rows.
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_ROWS = 16, 4096, 2
TRAIN_STEPS = 6          # step 0 warms up, 1-4 are timed, 5 is profiled
RESUME_SEQ, RESUME_STEPS, RESUME_EVERY, RESUME_FAIL = 1024, 6, 4, 5
# The kernel rounds P to bf16 before P.V (at most 2^-9 of a probability);
# the plain forward does not. Both take the same plain backward, so the
# first step's loss and gradients differ only by that rounding carried
# through the layers in bf16. The loss averages 8192 tokens: it moves by
# far less than one rounding of P. The grad norm sums every gradient: one
# bf16 step. A gradient leaf's largest difference is measured against the
# same difference of a plain model of that one rounding (`rounded_p`, the
# plain version with P rounded to bf16 before P.V): the kernel may move a
# leaf at most twice as far from the plain gradients as the model does.
TRAIN_LOSS_TOL = 2 ** -9      # |loss_kernel - loss_torch| / loss_torch
TRAIN_GNORM_TOL = 2 ** -8     # |gnorm_kernel - gnorm_torch| / gnorm_torch
TRAIN_GRAD_RATIO = 2.0        # kernel's leaf difference / the model's
# the plain backward against autograd of the plain forward: both take
# float32 products and round each output to bf16 once, so within one bf16
# step of the output's largest element
BWD_TOL = 2 ** -7
BWD_SEQ = 512            # the shorter sequence of that comparison
# the layer groups stacked along a leading layer dim in a parameter tree
STACKED = ("dense_layers", "moe_layers", "macros")


def grad_norm(grads: dict) -> float:
    return math.sqrt(sum(float(g.float().square().sum()) for g in grads.values()))


def attention_pairs(n: int, window: int = 0) -> int:
    """Unmasked (query, key) pairs of causal attention over n positions,
    a query seeing at most `window` keys (0: every key up to its own)."""
    if not window or window >= n:
        return n * (n + 1) // 2
    return window * (window + 1) // 2 + (n - window) * window


def train_model_flops(model, cfg, b: int, s: int) -> tuple[float, float]:
    """(matrix FLOPs, attention and cell FLOPs) of one training step over
    b x s positions: 3x the forward (forward and backward), no recompute.
    A matrix costs 2 flops a weight a position that passes through it:
    every layer's projections, the router, the routed experts at top_k /
    num_experts of each expert tensor (a shared expert whole), MLA's
    low-rank projections, the RG-LRU's gate matrices and its depthwise
    convolution, the xLSTM cells' projections and the sLSTM's recurrent R;
    the head (every codebook's; the tied embedding's) over the positions
    with a label, the patch projection over the patches, and MTP's
    projection, block and pass through the head over s - 1 positions.
    Norms, biases, the gates' elementwise math, the scans and the
    embedding lookup count nothing. Attention: 2 flops a head dim in q.k
    and 2 in p.v per unmasked (q, k) pair (a window's for local attention;
    MLA's q.k over its nope and rope dims, p.v over v_head_dim); an mLSTM
    head 2e(c + 1) + 4e^2 + 4e a position (the pairs of its chunk of c,
    the read of and update to its e x e state)."""
    from repro_torch.common import tree_paths
    from repro_torch.models.xlstm import CHUNK
    routed = cfg.top_k / cfg.num_experts if cfg.num_experts else 1.0
    mat = cell = 0.0
    for path, d in tree_paths(model.param_defs()):
        stacked = path[0] in STACKED
        layers = d.shape[0] if stacked else 1
        shape = d.shape[1:] if stacked else d.shape
        name = path[-1]
        pos = s - 1 if path[0] == "mtp" else s
        if len(shape) >= 2 and name != "b":
            n = math.prod(shape)
            if path[0] in ("embed", "lm_head"):
                if path[0] == "embed" and not cfg.tie_embeddings:
                    n = 0
                pos = s - cfg.num_patches
            elif path[0] == "patch_proj":
                pos = cfg.num_patches
            if name in ("w_gate", "w_up", "w_down") and len(shape) == 3:
                n *= routed
            mat += 2 * n * b * pos * layers
        if name in ("wq", "q_b"):
            h, e = shape[-2], shape[-1]
            if cfg.family == "ssm":
                cell += layers * b * pos * h * (2 * e * (CHUNK + 1)
                                                + 4 * e * e + 4 * e)
            elif name == "q_b":
                cell += layers * 2 * b * h * (e + cfg.v_head_dim) * \
                    attention_pairs(pos)
            else:
                cell += layers * 4 * b * h * e * attention_pairs(
                    pos, cfg.window_size)
    if cfg.mtp_depth:
        mat += 2 * cfg.d_model * cfg.vocab_size * b * (s - 1)
    return 3.0 * mat, 3.0 * cell


def rounded_p(torch, fa):
    """flash_attention_plain with the one rounding the kernel adds: the
    unnormalised probabilities rounded to bf16 before P.V, the row sums
    taken from the float32 ones (measurement only)."""
    def plain(q, k, v, causal=True, scale=None):
        b, sq, h, e = q.shape
        skv, g = k.shape[1], k.shape[2]
        s = torch.einsum("bqgre,bkge->bgrqk",
                         q.reshape(b, sq, g, h // g, e).float(), k.float())
        s.mul_(scale or e ** -0.5)
        if causal:
            keep = torch.ones((sq, skv), dtype=torch.bool,
                              device=q.device).tril(skv - sq)
            s.masked_fill_(~keep, fa.NEG)
        s.sub_(s.amax(-1, keepdim=True)).exp_()
        l = s.sum(-1, keepdim=True)
        o = torch.einsum("bgrqk,bkge->bgrqe", s.bfloat16().float(), v.float())
        o = (o / l).permute(0, 3, 1, 2, 4)
        return o.reshape(b, sq, h, e).to(q.dtype)
    return plain


TRAIN_RANGES = ("flash_attention_backward", "softmax_xent_chunked",
                "softmax_xent_chunked_backward", "adamw_update")


def train_breakdown(torch, prof, wall_ms: float) -> str:
    """Device time of one profiled step: busy share (kernels only), the
    flash kernel, the GEMMs, and the device spans of the port's
    record_function ranges (the attention backward, the cross-entropy and
    AdamW, GEMMs inside included), which the profiler lists beside the
    kernels."""
    import re
    dev = device_totals(torch, prof)
    spans = {e.key: e.self_device_time_total / 1e3 for e in dev
             if e.key in TRAIN_RANGES}
    kern = [e for e in dev if e.key not in TRAIN_RANGES]
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    flash = sum(e.self_device_time_total for e in kern
                if "flash_attention" in e.key) / 1e3
    gemm = sum(e.self_device_time_total for e in kern
               if re.search(r"gemm|nvjet|xmma|cutlass|sm90_", e.key, re.I)) / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
    return (f"host {wall_ms:.3f} ms (profiler on), device busy {busy:.3f} ms "
            f"({100 * busy / wall_ms:.1f}%, idle {100 * (1 - busy / wall_ms):.1f}%);"
            f" flash_attention wgmma kernel {flash:.3f} ms; GEMM kernels "
            f"{gemm:.3f} ms; device spans of the ranges: "
            + ", ".join(f"{k} {v:.3f} ms ({100 * v / wall_ms:.1f}%)"
                        for k, v in sorted(spans.items()))
            + "; top kernels: " + "; ".join(
                f"{e.key[:50]} {e.self_device_time_total / 1e3:.3f} ms "
                f"x{e.count}" for e in top))


def grads_by_path(model, params, batch):
    from repro_torch.common import tree_paths
    from repro_torch.models import loss_and_grads
    loss, metrics, grads = loss_and_grads(model, params, batch)
    return loss, dict(tree_paths(grads)), metrics


def run_trainer(torch, cfg, shape, seed: int, steps: int, tag: str,
                card: str, host_trace: bool = True) -> dict:
    """`cfg` through Trainer.run(steps) on the card (OptConfig(
    warmup_steps=10), no checkpoint written), each step its own counted
    run (the launch counts to 0 just before, read just after), timed from
    the host to a sync, the last one profiled. Returns the steps' records,
    the step median over the timed ones, the leaves that did not move
    (`stuck`; a norm weight at 1.0 is excused while the lrs sum below
    2^-9, half a bf16 step there), peak memory, the profile's breakdown,
    and the parameter count and bytes. Without `host_trace` the profiled
    step is traced on the device only (no host ops, so no ranges)."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.common import param_bytes, param_count, tree_paths
    from repro_torch.kernels import ops
    from repro_torch.optim import OptConfig
    from repro_torch.runtime import Trainer

    tokens = shape.global_batch * shape.seq_len
    recs: list[dict] = []
    init: dict = {}
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                   if host_trace else [ProfilerActivity.CUDA])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as workdir:
        trainer = Trainer(cfg, shape, workdir, OptConfig(warmup_steps=10),
                          ckpt_every=steps + 1, seed=seed)
        inner = trainer.step_fn

        def step_fn(params, opt_state, batch):
            i = len(recs)
            if i == 0:
                init.update((p, t.detach().to("cpu", copy=True))
                            for p, t in tree_paths(params))
            torch.cuda.synchronize()
            ops.reset_launches()         # the main path: counts to 0 just before
            if i == steps - 1:
                prof.start()
            t0 = time.perf_counter()
            out = inner(params, opt_state, batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            if i == steps - 1:
                prof.stop()
            m = out[2]
            rec = dict(ms=ms, launches=ops.launches["flash_attention"],
                       variants=dict(ops.flash_attention_variants),
                       loss=float(m["loss"]), gnorm=float(m["grad_norm"]),
                       lr=float(m["lr"]))
            recs.append(rec)
            role = ("warm-up" if i == 0 else "profiled"
                    if i == steps - 1 else "timed")
            log(f"{tag} step {i} ({role}): {ms:.3f} ms, "
                f"{tokens / (ms / 1e3):.1f} tokens/s, loss {rec['loss']:.6f}, "
                f"grad_norm {rec['gnorm']:.6f}, lr {rec['lr']:.6e}, "
                f"flash_attention launches {rec['launches']} "
                f"{rec['variants']}; {card}")
            return out

        trainer.step_fn = step_fn
        params, _, _ = trainer.run(steps)
        peak = torch.cuda.max_memory_allocated()
        unchanged = {"/".join(p): bool((init[p] == 1).all())
                     for p, t in tree_paths(params)
                     if torch.equal(t.cpu(), init[p])}
        lr_sum = sum(r["lr"] for r in recs)
        stuck = [n for n, ones in unchanged.items()
                 if not (ones and lr_sum < 2 ** -9)]
        n_params, n_bytes = param_count(params), param_bytes(params)
        del trainer, params, inner
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        breakdown = train_breakdown(torch, prof, recs[-1]["ms"])
    except Exception as e:                   # noqa: BLE001 — reported
        breakdown = f"unavailable ({type(e).__name__}: {e})"
    breakdown += f" (the trace took {time.perf_counter() - t0:.1f} s to read)"
    del prof
    return dict(steps=recs, step_ms=statistics.median(
                    r["ms"] for r in recs[1:steps - 1]),
                unchanged=sorted(unchanged), stuck=stuck, n_leaves=len(init),
                lr_sum=lr_sum, peak=peak, breakdown=breakdown,
                n_params=n_params, n_bytes=n_bytes)


def check_steps(run: dict, want_flash: int, what: str,
                failures: list) -> None:
    """Every step launched `want_flash` flash_attention kernels, all wgmma,
    with a finite loss and a finite nonzero grad norm; every leaf moved."""
    want = {"wgmma": want_flash, "simt": 0}
    for i, r in enumerate(run["steps"]):
        if r["launches"] != want_flash or r["variants"] != want:
            failures.append(f"{what} step {i}: flash_attention launches "
                            f"{r['launches']} {r['variants']}, want "
                            f"{want_flash}, all wgmma")
        if not (math.isfinite(r["loss"]) and math.isfinite(r["gnorm"])
                and r["gnorm"] > 0):
            failures.append(f"{what} step {i}: loss {r['loss']}, grad_norm "
                            f"{r['gnorm']}")
    if run["stuck"]:
        failures.append(f"{what}: leaves unchanged: {run['stuck']}")


def attention_gate(torch, cfg, params, batch, tag: str, card: str,
                   failures: list, repeat: bool = False) -> dict:
    """Step 0's loss, grad norm and every gradient leaf with the kernel
    against the plain attention, beside the plain model of the kernel's
    bf16 P (`rounded_p`): TRAIN_LOSS_TOL, TRAIN_GNORM_TOL and each leaf
    within TRAIN_GRAD_RATIO x the model. A MoE model runs the plain
    version and the model under the kernel run's routing (`watch_moe`),
    the router's probabilities held to the same ratio. With `repeat`, the
    kernel run once more, every leaf equal bit for bit (determinism).
    Returns the flash kernel's first call's arguments (layer 0)."""
    import dataclasses

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import build_model, moe

    model = build_model(cfg, "cuda")
    out: dict = {}
    calls = {"route": [], "dropped": []}

    def kernel_run():
        restore = watch_moe(torch, moe, calls)
        try:
            out["run"] = grads_by_path(model, params, batch)
        finally:
            restore()

    x = first_call_args(ops, "flash_attention", kernel_run)
    loss_k, g_k, _ = out.pop("run")
    if repeat:
        _, again, _ = grads_by_path(model, params, batch)
        differ = [p for p in g_k if not torch.equal(g_k[p], again[p])]
        del again
        log(f"{tag} determinism: gradient leaves that differ between two "
            f"identical kernel runs under use_deterministic_algorithms("
            f"{torch.are_deterministic_algorithms_enabled()}): "
            f"{['/'.join(p) for p in differ] or 'none'} of {len(g_k)}; {card}")
        if differ or not torch.are_deterministic_algorithms_enabled():
            failures.append(f"{tag} gradients not reproducible under "
                            f"deterministic algorithms: {differ}")
    model_t = build_model(dataclasses.replace(cfg, attention_impl="torch"),
                          "cuda")
    routes = {"kernel": calls["route"]}

    def plain_run(name, rounded):
        got = {"route": [], "dropped": []}
        restore = watch_moe(torch, moe, got,
                            routes["kernel"] if cfg.num_experts else None)
        plain = fa.flash_attention_plain
        if rounded:
            fa.flash_attention_plain = rounded_p(torch, fa)
        try:
            res = grads_by_path(model_t, params, batch)
        finally:
            fa.flash_attention_plain = plain
            restore()
        routes[name] = got["route"]
        return res

    loss_t, g_t, _ = plain_run("torch", False)
    loss_r, g_r, _ = plain_run("model", True)
    n_k, n_t = grad_norm(g_k), grad_norm(g_t)
    d_loss = abs(float(loss_k) - float(loss_t)) / abs(float(loss_t))
    d_norm = abs(n_k - n_t) / n_t

    def leaf_diff(g):
        return {"/".join(p): float((g[p].float() - g_t[p].float()).abs().max())
                / float(g_t[p].float().abs().max()) for p in g_t}
    worst, model_worst = leaf_diff(g_k), leaf_diff(g_r)
    log(f"{tag} kernel vs torch, step 0"
        + (" (under the kernel run's routing)" if cfg.num_experts else "")
        + f": loss {float(loss_k):.6f} / {float(loss_t):.6f} (rel "
        f"{d_loss:.3e}, bound {TRAIN_LOSS_TOL:.3e}); grad_norm {n_k:.6f} / "
        f"{n_t:.6f} (rel {d_norm:.3e}, bound {TRAIN_GNORM_TOL:.3e}); the "
        f"plain model of the kernel's bf16 P: loss {float(loss_r):.6f}, "
        f"grad_norm {grad_norm(g_r):.6f}; max|dgrad| / max|grad| by leaf, "
        f"kernel / model (bound {TRAIN_GRAD_RATIO} x model): " + ", ".join(
            f"{k} {v:.3e} / {model_worst[k]:.3e}" for k, v in worst.items())
        + f"; {card}")
    if not d_loss <= TRAIN_LOSS_TOL:
        failures.append(f"{tag} kernel and torch losses differ by {d_loss}")
    if not d_norm <= TRAIN_GNORM_TOL:
        failures.append(f"{tag} kernel and torch grad norms differ by {d_norm}")
    for k, v in worst.items():
        if not v <= TRAIN_GRAD_RATIO * model_worst[k]:
            failures.append(f"{tag} kernel and torch {k} gradients differ "
                            f"by {v} of the largest, the model by "
                            f"{model_worst[k]}")
    if cfg.num_experts:
        dp = {name: max(float((p_o - p_t).abs().max()) for (_, p_o), (_, p_t)
                        in zip(routes[name], routes["torch"]))
              for name in ("kernel", "model")}
        log(f"{tag} router probabilities under the kernel run's routing "
            f"({len(routes['kernel'])} router calls, the recompute's too): "
            f"max|dp| against the plain run: kernel {dp['kernel']:.3e}, model "
            f"{dp['model']:.3e} (bound {MOE_MODEL_RATIO} x model); {card}")
        if not dp["kernel"] <= MOE_MODEL_RATIO * dp["model"]:
            failures.append(f"{tag} the kernel moves the router's "
                            f"probabilities by {dp['kernel']}, the model of "
                            f"its rounding by {dp['model']}")
    del g_k, g_t, g_r, model_t, routes, calls
    return {k: v.detach() if isinstance(v, torch.Tensor) else v
            for k, v in x.items()}


def time_training_attention(torch, x: dict, label: str, card: str,
                            seed: int, step_tol: bool = False) -> dict:
    """The kernel at layer 0's training (q, k, v) beside SDPA and the plain
    version (`step_tol` as `time_flash_attention` takes it), and the plain
    backward's time there, without the Trainer's deterministic algorithms
    (which fill each new output with NaN and keep SDPA off its cuDNN
    backend)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    torch.use_deterministic_algorithms(False)
    rec = time_flash_attention(torch, ops, x, label, card, step_tol=step_tol)
    q, k, v = x["q"], x["k"], x["v"]
    o = ops.flash_attention(q, k, v, True)
    do = torch.randn(o.shape, device="cuda", dtype=o.dtype,
                     generator=torch.Generator("cuda").manual_seed(seed))
    t_bwd = cuda_ms(torch, lambda: fa.flash_attention_backward_plain(
        q, k, v, o, do, True), iters=3, warmup=1)
    b, s, h, e = q.shape
    bwd_flops = 10 * b * h * e * (s * (s + 1) // 2)   # 5 products, causal
    log(f"[timing] flash_attention_backward_plain at {tuple(q.shape)} k/v "
        f"{tuple(k.shape)} bf16 causal ({label}): {t_bwd:.6f} ms; "
        f"{bwd_flops:.4e} flops of a fused backward ({bwd_flops / BF16_FLOPS * 1e3:.6f}"
        f" ms at the bf16 tensor peak); {card}")
    rec["train_backward_plain_ms"] = t_bwd
    return rec


def crash_resume(torch, cfg, shape, seed: int) -> dict:
    """An uninterrupted Trainer run of RESUME_STEPS steps (a checkpoint
    every RESUME_EVERY) against one killed at RESUME_FAIL and resumed from
    its last checkpoint, in a temporary directory: every parameter and
    moment and the last loss equal bit for bit. Returns the verdict and the
    final trees."""
    import os
    import tempfile

    from repro_torch.checkpoint import latest
    from repro_torch.common import tree_paths
    from repro_torch.optim import OptConfig
    from repro_torch.runtime import SimulatedFailure, Trainer

    opt = OptConfig(warmup_steps=10)
    with tempfile.TemporaryDirectory() as root:
        d1, d2 = os.path.join(root, "a"), os.path.join(root, "b")
        run = lambda d: Trainer(cfg, shape, d, opt, ckpt_every=RESUME_EVERY,
                                seed=seed)
        pa, sa, ma = run(d1).run(RESUME_STEPS)
        shutil.rmtree(d1)
        crashed = run(d2)
        failed = False
        try:
            crashed.run(RESUME_STEPS, fail_at=RESUME_FAIL)
        except SimulatedFailure:
            failed = True
        # the step-4 checkpoint was published before the crash (a process
        # that dies loses only the write in flight); here its writer thread
        # lives on, so wait for it before resuming from it
        crashed.ckpt.wait()
        resumed_from = latest(d2) or "none"
        del crashed
        pb, sb, mb = run(d2).run(RESUME_STEPS)
    same = [torch.equal(a, b) for (_, a), (_, b) in
            zip(tree_paths((pa, sa)), tree_paths((pb, sb)))]
    exact = (failed and all(same) and float(ma["loss"]) == float(mb["loss"])
             and resumed_from.endswith(f"step_{RESUME_EVERY:08d}"))
    del pa, sa
    return dict(exact=exact, failed=failed, same=sum(same), leaves=len(same),
                loss=(float(ma["loss"]), float(mb["loss"])),
                resumed_from=os.path.basename(resumed_from),
                trees={"params": pb, "opt_state": sb})


def run_lm_training(torch, args, card: str, failures: list) -> dict:
    """yi-6b at full width (16 layers) through Trainer.run, each step
    counted and timed; kernel against plain on the first step; the kernel
    and the plain backward at the training shape; a bit-exact crash-resume
    on one full-width layer; the training CLI. Returns the kernel's
    training launches and timing record."""
    import dataclasses
    import os
    import tempfile

    from repro_torch.checkpoint import load, save
    from repro_torch.common import param_bytes, tree_paths
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import batch_for_step
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("yi-6b"), num_layers=TRAIN_LAYERS)
    shape = ShapeConfig("train", TRAIN_SEQ, TRAIN_ROWS, "train")
    tokens = TRAIN_SEQ * TRAIN_ROWS
    dense_flops, attn_flops = train_model_flops(build_model(cfg, "cuda"), cfg,
                                                TRAIN_ROWS, TRAIN_SEQ)
    flops = dense_flops + attn_flops
    run = run_trainer(torch, cfg, shape, args.seed, TRAIN_STEPS, "[train]",
                      card)
    steps, step_ms, peak = run["steps"], run["step_ms"], run["peak"]
    log(f"[train] yi-6b {TRAIN_LAYERS} of 32 layers, d {cfg.d_model}, heads "
        f"{cfg.num_heads}/{cfg.num_kv_heads} x {cfg.resolved_head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, bf16, remat "
        f"{cfg.remat_policy!r}; {run['n_params'] / 1e9:.4f} B params "
        f"({run['n_bytes'] / 1e9:.3f} GB); batch {TRAIN_ROWS} x {TRAIN_SEQ}; step "
        f"{step_ms:.3f} ms (median of steps 1-{TRAIN_STEPS - 2}), "
        f"{tokens / (step_ms / 1e3):.1f} tokens/s; model FLOPs a step "
        f"{flops:.4e} ({dense_flops:.4e} dense + {attn_flops:.4e} attention),"
        f" {flops / (step_ms / 1e3) / 1e12:.1f} TFLOP/s, "
        f"{100 * flops / (step_ms / 1e3) / BF16_FLOPS:.1f}% of "
        f"{BF16_FLOPS / 1e12:.1f}; peak memory {peak} bytes "
        f"({peak / 2 ** 30:.2f} GiB); leaves changed "
        f"{run['n_leaves'] - len(run['unchanged'])}/{run['n_leaves']}; "
        f"unchanged: {run['unchanged']} (norm weights at 1.0: the lrs sum "
        f"to {run['lr_sum']:.2e}, under 2^-9, half a bf16 step there); "
        f"{card}")
    log(f"[train] profile of step {TRAIN_STEPS - 1}: {run['breakdown']}; "
        f"{card}")
    check_steps(run, 2 * TRAIN_LAYERS, "train", failures)
    if len(steps) != TRAIN_STEPS:
        failures.append(f"train: {len(steps)} steps")

    # kernel against plain on the first step's weights and batch
    params = build_model(cfg, "cuda").init_params(args.seed)
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in
             batch_for_step(cfg, shape, 0, args.seed).items()}
    x = attention_gate(torch, cfg, params, batch, "[train]", card, failures)
    del params, batch
    torch.cuda.empty_cache()
    kernel = time_training_attention(torch, x, "yi-6b training layer 0", card,
                                     args.seed)
    # the plain backward held against autograd of the plain forward, on a
    # shorter sequence
    q, k, v = x["q"], x["k"], x["v"]
    do = torch.randn(q.shape, device="cuda", dtype=q.dtype,
                     generator=torch.Generator("cuda").manual_seed(args.seed))
    qs, ks, vs, dos = (t[:1, :BWD_SEQ].contiguous() for t in (q, k, v, do))
    got = fa.flash_attention_backward_plain(
        qs, ks, vs, fa.flash_attention_plain(qs, ks, vs), dos)
    leaves = [t.clone().requires_grad_() for t in (qs, ks, vs)]
    fa.flash_attention_plain(*leaves).backward(dos)
    bwd_err = max(float((a.float() - w.grad.float()).abs().max())
                  / float(w.grad.float().abs().max())
                  for a, w in zip(got, leaves))
    log(f"[train] flash_attention_backward_plain vs autograd of the plain "
        f"forward at q {tuple(qs.shape)}: max|d| / max|grad| {bwd_err:.3e} "
        f"(bound {BWD_TOL:.3e}); {card}")
    if not bwd_err <= BWD_TOL:
        failures.append(f"train: the plain backward differs from autograd "
                        f"by {bwd_err} of the largest gradient")
    del x, q, k, v, do, got, leaves
    torch.cuda.empty_cache()

    # determinism, then a bit-exact crash-resume on one full-width layer
    one = dataclasses.replace(cfg, num_layers=1)
    rshape = ShapeConfig("resume", RESUME_SEQ, 1, "train")
    m1 = build_model(one, "cuda")
    p1 = m1.init_params(args.seed)
    b1 = {k: torch.from_numpy(v).to("cuda") for k, v in
          batch_for_step(one, rshape, 0, args.seed).items()}
    for flag in (False, True):
        torch.use_deterministic_algorithms(flag)
        _, ga, _ = grads_by_path(m1, p1, b1)
        _, gb, _ = grads_by_path(m1, p1, b1)
        differ = ["/".join(p) for p in ga if not torch.equal(ga[p], gb[p])]
        log(f"[train] determinism: use_deterministic_algorithms({flag}): "
            f"gradient leaves that differ between two identical steps: "
            f"{differ or 'none'}; {card}")
        if flag and differ:
            failures.append(f"train: gradients not reproducible under "
                            f"deterministic algorithms: {differ}")
    del m1, p1, b1, ga, gb
    res = crash_resume(torch, one, rshape, args.seed)
    trees = res.pop("trees")
    nbytes = param_bytes(trees)
    with tempfile.TemporaryDirectory() as root:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save(os.path.join(root, "c"), RESUME_STEPS, trees)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, back = load(path, trees)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        roundtrip = all(torch.equal(a, b) for (_, a), (_, b) in
                        zip(tree_paths(trees), tree_paths(back)))
    log(f"[train] crash-resume (1 layer at full width and vocab, 1 x "
        f"{RESUME_SEQ}, {RESUME_STEPS} steps, checkpoint every "
        f"{RESUME_EVERY}, killed at step {RESUME_FAIL}, resumed from "
        f"{res['resumed_from']}): bit-exact {res['exact']} "
        f"({res['same']}/{res['leaves']} leaves equal, loss "
        f"{res['loss'][0]:.6f} / {res['loss'][1]:.6f}); a checkpoint of "
        f"{nbytes} bytes: write {t_save:.3f} s ({nbytes / t_save / 1e9:.3f} "
        f"GB/s), load {t_load:.3f} s ({nbytes / t_load / 1e9:.3f} GB/s), "
        f"round trip exact {roundtrip}; {card}")
    if not (res["exact"] and roundtrip):
        failures.append(f"train: crash-resume bit-exact {res['exact']} "
                        f"(injected failure raised: {res['failed']}), "
                        f"checkpoint round trip exact {roundtrip}")
    del trees, back
    torch.cuda.empty_cache()

    # the training CLI, as a user runs it
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             "yi-6b", "--smoke", "--steps", "3", "--workdir", workdir],
            env=dict(os.environ, PYTHONPATH=str(SRC)), capture_output=True,
            text=True, timeout=600)
    log(f"[train] python -m repro_torch.launch.train --arch yi-6b --smoke "
        f"--steps 3: rc {out.returncode}, {time.perf_counter() - t0:.1f} s: "
        + " | ".join(out.stdout.strip().splitlines()[-3:]))
    if out.returncode != 0 or "done on cuda" not in out.stdout:
        failures.append(f"train CLI: rc {out.returncode}\n{out.stdout}\n"
                        f"{out.stderr}")
    kernel["train_launches"] = sum(r["launches"] for r in steps)
    kernel["train_step_ms"] = step_ms
    return kernel


# ---------------------------------------------------------------------------
# phase 14: every LM family trained at full width
# ---------------------------------------------------------------------------

# (arch, overrides, rows, positions) in the order the phase runs them:
# each family at its full published width, its depth cut so that its
# parameters, bf16 gradients and float32 moments (12 bytes a parameter)
# fit the card beside the activations. pixtral's 4096 positions are its
# 256 patches and 3840 text tokens; musicgen's 4096 frames hold 4
# codebooks; dbrx runs its serving cut's 2048 positions; recurrentgemma
# one macro (2 RG-LRU blocks and 1 local attention); xlstm whole at its
# training context. deepseek-v3 keeps 1 of its 3 dense layers and the MTP
# module, whose MoE block alone is 11.61 B parameters: float32 moments for
# it would add 93 GB (bf16 ones 46 GB) to the 56.2 GB of parameters and
# gradients, so it runs loss_and_grads only.
FAMILY_TRAIN = (
    ("qwen3-8b", dict(num_layers=2), 2, 4096),
    ("deepseek-7b", dict(num_layers=2), 2, 4096),
    ("yi-34b", dict(num_layers=2), 2, 4096),
    ("pixtral-12b", dict(num_layers=2), 2, 4096),
    ("musicgen-large", dict(num_layers=4), 2, 4096),
    ("dbrx-132b", dict(num_layers=1), 2, 2048),
    ("recurrentgemma-9b", dict(num_layers=3), 2, 4096),
    ("xlstm-125m", {}, 2, 2048),
    ("deepseek-v3-671b", dict(num_layers=1, first_dense_layers=1), 1, 4096),
)
FAMILY_STEPS = 4         # step 0 warms up, 1-2 are timed, 3 is profiled
XL_RESUME_SEQ = 128      # xlstm's crash-resume: 1 x 128 positions
# recurrentgemma and xlstm launch no kernel: their step 0 in bf16 is held
# against float32 at the same weights upcast (TF32 off)
REC_LOSS_TOL = 1e-2      # |loss_bf16 - loss_f32| / loss_f32
REC_GRAD_COS = 0.99      # cosine of the whole flattened gradients, at least
# xlstm's step-0 gradients at 2 x 2048 are too ill-conditioned for that
# comparison: float32 at its weights perturbed by one bf16 rounding lands
# at cosine 0.18 from float32 at the weights themselves on an H100 (0.82
# at 2 x 256; 0.99998 at a perturbation of 1e-6), and the JAX package's
# model does the same at a reduced width on the CPU
# (scripts/xlstm_grad_conditioning.py). There the bf16 comparison and that
# perturbation are reported, and the bounds hold the card's float32 loss
# and gradients against the CPU's on the batch's first XL_CPU_SEQ
# positions of its first sequence.
XL_CONDITION = 2 ** -9
XL_CPU_SEQ = 512
# deepseek-v3: one SGD step p -= eta g on the bf16 weights, eta = SGD_SHARE
# x loss / |g|^2 (a first-order decrease of SGD_SHARE of the loss), must
# lower the loss on the same batch by at least half of eta |g|^2. At 14 B
# parameters eta g is ~2e-7 an element against a bf16 half-step of ~4e-5
# at a weight of 0.02, so rounding to nearest drops almost every update;
# the step rounds each weight stochastically (up with the probability of
# its remainder), which keeps the update's expectation
SGD_SHARE = 1e-2


def family_line(cfg, full, rows: int, seq: int) -> str:
    return (f"{cfg.family}, {cfg.num_layers} of {full.num_layers} layers"
            + (f" ({cfg.first_dense_layers} dense)" if cfg.num_experts else "")
            + f", d {cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads}"
            + (f", {cfg.num_experts} experts top-{cfg.top_k}"
               if cfg.num_experts else "")
            + (", MLA" if cfg.use_mla else "")
            + (f", MTP {cfg.mtp_depth}" if cfg.mtp_depth else "")
            + (", qk-norm" if cfg.qk_norm else "")
            + (f", {cfg.num_patches} patches" if cfg.num_patches else "")
            + (f", {cfg.num_codebooks} codebooks" if cfg.num_codebooks else "")
            + (f", window {cfg.window_size}" if cfg.window_size else "")
            + f", vocab {cfg.vocab_size}, bf16, remat {cfg.remat_policy!r}; "
            f"batch {rows} x {seq}")


def compare_grads(torch, loss_a, g_a: dict, loss_b, g_b: dict):
    """(|loss_a - loss_b| / |loss_b|, the cosine of the whole flattened
    gradients, |g_a|, |g_b|, {leaf: max|d| / max|g_b|}), g_b the
    yardstick; leaf by leaf in float32 on g_b's device."""
    dot = na = nb = 0.0
    share = {}
    for p, gb in g_b.items():
        ga, gb = g_a[p].to(gb.device).float(), gb.float()
        dot += float(torch.dot(ga.flatten(), gb.flatten()))
        na += float(ga.square().sum())
        nb += float(gb.square().sum())
        share["/".join(p)] = float((ga - gb).abs().max()) / max(
            float(gb.abs().max()), 1e-30)
    d_loss = abs(float(loss_a) - float(loss_b)) / abs(float(loss_b))
    return d_loss, dot / math.sqrt(na * nb), math.sqrt(na), math.sqrt(nb), share


def float32_gate(torch, cfg, params, batch, tag: str, card: str,
                 failures: list) -> None:
    """Step 0 in bf16 (twice: every leaf equal bit for bit, the
    determinism gate) against float32 at the same weights upcast: the loss
    within REC_LOSS_TOL, the cosine of the whole flattened gradients at
    least REC_GRAD_COS, each leaf's max|d| / max|grad| printed. For xlstm
    the gradients' cosine is reported beside float32 at weights perturbed
    by one bf16 rounding (XL_CONDITION), and the bounds hold the card's
    float32 run against the CPU's on XL_CPU_SEQ positions instead."""
    import dataclasses

    from repro_torch.common import tree_map_with_path
    from repro_torch.models import build_model

    model = build_model(cfg, "cuda")
    loss_b, g_b, _ = grads_by_path(model, params, batch)
    _, again, _ = grads_by_path(model, params, batch)
    differ = ["/".join(p) for p in g_b if not torch.equal(g_b[p], again[p])]
    del again
    log(f"{tag} determinism: gradient leaves that differ between two "
        f"identical runs under use_deterministic_algorithms("
        f"{torch.are_deterministic_algorithms_enabled()}): {differ or 'none'}"
        f" of {len(g_b)}; {card}")
    if differ or not torch.are_deterministic_algorithms_enabled():
        failures.append(f"{tag} gradients not reproducible under "
                        f"deterministic algorithms: {differ}")
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                activation_dtype="float32")
    m32 = build_model(cfg32, "cuda")
    p32 = tree_map_with_path(lambda _, t: t.float(), params)
    loss_f, g_f, _ = grads_by_path(m32, p32, batch)
    d_loss, cos, nb, nf, share = compare_grads(torch, loss_b, g_b, loss_f, g_f)
    gated = cfg.family != "ssm"
    log(f"{tag} bf16 vs float32 at the same weights, step 0: loss "
        f"{float(loss_b):.6f} / {float(loss_f):.6f} (rel {d_loss:.3e}, bound "
        f"{REC_LOSS_TOL:.0e}); grad norm {nb:.6f} / {nf:.6f}; cosine of the "
        f"flattened gradients {cos:.6f} ("
        + (f"bound >= {REC_GRAD_COS}" if gated else "reported: see below")
        + "); max|d| / max|grad| by leaf: " + ", ".join(
            f"{k} {v:.3e}" for k, v in share.items()) + f"; {card}")
    if not d_loss <= REC_LOSS_TOL:
        failures.append(f"{tag} bf16 and float32 losses differ by {d_loss}")
    if gated and not cos >= REC_GRAD_COS:
        failures.append(f"{tag} bf16 and float32 gradients: cosine {cos}")
    del g_b
    if gated:
        return
    gen = torch.Generator("cuda").manual_seed(1)
    shifted = tree_map_with_path(lambda _, t: t * (1 + XL_CONDITION * torch.randn(
        t.shape, device=t.device, generator=gen)), p32)
    loss_s, g_s, _ = grads_by_path(m32, shifted, batch)
    _, cos_s, _, _, _ = compare_grads(torch, loss_s, g_s, loss_f, g_f)
    del shifted, g_s, g_f
    sub = {k: v[:1, :XL_CPU_SEQ] for k, v in batch.items()}
    loss_c, g_c, _ = grads_by_path(m32, p32, sub)
    loss_h, g_h, _ = grads_by_path(
        build_model(cfg32, "cpu"),
        tree_map_with_path(lambda _, t: t.cpu(), p32),
        {k: v.cpu() for k, v in sub.items()})
    d_h, cos_h, nc, nh, share_h = compare_grads(torch, loss_c, g_c, loss_h, g_h)
    log(f"{tag} the float32 gradients are ill-conditioned at this length: "
        f"float32 at the weights perturbed by {XL_CONDITION:.3e} (one bf16 "
        f"rounding) lands at cosine {cos_s:.6f} from float32 at the weights "
        f"(bf16 at {cos:.6f}), so the bounds hold the card's float32 run "
        f"against the CPU's on 1 x {XL_CPU_SEQ} positions: loss "
        f"{float(loss_c):.6f} / {float(loss_h):.6f} (rel {d_h:.3e}, bound "
        f"{REC_LOSS_TOL:.0e}); grad norm {nc:.6f} / {nh:.6f}; cosine {cos_h:.9f}"
        f" (bound >= {REC_GRAD_COS}); max|d| / max|grad| by leaf, largest: "
        f"{max(share_h.values()):.3e}; {card}")
    if not d_h <= REC_LOSS_TOL:
        failures.append(f"{tag} card and CPU float32 losses differ by {d_h}")
    if not cos_h >= REC_GRAD_COS:
        failures.append(f"{tag} card and CPU float32 gradients: cosine {cos_h}")


def train_family(torch, args, arch: str, over: dict, rows: int, seq: int,
                 card: str, failures: list) -> dict:
    """(a) Trainer.run(FAMILY_STEPS) (`run_trainer`) with the flash launches
    a step; (b) step 0's gate: the kernel against the plain attention for
    the GQA families (`attention_gate`), bf16 against float32 for the
    recurrent ones (`float32_gate`); (c) determinism, inside both; for the
    GQA families the kernel timed at layer 0's training (q, k, v)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import batch_for_step
    from repro_torch.models import build_model

    t_start = time.perf_counter()
    full = get_config(arch)
    cfg = dataclasses.replace(full, **over)
    shape = ShapeConfig("train", seq, rows, "train")
    tag = f"[train-fam {arch}]"
    gqa = cfg.family not in ("hybrid", "ssm")
    layers = cfg.num_layers
    mat, cell = train_model_flops(build_model(cfg, "cuda"), cfg, rows, seq)
    flops = mat + cell
    # xlstm's sLSTM loop launches ~330,000 kernels a step: a host trace of
    # them takes minutes to read, so its step is traced on the device only
    run = run_trainer(torch, cfg, shape, args.seed, FAMILY_STEPS, tag, card,
                      host_trace=cfg.family != "ssm")
    t_a = time.perf_counter() - t_start
    step_ms, tokens = run["step_ms"], rows * seq
    launches = [r["launches"] for r in run["steps"]]
    log(f"{tag} {family_line(cfg, full, rows, seq)}; "
        f"{run['n_params'] / 1e9:.4f} B params ({run['n_bytes'] / 1e9:.3f} GB "
        f"bf16); step {step_ms:.3f} ms (median of steps 1-"
        f"{FAMILY_STEPS - 2}), {tokens / (step_ms / 1e3):.1f} tokens/s; model "
        f"FLOPs a step {flops:.4e} ({mat:.4e} matrices + {cell:.4e} attention "
        f"and cells), {flops / (step_ms / 1e3) / 1e12:.1f} TFLOP/s, "
        f"{100 * flops / (step_ms / 1e3) / BF16_FLOPS:.2f}% of "
        f"{BF16_FLOPS / 1e12:.1f}; peak memory {run['peak']} bytes "
        f"({run['peak'] / 2 ** 30:.2f} GiB); flash_attention launches a step "
        f"{launches} (want {2 * layers if gqa else 0}); leaves changed "
        f"{run['n_leaves'] - len(run['unchanged'])}/{run['n_leaves']}, "
        f"unchanged {run['unchanged']} (lrs sum {run['lr_sum']:.2e}); {card}")
    log(f"{tag} profile of step {FAMILY_STEPS - 1}: {run['breakdown']}; "
        f"{card}")
    check_steps(run, 2 * layers if gqa else 0, tag, failures)

    params = build_model(cfg, "cuda").init_params(args.seed)
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in
             batch_for_step(cfg, shape, 0, args.seed).items()}
    torch.use_deterministic_algorithms(True)     # as the Trainer runs
    rec = None
    if gqa:
        x = attention_gate(torch, cfg, params, batch, tag, card, failures,
                           repeat=True)
        del params, batch
        torch.cuda.empty_cache()
        # the families' outputs reach 4 and more, where bf16 steps by 2^-5:
        # phase 10's rule at their prefill shapes (`step_tol`)
        rec = time_training_attention(torch, x, f"{arch} training layer 0",
                                      card, args.seed, step_tol=True)
        del x
    else:
        float32_gate(torch, cfg, params, batch, tag, card, failures)
        del params, batch
    torch.cuda.empty_cache()
    t_b = time.perf_counter() - t_start - t_a
    if arch == "xlstm-125m":
        rshape = ShapeConfig("resume", XL_RESUME_SEQ, 1, "train")
        res = crash_resume(torch, cfg, rshape, args.seed)
        log(f"{tag} crash-resume (whole, 1 x {XL_RESUME_SEQ}, {RESUME_STEPS}"
            f" steps, checkpoint every {RESUME_EVERY}, killed at step "
            f"{RESUME_FAIL}, resumed from {res['resumed_from']}): bit-exact "
            f"{res['exact']} ({res['same']}/{res['leaves']} leaves equal, loss "
            f"{res['loss'][0]:.6f} / {res['loss'][1]:.6f}); {card}")
        if not res["exact"]:
            failures.append(f"{tag} crash-resume bit-exact {res['exact']} "
                            f"(injected failure raised: {res['failed']})")
        del res
        torch.cuda.empty_cache()
    log(f"{tag} {time.perf_counter() - t_start:.1f} s ((a) {t_a:.1f} s, "
        f"(b), (c) and the timings {t_b:.1f} s)")
    return dict(kernel=rec, launches=sum(launches), step_ms=step_ms,
                peak=run["peak"])


def stochastic_bf16(torch, x, gen):
    """float32 `x` rounded to bf16 up or down with the probabilities that
    keep its expectation: uniform bits added below the bf16 mantissa, then
    cut off."""
    bits = x.view(torch.int32)
    noise = torch.randint(0, 1 << 16, x.shape, dtype=torch.int32,
                          device=x.device, generator=gen)
    return ((bits + noise) & -(1 << 16)).view(torch.float32).to(torch.bfloat16)


def train_deepseek(torch, args, arch: str, over: dict, rows: int, seq: int,
                   card: str, failures: list) -> dict:
    """deepseek-v3's loss_and_grads under deterministic algorithms, twice
    (every leaf equal bit for bit: the first run's gradients are held on
    the host, two trees do not fit the card); loss = ce + router_aux_weight
    aux + 0.1 mtp_ce; every leaf finite, every leaf of the `mtp` subtree
    nonzero; no kernel launched; one SGD step of eta = SGD_SHARE x loss /
    |g|^2 on the bf16 weights lowers the loss on the same batch by at least
    half of eta |g|^2."""
    import dataclasses

    from repro_torch.common import param_bytes, param_count
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import batch_for_step
    from repro_torch.kernels import ops
    from repro_torch.models import build_model

    t_start = time.perf_counter()
    full = get_config(arch)
    cfg = dataclasses.replace(full, **over)
    shape = ShapeConfig("train", seq, rows, "train")
    tag = f"[train-fam {arch}]"
    torch.use_deterministic_algorithms(True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, "cuda")
    params = model.init_params(args.seed)
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in
             batch_for_step(cfg, shape, 0, args.seed).items()}
    mat, cell = train_model_flops(model, cfg, rows, seq)
    times = []

    def timed():
        torch.cuda.empty_cache()      # two 56 GB trees in turn: no fragments
        torch.cuda.synchronize()
        ops.reset_launches()          # the main path: counts to 0 just before
        t0 = time.perf_counter()
        out = grads_by_path(model, params, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        return out, dict(ops.launches)

    (loss, g, met), launched = timed()
    after_grads = torch.cuda.memory_allocated()

    def chunks(t):          # no leaf-sized temporary: the card is nearly full
        return t.reshape(-1).split(1 << 26)
    finite = [p for p, t in g.items()
              if not all(bool(torch.isfinite(c).all()) for c in chunks(t))]
    zero_mtp = [p for p, t in g.items() if p[0] == "mtp"
                and not any(bool((c != 0).any()) for c in chunks(t))]
    n_mtp = sum(1 for p in g if p[0] == "mtp")
    g2sum = sum(float(c.float().square().sum()) for t in g.values()
                for c in chunks(t))
    n_leaves = len(g)
    host = {p: t.to("cpu", copy=True) for p, t in g.items()}
    del g
    (loss2, g, _), launched2 = timed()
    differ = [p for p, t in g.items() if not torch.equal(t.cpu(), host[p])]
    del host
    parts = (met["ce"] + cfg.router_aux_weight * met["aux"]) \
        + 0.1 * met["mtp_ce"]
    composed = abs(float(parts) - float(loss)) <= 2 ** -20 * abs(float(loss))
    eta = SGD_SHARE * float(loss) / g2sum
    gen = torch.Generator("cuda").manual_seed(args.seed)
    with torch.no_grad():
        for p, t in g.items():
            leaf = params
            for k in p:
                leaf = leaf[k]
            for pc, gc in zip(chunks(leaf), chunks(t)):
                pc.copy_(stochastic_bf16(torch, pc.float() - eta * gc.float(),
                                         gen))
        del g
        after, _ = model.loss(params, batch)
    drop, want = float(loss) - float(after), 0.5 * eta * g2sum
    peak = torch.cuda.max_memory_allocated()
    n_params, n_bytes = param_count(params), param_bytes(params)
    ms = times[-1]
    log(f"{tag} {family_line(cfg, full, rows, seq)}; {n_params / 1e9:.4f} B "
        f"params ({n_bytes / 1e9:.3f} GB bf16, {n_mtp} leaves under mtp); "
        f"loss_and_grads only (no optimizer step: float32 moments for the "
        f"MTP's MoE block alone would add 93 GB); {times[0]:.3f} ms first, "
        f"{ms:.3f} ms second, {rows * seq / (ms / 1e3):.1f} tokens/s, model "
        f"FLOPs {mat + cell:.4e} ({mat:.4e} matrices + {cell:.4e} attention),"
        f" {100 * (mat + cell) / (ms / 1e3) / BF16_FLOPS:.2f}% of "
        f"{BF16_FLOPS / 1e12:.1f}; kernel launches {launched} / {launched2}; "
        f"peak memory {peak} bytes ({peak / 2 ** 30:.2f} GiB), {after_grads} "
        f"bytes held beside the first gradients; {card}")
    log(f"{tag} loss {float(loss):.6f} = ce {float(met['ce']):.6f} + "
        f"{cfg.router_aux_weight} x aux {float(met['aux']):.6f} + 0.1 x "
        f"mtp_ce {float(met['mtp_ce']):.6f}: {composed}; second run's loss "
        f"{float(loss2):.6f}; leaves not finite {finite or 'none'}; mtp "
        f"leaves with a zero gradient {zero_mtp or 'none'} of {n_mtp}; "
        f"determinism: leaves that differ between the two runs "
        f"{['/'.join(p) for p in differ] or 'none'} of {n_leaves}; "
        f"|g|^2 {g2sum:.6e}; SGD step (stochastic rounding) eta {eta:.6e}: loss {float(loss):.6f} "
        f"-> {float(after):.6f}, decrease {drop:.6e} (bound >= 0.5 eta |g|^2"
        f" = {want:.6e}); {card}")
    if not composed:
        failures.append(f"{tag} loss {float(loss)} is not ce + aux + mtp_ce "
                        f"({float(parts)})")
    if finite or zero_mtp:
        failures.append(f"{tag} leaves not finite {finite}, mtp leaves with "
                        f"a zero gradient {zero_mtp}")
    if differ or float(loss2) != float(loss):
        failures.append(f"{tag} gradients not reproducible under "
                        f"deterministic algorithms: {differ}")
    if launched["flash_attention"] or launched2["flash_attention"]:
        failures.append(f"{tag} launched flash_attention: {launched}")
    if not drop >= want:
        failures.append(f"{tag} the SGD step lowered the loss by {drop}, "
                        f"want at least {want}")
    del params, batch, model
    torch.cuda.empty_cache()
    log(f"{tag} {time.perf_counter() - t_start:.1f} s")
    return dict(kernel=None, launches=launched["flash_attention"],
                step_ms=ms, peak=peak)


def run_lm_family_training(torch, args, card: str, failures: list) -> dict:
    """Every FAMILY_TRAIN config through `train_family` (deepseek-v3
    through `train_deepseek`), freeing each model before the next; a
    config that fails is reported and the next runs."""
    out = {}
    for arch, over, rows, seq in FAMILY_TRAIN:
        run = train_deepseek if arch == MLA_ARCH else train_family
        try:
            out[arch] = run(torch, args, arch, over, rows, seq, card, failures)
        except Exception:
            failures.append(f"phase LM family training, {arch}:\n"
                            f"{traceback.format_exc()}")
        torch.cuda.empty_cache()
    torch.use_deterministic_algorithms(False)
    return out


# ---------------------------------------------------------------------------
# phase 15: sharding and launch
# ---------------------------------------------------------------------------

SHARD_ARCH = "qwen3-8b"        # embedding_impl="mapsin", vocab 151,936
EMBED_SHARDS = 8               # (a): LocalMesh(8) on `model`
MESH_PREFILL_LAYERS = 4        # (b): 4 x 4000 positions (LM_BATCH, LM_PROMPT)
MESH_TRAIN_LAYERS, MESH_TRAIN_ROWS, MESH_TRAIN_SEQ = 2, 2, 4096   # (c)
MESH_TRAIN_STEPS = 3
ELASTIC_SHARDS, ELASTIC_MODEL = 8, 4   # (d): make_mesh_for(8, model_par=4)


def trees_equal(torch, a, b) -> list:
    """The paths at which two trees of tensors differ (bit for bit)."""
    from repro_torch.common import tree_paths
    return ["/".join(p) for (p, x), (_, y) in zip(tree_paths(a), tree_paths(b))
            if not torch.equal(x, y)]


class model_axis_runs:
    """Counts, while open, the LocalMesh runs over a `model` axis: the
    shard bodies of mapsin_embed's vocab-sharded lookup (``calls``)."""

    def __enter__(self):
        from repro_torch.core import collectives

        self.calls, real = 0, collectives.LocalMesh.run
        self._cls, self._real = collectives.LocalMesh, real

        def run(mesh, body):
            self.calls += "model" in mesh.axis_names
            return real(mesh, body)
        collectives.LocalMesh.run = run
        return self

    def __exit__(self, *exc):
        self._cls.run = self._real


def check_mapsin_embed(torch, args, card: str, failures: list) -> dict:
    """(a): qwen3-8b's table over LocalMesh(8) on `model` against the dense
    gather, bit for bit; both timed from the host to a sync; the lookup's
    memory beyond its output."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import LocalMesh
    from repro_torch.models.embedding import dense_embed, mapsin_embed

    cfg = get_config(SHARD_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    table = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                        device="cuda").mul_(0.02).to(torch.bfloat16)
    rng = np.random.RandomState(args.seed)
    tok = torch.as_tensor(rng.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT)),
                          dtype=torch.int32, device="cuda")
    mesh = LocalMesh(EMBED_SHARDS, "cuda", axis="model")
    with torch.no_grad():
        dense = dense_embed(table, tok)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = mapsin_embed(table, tok, mesh)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base - \
            got.numel() * got.element_size()
        equal = torch.equal(got, dense)
        del got
        ms_mapsin = wall_ms(torch, lambda: mapsin_embed(table, tok, mesh))
        ms_dense = wall_ms(torch, lambda: dense_embed(table, tok))
    tbytes = table.numel() * table.element_size()
    log(f"[shard] (a) mapsin_embed: {cfg.vocab_size} x {cfg.d_model} bf16 "
        f"table ({tbytes} bytes) over LocalMesh({EMBED_SHARDS}) on model, "
        f"{LM_BATCH} x {LM_PROMPT} ids: equal to dense_embed {equal}; "
        f"{ms_mapsin:.3f} ms against the dense gather's {ms_dense:.3f} ms "
        f"(host clock to a sync, median of 5); memory beyond the output "
        f"{extra} bytes ({extra / 2 ** 30:.3f} GiB); {card}")
    if not equal:
        failures.append("sharding (a): mapsin_embed differs from dense_embed")
    del table, dense
    return dict(ms=ms_mapsin, dense_ms=ms_dense, extra_bytes=extra)


def check_mesh_prefill(torch, args, card: str, failures: list) -> dict:
    """(b): qwen3-8b cut to 4 layers, one 4 x 4000 prefill with the mesh
    and rules and one without, on the same weights (the embedding table
    flagged requires_grad, so that a lookup outside no_grad would record a
    graph): logits equal bit for bit, one wgmma flash launch a layer each
    (the counts to 0 just before each run, read just after), no graph, and
    the sharded lookup run in the mesh run alone."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import build_model, make_prefill_step
    from repro_torch.sharding import make_rules

    cfg = dataclasses.replace(get_config(SHARD_ARCH),
                              num_layers=MESH_PREFILL_LAYERS)
    mesh = make_mesh_for(EMBED_SHARDS, model_par=EMBED_SHARDS, device="cuda")
    rules = make_rules(mesh, cfg)
    plain = build_model(cfg, device="cuda")
    meshed = build_model(cfg, mesh, rules)
    params = plain.init_params(args.seed)
    params["embed"].requires_grad_(True)
    rng = np.random.RandomState(args.seed)
    batch = {"tokens": torch.as_tensor(
        rng.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT)),
        dtype=torch.int32, device="cuda")}
    out, launches, sharded = {}, {}, {}
    with torch.no_grad():
        for name, model in (("mesh", meshed), ("plain", plain)):
            step = make_prefill_step(model)
            torch.cuda.synchronize()
            ops.reset_launches()         # the main path: counts to 0 just before
            with model_axis_runs() as runs:
                logits, cache = step(params, batch)
            torch.cuda.synchronize()
            launches[name] = (ops.launches["flash_attention"],
                              dict(ops.flash_attention_variants))
            sharded[name] = runs.calls
            out[name] = logits
            del cache
        equal = torch.equal(out["mesh"], out["plain"])
        graph = out["mesh"].grad_fn is not None or out["mesh"].requires_grad
        ms = {name: wall_ms(torch, lambda m=m: make_prefill_step(m)(params, batch),
                            runs=3)
              for name, m in (("plain", plain), ("mesh", meshed))}
    want = (MESH_PREFILL_LAYERS, {"wgmma": MESH_PREFILL_LAYERS, "simt": 0})
    log(f"[shard] (b) prefill {SHARD_ARCH} ({MESH_PREFILL_LAYERS} of "
        f"{get_config(SHARD_ARCH).num_layers} layers, {LM_BATCH} x "
        f"{LM_PROMPT}) with {mesh} and rules (kv_mode {rules.kv_mode}) and "
        f"without: logits equal bit for bit {equal}; flash_attention "
        f"launches mesh {launches['mesh']}, plain {launches['plain']}; "
        f"sharded lookups (LocalMesh runs on model) mesh {sharded['mesh']}, "
        f"plain {sharded['plain']}; graph "
        f"recorded under no_grad {graph}; {ms['mesh']:.3f} ms against "
        f"{ms['plain']:.3f} ms (host clock to a sync, median of 3); {card}")
    if not equal:
        failures.append("sharding (b): the mesh prefill's logits differ")
    if launches["mesh"] != want or launches["plain"] != want:
        failures.append(f"sharding (b): flash_attention launches {launches}, "
                        f"want {want} each")
    if graph:
        failures.append("sharding (b): the mesh prefill recorded a graph "
                        "under no_grad")
    if sharded["mesh"] == 0 or sharded["plain"] != 0:
        failures.append(f"sharding (b): sharded lookups {sharded}, want more "
                        f"than 0 on the mesh and 0 without")
    del params, out
    torch.cuda.empty_cache()
    return dict(launches=launches["mesh"][0] + launches["plain"][0], ms=ms)


def check_mesh_training(torch, args, card: str, failures: list) -> dict:
    """(c): qwen3-8b cut to 2 layers, 2 x 4096, through Trainer.run for 3
    steps with the mesh and rules and without: every step's metrics and the
    parameters after the last equal bit for bit under the Trainer's
    deterministic algorithms; step ms (median of steps 1-2) of both; the
    flash launches and sharded lookups of each run (counts to 0 just
    before it, read just after). Returns the mesh run's parameters for
    (d)."""
    import dataclasses
    import statistics
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.optim import OptConfig
    from repro_torch.runtime import Trainer
    from repro_torch.sharding import make_rules

    cfg = dataclasses.replace(get_config(SHARD_ARCH),
                              num_layers=MESH_TRAIN_LAYERS)
    shape = ShapeConfig("train", MESH_TRAIN_SEQ, MESH_TRAIN_ROWS, "train")
    mesh = make_mesh_for(EMBED_SHARDS, model_par=EMBED_SHARDS, device="cuda")
    rules = make_rules(mesh, cfg, shape)
    runs = {}
    for name, kw in (("mesh", dict(mesh=mesh, rules=rules)), ("plain", {})):
        metrics: list = []
        with tempfile.TemporaryDirectory() as workdir:
            trainer = Trainer(cfg, shape, workdir, OptConfig(warmup_steps=10),
                              ckpt_every=MESH_TRAIN_STEPS + 1, seed=args.seed,
                              **kw)
            torch.cuda.synchronize()
            ops.reset_launches()         # the main path: counts to 0 just before
            with model_axis_runs() as sharded:
                params, _, _ = trainer.run(
                    MESH_TRAIN_STEPS, hook=lambda s, m: metrics.append(
                        {k: v.clone() for k, v in m.items()}))
            launches = (ops.launches["flash_attention"],
                        dict(ops.flash_attention_variants))
            step_ms = statistics.median(trainer.watchdog._times[1:]) * 1e3
        runs[name] = dict(params=params, metrics=metrics, launches=launches,
                          step_ms=step_ms, sharded=sharded.calls)
        del trainer
        torch.cuda.empty_cache()
    torch.use_deterministic_algorithms(False)
    differ = trees_equal(torch, runs["mesh"]["params"], runs["plain"]["params"])
    metric_differ = [f"step {i} {k}" for i, (a, b) in enumerate(zip(
        runs["mesh"]["metrics"], runs["plain"]["metrics"]))
        for k in a if not torch.equal(a[k], b[k])]
    n = 2 * MESH_TRAIN_LAYERS * MESH_TRAIN_STEPS
    want = (n, {"wgmma": n, "simt": 0})
    tokens = MESH_TRAIN_ROWS * MESH_TRAIN_SEQ
    log(f"[shard] (c) Trainer.run({MESH_TRAIN_STEPS}) {SHARD_ARCH} "
        f"({MESH_TRAIN_LAYERS} layers, {MESH_TRAIN_ROWS} x {MESH_TRAIN_SEQ}) "
        f"with {mesh} and rules and without: losses "
        + ", ".join(f"{float(m['loss']):.6f}" for m in runs["mesh"]["metrics"])
        + " / " + ", ".join(f"{float(m['loss']):.6f}"
                            for m in runs["plain"]["metrics"])
        + f"; grad norms " + ", ".join(f"{float(m['grad_norm']):.6f}"
                                       for m in runs["mesh"]["metrics"])
        + f"; metrics that differ: {metric_differ or 'none'}; parameter "
        f"leaves that differ after step {MESH_TRAIN_STEPS}: {differ or 'none'}"
        f"; step {runs['mesh']['step_ms']:.3f} ms on the mesh against "
        f"{runs['plain']['step_ms']:.3f} ms "
        f"({tokens / runs['mesh']['step_ms'] * 1e3:.1f} / "
        f"{tokens / runs['plain']['step_ms'] * 1e3:.1f} tokens/s); "
        f"flash_attention launches {runs['mesh']['launches']} / "
        f"{runs['plain']['launches']}; sharded lookups (LocalMesh runs on "
        f"model) {runs['mesh']['sharded']} / {runs['plain']['sharded']}; "
        f"{card}")
    if runs["mesh"]["sharded"] == 0 or runs["plain"]["sharded"] != 0:
        failures.append(f"sharding (c): sharded lookups "
                        f"{runs['mesh']['sharded']} / "
                        f"{runs['plain']['sharded']}, want more than 0 on "
                        f"the mesh and 0 without")
    if differ or metric_differ or len(runs["mesh"]["metrics"]) != MESH_TRAIN_STEPS:
        failures.append(f"sharding (c): the mesh Trainer differs from the "
                        f"meshless one: metrics {metric_differ}, leaves {differ}")
    if runs["mesh"]["launches"] != want or runs["plain"]["launches"] != want:
        failures.append(f"sharding (c): flash_attention launches "
                        f"{runs['mesh']['launches']} / "
                        f"{runs['plain']['launches']}, want {want} each")
    params = runs["mesh"]["params"]
    del runs
    torch.cuda.empty_cache()
    return dict(cfg=cfg, params=params, launches=2 * n)


def check_elastic_restore(torch, cfg, params, card: str, failures: list) -> dict:
    """(d): (c)'s parameters saved, loaded onto the shardings of
    make_rules(make_mesh_for(8, model_par=4), cfg): every block of its
    sharding's shape, shard 0's bytes equal to sharded_bytes_per_device,
    the rebuilt tree equal to the saved one; saved back from the mesh and
    loaded with no mesh, equal again; GB/s each way."""
    import os
    import tempfile

    from repro_torch.checkpoint import load, save
    from repro_torch.common import param_bytes, tree_paths
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import build_model
    from repro_torch.models.params import (abstract_tree,
                                           sharded_bytes_per_device,
                                           sharding_tree)
    from repro_torch.sharding import make_rules

    mesh = make_mesh_for(ELASTIC_SHARDS, model_par=ELASTIC_MODEL, device="cuda")
    rules = make_rules(mesh, cfg)
    defs = build_model(cfg, device="cuda").param_defs()
    nbytes = param_bytes(params)
    with tempfile.TemporaryDirectory() as root:
        path = save(os.path.join(root, "a"), MESH_TRAIN_STEPS, {"params": params})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, out = load(path, {"params": abstract_tree(defs)},
                      {"params": sharding_tree(defs, rules)})
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        sharded = out["params"]
        bad_blocks = [
            "/".join(p) for p, st in tree_paths(sharded)
            if len(st.blocks) != mesh.size or any(
                tuple(b.shape) != st.sharding.shard_shape(st.shape)
                for b in st.blocks)]
        shard0 = sum(st.blocks[0].numel() * st.blocks[0].element_size()
                     for _, st in tree_paths(sharded))
        want0 = sharded_bytes_per_device(defs, rules)
        rebuilt = trees_equal(torch, {p: st.full() for p, st in
                                      tree_paths(sharded)},
                              dict(tree_paths(params)))
        t0 = time.perf_counter()
        back_path = save(os.path.join(root, "b"), MESH_TRAIN_STEPS,
                         {"params": sharded})
        t_save = time.perf_counter() - t0
        del out, sharded
        _, back = load(back_path, {"params": params}, device="cuda")
        round_trip = trees_equal(torch, back["params"], params)
    log(f"[shard] (d) elastic restore of (c)'s {nbytes} bytes onto {mesh} "
        f"(rules kv_mode {rules.kv_mode}, fsdp over data): blocks not of "
        f"their sharding's shape {bad_blocks or 'none'}; shard 0 holds "
        f"{shard0} bytes, sharded_bytes_per_device {want0}; rebuilt tree "
        f"differs at {rebuilt or 'nothing'}; saved back from the mesh and "
        f"loaded with none, differs at {round_trip or 'nothing'}; load onto "
        f"the mesh {t_load:.3f} s ({nbytes / t_load / 1e9:.3f} GB/s), save "
        f"from the mesh {t_save:.3f} s ({nbytes / t_save / 1e9:.3f} GB/s); "
        f"{card}")
    if bad_blocks or shard0 != want0 or rebuilt or round_trip:
        failures.append(f"sharding (d): blocks {bad_blocks}, shard 0 "
                        f"{shard0} != {want0}, rebuilt {rebuilt}, round trip "
                        f"{round_trip}")
    return dict(load_gbps=nbytes / t_load / 1e9, save_gbps=nbytes / t_save / 1e9)


def run_dryrun_roofline(torch, card: str, train_step_ms, failures: list) -> dict:
    """(e): `python -m repro_torch.launch.dryrun --all --mesh both` then
    `python -m repro_torch.launch.roofline` on its reports: cells counted,
    seconds, each cell's counted flops over the cost model's, and the cost
    model's one-GPU terms for phase 13's yi-6b run beside its measured
    step."""
    import dataclasses
    import os

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.costmodel import cost_cell

    out_dir = Path(__file__).resolve().parent / "build" / "dryrun"
    shutil.rmtree(out_dir, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    dry = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all", "--mesh",
         "both", "--out", str(out_dir)],
        env=env, capture_output=True, text=True, timeout=900)
    t_dry = time.perf_counter() - t0
    roof = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.roofline", "--dir",
         str(out_dir), "--out", str(out_dir.parent / "roofline.json")],
        env=env, capture_output=True, text=True, timeout=300)
    reports = [json.loads(p.read_text()) for p in sorted(out_dir.glob("*.json"))]
    summary = (dry.stdout.strip().splitlines() or [""])[-1]
    log(f"[launch] (e) dryrun --all --mesh both: rc {dry.returncode}, "
        f"{t_dry:.1f} s, {len(reports)} cell reports ({summary}); host work "
        f"only, on meta tensors; {card}")
    for r in reports:
        log(f"[launch] {r['arch']} {r['shape']} {r['mesh']}: counted "
            f"{r['counted_flops']:.6e} flops (plain attention), cost "
            f"model {r['cost_model']['flops']:.6e}, counted/model "
            f"{r['counted_flops'] / r['cost_model']['flops']:.4f}; "
            f"{r['count_s']:.2f} s")
    log("[launch] roofline: rc " + str(roof.returncode) + "\n"
        + roof.stdout.strip())
    if dry.returncode != 0 or roof.returncode != 0 or not reports:
        failures.append(f"launch (e): dryrun rc {dry.returncode}, roofline rc "
                        f"{roof.returncode}\n{dry.stdout[-3000:]}\n"
                        f"{dry.stderr[-3000:]}\n{roof.stderr[-3000:]}")
    cfg = dataclasses.replace(get_config("yi-6b"), num_layers=TRAIN_LAYERS)
    shape = ShapeConfig("train", TRAIN_SEQ, TRAIN_ROWS, "train")
    terms = cost_cell(cfg, shape, {"data": 1}).terms(1)
    measured = (f"{train_step_ms:.3f} ms" if train_step_ms is not None
                else "not measured (phase 13 failed)")
    log(f"[launch] cost model, one GPU ({{'data': 1}}), phase 13's yi-6b "
        f"({TRAIN_LAYERS} layers, {TRAIN_ROWS} x {TRAIN_SEQ}, remat "
        f"{cfg.remat_policy!r}): compute {terms['compute_s'] * 1e3:.3f} ms, "
        f"memory {terms['memory_s'] * 1e3:.3f} ms, collective "
        f"{terms['collective_s'] * 1e3:.3f} ms, dominant {terms['dominant']}, "
        f"step bound {terms['step_s'] * 1e3:.3f} ms; measured step "
        f"{measured}; {card}")
    return dict(seconds=t_dry, counted=len(reports), terms=terms)


def run_sharding_launch(torch, args, card: str, train_step_ms,
                        failures: list) -> dict:
    """Phase 15, (a)-(e), each reporting its own failure. Returns the flash
    launches of (b) and (c)'s main-path runs."""
    launches = 0
    steps = (("(a) mapsin_embed", lambda: check_mapsin_embed(
                 torch, args, card, failures)),
             ("(b) mesh prefill", lambda: check_mesh_prefill(
                 torch, args, card, failures)))
    for what, fn in steps:
        try:
            launches += fn().get("launches", 0)
        except Exception:
            failures.append(f"phase sharding {what}:\n{traceback.format_exc()}")
        torch.cuda.empty_cache()
    try:
        train = check_mesh_training(torch, args, card, failures)
        launches += train["launches"]
        check_elastic_restore(torch, train["cfg"], train["params"], card,
                              failures)
        del train
    except Exception:
        failures.append(f"phase sharding (c)/(d):\n{traceback.format_exc()}")
    torch.use_deterministic_algorithms(False)
    torch.cuda.empty_cache()
    try:
        run_dryrun_roofline(torch, card, train_step_ms, failures)
    except Exception:
        failures.append(f"phase launch (e):\n{traceback.format_exc()}")
    return dict(launches=launches)


def phase_done(name: str, t0: float) -> float:
    now = time.perf_counter()
    log(f"[phase] {name}: {now - t0:.1f} s")
    return now


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--universities", type=int, default=400)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--crash-child", nargs=2, metavar=("DIR", "SEED"),
                    help="run the ingest phase's crash canary child")
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
    if args.crash_child:
        return crash_child(args.crash_child[0], int(args.crash_child[1]))
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
        fuzz["probe_compact"] = fuzz_probe_compact(torch, ops, rdf, args.seed)
        fuzz["multiway_compact"] = fuzz_multiway_compact(torch, ops, rdf,
                                                         args.seed)
        fuzz["sort_merge_compact"] = fuzz_sort_merge_compact(torch, ops,
                                                             args.seed)
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
        lubm = dict(store=main_run["store"], d=main_run["d"],
                    triples=main_run["triples"])
        kernels = time_kernels(torch, main_run, fuzz, floor)
        kernels.append(check_reduce_side(torch, args, fuzz, failures))
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
    t_phase = phase_done("engine serving", t_phase)

    # the mutable store over the main path's triples, beside its store
    ingest = None
    if lubm is None:
        failures.append("phase ingest: no LUBM store from the main path")
    else:
        try:
            ingest = run_ingest(torch, args, lubm, floor, failures)
        except Exception:
            failures.append(f"phase ingest:\n{traceback.format_exc()}")
    ss = next((k for k in kernels if k["name"] == "searchsorted"), None)
    if ingest is not None and ss is not None:
        ss["launches"] += ingest["launches"]
        ss["ingest_launches"] = ingest["launches"]
        ss["mismatches"] += ingest["mismatches"]
        ss["merge_shapes"] = {
            label: {k: t[k] for k in ("ms", "library_ms", "plain_ms",
                                      "floor_ms", "bound_ms")}
            for label, t in ingest["merge_timings"].items()}
    torch.cuda.empty_cache()
    t_phase = phase_done("ingest", t_phase)

    # the distributed path over the main path's triples, eight shards
    dist = None
    if lubm is None:
        failures.append("phase distributed: no LUBM store from the main "
                        "path")
    else:
        try:
            dist = run_distributed(torch, args, lubm, floor, failures)
        except Exception:
            failures.append(f"phase distributed:\n{traceback.format_exc()}")
    if dist is not None and ss is not None:
        ss["launches"] += dist["launches"]
        ss["dist_launches"] = dist["launches"]
        ss["mismatches"] += dist["mismatches"]
        ss["answer_shapes"] = {
            label: {k: t[k] for k in ("ms", "library_ms", "plain_ms",
                                      "floor_ms", "bound_ms")}
            for label, t in dist["answer_timings"].items()}
    pg = next((k for k in kernels if k["name"] == "probe_gather"), None)
    if dist is not None and pg is not None:
        pg["launches"] += dist["pg_launches"]
        pg["dist_launches"] = dist["pg_launches"]
        pg["mismatches"] += dist["pg_mismatches"]
        pg["answer_shapes"] = {
            label: {k: t[k] for k in ("ms", "plain_ms", "bound_ms")}
            for label, t in dist["pg_answer_timings"].items()}
    del lubm
    torch.cuda.empty_cache()
    t_phase = phase_done("distributed", t_phase)

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
    t_phase = phase_done("LM serving", t_phase)

    # the other LM families at full width, after yi-6b's weights are freed
    torch.cuda.empty_cache()
    families = {}
    try:
        families = run_lm_families(torch, args, card, failures)
    except Exception:
        failures.append(f"phase LM families:\n{traceback.format_exc()}")
    k = next((k for k in kernels if k["name"] == "flash_attention"), None)
    if k is None:
        failures.append("phase LM families: no flash_attention record from "
                        "LM serving")
    else:
        k["family_launches"] = {a: f["launches"] for a, f in families.items()}
        k["family_shapes"] = {a: {key: f["kernel"][key] for key in (
            "shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err")} for a, f in families.items()}
        for f in families.values():
            k["launches"] += f["launches"]
            k["mismatches"] += f["kernel"]["mismatches"]
            k["max_abs_err"] = max(k["max_abs_err"], f["kernel"]["max_abs_err"])
            if f["kernel"]["mismatches"]:
                failures.append("flash_attention: mismatches against the "
                                "plain version at an LM family's shape")
    family_peak = max((f["peak"] for f in families.values()), default=0)
    t_phase = phase_done("LM families", t_phase)

    # deepseek-v3's MLA at full width, after the families' weights are freed
    torch.cuda.empty_cache()
    mla_peak = 0
    try:
        mla = run_lm_mla(torch, args, card, failures)
        mla_peak = mla["peak"]
        if k is not None:
            k["family_launches"][MLA_ARCH] = mla["launches"]["flash_attention"]
    except Exception:
        failures.append(f"phase LM MLA:\n{traceback.format_exc()}")
    t_phase = phase_done("LM MLA (deepseek-v3-671b)", t_phase)

    # the recurrent families at full width, after MLA's weights are freed
    torch.cuda.empty_cache()
    rec_peak = 0
    try:
        recur = run_lm_recurrent(torch, args, card, failures)
        rec_peak = max(recur[a]["peak"] for a in (RG_ARCH, XL_ARCH))
        if k is not None:
            for a in (RG_ARCH, XL_ARCH):
                k["family_launches"][a] = recur[a]["launches"]["flash_attention"]
            k["window_launches"] = recur["window"]["launches"]["flash_attention"]
    except Exception:
        failures.append(f"phase LM recurrent:\n{traceback.format_exc()}")
    t_phase = phase_done(f"LM recurrent ({RG_ARCH}, {XL_ARCH})", t_phase)

    # training at full width, after serving's weights are freed
    torch.cuda.empty_cache()
    train_step_ms = None
    try:
        train = run_lm_training(torch, args, card, failures)
        train_step_ms = train["train_step_ms"]
        k = next((k for k in kernels if k["name"] == "flash_attention"), None)
        if k is None:
            failures.append("phase LM training: no flash_attention record "
                            "from LM serving")
        else:
            k["launches"] += train["train_launches"]
            k["train_launches"] = train["train_launches"]
            k["train_step_ms"] = train["train_step_ms"]
            k["mismatches"] += train["mismatches"]
            k["max_abs_err"] = max(k["max_abs_err"], train["max_abs_err"])
            k["train_shape"] = {key: train[key] for key in (
                "shape", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "max_abs_err", "train_backward_plain_ms")}
            if train["mismatches"]:
                failures.append("flash_attention: mismatches against the "
                                "plain version at the training shape")
    except Exception:
        failures.append(f"phase LM training:\n{traceback.format_exc()}")
    train_peak = torch.cuda.max_memory_allocated()
    t_phase = phase_done("LM training", t_phase)

    # every family trained, after yi-6b's training state is freed
    torch.cuda.empty_cache()
    fam_train = {}
    try:
        fam_train = run_lm_family_training(torch, args, card, failures)
    except Exception:
        failures.append(f"phase LM family training:\n{traceback.format_exc()}")
    k = next((k for k in kernels if k["name"] == "flash_attention"), None)
    if k is None:
        failures.append("phase LM family training: no flash_attention record "
                        "from LM serving")
    else:
        k["family_train_launches"] = {a: f["launches"]
                                      for a, f in fam_train.items()}
        k["family_train_shapes"] = {}
        for a, f in fam_train.items():
            k["launches"] += f["launches"]
            rec = f["kernel"]
            if rec is None:
                continue
            k["family_train_shapes"][a] = {key: rec[key] for key in (
                "shape", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "max_abs_err", "train_backward_plain_ms")}
            k["mismatches"] += rec["mismatches"]
            k["max_abs_err"] = max(k["max_abs_err"], rec["max_abs_err"])
            if rec["mismatches"]:
                failures.append(f"flash_attention: mismatches against the "
                                f"plain version at {a}'s training shape")
    fam_train_peak = max((f["peak"] for f in fam_train.values()), default=0)
    t_phase = phase_done("LM family training", t_phase)

    # sharding and launch, after the families' training state is freed
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    shard = {"launches": 0}
    try:
        shard = run_sharding_launch(torch, args, card, train_step_ms, failures)
    except Exception:
        failures.append(f"phase sharding and launch:\n{traceback.format_exc()}")
    k = next((k for k in kernels if k["name"] == "flash_attention"), None)
    if k is not None:
        k["sharding_launches"] = shard["launches"]
        k["launches"] += shard["launches"]
    shard_peak = torch.cuda.max_memory_allocated()
    phase_done("sharding and launch", t_phase)

    print(json.dumps({"kernels": kernels}), flush=True)
    log(f"memory: max_memory_allocated {peak} bytes "
        f"({peak / 2 ** 30:.2f} GiB) over the main path; {lm_peak} bytes "
        f"({lm_peak / 2 ** 30:.2f} GiB) over LM serving; {family_peak} bytes "
        f"({family_peak / 2 ** 30:.2f} GiB) over the LM families; {mla_peak} "
        f"bytes ({mla_peak / 2 ** 30:.2f} GiB) over LM MLA; {rec_peak} bytes "
        f"({rec_peak / 2 ** 30:.2f} GiB) over LM recurrent; {train_peak} bytes "
        f"({train_peak / 2 ** 30:.2f} GiB) over LM training; {fam_train_peak} "
        f"bytes ({fam_train_peak / 2 ** 30:.2f} GiB) over LM family training; "
        f"{shard_peak} bytes ({shard_peak / 2 ** 30:.2f} GiB) over sharding "
        f"and launch")
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
