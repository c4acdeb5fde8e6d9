// The fused MAPSIN GET: rank-find, range gather and residual filter in one
// pass.
//
// Replaces the Pallas TPU kernel probe_gather3
// (src/repro/kernels/probe_gather.py, body `_kernel`, wrapper
// kernels/ops.py `probe_gather`). For each probe b with range
// [lo[b], hi[b]) over the sorted int64 index:
//   start = rank(lo), end = rank(hi)            (left ranks)
//   slot c < cap holds keys[start + c] when start + c < end;
//   the slot is valid when it is in range, its key's fields equal the
//   residual values flt[b, pos] at every position set in flt_mask, and
//   its fields are equal across every intra-pattern repeat in eq_mask;
//   invalid slots hold key 0;
//   missed[b] = max(end - start - cap, 0), whatever the residual.
//
// The TPU kernel keeps three int32 columns and places matches by a one-hot
// accumulation over compare tiles, because the TPU has neither int64
// vectors nor a cheap gather. Hopper has both, so this kernel is held to
// that contract, not to its algorithm: one warp per probe. Lane 0 finds
// rank(lo) and lane 1 rank(hi), both by binary search, and the warp shares
// them by shuffle. Then the lanes stride over the cap slots: slot c reads
// keys[start + c], so the 32 lanes read 32 neighbouring keys (coalesced),
// unpack the three 21-bit fields in registers and test the residual and
// the repeats there. Any cap works; a lane handles slots c, c + 32, ...
//
// What bounds it on this card: bytes. The kernel must read each probe's
// lo and hi, the filter values at the flt_mask positions of each probe
// whose range holds a key, and the in-range keys, and write cap keys
// (8 bytes), cap flags (1 byte) and one missed count per probe; at the
// main path's shapes (2^20 probes by 128 slots) that is about 1.2 GB
// written, some 0.35 ms at 3.35 TB/s. The two searches per probe are
// latency, hidden by the many warps in flight. A probe whose range is
// empty by construction (lo >= hi: the executor sends [0, 0) for an
// invalid binding) skips both searches: no slot can be in range and
// missed is 0, exactly what the searches would give. A probe whose range
// holds no key reads no filter value.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int64_t lower_bound(const int64_t* __restrict__ keys,
                                               int64_t m, int64_t x) {
  int64_t lo = 0;
  int64_t n = m;
  while (n > 0) {
    const int64_t half = n >> 1;
    if (__ldg(keys + lo + half) < x) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

__global__ void probe_gather_kernel(const int64_t* __restrict__ keys, int64_t m,
                                    const int64_t* __restrict__ lo,
                                    const int64_t* __restrict__ hi,
                                    const int64_t* __restrict__ flt,
                                    int64_t b, int cap, int flt_mask,
                                    int eq_mask, int bits,
                                    int64_t* __restrict__ out_k,
                                    bool* __restrict__ out_valid,
                                    int32_t* __restrict__ missed) {
  const int lane = threadIdx.x & 31;
  const int64_t w =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (w >= b) return;                 // whole warps exit together

  const int64_t qlo = lo[w];
  const int64_t qhi = hi[w];
  int64_t start = 0;
  int64_t end = 0;
  if (qlo < qhi) {
    long long r = 0;
    if (lane < 2) r = lower_bound(keys, m, lane == 0 ? qlo : qhi);
    start = __shfl_sync(0xffffffffu, r, 0);
    end = __shfl_sync(0xffffffffu, r, 1);
  }
  if (lane == 0) {
    const int64_t over = end - start - cap;
    missed[w] = static_cast<int32_t>(over > 0 ? over : 0);
  }

  const int64_t field = (int64_t{1} << bits) - 1;
  int64_t f0 = 0;
  int64_t f1 = 0;
  int64_t f2 = 0;
  if (start < end) {                  // only the filter values the slots test
    if (flt_mask & 1) f0 = flt[3 * w + 0];
    if (flt_mask & 2) f1 = flt[3 * w + 1];
    if (flt_mask & 4) f2 = flt[3 * w + 2];
  }
  int64_t* row_k = out_k + w * cap;
  bool* row_v = out_valid + w * cap;
  for (int c = lane; c < cap; c += 32) {
    const int64_t idx = start + c;
    bool ok = idx < end;              // end <= m, so the read is in bounds
    int64_t key = 0;
    if (ok) {
      key = __ldg(keys + idx);
      const int64_t k0 = (key >> (2 * bits)) & field;
      const int64_t k1 = (key >> bits) & field;
      const int64_t k2 = key & field;
      if (flt_mask & 1) ok = ok && (k0 == f0);
      if (flt_mask & 2) ok = ok && (k1 == f1);
      if (flt_mask & 4) ok = ok && (k2 == f2);
      if (eq_mask & 1) ok = ok && (k0 == k1);
      if (eq_mask & 2) ok = ok && (k0 == k2);
      if (eq_mask & 4) ok = ok && (k1 == k2);
    }
    row_k[c] = ok ? key : 0;
    row_v[c] = ok;
  }
}

}  // namespace

// flt_mask: bit p set = residual equality on index-order position p.
// eq_mask: bit 0 = positions (0, 1) equal, bit 1 = (0, 2), bit 2 = (1, 2).
extern "C" int probe_gather_i64(const void* keys, int64_t m, const void* lo,
                                const void* hi, const void* flt, int64_t b,
                                int cap, int flt_mask, int eq_mask, int bits,
                                void* out_k, void* out_valid, void* missed,
                                void* stream) {
  if (b <= 0) return 0;
  const int threads = 256;            // 8 warps, 8 probes a block
  const int64_t blocks = (b * 32 + threads - 1) / threads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  probe_gather_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), m, static_cast<const int64_t*>(lo),
      static_cast<const int64_t*>(hi), static_cast<const int64_t*>(flt), b,
      cap, flt_mask, eq_mask, bits, static_cast<int64_t*>(out_k),
      static_cast<bool*>(out_valid), static_cast<int32_t*>(missed));
  return static_cast<int>(cudaGetLastError());
}
