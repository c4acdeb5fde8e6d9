// Rank-find over the sorted composite-key index: the index GET's search.
//
// Replaces the Pallas TPU kernel searchsorted3
// (src/repro/kernels/searchsorted.py, body `_kernel`, wrapper
// kernels/ops.py `searchsorted`): for each query, its left rank, the
// number of keys strictly below it (numpy/torch searchsorted, side left).
//
// The TPU kernel splits each key into three int32 columns (the TPU has no
// int64 vectors) and walks key blocks with a compare tile, pruning blocks
// that lie wholly below or above the queries. Hopper compares int64
// natively, so this kernel searches the packed int64 keys directly.
//
// What bounds it on this card. Each query is read and each rank written
// once (16 bytes a query); the search is a chain of dependent loads from
// an index of tens of MB. A per-lane binary search takes about 23 steps at
// M = 5.2 M keys. When a warp's queries are all equal, which is the
// multiway step's usual input (the binding table is sized by capacity and
// every invalid row searches for key 0), the warp waits on those 23 steps
// one after the other; when they are distinct, the lower steps are random
// loads that miss the caches. The design answers each case separately:
//
// - A warp whose 32 queries are all equal (one ballot tells) ranks that
//   value with all its lanes: every step, lane j tests the (j+1)-th of 32
//   evenly spaced pivots of the current range and a ballot narrows it
//   33-fold, so ceil(log33(M + 1)) = 5 dependent steps at M = 5.2 M, the
//   last over consecutive keys. The warp remembers the last value it
//   ranked, so a warp that meets it again (key 0, chunk after chunk)
//   writes the rank without searching.
// - Otherwise each lane ranks its own query, starting below the top of
//   the tree: a table of every S-th key (S = 2^seg_log2, at most
//   TABLE_MAX entries) sits in shared memory, so a lane finds its segment
//   there without a global load, then binary-searches the S keys of that
//   segment. A block loads the table only when one of its warps first
//   needs it, so launches whose warps all rank together never pay for it.
//   (A warp of two to four distinct values was faster here than ranking
//   each value together in turn: its lanes share the table and most
//   loads.)
//
// The grid is persistent: one block of 1024 threads a multiprocessor, each
// striding over the queries a block-width at a time, so that a block
// loads its table once and a warp's remembered rank carries over its
// chunks. (Two blocks a multiprocessor were slower at both shapes that
// chip_smoke.py times: twice the table loads, and twice the warps that
// each pay for a first search.) The next chunk's queries are loaded before
// the current one is searched.
//
// Keys are sorted and padded with INF_KEY (2^63 - 1); a query equal to
// INF_KEY ranks past every real key and before the padding. A run of equal
// keys may cross any number of segments: the table search counts the
// entries strictly below the query, so the segment it picks always holds
// the first key not below it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;             // LANES in kernels/searchsorted.py
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlock = 1024;
constexpr int64_t kMaxTableBytes = 227 * 1024;   // a block's shared memory

// The `path` argument (AUTO, APART, TOGETHER in kernels/searchsorted.py):
// tests force each search on every warp.
constexpr int kAuto = 0;       // together when a warp's queries are equal
constexpr int kApart = 1;      // every warp per lane
constexpr int kTogether = 2;   // every warp together, each value in turn

// A position in the keys. 32 bits: every position and step sum stays
// below m + S + 32, and the entry point refuses an m for which that
// reaches 2^32 (the TPU kernel's ranks are int32, a tighter limit). 64-bit positions took 43 registers
// against 32 and were slower on an H100 at every shape that
// scripts/searchsorted_ab.py times, by up to 40% where a warp holds a few
// distinct values.
using Pos = uint32_t;

// Queries are read and ranks written once: stream them past the caches
// that hold the keys.
__device__ __forceinline__ int64_t load_stream(const int64_t* p) {
  return __ldcs(reinterpret_cast<const long long*>(p));
}

__device__ __forceinline__ void store_stream(int64_t* p, int64_t v) {
  __stcs(reinterpret_cast<long long*>(p), static_cast<long long>(v));
}

__device__ __forceinline__ Pos min_of(Pos a, Pos b) { return a < b ? a : b; }

// Lower bound of x in a[0, n): the first index whose value is >= x. `a`
// is the shared table, or (kGlobal) the keys, read through the
// read-only cache.
template <bool kGlobal>
__device__ __forceinline__ Pos lower_bound(const int64_t* a, Pos n, int64_t x) {
  Pos lo = 0;
  while (n > 0) {
    const Pos half = n >> 1;
    int64_t key;
    if constexpr (kGlobal) key = __ldg(a + lo + half);
    else key = a[lo + half];
    const bool right = key < x;
    lo = right ? lo + half + 1 : lo;
    n = right ? n - half - 1 : half;
  }
  return lo;
}

// The whole warp ranks one value v (warp-uniform). The rank lies in
// [lo, lo + n]; each step splits that into pieces of `step` candidates,
// lane j tests key[lo + (j+1)*step - 1], and the count of pivots below v
// (a prefix of the lanes, as the keys are sorted) picks the piece.
__device__ __forceinline__ Pos warp_rank(const int64_t* __restrict__ keys,
                                         Pos m, int64_t v, int lane) {
  Pos lo = 0;
  Pos n = m;
  while (n > 0) {
    const Pos step = n / (kLanes + 1) + 1;
    const Pos p = lo + static_cast<Pos>(lane + 1) * step - 1;
    const bool below = p < lo + n && __ldg(keys + p) < v;
    const Pos next = lo + static_cast<Pos>(__popc(__ballot_sync(kFull, below))) * step;
    n = min_of(step - 1, lo + n - next);
    lo = next;
  }
  return lo;
}

// One lane ranks its own x: its segment from the shared table (t entries,
// table[s] = keys[s << seg_log2]), then a binary search inside it.
__device__ __forceinline__ Pos lane_rank(const int64_t* __restrict__ keys,
                                         Pos m, const int64_t* table, Pos t,
                                         int seg_log2, int64_t x) {
  const Pos c = lower_bound<false>(table, t, x);   // table entries below x
  if (c == 0) return 0;                      // keys[0] >= x
  // keys[(c-1) << seg_log2] < x <= keys[c << seg_log2] (or c << seg_log2 >= m)
  const Pos a = ((c - 1) << seg_log2) + 1;
  const Pos e = min_of(c << seg_log2, m);
  return a + lower_bound<true>(keys + a, e - a, x);
}

// Every S-th key into the shared table, kBatch independent loads in
// flight a thread (the strided keys mostly miss the caches).
__device__ __forceinline__ void load_table(const int64_t* __restrict__ keys,
                                           int seg_log2, Pos t,
                                           int64_t* table) {
  constexpr int kBatch = 8;
  for (Pos s0 = threadIdx.x; s0 < t; s0 += kBatch * blockDim.x) {
    int64_t v[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const Pos s = s0 + b * blockDim.x;
      v[b] = s < t ? __ldg(keys + (s << seg_log2)) : 0;
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const Pos s = s0 + b * blockDim.x;
      if (s < t) table[s] = v[b];
    }
  }
}

__global__ void __launch_bounds__(kBlock)
searchsorted_kernel(const int64_t* __restrict__ keys, Pos m,
                    const int64_t* __restrict__ queries, int64_t nq,
                    int64_t* __restrict__ out, int seg_log2, Pos t,
                    int path) {
  extern __shared__ int64_t table[];
  const int lane = threadIdx.x % kLanes;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  bool loaded = false;                 // block-uniform
  bool remembered = false;             // warp-uniform, with the two below
  int64_t last_v = 0;
  Pos last_r = 0;
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  int64_t ahead = i < nq ? load_stream(queries + i) : 0;
  // every thread of the block takes each turn, so the barriers line up
  for (int64_t base = i - threadIdx.x; base < nq; base += stride, i += stride) {
    const bool valid = i < nq;
    int64_t x = ahead;
    ahead = i + stride < nq ? load_stream(queries + i + stride) : 0;
    const unsigned live = __ballot_sync(kFull, valid);
    // lanes past the end take lane 0's query, so they add no value
    const int64_t x0 = __shfl_sync(kFull, x, 0);
    x = valid ? x : x0;
    const bool equal = __ballot_sync(kFull, x != x0) == 0;
    const bool together =
        path == kTogether || (path == kAuto && equal);
    if (!loaded && __syncthreads_or(live != 0 && !together)) {
      load_table(keys, seg_log2, t, table);
      __syncthreads();
      loaded = true;
    }
    if (live == 0) continue;
    Pos r = 0;
    if (together) {
      // each distinct value of the warp in turn, by its first lane
      for (unsigned rest = kFull; rest != 0;) {
        const int64_t v = __shfl_sync(kFull, x, __ffs(rest) - 1);
        if (!remembered || v != last_v) {
          last_r = warp_rank(keys, m, v, lane);
          last_v = v;
          remembered = true;
        }
        r = x == v ? last_r : r;
        rest &= __ballot_sync(kFull, x != v);
      }
    } else {
      r = lane_rank(keys, m, table, t, seg_log2, x);
    }
    if (valid) store_stream(out + i, static_cast<int64_t>(r));
  }
}

}  // namespace

// seg_log2 and path come from kernels/searchsorted.py (`launch_params`),
// which the CPU model of this kernel reads too.
extern "C" int searchsorted_i64(const void* keys, int64_t m,
                                const void* queries, int64_t nq, void* out,
                                int seg_log2, int path, void* stream) {
  if (nq <= 0) return 0;
  if (m < 0 || (path != kAuto && path != kApart && path != kTogether) ||
      seg_log2 < 0 || seg_log2 > 31 ||
      m + (int64_t{1} << seg_log2) + kLanes >= (int64_t{1} << 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t t = m == 0 ? 0 : ((m - 1) >> seg_log2) + 1;
  const int64_t smem = t * static_cast<int64_t>(sizeof(int64_t));
  if (smem > kMaxTableBytes) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      searchsorted_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return static_cast<int>(err);
  const int64_t need = (nq + kBlock - 1) / kBlock;
  const int64_t blocks = need < sms ? need : sms;
  searchsorted_kernel<<<static_cast<unsigned int>(blocks), kBlock,
                        static_cast<size_t>(smem),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), static_cast<Pos>(m),
      static_cast<const int64_t*>(queries), nq, static_cast<int64_t*>(out),
      seg_log2, static_cast<Pos>(t), path);
  return static_cast<int>(cudaGetLastError());
}
