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
// natively, so here each thread runs one lower-bound binary search over
// the packed int64 keys: ceil(log2(M + 1)) dependent loads, about 23 at
// M = 5.2 M keys.
//
// What bounds it on this card: latency, not bytes. The kernel must read
// each query and write each rank (16 bytes a query), but every probe of a
// search is a dependent load from a 40 MB index that mostly misses the
// 50 MB L2 once several indexes are live. Its design answers that only
// with parallelism: one thread per query and many queries in flight, so
// the memory system overlaps the searches' stalls. Keeping the top levels
// of the implicit search tree in shared memory is later work.
//
// Keys are sorted and padded with INF_KEY (2^63 - 1); a query equal to
// INF_KEY ranks past every real key and before the padding.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void searchsorted_kernel(const int64_t* __restrict__ keys,
                                    int64_t m,
                                    const int64_t* __restrict__ queries,
                                    int64_t nq,
                                    int64_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  const int64_t x = queries[i];
  int64_t lo = 0;
  int64_t n = m;
  while (n > 0) {                     // lower bound: first key >= x
    const int64_t half = n >> 1;
    if (__ldg(keys + lo + half) < x) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  out[i] = lo;
}

}  // namespace

extern "C" int searchsorted_i64(const void* keys, int64_t m,
                                const void* queries, int64_t nq, void* out,
                                void* stream) {
  if (nq <= 0) return 0;
  const int threads = 256;
  const int64_t blocks = (nq + threads - 1) / threads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  searchsorted_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), m,
      static_cast<const int64_t*>(queries), nq, static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
