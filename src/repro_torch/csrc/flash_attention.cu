// Blocked forward attention with an online softmax (flash attention).
//
// Replaces the Pallas TPU kernel flash_attention
// (src/repro/kernels/flash_attention.py, body `_kernel`, wrapper
// kernels/ops.py `flash_attention`): o = softmax(q k^T * scale + mask) v
// for q (b, sq, h, e) and k, v (b, skv, g, e), query head hq reading kv
// head hq / (h / g) (GQA). Scores, the running max and sum and the P.V
// accumulator are float32 whatever the input type; P is not rounded
// before P.V; o is written once, in q's type. Keys past skv are masked;
// causal keeps k_pos <= q_pos + (skv - sq) (end-aligned, the reference's
// mask; at sq == skv it is the Pallas kernel's k_pos <= q_pos), and kv
// tiles wholly above that diagonal are skipped. A row with no unmasked key
// gets 0, from the sum clamped at 1e-30 as in the Pallas kernel.
//
// The TPU kernel walks a sequential (b*h, q block, kv block) grid and keeps
// the softmax statistics in VMEM scratch across the kv dimension. Here one
// block of 256 threads owns one (batch, head, 64-row query tile) and walks
// the kv tiles in a loop; the statistics stay in registers. q, k and v are
// read in their (b, s, heads, e) layout: no transposed copies.
//
// What bounds it on this card: operations. At the serving path's prefill
// (b 4, s 4000, 32 heads, e 128) it must do about 5.2e11 flops against
// 0.29 GB of traffic, far above the card's bytes-to-flops balance, so the
// bound is the bf16 tensor-core rate. This first version does not reach
// it: its products run as float32 FMAs on the CUDA cores, operands from
// shared memory. Each thread owns a quarter of one query row: 16 of the
// tile's 64 scores and e/4 of the row's output columns in registers, with
// the row's max and sum combined by two warp shuffles. K's rows are padded
// by one float so the threads of a row read distinct banks, and P reuses
// K's buffer once the scores are taken, which keeps two blocks resident
// per SM at e = 128. Tensor cores (mma/wgmma), TMA and warp specialisation
// are the next version's work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockKv = 64;
constexpr int kThreads = 256;        // 4 threads per query row
constexpr int kColsPerThread = kBlockKv / 4;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Row pitches in floats: Q and K rows padded by one so the threads of a
// row read distinct banks; K's buffer also holds P (64 columns) later.
template <int E>
__host__ __device__ constexpr int q_pitch() { return E + 1; }
template <int E>
__host__ __device__ constexpr int k_pitch() {
  return E + 1 > kBlockKv + 1 ? E + 1 : kBlockKv + 1;
}
template <int E>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBlockQ * q_pitch<E>() + kBlockKv * k_pitch<E>() +
                          kBlockKv * E);
}

template <typename T, int E>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int sq,
                       int skv, int h, int g, int causal, float scale) {
  constexpr int EP = q_pitch<E>();
  constexpr int KP = k_pitch<E>();
  constexpr int kOut = E / 4;                // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                          // [64][EP]
  float* ks = qs + kBlockQ * EP;             // [64][KP]: K, then P
  float* vs = ks + kBlockKv * KP;            // [64][E]

  const int tid = threadIdx.x;
  const int row = tid >> 2;                  // query row within the tile
  const int quad = tid & 3;
  // heaviest causal tiles (the last query rows) first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int q0 = qt * kBlockQ;
  const int bh = blockIdx.y;
  const int bi = bh / h;
  const int hq = bh % h;
  const int hk = hq / (h / g);
  const int offset = skv - sq;               // end-aligned causal diagonal

  for (int idx = tid; idx < kBlockQ * E; idx += kThreads) {
    const int r = idx / E, d = idx % E;
    const int qi = q0 + r;
    qs[r * EP + d] = qi < sq
        ? to_float(q[((static_cast<int64_t>(bi) * sq + qi) * h + hq) * E + d])
        : 0.f;
  }

  int n_tiles = (skv + kBlockKv - 1) / kBlockKv;
  if (causal) {
    const int last = min(q0 + kBlockQ - 1, sq - 1) + offset;
    n_tiles = last < 0 ? 0 : min(n_tiles, last / kBlockKv + 1);
  }
  const int qpos = q0 + row;
  float acc[kOut];
#pragma unroll
  for (int j = 0; j < kOut; ++j) acc[j] = 0.f;
  float m = kNeg, l = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockKv;
    __syncthreads();                         // the last tile's P and V read
    for (int idx = tid; idx < kBlockKv * E; idx += kThreads) {
      const int r = idx / E, d = idx % E;
      const int ki = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (ki < skv) {
        const int64_t at = ((static_cast<int64_t>(bi) * skv + ki) * g + hk) * E + d;
        kx = to_float(k[at]);
        vx = to_float(v[at]);
      }
      ks[r * KP + d] = kx;
      vs[r * E + d] = vx;
    }
    __syncthreads();

    float s[kColsPerThread];
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) s[j] = 0.f;
    const float* qrow = qs + row * EP;
    for (int d = 0; d < E; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j)
        s[j] = fmaf(qd, ks[(quad + 4 * j) * KP + d], s[j]);
    }
    float tile_max = kNeg;
    bool valid[kColsPerThread];
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int kpos = k0 + quad + 4 * j;
      valid[j] = kpos < skv && (!causal || kpos <= qpos + offset);
      s[j] = valid[j] ? s[j] * scale : kNeg;
      tile_max = fmaxf(tile_max, s[j]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      s[j] = valid[j] ? expf(s[j] - m_new) : 0.f;
      psum += s[j];
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
    __syncthreads();                         // every thread is done with K
    float* prow = ks + row * KP;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) prow[quad + 4 * j] = s[j];
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kOut; ++j) acc[j] *= alpha;
    for (int c = 0; c < kBlockKv; ++c) {
      const float p = prow[c];
      const float* vrow = vs + c * E + quad;
#pragma unroll
      for (int j = 0; j < kOut; ++j) acc[j] = fmaf(p, vrow[4 * j], acc[j]);
    }
  }

  if (qpos < sq) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* out = o + ((static_cast<int64_t>(bi) * sq + qpos) * h + hq) * E + quad;
#pragma unroll
    for (int j = 0; j < kOut; ++j) store(out + 4 * j, acc[j] * inv);
  }
}

template <typename T, int E>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int sq, int skv, int h, int g, int causal, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<E>();
  auto kernel = flash_attention_kernel<T, E>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, b * h);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, skv, h, g, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int e, const void* q, const void* k, const void* v, void* o,
             int b, int sq, int skv, int h, int g, int causal, float scale,
             cudaStream_t stream) {
  switch (e) {
    case 16: return launch<T, 16>(q, k, v, o, b, sq, skv, h, g, causal, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, b, sq, skv, h, g, causal, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, b, sq, skv, h, g, causal, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, b, sq, skv, h, g, causal, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o alike). Returns the CUDA
// error of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int b, int sq,
                                   int skv, int h, int g, int e, int dtype,
                                   int causal, float scale, void* stream) {
  if (b <= 0 || sq <= 0) return 0;
  if (g <= 0 || h % g != 0 || static_cast<int64_t>(b) * h > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(e, q, k, v, o, b, sq, skv, h, g, causal, scale, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(e, q, k, v, o, b, sq, skv, h, g, causal, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
