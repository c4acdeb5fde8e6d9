// Blocked forward attention with an online softmax (flash attention).
//
// Replaces the Pallas TPU kernel flash_attention
// (src/repro/kernels/flash_attention.py:73, body `_kernel`, wrapper
// kernels/ops.py `flash_attention`): o = softmax(q k^T * scale + mask) v
// for q (b, sq, h, e) and k, v (b, skv, g, e), query head hq reading kv
// head hq / (h / g) (GQA), all read in that layout with no transposed
// copies. The softmax statistics are float32; o is written once, in q's
// type. Keys past skv are masked; causal keeps k_pos <= q_pos + (skv - sq)
// (end-aligned, the reference's mask; at sq == skv it is the Pallas
// kernel's k_pos <= q_pos), and kv tiles wholly above that diagonal are
// skipped. A row with no unmasked key gets 0: p is zeroed by the mask and
// the sum is clamped at 1e-30, as in the Pallas kernel.
//
// What bounds it on this card: operations. At the serving path's prefill
// (b 4, s 4000, 32 heads, e 128, bf16) it must do about 5.2e11 flops
// against 0.29 GB of traffic, far above the card's bytes-to-flops balance,
// so the bound is the bf16 tensor-core rate, which only `wgmma` reaches.
//
// Two kernels, chosen by the wrapper (kernels/flash_attention.py
// `variant`) from the dtype and the head dim:
//
// * wgmma, for bfloat16 at e = 64 and 128 (q, k and v 16-byte aligned, as
//   the tensor maps need; the wrapper raises otherwise). One block of two warpgroups
//   owns one (batch, query head, 128-row query tile); each warpgroup owns
//   64 rows. One thread loads Q once and the K and V tiles (128 keys) into
//   a two-stage ring by TMA, each stage completing on an mbarrier; the
//   copy of tile t+1 is in flight while tile t is computed. The tensor
//   maps describe the real (b, s, heads, e) layout, so GQA is a head
//   coordinate and the ragged tail of s is zero-filled by the copy. Each
//   row of a tile is cut into 128-byte column blocks (64 bf16) loaded with
//   the 128-byte swizzle, the layout wgmma's descriptors read. S = Q K^T
//   is `wgmma` m64n128k16 with both operands in shared memory, K-major;
//   the online softmax runs on the accumulator fragment (a row's max and
//   sum meet across its 4 threads by two shuffles; scale * log2(e) is
//   folded into exp2); P is rounded to bf16 in registers, where the
//   accumulator's layout is already the A fragment of the next product,
//   and O += P V is `wgmma` with A from registers and V from shared memory
//   as an MN-major B (the transpose-B flag). The sum l is taken from the
//   unrounded float32 p. Only the diagonal tile and the kv tail take the
//   masked path. Shared memory at e = 128: Q 32 KB + 2 x (K + V) 128 KB,
//   one block per SM; heaviest causal query tiles are launched first.
// * simt (the first, CUDA-core kernel, unchanged), for float32 and bfloat16
//   at e = 16 and 32: one block of 256 threads per (batch, head, 64 query
//   rows), float32 FMAs on the CUDA cores with operands from shared
//   memory, P not rounded. Each thread owns a quarter of one query row:
//   16 of the tile's 64 scores and e/4 output columns in registers. K's
//   rows are padded by one float so the threads of a row read distinct
//   banks, and P reuses K's buffer, which keeps two blocks per SM.

#include <cstdint>
#include <type_traits>
#include <cuda.h>             // CUtensorMap and its enums; no -lcuda needed
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

// float32 at every head dim; bfloat16 only at the head dims the wgmma
// kernel does not take.
template <typename T>
int dispatch(int e, const void* q, const void* k, const void* v, void* o,
             int b, int sq, int skv, int h, int g, int causal, float scale,
             cudaStream_t stream) {
  switch (e) {
    case 16: return launch<T, 16>(q, k, v, o, b, sq, skv, h, g, causal, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, b, sq, skv, h, g, causal, scale, stream);
  }
  if constexpr (std::is_same<T, float>::value) {
    switch (e) {
      case 64: return launch<T, 64>(q, k, v, o, b, sq, skv, h, g, causal, scale, stream);
      case 128: return launch<T, 128>(q, k, v, o, b, sq, skv, h, g, causal, scale, stream);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}


// ---------------------------------------------------------------------------
// The tensor-core kernel (bfloat16, e = 64 and 128)
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kBlockQ = 128;         // query rows per block, 64 per warpgroup
constexpr int kBlockKv = 128;        // keys per kv tile
constexpr int kThreads = 256;        // two warpgroups
constexpr int kAtomCols = 64;        // bf16 columns in one 128-byte swizzle row
constexpr uint32_t kRow = 128;       // bytes in one swizzled row
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory from a 1024-byte-aligned base: Q (kBlockQ x E), K[2] and
// V[2] (kBlockKv x E each), then three mbarriers (Q, kv stage 0, stage 1).
// Each tile is E / 64 column blocks of rows x 128 bytes, one after another.
template <int E>
__host__ __device__ constexpr uint32_t q_bytes() { return kBlockQ * E * 2; }
template <int E>
__host__ __device__ constexpr uint32_t kv_bytes() { return kBlockKv * E * 2; }
template <int E>
__host__ __device__ constexpr uint32_t bar_offset() {
  return q_bytes<E>() + 4 * kv_bytes<E>();
}
template <int E>
__host__ __device__ constexpr size_t smem_bytes() {
  return 1024 + bar_offset<E>() + 3 * 8;     // + alignment slack
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar), "r"(bytes) : "memory");
}

// Wait until the barrier has completed the phase of this parity. The loop
// stays inside the asm, so the compiler sees no divergent branch here.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar), "r"(parity) : "memory");
}

// One box of a 4-d tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
        "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// wgmma's shared-memory matrix descriptor for the 128-byte swizzle: start
// address, leading and stride byte offsets (16-byte units), layout type 1
// in bits 62-63. K-major: the stride offset steps 8 rows (1024 bytes), the
// leading one is unused. MN-major: the stride offset steps 8 rows of K,
// the leading one steps to the next 64-column block of N.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Set the masked entries of a score fragment (layout as below) to `fill`:
// keys at or past skv and, if causal, keys past the row's diagonal.
template <int N>
__device__ __forceinline__ void mask_tile(float (&x)[N], float fill, int row0,
                                          int col0, int skv, int causal,
                                          int offset) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int row = row0 + (i & 2) * 4;
    const int col = col0 + 8 * (i >> 2) + (i & 1);
    if (!(col < skv && (!causal || col <= row + offset))) x[i] = fill;
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x 128, f32) += A (64 x 16, smem) * B (128 x 16, smem), both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 128, f32) += A (64 x 16, bf16 in registers) * B (16 x 128, smem,
// MN-major: the transpose-B flag).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, f32) += A (64 x 16, bf16 in registers) * B (16 x 64, smem,
// MN-major: the transpose-B flag).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int E>
__device__ __forceinline__ void wgmma_pv(float (&d)[E / 2], const uint32_t* a,
                                         uint64_t db) {
  if constexpr (E == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n64(d, a, db);
}

// Accumulator fragment of a 64 x N wgmma (and, for N = 16, the A fragment
// of the next one): warp w of the warpgroup holds rows 16w..16w+15; lane
// holds rows r = lane / 4 and r + 8; element i sits at row r + 8 * (i / 2
// % 2) and column 8 * (i / 4) + 2 * (lane % 4) + i % 2.
template <int E>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             __nv_bfloat16* __restrict__ o, int sq, int skv,
                             int h, int g, int causal, float scale_log2) {
  constexpr int kBlocks = E / kAtomCols;     // 128-byte column blocks a row
  constexpr int kOut = E / 2;                // O floats per thread
  constexpr int kScores = kBlockKv / 2;      // S floats per thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t bar_q = base + bar_offset<E>();
  auto k_s = [&](int s) { return base + q_bytes<E>() + s * kv_bytes<E>(); };
  auto v_s = [&](int s) {
    return base + q_bytes<E>() + (2 + s) * kv_bytes<E>();
  };
  auto bar_kv = [&](int s) { return bar_q + 8u * (1 + s); };

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int bi = bh / h;
  const int hq = bh % h;
  const int hk = hq / (h / g);
  // heaviest causal query tiles (the last rows) first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const int offset = skv - sq;               // end-aligned causal diagonal
  int n_tiles = (skv + kBlockKv - 1) / kBlockKv;
  if (causal) {
    const int last = min(q0 + kBlockQ - 1, sq - 1) + offset;
    n_tiles = last < 0 ? 0 : min(n_tiles, last / kBlockKv + 1);
  }

  if (tid == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_kv(0), 1);
    mbar_init(bar_kv(1), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const CUtensorMap* map_k = &tk;
  const CUtensorMap* map_v = &tv;
  auto load_kv = [&](int t) {                // tile t into stage t % 2
    const int s = t & 1;
    mbar_expect_tx(bar_kv(s), 2 * kv_bytes<E>());
#pragma unroll
    for (int c = 0; c < kBlocks; ++c) {
      tma_load_4d(k_s(s) + c * kBlockKv * kRow, map_k, bar_kv(s),
                  c * kAtomCols, hk, t * kBlockKv, bi);
      tma_load_4d(v_s(s) + c * kBlockKv * kRow, map_v, bar_kv(s),
                  c * kAtomCols, hk, t * kBlockKv, bi);
    }
  };
  if (tid == 0) {
    mbar_expect_tx(bar_q, q_bytes<E>());
#pragma unroll
    for (int c = 0; c < kBlocks; ++c)
      tma_load_4d(q_s + c * kBlockQ * kRow, &tq, bar_q, c * kAtomCols, hq,
                  q0, bi);
    if (n_tiles > 0) load_kv(0);
  }

  // the warpgroup, broadcast from lane 0 so that the compiler knows it is
  // warp-uniform: branches on it do not serialize the products
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int lane = tid & 31;
  const int row0 = q0 + 64 * wg + 16 * ((tid >> 5) & 3) + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  const int wg_first = q0 + 64 * wg;         // this warpgroup's rows
  const int wg_last = min(wg_first + 63, sq - 1);
  const bool wg_live = wg_first < sq;

  float acc[kOut];
#pragma unroll
  for (int i = 0; i < kOut; ++i) acc[i] = 0.f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;   // rows row0, row0 + 8
  mbar_wait(bar_q, 0);

  for (int t = 0; t < n_tiles; ++t) {
    if (tid == 0 && t + 1 < n_tiles) load_kv(t + 1);
    const int s = t & 1;
    const int k0 = t * kBlockKv;
    if (wg_live && (!causal || k0 <= wg_last + offset)) {
      mbar_wait(bar_kv(s), (t >> 1) & 1);
      float sc[kScores];                     // the first product zeroes it
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < E / 16; ++kk) {
        // 16 columns of e: column block kk / 4, 32 bytes into its rows
        const uint32_t col = (kk % 4) * 32;
        const uint64_t da = gmma_desc(
            q_s + (kk / 4) * kBlockQ * kRow + wg * 64 * kRow + col, 16, 1024);
        const uint64_t db =
            gmma_desc(k_s(s) + (kk / 4) * kBlockKv * kRow + col, 16, 1024);
        wgmma_ss_n128(sc, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // the diagonal tile and the kv tail are masked; interior tiles not
      const bool edge = k0 + kBlockKv > skv ||
                        (causal && k0 + kBlockKv - 1 > wg_first + offset);
#pragma unroll
      for (int i = 0; i < kScores; ++i) sc[i] *= scale_log2;
      if (edge) mask_tile(sc, kNeg, row0, k0 + col0, skv, causal, offset);
      float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
      for (int i = 0; i < kScores; ++i) {
        if (i & 2) mx1 = fmaxf(mx1, sc[i]);
        else mx0 = fmaxf(mx0, sc[i]);
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float alpha0 = exp2_approx(m0 - mn0);
      const float alpha1 = exp2_approx(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int i = 0; i < kScores; ++i)
        sc[i] = exp2_approx(sc[i] - ((i & 2) ? mn1 : mn0));
      // masked p is 0, also in a row with nothing unmasked yet (exp2(0))
      if (edge) mask_tile(sc, 0.f, row0, k0 + col0, skv, causal, offset);
      float ps0 = 0.f, ps1 = 0.f;            // l from the float32 p
      uint32_t pa[kScores / 2];              // P in bf16: the A fragments
#pragma unroll
      for (int i = 0; i < kScores; i += 2) {
        if (i & 2) ps1 += sc[i] + sc[i + 1];
        else ps0 += sc[i] + sc[i + 1];
        pa[i / 2] = pack_bf16(sc[i], sc[i + 1]);
      }
      ps0 += __shfl_xor_sync(0xffffffffu, ps0, 1);
      ps0 += __shfl_xor_sync(0xffffffffu, ps0, 2);
      ps1 += __shfl_xor_sync(0xffffffffu, ps1, 1);
      ps1 += __shfl_xor_sync(0xffffffffu, ps1, 2);
      l0 = l0 * alpha0 + ps0;
      l1 = l1 * alpha1 + ps1;
#pragma unroll
      for (int i = 0; i < kOut; ++i) acc[i] *= (i & 2) ? alpha1 : alpha0;

      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockKv / 16; ++kk)   // 16 keys: 2 x 8 rows
        wgmma_pv<E>(acc, &pa[4 * kk],
                    gmma_desc(v_s(s) + kk * 16 * kRow, kBlockKv * kRow, 1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    __syncthreads();                         // stage s is free for tile t+2
  }

#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int row = row0 + 8 * hi;
    if (row < sq) {
      const float inv = 1.f / fmaxf(hi ? l1 : l0, 1e-30f);
      __nv_bfloat16* out =
          o + ((static_cast<int64_t>(bi) * sq + row) * h + hq) * E + col0;
#pragma unroll
      for (int j = 0; j < E / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * hi] * inv,
                                  acc[4 * j + 2 * hi + 1] * inv);
    }
  }
}

// cuTensorMapEncodeTiled is a driver-API function; it is taken through the
// runtime's entry-point query, so the library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of one (b, s, heads, E) bf16 tensor, cut into boxes of
// `rows` positions of one head by 64 columns, with the 128-byte swizzle;
// positions past s read as zeros. Returns 0 or minus the CUresult.
int make_map(CUtensorMap* map, const void* ptr, int b, int s, int heads,
             int e, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(e),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(e) * 2,
                                 static_cast<cuuint64_t>(heads) * e * 2,
                                 static_cast<cuuint64_t>(s) * heads * e * 2};
  const cuuint32_t box[4] = {kAtomCols, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode_tiled()(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -static_cast<int>(r);
}

template <int E>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int sq, int skv, int h, int g, int causal, float scale,
           cudaStream_t stream) {
  if (skv == 0)                  // nothing to attend to: every row is 0
    return static_cast<int>(cudaMemsetAsync(
        o, 0, sizeof(__nv_bfloat16) * b * static_cast<size_t>(sq) * h * E,
        stream));
  const int n_q = (sq + kBlockQ - 1) / kBlockQ;
  if (n_q > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (encode_tiled() == nullptr)
    return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap tq, tk, tv;
  int rc = make_map(&tq, q, b, sq, h, E, kBlockQ);
  if (rc == 0) rc = make_map(&tk, k, b, skv, g, E, kBlockKv);
  if (rc == 0) rc = make_map(&tv, v, b, skv, g, E, kBlockKv);
  if (rc != 0) return rc;
  constexpr size_t smem = smem_bytes<E>();
  auto kernel = flash_attention_wgmma_kernel<E>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(b * h, n_q), kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), sq, skv, h, g, causal,
      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o alike). Returns the CUDA
// error of the launch (0 on success).
extern "C" int flash_attention_simt(const void* q, const void* k,
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

// bfloat16 q, k, v and o, e = 64 or 128, every pointer 16-byte aligned.
// Returns the CUDA error of the launch (0 on success), or minus the
// CUresult of a tensor map that could not be encoded.
extern "C" int flash_attention_wgmma(const void* q, const void* k,
                                     const void* v, void* o, int b, int sq,
                                     int skv, int h, int g, int e, int causal,
                                     float scale, void* stream) {
  if (b <= 0 || sq <= 0) return 0;
  if (g <= 0 || h % g != 0 || static_cast<int64_t>(b) * h > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  switch (e) {
    case 64: return tc::launch<64>(q, k, v, o, b, sq, skv, h, g, causal, scale, st);
    case 128: return tc::launch<128>(q, k, v, o, b, sq, skv, h, g, causal, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
