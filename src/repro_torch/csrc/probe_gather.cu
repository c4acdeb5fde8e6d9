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
//
// probe_compact (probe_count_kernel, a scan of the counts, then
// probe_emit_kernel) replaces no TPU kernel: it is the same GET with the
// MAPSIN merge behind it (core/mapsin.py `merge_matches`), so a mapsin
// step writes its rows, (probe, slot) order and out_cap cut included,
// without the (B, cap) keys and flags above and the 2^27-row passes the
// merge made over them. What bounds it on this card: bytes again, but a
// few MB: each probe's lo and hi, its count, offset and missed count, the
// live probes' searches and in-range keys (read twice, once a pass), and
// the step's table written once (2^20 rows of up to 6 int32 at the main
// path's shapes). Most probes are dead (an invalid binding), so both
// passes take one probe a thread and spend warp-wide work only on the
// probes that have keys; the count pass is latency-bound on the live
// probes' searches, like the kernel above.
//
// multiway_compact (multiway_count_kernel, a scan of the counts, then
// multiway_emit_kernel) replaces no TPU kernel either: it is one pattern
// of the multiway star join (core/mapsin.py `multiway_match`) after the
// row-GET's rank-find. Each of the step's rows (R of them: the bindings,
// then out_cap) comes from a binding, its origin, whose fetched row is
// the rank range [start, end); the rows of the pattern are each valid row
// followed by each key among the first row_cap of that range that passes
// the pattern's tests, in (row, slot) order, cut at out_cap. The merge
// built them as R x row_cap temporaries (2^26 slots at the main path's
// shapes) for a few dozen rows. What bounds it on this card: bytes, a
// few MB: the R flags and counts, the live rows' origins, ranks, filter
// values and in-range keys (read twice), and the step's table and
// origins written once. Both passes take one row a thread and spend
// warp-wide work only on the valid rows whose range holds a key.
//
// sort_merge_compact (sort_merge_count_kernel, a scan of the counts, then
// sort_merge_emit_kernel) replaces no TPU kernel either: it is the reduce
// phase's merge of the reduce-side join (core/reduce_side.py
// `sort_merge_join`) after its sort. Each valid left row ranks its int32
// join key in the sorted relation keys (lower and upper bound); its
// window is the first probe_cap rows of that equal range, and its matches
// are the window's valid rows that pass every extra equality of a left
// column with a right column. The merge built them as an (L, probe_cap)
// grid of gathered rows (2^30 slots at the main path's shapes) for a few
// thousand matches. What bounds it on this card: bytes, a few MB: the L
// left flags, the valid rows' keys and searches, their windows' flags and
// compared columns (read twice, once a pass), the counts, and the step's
// table written once. Both passes take one left row a thread and spend
// warp-wide work only on the rows whose window holds a row, each such row
// on a warp of its own: the live rows are compacted to the front of their
// table, and a window is up to probe_cap rows long, so one warp working
// through 32 neighbouring live rows in turn took most of the op's time.

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

// The residual values of probe p at the positions set in flt_mask.
__device__ __forceinline__ void load_filter(const int64_t* __restrict__ flt,
                                            int64_t p, int flt_mask,
                                            int64_t& f0, int64_t& f1,
                                            int64_t& f2) {
  if (flt_mask & 1) f0 = flt[3 * p + 0];
  if (flt_mask & 2) f1 = flt[3 * p + 1];
  if (flt_mask & 4) f2 = flt[3 * p + 2];
}

// Whether a key's three `bits`-wide fields equal the residual values at
// the flt_mask positions and each other across every eq_mask repeat.
__device__ __forceinline__ bool residual_ok(int64_t key, int64_t f0,
                                            int64_t f1, int64_t f2,
                                            int flt_mask, int eq_mask,
                                            int bits) {
  const int64_t field = (int64_t{1} << bits) - 1;
  const int64_t k0 = (key >> (2 * bits)) & field;
  const int64_t k1 = (key >> bits) & field;
  const int64_t k2 = key & field;
  bool ok = true;
  if (flt_mask & 1) ok = ok && (k0 == f0);
  if (flt_mask & 2) ok = ok && (k1 == f1);
  if (flt_mask & 4) ok = ok && (k2 == f2);
  if (eq_mask & 1) ok = ok && (k0 == k1);
  if (eq_mask & 2) ok = ok && (k0 == k2);
  if (eq_mask & 4) ok = ok && (k1 == k2);
  return ok;
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

  int64_t f0 = 0;
  int64_t f1 = 0;
  int64_t f2 = 0;
  if (start < end) {                  // only the filter values the slots test
    load_filter(flt, w, flt_mask, f0, f1, f2);
  }
  int64_t* row_k = out_k + w * cap;
  bool* row_v = out_valid + w * cap;
  for (int c = lane; c < cap; c += 32) {
    const int64_t idx = start + c;
    bool ok = idx < end;              // end <= m, so the read is in bounds
    int64_t key = 0;
    if (ok) {
      key = __ldg(keys + idx);
      ok = residual_ok(key, f0, f1, f2, flt_mask, eq_mask, bits);
    }
    row_k[c] = ok ? key : 0;
    row_v[c] = ok;
  }
}

constexpr unsigned kAll = 0xffffffffu;

// probe_compact, pass 1 of 2. One thread per probe, 32 probes a warp: each
// lane reads its probe's lo and hi (one coalesced read a warp) and, where
// lo < hi, ranks both. A dead probe costs that read and its two stores.
// Then the warp takes the probes whose range holds a key one at a time,
// its lanes on neighbouring keys, and counts the keys that pass the
// residual by ballot. Writes count[p] (matches among the first `cap` keys
// of the range), missed[p] as probe_gather_kernel does, and start[p]
// where count[p] > 0.
__global__ void probe_count_kernel(const int64_t* __restrict__ keys, int64_t m,
                                   const int64_t* __restrict__ lo,
                                   const int64_t* __restrict__ hi,
                                   const int64_t* __restrict__ flt, int64_t n,
                                   int cap, int flt_mask, int eq_mask, int bits,
                                   int64_t* __restrict__ start_out,
                                   int32_t* __restrict__ count,
                                   int32_t* __restrict__ missed) {
  const int lane = threadIdx.x & 31;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p - lane >= n) return;          // whole warps exit together
  const bool in = p < n;
  int64_t start = 0;
  int64_t end = 0;
  if (in) {
    const int64_t qlo = lo[p];
    const int64_t qhi = hi[p];
    if (qlo < qhi) {
      start = lower_bound(keys, m, qlo);
      end = lower_bound(keys, m, qhi);
    }
  }
  const bool any = start < end;
  int64_t f0 = 0;
  int64_t f1 = 0;
  int64_t f2 = 0;
  if (any) load_filter(flt, p, flt_mask, f0, f1, f2);
  int32_t mine = 0;
  for (unsigned todo = __ballot_sync(kAll, any); todo; todo &= todo - 1) {
    const int j = __ffs(todo) - 1;
    const long long s = __shfl_sync(kAll, static_cast<long long>(start), j);
    const long long e = __shfl_sync(kAll, static_cast<long long>(end), j);
    const long long g0 = __shfl_sync(kAll, static_cast<long long>(f0), j);
    const long long g1 = __shfl_sync(kAll, static_cast<long long>(f1), j);
    const long long g2 = __shfl_sync(kAll, static_cast<long long>(f2), j);
    const long long n_in = e - s < cap ? e - s : cap;
    int32_t got = 0;
    for (long long c0 = 0; c0 < n_in; c0 += 32) {
      const long long c = c0 + lane;  // s + c < e <= m: the read is in bounds
      const bool ok = c < n_in && residual_ok(__ldg(keys + s + c), g0, g1, g2,
                                              flt_mask, eq_mask, bits);
      got += __popc(__ballot_sync(kAll, ok));
    }
    if (lane == j) mine = got;
  }
  if (in) {
    count[p] = mine;
    const int64_t over = end - start - cap;
    missed[p] = static_cast<int32_t>(over > 0 ? over : 0);
    if (mine > 0) start_out[p] = start;
  }
}

// probe_compact, pass 2 of 2, after the exclusive offsets off = incl -
// count of a scan of each slot's counts. blockIdx.y is the slot: its b
// probes, its out_cap rows of w = nv + n_new int32 columns. Thread t of a
// slot writes row t's flag, element t of the slot's table where it lies
// past the kept rows (zero), and, for probe t with matches and off <
// out_cap, the warp re-reads the probe's keys from start, ranks the
// passing ones by ballot and popcount, and writes each kept match at row
// off + rank: the binding's nv columns from `table`, then the fields of
// the key at the n_new positions packed two bits each in new_pos. The
// matches are the first count[p] that pass from start, so the scan stops
// once it has them (or at the end of the keys); the rank of any key that
// passes beyond the range is at least count[p], and it is not written.
// Rows go in (probe, slot) order with no atomics: the first out_cap of a
// slot are kept, as a cumulative count over (probe, slot) keeps them.
__global__ void probe_emit_kernel(const int64_t* __restrict__ keys, int64_t m,
                                  const int64_t* __restrict__ flt,
                                  const int32_t* __restrict__ table, int nv,
                                  const int64_t* __restrict__ start,
                                  const int32_t* __restrict__ count,
                                  const int32_t* __restrict__ incl, int64_t b,
                                  int out_cap, int flt_mask, int eq_mask,
                                  int bits, int new_pos, int n_new,
                                  int32_t* __restrict__ out,
                                  bool* __restrict__ out_valid,
                                  int32_t* __restrict__ dropped,
                                  int32_t* __restrict__ over) {
  const int lane = threadIdx.x & 31;
  const int64_t slot = blockIdx.y;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int w = nv + n_new;
  const int32_t total = incl[slot * b + b - 1];
  const int64_t kept = total < out_cap ? total : out_cap;
  int32_t* slot_out = out + slot * out_cap * w;
  if (t < out_cap) out_valid[slot * out_cap + t] = t < kept;
  if (t >= kept * w && t < static_cast<int64_t>(out_cap) * w) slot_out[t] = 0;
  if (t == 0) {
    over[slot] = total - out_cap;
    dropped[slot] = total > out_cap ? total - out_cap : 0;
  }
  if (t - lane >= b) return;          // whole warps exit together
  const int64_t p = slot * b + t;
  int32_t cnt = 0;
  int32_t off = 0;
  if (t < b) {
    cnt = count[p];
    off = incl[p] - cnt;
  }
  const bool emit = cnt > 0 && off < out_cap;
  int64_t s = 0;
  int64_t f0 = 0;
  int64_t f1 = 0;
  int64_t f2 = 0;
  if (emit) {
    s = start[p];
    load_filter(flt, p, flt_mask, f0, f1, f2);
  }
  const int64_t field = (int64_t{1} << bits) - 1;
  const unsigned below = (1u << lane) - 1;
  for (unsigned todo = __ballot_sync(kAll, emit); todo; todo &= todo - 1) {
    const int j = __ffs(todo) - 1;
    const long long sj = __shfl_sync(kAll, static_cast<long long>(s), j);
    const long long g0 = __shfl_sync(kAll, static_cast<long long>(f0), j);
    const long long g1 = __shfl_sync(kAll, static_cast<long long>(f1), j);
    const long long g2 = __shfl_sync(kAll, static_cast<long long>(f2), j);
    const int32_t offj = __shfl_sync(kAll, off, j);
    const int32_t cntj = __shfl_sync(kAll, cnt, j);
    const int32_t limit = cntj < out_cap - offj ? cntj : out_cap - offj;
    const int32_t* src = table + (p - lane + j) * nv;
    int32_t* dst = slot_out + static_cast<int64_t>(offj) * w;
    int32_t done = 0;
    for (long long c0 = 0; done < limit && sj + c0 < m; c0 += 32) {
      const long long idx = sj + c0 + lane;
      int64_t key = 0;
      bool ok = idx < m;
      if (ok) {
        key = __ldg(keys + idx);
        ok = residual_ok(key, g0, g1, g2, flt_mask, eq_mask, bits);
      }
      const unsigned hits = __ballot_sync(kAll, ok);
      const int32_t rank = done + __popc(hits & below);
      if (ok && rank < limit) {
        int32_t* row = dst + static_cast<int64_t>(rank) * w;
        for (int q = 0; q < nv; ++q) row[q] = src[q];
        for (int q = 0; q < n_new; ++q) {
          const int pos = (new_pos >> (2 * q)) & 3;
          row[nv + q] = static_cast<int32_t>((key >> ((2 - pos) * bits)) & field);
        }
      }
      done += __popc(hits);
    }
  }
}

// Whether a key passes one star pattern's tests: its residual values f
// at flt_mask, its prefix components x at extra_mask, its repeats.
__device__ __forceinline__ bool star_ok(int64_t key, int64_t f0, int64_t f1,
                                        int64_t f2, int64_t x0, int64_t x1,
                                        int64_t x2, int flt_mask,
                                        int extra_mask, int eq_mask,
                                        int bits) {
  return residual_ok(key, f0, f1, f2, flt_mask, eq_mask, bits) &&
         residual_ok(key, x0, x1, x2, extra_mask, 0, bits);
}

// A star row's fetched range and tests: row p (of slot p / r) takes the
// range of binding q = slot * b + origin[p]. Sets q, the range's first
// rank s, its length n_in (at most row_cap) and, where n_in > 0, the
// filter values.
__device__ __forceinline__ void star_row(
    const int64_t* __restrict__ start, const int64_t* __restrict__ end,
    const int64_t* __restrict__ flt, const int64_t* __restrict__ extra,
    const int32_t* __restrict__ origin, int64_t p, int64_t r, int64_t b,
    int row_cap, int flt_mask, int extra_mask, int32_t& o, int64_t& s,
    int64_t& n_in, int64_t& f0, int64_t& f1, int64_t& f2, int64_t& x0,
    int64_t& x1, int64_t& x2) {
  o = origin[p];
  const int64_t q = (p / r) * b + o;
  s = start[q];
  const int64_t e = end[q];
  n_in = e - s < row_cap ? e - s : row_cap;
  if (n_in > 0) {
    load_filter(flt, q, flt_mask, f0, f1, f2);
    load_filter(extra, q, extra_mask, x0, x1, x2);
  }
}

// multiway_compact, pass 1 of 2. One thread per row, 32 rows a warp: each
// lane reads its row's flag (one coalesced read a warp) and, for a valid
// row, its origin, range and filter values. An invalid row costs its
// flag and its store. Then the warp takes the rows whose range holds a
// key one at a time, its lanes on neighbouring keys, and counts the keys
// that pass by ballot. Writes count[p] for each of the n = s * r rows.
__global__ void multiway_count_kernel(
    const int64_t* __restrict__ keys, const int64_t* __restrict__ start,
    const int64_t* __restrict__ end, const int64_t* __restrict__ flt,
    const int64_t* __restrict__ extra, const int32_t* __restrict__ origin,
    const bool* __restrict__ valid, int64_t n, int64_t r, int64_t b,
    int row_cap, int flt_mask, int extra_mask, int eq_mask, int bits,
    int32_t* __restrict__ count) {
  const int lane = threadIdx.x & 31;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p - lane >= n) return;          // whole warps exit together
  const bool in = p < n;
  int32_t o = 0;
  int64_t s = 0;
  int64_t n_in = 0;
  int64_t f0 = 0, f1 = 0, f2 = 0, x0 = 0, x1 = 0, x2 = 0;
  if (in && valid[p]) {
    star_row(start, end, flt, extra, origin, p, r, b, row_cap, flt_mask,
             extra_mask, o, s, n_in, f0, f1, f2, x0, x1, x2);
  }
  int32_t mine = 0;
  for (unsigned todo = __ballot_sync(kAll, n_in > 0); todo; todo &= todo - 1) {
    const int j = __ffs(todo) - 1;
    const long long sj = __shfl_sync(kAll, static_cast<long long>(s), j);
    const long long nj = __shfl_sync(kAll, static_cast<long long>(n_in), j);
    const long long g0 = __shfl_sync(kAll, static_cast<long long>(f0), j);
    const long long g1 = __shfl_sync(kAll, static_cast<long long>(f1), j);
    const long long g2 = __shfl_sync(kAll, static_cast<long long>(f2), j);
    const long long y0 = __shfl_sync(kAll, static_cast<long long>(x0), j);
    const long long y1 = __shfl_sync(kAll, static_cast<long long>(x1), j);
    const long long y2 = __shfl_sync(kAll, static_cast<long long>(x2), j);
    int32_t got = 0;
    for (long long c0 = 0; c0 < nj; c0 += 32) {
      const long long c = c0 + lane;  // s + c < end <= M: in bounds
      const bool ok = c < nj && star_ok(__ldg(keys + sj + c), g0, g1, g2, y0,
                                        y1, y2, flt_mask, extra_mask, eq_mask,
                                        bits);
      got += __popc(__ballot_sync(kAll, ok));
    }
    if (lane == j) mine = got;
  }
  if (in) count[p] = mine;
}

// multiway_compact, pass 2 of 2, after the exclusive offsets off = incl -
// count of a scan of each slot's counts. blockIdx.y is the slot: its r
// rows, its out_cap rows out of w = nv + n_new int32 columns and their
// origins. Thread t of a slot writes out row t's flag, its origin where
// it lies past the kept rows (zero), element t of the slot's table where
// it lies past the kept rows (zero), and, for row t with matches and off
// < out_cap, the warp re-reads the row's range from its start, ranks the
// passing keys by ballot and popcount, and writes each kept match at row
// off + rank: row t's nv columns, the key's fields at the n_new positions
// packed two bits each in new_pos, and the origin. No atomics: rows go
// in (row, slot) order and the first out_cap of a slot are kept, as a
// cumulative count over (row, slot) keeps them.
__global__ void multiway_emit_kernel(
    const int64_t* __restrict__ keys, const int64_t* __restrict__ start,
    const int64_t* __restrict__ end, const int64_t* __restrict__ flt,
    const int64_t* __restrict__ extra, const int32_t* __restrict__ origin,
    const int32_t* __restrict__ table, int nv,
    const int32_t* __restrict__ count, const int32_t* __restrict__ incl,
    int64_t r, int64_t b, int row_cap, int out_cap, int flt_mask,
    int extra_mask, int eq_mask, int bits, int new_pos, int n_new,
    int32_t* __restrict__ out, bool* __restrict__ out_valid,
    int32_t* __restrict__ out_origin, int32_t* __restrict__ dropped,
    int32_t* __restrict__ over) {
  const int lane = threadIdx.x & 31;
  const int64_t slot = blockIdx.y;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int w = nv + n_new;
  const int32_t total = incl[slot * r + r - 1];
  const int64_t kept = total < out_cap ? total : out_cap;
  int32_t* slot_out = out + slot * out_cap * w;
  int32_t* slot_origin = out_origin + slot * out_cap;
  if (t < out_cap) {
    out_valid[slot * out_cap + t] = t < kept;
    if (t >= kept) slot_origin[t] = 0;
  }
  if (t >= kept * w && t < static_cast<int64_t>(out_cap) * w) slot_out[t] = 0;
  if (t == 0) {
    over[slot] = total - out_cap;
    dropped[slot] = total > out_cap ? total - out_cap : 0;
  }
  if (t - lane >= r) return;          // whole warps exit together
  const int64_t p = slot * r + t;
  int32_t cnt = 0;
  int32_t off = 0;
  if (t < r) {
    cnt = count[p];
    off = incl[p] - cnt;
  }
  const bool emit = cnt > 0 && off < out_cap;
  int32_t o = 0;
  int64_t s = 0;
  int64_t n_in = 0;
  int64_t f0 = 0, f1 = 0, f2 = 0, x0 = 0, x1 = 0, x2 = 0;
  if (emit) {
    star_row(start, end, flt, extra, origin, p, r, b, row_cap, flt_mask,
             extra_mask, o, s, n_in, f0, f1, f2, x0, x1, x2);
  }
  const int64_t field = (int64_t{1} << bits) - 1;
  const unsigned below = (1u << lane) - 1;
  for (unsigned todo = __ballot_sync(kAll, emit); todo; todo &= todo - 1) {
    const int j = __ffs(todo) - 1;
    const long long sj = __shfl_sync(kAll, static_cast<long long>(s), j);
    const long long nj = __shfl_sync(kAll, static_cast<long long>(n_in), j);
    const long long g0 = __shfl_sync(kAll, static_cast<long long>(f0), j);
    const long long g1 = __shfl_sync(kAll, static_cast<long long>(f1), j);
    const long long g2 = __shfl_sync(kAll, static_cast<long long>(f2), j);
    const long long y0 = __shfl_sync(kAll, static_cast<long long>(x0), j);
    const long long y1 = __shfl_sync(kAll, static_cast<long long>(x1), j);
    const long long y2 = __shfl_sync(kAll, static_cast<long long>(x2), j);
    const int32_t oj = __shfl_sync(kAll, o, j);
    const int32_t offj = __shfl_sync(kAll, off, j);
    const int32_t cntj = __shfl_sync(kAll, cnt, j);
    const int32_t limit = cntj < out_cap - offj ? cntj : out_cap - offj;
    const int32_t* src = table + (p - lane + j) * nv;
    int32_t* dst = slot_out + static_cast<int64_t>(offj) * w;
    int32_t* dst_origin = slot_origin + offj;
    int32_t done = 0;
    for (long long c0 = 0; done < limit && c0 < nj; c0 += 32) {
      const long long c = c0 + lane;
      int64_t key = 0;
      bool ok = c < nj;               // s + c < end <= M: in bounds
      if (ok) {
        key = __ldg(keys + sj + c);
        ok = star_ok(key, g0, g1, g2, y0, y1, y2, flt_mask, extra_mask,
                     eq_mask, bits);
      }
      const unsigned hits = __ballot_sync(kAll, ok);
      const int32_t rank = done + __popc(hits & below);
      if (ok && rank < limit) {
        int32_t* row = dst + static_cast<int64_t>(rank) * w;
        for (int q = 0; q < nv; ++q) row[q] = src[q];
        for (int q = 0; q < n_new; ++q) {
          const int pos = (new_pos >> (2 * q)) & 3;
          row[nv + q] = static_cast<int32_t>((key >> ((2 - pos) * bits)) & field);
        }
        dst_origin[rank] = oj;
      }
      done += __popc(hits);
    }
  }
}

// sort_merge_compact's passes hand a block's rows to its warps: a block
// is kSmBlock threads, one left row each, and each warp takes the
// block's rows with window work in turn. The bindings a step joins are
// compacted to the front of their table, so the live rows sit side by
// side: one warp a row, not one warp for 32 of them.
constexpr int kSmBlock = 1024;
constexpr int kSmWarps = kSmBlock / 32;
constexpr int kSmBatch = 4;           // window chunks of 32 loaded at once

// Both ranks of x in sorted int32 keys: lo, the first key not below x,
// and hi, the first key above it. The two searches step together, so
// their loads overlap.
__device__ __forceinline__ void equal_range32(const int32_t* __restrict__ keys,
                                              int64_t m, int32_t x,
                                              int64_t& lo, int64_t& hi) {
  int64_t a = 0, na = m, b = 0, nb = m;
  while (na > 0 || nb > 0) {
    const int64_t ha = na >> 1;
    const int64_t hb = nb >> 1;
    const int32_t ka = na > 0 ? __ldg(keys + a + ha) : 0;
    const int32_t kb = nb > 0 ? __ldg(keys + b + hb) : 0;
    if (na > 0) {
      if (ka < x) { a += ha + 1; na -= ha + 1; } else { na = ha; }
    }
    if (nb > 0) {
      if (kb <= x) { b += hb + 1; nb -= hb + 1; } else { nb = hb; }
    }
  }
  lo = a;
  hi = b;
}

// Whether right row r is valid and holds the left values v at the n_eq
// right columns packed eight bits each in eq_right. Every load is issued
// whatever the others read, so they overlap.
__device__ __forceinline__ bool right_ok(const int32_t* __restrict__ rts,
                                         int nvr, const bool* __restrict__ rvs,
                                         int64_t r, int n_eq, int eq_right,
                                         int32_t v0, int32_t v1, int32_t v2) {
  const int32_t* row = rts + r * nvr;
  bool ok = rvs[r];
  if (n_eq > 0) ok &= row[eq_right & 255] == v0;
  if (n_eq > 1) ok &= row[(eq_right >> 8) & 255] == v1;
  if (n_eq > 2) ok &= row[(eq_right >> 16) & 255] == v2;
  return ok;
}

// The left values of row p at the n_eq columns packed in eq_left.
__device__ __forceinline__ void left_values(const int32_t* __restrict__ lt,
                                            int nvl, int64_t p, int n_eq,
                                            int eq_left, int32_t& v0,
                                            int32_t& v1, int32_t& v2) {
  const int32_t* row = lt + p * nvl;
  if (n_eq > 0) v0 = row[eq_left & 255];
  if (n_eq > 1) v1 = row[(eq_left >> 8) & 255];
  if (n_eq > 2) v2 = row[(eq_left >> 16) & 255];
}

// The block's threads whose `mine` is set, in thread order, into list;
// returns their number. Every thread of the block calls it; it ends on a
// barrier, so what the threads wrote to shared memory before it is seen.
__device__ __forceinline__ int block_list(bool mine, int* list, int* base) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned hits = __ballot_sync(kAll, mine);
  if (lane == 0) base[warp] = __popc(hits);
  __syncthreads();
  if (warp == 0) {                    // exclusive scan of the warps' counts
    const int v = base[lane];
    int incl = v;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kAll, incl, d);
      if (lane >= d) incl += y;
    }
    base[lane] = incl - v;
    if (lane == 31) base[32] = incl;
  }
  __syncthreads();
  if (mine) list[base[warp] + __popc(hits & ((1u << lane) - 1))] = threadIdx.x;
  __syncthreads();
  return base[32];
}

// The sum of v over the warp's lanes.
__device__ __forceinline__ int32_t warp_sum(int32_t v) {
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kAll, v, d);
  return v;
}

// sort_merge_compact, pass 1 of 2. One thread per left row: it reads its
// row's flag (coalesced) and, for a valid row, its key, both ranks of the
// key in the sorted relation (lo, hi) and its left equality values. An
// invalid row costs its flag and two stores. Then each warp takes the
// block's rows whose window [lo, min(hi, lo + probe_cap)) holds a row, one
// at a time, its lanes on neighbouring right rows, each counting its own.
// Writes count[p] and missed[p] = max(hi - lo - probe_cap, 0) (cm is count
// then missed, 2 l int32, scanned whole after), and the window's start
// and length (win, 2 l int32) where count[p] > 0.
__global__ void __launch_bounds__(kSmBlock) sort_merge_count_kernel(
    const int32_t* __restrict__ rks, int64_t m, const int32_t* __restrict__ rts,
    int nvr, const bool* __restrict__ rvs, const int32_t* __restrict__ lt,
    int nvl, const bool* __restrict__ lv, int64_t l, int lkey_col,
    int probe_cap, int n_eq, int eq_left, int eq_right,
    int32_t* __restrict__ cm, int32_t* __restrict__ win) {
  __shared__ int list[kSmBlock];
  __shared__ int base[33];
  __shared__ int32_t s_lo[kSmBlock], s_n[kSmBlock], s_cnt[kSmBlock];
  __shared__ int32_t s_v[3][kSmBlock];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kSmBlock + tid;
  const bool in = p < l;
  int64_t lo = 0;
  int64_t hi = 0;
  int32_t v0 = 0, v1 = 0, v2 = 0;
  if (in && lv[p]) {
    equal_range32(rks, m, lt[p * nvl + lkey_col], lo, hi);
    if (lo < hi) left_values(lt, nvl, p, n_eq, eq_left, v0, v1, v2);
  }
  const int64_t n_in = hi - lo < probe_cap ? hi - lo : probe_cap;
  s_lo[tid] = static_cast<int32_t>(lo);
  s_n[tid] = static_cast<int32_t>(n_in);
  s_cnt[tid] = 0;
  s_v[0][tid] = v0;
  s_v[1][tid] = v1;
  s_v[2][tid] = v2;
  const int n = block_list(n_in > 0, list, base);
  for (int i = tid >> 5; i < n; i += kSmWarps) {
    const int r = list[i];
    const int64_t sr = s_lo[r];
    const int32_t nr = s_n[r];
    const int32_t g0 = s_v[0][r], g1 = s_v[1][r], g2 = s_v[2][r];
    int32_t got = 0;
#pragma unroll 4
    for (int32_t c = lane; c < nr; c += 32) {   // sr + c < hi <= m
      got += right_ok(rts, nvr, rvs, sr + c, n_eq, eq_right, g0, g1, g2);
    }
    got = warp_sum(got);
    if (lane == 0) s_cnt[r] = got;
  }
  __syncthreads();
  if (in) {
    const int32_t mine = s_cnt[tid];
    const int64_t over = hi - lo - probe_cap;
    cm[p] = mine;
    cm[l + p] = static_cast<int32_t>(over > 0 ? over : 0);
    if (mine > 0) {
      win[p] = static_cast<int32_t>(lo);
      win[l + p] = static_cast<int32_t>(n_in);
    }
  }
}

// sort_merge_compact, pass 2 of 2, after the inclusive scan incl of cm
// (count then missed), so that off = incl[p] - count[p], the matches are
// incl[l - 1] and the missed rows incl[2 l - 1] - incl[l - 1]. Thread t
// writes out row t's flag and element t of the table where it lies past
// the kept rows (zero). Left row t with matches and off < out_cap goes to
// its block's list; each warp takes the listed rows one at a time,
// re-reads the row's window kSmBatch chunks of 32 at once, ranks the
// passing right rows by ballot and popcount, and writes each kept match at
// row off + rank: the left row's nvl columns, then the right row's n_out
// columns packed eight bits each in r_out. No atomics: rows go in (left
// row, window) order and the first out_cap are kept, as a cumulative count
// over the grid keeps them.
__global__ void __launch_bounds__(kSmBlock) sort_merge_emit_kernel(
    const int32_t* __restrict__ rts, int nvr, const bool* __restrict__ rvs,
    const int32_t* __restrict__ lt, int nvl, int64_t l,
    const int32_t* __restrict__ cm, const int32_t* __restrict__ incl,
    const int32_t* __restrict__ win, int out_cap, int n_eq, int eq_left,
    int eq_right, int r_out, int n_out, int32_t* __restrict__ out,
    bool* __restrict__ out_valid, int32_t* __restrict__ dropped,
    int32_t* __restrict__ over) {
  __shared__ int list[kSmBlock];
  __shared__ int base[33];
  __shared__ int32_t s_lo[kSmBlock], s_n[kSmBlock], s_off[kSmBlock],
      s_lim[kSmBlock];
  __shared__ int32_t s_v[3][kSmBlock];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kSmBlock + tid;
  const int w = nvl + n_out;
  const int32_t total = incl[l - 1];
  const int64_t kept = total < out_cap ? total : out_cap;
  if (t < out_cap) out_valid[t] = t < kept;
  if (t >= kept * w && t < static_cast<int64_t>(out_cap) * w) out[t] = 0;
  if (t == 0) {
    // int32 sums that wrap as the plain version's int32 counts do
    const uint32_t missed = static_cast<uint32_t>(incl[2 * l - 1]) -
                            static_cast<uint32_t>(total);
    const int32_t ov = total - out_cap;
    over[0] = ov;
    dropped[0] = static_cast<int32_t>(static_cast<uint32_t>(ov > 0 ? ov : 0) +
                                      missed);
  }
  if (static_cast<int64_t>(blockIdx.x) * kSmBlock >= l) return;  // whole block
  int32_t cnt = 0;
  int32_t off = 0;
  if (t < l) {
    cnt = cm[t];
    off = incl[t] - cnt;
  }
  const bool emit = cnt > 0 && off < out_cap;
  if (emit) {
    int32_t v0 = 0, v1 = 0, v2 = 0;
    left_values(lt, nvl, t, n_eq, eq_left, v0, v1, v2);
    s_lo[tid] = win[t];
    s_n[tid] = win[l + t];
    s_off[tid] = off;
    s_lim[tid] = cnt < out_cap - off ? cnt : out_cap - off;
    s_v[0][tid] = v0;
    s_v[1][tid] = v1;
    s_v[2][tid] = v2;
  }
  const int n = block_list(emit, list, base);
  const unsigned below = (1u << lane) - 1;
  const int c0q = r_out & 255, c1q = (r_out >> 8) & 255, c2q = (r_out >> 16) & 255;
  for (int i = tid >> 5; i < n; i += kSmWarps) {
    const int r = list[i];
    const int64_t sr = s_lo[r];
    const int32_t nr = s_n[r];
    const int32_t limit = s_lim[r];
    const int32_t g0 = s_v[0][r], g1 = s_v[1][r], g2 = s_v[2][r];
    const int32_t* src = lt + (t - tid + r) * nvl;
    int32_t* dst = out + static_cast<int64_t>(s_off[r]) * w;
    int32_t done = 0;
    for (int32_t c0 = 0; done < limit && c0 < nr; c0 += 32 * kSmBatch) {
      bool ok[kSmBatch];
      int32_t x0[kSmBatch], x1[kSmBatch], x2[kSmBatch];
#pragma unroll
      for (int k = 0; k < kSmBatch; ++k) {
        const int32_t c = c0 + 32 * k + lane;
        ok[k] = false;
        x0[k] = x1[k] = x2[k] = 0;
        if (c < nr) {                 // sr + c < hi <= m: in bounds
          const int32_t* row = rts + (sr + c) * nvr;
          ok[k] = right_ok(rts, nvr, rvs, sr + c, n_eq, eq_right, g0, g1, g2);
          if (n_out > 0) x0[k] = row[c0q];
          if (n_out > 1) x1[k] = row[c1q];
          if (n_out > 2) x2[k] = row[c2q];
        }
      }
#pragma unroll
      for (int k = 0; k < kSmBatch; ++k) {
        const unsigned hits = __ballot_sync(kAll, ok[k]);
        const int32_t rank = done + __popc(hits & below);
        if (ok[k] && rank < limit) {
          int32_t* row = dst + static_cast<int64_t>(rank) * w;
          for (int q = 0; q < nvl; ++q) row[q] = src[q];
          if (n_out > 0) row[nvl] = x0[k];
          if (n_out > 1) row[nvl + 1] = x1[k];
          if (n_out > 2) row[nvl + 2] = x2[k];
        }
        done += __popc(hits);
      }
    }
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

// probe_compact's passes over s slots of b probes (n = s * b), for the
// wrapper kernels/probe_gather.py `probe_compact_cuda`, which scans the
// counts between them. new_pos: the new fields' positions, two bits each.
extern "C" int probe_count_i64(const void* keys, int64_t m, const void* lo,
                               const void* hi, const void* flt, int64_t n,
                               int cap, int flt_mask, int eq_mask, int bits,
                               void* start, void* count, void* missed,
                               void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  probe_count_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), m, static_cast<const int64_t*>(lo),
      static_cast<const int64_t*>(hi), static_cast<const int64_t*>(flt), n,
      cap, flt_mask, eq_mask, bits, static_cast<int64_t*>(start),
      static_cast<int32_t*>(count), static_cast<int32_t*>(missed));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_emit_i64(const void* keys, int64_t m, const void* flt,
                              const void* table, int nv, const void* start,
                              const void* count, const void* incl, int64_t s,
                              int64_t b, int out_cap, int flt_mask,
                              int eq_mask, int bits, int new_pos, int n_new,
                              void* out, void* out_valid, void* dropped,
                              void* over, void* stream) {
  if (s <= 0 || b <= 0) return 0;
  const int threads = 256;
  int64_t span = static_cast<int64_t>(out_cap) * (nv + n_new);
  if (span < out_cap) span = out_cap;
  if (span < b) span = b;
  const int64_t blocks = (span + threads - 1) / threads;
  if (blocks > 0x7fffffff || s > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned int>(blocks),
                  static_cast<unsigned int>(s));
  probe_emit_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), m, static_cast<const int64_t*>(flt),
      static_cast<const int32_t*>(table), nv,
      static_cast<const int64_t*>(start), static_cast<const int32_t*>(count),
      static_cast<const int32_t*>(incl), b, out_cap, flt_mask, eq_mask, bits,
      new_pos, n_new, static_cast<int32_t*>(out), static_cast<bool*>(out_valid),
      static_cast<int32_t*>(dropped), static_cast<int32_t*>(over));
  return static_cast<int>(cudaGetLastError());
}

// multiway_compact's passes over s slots of r rows (n = s * r) whose
// origins index b bindings a slot, for the wrapper kernels/probe_gather.py
// `multiway_compact_cuda`, which scans the counts between them.
// extra_mask: the positions of the prefix components tested like flt_mask.
extern "C" int multiway_count_i64(const void* keys, const void* start,
                                  const void* end, const void* flt,
                                  const void* extra, const void* origin,
                                  const void* valid, int64_t n, int64_t r,
                                  int64_t b, int row_cap, int flt_mask,
                                  int extra_mask, int eq_mask, int bits,
                                  void* count, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  multiway_count_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), static_cast<const int64_t*>(start),
      static_cast<const int64_t*>(end), static_cast<const int64_t*>(flt),
      static_cast<const int64_t*>(extra), static_cast<const int32_t*>(origin),
      static_cast<const bool*>(valid), n, r, b, row_cap, flt_mask, extra_mask,
      eq_mask, bits, static_cast<int32_t*>(count));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int multiway_emit_i64(const void* keys, const void* start,
                                 const void* end, const void* flt,
                                 const void* extra, const void* origin,
                                 const void* table, int nv, const void* count,
                                 const void* incl, int64_t s, int64_t r,
                                 int64_t b, int row_cap, int out_cap,
                                 int flt_mask, int extra_mask, int eq_mask,
                                 int bits, int new_pos, int n_new, void* out,
                                 void* out_valid, void* out_origin,
                                 void* dropped, void* over, void* stream) {
  if (s <= 0 || r <= 0) return 0;
  const int threads = 256;
  int64_t span = static_cast<int64_t>(out_cap) * (nv + n_new);
  if (span < out_cap) span = out_cap;
  if (span < r) span = r;
  const int64_t blocks = (span + threads - 1) / threads;
  if (blocks > 0x7fffffff || s > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned int>(blocks),
                  static_cast<unsigned int>(s));
  multiway_emit_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), static_cast<const int64_t*>(start),
      static_cast<const int64_t*>(end), static_cast<const int64_t*>(flt),
      static_cast<const int64_t*>(extra), static_cast<const int32_t*>(origin),
      static_cast<const int32_t*>(table), nv,
      static_cast<const int32_t*>(count), static_cast<const int32_t*>(incl), r,
      b, row_cap, out_cap, flt_mask, extra_mask, eq_mask, bits, new_pos, n_new,
      static_cast<int32_t*>(out), static_cast<bool*>(out_valid),
      static_cast<int32_t*>(out_origin), static_cast<int32_t*>(dropped),
      static_cast<int32_t*>(over));
  return static_cast<int>(cudaGetLastError());
}

// sort_merge_compact's passes over l left rows against m sorted right rows,
// for the wrapper kernels/probe_gather.py `sort_merge_compact_cuda`, which
// scans the counts between them. eq_left / eq_right: the columns of the
// n_eq extra equalities, eight bits each; r_out: the n_out right columns
// written after the left ones, eight bits each.
extern "C" int sort_merge_count_i32(const void* rks, int64_t m,
                                    const void* rts, int nvr, const void* rvs,
                                    const void* lt, int nvl, const void* lv,
                                    int64_t l, int lkey_col, int probe_cap,
                                    int n_eq, int eq_left, int eq_right,
                                    void* cm, void* win, void* stream) {
  if (l <= 0) return 0;
  const int64_t blocks = (l + kSmBlock - 1) / kSmBlock;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  sort_merge_count_kernel<<<static_cast<unsigned int>(blocks), kSmBlock, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rks), m, static_cast<const int32_t*>(rts),
      nvr, static_cast<const bool*>(rvs), static_cast<const int32_t*>(lt), nvl,
      static_cast<const bool*>(lv), l, lkey_col, probe_cap, n_eq, eq_left,
      eq_right, static_cast<int32_t*>(cm), static_cast<int32_t*>(win));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sort_merge_emit_i32(const void* rts, int nvr, const void* rvs,
                                   const void* lt, int nvl, int64_t l,
                                   const void* cm, const void* incl,
                                   const void* win, int out_cap, int n_eq,
                                   int eq_left, int eq_right, int r_out,
                                   int n_out, void* out, void* out_valid,
                                   void* dropped, void* over, void* stream) {
  if (l <= 0) return 0;
  int64_t span = static_cast<int64_t>(out_cap) * (nvl + n_out);
  if (span < out_cap) span = out_cap;
  if (span < l) span = l;
  const int64_t blocks = (span + kSmBlock - 1) / kSmBlock;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  sort_merge_emit_kernel<<<static_cast<unsigned int>(blocks), kSmBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rts), nvr, static_cast<const bool*>(rvs),
      static_cast<const int32_t*>(lt), nvl, l,
      static_cast<const int32_t*>(cm), static_cast<const int32_t*>(incl),
      static_cast<const int32_t*>(win), out_cap, n_eq, eq_left, eq_right,
      r_out, n_out, static_cast<int32_t*>(out), static_cast<bool*>(out_valid),
      static_cast<int32_t*>(dropped), static_cast<int32_t*>(over));
  return static_cast<int>(cudaGetLastError());
}
