// Binned scan kernels of usearch_torch, for Hopper (sm_90a).
//
// B1 `usearch_binned_scan` replaces the TPU kernel `_make_binned_t_kernel`
// (usearch_tpu/ops/pallas_scan.py:446), which `pallas_search_binned
// (transposed=True)` launches for approximate search. B2
// `usearch_binned_minima` replaces `_make_binned_t_min_kernel`
// (pallas_scan.py:631), which `pallas_search_exact` launches for exact
// search. For every query and every 128-row bin of the table both compute
// the dots, the ip/cos/l2sq epilogue plus the deleted-row penalty
// (scan_common.cuh), and the bin's minimum; B1 also keeps the first row that
// reaches it (strict '<' in row order, as jnp.argmin).
//
// Outputs are [n_q, n_bins], so the top-k that follows reads each query's
// bins as one contiguous row:
//   B1          f32 minima + i32 global row ids
//   B1 compact  bf16 minima of the shifted distance + i8 row within the bin;
//               an f32 table is rounded to bf16 here, and its queries arrive
//               rounded to bf16 (`q` then points at bf16 rows)
//   B2          f32 minima only
//
// Bound on this card: the work is a [n_q, W] x [W, N] product. At the
// serving shape (N = 2^20, W = 256, Q = 16384) that is 8.8e12 operations
// against 0.3 GB of memory traffic (the table once, the surfaces once), so
// the tensor cores bound it: 4.4 ms at the int8 rate, 2.2 ms for the f32
// compact path's bf16 product at N = 262,144.
//
// Design, for i8, bf16 and compact f32 (`wgmma_scan`): the product runs on
// the tensor cores, `wgmma.mma_async` s32 += s8 x s8 (m64n256k32) or f32 +=
// bf16 x bf16 (m64n256k16), both operands K-major as they lie in memory.
// - Loop order: a block owns 256 table rows (two bins) and walks every query
//   tile, so the table is read from memory once and the queries come from
//   L2 (4 MB at the i8 serving shape). The table tile stays in shared memory
//   for the whole block when its rows are at most 512 bytes (i8 W <= 512,
//   bf16 W <= 256); wider rows stream the table's 128-byte K-block beside
//   each query K-block.
// - Copies: 2-D TMA boxes of 128 bytes x rows with the 128-byte swizzle that
//   `wgmma` reads; an f32 table is rounded to bf16 by threads and written in
//   that swizzle, then fenced for the async proxy.
// - Two warpgroups, each its own producer: each keeps a ring of up to 8
//   query K-blocks in flight under mbarriers, refilling a slot as soon as
//   its product is done, and owns 64 queries x 256 rows of accumulators (128
//   registers a thread). A separate producer warp would put three warps on
//   one SM quarter and cap every thread at 168 registers.
// - Epilogue in registers, one instantiation per metric: per thread the
//   (distance, row) minimum over its 32 rows of each bin, in lexicographic
//   order so the first row reaching the minimum wins, then two shuffles
//   across the four threads of a query, and one store per query for both
//   bins. Square roots are taken once per query and row. i8 dots within
//   2^22 convert exactly without the quarter-rate I2F; i8 ip with 0/MASKED
//   penalties ranks integer keys; cos ranks an approximate quotient and
//   takes __fdiv_rn only on the rows that can reach the minimum.
// The building blocks (tile shapes, `Aux`, mbarrier/TMA/descriptor helpers,
// `mma_k`, the register epilogue `tile_minima` and the host's tensor maps)
// live in csrc/wgmma_common.cuh, shared with B8/B9 (csrc/fused.cu); this
// file keeps the kernel's loop, its ring and shared-memory `Layout`, its
// per-row and per-query values (the lines of the header's `set_row` and
// `query_values`, inline: calling them changes this kernel's SASS) and its
// stores.
// What holds it back on the card (PERF.md, Findings): the product and the
// query stream together reach 50-59% of the tensor-core rate, and the
// epilogue adds to them instead of overlapping them.
//
// f32 storage outside compact mode (B1 f32, B2 f32: the exact f32 path)
// keeps a SIMT f32-FMA product (`simt_scan`), since no exact path may use
// TF32; its bound is the f32 FMA rate (2.05 ms at Q = 1,024, N = 262,144,
// W = 256). Every (query, row) dot is one __fmaf_rn chain over the width in
// ascending order, so its minima and rows do not depend on the tiling:
// - a block owns one bin and 128 queries, each of its 128 threads 8 rows x
//   16 queries, 128 accumulators, so 24 float4 reads from shared memory
//   feed 512 FMAs; two blocks an SM (255 registers a thread), so one's
//   prologue and epilogue overlap the other's product; the query tiles of
//   a bin are neighbours in the grid, so the table is read from device
//   memory about once;
// - the width streams through a ring of three 32-float slabs of the bin's
//   rows and the tile's queries, filled by 16-byte cp.async copies two
//   slabs ahead, one barrier a slab; rows lie as in memory, pitch 36
//   floats, so the product reads each operand as a float4 without bank
//   conflicts;
// - the epilogue goes through shared memory, one thread a query over the
//   bin's 128 rows in rolled loops: no reduction across threads, little
//   code, and each row's values (roots, reciprocals) computed once; cos
//   takes __fdiv_rn only on the row B1's preselection picks.
//
// Every entry point launches on the stream it is given, allocates nothing,
// and returns cudaGetLastError() after its launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "scan_common.cuh"
#include "wgmma_common.cuh"

namespace {


// ---------------------------------------------------------------------------
// SIMT f32 kernel

constexpr int kThreads = 128;               // threads of a block
constexpr int kTM = 8;                      // rows per thread, 16 apart
constexpr int kTN = 16;                     // queries per thread, kQG apart
constexpr int kQG = kThreads / (kBin / kTM);  // query groups: threads of one row group
constexpr int kBQ = kQG * kTN;              // queries of one block
constexpr int kMinBlocks = 2;               // blocks an SM, each with 255 registers a thread
constexpr int kSK = 32;                     // floats of the width per slab
constexpr int kSP = kSK + 4;  // slab pitch in floats: 8 neighbouring rows' float4s on distinct banks
constexpr int kStages = 3;    // slabs of the ring
constexpr int kSlab = (kBin + kBQ) * kSP;       // floats of one slot: the bin's rows, then the queries'
constexpr int kDP = kBQ + kQG;  // pitch of the dots [kBin][kBQ] in the ring after the product: no conflicts
constexpr int kSimtSmem = kStages * kSlab * 4;  // 110,592 bytes: two blocks an SM

constexpr int kChunks = kSK / 4;              // 16-byte chunks of a row's slab
constexpr int kRowStep = kThreads / kChunks;  // rows that one pass of the block's copies covers
static_assert(kBin % kRowStep == 0 && kBQ % kRowStep == 0 && kBQ == kThreads && kBin <= kThreads &&
                  kBin * kDP + 5 * kBin <= kStages * kSlab,
              "the copies cover whole rows; a thread a query; the dots and row values fit in the ring");

// One thread's 16-byte copies of a slab: chunk c = tid % kChunks of rows
// r + kRowStep p (r = tid / kChunks) of the bin and of the query tile.
struct SlabCopies {
  const float* t;  // the thread's first chunk of slab 0 in the table
  const float* q;  // and in the queries
  int skip;        // floats from one of its rows to the next
  int dst;         // the first chunk's offset in a slot, in floats
  int col;         // the chunk's first float in the slab
  int q_left;      // query rows from its first one to the tile's end
};

__device__ __forceinline__ SlabCopies slab_copies(const float* __restrict__ t_base, const float* __restrict__ q_base,
                                                  int width, int q_rows, int tid) {
  SlabCopies c;
  const int r = tid / kChunks;
  c.col = tid % kChunks * 4;
  c.t = t_base + (size_t)r * width + c.col;
  c.q = q_base + (size_t)r * width + c.col;
  c.skip = kRowStep * width;
  c.dst = r * kSP + c.col;
  c.q_left = q_rows - r;
  return c;
}

// Slab s (floats [kSK s, kSK s + kSK) of every row) of the bin's rows and
// the tile's queries into `slot`, row-major with pitch kSP: the bin's 128
// rows, then the 128 queries. Chunks past the width and query rows past
// q_rows are zero-filled (read from a valid address, 0 bytes).
__device__ __forceinline__ void fetch_slab(float* slot, const SlabCopies& c, int width, int s) {
  const int w = s * kSK;
  const bool in = w + c.col < width;
#pragma unroll
  for (int p = 0; p < kBin / kRowStep; ++p)
    __pipeline_memcpy_async(slot + c.dst + kRowStep * p * kSP, in ? c.t + w + p * c.skip : c.t, 16, in ? 0 : 16);
#pragma unroll
  for (int p = 0; p < kBQ / kRowStep; ++p) {
    const bool q_in = in && kRowStep * p < c.q_left;
    __pipeline_memcpy_async(slot + c.dst + (kBin + kRowStep * p) * kSP, q_in ? c.q + w + p * c.skip : c.t, 16,
                            q_in ? 0 : 16);
  }
}

// acc[i][j] += the dots of one slab: rows ty + 16 i (from `a`, this
// thread's first row) with queries tx + kQG j (from `b`), one __fmaf_rn a
// float in ascending order, each float4 read once: per 4 floats the rows'
// float4s are held and the queries' streamed past them. Unrolled by two
// only: unrolled whole, the slab's 4,096 FMAs made the cos kernel 22%
// slower (PERF.md, PR 10).
__device__ __forceinline__ void slab_fma(float (&acc)[kTM][kTN], const float* a, const float* b) {
#pragma unroll 2
  for (int c = 0; c < kSK; c += 4) {
    float4 av[kTM];
#pragma unroll
    for (int i = 0; i < kTM; ++i) av[i] = *reinterpret_cast<const float4*>(a + i * 16 * kSP + c);
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const float4 bv = *reinterpret_cast<const float4*>(b + j * kQG * kSP + c);
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        acc[i][j] = __fmaf_rn(av[i].x, bv.x, acc[i][j]);
        acc[i][j] = __fmaf_rn(av[i].y, bv.y, acc[i][j]);
        acc[i][j] = __fmaf_rn(av[i].z, bv.z, acc[i][j]);
        acc[i][j] = __fmaf_rn(av[i].w, bv.w, acc[i][j]);
      }
    }
  }
}

// One block per (bin, query tile), the query tiles of a bin neighbours in
// the grid, so each bin's rows come from device memory once and from L2
// for the other tiles. The width streams through a ring of kStages slabs:
// each thread waits for a slab, passes one barrier (after which the slot
// read a slab ago is free) and refills that slot before its product.
template <int kMode>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
simt_scan(const float* __restrict__ q, const float* __restrict__ table, const float* __restrict__ q_sq,
          const float* __restrict__ t_sq, const float* __restrict__ penalty, void* __restrict__ out_v,
          void* __restrict__ out_i, int n_q, int n_bins, int width, int metric) {
  extern __shared__ __align__(16) float ring[];

  const int tid = threadIdx.x;
  const int tx = tid % kQG;  // queries tx + kQG j
  const int ty = tid / kQG;  // rows ty + 16 i
  const int n_qt = (n_q + kBQ - 1) / kBQ;
  const int bin = blockIdx.x / n_qt;
  const int q0 = blockIdx.x % n_qt * kBQ;
  const int row0 = bin * kBin;
  const int q_rows = min(kBQ, n_q - q0);
  const float* t_base = table + (size_t)row0 * width;
  const float* q_base = q + (size_t)q0 * width;
  const int n_slabs = (width + kSK - 1) / kSK;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  const SlabCopies copies = slab_copies(t_base, q_base, width, q_rows, tid);
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_slabs) fetch_slab(ring + s * kSlab, copies, width, s);
    __pipeline_commit();
  }
  for (int s = 0; s < n_slabs; ++s) {
    __pipeline_wait_prior(kStages - 2);  // this thread's copies of slab s have landed
    __syncthreads();                     // everyone's have, and slab s - 1's slot is read
    const int next = s + kStages - 1;
    if (next < n_slabs) fetch_slab(ring + next % kStages * kSlab, copies, width, next);
    __pipeline_commit();
    const float* slot = ring + s % kStages * kSlab;
    slab_fma(acc, slot + ty * kSP, slot + (kBin + tx) * kSP);
  }
  __pipeline_wait_prior(0);
  __syncthreads();  // every slab is read: the ring holds the dots and the rows' values now

  // The epilogue, one thread a query over the bin's rows in ascending
  // order, strict '<', so the first row reaching the minimum wins
  // (jnp.argmin): the dots go to shared memory, and each row's values are
  // computed once (the roots: the epilogue's own bits).
  float* dots = ring;  // [kBin][kDP]
  float* r_pen = ring + kBin * kDP;
  float* r_tsq = r_pen + kBin;
  float* r_trt = r_tsq + kBin;
  float* r_itr = r_trt + kBin;
  float* r_cpen = r_itr + kBin;
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) dots[(ty + 16 * i) * kDP + tx + kQG * j] = acc[i][j];
  bool irregular = false;
  if (tid < kBin) {
    const float pen = __ldg(penalty + row0 + tid);
    const float ts = metric == kIP ? 0.0f : __ldg(t_sq + row0 + tid);
    const float tr = __fsqrt_rn(ts);
    r_pen[tid] = pen;
    r_tsq[tid] = ts;
    r_trt[tid] = tr;
    r_itr[tid] = tr == 0.0f ? 0.0f : __frcp_rn(tr);
    r_cpen[tid] = __fadd_rn(1.0f, pen);
    irregular = !regular_root(tr);
  }
  irregular = __syncthreads_or(irregular);
  if (tid >= q_rows) return;

  const float qs = metric == kIP ? 0.0f : __ldg(q_sq + q0 + tid);
  const float qr = __fsqrt_rn(qs);
  const float* col = dots + tid;
  float best = __int_as_float(0x7f800000);  // +inf
  int arg = 0;
  bool every = true;
  if (metric == kCos && qr != 0.0f && regular_root(qr) && !irregular) {
    // cos preselects as B1's `bin_min` does (csrc/wgmma_common.cuh): d' =
    // cpen - (dot / trt) / qrt, the quotients taken as products by the
    // reciprocals, is within 2^-19 (1 + |quotient| + |distance|) of the
    // exact distance where both roots are regular, so every row reaching
    // the exact minimum lies within twice that of the smallest d'. When the
    // second smallest d' lies beyond, the smallest one's row is the answer
    // and takes the one exact epilogue (one __fdiv_rn); otherwise every row
    // does.
    const float iqr = __frcp_rn(qr);
    float m1 = best, m2 = best, top = 0.0f;
    int pick = 0;
#pragma unroll 4
    for (int r = 0; r < kBin; ++r) {
      const float x = __fmul_rn(col[r * kDP], r_itr[r]);
      const float d = __fmaf_rn(-x, iqr, r_cpen[r]);
      top = fmaxf(top, fabsf(x));
      const bool lower = d < m1;
      m2 = lower ? m1 : fminf(m2, d);
      pick = lower ? r : pick;
      m1 = lower ? d : m1;
    }
    if (m2 > m1 + 0x1p-17f * (1.0f + __fmul_rn(top, iqr) + fabsf(m1))) {
      best = epilogue<true>(kCos, false, col[pick * kDP], qs, r_tsq[pick], r_pen[pick], qr, r_trt[pick]);
      arg = pick;
      every = false;
    }
  }
  if (every) {
#pragma unroll 4
    for (int r = 0; r < kBin; ++r) {
      const float d = epilogue<true>(metric, false, col[r * kDP], qs, r_tsq[r], r_pen[r], qr, r_trt[r]);
      if (d < best) {
        best = d;
        arg = r;
      }
    }
  }
  const size_t o = (size_t)(q0 + tid) * n_bins + bin;
  static_cast<float*>(out_v)[o] = best;
  if constexpr (kMode == kBinned) static_cast<int32_t*>(out_i)[o] = row0 + arg;
}

template <int kMode>
int launch_simt(const float* q, const float* table, const float* q_sq, const float* t_sq, const float* penalty,
                void* out_v, void* out_i, int n_q, int n_rows, int width, int metric, cudaStream_t s) {
  if (width % 4 || reinterpret_cast<uintptr_t>(q) % 16 || reinterpret_cast<uintptr_t>(table) % 16)
    return cudaErrorInvalidValue;
  const auto kernel = simt_scan<kMode>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSimtSmem);
  if (err != cudaSuccess) return err;
  const int n_bins = n_rows / kBin;
  const long long blocks = (long long)n_bins * ((n_q + kBQ - 1) / kBQ);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), kThreads, kSimtSmem, s>>>(q, table, q_sq, t_sq, penalty, out_v, out_i,
                                                                    n_q, n_bins, width, metric);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// wgmma kernel: i8, bf16 and compact f32

constexpr int kResidentKB = 4;  // K-blocks of a table tile kept for the block
constexpr int kMaxStages = 8;   // slots of a warpgroup's ring

// Shared memory of one block: the resident table tile (or none), two rings
// of `stages` K-blocks (query, then the table's when streamed), the rows'
// values, and the barriers: a full barrier per ring slot and one for the
// table. Every buffer starts on 1 KB; the rings take what is left.
struct Layout {
  int n_kb, stages, stage_bytes, ring_off, aux_off, bar_off, bytes;
  bool resident;
};

__host__ __device__ __forceinline__ Layout layout(int n_kb) {
  Layout L;
  L.n_kb = n_kb;
  L.resident = n_kb <= kResidentKB;
  L.stage_bytes = L.resident ? kQStage : kQStage + kTStage;
  L.ring_off = L.resident ? n_kb * kTStage : 0;
  const int room = kSmem - 1024 - 256 - static_cast<int>(sizeof(Aux)) - L.ring_off;
  L.stages = room / (2 * L.stage_bytes) < kMaxStages ? room / (2 * L.stage_bytes) : kMaxStages;
  L.aux_off = L.ring_off + 2 * L.stages * L.stage_bytes;
  L.bar_off = L.aux_off + static_cast<int>(sizeof(Aux));
  L.bytes = L.bar_off + 256 + 1024;  // barriers, and slack to align the base to 1 KB
  return L;
}

// Rows [row0, row0 + 256) of an f32 table of `width` floats, K-blocks
// [kb0, kb0 + n_kb), rounded to bf16 into `dst`: K-block k at k * 32 KB,
// row r's 16-byte chunk c at r * 128 + ((c ^ (r % 8)) * 16), the layout a
// 128-byte-swizzled TMA box gives. Rows past n_rows are zeros.
__device__ __forceinline__ void round_table(uint8_t* dst, const float* __restrict__ table, int row0, int n_rows,
                                            int width, int kb0, int n_kb, int t, int n_threads) {
  for (int e = t; e < kTileRows * n_kb * 8; e += n_threads) {
    const int c = e % 8;
    const int kb = (e / 8) % n_kb;
    const int r = e / (8 * n_kb);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < n_rows) {
      const float4* src = reinterpret_cast<const float4*>(table + (size_t)(row0 + r) * width + (kb0 + kb) * 64 + c * 8);
      const float4 a = __ldg(src);
      const float4 b = __ldg(src + 1);
      v = make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
    }
    *reinterpret_cast<uint4*>(dst + kb * kTStage + r * kKB + ((c ^ (r % 8)) << 4)) = v;
  }
}

// The epilogue of one warpgroup tile: queries q0 + [0, 64) against the
// block's 256 rows, per bin the first row reaching the minimum, one store
// per query for both bins. `exact_rows` (a row of irregular norm in the block),
// or an irregular or zero query, turns the cos preselection off.
template <int kMetric, int kMode, bool kSmall, typename A>
__device__ __forceinline__ void tile_epilogue(const A (&acc)[128], const Aux& aux, bool exact_rows, bool keyed,
                                              const float* __restrict__ q_sq, void* __restrict__ out_v,
                                              void* __restrict__ out_i, int q0, int n_q, int bin0, int n_bins,
                                              int row0, int t) {
  const int lane = t % 32;
  const int qa = q0 + 16 * (t / 32) + lane / 4;  // this thread's queries: qa, qa + 8
  const int c2 = 2 * (lane % 4);
  float qs[2], qr[2], iqr[2];
  bool exact_all[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = qa + 8 * h;
    qs[h] = (kMetric != kIP && qi < n_q) ? __ldg(q_sq + qi) : 0.0f;
    qr[h] = __fsqrt_rn(qs[h]);
    iqr[h] = qr[h] == 0.0f ? 0.0f : __frcp_rn(qr[h]);
    exact_all[h] = exact_rows || qr[h] == 0.0f || !regular_root(qr[h]);
  }
  float best[2][2];  // [bin][query]
  int arg[2][2];
  tile_minima<kMetric, kMode == kCompact, kSmall>(acc, aux, keyed, c2, qs, qr, iqr, exact_all, best, arg);
  // Thread c of the four stores query qa + 8 c (c < 2): both bins at once
  // where they share an aligned pair.
  const int c = lane % 4;
  if (c >= 2) return;
  const int qi = qa + 8 * c;
  if (qi >= n_q) return;
  const float v0 = c ? best[0][1] : best[0][0], v1 = c ? best[1][1] : best[1][0];
  const int a0 = c ? arg[0][1] : arg[0][0], a1 = c ? arg[1][1] : arg[1][0];
  const size_t o = (size_t)qi * n_bins + bin0;
  const bool pair = bin0 + 1 < n_bins && n_bins % 2 == 0;
  if constexpr (kMode == kBinned) {
    if (pair) {
      *reinterpret_cast<float2*>(static_cast<float*>(out_v) + o) = make_float2(v0, v1);
      *reinterpret_cast<int2*>(static_cast<int32_t*>(out_i) + o) = make_int2(row0 + a0, row0 + a1);
      return;
    }
    static_cast<float*>(out_v)[o] = v0;
    static_cast<int32_t*>(out_i)[o] = row0 + a0;
    if (bin0 + 1 < n_bins) {
      static_cast<float*>(out_v)[o + 1] = v1;
      static_cast<int32_t*>(out_i)[o + 1] = row0 + a1;
    }
  } else if constexpr (kMode == kCompact) {
    const int8_t r0 = static_cast<int8_t>(a0), r1 = static_cast<int8_t>(a1 - kBin);
    if (pair) {
      *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(out_v) + o) = pack_bf16(v0, v1);
      *reinterpret_cast<char2*>(static_cast<int8_t*>(out_i) + o) = make_char2(r0, r1);
      return;
    }
    static_cast<__nv_bfloat16*>(out_v)[o] = __float2bfloat16_rn(v0);
    static_cast<int8_t*>(out_i)[o] = r0;
    if (bin0 + 1 < n_bins) {
      static_cast<__nv_bfloat16*>(out_v)[o + 1] = __float2bfloat16_rn(v1);
      static_cast<int8_t*>(out_i)[o + 1] = r1;
    }
  } else {
    if (pair) {
      *reinterpret_cast<float2*>(static_cast<float*>(out_v) + o) = make_float2(v0, v1);
      return;
    }
    static_cast<float*>(out_v)[o] = v0;
    if (bin0 + 1 < n_bins) static_cast<float*>(out_v)[o + 1] = v1;
  }
}

// Fills ring slot `buf` with step `n` of warpgroup g's walk: K-block
// n % n_kb of its (n / n_kb)-th query tile, and the table's K-block when
// the table streams. Thread 0 of the warpgroup issues the copies; an f32
// table is rounded into the slot by the whole warpgroup first.
template <bool kRound>
__device__ __forceinline__ void fill(const Layout& L, uint8_t* buf, uint64_t* bar, const CUtensorMap* q_map,
                                     const CUtensorMap* t_map, const float* __restrict__ table_f32, int n, int g,
                                     int first_qt, int n_qt, int row0, int n_rows, int width, int t) {
  const int kb = n % L.n_kb;
  const int qt = (first_qt + g + 2 * (n / L.n_kb)) % n_qt;
  if (kRound && !L.resident) {
    round_table(buf + kQStage, table_f32, row0, n_rows, width, kb, 1, t, kWG);
    fence_proxy_async();
    asm volatile("bar.sync %0, 128;" ::"r"(1 + g) : "memory");
  }
  if (t == 0) {
    const bool table = !L.resident && !kRound;
    mbar_expect_tx(bar, kQStage + (table ? kTStage : 0));
    tma_load(buf, q_map, kb * kKB, qt * kQT, bar);
    if (table) tma_load(buf + kQStage, t_map, kb * kKB, row0, bar);
  }
}

// T: the table's storage type; an f32 table (compact only) is rounded to
// bf16 in shared memory, its queries arrive as bf16. `row_bytes` is the
// bytes of a row as the tensor cores read it (W, or 2 W for bf16 and f32).
// Warpgroup g takes query tiles g, g + 2, ... and keeps its own ring: once
// the product of step n is done it refills that slot with step n + stages.
// One instantiation per metric keeps each epilogue's registers its own.
template <typename T, int kMode, int kMetric, bool kSmall>
__global__ void __launch_bounds__(kBlock, 1)
wgmma_scan(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap t_map,
           const float* __restrict__ table_f32, const float* __restrict__ q_sq, const float* __restrict__ t_sq,
           const float* __restrict__ penalty, void* __restrict__ out_v, void* __restrict__ out_i, int n_q,
           int n_rows, int row_bytes) {
  using A = typename Acc<T>::type;
  constexpr bool kRound = std::is_same<T, float>::value;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const Layout L = layout(row_bytes / kKB);
  uint8_t* table_s = smem;
  Aux& aux = *reinterpret_cast<Aux*>(smem + L.aux_off);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar_off);
  uint64_t* table_bar = full + 2 * L.stages;

  const int tid = threadIdx.x;
  const int g = tid / kWG;
  const int t = tid % kWG;
  const int row0 = blockIdx.x * kTileRows;
  const int n_bins = n_rows / kBin;
  const int n_qt = (n_q + kQT - 1) / kQT;
  // Blocks start their walk over the query tiles at different tiles, so the
  // SMs do not all read the same L2 lines at once.
  const int first_qt = blockIdx.x % n_qt;
  const int width = row_bytes / 2;  // floats of an f32 row
  uint8_t* ring = smem + L.ring_off + g * L.stages * L.stage_bytes;
  uint64_t* ring_full = full + g * L.stages;
  const int steps = (n_qt - g + 1) / 2 * L.n_kb;  // this warpgroup's K-blocks

  if (tid == 0) {
    for (int i = 0; i < 2 * L.stages + 1; ++i) mbar_init(full + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  bool irregular = false, unkeyed = false;
  for (int r = tid; r < kTileRows; r += kBlock) {
    const bool in = row0 + r < n_rows;
    const float ts = (in && kMetric != kIP) ? t_sq[row0 + r] : 0.0f;
    const float tr = __fsqrt_rn(ts);
    const float pen = in ? penalty[row0 + r] : 0.0f;
    aux.pen[r] = pen;
    aux.tsq[r] = ts;
    aux.trt[r] = tr;
    aux.itr[r] = tr == 0.0f ? 0.0f : __frcp_rn(tr);
    aux.cpen[r] = __fadd_rn(kMode == kCompact ? 0.0f : 1.0f, pen);
    aux.key[r] = make_int2(pen == 0.0f ? 128 : 0, (pen == 0.0f ? 0 : -(1 << 30)) + kBin - 1 - r % kBin);
    irregular |= kMetric == kCos && !regular_root(tr);
    unkeyed |= pen != 0.0f && pen != kMasked;
  }
  if constexpr (kRound) {
    if (L.resident) {
      round_table(table_s, table_f32, row0, n_rows, width, 0, L.n_kb, tid, kBlock);
      fence_proxy_async();
    }
  }
  const bool exact_rows = __syncthreads_or(irregular);
  const bool keyed = kMetric == kIP && kSmall && !__syncthreads_or(unkeyed);
  if (tid == 0 && !kRound && L.resident) {
    mbar_expect_tx(table_bar, L.n_kb * kTStage);
    for (int kb = 0; kb < L.n_kb; ++kb) tma_load(table_s + kb * kTStage, &t_map, kb * kKB, row0, table_bar);
  }
  for (int n = 0; n < L.stages && n < steps; ++n)
    fill<kRound>(L, ring + n * L.stage_bytes, ring_full + n, &q_map, &t_map, table_f32, n, g, first_qt, n_qt, row0,
                 n_rows, width, t);
  if (!kRound && L.resident) mbar_wait(table_bar, 0);

  const int tiles = steps / L.n_kb;
  A acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = A(0);
  for (int i = 0; i < tiles; ++i) {
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    for (int kb = 0; kb < L.n_kb; ++kb) {
      const int n = i * L.n_kb + kb;
      const int slot = n % L.stages;
      mbar_wait(ring_full + slot, (n / L.stages) & 1);
      const uint32_t qa = smem_addr(ring + slot * L.stage_bytes);
      const uint32_t ta = L.resident ? smem_addr(table_s + kb * kTStage) : qa + kQStage;
      const uint64_t da = sw128_desc(qa), db = sw128_desc(ta);
#pragma unroll
      for (int k = 0; k < kKB / 32; ++k) mma_k(acc, da + 2 * k, db + 2 * k, kb | k);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      if (kb > 0) {
        // the previous K-block's product is done: refill its slot
        asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
        const int done = n - 1;
        if (done + L.stages < steps)
          fill<kRound>(L, ring + done % L.stages * L.stage_bytes, ring_full + done % L.stages, &q_map, &t_map,
                       table_f32, done + L.stages, g, first_qt, n_qt, row0, n_rows, width, t);
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc(acc);
    const int last = (i + 1) * L.n_kb - 1;
    if (last + L.stages < steps)
      fill<kRound>(L, ring + last % L.stages * L.stage_bytes, ring_full + last % L.stages, &q_map, &t_map,
                   table_f32, last + L.stages, g, first_qt, n_qt, row0, n_rows, width, t);
    const int q0 = (first_qt + g + 2 * i) % n_qt * kQT;
    const int bin0 = 2 * blockIdx.x;
    tile_epilogue<kMetric, kMode, kSmall>(acc, aux, exact_rows, keyed, q_sq, out_v, out_i, q0, n_q, bin0, n_bins, row0,
                                          t);
  }
}

template <typename T, int kMode, int kMetric, bool kSmall>
int run_wgmma(const CUtensorMap& q_map, const CUtensorMap& t_map, const void* table, const float* q_sq,
              const float* t_sq, const float* penalty, void* out_v, void* out_i, int n_q, int n_rows, int row_bytes,
              cudaStream_t s) {
  const Layout L = layout(row_bytes / kKB);
  const auto kernel = wgmma_scan<T, kMode, kMetric, kSmall>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (err != cudaSuccess) return err;
  const int n_tiles = (n_rows / kBin + 1) / 2;
  kernel<<<n_tiles, kBlock, L.bytes, s>>>(q_map, t_map, static_cast<const float*>(table), q_sq, t_sq, penalty, out_v,
                                          out_i, n_q, n_rows, row_bytes);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kMode, int kMetric>
int run_metric(const CUtensorMap& q_map, const CUtensorMap& t_map, const void* table, const float* q_sq,
               const float* t_sq, const float* penalty, void* out_v, void* out_i, int n_q, int n_rows, int row_bytes,
               cudaStream_t s) {
  if constexpr (std::is_same<T, int8_t>::value) {
    if (row_bytes <= 256)
      return run_wgmma<T, kMode, kMetric, true>(q_map, t_map, table, q_sq, t_sq, penalty, out_v, out_i, n_q, n_rows,
                                                row_bytes, s);
  }
  return run_wgmma<T, kMode, kMetric, false>(q_map, t_map, table, q_sq, t_sq, penalty, out_v, out_i, n_q, n_rows,
                                             row_bytes, s);
}

template <typename T, int kMode>
int launch_wgmma(const void* q, const void* table, const float* q_sq, const float* t_sq, const float* penalty,
                 void* out_v, void* out_i, int n_q, int n_rows, int row_bytes, int metric, cudaStream_t s) {
  constexpr bool kRound = std::is_same<T, float>::value;
  if (row_bytes % kKB) return cudaErrorInvalidValue;
  CUtensorMap q_map, t_map;
  if (!tile_map(&q_map, q, row_bytes, n_q, kQT)) return cudaErrorInvalidValue;
  if (kRound) {
    if (reinterpret_cast<uintptr_t>(table) % 16) return cudaErrorInvalidValue;
    t_map = q_map;  // unused: the table is read by threads
  } else if (!tile_map(&t_map, table, row_bytes, n_rows, kTileRows)) {
    return cudaErrorInvalidValue;
  }
  switch (metric) {
    case kIP:
      return run_metric<T, kMode, kIP>(q_map, t_map, table, q_sq, t_sq, penalty, out_v, out_i, n_q, n_rows, row_bytes,
                                       s);
    case kCos:
      return run_metric<T, kMode, kCos>(q_map, t_map, table, q_sq, t_sq, penalty, out_v, out_i, n_q, n_rows,
                                        row_bytes, s);
    default:
      return run_metric<T, kMode, kL2sq>(q_map, t_map, table, q_sq, t_sq, penalty, out_v, out_i, n_q, n_rows,
                                         row_bytes, s);
  }
}

template <int kMode>
int launch(const void* q, const void* table, const float* q_sq, const float* t_sq, const float* penalty,
           void* out_v, void* out_i, int n_q, int n_rows, int width, int dtype, int metric, void* stream) {
  if (n_q <= 0 || n_rows <= 0 || n_rows % kBin || width <= 0 || metric < kIP || metric > kL2sq)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kI8:
      return launch_wgmma<int8_t, kMode>(q, table, q_sq, t_sq, penalty, out_v, out_i, n_q, n_rows, width, metric, s);
    case kBF16:
      return launch_wgmma<__nv_bfloat16, kMode>(q, table, q_sq, t_sq, penalty, out_v, out_i, n_q, n_rows, 2 * width,
                                                metric, s);
    case kF32:
      if constexpr (kMode == kCompact) {
        return launch_wgmma<float, kMode>(q, table, q_sq, t_sq, penalty, out_v, out_i, n_q, n_rows, 2 * width,
                                          metric, s);
      } else {
        return launch_simt<kMode>(static_cast<const float*>(q), static_cast<const float*>(table), q_sq, t_sq,
                                  penalty, out_v, out_i, n_q, n_rows, width, metric, s);
      }
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// B1. compact != 0 selects bf16 shifted minima + i8 within-bin rows; with
// an f32 table, `q` then holds the queries rounded to bf16.
int usearch_binned_scan(const void* q, const void* table, const float* q_sq, const float* t_sq,
                        const float* penalty, void* out_v, void* out_i, int n_q, int n_rows, int width, int dtype,
                        int metric, int compact, void* stream) {
  return compact ? launch<kCompact>(q, table, q_sq, t_sq, penalty, out_v, out_i, n_q, n_rows, width, dtype, metric,
                                    stream)
                 : launch<kBinned>(q, table, q_sq, t_sq, penalty, out_v, out_i, n_q, n_rows, width, dtype, metric,
                                   stream);
}

// B2. Writes f32 bin minima only.
int usearch_binned_minima(const void* q, const void* table, const float* q_sq, const float* t_sq,
                          const float* penalty, void* out_v, int n_q, int n_rows, int width, int dtype, int metric,
                          void* stream) {
  return launch<kMinima>(q, table, q_sq, t_sq, penalty, out_v, nullptr, n_q, n_rows, width, dtype, metric, stream);
}

}  // extern "C"
