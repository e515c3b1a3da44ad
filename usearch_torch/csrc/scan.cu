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
// What holds it back on the card (PERF.md, Findings): the product and the
// query stream together reach 50-59% of the tensor-core rate, and the
// epilogue adds to them instead of overlapping them.
//
// f32 storage outside compact mode (B1 f32, B2 f32: the exact f32 path)
// keeps a SIMT f32-FMA product (`simt_scan`), since no exact path may use
// TF32: a block owns one bin and 128 queries, each of its 256 threads 8
// rows x 8 queries, the width streamed through shared memory.
//
// Every entry point launches on the stream it is given, allocates nothing,
// and returns cudaGetLastError() after its launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "scan_common.cuh"

namespace {

constexpr int kBin = 128;  // rows of one bin

// ---------------------------------------------------------------------------
// SIMT f32 kernel

constexpr int kBQ = 128;       // queries of one block
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kTM = 8;         // rows per thread
constexpr int kTN = 8;         // queries per thread
constexpr int kWords = 8;      // floats of the width per stage
constexpr int kPad = 4;        // shared-memory row padding, in floats

__device__ __forceinline__ void lds8(float (&r)[8], const float* p) {
  const float4 x = reinterpret_cast<const float4*>(p)[0];
  const float4 y = reinterpret_cast<const float4*>(p)[1];
  r[0] = x.x; r[1] = x.y; r[2] = x.z; r[3] = x.w;
  r[4] = y.x; r[5] = y.y; r[6] = y.z; r[7] = y.w;
}

// Copies floats [w0, w0 + kWords) of `n_rows` rows into S[k][row] (k-major,
// so a thread's 8 rows are one 32-byte read); rows past n_rows read as 0.
__device__ __forceinline__ void load_stage(float (*S)[kBin + kPad], const float* __restrict__ base, int width,
                                           int n_rows, int w0, int tid) {
#pragma unroll
  for (int e = tid; e < kBin * kWords; e += kThreads) {
    const int r = e / kWords;
    const int w = e % kWords;
    S[w][r] = r < n_rows ? __ldg(base + (size_t)r * width + w0 + w) : 0.0f;
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
simt_scan(const float* __restrict__ q, const float* __restrict__ table, const float* __restrict__ q_sq,
          const float* __restrict__ t_sq, const float* __restrict__ penalty, void* __restrict__ out_v,
          void* __restrict__ out_i, int n_q, int n_bins, int width, int metric) {
  __shared__ __align__(16) float t_s[kWords][kBin + kPad];
  __shared__ __align__(16) float q_s[kWords][kBQ + kPad];
  __shared__ float red_v[kBin / kTM][kBQ];
  __shared__ int red_i[kBin / kTM][kBQ];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // query group
  const int ty = tid / 16;  // row group
  const int bin = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const int row0 = bin * kBin;
  const int q_rows = min(kBQ, n_q - q0);
  const float* t_base = table + (size_t)row0 * width;
  const float* q_base = q + (size_t)q0 * width;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  for (int w0 = 0; w0 < width; w0 += kWords) {
    load_stage(t_s, t_base, width, kBin, w0, tid);
    load_stage(q_s, q_base, width, q_rows, w0, tid);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      float a[kTM], b[kTN];
      lds8(a, &t_s[k][ty * kTM]);
      lds8(b, &q_s[k][tx * kTN]);
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue and this thread's part of the bin reduction: rows ascending,
  // strict '<', so the first row reaching the minimum wins (jnp.argmin).
  float t_sq_r[kTM], pen_r[kTM];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = row0 + ty * kTM + i;
    pen_r[i] = penalty[r];
    t_sq_r[i] = metric == kIP ? 0.0f : t_sq[r];
  }
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    const int c = tx * kTN + j;
    const float qs = (metric != kIP && c < q_rows) ? q_sq[q0 + c] : 0.0f;
    float best = __int_as_float(0x7f800000);  // +inf
    int arg = 0;
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const float d = epilogue(metric, false, acc[i][j], qs, t_sq_r[i], pen_r[i]);
      if (d < best) {
        best = d;
        arg = ty * kTM + i;
      }
    }
    red_v[ty][c] = best;
    red_i[ty][c] = arg;
  }
  __syncthreads();

  // Across the 16 row groups, again in ascending row order.
  if (tid < q_rows) {
    float best = red_v[0][tid];
    int arg = red_i[0][tid];
#pragma unroll
    for (int s = 1; s < kBin / kTM; ++s) {
      const float v = red_v[s][tid];
      if (v < best) {
        best = v;
        arg = red_i[s][tid];
      }
    }
    const size_t o = (size_t)(q0 + tid) * n_bins + bin;
    if constexpr (kMode == kBinned) {
      static_cast<float*>(out_v)[o] = best;
      static_cast<int32_t*>(out_i)[o] = row0 + arg;
    } else {
      static_cast<float*>(out_v)[o] = best;
    }
  }
}

// ---------------------------------------------------------------------------
// wgmma kernel: i8, bf16 and compact f32

constexpr int kTileRows = 256;            // table rows of one block: two bins
constexpr int kQT = 64;                   // queries of one warpgroup tile
constexpr int kKB = 128;                  // bytes of a row per K-block: one swizzle row
constexpr int kWG = 128;                  // threads of a warpgroup
constexpr int kBlock = 2 * kWG;           // two warpgroups, each its own producer
constexpr int kQStage = kQT * kKB;        // 8 KB: a query K-block
constexpr int kTStage = kTileRows * kKB;  // 32 KB: a table K-block
constexpr int kResidentKB = 4;            // K-blocks of a table tile kept for the block
constexpr int kMaxStages = 8;             // slots of a warpgroup's ring
constexpr int kSmem = 232448;             // shared memory a block may use

// Per-row values of the block's 256 rows, in shared memory.
struct Aux {
  float pen[kTileRows];   // deleted-row penalty
  float tsq[kTileRows];   // t_sq
  float trt[kTileRows];   // __fsqrt_rn(t_sq)
  float itr[kTileRows];   // cos: 1 / trt, 0 for a zero row
  float cpen[kTileRows];  // cos: the epilogue's constant term plus the penalty
  int2 key[kTileRows];    // i8 ip: (multiplier, addend) of the row's max-key
};

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

// One 128-byte x rows box of `map` at (byte x, row y) into `dst`; completes
// its bytes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];" ::
          "r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_addr(bar))
      : "memory");
}

// Generic-proxy writes to shared memory made visible to wgmma and TMA.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Shared-memory matrix descriptor of a K-major tile whose rows are 128
// bytes, 128-byte swizzled, 8-row groups 1 KB apart. Adding 2 moves it 32
// bytes along K (the next k-step).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

#define D8(C, i) \
  C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3]), C(d[i + 4]), C(d[i + 5]), C(d[i + 6]), C(d[i + 7])
#define D64(C, i) \
  D8(C, i), D8(C, i + 8), D8(C, i + 16), D8(C, i + 24), D8(C, i + 32), D8(C, i + 40), D8(C, i + 48), D8(C, i + 56)
#define D_REGS                                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"                     \
  " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"           \
  " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"           \
  " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"           \
  " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"           \
  " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"           \
  " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111," \
  " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"

// d[64 x 256] (+)= a[64 x 32 s8] . b[256 x 32 s8]^T; accumulate unless first.
__device__ __forceinline__ void mma_k(int (&d)[128], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " D_REGS ", %128, %129, p;\n}\n"
      : D64("+r", 0), D64("+r", 64)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x 256] (+)= a[64 x 16 bf16] . b[256 x 16 bf16]^T, in f32.
__device__ __forceinline__ void mma_k(float (&d)[128], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " D_REGS ", %128, %129, p, 1, 1, 0, 0;\n}\n"
      : D64("+f", 0), D64("+f", 64)
      : "l"(a), "l"(b), "r"(accumulate));
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous product's fence and wait.
__device__ __forceinline__ void fence_acc(int (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
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

// Norms inside [2^-30, 2^30] keep the cos preselection's products normal.
__device__ __forceinline__ bool regular_root(float r) { return r == 0.0f || (r >= 0x1p-30f && r <= 0x1p30f); }

// A dot as f32. kSmall: an i8 dot of at most 256 products, |x| <= 2^22,
// converted exactly by adding it to the bits of 1.5 * 2^23 (two full-rate
// operations where __int2float_rn is a quarter-rate one).
template <bool kSmall>
__device__ __forceinline__ float dot_value(int x) {
  return kSmall ? __fsub_rn(__int_as_float(x + 0x4B400000), 12582912.0f) : __int2float_rn(x);
}
template <bool kSmall>
__device__ __forceinline__ float dot_value(float x) {
  return x;
}

// (value, row) pairs in lexicographic order: the first row reaching the
// minimum wins, whatever order the pairs meet in.
__device__ __forceinline__ void keep_min(float d, int col, float& best, int& arg) {
  if (d < best || (d == best && col < arg)) {
    best = d;
    arg = col;
  }
}

// The (value, row) minima of the thread's two queries over its 32 rows of
// bin b: rows 8 j + c2 + e of the block, j in [16 b, 16 b + 16), e in
// {0, 1}; four chains (query, j parity) keep the pipes busy.
//
// cos first preselects: d' = cpen - (dot / trt) / qrt with the quotients
// taken as products by the reciprocals, within 2^-19 (1 + |quotient| +
// |distance|) of the exact distance where both roots are regular. Every
// row reaching the exact minimum lies within twice that of the smallest
// d'. When one row does, it is the answer and takes the exact epilogue
// (one __fdiv_rn) alone; otherwise, or for an irregular or zero query,
// every row does (rare, and the only branch that the threads of a warp may
// take apart).
template <int kMetric, bool kShifted, bool kSmall, typename A>
__device__ __forceinline__ void bin_min(const A (&acc)[128], const Aux& aux, int b, int c2, const float (&qs)[2],
                                        const float (&qr)[2], const float (&iqr)[2], const bool (&exact_all)[2],
                                        float (&best)[2], int (&arg)[2]) {
  const float inf = __int_as_float(0x7f800000);
  bool every[2] = {true, true};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    best[h] = inf;
    arg[h] = kBin * b + c2;
  }
  if constexpr (kMetric == kCos) {
    float m1[2] = {inf, inf}, top[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 16 * b; j < 16 * b + 16; ++j) {
      const int col = 8 * j + c2;
      const float2 it = *reinterpret_cast<const float2*>(aux.itr + col);
      const float2 cp = *reinterpret_cast<const float2*>(aux.cpen + col);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float x0 = __fmul_rn(dot_value<kSmall>(acc[4 * j + 2 * h]), it.x);
        const float x1 = __fmul_rn(dot_value<kSmall>(acc[4 * j + 2 * h + 1]), it.y);
        m1[h] = fminf(m1[h], fminf(__fmaf_rn(-x0, iqr[h], cp.x), __fmaf_rn(-x1, iqr[h], cp.y)));
        top[h] = fmaxf(top[h], fmaxf(fabsf(x0), fabsf(x1)));
      }
    }
    float thr[2], pick_dot[2] = {0.0f, 0.0f};
    int count[2] = {0, 0}, pick[2] = {0, 0};
#pragma unroll
    for (int h = 0; h < 2; ++h) thr[h] = m1[h] + 0x1p-17f * (1.0f + __fmul_rn(top[h], iqr[h]) + fabsf(m1[h]));
#pragma unroll
    for (int j = 16 * b + 15; j >= 16 * b; --j) {  // descending: the first near row is kept last
      const int col = 8 * j + c2;
      const float2 it = *reinterpret_cast<const float2*>(aux.itr + col);
      const float2 cp = *reinterpret_cast<const float2*>(aux.cpen + col);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 1; e >= 0; --e) {
          const float dot = dot_value<kSmall>(acc[4 * j + 2 * h + e]);
          const float x = __fmul_rn(dot, e ? it.y : it.x);
          if (__fmaf_rn(-x, iqr[h], e ? cp.y : cp.x) <= thr[h]) {
            pick_dot[h] = dot;
            pick[h] = col + e;
            ++count[h];
          }
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (exact_all[h] || count[h] != 1) continue;
      const int r = pick[h];
      best[h] = epilogue<true>(kCos, kShifted, pick_dot[h], qs[h], aux.tsq[r], aux.pen[r], qr[h], aux.trt[r]);
      arg[h] = r;
      every[h] = false;
    }
    if (!every[0] && !every[1]) return;
  }
  float cb[2][2];
  int ca[2][2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    cb[h][0] = cb[h][1] = inf;
    ca[h][0] = ca[h][1] = kBin * b + c2;
  }
#pragma unroll
  for (int j = 16 * b; j < 16 * b + 16; ++j) {
    const int col = 8 * j + c2;
    const float2 pen = *reinterpret_cast<const float2*>(aux.pen + col);
    float2 ts = make_float2(0.0f, 0.0f), tr = make_float2(0.0f, 0.0f);
    if (kMetric != kIP) ts = *reinterpret_cast<const float2*>(aux.tsq + col);
    if (kMetric == kCos) tr = *reinterpret_cast<const float2*>(aux.trt + col);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!every[h]) continue;
      const float d0 = epilogue<true>(kMetric, kShifted, dot_value<kSmall>(acc[4 * j + 2 * h]), qs[h], ts.x, pen.x,
                                      qr[h], tr.x);
      const float d1 = epilogue<true>(kMetric, kShifted, dot_value<kSmall>(acc[4 * j + 2 * h + 1]), qs[h], ts.y,
                                      pen.y, qr[h], tr.y);
      float& v = cb[h][j % 2];
      int& a = ca[h][j % 2];
      if (d0 < v) {  // a chain meets its rows in ascending order: '<' keeps the first
        v = d0;
        a = col;
      }
      if (d1 < v) {
        v = d1;
        a = col + 1;
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!every[h]) continue;
    best[h] = cb[h][0];
    arg[h] = ca[h][0];
    keep_min(cb[h][1], ca[h][1], best[h], arg[h]);
  }
}

// bin_min for i8 ip dots within 2^22 where every penalty is 0 or MASKED
// (the scans' own case), in two integer operations a row: the row's key is
// dot * 128 + 127 - c for a live row (c: its row within the bin) and
// -2^30 + 127 - c for a deleted one, and the largest key is the first row
// reaching the smallest distance. For a live row that distance is the
// epilogue of dot = key >> 7 (exact: 1 - dot and -dot are integers below
// 2^23); a deleted row's is MASKED, which absorbs every such term, so the
// epilogue of its key's high bits gives it too.
template <bool kShifted>
__device__ __forceinline__ void keyed_bin_min(const int (&acc)[128], const Aux& aux, int b, int c2, float (&best)[2],
                                              int (&arg)[2]) {
  int top[2][2] = {{INT_MIN, INT_MIN}, {INT_MIN, INT_MIN}};
#pragma unroll
  for (int j = 16 * b; j < 16 * b + 16; ++j) {
    const int4 k = *reinterpret_cast<const int4*>(aux.key + 8 * j + c2);  // (m, c) of two rows
#pragma unroll
    for (int h = 0; h < 2; ++h)
      top[h][j % 2] = max(top[h][j % 2], max(acc[4 * j + 2 * h] * k.x + k.y, acc[4 * j + 2 * h + 1] * k.z + k.w));
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = max(top[h][0], top[h][1]);
    const int c = kBin - 1 - (key & (kBin - 1));
    best[h] = epilogue<true>(kIP, kShifted, static_cast<float>(key >> 7), 0.0f, 0.0f, aux.pen[kBin * b + c]);
    arg[h] = kBin * b + c;
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
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    if constexpr (kMetric == kIP && kSmall && std::is_same<A, int>::value) {
      if (keyed) {
        keyed_bin_min<kMode == kCompact>(acc, aux, b, c2, best[b], arg[b]);
      } else {
        bin_min<kMetric, kMode == kCompact, kSmall>(acc, aux, b, c2, qs, qr, iqr, exact_all, best[b], arg[b]);
      }
    } else {
      bin_min<kMetric, kMode == kCompact, kSmall>(acc, aux, b, c2, qs, qr, iqr, exact_all, best[b], arg[b]);
    }
    // the four threads of a query hold interleaved rows
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int m = 1; m <= 2; m *= 2)
        keep_min(__shfl_xor_sync(0xffffffffu, best[b][h], m), __shfl_xor_sync(0xffffffffu, arg[b][h], m), best[b][h],
                 arg[b][h]);
    }
  }
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

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime,
// so the library does not link libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A map of `rows` rows of `row_bytes` bytes read in 128-byte x box_rows
// boxes, 128-byte swizzled; rows past the end read as zeros.
bool tile_map(CUtensorMap* map, const void* base, int row_bytes, int rows, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr || reinterpret_cast<uintptr_t>(base) % 16) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(row_bytes), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kKB), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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
        if (width % kWords) return cudaErrorInvalidValue;
        const int n_bins = n_rows / kBin;
        const dim3 grid(n_bins, (n_q + kBQ - 1) / kBQ);
        simt_scan<kMode><<<grid, kThreads, 0, s>>>(static_cast<const float*>(q), static_cast<const float*>(table),
                                                   q_sq, t_sq, penalty, out_v, out_i, n_q, n_bins, width, metric);
        return static_cast<int>(cudaGetLastError());
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
