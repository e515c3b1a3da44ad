// Tensor-core building blocks of usearch_torch's flat-scan kernels, shared by
// csrc/scan.cu (B1, B2: `wgmma_scan`) and csrc/fused.cu (B8, B9: the fused
// running top-k), one copy for both:
// - the tile shapes: 128-byte K-blocks of 64 query rows or 256 table rows,
//   each one 2-D TMA box with the 128-byte swizzle that `wgmma` reads;
// - the rows' per-tile values (`Aux`, `set_row`) and the queries' values
//   (`query_values`);
// - mbarrier, TMA and matrix-descriptor helpers, the s8 and bf16 `wgmma`
//   m64n256 products (`mma_k`; m64n128 for the probe kernels of
//   csrc/probe.cu and csrc/bisect.cu, which include this header too, and
//   their b1 and-popc product `mma_popc`; m64n128 and m64n64 for the
//   loop-carried product of csrc/matmul_probe.cu) and the accumulator fence;
// - the register epilogue: per query and 128-row bin the first row reaching
//   the minimum (`tile_minima`, over `bin_min`/`keyed_bin_min`), with the
//   distances of csrc/scan_common.cuh's `epilogue`, so every kernel that
//   uses it gives B1's distances by construction;
// - the host's tensor maps (`tile_map`), cuTensorMapEncodeTiled taken
//   through the CUDA runtime so no library links libcuda.
//
// Each source that includes it is compiled on its own; everything here has
// internal linkage.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "scan_common.cuh"

namespace {

constexpr int kTileRows = 256;            // table rows of one tile: two bins
constexpr int kQT = 64;                   // queries of one warpgroup tile
constexpr int kKB = 128;                  // bytes of a row per K-block: one swizzle row
constexpr int kWG = 128;                  // threads of a warpgroup
constexpr int kBlock = 2 * kWG;           // two warpgroups
constexpr int kQStage = kQT * kKB;        // 8 KB: a query K-block
constexpr int kTStage = kTileRows * kKB;  // 32 KB: a table K-block
constexpr int kSmem = 232448;             // shared memory a block may use

// Per-row values of a tile's 256 rows, in shared memory.
struct Aux {
  float pen[kTileRows];   // deleted-row penalty
  float tsq[kTileRows];   // t_sq
  float trt[kTileRows];   // __fsqrt_rn(t_sq)
  float itr[kTileRows];   // cos: 1 / trt, 0 for a zero row
  float cpen[kTileRows];  // cos: the epilogue's constant term plus the penalty
  int2 key[kTileRows];    // i8 ip: (multiplier, addend) of the row's max-key
};

// Row r of `aux` from its squared norm ts, its root tr = __fsqrt_rn(ts) and
// its penalty; kShifted: the compact mode's distance (no constant term).
// B1's `wgmma_scan` has these lines inline (a call changes its SASS);
// tests/test_torch_fused_breakdown.py holds the two in step.
template <bool kShifted>
__device__ __forceinline__ void set_row(Aux& aux, int r, float ts, float tr, float pen) {
  aux.pen[r] = pen;
  aux.tsq[r] = ts;
  aux.trt[r] = tr;
  aux.itr[r] = tr == 0.0f ? 0.0f : __frcp_rn(tr);
  aux.cpen[r] = __fadd_rn(kShifted ? 0.0f : 1.0f, pen);
  aux.key[r] = make_int2(pen == 0.0f ? 128 : 0, (pen == 0.0f ? 0 : -(1 << 30)) + kBin - 1 - r % kBin);
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

#define D_REGS64                                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"           \
  " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31," \
  " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
  " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d[64 x 128] (+)= a[64 x 32 s8] . b[128 x 32 s8]^T: one 128-row bin (the
// probe kernels, csrc/probe.cu).
__device__ __forceinline__ void mma_k(int (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " D_REGS64 ", %64, %65, p;\n}\n"
      : D64("+r", 0)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x 128] (+)= a[64 x 16 bf16] . b[128 x 16 bf16]^T, in f32.
__device__ __forceinline__ void mma_k(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " D_REGS64 ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : D64("+f", 0)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x 128] (+)= popc(a[64 x 256 b1] & b[128 x 256 b1]^T), exact in int32:
// the and-count of 32 bytes of packed bits per row pair, for the probe
// kernels over b1 rows. The same bytes per step, descriptors and
// accumulator layout as the s8 m64n128k32 product, and the same rate per
// instruction (BGMMA in the SASS).
__device__ __forceinline__ void mma_popc(int (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k256.s32.b1.b1.and.popc " D_REGS64 ", %64, %65, p;\n}\n"
      : D64("+r", 0)
      : "l"(a), "l"(b), "r"(accumulate));
}

#define D32(C, i) D8(C, i), D8(C, i + 8), D8(C, i + 16), D8(C, i + 24)
#define D_REGS32                                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"           \
  " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d[64 x 64] (+)= a[64 x 32 s8] . b[64 x 32 s8]^T: the loop-carried product
// of csrc/matmul_probe.cu where its columns come in 64s.
__device__ __forceinline__ void mma_k(int (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " D_REGS32 ", %32, %33, p;\n}\n"
      : D32("+r", 0)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x 64] (+)= a[64 x 16 bf16] . b[64 x 16 bf16]^T, in f32.
__device__ __forceinline__ void mma_k(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " D_REGS32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : D32("+f", 0)
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
__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_acc(int (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
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

// The values of this thread's two queries, qa and qa + 8: the squared norm
// (cos, l2sq), its root and the root's reciprocal; `odd` where the root is
// zero or irregular, which turns cos's preselection off for that query.
// B1's `tile_epilogue` has these lines inline, as set_row's.
template <int kMetric>
__device__ __forceinline__ void query_values(const float* __restrict__ q_sq, int qa, int n_q, float (&qs)[2],
                                             float (&qr)[2], float (&iqr)[2], bool (&odd)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = qa + 8 * h;
    qs[h] = (kMetric != kIP && qi < n_q) ? __ldg(q_sq + qi) : 0.0f;
    qr[h] = __fsqrt_rn(qs[h]);
    iqr[h] = qr[h] == 0.0f ? 0.0f : __frcp_rn(qr[h]);
    odd[h] = qr[h] == 0.0f || !regular_root(qr[h]);
  }
}

// The minima of one warpgroup tile (its 64 queries against the 256 rows of
// `aux`, two bins): best[b][h] and arg[b][h] (the row within the 256) of
// bin b for query qa + 8 h, the same in each of the query's four threads
// after two shuffles. `keyed`: i8 ip dots within 2^22 whose penalties are
// all 0 or MASKED take the integer keys. `exact_all[h]` turns cos's
// preselection off for query h.
template <int kMetric, bool kShifted, bool kSmall, typename A>
__device__ __forceinline__ void tile_minima(const A (&acc)[128], const Aux& aux, bool keyed, int c2,
                                            const float (&qs)[2], const float (&qr)[2], const float (&iqr)[2],
                                            const bool (&exact_all)[2], float (&best)[2][2], int (&arg)[2][2]) {
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    if constexpr (kMetric == kIP && kSmall && std::is_same<A, int>::value) {
      if (keyed) {
        keyed_bin_min<kShifted>(acc, aux, b, c2, best[b], arg[b]);
      } else {
        bin_min<kMetric, kShifted, kSmall>(acc, aux, b, c2, qs, qr, iqr, exact_all, best[b], arg[b]);
      }
    } else {
      bin_min<kMetric, kShifted, kSmall>(acc, aux, b, c2, qs, qr, iqr, exact_all, best[b], arg[b]);
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

}  // namespace
