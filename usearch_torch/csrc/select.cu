// Selection loop of usearch_torch, for Hopper (sm_90a).
//
// B12 `usearch_select_loop` replaces the TPU micro-benchmark kernel
// `make(variant)` (scripts/tpu_select_microbench.py:19), which times one
// selection operation of the probe kernels on its own: IT passes over an
// i32 buffer x [W, G] held in fast memory, pass i reducing x + i column by
// column into row 0 of an f32 [8, G] output. The variants:
//   astype_only    f32 sum of rows 0-7
//   i32_min128/32  i32 sum of the minima of 128- or 32-row groups
//   f32_min32      f32 sum of the 32-row minima
//   pack_only      i32 sum of the packed keys ((-x) << 5) | (row & 31) of
//                  rows 0, 32, 64, ...
//   pack_min32     i32 sum of the 32-row minima of the packed keys
//   f32_minarg128/32  f32 sum of the group minima plus the i32 sum of
//                  their first arg-minima, as f32
// i32 arithmetic wraps (as uint32_t, so no shift or sum of a negative value
// is undefined); f32 sums add the groups in order, rounding each addition
// to nearest, and ints turn into f32 by rounding to nearest.
//
// Bound on this card. The bytes are x read once and [8, G] written once
// (0.2 us at the script's shape). chip_smoke.py's operation bound counts
// 2-5 32-bit operations an element and pass (SELECT_OPS) at the f32 rate
// of 67 TFLOP/s, which is 128 FMA lanes an SM and clock counted as two
// operations each. The operations a select issues run slower on compute
// capability 9.0 (CUDA C++ Programming Guide, arithmetic instructions
// table, results per clock and SM): 64 for 32-bit integer add, shift and
// bitwise operations and for compare, minimum and maximum, a quarter of
// that bound's 256; 16 for an int-to-f32 conversion, a sixteenth; 32 for a
// warp shuffle. And every pass reads the whole copy from shared memory, at
// most 128 bytes a clock and SM: 4 bytes an element, the same time as two
// of those 64-a-clock operations. At the script's shape (1,408 x 128) a
// pass is thus at least 22-24 ns of shared-memory reads over 132 SMs at
// 1.76-1.98 GHz, where the operation bound gives 5.4-13.4 ns; the f32
// variants' conversions alone take 43-49 ns.
//
// Design. The TPU script times its one TensorCore, so the counterpart here
// is the whole card: the reducing variants' passes are spread over every
// SM, each pass in registers in the layout of a `wgmma` accumulator, as the
// probe kernels' epilogues (csrc/wgmma_common.cuh `tile_minima`) hold
// their dots.
// - Grid: G/32 column groups x P pass groups, P = max(1, SMs / (G/32)),
//   one block an SM (its copy takes up to 221 KB). Block (c, p) stages its
//   32 columns once (cp.async, 16 bytes a copy, rows padded to 36 words so
//   that neither the copies nor the fragment reads meet on a bank) and runs
//   passes i with i % P == p; its two slots (two warps each) run two passes
//   at once, slot (i / P) % 2. Every pass round of the grid thus takes 2 P
//   passes, so a launch of IT passes takes the staging plus ceil(IT / 2P)
//   rounds: linear in IT (chip_smoke's PASS_STEADY). Every block stages,
//   with passes or without, so that the staging does not depend on IT.
// - astype_only and pack_only read 8 and W/32 rows a pass: spread over the
//   card, 200 of their passes add 0.1-1.7 us to a launch, no more than the
//   launch's own jitter (astype_only's times a pass at IT and 2 IT read
//   30% and 149% apart on two cards). They take fewer pass groups, so that
//   200 passes add 7-10 us: astype_only 1 (its pass is one ~0.1 us chain;
//   100 rounds), pack_only 8 (a ~0.6 us pass; 13 rounds).
// - A pass in registers: the columns are the M side of an m64nN fragment
//   and the rows its N side. A warp owns a 16-column slab; lane l takes
//   columns l/4 and l/4 + 8 of it, and of each 128-row tile the rows
//   8 j + c2 + e (j < 16, e < 2, c2 = 2 (l % 4)), read from shared memory
//   every pass (through a volatile pointer, as the TPU kernel reads VMEM
//   every pass), a tile at a time (a second tile of registers, loaded
//   while the first is reduced, made the passes 1-20% slower on an H100:
//   select_breakdown's two_tiles). A thread reduces its own values of a
//   group first (8 a column for a 32-row group, 32 for a 128-row one, in
//   ascending rows), then two xor shuffles (1, 2) finish the group across
//   the quad, the arg-minimum riding along in (value, row) order
//   (`keep_min`). Each group's result joins a per-column running sum in
//   registers, in group order. No pass has a barrier or a serial tail.
//   pack_only's thread sums the keys of rows 32 b + c2 into four partial
//   sums a column (i32 sums wrap, so in any order); its c2 = 0 thread
//   holds the answer.
// - The packed key ORs in the row's run-time term c2 + ..., so no key is a
//   bare shifted negation (ptxas 12.9 drops the negation of such a key fed
//   to a three-input VIMNMX3 at -O1 and above; B13 does the same).
// - Only the slot that runs pass IT - 1 stores row 0, so the result is
//   deterministic. Every pass's result folds into a register checksum,
//   stored only if g < 1 (which the entry point refuses), so no pass is
//   dead code; the condition is not the pass loop's bound, through whose
//   guard a compiler could thread it.
//
// The entry point launches on the stream it is given, allocates nothing,
// and returns cudaGetLastError() after the launch.

#include <cuda_pipeline.h>

#include "wgmma_common.cuh"

namespace {

constexpr int kCols = 32;             // columns of a block: two 16-column slabs
constexpr int kSlots = 2;             // passes a block runs at once, two warps each
constexpr int kThreads = 64 * kSlots;
constexpr int kPitch = 36;            // words of a staged row: 32 columns and 4 of padding
constexpr int kMaxRows = 1536;

enum Variant {
  kAstypeOnly = 0,
  kI32Min128 = 1,
  kI32Min32 = 2,
  kF32Min32 = 3,
  kPackOnly = 4,
  kPackMin32 = 5,
  kF32MinArg128 = 6,
  kF32MinArg32 = 7
};

__device__ __forceinline__ int packed_key(uint32_t v, int row) {
  return static_cast<int>(((0u - v) << 5) | static_cast<uint32_t>(row));
}

__device__ __forceinline__ float as_f32(uint32_t v) { return __int2float_rn(static_cast<int>(v)); }

// One group of the tile values a[j][e][h] (rows 8 j + c2 + e, columns
// col + 8 h; x + add is taken here): group b's rows are j in [j0, j0 +
// kGroup / 8), j0 = b kGroup / 8. Adds its result to isum (i32 minima,
// arg-minima) and fsum (f32 minima).
template <int kV, int kGroup>
__device__ __forceinline__ void group_select(const uint32_t (&a)[16][2][2], uint32_t add, int b, int c2,
                                             uint32_t (&isum)[2], float (&fsum)[2]) {
  constexpr int kJ = kGroup / 8;
  const int j0 = b * kJ;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    auto x = [&](int r) { return a[j0 + r / 2][r % 2][h] + add; };  // row 8 (r / 2) + c2 + r % 2 of the group
    if constexpr (kV == kI32Min128 || kV == kI32Min32 || kV == kPackMin32) {
      auto key = [&](int r) {
        return kV == kPackMin32 ? packed_key(x(r), 8 * (r / 2) + c2 + r % 2) : static_cast<int>(x(r));
      };
      int m = key(0);
#pragma unroll
      for (int r = 1; r < 2 * kJ; ++r) m = min(m, key(r));
      m = min(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = min(m, __shfl_xor_sync(0xffffffffu, m, 2));
      isum[h] += static_cast<uint32_t>(m);
    } else if constexpr (kV == kF32Min32) {
      float m = as_f32(x(0));
#pragma unroll
      for (int r = 1; r < 2 * kJ; ++r) m = fminf(m, as_f32(x(r)));
      m = fminf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fminf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      fsum[h] = __fadd_rn(fsum[h], m);
    } else {  // f32 minimum and first arg-minimum
      float m = as_f32(x(0));
      int am = c2;
#pragma unroll
      for (int r = 1; r < 2 * kJ; ++r) {
        const float v = as_f32(x(r));
        if (v < m) {  // ascending rows, '<': the thread's first minimum
          m = v;
          am = 8 * (r / 2) + c2 + r % 2;
        }
      }
#pragma unroll
      for (int s = 1; s <= 2; s *= 2)
        keep_min(__shfl_xor_sync(0xffffffffu, m, s), __shfl_xor_sync(0xffffffffu, am, s), m, am);
      fsum[h] = __fadd_rn(fsum[h], m);
      isum[h] += static_cast<uint32_t>(am);
    }
  }
}

// This thread's values of the 128-row tile from row t0: a[j][e][h] is row
// t0 + 8 j + c2 + e, column col + 8 h (xr points at row c2, column col).
__device__ __forceinline__ void load_tile(const volatile uint32_t* xr, int t0, uint32_t (&a)[16][2][2]) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int h = 0; h < 2; ++h) a[j][e][h] = xr[(t0 + 8 * j + e) * kPitch + 8 * h];
}

template <int kV, int kGroup>
__device__ __forceinline__ void tile_select(const uint32_t (&a)[16][2][2], uint32_t add, int c2, uint32_t (&isum)[2],
                                            float (&fsum)[2]) {
#pragma unroll
  for (int b = 0; b < 128 / kGroup; ++b) group_select<kV, kGroup>(a, add, b, c2, isum, fsum);
}

// One pass over the staged copy, of x + add, for this thread's columns col
// and col + 8: v[h] is row 0 of column col + 8 h, the same in the quad's four
// threads (pack_only: in its c2 = 0 thread). xr points at row c2, column col
// of the copy.
template <int kV>
__device__ __forceinline__ void select_pass(const volatile uint32_t* xr, int w, uint32_t add, int c2, float (&v)[2]) {
  if constexpr (kV == kAstypeOnly) {
    const int q0 = (threadIdx.x % 32) & ~3;  // the quad's c2 = 0 lane
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float f0 = as_f32(xr[8 * h] + add), f1 = as_f32(xr[kPitch + 8 * h] + add);  // rows c2, c2 + 1
      float s = __shfl_sync(0xffffffffu, f0, q0);
      s = __fadd_rn(s, __shfl_sync(0xffffffffu, f1, q0));
#pragma unroll
      for (int q = 1; q < 4; ++q) {  // rows 0-7 in order
        s = __fadd_rn(s, __shfl_sync(0xffffffffu, f0, q0 + q));
        s = __fadd_rn(s, __shfl_sync(0xffffffffu, f1, q0 + q));
      }
      v[h] = s;
    }
  } else if constexpr (kV == kPackOnly) {
    uint32_t s[2][4] = {};  // four partial sums a column (i32 sums wrap: any order)
#pragma unroll 1
    for (int r = 0; r < w; r += 128) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          s[h][k] += static_cast<uint32_t>(packed_key(xr[(r + 32 * k) * kPitch + 8 * h] + add, c2));  // row term c2
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) v[h] = as_f32(s[h][0] + s[h][1] + s[h][2] + s[h][3]);
  } else {
    constexpr int kGroup = (kV == kI32Min128 || kV == kF32MinArg128) ? 128 : 32;
    uint32_t isum[2] = {0u, 0u};
    float fsum[2] = {-0.0f, -0.0f};  // the identity of a rounded f32 sum
    uint32_t a[16][2][2];
#pragma unroll 1
    for (int t0 = 0; t0 < w; t0 += 128) {
      load_tile(xr, t0, a);
      tile_select<kV, kGroup>(a, add, c2, isum, fsum);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if constexpr (kV == kF32Min32)
        v[h] = fsum[h];
      else if constexpr (kV == kF32MinArg128 || kV == kF32MinArg32)
        v[h] = __fadd_rn(fsum[h], as_f32(isum[h]));
      else
        v[h] = as_f32(isum[h]);
    }
  }
}

template <int kV>
__global__ void __launch_bounds__(kThreads, 1) select_kernel(const int* x, float* out, int w, int g, int iters) {
  extern __shared__ __align__(16) uint32_t xs[];  // [w][kPitch]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c0 = blockIdx.x * kCols;
  for (int e = threadIdx.x; e < w * 8; e += kThreads) {  // 16 bytes a copy, eight a row
    const int r = e / 8, c = 4 * (e % 8);
    __pipeline_memcpy_async(xs + r * kPitch + c, x + static_cast<size_t>(r) * g + c0 + c, 16);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  const int slot = warp / 2, c2 = 2 * (lane % 4), col = 16 * (warp % 2) + lane / 4;
  const volatile uint32_t* xr = xs + c2 * kPitch + col;
  const int groups = gridDim.y;
  uint32_t check = 0;
#pragma unroll 1
  for (int i = blockIdx.y + groups * slot; i < iters; i += groups * kSlots) {
    float v[2];
    select_pass<kV>(xr, w, static_cast<uint32_t>(i), c2, v);
    if (i == iters - 1 && c2 == 0) {
      out[c0 + col] = v[0];
      out[c0 + col + 8] = v[1];
    }
    check = check * 31u + (__float_as_uint(v[0]) ^ __float_as_uint(v[1]));
  }
  if (g < 1) out[c0 + col] = __uint_as_float(check);  // never: keeps every pass live
}

// Pass groups of the grid for g columns on the current device: enough to
// fill its SMs, fewer for the variants that read a few rows a pass.
int pass_groups(int g, int variant, int* groups) {
  if (variant == kAstypeOnly || variant == kPackOnly) {
    *groups = variant == kAstypeOnly ? 1 : 8;
    return 0;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int fill = sms / (g / kCols);
  *groups = fill > 1 ? fill : 1;
  return 0;
}

template <int kV>
int launch(const int* x, float* out, int w, int g, int iters, cudaStream_t stream) {
  const size_t smem = sizeof(uint32_t) * static_cast<size_t>(w) * kPitch;
  int groups = 0;
  if (int err = pass_groups(g, kV, &groups)) return err;
  auto kernel = select_kernel<kV>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(g / kCols, groups), kThreads, smem, stream>>>(x, out, w, g, iters);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// B12. x: [w, g] int32, 16-byte aligned, w a multiple of 128 up to 1,536,
// g of 32; out: [8, g] f32, of which the kernel writes row 0 (the caller
// zeroes the rest).
int usearch_select_loop(const int* x, float* out, int w, int g, int iters, int variant, void* stream) {
  if (w <= 0 || w % 128 || w > kMaxRows || g <= 0 || g % kCols || iters < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kAstypeOnly:
      return launch<kAstypeOnly>(x, out, w, g, iters, s);
    case kI32Min128:
      return launch<kI32Min128>(x, out, w, g, iters, s);
    case kI32Min32:
      return launch<kI32Min32>(x, out, w, g, iters, s);
    case kF32Min32:
      return launch<kF32Min32>(x, out, w, g, iters, s);
    case kPackOnly:
      return launch<kPackOnly>(x, out, w, g, iters, s);
    case kPackMin32:
      return launch<kPackMin32>(x, out, w, g, iters, s);
    case kF32MinArg128:
      return launch<kF32MinArg128>(x, out, w, g, iters, s);
    case kF32MinArg32:
      return launch<kF32MinArg32>(x, out, w, g, iters, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The blocks of B12's grid for g columns and the variant on the current
// device (g a positive multiple of 32).
int usearch_select_blocks(int g, int variant, int* blocks) {
  if (g <= 0 || g % kCols || variant < kAstypeOnly || variant > kF32MinArg32) return cudaErrorInvalidValue;
  int groups = 0;
  if (int err = pass_groups(g, variant, &groups)) return err;
  *blocks = g / kCols * groups;
  return 0;
}

}  // extern "C"
