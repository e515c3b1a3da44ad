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
// Design. The columns are independent, so each block owns 32 of them and
// stages all W rows of those columns into shared memory once (W <= 1,536:
// at most 192 KB), as the TPU kernel holds x in VMEM with no copy in the
// loop (read through a volatile pointer, so every pass loads it again). In
// each pass, warp j reduces groups j, j + 16, ... with one lane a
// column, into a shared [groups][32] buffer; then warp 0 sums each column
// over the groups in order and stores the result. Each pass's store is a
// volatile store followed by a compiler memory barrier, and the passes are
// separated by __syncthreads, so no pass can be merged into the next or
// dropped: a launch of IT passes takes the launch and the staging plus IT
// times one pass.
//
// Bound on this card: the bytes are x read once and [8, G] written once
// (well under a microsecond); the operations are about 2-5 32-bit integer
// or float operations an element and pass, over W x G x IT elements, at
// the card's 67 TFLOP/s f32 rate (the table has no integer SIMT rate; the
// integer rate is lower, so the bound is a lower one). With G = 128 the
// kernel runs on 4 blocks, 4 of the 132 SMs: it measures one SM's
// selection cost, as the TPU script measures one core's.
//
// The entry point launches on the stream it is given, allocates nothing,
// and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;   // columns of a block, one lane each
constexpr int kWarps = 16;  // warps of a block
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

__device__ __forceinline__ uint32_t packed_key(uint32_t v, int row) {
  return ((0u - v) << 5) | static_cast<uint32_t>(row & 31);
}

template <int kV>
__global__ void __launch_bounds__(kWarps * 32) select_kernel(const int* x, float* out, int w, int g, int iters) {
  constexpr int kGroup = (kV == kI32Min128 || kV == kF32MinArg128) ? 128 : 32;
  constexpr bool kPhase1 = kV != kAstypeOnly && kV != kPackOnly;  // per-group reductions
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* xs = smem;                 // [w][kCols]
  uint32_t* res = xs + w * kCols;      // [groups][kCols]: minima (as bits)
  int* arg = reinterpret_cast<int*>(res + (w / 32) * kCols);  // [groups][kCols]: arg-minima

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c0 = blockIdx.x * kCols;
  const int groups = w / kGroup;
  // 16-byte loads, eight a row of the block's columns, several in flight a
  // thread
#pragma unroll 4
  for (int e = tid; e < w * (kCols / 4); e += kWarps * 32)
    reinterpret_cast<uint4*>(xs)[e] =
        *reinterpret_cast<const uint4*>(x + static_cast<size_t>(e / (kCols / 4)) * g + c0 + (e % (kCols / 4)) * 4);
  __syncthreads();
  const volatile uint32_t* xv = xs;  // every pass reads x from shared memory, as the TPU kernel reads VMEM

  volatile float* dst = out + c0 + lane;  // row 0 of the output
  for (int i = 0; i < iters; ++i) {
    const uint32_t add = static_cast<uint32_t>(i);
    if (kPhase1) {
      for (int gi = warp; gi < groups; gi += kWarps) {
        const int r0 = gi * kGroup;
        if (kV == kI32Min128 || kV == kI32Min32 || kV == kPackMin32) {
          int m = 0x7fffffff;
          for (int r = r0; r < r0 + kGroup; ++r) {
            const uint32_t v = xv[r * kCols + lane] + add;
            const int key = static_cast<int>(kV == kPackMin32 ? packed_key(v, r) : v);
            m = min(m, key);
          }
          res[gi * kCols + lane] = static_cast<uint32_t>(m);
        } else {
          float m = __int2float_rn(static_cast<int>(xv[r0 * kCols + lane] + add));
          int am = 0;
          for (int r = r0 + 1; r < r0 + kGroup; ++r) {
            const float v = __int2float_rn(static_cast<int>(xv[r * kCols + lane] + add));
            if (kV == kF32Min32) {
              m = fminf(m, v);
            } else if (v < m) {  // strict: the first arg-minimum stays
              m = v;
              am = r - r0;
            }
          }
          res[gi * kCols + lane] = __float_as_uint(m);
          if (kV != kF32Min32) arg[gi * kCols + lane] = am;
        }
      }
      __syncthreads();
    }
    if (warp == 0) {
      float v;
      if (kV == kAstypeOnly) {
        v = __int2float_rn(static_cast<int>(xv[lane] + add));
        for (int r = 1; r < 8; ++r) v = __fadd_rn(v, __int2float_rn(static_cast<int>(xv[r * kCols + lane] + add)));
      } else if (kV == kPackOnly) {
        uint32_t s = 0;
        for (int r = 0; r < w; r += 32) s += packed_key(xv[r * kCols + lane] + add, r);
        v = __int2float_rn(static_cast<int>(s));
      } else if (kV == kF32Min32) {
        v = __uint_as_float(res[lane]);
        for (int gi = 1; gi < groups; ++gi) v = __fadd_rn(v, __uint_as_float(res[gi * kCols + lane]));
      } else if (kV == kF32MinArg128 || kV == kF32MinArg32) {
        float sm = __uint_as_float(res[lane]);
        uint32_t sa = static_cast<uint32_t>(arg[lane]);
        for (int gi = 1; gi < groups; ++gi) {
          sm = __fadd_rn(sm, __uint_as_float(res[gi * kCols + lane]));
          sa += static_cast<uint32_t>(arg[gi * kCols + lane]);
        }
        v = __fadd_rn(sm, __int2float_rn(static_cast<int>(sa)));
      } else {
        uint32_t s = 0;
        for (int gi = 0; gi < groups; ++gi) s += res[gi * kCols + lane];
        v = __int2float_rn(static_cast<int>(s));
      }
      *dst = v;
      asm volatile("" ::: "memory");  // each pass's store stays
    }
    __syncthreads();  // the groups' results are read before the next pass writes them
  }
}

template <int kV>
int launch(const int* x, float* out, int w, int g, int iters, cudaStream_t stream) {
  const size_t smem = sizeof(uint32_t) * (static_cast<size_t>(w) * kCols + 2 * (w / 32) * kCols);
  auto kernel = select_kernel<kV>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<g / kCols, kWarps * 32, smem, stream>>>(x, out, w, g, iters);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// B12. x: [w, g] int32, w a multiple of 128 up to 1,536, g of 32; out: [8,
// g] f32, of which the kernel writes row 0 (the caller zeroes the rest).
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

}  // extern "C"
