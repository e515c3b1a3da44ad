// Loop-carried tensor-core product of usearch_torch, for Hopper (sm_90a).
//
// B11 `usearch_loop_matmul` replaces the TPU micro-benchmark kernel
// `pallas_loop(mode)` (scripts/tpu_i8_matmul_probe.py:50), which times the
// matrix unit on REPS products that depend on each other: acc [M, N] starts
// at 0, and every step takes a = a0 + acc[:, :K] % 2 (floor-mod: 0 or 1,
// also for negative acc) and adds a . b0^T to acc. Modes: bf16 (bf16
// operands, f32 sums), i8 (i8 operands, i32 sums), i8f32 (i8 operands, s32
// products turned to f32) and cast (i8 operands cast to bf16, f32 sums).
//
// The product runs on the tensor cores through mma.sync that the kernel
// issues itself: m16n8k32 s8 x s8 -> s32 for i8 and i8f32, m16n8k16
// bf16 x bf16 -> f32 for bf16 and cast. The operands hold integers below
// 128 in magnitude and K * 128 * 128 <= 2^24, so every partial sum of one
// step is an exact integer in f32 as in s32, whatever the order; each step
// starts its sums at 0, and acc adds the step's product once, rounding to
// nearest (f32 modes) in step order. So the result equals the plain
// version bit for bit, past 2^24 too.
//
// The step-to-step dependency. Each block owns 64 columns of acc for all
// M rows, in registers (a warp holds the 16-row tiles mt = warp and
// warp + 8, 8 column tiles of 8 each), with its 64 rows of b0 and all of
// a0 in shared memory for the whole run. Every step needs the parity of
// acc[:, :K] from the step before, which the first K / 64 blocks own. Those
// blocks publish it as M x K bits (8 KB at M = K = 256) into one of two
// buffers in device memory, and the whole grid meets at a grid-wide barrier
// (cooperative launch, so all blocks are resident at once and the barrier
// cannot deadlock); then every block copies the bits into shared memory
// and builds its A fragments as a0 + bit. The other way, every block
// recomputing the lead columns, would add M x K x K products a block a step
// (half again as much work at N / 64 = 128 blocks) and keep another 64-128
// KB of b0 per block; the barrier costs one grid synchronisation a step.
// Two bit buffers suffice: the barrier orders step s's reads before step
// s + 2's writes of the same buffer, and the bits are read through L2
// (__ldcg), not the per-SM L1, which another SM's writes do not update.
//
// Bound on this card: 2 x M x K x N x REPS operations at the tensor cores'
// int8 (1,979 TOP/s) or bf16 (989 TFLOP/s) rate; at the script's shape
// (256 x 256 x 8192, 512 steps) 0.278 ms and 0.556 ms. The bytes (operands
// and acc once) are a few megabytes. This version issues mma.sync
// (Ampere's instruction, below the wgmma rate), keeps b0 in shared memory
// and reloads its fragments every step, and pays a grid barrier per step;
// wgmma and a lighter per-row-tile handshake are later work.
//
// The entry point launches on the stream it is given, allocates nothing,
// and returns cudaGetLastError() after the launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 64;             // columns of acc a block owns
constexpr int kNTiles = kCols / 8;    // 8-column mma tiles a block owns
constexpr int kMaxMTiles = 2;         // 16-row tiles a warp owns (M <= 256)
constexpr int kPad = 16;              // bytes after each shared row: no bank conflicts

enum Mode { kBF16 = 0, kI8 = 1, kI8F32 = 2, kCast = 3 };

struct Params {
  const void* a;    // [M, K] bf16 (bf16) or i8
  const void* b;    // [N, K] the same
  void* out;        // [M, N] i32 (i8) or f32
  uint32_t* bits;   // [2][M][K / 32] parity of acc[:, :K], bit k%32 of word k/32
  int m, k, n, reps;
};

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the low four bits of x as four bytes of 0 or 1
__device__ __forceinline__ uint32_t spread4(uint32_t x) {
  return (x & 1u) | ((x & 2u) << 7) | ((x & 4u) << 14) | ((x & 8u) << 21);
}

// two bf16 of a word (lo, hi), each plus a parity bit, in bf16 arithmetic
__device__ __forceinline__ uint32_t add_bits_bf16(uint32_t w, uint32_t bits2) {
  const __nv_bfloat162 par = __halves2bfloat162(__float2bfloat16_rn(static_cast<float>(bits2 & 1u)),
                                                 __float2bfloat16_rn(static_cast<float>((bits2 >> 1) & 1u)));
  __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&w);
  v = __hadd2(v, par);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// two i8 (lo, hi) plus their parity bits, wrapping as i8 does, cast to a
// pair of bf16
__device__ __forceinline__ uint32_t add_bits_cast(uint16_t w, uint32_t bits2) {
  const int8_t lo = static_cast<int8_t>(static_cast<uint8_t>(w & 0xff) + (bits2 & 1u));
  const int8_t hi = static_cast<int8_t>(static_cast<uint8_t>(w >> 8) + ((bits2 >> 1) & 1u));
  const __nv_bfloat162 v = __halves2bfloat162(__float2bfloat16_rn(static_cast<float>(lo)),
                                              __float2bfloat16_rn(static_cast<float>(hi)));
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ int parity(int x) { return x & 1; }
__device__ __forceinline__ int parity(float x) { return x - 2.0f * floorf(x * 0.5f) != 0.0f; }

template <int kMode>
__global__ void __launch_bounds__(kThreads, 1) loop_matmul_kernel(const Params p) {
  constexpr bool kS8 = kMode == kI8 || kMode == kI8F32;  // s8 products, else bf16
  using AccT = typename std::conditional<kMode == kI8, int, float>::type;
  using DotT = typename std::conditional<kS8, int, float>::type;
  constexpr int kAElem = kMode == kBF16 ? 2 : 1;  // bytes of a staged a0 element
  constexpr int kBElem = kS8 ? 1 : 2;             // b0 staged as bf16 for cast
  constexpr int kKStep = kS8 ? 32 : 16;           // depth of one mma

  extern __shared__ __align__(16) uint8_t smem[];
  const int a_stride = p.k * kAElem + kPad;
  const int b_stride = p.k * kBElem + kPad;
  const int words = p.k / 32;  // parity words of a row
  uint8_t* a_s = smem;                                           // [M][a_stride]
  uint8_t* b_s = a_s + static_cast<size_t>(p.m) * a_stride;      // [kCols][b_stride]
  uint32_t* bits_s = reinterpret_cast<uint32_t*>(b_s + static_cast<size_t>(kCols) * b_stride);  // [M][words]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // the mma fragments' group and thread-in-group
  const int col0 = blockIdx.x * kCols;
  const int m_tiles = p.m / 16;
  cg::grid_group grid = cg::this_grid();

  // a0 (all rows) and this block's rows of b0, once
  {
    const int chunks = p.k * kAElem / 16;
    const uint4* src = static_cast<const uint4*>(p.a);
    for (int e = tid; e < p.m * chunks; e += kThreads)
      *reinterpret_cast<uint4*>(a_s + (e / chunks) * a_stride + (e % chunks) * 16) = src[e];
  }
  if (kMode == kCast) {
    const int8_t* src = static_cast<const int8_t*>(p.b) + static_cast<size_t>(col0) * p.k;
    for (int e = tid; e < kCols * p.k; e += kThreads)
      reinterpret_cast<__nv_bfloat16*>(b_s + (e / p.k) * b_stride)[e % p.k] =
          __float2bfloat16_rn(static_cast<float>(src[e]));
  } else {
    const int chunks = p.k * kBElem / 16;
    const uint4* src = static_cast<const uint4*>(p.b) + static_cast<size_t>(col0) * chunks;
    for (int e = tid; e < kCols * chunks; e += kThreads)
      *reinterpret_cast<uint4*>(b_s + (e / chunks) * b_stride + (e % chunks) * 16) = src[e];
  }

  AccT acc[kMaxMTiles][kNTiles][4];
#pragma unroll
  for (int i = 0; i < kMaxMTiles; ++i)
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = AccT(0);

  for (int s = 0; s < p.reps; ++s) {
    // the parity bits of the previous step's acc (0 at the first)
    if (s == 0) {
      for (int e = tid; e < p.m * words; e += kThreads) bits_s[e] = 0u;
    } else {
      const uint32_t* src = p.bits + static_cast<size_t>((s - 1) & 1) * p.m * words;
      for (int e = tid; e < p.m * words; e += kThreads) bits_s[e] = __ldcg(src + e);
    }
    __syncthreads();

    DotT d[kMaxMTiles][kNTiles][4];
#pragma unroll
    for (int i = 0; i < kMaxMTiles; ++i)
#pragma unroll
      for (int j = 0; j < kNTiles; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) d[i][j][c] = DotT(0);

#pragma unroll 1
    for (int kk = 0; kk < p.k / kKStep; ++kk) {
      uint32_t af[kMaxMTiles][4];
#pragma unroll
      for (int i = 0; i < kMaxMTiles; ++i) {
        const int mt = warp + i * kWarps;
        if (mt >= m_tiles) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // rows g and g + 8 of the tile: registers h and h + 2
          const int row = mt * 16 + g + 8 * h;
          const uint8_t* ar = a_s + row * a_stride;
          if (kS8) {
            const uint32_t wb = bits_s[row * words + kk];
            const uint32_t lo = *reinterpret_cast<const uint32_t*>(ar + kk * 32 + t * 4);
            const uint32_t hi = *reinterpret_cast<const uint32_t*>(ar + kk * 32 + 16 + t * 4);
            af[i][h] = __vadd4(lo, spread4(wb >> (t * 4)));
            af[i][h + 2] = __vadd4(hi, spread4(wb >> (16 + t * 4)));
          } else {
            const uint32_t wb = bits_s[row * words + kk / 2] >> ((kk & 1) * 16);
            if (kMode == kBF16) {
              const uint32_t* ar32 = reinterpret_cast<const uint32_t*>(ar) + kk * 8;
              af[i][h] = add_bits_bf16(ar32[t], wb >> (t * 2));
              af[i][h + 2] = add_bits_bf16(ar32[4 + t], wb >> (8 + t * 2));
            } else {
              const uint16_t* ar16 = reinterpret_cast<const uint16_t*>(ar) + kk * 8;
              af[i][h] = add_bits_cast(ar16[t], wb >> (t * 2));
              af[i][h + 2] = add_bits_cast(ar16[4 + t], wb >> (8 + t * 2));
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        const uint32_t* br =
            reinterpret_cast<const uint32_t*>(b_s + (j * 8 + g) * b_stride) + kk * (kKStep * kBElem / 4);
        const uint32_t b0 = br[t], b1 = br[kKStep * kBElem / 8 + t];
#pragma unroll
        for (int i = 0; i < kMaxMTiles; ++i) {
          if (warp + i * kWarps >= m_tiles) continue;
          if constexpr (kS8)
            mma_s8(d[i][j], af[i], b0, b1);
          else
            mma_bf16(d[i][j], af[i], b0, b1);
        }
      }
    }

    // acc += this step's product: i32 wraps, f32 rounds once
#pragma unroll
    for (int i = 0; i < kMaxMTiles; ++i)
#pragma unroll
      for (int j = 0; j < kNTiles; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if constexpr (kMode == kI8)
            acc[i][j][c] = static_cast<int>(static_cast<uint32_t>(acc[i][j][c]) + static_cast<uint32_t>(d[i][j][c]));
          else if constexpr (kMode == kI8F32)
            acc[i][j][c] = __fadd_rn(acc[i][j][c], __int2float_rn(d[i][j][c]));
          else
            acc[i][j][c] = __fadd_rn(acc[i][j][c], d[i][j][c]);
        }

    if (s + 1 == p.reps) break;
    if (col0 < p.k) {
      // publish the parity of this block's lead columns: word col0 / 32 + jw
      // of row r gathers, from the four lanes of group g, columns
      // 8 q + 2 t and 8 q + 2 t + 1 of tiles 4 jw + q
      uint32_t* dst = p.bits + static_cast<size_t>(s & 1) * p.m * words;
#pragma unroll
      for (int i = 0; i < kMaxMTiles; ++i) {
        const int mt = warp + i * kWarps;
        if (mt >= m_tiles) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int jw = 0; jw < kCols / 32; ++jw) {
            uint32_t w = 0;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              w |= static_cast<uint32_t>(parity(acc[i][jw * 4 + q][2 * h])) << (q * 8 + 2 * t);
              w |= static_cast<uint32_t>(parity(acc[i][jw * 4 + q][2 * h + 1])) << (q * 8 + 2 * t + 1);
            }
            w |= __shfl_xor_sync(0xffffffffu, w, 1);
            w |= __shfl_xor_sync(0xffffffffu, w, 2);
            if (t == 0) dst[(mt * 16 + g + 8 * h) * words + col0 / 32 + jw] = w;
          }
      }
    }
    grid.sync();
  }

  // acc out: rows g and g + 8 of each tile, columns 2 t and 2 t + 1
  AccT* out = static_cast<AccT*>(p.out);
#pragma unroll
  for (int i = 0; i < kMaxMTiles; ++i) {
    const int mt = warp + i * kWarps;
    if (mt >= m_tiles) continue;
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        AccT* o = out + static_cast<size_t>(mt * 16 + g + 8 * h) * p.n + col0 + j * 8 + 2 * t;
        o[0] = acc[i][j][2 * h];
        o[1] = acc[i][j][2 * h + 1];
      }
  }
}

template <int kMode>
int launch(Params p, cudaStream_t stream) {
  const int a_elem = kMode == kBF16 ? 2 : 1, b_elem = (kMode == kI8 || kMode == kI8F32) ? 1 : 2;
  const size_t smem = static_cast<size_t>(p.m) * (p.k * a_elem + kPad) +
                      static_cast<size_t>(kCols) * (p.k * b_elem + kPad) + static_cast<size_t>(p.m) * (p.k / 32) * 4;
  auto kernel = loop_matmul_kernel<kMode>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(p.n / kCols), dim3(kThreads),
                                    args, smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// B11. a, b: [M, K], [N, K] bf16 (mode bf16) or i8; out: [M, N] i32 (mode
// i8) or f32; bits: [2, M, K / 32] 32-bit scratch. M % 16 == 0, M <= 256,
// K % 64 == 0, K <= N, K <= 1024, N % 64 == 0; the N / 64 blocks must be
// resident at once.
int usearch_loop_matmul(const void* a, const void* b, void* out, void* bits, int m, int k, int n, int reps, int mode,
                        void* stream) {
  if (m <= 0 || m % 16 || m > kMaxMTiles * kWarps * 16 || k <= 0 || k % kCols || k > n || k > 1024 || n % kCols ||
      reps < 1)
    return cudaErrorInvalidValue;
  const Params p{a, b, out, static_cast<uint32_t*>(bits), m, k, n, reps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kBF16:
      return launch<kBF16>(p, s);
    case kI8:
      return launch<kI8>(p, s);
    case kI8F32:
      return launch<kI8F32>(p, s);
    case kCast:
      return launch<kCast>(p, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
