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
// The product runs on `wgmma`: m64nNk32 s8 x s8 -> s32 for i8 and i8f32,
// m64nNk16 bf16 x bf16 -> f32 for bf16 and cast, N = 128 or 64 columns a
// warpgroup, both operands from shared memory (K-major, 128-byte
// swizzled). The operands hold integers below 128 in magnitude and K * 128
// * 128 <= 2^24, so every partial sum of one step is an exact integer in
// f32 as in s32, whatever the order; each step starts its sums at 0 in
// registers of its own, and acc adds the step's product once, rounding to
// nearest (f32 modes) in step order. So the result equals the plain version
// bit for bit, past 2^24 too.
//
// Layout. Block (x, y) owns rows [64 y, 64 y + 64) of acc (one `wgmma` M
// tile; rows past M are zero operands, computed and never stored) and a
// slice of `wgs` x `knw` columns, warpgroup w the knw columns from w x knw,
// in registers for the whole run. Its slice of b0 stays in shared memory as
// the B operand, and so do the tile's rows of a0 where they fit (else they
// are read from device memory). Each step rebuilds A = a0 + parity, the
// tile's 64 rows x K, in a's own arithmetic (bf16 rounds, i8 wraps; cast
// rounds the wrapped i8 to bf16, exactly, by integer means), into `slots`
// 128-byte K-blocks of shared memory (all of them where they fit), then
// one proxy fence and barrier, then the products.
//
// The step-to-step dependency, without a grid barrier. Only the lead blocks
// (those whose columns start below K) produce parity: after step s each
// puts the bits of its columns below K into shared memory for its own next
// step and into bits[s] (a buffer per step, never rewritten), and raises
// flags[y][s] with release semantics (__threadfence, then an atomic add).
// A block that needs bits it does not make (every other block, and a lead
// block when K spans several) waits for flags[y][s] to count the lead
// blocks with acquire semantics and reads them through L2 (__ldcg). Warp 0
// builds no part of A: it runs the handshake while the other warps build.
// A lead block alone in its row tile (K within a block's columns, the
// script's case) raises flag s at step s + 1, so its fence runs under the
// build and the chain of steps stays inside the block; a block that is not
// a lead acquires flag s there, trails the lead by a step, copies the bits
// while its own product runs, and never waits on another block that is not
// a lead. All blocks must be resident at once (cooperative launch): a block
// spinning on a flag must not wait for one that was never scheduled.
// `usearch_loop_chain` runs the same kernel with the product taken out
// (acc stays 0): the floor of the step chain without the product.
//
// Bound on this card: 2 x M x K x N x REPS operations at the tensor cores'
// int8 (1,979 TOP/s) or bf16 (989 TFLOP/s) rate; at the script's shape
// (256 x 256 x 8192, 512 steps) 0.278 ms and 0.556 ms, with 128 blocks of
// 64 rows x 256 columns. The bytes (operands and acc once) are a few
// megabytes. What holds it above that is the lead block's chain: each step
// its whole product, then the parity, then the next A (PERF.md, Findings).
//
// The entry points launch on the stream they are given, allocate nothing,
// and return cudaGetLastError() after the launch.

#include "wgmma_common.cuh"

namespace {

constexpr int kTileM = 64;      // rows of acc a block owns: one wgmma M tile
constexpr int kABlock = kTileM * kKB;  // 8 KB: one K-block of the A tile

enum LoopMode { kLoopBF16 = 0, kLoopI8 = 1, kLoopI8F32 = 2, kLoopCast = 3 };

struct LoopParams {
  const void* a;    // [M, K] bf16 (bf16) or i8
  const void* b;    // [N, K] the same
  void* out;        // [M, N] i32 (i8) or f32
  uint32_t* bits;   // [reps][Mp][K / 32] parity of acc[:, :K] after each step, bit k % 32 of word k / 32
  int* flags;       // [Mp / 64][reps] lead blocks done with each step, 0 at the launch
  int m, k, n, reps, slots, a0_resident;
};

// Bytes a row of A or B takes in shared memory: whole 128-byte K-blocks,
// zero past K.
__host__ __device__ __forceinline__ int row_bytes(int k, int elem) { return (k * elem + kKB - 1) / kKB * kKB; }

// Shared memory: B [n_kb][columns][128 B], the A ring [slots][64][128 B],
// the parity bits [2][64][K / 32], the tile's rows of a0 when resident
// ([64][K] as in device memory); slack to align the base to 1 KB.
__host__ __device__ __forceinline__ int loop_smem(int cols, int k, int elem, int a0_elem, int slots, int a0_resident) {
  return cols * row_bytes(k, elem) + slots * kABlock + 2 * kTileM * (k / 32) * 4 +
         (a0_resident ? kTileM * k * a0_elem : 0) + 1024;
}

// the low four bits of x as four bytes of 0 or 1
__device__ __forceinline__ uint32_t spread4(uint32_t x) {
  return (x & 1u) | ((x & 2u) << 7) | ((x & 4u) << 14) | ((x & 8u) << 21);
}

// two bf16 of a word (lo, hi), each plus a parity bit, in bf16 arithmetic
// (the bits as bf16 0.0 or 1.0, 0x3f80, without a conversion)
__device__ __forceinline__ uint32_t add_bits_bf16(uint32_t w, uint32_t bits2) {
  const uint32_t one = (bits2 & 1u) * 0x3f80u | ((bits2 >> 1) & 1u) * 0x3f800000u;
  __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&w);
  v = __hadd2(v, *reinterpret_cast<const __nv_bfloat162*>(&one));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// byte b of w, an i8, as bf16 in the low half: exactly, since |x| <= 128
// has at most 8 significant bits (the f32 of x + 2^23 + 128 less 2^23 +
// 128, then its high half)
__device__ __forceinline__ uint32_t i8_bf16(uint32_t w, int b) {
  const float x = __uint_as_float(0x4b000000u | (((w >> (8 * b)) & 0xffu) ^ 0x80u)) - 8388736.0f;
  return __float_as_uint(x) >> 16;
}

// four i8 as two pairs of bf16
__device__ __forceinline__ uint2 cast4(uint32_t w) {
  return make_uint2(i8_bf16(w, 0) | i8_bf16(w, 1) << 16, i8_bf16(w, 2) | i8_bf16(w, 3) << 16);
}

// x % 2 of an integer-valued acc: the low bit of an int; for an f32, the
// bit of weight 1: the low mantissa bit of |x| + 2^23 below 2^23, of x
// itself below 2^24, and 0 above (every f32 past 2^24 is even)
__device__ __forceinline__ uint32_t parity(int x) { return static_cast<uint32_t>(x) & 1u; }
__device__ __forceinline__ uint32_t parity(float x) {
  const float ax = fabsf(x);
  const uint32_t lsb = __float_as_uint(ax < 8388608.0f ? ax + 8388608.0f : ax) & 1u;
  return ax < 16777216.0f ? lsb : 0u;
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// K-blocks kb0 to kb0 + count - 1 of the A tile into `dst` (one 8 KB slot
// each): the tile's rows of a0 (`a`, row r at r * K elements, in shared or
// device memory) plus their parity bits (`bits`: [64][kw] words), 16-byte
// chunks in the 128-byte swizzle that wgmma reads; zero past M (rows from
// `rows`) and past K.
template <int kMode>
__device__ __forceinline__ void build_a(uint8_t* dst, const uint8_t* a, const uint32_t* bits, int kw, int kb0,
                                        int count, int rows, int k, int tid, int threads) {
  constexpr int kElem = kMode == kLoopBF16 ? 2 : 1;    // bytes of an a0 element
  constexpr int kCols = kMode == kLoopI8 || kMode == kLoopI8F32 ? 16 : 8;  // columns of a chunk
#pragma unroll 4
  for (int e = tid; e < count * kTileM * 8; e += threads) {
    const int kb = kb0 + e / (kTileM * 8), r = (e / 8) % kTileM, c = e % 8;
    const int k0 = kb * 8 * kCols + c * kCols;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows && k0 < k) {
      const uint32_t w = bits[r * kw + k0 / 32] >> (k0 % 32);
      const uint8_t* src = a + (static_cast<size_t>(r) * k + k0) * kElem;
      if constexpr (kMode == kLoopBF16) {
        const uint4 x = *reinterpret_cast<const uint4*>(src);
        v = make_uint4(add_bits_bf16(x.x, w), add_bits_bf16(x.y, w >> 2), add_bits_bf16(x.z, w >> 4),
                       add_bits_bf16(x.w, w >> 6));
      } else if constexpr (kMode == kLoopCast) {
        // the i8 sums wrap, then each is cast to bf16
        const uint2 x = *reinterpret_cast<const uint2*>(src);
        const uint2 lo = cast4(__vadd4(x.x, spread4(w))), hi = cast4(__vadd4(x.y, spread4(w >> 4)));
        v = make_uint4(lo.x, lo.y, hi.x, hi.y);
      } else {
        const uint4 x = *reinterpret_cast<const uint4*>(src);
        v = make_uint4(__vadd4(x.x, spread4(w)), __vadd4(x.y, spread4(w >> 4)), __vadd4(x.z, spread4(w >> 8)),
                       __vadd4(x.w, spread4(w >> 12)));
      }
    }
    *reinterpret_cast<uint4*>(dst + (kb - kb0) * kABlock + r * kKB + ((c ^ (r & 7)) << 4)) = v;
  }
}

// The block's columns of b0 as the B operand, once: [n_kb][cols][128 B],
// swizzled, cast's i8 rows as bf16; zero past K.
template <int kMode>
__device__ __forceinline__ void load_b(uint8_t* dst, const uint8_t* b, int col0, int cols, int n_kb, int k, int tid,
                                       int threads) {
  constexpr bool kS8 = kMode == kLoopI8 || kMode == kLoopI8F32;
  constexpr int kCols = kS8 ? 16 : 8;  // columns of a chunk
#pragma unroll 1
  for (int e = tid; e < n_kb * cols * 8; e += threads) {
    const int kb = e / (cols * 8), rr = (e / 8) % cols, c = e % 8;
    const int k0 = kb * 8 * kCols + c * kCols;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (k0 < k) {
      const size_t at = static_cast<size_t>(col0 + rr) * k + k0;
      if constexpr (kMode == kLoopCast) {
        const uint2 x = __ldg(reinterpret_cast<const uint2*>(b + at));
        const uint2 lo = cast4(x.x), hi = cast4(x.y);
        v = make_uint4(lo.x, lo.y, hi.x, hi.y);
      } else {
        v = __ldg(reinterpret_cast<const uint4*>(b + at * (kS8 ? 1 : 2)));
      }
    }
    *reinterpret_cast<uint4*>(dst + (kb * cols + rr) * kKB + ((c ^ (rr & 7)) << 4)) = v;
  }
}

// kNW: columns of a warpgroup (128 or 64); kChain: the product taken out.
template <int kMode, int kNW, bool kChain>
__global__ void __launch_bounds__(kNW == 128 ? 2 * kWG : 3 * kWG, 1) loop_wgmma(const LoopParams p) {
  constexpr bool kS8 = kMode == kLoopI8 || kMode == kLoopI8F32;  // s8 products, else bf16
  constexpr int kElem = kS8 ? 1 : 2;                             // bytes of an operand element in shared memory
  constexpr int kA0Elem = kMode == kLoopBF16 ? 2 : 1;            // bytes of an a0 element
  using AccT = typename std::conditional<kMode == kLoopI8, int, float>::type;
  using DotT = typename std::conditional<kS8, int, float>::type;
  constexpr int kRegs = kNW / 2;  // accumulators of a thread

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int threads = blockDim.x;
  const int cols = threads / kWG * kNW;  // the block's columns
  const int kw = p.k / 32;               // parity words of a row
  const int rb = row_bytes(p.k, kElem);
  const int n_kb = rb / kKB;
  uint8_t* b_s = smem;                                                    // [n_kb][cols][128 B]
  uint8_t* a_s = b_s + cols * rb;                                         // [slots][64][128 B]
  uint32_t* bits_s = reinterpret_cast<uint32_t*>(a_s + p.slots * kABlock);  // [2][64][kw]
  uint8_t* a0_s = reinterpret_cast<uint8_t*>(bits_s + 2 * kTileM * kw);      // [64][K] when resident

  const int tid = threadIdx.x, wg = tid / kWG, warp = (tid % kWG) / 32, l = tid % 32;
  const int q4 = l % 4, c2 = 2 * q4;
  const int col0 = blockIdx.x * cols;
  const int row0 = blockIdx.y * kTileM;
  const int mp = gridDim.y * kTileM;
  const bool lead = col0 < p.k;
  const int n_lead = (p.k + cols - 1) / cols;
  const int lw0 = col0 / 32, lw1 = min(p.k, col0 + cols) / 32;  // a lead block's words [lw0, lw1)
  int* flags = p.flags + blockIdx.y * p.reps;
  const int rows = min(kTileM, p.m - row0);  // the tile's rows inside M
  const uint8_t* a0 = static_cast<const uint8_t*>(p.a) + static_cast<size_t>(row0) * p.k * kA0Elem;

  load_b<kMode>(b_s, static_cast<const uint8_t*>(p.b), col0, cols, n_kb, p.k, tid, threads);
  if (p.a0_resident) {
    const int chunks = rows * p.k * kA0Elem / 16;
    for (int e = tid; e < chunks; e += threads)
      reinterpret_cast<uint4*>(a0_s)[e] = __ldg(reinterpret_cast<const uint4*>(a0) + e);
  }
  for (int e = tid; e < kTileM * kw; e += threads) bits_s[e] = 0u;
  fence_proxy_async();
  __syncthreads();

  // the bits of step s (after its product) into bits_s[(s + 1) & 1], all
  // but a lead block's own words; flag s was acquired before a barrier
  auto copy_bits = [&](int s) {
    uint32_t* nxt = bits_s + ((s + 1) & 1) * kTileM * kw;
    const uint32_t* src = p.bits + (static_cast<size_t>(s) * mp + row0) * kw;
    for (int e = tid; e < kTileM * kw; e += threads) {
      const int w = e % kw;
      if (!lead || w < lw0 || w >= lw1) nxt[e] = __ldcg(src + e);
    }
  };
  auto wait_flag = [&](int s) {
    while (ld_acquire(flags + s) < n_lead) {
    }
  };

  AccT acc[kRegs];
  DotT d[kRegs];
#pragma unroll
  for (int i = 0; i < kRegs; ++i) {
    acc[i] = AccT(0);
    d[i] = DotT(0);
  }
  const uint32_t b_addr = smem_addr(b_s + wg * kNW * kKB);

  for (int s = 0; s < p.reps; ++s) {
    const uint32_t* cur = bits_s + (s & 1) * kTileM * kw;
    const bool more = s + 1 < p.reps;
    // A = a0 + this step's bits, `slots` K-blocks at a time (all of them
    // where they fit), each group's products issued once it is in shared
    // memory
    if constexpr (!kChain) {
      fence_acc(d);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    }
    for (int kb0 = 0; kb0 < n_kb; kb0 += p.slots) {
      const int count = min(p.slots, n_kb - kb0);
      if (kb0 > 0) {
        // the previous group's products read the slots: done, in every warpgroup
        if constexpr (!kChain) asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
        __syncthreads();
      }
      if (tid >= 32) {
        if (p.a0_resident)  // two inlined copies: shared-memory loads in this one
          build_a<kMode>(a_s, a0_s, cur, kw, kb0, count, rows, p.k, tid - 32, threads - 32);
        else
          build_a<kMode>(a_s, a0, cur, kw, kb0, count, rows, p.k, tid - 32, threads - 32);
      } else if (tid == 0 && kb0 == 0) {
        // warp 0 builds nothing: the handshake runs under the others' build.
        // A lead block alone in its row tile raises flag s - 1 (the bits
        // were stored before the last step's barrier); a block that is not
        // a lead acquires flag s, so it trails the lead by a step and its
        // copy of bits[s] runs under its product
        if (lead && n_lead == 1 && s > 0) {
          __threadfence();
          atomicAdd(flags + s - 1, 1);
        }
        if (!lead && more) wait_flag(s);
      }
      fence_proxy_async();
      __syncthreads();
      if constexpr (!kChain) {
        for (int kb = kb0; kb < kb0 + count; ++kb) {
          const uint64_t da = sw128_desc(smem_addr(a_s + (kb - kb0) * kABlock));
          const uint64_t db = sw128_desc(b_addr + kb * cols * kKB);
#pragma unroll
          for (int k = 0; k < kKB / 32; ++k) mma_k(d, da + 2 * k, db + 2 * k, kb | k);
        }
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      }
    }
    if (!lead && more) copy_bits(s);  // flag s acquired before the barrier above
    if constexpr (!kChain) {
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_acc(d);
    }
    // acc += this step's product: i32 wraps, f32 rounds once
#pragma unroll
    for (int i = 0; i < kRegs; ++i) {
      if constexpr (kMode == kLoopI8)
        acc[i] = static_cast<int>(static_cast<uint32_t>(acc[i]) + static_cast<uint32_t>(d[i]));
      else if constexpr (kMode == kLoopI8F32)
        acc[i] = __fadd_rn(acc[i], __int2float_rn(d[i]));
      else
        acc[i] = __fadd_rn(acc[i], d[i]);
    }
    if (lead && more) {
      // the parity of this warpgroup's columns below K: word w0 + jw of row
      // r gathers, from the four threads of a quad, columns 8 q + c2 and
      // 8 q + c2 + 1 of column tiles 4 jw + q
      uint32_t* nxt = bits_s + ((s + 1) & 1) * kTileM * kw;
      uint32_t* dst = p.bits + (static_cast<size_t>(s) * mp + row0) * kw;
      const int w0 = (col0 + wg * kNW) / 32;
#pragma unroll
      for (int jw = 0; jw < kNW / 32; ++jw) {
        if (w0 + jw >= kw) break;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t w = 0;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            w |= parity(acc[4 * (4 * jw + q) + 2 * h]) << (8 * q);
            w |= parity(acc[4 * (4 * jw + q) + 2 * h + 1]) << (8 * q + 1);
          }
          w <<= c2;
          w |= __shfl_xor_sync(0xffffffffu, w, 1);
          w |= __shfl_xor_sync(0xffffffffu, w, 2);
          if (q4 == 0) {
            const int r = 16 * warp + l / 4 + 8 * h;
            nxt[r * kw + w0 + jw] = w;
            dst[r * kw + w0 + jw] = w;
          }
        }
      }
      if (n_lead > 1) {
        // the other lead blocks' words: raise flag s now, then wait for it
        __syncthreads();
        if (tid == 0) {
          __threadfence();
          atomicAdd(flags + s, 1);
          wait_flag(s);
        }
        __syncthreads();
        copy_bits(s);
      }
    }
    __syncthreads();
  }

  // acc out: rows 16 warp + l / 4 + 8 h, columns 8 j + c2 and 8 j + c2 + 1
  AccT* out = static_cast<AccT*>(p.out);
#pragma unroll
  for (int j = 0; j < kNW / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 16 * warp + l / 4 + 8 * h;
      if (r >= p.m) continue;
      AccT* o = out + static_cast<size_t>(r) * p.n + col0 + wg * kNW + 8 * j + c2;
      o[0] = acc[4 * j + 2 * h];
      o[1] = acc[4 * j + 2 * h + 1];
    }
}

template <int kMode, int kNW, bool kChain>
int launch(LoopParams p, int wgs, cudaStream_t stream) {
  const int elem = kMode == kLoopI8 || kMode == kLoopI8F32 ? 1 : 2;
  const int smem = loop_smem(wgs * kNW, p.k, elem, kMode == kLoopBF16 ? 2 : 1, p.slots, p.a0_resident);
  auto kernel = loop_wgmma<kMode, kNW, kChain>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&p};
  const dim3 grid(p.n / (wgs * kNW), (p.m + kTileM - 1) / kTileM);
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), grid, dim3(wgs * kWG), args, smem,
                                    stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <bool kChain>
int loop_entry(const void* a, const void* b, void* out, void* bits, void* flags, int m, int k, int n, int reps,
               int mode, int knw, int wgs, int slots, int a0_resident, void* stream) {
  const int elem = mode == kLoopI8 || mode == kLoopI8F32 ? 1 : 2;
  const int n_kb = row_bytes(k, elem) / kKB;
  if (m <= 0 || m % 16 || m > 4 * kTileM || k <= 0 || k % 64 || k > n || k > 1024 || n % 64 || reps < 1 ||
      (knw != 64 && knw != 128) || wgs < 1 || wgs > (knw == 128 ? 2 : 3) || n % (knw * wgs) || slots < 1 ||
      slots > n_kb ||
      loop_smem(knw * wgs, k, elem, mode == kLoopBF16 ? 2 : 1, slots, a0_resident) > kSmem)
    return cudaErrorInvalidValue;
  const LoopParams p{a,    b, out,   static_cast<uint32_t*>(bits), static_cast<int*>(flags), m, k, n, reps, slots,
                     a0_resident};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LOOP_MODE(M)                                                                             \
  case M:                                                                                        \
    return knw == 128 ? launch<M, 128, kChain>(p, wgs, s) : launch<M, 64, kChain>(p, wgs, s);
  switch (mode) {
    LOOP_MODE(kLoopBF16)
    LOOP_MODE(kLoopI8)
    LOOP_MODE(kLoopI8F32)
    LOOP_MODE(kLoopCast)
    default:
      return cudaErrorInvalidValue;
  }
#undef LOOP_MODE
}

}  // namespace

extern "C" {

// B11. a, b: [M, K], [N, K] bf16 (mode bf16) or i8, 16-byte aligned; out:
// [M, N] i32 (mode i8) or f32; bits: [reps, Mp, K / 32] 32-bit scratch, Mp
// = M rounded up to 64; flags: [Mp / 64, reps] int32, zero. M % 16 == 0, M
// <= 256, K % 64 == 0, K <= N, K <= 1024, N % (knw * wgs) == 0; knw 128
// (wgs <= 2) or 64 (wgs <= 3) columns a warpgroup; `slots` of the A tile's
// K-blocks in shared memory at a time (1 to all); a0_resident: the tile's
// rows of a0 in shared memory too; all shared memory within kSmem. The N /
// (knw * wgs) x Mp / 64 blocks must be resident at once.
int usearch_loop_matmul(const void* a, const void* b, void* out, void* bits, void* flags, int m, int k, int n,
                        int reps, int mode, int knw, int wgs, int slots, int a0_resident, void* stream) {
  return loop_entry<false>(a, b, out, bits, flags, m, k, n, reps, mode, knw, wgs, slots, a0_resident, stream);
}

// B11 with the product taken out: the same steps, handshake and stores,
// acc 0 throughout; its time is the chain's floor.
int usearch_loop_chain(const void* a, const void* b, void* out, void* bits, void* flags, int m, int k, int n,
                       int reps, int mode, int knw, int wgs, int slots, int a0_resident, void* stream) {
  return loop_entry<true>(a, b, out, bits, flags, m, k, n, reps, mode, knw, wgs, slots, a0_resident, stream);
}

}  // extern "C"
