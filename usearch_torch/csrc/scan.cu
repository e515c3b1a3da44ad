// Binned scan kernels of usearch_torch, for Hopper (sm_90a).
//
// B1 `usearch_binned_scan` replaces the TPU kernel `_make_binned_t_kernel`
// (usearch_tpu/ops/pallas_scan.py:446), which `pallas_search_binned
// (transposed=True)` launches for approximate search. B2
// `usearch_binned_minima` replaces `_make_binned_t_min_kernel`
// (pallas_scan.py:631), which `pallas_search_exact` launches for exact
// search. For every query and every 128-row bin of the table both compute
// the dots, the ip/cos/l2sq epilogue plus the deleted-row penalty, and the
// bin's minimum; B1 also keeps the first row that reaches it.
//
// Outputs are [n_q, n_bins], so the top-k that follows reads each query's
// bins as one contiguous row:
//   B1          f32 minima + i32 global row ids
//   B1 compact  bf16 minima of the shifted distance + i8 row within the bin;
//               f32 tiles and queries are rounded to bf16 before the dot
//   B2          f32 minima only
//
// Dots are exact where the reference's are: i8 x i8 sums in i32 (__dp4a),
// bf16 and f32 in f32 with f32 FMAs (no TF32), so the bin minima of the
// exact path are full precision.
//
// Bound on this card: the work is a [n_q, W] x [W, N] product. At the
// serving shape (N = 2^20, W = 256, Q = 16384) that is 4.4e12 MACs against
// 1.3 GB of memory traffic (table once, bin surfaces once), so the tensor
// cores' rate bounds it, not memory. This first version is a plain
// register-tiled SIMT product: a block owns one bin (128 rows) and 128
// queries, each of its 256 threads 8 rows x 8 queries, the width streamed
// through shared memory 8 words at a time. The [rows, queries] scores never
// leave registers; the epilogue and the bin reduction run in the block.
// Moving the product to the tensor cores (mma.sync / wgmma) is later work.
//
// Every entry point launches on the stream it is given, allocates nothing,
// and returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBin = 128;      // rows of one bin = table rows of one block
constexpr int kBQ = 128;       // queries of one block
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kTM = 8;         // rows per thread
constexpr int kTN = 8;         // queries per thread
constexpr int kWords = 8;      // 4-byte words of the width per stage
constexpr int kPad = 4;        // shared-memory row padding, in 4-byte words

enum Metric { kIP = 0, kCos = 1, kL2sq = 2 };
enum Mode { kBinned = 0, kCompact = 1, kMinima = 2 };
enum DType { kI8 = 0, kBF16 = 1, kF32 = 2 };

// Shared-memory operand type and elements per 4-byte word of storage. i8
// stays packed four to a word and multiplies with __dp4a.
template <typename T> struct Elem;
template <> struct Elem<int8_t> { using type = int; static constexpr int per_word = 1; };
template <> struct Elem<__nv_bfloat16> { using type = float; static constexpr int per_word = 2; };
template <> struct Elem<float> { using type = float; static constexpr int per_word = 1; };

__device__ __forceinline__ float mac(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ int mac(int a, int b, int c) { return __dp4a(a, b, c); }

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(int x) { return __int2float_rn(x); }

__device__ __forceinline__ void lds8(float (&r)[8], const float* p) {
  const float4 x = reinterpret_cast<const float4*>(p)[0];
  const float4 y = reinterpret_cast<const float4*>(p)[1];
  r[0] = x.x; r[1] = x.y; r[2] = x.z; r[3] = x.w;
  r[4] = y.x; r[5] = y.y; r[6] = y.z; r[7] = y.w;
}

__device__ __forceinline__ void lds8(int (&r)[8], const int* p) {
  const int4 x = reinterpret_cast<const int4*>(p)[0];
  const int4 y = reinterpret_cast<const int4*>(p)[1];
  r[0] = x.x; r[1] = x.y; r[2] = x.z; r[3] = x.w;
  r[4] = y.x; r[5] = y.y; r[6] = y.z; r[7] = y.w;
}

// Copies words [w0, w0 + kWords) of `n_rows` rows into S[k][row] (k-major,
// so a thread's 8 rows are one 32-byte read); rows past n_rows read as 0.
template <typename T, bool kRound>
__device__ __forceinline__ void load_stage(typename Elem<T>::type (*S)[kBin + kPad],
                                           const uint32_t* __restrict__ base, int row_words,
                                           int n_rows, int w0, int tid) {
#pragma unroll
  for (int e = tid; e < kBin * kWords; e += kThreads) {
    const int r = e / kWords;
    const int w = e % kWords;
    const uint32_t bits = r < n_rows ? __ldg(base + (size_t)r * row_words + w0 + w) : 0u;
    if constexpr (std::is_same<T, int8_t>::value) {
      S[w][r] = static_cast<int>(bits);
    } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      S[2 * w][r] = __uint_as_float(bits << 16);
      S[2 * w + 1][r] = __uint_as_float(bits & 0xffff0000u);
    } else {
      float x = __uint_as_float(bits);
      if constexpr (kRound) x = __bfloat162float(__float2bfloat16_rn(x));
      S[w][r] = x;
    }
  }
}

// The reference's _epilogue_t, operation for operation (no contraction).
__device__ __forceinline__ float epilogue(int metric, bool shifted, float dot, float q_sq,
                                          float t_sq, float penalty) {
  float d;
  if (metric == kIP) {
    d = shifted ? -dot : __fsub_rn(1.0f, dot);
  } else if (metric == kCos) {
    const float off = shifted ? 0.0f : 1.0f;
    const float denom = __fmul_rn(__fsqrt_rn(q_sq), __fsqrt_rn(t_sq));
    const float safe = denom == 0.0f ? 1.0f : denom;
    const float base = __fsub_rn(off, __fdiv_rn(dot, safe));
    const bool qz = q_sq == 0.0f;
    const bool tz = t_sq == 0.0f;
    d = (qz && tz) ? off - 1.0f : (qz != tz ? off : base);
  } else {
    const float two_dot = __fmul_rn(2.0f, dot);
    d = shifted ? __fsub_rn(t_sq, two_dot) : fmaxf(__fsub_rn(__fadd_rn(q_sq, t_sq), two_dot), 0.0f);
  }
  return __fadd_rn(d, penalty);
}

template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
binned_kernel(const T* __restrict__ q, const T* __restrict__ table,
              const float* __restrict__ q_sq, const float* __restrict__ t_sq,
              const float* __restrict__ penalty, void* __restrict__ out_v,
              void* __restrict__ out_i, int n_q, int n_bins, int width, int metric) {
  using S = typename Elem<T>::type;
  constexpr int kK = kWords * Elem<T>::per_word;  // operand rows per stage
  constexpr bool kRound = kMode == kCompact && std::is_same<T, float>::value;
  __shared__ __align__(16) S t_s[kK][kBin + kPad];
  __shared__ __align__(16) S q_s[kK][kBQ + kPad];
  __shared__ float red_v[kBin / kTM][kBQ];
  __shared__ int red_i[kBin / kTM][kBQ];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // query group
  const int ty = tid / 16;  // row group
  const int bin = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const int row0 = bin * kBin;
  const int row_words = width * (int)sizeof(T) / 4;
  const int q_rows = min(kBQ, n_q - q0);
  const uint32_t* t_base = reinterpret_cast<const uint32_t*>(table) + (size_t)row0 * row_words;
  const uint32_t* q_base = reinterpret_cast<const uint32_t*>(q) + (size_t)q0 * row_words;

  S acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = S(0);

  for (int w0 = 0; w0 < row_words; w0 += kWords) {
    load_stage<T, kRound>(t_s, t_base, row_words, kBin, w0, tid);
    load_stage<T, kRound>(q_s, q_base, row_words, q_rows, w0, tid);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      S a[kTM], b[kTN];
      lds8(a, &t_s[k][ty * kTM]);
      lds8(b, &q_s[k][tx * kTN]);
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = mac(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue and this thread's part of the bin reduction: rows ascending,
  // strict '<', so the first row reaching the minimum wins (jnp.argmin).
  const bool shifted = kMode == kCompact;
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
      const float d = epilogue(metric, shifted, to_float(acc[i][j]), qs, t_sq_r[i], pen_r[i]);
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
    } else if constexpr (kMode == kCompact) {
      static_cast<__nv_bfloat16*>(out_v)[o] = __float2bfloat16_rn(best);
      static_cast<int8_t*>(out_i)[o] = static_cast<int8_t>(arg);
    } else {
      static_cast<float*>(out_v)[o] = best;
    }
  }
}

template <int kMode>
int launch(const void* q, const void* table, const float* q_sq, const float* t_sq,
           const float* penalty, void* out_v, void* out_i, int n_q, int n_rows, int width,
           int dtype, int metric, void* stream) {
  if (n_q <= 0 || n_rows <= 0 || n_rows % kBin || metric < kIP || metric > kL2sq)
    return cudaErrorInvalidValue;
  const int n_bins = n_rows / kBin;
  const dim3 grid(n_bins, (n_q + kBQ - 1) / kBQ);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kI8:
      if (width % (4 * kWords)) return cudaErrorInvalidValue;
      binned_kernel<int8_t, kMode><<<grid, kThreads, 0, s>>>(
          static_cast<const int8_t*>(q), static_cast<const int8_t*>(table), q_sq, t_sq,
          penalty, out_v, out_i, n_q, n_bins, width, metric);
      break;
    case kBF16:
      if (width % (2 * kWords)) return cudaErrorInvalidValue;
      binned_kernel<__nv_bfloat16, kMode><<<grid, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(table),
          q_sq, t_sq, penalty, out_v, out_i, n_q, n_bins, width, metric);
      break;
    case kF32:
      if (width % kWords) return cudaErrorInvalidValue;
      binned_kernel<float, kMode><<<grid, kThreads, 0, s>>>(
          static_cast<const float*>(q), static_cast<const float*>(table), q_sq, t_sq,
          penalty, out_v, out_i, n_q, n_bins, width, metric);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// B1. compact != 0 selects bf16 shifted minima + i8 within-bin rows.
int usearch_binned_scan(const void* q, const void* table, const float* q_sq, const float* t_sq,
                        const float* penalty, void* out_v, void* out_i, int n_q, int n_rows,
                        int width, int dtype, int metric, int compact, void* stream) {
  return compact ? launch<kCompact>(q, table, q_sq, t_sq, penalty, out_v, out_i, n_q, n_rows,
                                    width, dtype, metric, stream)
                 : launch<kBinned>(q, table, q_sq, t_sq, penalty, out_v, out_i, n_q, n_rows,
                                   width, dtype, metric, stream);
}

// B2. Writes f32 bin minima only.
int usearch_binned_minima(const void* q, const void* table, const float* q_sq,
                          const float* t_sq, const float* penalty, void* out_v, int n_q,
                          int n_rows, int width, int dtype, int metric, void* stream) {
  return launch<kMinima>(q, table, q_sq, t_sq, penalty, out_v, nullptr, n_q, n_rows, width,
                         dtype, metric, stream);
}

}  // extern "C"
