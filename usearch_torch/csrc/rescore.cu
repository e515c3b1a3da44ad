// The exact rescore of usearch_torch's exact flat search, for Hopper (sm_90a).
//
// `ops/scan.block_dots` replaces the product of `one_chunk` in the TPU path
// `pallas_search_exact` (usearch_tpu/ops/pallas_scan.py:789-801): once B2
// (csrc/scan.cu `usearch_binned_minima`) has given every query's bin minima
// and a top-k has picked its b = k + 4 best bins, every row of those bins is
// scored against the query. The TPU path gathers the bins' rows and runs one
// batched `dot_general` (i8 into int32, f32 at HIGHEST, bf16 into f32), which
// XLA fuses with the gather. Here one kernel does the gather and the dots:
//
//   dots[i, j * 128 + r] = <q[i], table[bins[i, j] * 128 + r]>
//
// i8 rows sum exactly in int32 (__dp4a); bf16 rows (products exact in f32)
// and f32 rows in f32 FMAs. The metric's epilogue, the mask and the top-k
// stay torch ops over the [Q, b * 128] dots (ops/scan.exact_steps).
//
// Bound: bytes. The kernel reads Q * b * 128 rows of W elements, each
// (query, bin) block once, and writes Q * b * 128 dots; two operations a
// pair of elements are far below what the integer and FMA pipes issue, and a
// batched matrix-vector product has no reuse for the tensor cores to take.
//
// Design: one block of 128 threads a (query, bin). A bin's 128 rows are one
// contiguous block of the table; 16 teams of 8 lanes each own 8 of its rows.
// Lane l of a team reads 16-byte chunks l, l + 8, ... of each of its rows,
// so a team's load covers 128 contiguous bytes of a row, and holds the
// query's chunk in registers across its 8 rows: 8 independent loads in
// flight a thread, 8 sums. A reduce-scatter of 7 shuffles leaves lane l
// with the sum of the team's row l, which it writes: a warp writes 32
// consecutive dots. The entry point launches on the stream it is given,
// allocates nothing, and returns cudaGetLastError() after the launch.

#include "scan_common.cuh"

namespace {

constexpr int kThreads = kBin;                    // 16 teams of 8 lanes
constexpr int kTeam = 8;                          // lanes that share a row
constexpr int kRows = kBin / (kThreads / kTeam);  // rows of a team: 8
constexpr int kMaxI8Width = 1 << 16;       // i8 bytes a row: |dot| <= 2^16 * 2^14 = 2^30 in int32

// One 16-byte chunk of a query held across a team's rows, and the step that
// adds its products with a table chunk to a sum.
template <typename T> struct Dot;

template <> struct Dot<int8_t> {
  using Acc = int;
  using Q = uint4;
  static __device__ __forceinline__ Q query(const uint4 c) { return c; }
  static __device__ __forceinline__ int step(const Q& q, const uint4 t, int acc) {
    acc = __dp4a(static_cast<int>(q.x), static_cast<int>(t.x), acc);
    acc = __dp4a(static_cast<int>(q.y), static_cast<int>(t.y), acc);
    acc = __dp4a(static_cast<int>(q.z), static_cast<int>(t.z), acc);
    return __dp4a(static_cast<int>(q.w), static_cast<int>(t.w), acc);
  }
};

// bf16 to f32 is a shift: the element at the lower address is the low half.
__device__ __forceinline__ float bf16_lo(const uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(const uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

template <> struct Dot<__nv_bfloat16> {
  using Acc = float;
  struct Q {
    float v[8];
  };
  static __device__ __forceinline__ Q query(const uint4 c) {
    return Q{{bf16_lo(c.x), bf16_hi(c.x), bf16_lo(c.y), bf16_hi(c.y), bf16_lo(c.z), bf16_hi(c.z), bf16_lo(c.w),
              bf16_hi(c.w)}};
  }
  static __device__ __forceinline__ float step(const Q& q, const uint4 t, float acc) {
    acc = fmaf(q.v[0], bf16_lo(t.x), acc);
    acc = fmaf(q.v[1], bf16_hi(t.x), acc);
    acc = fmaf(q.v[2], bf16_lo(t.y), acc);
    acc = fmaf(q.v[3], bf16_hi(t.y), acc);
    acc = fmaf(q.v[4], bf16_lo(t.z), acc);
    acc = fmaf(q.v[5], bf16_hi(t.z), acc);
    acc = fmaf(q.v[6], bf16_lo(t.w), acc);
    return fmaf(q.v[7], bf16_hi(t.w), acc);
  }
};

template <> struct Dot<float> {
  using Acc = float;
  using Q = uint4;
  static __device__ __forceinline__ Q query(const uint4 c) { return c; }
  static __device__ __forceinline__ float step(const Q& q, const uint4 t, float acc) {
    acc = fmaf(__uint_as_float(q.x), __uint_as_float(t.x), acc);
    acc = fmaf(__uint_as_float(q.y), __uint_as_float(t.y), acc);
    acc = fmaf(__uint_as_float(q.z), __uint_as_float(t.z), acc);
    return fmaf(__uint_as_float(q.w), __uint_as_float(t.w), acc);
  }
};

// q [n_q, chunks] and table [n_bins * 128, chunks] in 16-byte chunks of
// their rows; bins [n_q * b] (query-major); dots [n_q * b, 128]. A bin
// outside the table reads nothing and gives 0 dots (the caller passes the
// bins of a top-k over the table's bins).
template <typename T>
__global__ void __launch_bounds__(kThreads, 8)
    block_dots_kernel(const uint4* __restrict__ q, const uint4* __restrict__ table, const int64_t* __restrict__ bins,
                      typename Dot<T>::Acc* __restrict__ dots, int b, int chunks, int64_t n_bins) {
  using D = Dot<T>;
  using Acc = typename D::Acc;
  const int team = threadIdx.x / kTeam, l = threadIdx.x % kTeam;
  const int64_t slot = blockIdx.x;  // query * b + j
  const int64_t bin = bins[slot];
  Acc acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = Acc(0);
  if (bin >= 0 && bin < n_bins) {
    const uint4* qrow = q + (slot / b) * chunks;
    const uint4* rows = table + (bin * kBin + team * kRows) * chunks;
    for (int c = l; c < chunks; c += kTeam) {
      const typename D::Q qc = D::query(__ldg(qrow + c));
      uint4 t[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) t[r] = __ldg(rows + static_cast<int64_t>(r) * chunks + c);
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = D::step(qc, t[r], acc[r]);
    }
  }
  // reduce-scatter across the team: after the step of distance h a lane
  // keeps the half of its rows on its side of bit h, summed with its
  // partner's; after h = 1 it holds row l's sum in acc[0]
#pragma unroll
  for (int h = kRows / 2; h >= 1; h /= 2) {
    const bool upper = (l & h) != 0;
#pragma unroll
    for (int j = 0; j < h; ++j) {
      const Acc send = upper ? acc[j] : acc[j + h];
      const Acc keep = upper ? acc[j + h] : acc[j];
      acc[j] = keep + __shfl_xor_sync(0xffffffffu, send, h);
    }
  }
  dots[slot * kBin + team * kRows + l] = acc[0];
}

template <typename T>
cudaError_t launch(const void* q, const void* table, const int64_t* bins, void* dots, int n_q, int b, int n,
                   int width, cudaStream_t s) {
  const int chunks = static_cast<int>(width * sizeof(T) / 16);
  const int64_t blocks = static_cast<int64_t>(n_q) * b;
  block_dots_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const uint4*>(q), static_cast<const uint4*>(table), bins,
      static_cast<typename Dot<T>::Acc*>(dots), b, chunks, static_cast<int64_t>(n / kBin));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The rescore's dots: q [n_q, width] and table [n, width] of one dtype
// (0 i8, 1 bf16, 2 f32; rows 16-byte aligned), bins [n_q, b] int64 bin ids,
// dots [n_q, b * 128] int32 for i8, f32 otherwise. n and width are
// multiples of 128; i8 rows at most kMaxI8Width wide.
int usearch_block_dots(const void* q, const void* table, const int64_t* bins, void* dots, int n_q, int b, int n,
                       int width, int dtype, void* stream) {
  if (n_q < 0 || b < 1 || n < kBin || n % kBin || width < kBin || width % kBin ||
      static_cast<int64_t>(n_q) * b > 0x7fffffff || (dtype == kI8 && width > kMaxI8Width))
    return cudaErrorInvalidValue;
  if (n_q == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kI8: return static_cast<int>(launch<int8_t>(q, table, bins, dots, n_q, b, n, width, s));
    case kBF16: return static_cast<int>(launch<__nv_bfloat16>(q, table, bins, dots, n_q, b, n, width, s));
    case kF32: return static_cast<int>(launch<float>(q, table, bins, dots, n_q, b, n, width, s));
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
