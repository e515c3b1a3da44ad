// Device arithmetic shared by the IVF probe kernels of usearch_torch
// (csrc/probe.cu: B3, B5, B7; csrc/pair.cu: B6), one copy for all of them:
// the storage types' dot products, the rank-form distances of the TPU
// kernels' `_window_dists` and `_rank_epilogue`, bit for bit, and the
// staging of row slices through shared memory.
//
// Each source that includes it is compiled on its own; everything here has
// internal linkage.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBin = 128;            // rows of one bin
constexpr int kWords = 32;           // 4-byte words of the width per stage
constexpr int kStride = kWords + 4;  // padded shared row, in words
constexpr float kMasked = 3.0e38f;   // MASKED of ops/distances.py

// the probe kernels' codes (ops/probe.py METRIC_CODES, DTYPE_CODES)
enum Metric { kIP = 0, kCos = 1, kL2sq = 2, kHamming = 3 };
enum DType { kI8 = 0, kBF16 = 1, kF32 = 2, kB1 = 3 };

template <typename T> struct Acc { using type = float; };
template <> struct Acc<int8_t> { using type = int; };
template <> struct Acc<uint8_t> { using type = int; };

// acc += <four words of t, four words of q> in the storage type's arithmetic
__device__ __forceinline__ void mac4(int& acc, uint4 t, uint4 q, int8_t) {
  acc = __dp4a(static_cast<int>(t.x), static_cast<int>(q.x), acc);
  acc = __dp4a(static_cast<int>(t.y), static_cast<int>(q.y), acc);
  acc = __dp4a(static_cast<int>(t.z), static_cast<int>(q.z), acc);
  acc = __dp4a(static_cast<int>(t.w), static_cast<int>(q.w), acc);
}

// packed b1: the and-count of 128 bits
__device__ __forceinline__ void mac4(int& acc, uint4 t, uint4 q, uint8_t) {
  acc += __popc(t.x & q.x) + __popc(t.y & q.y) + __popc(t.z & q.z) + __popc(t.w & q.w);
}

__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ void mac4(float& acc, uint4 t, uint4 q, __nv_bfloat16) {
  const uint32_t tw[4] = {t.x, t.y, t.z, t.w};
  const uint32_t qw[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc = __fmaf_rn(bf_lo(tw[i]), bf_lo(qw[i]), acc);
    acc = __fmaf_rn(bf_hi(tw[i]), bf_hi(qw[i]), acc);
  }
}

__device__ __forceinline__ void mac4(float& acc, uint4 t, uint4 q, float) {
  acc = __fmaf_rn(__uint_as_float(t.x), __uint_as_float(q.x), acc);
  acc = __fmaf_rn(__uint_as_float(t.y), __uint_as_float(q.y), acc);
  acc = __fmaf_rn(__uint_as_float(t.z), __uint_as_float(q.z), acc);
  acc = __fmaf_rn(__uint_as_float(t.w), __uint_as_float(q.w), acc);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(int x) { return __int2float_rn(x); }

// `_window_dists`, operation for operation (no contraction); hamming is
// l2sq's expression over popcounts and the and-count.
__device__ __forceinline__ float window_dist(int metric, float dot, float q_sq, float t_sq, bool has_pen,
                                             float pen) {
  float d;
  if (metric == kIP) {
    d = __fsub_rn(1.0f, dot);
  } else if (metric == kCos) {
    const float rs = t_sq == 0.0f ? 0.0f : __fdiv_rn(1.0f, __fsqrt_rn(t_sq));
    d = -__fmul_rn(dot, rs);
    if (t_sq == 0.0f && q_sq == 0.0f) d = -1.0f;
  } else {
    d = __fsub_rn(t_sq, __fmul_rn(2.0f, dot));
  }
  return has_pen ? __fadd_rn(d, pen) : d;
}

// `_rank_epilogue`.
__device__ __forceinline__ float rank_epilogue(int metric, float acc, float q_sq) {
  if (metric == kIP || acc >= kMasked * 0.5f) return acc;
  if (metric == kL2sq || metric == kHamming) return fmaxf(__fadd_rn(acc, q_sq), 0.0f);
  const float scale = q_sq == 0.0f ? 1.0f : __fdiv_rn(1.0f, __fsqrt_rn(q_sq));
  return __fadd_rn(1.0f, __fmul_rn(acc, scale));
}

// Rows [lo, hi) of src starting at row0 (rows of row_words words), words
// [w0, w0 + kWords) of each, into rows [lo, hi) of dst (rows of kStride
// words), in coalesced 16-byte loads shared by the n_threads threads of the
// block.
__device__ __forceinline__ void stage(uint32_t* dst, const uint32_t* src, int row0, int lo, int hi, int row_words,
                                      int w0, int tid, int n_threads) {
  for (int e = lo * (kWords / 4) + tid; e < hi * (kWords / 4); e += n_threads) {
    const int r = e / (kWords / 4), c = e % (kWords / 4);
    reinterpret_cast<uint4*>(dst + r * kStride)[c] =
        __ldg(reinterpret_cast<const uint4*>(src + static_cast<size_t>(row0 + r) * row_words + w0) + c);
  }
}

}  // namespace
