// Device arithmetic shared by the IVF probe kernels of usearch_torch
// (csrc/probe.cu: B3, B5, B6's lists, B7; csrc/pair.cu: B6's fold;
// csrc/bisect.cu: B13), one
// copy for all of them: the storage types' dot products, the rank-form
// distances of the TPU kernels' `_window_dists` and `_rank_epilogue`, bit
// for bit, the staging of row slices through shared memory, and the grouped
// kernels' window stream (`find_segments`, `segment_dots`). The metric and
// dtype codes, the bin, MASKED and the accumulator types are
// csrc/scan_common.cuh's.
//
// Each source that includes it is compiled on its own; everything here has
// internal linkage.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_common.cuh"  // the codes (ops/probe.py METRIC_CODES, DTYPE_CODES), kBin, kMasked, Acc

namespace {

constexpr int kWords = 32;           // 4-byte words of the width per stage
constexpr int kStride = kWords + 4;  // padded shared row, in words

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

constexpr int kLanes = 128;  // pairs per cell = threads per block
constexpr int kRows = 64;    // rows per pass (half a bin)

// Each lane's window (st, ln, bs) into shared memory, then, from lane 0,
// the runs of lanes that share one: segment s is lanes [seg_lo[s],
// seg_lo[s + 1]), *n_seg of them. A lane with nothing to read passes
// (0, 0, 0).
__device__ __forceinline__ void find_segments(int lane, int st, int ln, int bs, int* seg_st, int* seg_ln,
                                              int* seg_bs, int* seg_lo, int* n_seg) {
  seg_st[lane] = st;
  seg_ln[lane] = ln;
  seg_bs[lane] = bs;
  __syncthreads();
  if (lane == 0) {
    int n = 0;
    for (int l = 0; l < kLanes; ++l)
      if (l == 0 || seg_st[l] != seg_st[l - 1] || seg_ln[l] != seg_ln[l - 1] || seg_bs[l] != seg_bs[l - 1])
        seg_lo[n++] = l;
    seg_lo[n] = kLanes;
    *n_seg = n;
  }
  __syncthreads();
}

// acc of lanes [lo, hi): the dots of their query rows (the cell's rows in
// q_src) with table rows [r0, r0 + kRows). The whole block stages each
// slice of the width of both through shared memory.
template <typename T, typename A>
__device__ __forceinline__ void segment_dots(A (&acc)[kRows], uint32_t* t_s, uint32_t* q_s, const uint32_t* t_src,
                                             const uint32_t* q_src, int r0, int row_words, int lo, int hi,
                                             int lane) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = A(0);
  for (int w0 = 0; w0 < row_words; w0 += kWords) {
    __syncthreads();  // the previous stage is consumed
    stage(t_s, t_src, r0, 0, kRows, row_words, w0, lane, kLanes);
    stage(q_s, q_src, 0, lo, hi, row_words, w0, lane, kLanes);
    __syncthreads();
    if (lane >= lo && lane < hi) {
      const uint4* qrow = reinterpret_cast<const uint4*>(q_s + lane * kStride);
#pragma unroll 1
      for (int c = 0; c < kWords / 4; ++c) {
        const uint4 qv = qrow[c];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          mac4(acc[r], reinterpret_cast<const uint4*>(t_s + r * kStride)[c], qv, T());
      }
    }
  }
}

}  // namespace
