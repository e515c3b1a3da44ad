// Device arithmetic shared by the IVF probe kernels of usearch_torch
// (csrc/probe.cu: B3, B5, B6's lists, B7; csrc/pair.cu: B6's fold), one
// copy for all of them: the rank-form distances of the TPU kernels'
// `_window_dists` and `_rank_epilogue`, bit for bit, and the pairs per cell.
// The metric and dtype codes, the bin, MASKED and the accumulator types are
// csrc/scan_common.cuh's.
//
// Each source that includes it is compiled on its own; everything here has
// internal linkage.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_common.cuh"  // the codes (ops/probe.py METRIC_CODES, DTYPE_CODES), kBin, kMasked, Acc

namespace {

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

constexpr int kLanes = 128;  // pairs per cell

}  // namespace
