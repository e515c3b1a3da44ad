// Device arithmetic shared by the flat-scan kernels of usearch_torch
// (csrc/scan.cu: B1, B2; csrc/fused.cu: B8, B9, B10), one copy for all of
// them: the scan kernels' metric, dtype and mode codes, the deleted-row
// penalty, the accumulator type of each storage type, the bf16 packing, and
// the reference's ip/cos/l2sq epilogue, bit for bit. The probe kernels
// (csrc/probe_common.cuh) take the same codes, the bin and the penalty from
// here, with hamming and packed b1 rows added.
//
// Each source that includes it is compiled on its own; everything here has
// internal linkage.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the kernels' codes (ops/scan.py _METRIC_CODES, _DTYPE_CODES; ops/probe.py
// METRIC_CODES, DTYPE_CODES: hamming over packed b1 rows is the probe
// kernels' alone)
enum Metric { kIP = 0, kCos = 1, kL2sq = 2, kHamming = 3 };
enum DType { kI8 = 0, kBF16 = 1, kF32 = 2, kB1 = 3 };
// B1's two outputs and B2's (scan.cu)
enum Mode { kBinned = 0, kCompact = 1, kMinima = 2 };

constexpr int kBin = 128;           // rows of one bin
constexpr float kMasked = 3.0e38f;  // MASKED of ops/distances.py: the deleted-row penalty

// Dots of i8 (and packed b1) rows sum exactly in i32; bf16 and f32 rows in
// f32.
template <typename T> struct Acc { using type = float; };
template <> struct Acc<int8_t> { using type = int; };
template <> struct Acc<uint8_t> { using type = int; };

// Two f32 values rounded to bf16 and packed, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The reference's _epilogue_t (shifted: the compact mode's distance, the
// query's constant term left out) and _epilogue, operation for operation
// (no contraction), plus the deleted-row penalty. kRoots: the caller passes
// __fsqrt_rn(q_sq) and __fsqrt_rn(t_sq) as q_rt and t_rt, computed once per
// query and row; the same bits as taking them here.
template <bool kRoots = false>
__device__ __forceinline__ float epilogue(int metric, bool shifted, float dot, float q_sq, float t_sq,
                                          float penalty, float q_rt = 0.0f, float t_rt = 0.0f) {
  float d;
  if (metric == kIP) {
    d = shifted ? -dot : __fsub_rn(1.0f, dot);
  } else if (metric == kCos) {
    const float off = shifted ? 0.0f : 1.0f;
    const float denom = kRoots ? __fmul_rn(q_rt, t_rt) : __fmul_rn(__fsqrt_rn(q_sq), __fsqrt_rn(t_sq));
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

}  // namespace
