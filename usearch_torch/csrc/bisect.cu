// Probe-select bisection of usearch_torch, for Hopper (sm_90a).
//
// B13 `usearch_bisect_probe` replaces the TPU micro-benchmark kernel
// `make_kernel(variant, out_pad)` (scripts/tpu_probe_v2_bisect.py:60): the
// grouped IVF probe's window stream (kernel B3) cut down to its select step,
// one variant a select, so that the time differences between the variants
// measure the selects. A cell of 128 lanes (pairs) walks its n_win =
// meta[c, 3, 0] windows; window w is the w_pad rows from table row
// meta[c, 0, min(w, 127)]. Every lane dots its i8 query with every row of
// every window (exact i32), and its f32 accumulator [out_pad], started at
// `init`, takes:
//   dot_only  entries 0-7 += the dots of window rows 0-7, every window, no
//             lane mask
//   sel_none  per 32-row bin, its row 0's dot
//   sel8      per 8-row bin, the i32 minimum
//   sel32     per 32-row bin, the minimum of the packed key
//             ((-dot) << 5) | row_in_bin (uint32_t arithmetic, so no shift
//             of a negative value), as f32 (rounded to nearest)
//   sel32f    per 32-row bin, the f32 minimum plus its first arg-minimum
// the sel variants only in the lane's own window (qa[pair, 2] == w). The
// output is [cells * 128, out_pad], the accumulators transposed.
//
// Design: B3's, through csrc/probe_common.cuh's `segment_dots`. One block
// of 128 threads a cell, one thread a lane; each window streams through
// shared memory 64 rows and 128 bytes of the width at a time beside the
// cell's query rows, every lane's 64 dots land in registers (__dp4a) and
// are parked in shared memory, and the variant's select runs over them in
// ascending row order, in rolled loops, as B3 and B7 fold theirs. An
// unrolled select over the 64 registers, as first written, is miscompiled
// by ptxas (CUDA 12.9, -O1 and above, sm_90a): the keys of rows 0 and 32,
// -(dot << 5) with nothing ORed in, feed a three-input min (VIMNMX3) and
// their negation is dropped, so sel32 went wrong there while the PTX was
// right and -Xptxas -O0 was right. The rolled loops give no VIMNMX3. The
// accumulators live in shared memory, [out_pad][129] (padded so the
// transposed write is free of bank conflicts), and a sel variant writes
// own ? v : old into every entry it keeps, as the TPU kernel's where
// does: every lane computes its select in every window (an empty volatile
// asm takes v as an input, so the select cannot be moved under the lane's
// own-window test). The variants share everything else. A window that
// does not lie inside the table is skipped (the TPU kernel's copy would
// fault).
//
// Bound on this card: the bytes of the table rows the windows touch, read
// once, plus the queries and the output; at the script's shape (10M x 128
// i8 rows, 1,024 queries x 16 probes, w_pad 1,408, ~8K windows) a few
// tenths of a millisecond at the card's memory rate. The dots of the lanes'
// own windows are far fewer operations. This version runs the product on
// the SIMT cores (dp4a) for all 128 lanes of every window, as the TPU
// kernel's matrix product does; it is B3's cost model, not a fast kernel.
//
// The entry point launches on the stream it is given, allocates nothing,
// and returns cudaGetLastError() after the launch.

#include "probe_common.cuh"

namespace {

constexpr int kAccPitch = kLanes + 1;  // floats of one shared accumulator row
constexpr int kMaxOutPad = 320;

enum Variant { kDotOnly = 0, kSelNone = 1, kSel8 = 2, kSel32 = 3, kSel32f = 4 };

struct BisectParams {
  const int* meta;      // [cells, meta_rows, 128]: row 0 window starts, row 3 the window count
  const int8_t* q;      // [cells * 128, width]
  const float* qa;      // [cells * 128, 8]: column 2 the lane's own window
  const int8_t* table;  // [n_rows, width]
  float* out;           // [cells * 128, out_pad]
  int meta_rows, n_rows, width, w_pad, out_pad;
  float init;
};

// acc[bin] = own ? v : acc[bin], with v computed whatever own is
__device__ __forceinline__ void keep_if_own(float* acc, int bin, float v, bool own) {
  asm volatile("" ::"f"(v));
  float* a = acc + bin * kAccPitch;
  *a = own ? v : *a;
}

__device__ __forceinline__ int packed_key(int dot, int row) {
  return static_cast<int>(((0u - static_cast<uint32_t>(dot)) << 5) | static_cast<uint32_t>(row & 31));
}

template <int kV>
__global__ void __launch_bounds__(kLanes) bisect_kernel(const BisectParams p) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* t_s = smem;                                               // [kRows][kStride]
  uint32_t* q_s = t_s + kRows * kStride;                              // [kLanes][kStride]
  int* dot_s = reinterpret_cast<int*>(q_s + kLanes * kStride);       // [kRows][kLanes]
  float* acc_s = reinterpret_cast<float*>(dot_s + kRows * kLanes);    // [out_pad][kAccPitch]

  const int lane = threadIdx.x;
  const size_t cell = blockIdx.x;
  const int* meta = p.meta + cell * p.meta_rows * kLanes;
  const int n_win = meta[3 * kLanes];
  const int row_words = p.width / 4;
  const uint32_t* t_src = reinterpret_cast<const uint32_t*>(p.table);
  const uint32_t* q_src = reinterpret_cast<const uint32_t*>(p.q) + cell * kLanes * row_words;
  const float own_w = p.qa[(cell * kLanes + lane) * 8 + 2];
  float* acc = acc_s + lane;  // this lane's column
  for (int j = 0; j < p.out_pad; ++j) acc[j * kAccPitch] = p.init;

  for (int w = 0; w < n_win; ++w) {
    const int st = meta[w < kLanes ? w : kLanes - 1];
    if (st < 0 || st > p.n_rows - p.w_pad) continue;
    const bool own = own_w == static_cast<float>(w);
    for (int r0 = 0; r0 < p.w_pad; r0 += kRows) {
      int dots[kRows];
      segment_dots<int8_t>(dots, t_s, q_s, t_src, q_src, st + r0, row_words, 0, kLanes, lane);
      // this lane's dots into its own column, then its rows in ascending
      // order through the variant's select
#pragma unroll
      for (int r = 0; r < kRows; ++r) dot_s[r * kLanes + lane] = dots[r];
      const int* d = dot_s + lane;
      if (kV == kDotOnly) {
        if (r0 == 0) {
#pragma unroll 1
          for (int r = 0; r < 8; ++r) acc[r * kAccPitch] = __fadd_rn(acc[r * kAccPitch], __int2float_rn(d[r * kLanes]));
        }
      } else if (kV == kSelNone) {
#pragma unroll 1
        for (int b = 0; b < kRows / 32; ++b)
          keep_if_own(acc, (r0 + b * 32) / 32, __int2float_rn(d[b * 32 * kLanes]), own);
      } else if (kV == kSel8) {
#pragma unroll 1
        for (int b = 0; b < kRows / 8; ++b) {
          int m = d[b * 8 * kLanes];
#pragma unroll 1
          for (int r = 1; r < 8; ++r) m = min(m, d[(b * 8 + r) * kLanes]);
          keep_if_own(acc, (r0 + b * 8) / 8, __int2float_rn(m), own);
        }
      } else if (kV == kSel32) {
#pragma unroll 1
        for (int b = 0; b < kRows / 32; ++b) {
          int m = packed_key(d[b * 32 * kLanes], 0);
#pragma unroll 1
          for (int r = 1; r < 32; ++r) m = min(m, packed_key(d[(b * 32 + r) * kLanes], r));
          keep_if_own(acc, (r0 + b * 32) / 32, __int2float_rn(m), own);
        }
      } else {
#pragma unroll 1
        for (int b = 0; b < kRows / 32; ++b) {
          float m = __int2float_rn(d[b * 32 * kLanes]);
          int am = 0;
#pragma unroll 1
          for (int r = 1; r < 32; ++r) {
            const float v = __int2float_rn(d[(b * 32 + r) * kLanes]);
            if (v < m) {  // strict: the first arg-minimum stays
              m = v;
              am = r;
            }
          }
          keep_if_own(acc, (r0 + b * 32) / 32, __fadd_rn(m, __int2float_rn(am)), own);
        }
      }
    }
  }

  // the accumulators out, transposed, in coalesced stores
  __syncthreads();
  float* out = p.out + cell * kLanes * p.out_pad;
  for (int e = lane; e < kLanes * p.out_pad; e += kLanes) out[e] = acc_s[(e % p.out_pad) * kAccPitch + e / p.out_pad];
}

template <int kV>
int launch(const BisectParams& p, int cells, cudaStream_t stream) {
  const size_t smem = sizeof(uint32_t) * ((kRows + kLanes) * kStride + kRows * kLanes) +
                      sizeof(float) * p.out_pad * kAccPitch;
  auto kernel = bisect_kernel<kV>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<cells, kLanes, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// B13. meta: [cells, meta_rows >= 4, 128] int32; q: [cells * 128, width]
// i8; qa: [cells * 128, 8] f32; table: [n_rows, width] i8, width a multiple
// of 128; out: [cells * 128, out_pad] f32, out_pad <= 320 and at least the
// variant's entries (8; w_pad / 8 for sel8; w_pad / 32 otherwise); w_pad a
// multiple of 64.
int usearch_bisect_probe(const int* meta, const void* q, const float* qa, const void* table, float* out, int cells,
                         int meta_rows, int n_rows, int width, int w_pad, int out_pad, int variant, float init,
                         void* stream) {
  const int entries = variant == kDotOnly ? 8 : variant == kSel8 ? w_pad / 8 : w_pad / 32;
  if (cells <= 0 || meta_rows < 4 || n_rows <= 0 || width <= 0 || width % 128 || w_pad <= 0 || w_pad % kRows ||
      out_pad > kMaxOutPad || out_pad < entries || variant < kDotOnly || variant > kSel32f)
    return cudaErrorInvalidValue;
  const BisectParams p{meta, static_cast<const int8_t*>(q), qa, static_cast<const int8_t*>(table), out,
                       meta_rows, n_rows, width, w_pad, out_pad, init};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kDotOnly:
      return launch<kDotOnly>(p, cells, s);
    case kSelNone:
      return launch<kSelNone>(p, cells, s);
    case kSel8:
      return launch<kSel8>(p, cells, s);
    case kSel32:
      return launch<kSel32>(p, cells, s);
    default:
      return launch<kSel32f>(p, cells, s);
  }
}

}  // extern "C"
