// Grouped IVF probe kernels of usearch_torch, for Hopper (sm_90a).
//
// B3 `usearch_grouped_probe` replaces the TPU kernel `_make_grouped_kernel`
// (usearch_tpu/ops/pallas_probe.py:265), which `pallas_ivf_probe_grouped`
// (:871) launches for the dense IVF probe. The input is P (query, partition)
// pairs sorted by partition, in cells of 128; pair p owns the table rows
// [win_start[p], win_start[p] + win_len[p]). For each pair the kernel
//   1. scores the window's rows in the rank form of `_window_dists`
//      (ip 1 - dot, cos -dot/|t|, l2sq and hamming |t|^2 - 2 dot) plus the
//      deleted-row penalty when one is given;
//   2. keeps the bin_m smallest of every 128-row bin of the table, the
//      lower row first on ties;
//   3. keeps the k_pad = max(k, 8) smallest of those candidates, ordered by
//      (distance, extraction round, bin): the order in which the TPU
//      kernel's min/argmin fold meets them;
//   4. applies `_rank_epilogue` and writes the first k distances and global
//      row ids, -1 where nothing was found.
//
// B4 is B3 over packed b1 rows (uint8, 8 bits a byte), with hamming: it
// replaces the uint8 branch of the TPU kernel's `_win_dots`
// (pallas_probe.py:115-141), which sums eight bit-plane i8 products on the
// MXU. Here the and-count is __popc(t & q) over 32-bit words, summed in
// int32: the same integer whatever the bit order, with the popcounts of the
// rows as their squared norms, so hamming is l2sq's expression.
//
// B5 `usearch_grouped_probe_nofold` replaces `_make_grouped_nofold_kernel`
// (pallas_probe.py:453), launched by `pallas_ivf_probe_grouped_nofold`
// (:570): steps 1-2 of B3 over each pair's padded window, w_pad rows from
// its 128-aligned win_base, with no fold. It writes the bin_m best of bin b
// of the padded window, round j at column j * nb_w + b (nb_w = w_pad / 128)
// of the pair's [out_pad] row, with `_rank_epilogue` applied; MASKED and -1
// fill every other column. It takes b1 rows with hamming: the select of the
// tanimoto/sorensen probe, whose exact re-rank runs outside.
//
// Design. One block of 128 threads per cell, one thread per pair (lane).
// Lanes that share a window are a contiguous run of the cell (a segment);
// the block walks its segments in order, and for each 128-row bin of the
// segment's window streams the rows through shared memory, 64 rows and 128
// bytes of the width at a time, beside the same slice of the segment's
// query rows. Only the segment's lanes compute: each thread keeps the dots
// of its query against the 64 rows in registers (i8 with __dp4a into int32,
// exact; b1 with __popc into int32, exact; bf16 and f32 as f32 FMAs, no
// TF32), parks them in shared memory, then folds the rows in ascending
// order into a sorted list of the bin's best (strict '<', so the lower row
// wins ties). After each bin, B3 merges the bin's list into the lane's own
// sorted top-k_pad, kept lane-major in shared memory with each entry's
// extraction round, so equal distances keep the TPU kernel's order; B5
// writes the bin's list to its columns instead, after the block has filled
// its [128, out_pad] outputs with MASKED/-1 in coalesced stores.
//
// Bound on this card: each pair's window is a [w_pad, W] x [W] product,
// 2 x P x w_pad x W operations (a b1 row of B bytes counts as 8 B one-bit
// products); the distinct windows of a cell are read once. At bench.py's
// IVF shape (1M x 256 i8 rows, 16,384 queries, ~311k pairs, w_pad 1,280)
// the bytes of the distinct windows bound it, below half a millisecond at
// the card's memory rate. This first version runs the product on the SIMT
// cores (dp4a, popc), without tensor cores and without a copy pipeline;
// `wgmma` over [bin, W] x [W, lanes] tiles (or the b1 `mma` with and-popc)
// and a TMA ring are later work.
//
// The entry points launch on the stream they are given, allocate nothing,
// and return cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;          // pairs per cell = threads per block
constexpr int kBin = 128;            // rows of one bin
constexpr int kRows = 64;            // rows per pass (half a bin)
constexpr int kWords = 32;           // 4-byte words of the width per stage
constexpr int kStride = kWords + 4;  // padded shared row, in words
constexpr float kMasked = 3.0e38f;   // MASKED of ops/distances.py

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
__device__ __forceinline__ float window_dist(int metric, float dot, float q_sq, float t_sq,
                                             const float* penalty, float pen) {
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
  return penalty != nullptr ? __fadd_rn(d, pen) : d;
}

// `_rank_epilogue`.
__device__ __forceinline__ float rank_epilogue(int metric, float acc, float q_sq) {
  if (metric == kIP || acc >= kMasked * 0.5f) return acc;
  if (metric == kL2sq || metric == kHamming) return fmaxf(__fadd_rn(acc, q_sq), 0.0f);
  const float scale = q_sq == 0.0f ? 1.0f : __fdiv_rn(1.0f, __fsqrt_rn(q_sq));
  return __fadd_rn(1.0f, __fmul_rn(acc, scale));
}

struct Params {
  const void* q_g;        // [P, W] the pairs' query rows
  const float* q_sq;      // [P]
  const void* table;      // [n_rows, W]
  const float* t_sq;      // [n_rows] or null (ip)
  const float* penalty;   // [n_rows] or null (every row live)
  const int* win_base;    // [P] B5: first row of the padded window
  const int* win_start;   // [P]
  const int* win_len;     // [P]
  float* out_d;           // B3 [P, k]; B5 [P, out_pad]
  int* out_i;
  int n_rows, width, metric, k, k_pad, bin_m, w_pad, out_pad;
};

// kFold: B3 (a running top-k per lane); else B5 (per-bin lists written out)
template <typename T, int kMaxBinM, bool kFold>
__global__ void __launch_bounds__(kLanes) grouped_probe_kernel(const Params p) {
  using A = typename Acc<T>::type;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* t_s = smem;                                   // [kRows][kStride]
  uint32_t* q_s = t_s + kRows * kStride;                  // [kLanes][kStride]
  float* aux_t = reinterpret_cast<float*>(q_s + kLanes * kStride);  // [kBin]
  float* aux_p = aux_t + kBin;                            // [kBin]
  int* seg_st = reinterpret_cast<int*>(aux_p + kBin);     // [kLanes]
  int* seg_ln = seg_st + kLanes;                          // [kLanes]
  int* seg_bs = seg_ln + kLanes;                          // [kLanes]
  int* seg_lo = seg_bs + kLanes;                          // [kLanes + 1]
  int* n_seg = seg_lo + kLanes + 1;                       // [1]
  float* lst_v = reinterpret_cast<float*>(n_seg + 3);     // B3 [k_pad][kLanes]
  int* lst_i = reinterpret_cast<int*>(lst_v + p.k_pad * kLanes);
  uint8_t* lst_r = reinterpret_cast<uint8_t*>(lst_i + p.k_pad * kLanes);
  float* dot_s = reinterpret_cast<float*>(lst_r + ((p.k_pad * kLanes + 15) & ~15));  // [kRows][kLanes]

  const int lane = threadIdx.x;
  const size_t pair = static_cast<size_t>(blockIdx.x) * kLanes + lane;
  const int row_words = p.width * static_cast<int>(sizeof(T)) / 4;
  const T* table = static_cast<const T*>(p.table);
  int st = p.win_start[pair];
  int ln = p.win_len[pair];
  int bs = kFold ? 0 : p.win_base[pair];
  if (st < 0 || ln < 0 || st > p.n_rows - ln) ln = 0;
  if (!kFold && (bs < 0 || bs % kBin || bs > p.n_rows - p.w_pad || st < bs || st - bs > p.w_pad - ln)) ln = 0;
  if (ln == 0) st = bs = 0;
  const float qs = p.q_sq[pair];
  seg_st[lane] = st;
  seg_ln[lane] = ln;
  seg_bs[lane] = bs;
  if (!kFold) {
    // MASKED/-1 everywhere first, in coalesced stores; the bins of each
    // window overwrite their columns below
    const size_t cell0 = static_cast<size_t>(blockIdx.x) * kLanes * p.out_pad;
    for (int e = lane; e < kLanes * p.out_pad; e += kLanes) {
      p.out_d[cell0 + e] = kMasked;
      p.out_i[cell0 + e] = -1;
    }
  }
  __syncthreads();
  if (lane == 0) {  // runs of lanes that share a window
    int n = 0;
    for (int l = 0; l < kLanes; ++l)
      if (l == 0 || seg_st[l] != seg_st[l - 1] || seg_ln[l] != seg_ln[l - 1] || seg_bs[l] != seg_bs[l - 1])
        seg_lo[n++] = l;
    seg_lo[n] = kLanes;
    *n_seg = n;
  }
  __syncthreads();

  int cnt = 0;  // B3: entries of this lane's list
  const int segs = *n_seg;
  for (int s = 0; s < segs; ++s) {
    const int lo = seg_lo[s], hi = seg_lo[s + 1];
    const int w_st = seg_st[lo], w_ln = seg_ln[lo];
    if (w_ln == 0) continue;
    const bool owner = lane >= lo && lane < hi;
    const int w_end = w_st + w_ln;
    for (int b = w_st / kBin; b * kBin < w_end; ++b) {
      const int row0 = b * kBin;
      __syncthreads();  // the previous bin's aux is read
      if (p.metric != kIP) aux_t[lane] = p.t_sq[row0 + lane];
      if (p.penalty != nullptr) aux_p[lane] = p.penalty[row0 + lane];
      float bv[kMaxBinM];
      int bi[kMaxBinM];
#pragma unroll
      for (int j = 0; j < kMaxBinM; ++j) {
        bv[j] = __int_as_float(0x7f800000);  // +inf
        bi[j] = -1;
      }
      for (int half = 0; half < kBin / kRows; ++half) {
        const int r0 = row0 + half * kRows;
        if (r0 + kRows <= w_st || r0 >= w_end) continue;
        A acc[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = A(0);
        for (int w0 = 0; w0 < row_words; w0 += kWords) {
          __syncthreads();  // the previous stage is consumed
          const uint32_t* t_src = reinterpret_cast<const uint32_t*>(table);
          for (int e = lane; e < kRows * (kWords / 4); e += kLanes) {
            const int r = e / (kWords / 4), c = e % (kWords / 4);
            const uint4 v = __ldg(reinterpret_cast<const uint4*>(
                t_src + static_cast<size_t>(r0 + r) * row_words + w0) + c);
            reinterpret_cast<uint4*>(t_s + r * kStride)[c] = v;
          }
          const uint32_t* q_src = reinterpret_cast<const uint32_t*>(p.q_g) +
                                  static_cast<size_t>(blockIdx.x) * kLanes * row_words;
          for (int e = lo * (kWords / 4) + lane; e < hi * (kWords / 4); e += kLanes) {
            const int l = e / (kWords / 4), c = e % (kWords / 4);
            const uint4 v = __ldg(reinterpret_cast<const uint4*>(
                q_src + static_cast<size_t>(l) * row_words + w0) + c);
            reinterpret_cast<uint4*>(q_s + l * kStride)[c] = v;
          }
          __syncthreads();
          if (owner) {
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
        if (owner) {
          // this lane's dots, then its rows in ascending order into the
          // bin's sorted list (strict '<': the lower row keeps its place)
#pragma unroll
          for (int r = 0; r < kRows; ++r) dot_s[r * kLanes + lane] = to_float(acc[r]);
#pragma unroll 1
          for (int r = 0; r < kRows; ++r) {
            const int row = r0 + r;
            if (row < w_st || row >= w_end) continue;
            const int rr = half * kRows + r;
            const float ts = p.metric != kIP ? aux_t[rr] : 0.0f;
            const float pen = p.penalty != nullptr ? aux_p[rr] : 0.0f;
            float v = window_dist(p.metric, dot_s[r * kLanes + lane], qs, ts, p.penalty, pen);
            if (!(v < kMasked * 0.5f) || !(v < bv[kMaxBinM - 1])) continue;
            int id = row;
            bool shift = false;  // past the insertion point every entry moves down one
#pragma unroll
            for (int j = 0; j < kMaxBinM; ++j) {
              if (shift || v < bv[j]) {
                shift = true;
                const float tv = bv[j];
                const int ti = bi[j];
                bv[j] = v;
                bi[j] = id;
                v = tv;
                id = ti;
              }
            }
          }
        }
      }
      if (owner && !kFold) {
        // round j of this bin at column j * nb_w + bin of the padded window
        const int col = (row0 - seg_bs[lo]) / kBin;
        const int nb_w = p.w_pad / kBin;
        const size_t out0 = pair * p.out_pad;
#pragma unroll
        for (int j = 0; j < kMaxBinM; ++j) {
          if (j >= p.bin_m || bi[j] < 0) break;
          const float d = rank_epilogue(p.metric, bv[j], qs);
          p.out_d[out0 + j * nb_w + col] = d;
          p.out_i[out0 + j * nb_w + col] = bi[j];
        }
      }
      if (owner && kFold) {
        // merge the bin's candidates (round j = rank within the bin) into
        // the lane's list, ordered by (distance, round, bin)
#pragma unroll
        for (int j = 0; j < kMaxBinM; ++j) {
          if (j >= p.bin_m || bi[j] < 0) break;
          const float v = bv[j];
          int pos = cnt < p.k_pad ? cnt : p.k_pad - 1;
          if (cnt == p.k_pad) {
            const float lv = lst_v[pos * kLanes + lane];
            if (lv < v || (lv == v && lst_r[pos * kLanes + lane] <= j)) break;
          }
          while (pos > 0) {
            const int e = (pos - 1) * kLanes + lane;
            const float ev = lst_v[e];
            if (ev < v || (ev == v && lst_r[e] <= j)) break;
            lst_v[e + kLanes] = ev;
            lst_i[e + kLanes] = lst_i[e];
            lst_r[e + kLanes] = lst_r[e];
            --pos;
          }
          lst_v[pos * kLanes + lane] = v;
          lst_i[pos * kLanes + lane] = bi[j];
          lst_r[pos * kLanes + lane] = static_cast<uint8_t>(j);
          if (cnt < p.k_pad) ++cnt;
        }
      }
    }
  }

  if (kFold) {
    for (int j = 0; j < p.k; ++j) {
      float d = kMasked;
      int id = -1;
      if (j < cnt) {
        d = rank_epilogue(p.metric, lst_v[j * kLanes + lane], qs);
        id = d >= kMasked * 0.5f ? -1 : lst_i[j * kLanes + lane];
      }
      p.out_d[pair * p.k + j] = d;
      p.out_i[pair * p.k + j] = id;
    }
  }
}

size_t smem_bytes(int k_pad) {
  return sizeof(uint32_t) * (kRows + kLanes) * kStride + sizeof(float) * 2 * kBin +
         sizeof(int) * (4 * kLanes + 4) + static_cast<size_t>(k_pad) * kLanes * (4 + 4) +
         ((static_cast<size_t>(k_pad) * kLanes + 15) & ~size_t(15)) + sizeof(float) * kRows * kLanes;
}

template <typename T, int kMaxBinM, bool kFold>
int launch_typed(const Params& p, int n_pairs, cudaStream_t stream) {
  auto kernel = grouped_probe_kernel<T, kMaxBinM, kFold>;
  const size_t smem = smem_bytes(p.k_pad);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_pairs / kLanes, kLanes, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fold(const Params& p, int n_pairs, cudaStream_t stream) {
  if (p.bin_m <= 4) return launch_typed<T, 4, true>(p, n_pairs, stream);
  return launch_typed<T, 16, true>(p, n_pairs, stream);
}

bool bad_common(int n_pairs, int n_rows, int width, int dtype, int metric, int bin_m,
                const float* t_sq, const float* penalty) {
  // hamming goes with packed b1 rows and they with it
  return n_pairs <= 0 || n_pairs % kLanes || n_rows % kBin || width % 128 || bin_m < 1 || bin_m > 16 ||
         metric < kIP || metric > kHamming || (metric == kHamming) != (dtype == kB1) ||
         (metric != kIP && t_sq == nullptr);
}

}  // namespace

extern "C" {

// B3 (B4 for b1 rows with hamming). t_sq may be null for ip; penalty null
// means every row is live.
int usearch_grouped_probe(const void* q_g, const float* q_sq, const void* table,
                          const float* t_sq, const float* penalty, const int* win_start,
                          const int* win_len, float* out_d, int* out_i, int n_pairs, int n_rows,
                          int width, int dtype, int metric, int k, int bin_m, void* stream) {
  const int k_pad = k > 8 ? k : 8;
  if (bad_common(n_pairs, n_rows, width, dtype, metric, bin_m, t_sq, penalty) || k < 1 || k > 128 ||
      bin_m > k_pad)
    return cudaErrorInvalidValue;
  const Params p{q_g, q_sq, table, t_sq, penalty, nullptr, win_start, win_len, out_d, out_i,
                 n_rows, width, metric, k, k_pad, bin_m, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kI8:
      return launch_fold<int8_t>(p, n_pairs, s);
    case kBF16:
      return launch_fold<__nv_bfloat16>(p, n_pairs, s);
    case kF32:
      return launch_fold<float>(p, n_pairs, s);
    case kB1:
      return launch_fold<uint8_t>(p, n_pairs, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// B5, b1 rows with hamming. out_d/out_i are [n_pairs, out_pad] with out_pad
// = ceil(bin_m * w_pad / 128 / 128) * 128.
int usearch_grouped_probe_nofold(const void* q_g, const float* q_sq, const void* table,
                                 const float* t_sq, const float* penalty, const int* win_base,
                                 const int* win_start, const int* win_len, float* out_d, int* out_i,
                                 int n_pairs, int n_rows, int width, int dtype, int metric, int w_pad,
                                 int bin_m, void* stream) {
  if (bad_common(n_pairs, n_rows, width, dtype, metric, bin_m, t_sq, penalty) || dtype != kB1 ||
      penalty == nullptr || w_pad <= 0 || w_pad % kBin || w_pad > n_rows)
    return cudaErrorInvalidValue;
  const int n_cand = bin_m * (w_pad / kBin);
  const int out_pad = (n_cand + kLanes - 1) / kLanes * kLanes;
  const Params p{q_g, q_sq, table, t_sq, penalty, win_base, win_start, win_len, out_d, out_i,
                 n_rows, width, metric, 0, 0, bin_m, w_pad, out_pad};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bin_m <= 8) return launch_typed<uint8_t, 8, false>(p, n_pairs, s);
  return launch_typed<uint8_t, 16, false>(p, n_pairs, s);
}

}  // extern "C"
