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
// fill every other column. It takes ip/cos/l2sq over i8/bf16/f32 rows (the
// `nofold` flavour, at most 8 per bin) and b1 rows with hamming (the select
// of the tanimoto/sorensen probe, whose exact re-rank runs outside).
//
// B7 `usearch_binned_probe` replaces `_make_binned_probe_kernel`
// (pallas_probe.py:636), launched by `pallas_ivf_probe_binned` (:799), the
// `bin` flavour: i8 rows only, over each pair's whole padded window with no
// window mask, stats or penalty, the raw int32 dot of every row, and per
// bw-row bin the `keep` largest, written round-major (round j of bin b at
// column j * (w_pad / bw) + b) as f32 -dot beside the global row. The TPU
// kernel selects by min-reducing the packed key (-dot << 5) | row_in_bin
// (`pack`) or by f32 min and first argmin (`fminarg`); here each lane keeps
// a sorted list of `keep` (-dot, row) entries per bin, fed rows in
// ascending order with a strict '<' on -dot (pack) or on -dot rounded to f32
// (fminarg), which is the same order. It shares B3's window stream
// (`find_segments`, `segment_dots`): lanes with one padded window are one
// segment, and B3's bound holds.
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
// The dot products, the rank-form distances and the staging loop are
// csrc/probe_common.cuh's, shared with B6 (csrc/pair.cu). The entry points
// launch on the stream they are given, allocate nothing, and return
// cudaGetLastError() after the launch.

#include "probe_common.cuh"

namespace {

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
  const uint32_t* t_src = static_cast<const uint32_t*>(p.table);
  const uint32_t* q_src =
      static_cast<const uint32_t*>(p.q_g) + static_cast<size_t>(blockIdx.x) * kLanes * row_words;
  int st = p.win_start[pair];
  int ln = p.win_len[pair];
  int bs = kFold ? 0 : p.win_base[pair];
  if (st < 0 || ln < 0 || st > p.n_rows - ln) ln = 0;
  if (!kFold && (bs < 0 || bs % kBin || bs > p.n_rows - p.w_pad || st < bs || st - bs > p.w_pad - ln)) ln = 0;
  if (ln == 0) st = bs = 0;
  const float qs = p.q_sq[pair];
  if (!kFold) {
    // MASKED/-1 everywhere first, in coalesced stores; the bins of each
    // window overwrite their columns below
    const size_t cell0 = static_cast<size_t>(blockIdx.x) * kLanes * p.out_pad;
    for (int e = lane; e < kLanes * p.out_pad; e += kLanes) {
      p.out_d[cell0 + e] = kMasked;
      p.out_i[cell0 + e] = -1;
    }
  }
  find_segments(lane, st, ln, bs, seg_st, seg_ln, seg_bs, seg_lo, n_seg);

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
        segment_dots<T>(acc, t_s, q_s, t_src, q_src, r0, row_words, lo, hi, lane);
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
            float v = window_dist(p.metric, dot_s[r * kLanes + lane], qs, ts, p.penalty != nullptr, pen);
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

// B7: per pair, the whole padded window [win_base, win_base + w_pad), no
// masks, no stats; per bw-row bin the `keep` rows of largest i8 dot, by
// (-dot, row) (`pack`, the packed key's order) or by (f32(-dot), row)
// (`fminarg`), written round-major as f32 -dot beside the global row.
struct BinnedParams {
  const int8_t* q_g;      // [P, W]
  const int8_t* table;    // [n_rows, W]
  const int* win_base;    // [P]
  float* out_d;           // [P, out_pad]
  int* out_i;
  int n_rows, width, w_pad, bw, keep, fminarg, out_pad;
};

constexpr int kMaxKeep = 8;

// a before b in a bin's order: (key, row) with the rows met in ascending
// order, so a strict '<' on the key leaves the lower row first
__device__ __forceinline__ bool binned_before(int a, int b, int fminarg) {
  return fminarg ? __int2float_rn(a) < __int2float_rn(b) : a < b;
}

__global__ void __launch_bounds__(kLanes) binned_probe_kernel(const BinnedParams p) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* t_s = smem;                                   // [kRows][kStride]
  uint32_t* q_s = t_s + kRows * kStride;                  // [kLanes][kStride]
  int* dot_s = reinterpret_cast<int*>(q_s + kLanes * kStride);  // [kRows][kLanes]
  int* seg_st = dot_s + kRows * kLanes;                   // [kLanes]
  int* seg_ln = seg_st + kLanes;                          // [kLanes]
  int* seg_bs = seg_ln + kLanes;                          // [kLanes]
  int* seg_lo = seg_bs + kLanes;                          // [kLanes + 1]
  int* n_seg = seg_lo + kLanes + 1;                       // [1]

  const int lane = threadIdx.x;
  const size_t pair = static_cast<size_t>(blockIdx.x) * kLanes + lane;
  const int row_words = p.width / 4;
  const int nbw = p.w_pad / p.bw;
  const uint32_t* t_src = reinterpret_cast<const uint32_t*>(p.table);
  const uint32_t* q_src =
      reinterpret_cast<const uint32_t*>(p.q_g) + static_cast<size_t>(blockIdx.x) * kLanes * row_words;
  const int bs = p.win_base[pair];
  const bool ok = bs >= 0 && bs % kBin == 0 && bs <= p.n_rows - p.w_pad;
  // MASKED/-1 everywhere first, in coalesced stores; each window's bins
  // overwrite their columns below
  const size_t cell0 = static_cast<size_t>(blockIdx.x) * kLanes * p.out_pad;
  for (int e = lane; e < kLanes * p.out_pad; e += kLanes) {
    p.out_d[cell0 + e] = kMasked;
    p.out_i[cell0 + e] = -1;
  }
  // a lane reads its whole padded window, or nothing
  find_segments(lane, ok ? bs : 0, ok ? p.w_pad : 0, ok ? bs : 0, seg_st, seg_ln, seg_bs, seg_lo, n_seg);

  const size_t out0 = pair * p.out_pad;
  const int segs = *n_seg;
  for (int s = 0; s < segs; ++s) {
    const int lo = seg_lo[s], hi = seg_lo[s + 1];
    if (seg_ln[lo] == 0) continue;
    const int base = seg_bs[lo];
    const bool owner = lane >= lo && lane < hi;
    int lv[kMaxKeep];  // this bin's best keys (-dot), ascending
    int li[kMaxKeep];
    for (int r0 = base; r0 < base + p.w_pad; r0 += kRows) {
      int acc[kRows];
      segment_dots<int8_t>(acc, t_s, q_s, t_src, q_src, r0, row_words, lo, hi, lane);
      if (!owner) continue;
#pragma unroll
      for (int r = 0; r < kRows; ++r) dot_s[r * kLanes + lane] = acc[r];
#pragma unroll 1
      for (int r = 0; r < kRows; ++r) {
        const int row = r0 + r;
        const int sub = (row - base) % p.bw;  // bins start at multiples of bw
        if (sub == 0) {
#pragma unroll
          for (int j = 0; j < kMaxKeep; ++j) {
            lv[j] = 0x7fffffff;
            li[j] = -1;
          }
        }
        int v = -dot_s[r * kLanes + lane];
        int id = row;
        bool shift = false;  // past the insertion point every entry moves down one
#pragma unroll
        for (int j = 0; j < kMaxKeep; ++j) {
          if (j < p.keep && (shift || li[j] < 0 || binned_before(v, lv[j], p.fminarg))) {
            shift = true;
            const int tv = lv[j], ti = li[j];
            lv[j] = v;
            li[j] = id;
            v = tv;
            id = ti;
          }
        }
        if (sub == p.bw - 1) {
          // round j of this bin at column j * nbw + bin
          const int bin = (row - base) / p.bw;
#pragma unroll
          for (int j = 0; j < kMaxKeep; ++j) {
            if (j >= p.keep) break;
            p.out_d[out0 + j * nbw + bin] = __int2float_rn(lv[j]);
            p.out_i[out0 + j * nbw + bin] = li[j];
          }
        }
      }
    }
  }
}

size_t binned_smem_bytes() {
  return sizeof(uint32_t) * (kRows + kLanes) * kStride + sizeof(int) * kRows * kLanes +
         sizeof(int) * (4 * kLanes + 2);
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

// B5: ip/cos/l2sq over i8/bf16/f32 rows with bin_m <= 8, hamming over b1
// rows with bin_m <= 16. out_d/out_i are [n_pairs, out_pad] with out_pad =
// ceil(bin_m * w_pad / 128 / 128) * 128. The penalty row is required.
int usearch_grouped_probe_nofold(const void* q_g, const float* q_sq, const void* table,
                                 const float* t_sq, const float* penalty, const int* win_base,
                                 const int* win_start, const int* win_len, float* out_d, int* out_i,
                                 int n_pairs, int n_rows, int width, int dtype, int metric, int w_pad,
                                 int bin_m, void* stream) {
  if (bad_common(n_pairs, n_rows, width, dtype, metric, bin_m, t_sq, penalty) || penalty == nullptr ||
      (dtype != kB1 && bin_m > 8) || w_pad <= 0 || w_pad % kBin || w_pad > n_rows)
    return cudaErrorInvalidValue;
  const int n_cand = bin_m * (w_pad / kBin);
  const int out_pad = (n_cand + kLanes - 1) / kLanes * kLanes;
  const Params p{q_g, q_sq, table, t_sq, penalty, win_base, win_start, win_len, out_d, out_i,
                 n_rows, width, metric, 0, 0, bin_m, w_pad, out_pad};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kI8:
      return launch_typed<int8_t, 8, false>(p, n_pairs, s);
    case kBF16:
      return launch_typed<__nv_bfloat16, 8, false>(p, n_pairs, s);
    case kF32:
      return launch_typed<float, 8, false>(p, n_pairs, s);
    case kB1:
      if (bin_m <= 8) return launch_typed<uint8_t, 8, false>(p, n_pairs, s);
      return launch_typed<uint8_t, 16, false>(p, n_pairs, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// B7, i8 rows of at most 2048 columns. bw is a power of two with 2 keep <=
// bw <= 32 (pack) or 128 (fminarg), keep <= 8. out_d/out_i are [n_pairs,
// out_pad] with out_pad = ceil(keep * w_pad / bw / 128) * 128.
int usearch_binned_probe(const void* q_g, const void* table, const int* win_base, float* out_d, int* out_i,
                         int n_pairs, int n_rows, int width, int w_pad, int bw, int keep, int fminarg,
                         void* stream) {
  if (n_pairs <= 0 || n_pairs % kLanes || n_rows % kBin || width % 128 || width > 2048 || w_pad <= 0 ||
      w_pad % kBin || w_pad > n_rows || bw < 2 || (bw & (bw - 1)) || bw > (fminarg ? kBin : 32) ||
      keep < 1 || keep > kMaxKeep || 2 * keep > bw)
    return cudaErrorInvalidValue;
  const int out_pad = (keep * (w_pad / bw) + kLanes - 1) / kLanes * kLanes;
  const BinnedParams p{static_cast<const int8_t*>(q_g), static_cast<const int8_t*>(table), win_base, out_d,
                       out_i, n_rows, width, w_pad, bw, keep, fminarg, out_pad};
  const size_t smem = binned_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(binned_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  binned_probe_kernel<<<n_pairs / kLanes, kLanes, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
