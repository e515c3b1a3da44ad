// Flat-scan flavours of usearch_torch, for Hopper (sm_90a).
//
// B8 `usearch_fused_topk` replaces the TPU kernel `_make_kernel`
// (usearch_tpu/ops/pallas_scan.py:113), which `pallas_search` launches: the
// scan fused with a per-query running top-k, so the [n_q, n_bins] surface of
// bin minima never reaches memory. B9 `usearch_fused_topk_stream` replaces
// `_make_dma_kernel` (pallas_scan.py:228), which `pallas_search_dma`
// launches: B8's result, with the table streamed through a two-slot ring of
// asynchronous copies and the merge run once every `merge_every` bins. B10
// `usearch_binned_scan_lanes` replaces `_make_binned_kernel`
// (pallas_scan.py:397), which `pallas_search_binned(transposed=False)`
// launches: B1's surface (csrc/scan.cu) in the TPU's lane orientation,
// [n_bins, n_q], from a query tile that stays in shared memory.
//
// For every query and 128-row bin all three compute the dots, B1's ip/cos/
// l2sq epilogue plus the deleted-row penalty, and the bin's minimum with its
// first row (strict '<' in row order, as jnp.argmin). B8/B9 then insert each
// bin's (minimum, row) into the query's sorted list of k, in bin order, with
// a strict '<': an entry already in the list wins a tie, as the TPU's
// first-index extraction over [list, bins] gives. The list lives in the
// [n_q, k] output rows; entries at or above MASKED / 2 get the id -1.
//
// Dots are exact where B1's are: i8 x i8 in i32 (__dp4a; the TPU's B9 sums
// i8 in f32, equal while W <= 1024), bf16 and f32 in f32 FMAs in ascending
// order along the width (no TF32), so float distances equal B1's too.
//
// Bound on this card: the same [n_q, W] x [W, N] product as B1, so the
// tensor cores' rate bounds it (4.4e12 MACs at N = 2^20, W = 256,
// Q = 16384). This first version is a SIMT product on 256 threads: thread
// (tx, ty) owns rows ty + 16 i (i < 8) of the bin and queries tx + 16 j.
// Rows stay as they lie in memory, 16 words (64 bytes) of each at a time
// (a slab), with a pitch of 18 words, so 16 neighbouring queries read 16
// distinct bank pairs and a copy can fill a slab 8 bytes at a time.
// - B8: one block per 64 queries walks every bin; each slab is loaded,
//   synchronised and multiplied in turn (B1's schedule).
// - B9: the same block and product; slab s + 1 is in flight
//   (__pipeline_memcpy_async, i.e. cp.async) while slab s is multiplied, and
//   the bins' minima wait in shared memory for the merge.
// - B10: one block per 128 queries and 16 bins stages the queries' whole
//   rows once (rows of at most kMaxRowWords words; wider rows are staged
//   slab by slab beside the table's, as in B8), then streams its bins' slabs
//   and reduces each bin as soon as its product is done (the TPU's split_dot
//   schedule); the store of a bin's minima is coalesced along queries.
// Tensor cores (wgmma) and TMA are later work.
//
// Every entry point launches on the stream it is given, allocates nothing,
// and returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "scan_common.cuh"

namespace {

constexpr int kBin = 128;       // rows of one bin
constexpr int kThreads = 256;   // 16 x 16 threads
constexpr int kGroups = 16;     // row groups = query groups
constexpr int kTM = 8;          // rows per thread, strided by kGroups
constexpr int kSW = 16;         // 4-byte words of a row per slab
constexpr int kSP = kSW + 2;    // slab pitch in words
constexpr int kFusedQJ = 4;     // B8/B9: queries per thread (64 per block)
constexpr int kLanesQJ = 8;     // B10: queries per thread (128 per block)
constexpr int kLanesBins = 16;  // B10: bins per block
constexpr int kMaxRowWords = 384;  // B10: widest row, in words, whose queries are staged once
constexpr int kMaxK = 128;
constexpr int kMaxMerge = 64;

// Copies words [w0, w0 + kSW) of rows [0, n_rows) of `src` (row_words words
// a row) into `dst` (pitch kSP), 8 bytes a copy, asynchronously when kAsync;
// rows past `last` repeat row `last` (a ragged query tile).
template <bool kAsync>
__device__ __forceinline__ void copy_slab(uint32_t* dst, const uint32_t* __restrict__ src, int row_words,
                                          int n_rows, int last, int w0, int tid) {
  for (int e = tid; e < n_rows * (kSW / 2); e += kThreads) {
    const int r = e / (kSW / 2);
    const int c = (e % (kSW / 2)) * 2;
    const uint32_t* g = src + (size_t)min(r, last) * row_words + w0 + c;
    uint32_t* s = dst + r * kSP + c;
    if constexpr (kAsync) {
      __pipeline_memcpy_async(s, g, 8);
    } else {
      *reinterpret_cast<uint2*>(s) = __ldg(reinterpret_cast<const uint2*>(g));
    }
  }
}

// acc[i][j] += the dots of one slab: rows ty + 16 i of `a` (first row of
// this thread, pitch pa) with queries tx + 16 j of `b` (pitch pb), words in
// ascending order.
template <typename T, int QJ>
__device__ __forceinline__ void slab_mac(typename Acc<T>::type (&acc)[kTM][QJ], const uint32_t* a, int pa,
                                         const uint32_t* b, int pb) {
#pragma unroll
  for (int w = 0; w < kSW; w += 2) {
    uint2 av[kTM], bv[QJ];
#pragma unroll
    for (int i = 0; i < kTM; ++i) av[i] = *reinterpret_cast<const uint2*>(a + i * kGroups * pa + w);
#pragma unroll
    for (int j = 0; j < QJ; ++j) bv[j] = *reinterpret_cast<const uint2*>(b + j * kGroups * pb + w);
    if constexpr (std::is_same<T, int8_t>::value) {
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < QJ; ++j) {
          acc[i][j] = __dp4a(static_cast<int>(av[i].x), static_cast<int>(bv[j].x), acc[i][j]);
          acc[i][j] = __dp4a(static_cast<int>(av[i].y), static_cast<int>(bv[j].y), acc[i][j]);
        }
    } else if constexpr (std::is_same<T, float>::value) {
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < QJ; ++j) {
          acc[i][j] = __fmaf_rn(__uint_as_float(av[i].x), __uint_as_float(bv[j].x), acc[i][j]);
          acc[i][j] = __fmaf_rn(__uint_as_float(av[i].y), __uint_as_float(bv[j].y), acc[i][j]);
        }
    } else {
      // bf16: the low half of a word is the earlier element
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        float x[kTM], y[QJ];
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          const uint32_t word = h < 2 ? av[i].x : av[i].y;
          x[i] = h % 2 ? hi_bf16(word) : lo_bf16(word);
        }
#pragma unroll
        for (int j = 0; j < QJ; ++j) {
          const uint32_t word = h < 2 ? bv[j].x : bv[j].y;
          y[j] = h % 2 ? hi_bf16(word) : lo_bf16(word);
        }
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < QJ; ++j) acc[i][j] = __fmaf_rn(x[i], y[j], acc[i][j]);
      }
    }
  }
}

// The epilogue of this thread's dots and its part of the bin reduction:
// for each of its queries the minimum over its rows (ascending, strict '<')
// and that row within the bin, into red_v/red_i [kGroups][QT]; then zeroes
// the accumulators.
template <typename A, int QJ>
__device__ __forceinline__ void bin_epilogue(A (&acc)[kTM][QJ], const float (&qs)[QJ], int metric,
                                             const float* __restrict__ t_sq,
                                             const float* __restrict__ penalty, int row0, float* red_v,
                                             int* red_i, int tx, int ty) {
  constexpr int QT = kGroups * QJ;
  float ts[kTM], pen[kTM];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = row0 + ty + kGroups * i;
    pen[i] = __ldg(penalty + r);
    ts[i] = metric == kIP ? 0.0f : __ldg(t_sq + r);
  }
#pragma unroll
  for (int j = 0; j < QJ; ++j) {
    float best = __int_as_float(0x7f800000);  // +inf
    int arg = ty;
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const float d = epilogue(metric, false, to_float(acc[i][j]), qs[j], ts[i], pen[i]);
      if (d < best) {
        best = d;
        arg = ty + kGroups * i;
      }
      acc[i][j] = A(0);
    }
    red_v[ty * QT + tx + kGroups * j] = best;
    red_i[ty * QT + tx + kGroups * j] = arg;
  }
}

// Across the row groups: the minimum of query `c`, the lowest row on ties.
template <int QT>
__device__ __forceinline__ void bin_min(const float* red_v, const int* red_i, int c, float& best, int& arg) {
  best = red_v[c];
  arg = red_i[c];
#pragma unroll
  for (int s = 1; s < kGroups; ++s) {
    const float v = red_v[s * QT + c];
    const int r = red_i[s * QT + c];
    if (v < best || (v == best && r < arg)) {
      best = v;
      arg = r;
    }
  }
}

// Inserts candidates (in bin order) into one query's sorted list of k; an
// entry already there wins a tie. `thr` is the list's last value.
__device__ __forceinline__ void merge(float* list_d, int* list_i, int k, float& thr, const float* cand_v,
                                      const int* cand_i, int n, int stride) {
  for (int c = 0; c < n; ++c) {
    const float v = cand_v[c * stride];
    if (!(v < thr)) continue;
    int j = k - 1;
    while (j > 0 && list_d[j - 1] > v) {
      list_d[j] = list_d[j - 1];
      list_i[j] = list_i[j - 1];
      --j;
    }
    list_d[j] = v;
    list_i[j] = cand_i[c * stride];
    thr = list_d[k - 1];
  }
}

template <int QJ>
__device__ __forceinline__ void load_q_sq(float (&qs)[QJ], const float* __restrict__ q_sq, int metric, int q0,
                                          int q_rows, int tx) {
#pragma unroll
  for (int j = 0; j < QJ; ++j) {
    const int c = tx + kGroups * j;
    qs[j] = (metric != kIP && c < q_rows) ? __ldg(q_sq + q0 + c) : 0.0f;
  }
}

// B8 (kStream false: synchronous slabs, a merge after every bin) and B9
// (kStream true: a two-slot ring of asynchronous copies, a merge every
// merge_every bins). One block per kFusedQJ * 16 queries walks every bin.
template <typename T, bool kStream>
__global__ void __launch_bounds__(kThreads)
fused_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ table,
             const float* __restrict__ q_sq, const float* __restrict__ t_sq,
             const float* __restrict__ penalty, float* __restrict__ out_d, int* __restrict__ out_i,
             int n_q, int n_bins, int row_words, int metric, int k, int merge_every) {
  using A = typename Acc<T>::type;
  constexpr int QJ = kFusedQJ;
  constexpr int QT = kGroups * QJ;
  constexpr int kSlot = (kBin + QT) * kSP;  // words of one slot: the bin's rows, then the queries
  constexpr int kSlots = kStream ? 2 : 1;
  extern __shared__ __align__(16) uint32_t smem[];
  float* red_v = reinterpret_cast<float*>(smem + kSlots * kSlot);
  int* red_i = reinterpret_cast<int*>(red_v + kGroups * QT);
  float* cand_v = reinterpret_cast<float*>(red_i + kGroups * QT);  // [merge_every][QT]
  int* cand_i = reinterpret_cast<int*>(cand_v + merge_every * QT);

  const int tid = threadIdx.x;
  const int tx = tid % kGroups;
  const int ty = tid / kGroups;
  const int q0 = blockIdx.x * QT;
  const int q_rows = min(QT, n_q - q0);
  const uint32_t* q_base = q + (size_t)q0 * row_words;
  float* list_d = out_d + (size_t)(q0 + tid) * k;
  int* list_i = out_i + (size_t)(q0 + tid) * k;
  float thr = kMasked;
  if (tid < q_rows) {
    for (int j = 0; j < k; ++j) {
      list_d[j] = kMasked;
      list_i[j] = -1;
    }
  }
  float qs[QJ];
  load_q_sq(qs, q_sq, metric, q0, q_rows, tx);

  const int per_bin = row_words / kSW;
  const int n_slabs = n_bins * per_bin;
  auto fetch = [&](int s, uint32_t* slot) {
    const int bin = s / per_bin;
    const int w0 = (s % per_bin) * kSW;
    copy_slab<kStream>(slot, table + (size_t)bin * kBin * row_words, row_words, kBin, kBin - 1, w0, tid);
    copy_slab<kStream>(slot + kBin * kSP, q_base, row_words, QT, q_rows - 1, w0, tid);
  };

  A acc[kTM][QJ];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < QJ; ++j) acc[i][j] = A(0);

  if constexpr (kStream) {
    fetch(0, smem);
    __pipeline_commit();
  }
  int n_cand = 0;
  for (int s = 0; s < n_slabs; ++s) {
    uint32_t* slot = smem + (kStream ? (s & 1) * kSlot : 0);
    if constexpr (kStream) {
      if (s + 1 < n_slabs) fetch(s + 1, smem + ((s + 1) & 1) * kSlot);
      __pipeline_commit();
      __pipeline_wait_prior(1);  // slab s has landed; s + 1 may still be in flight
    } else {
      fetch(s, slot);
    }
    __syncthreads();
    slab_mac<T, QJ>(acc, slot + ty * kSP, kSP, slot + kBin * kSP + tx * kSP, kSP);
    __syncthreads();
    if ((s + 1) % per_bin) continue;

    const int bin = s / per_bin;
    bin_epilogue(acc, qs, metric, t_sq, penalty, bin * kBin, red_v, red_i, tx, ty);
    __syncthreads();
    if (tid < q_rows) {
      float best;
      int arg;
      bin_min<QT>(red_v, red_i, tid, best, arg);
      cand_v[n_cand * QT + tid] = best;
      cand_i[n_cand * QT + tid] = bin * kBin + arg;
    }
    if (++n_cand == merge_every || bin == n_bins - 1) {
      if (tid < q_rows) merge(list_d, list_i, k, thr, cand_v + tid, cand_i + tid, n_cand, QT);
      n_cand = 0;
    }
  }
  if (tid < q_rows) {
    for (int j = 0; j < k; ++j)
      if (list_d[j] >= kMasked / 2) list_i[j] = -1;
  }
}

// B10: one block per 128 queries and kLanesBins bins. The queries' rows are
// staged once (pitch row_words + 2, so 16 neighbouring queries read 16
// distinct bank pairs), or, for rows wider than kMaxRowWords, slab by slab
// with the table's; the bins' slabs stream past them, and each bin's minima
// and rows are written to [n_bins, n_q] as soon as its product is done.
template <typename T>
__global__ void __launch_bounds__(kThreads)
lanes_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ table,
             const float* __restrict__ q_sq, const float* __restrict__ t_sq,
             const float* __restrict__ penalty, float* __restrict__ out_v, int* __restrict__ out_i,
             int n_q, int n_bins, int row_words, int metric) {
  using A = typename Acc<T>::type;
  constexpr int QJ = kLanesQJ;
  constexpr int QT = kGroups * QJ;
  extern __shared__ __align__(16) uint32_t smem[];
  const bool once = row_words <= kMaxRowWords;
  const int pq = once ? row_words + 2 : kSP;
  uint32_t* q_s = smem;                // [QT][pq]
  uint32_t* t_s = q_s + QT * pq;       // [kBin][kSP]
  float* red_v = reinterpret_cast<float*>(t_s + kBin * kSP);
  int* red_i = reinterpret_cast<int*>(red_v + kGroups * QT);

  const int tid = threadIdx.x;
  const int tx = tid % kGroups;
  const int ty = tid / kGroups;
  const int q0 = blockIdx.y * QT;
  const int q_rows = min(QT, n_q - q0);
  const int bin0 = blockIdx.x * kLanesBins;
  const int bin1 = min(bin0 + kLanesBins, n_bins);
  const uint32_t* q_base = q + (size_t)q0 * row_words;
  for (int e = tid; once && e < QT * (row_words / 2); e += kThreads) {
    const int r = e / (row_words / 2);
    const int c = (e % (row_words / 2)) * 2;
    *reinterpret_cast<uint2*>(q_s + r * pq + c) =
        __ldg(reinterpret_cast<const uint2*>(q_base + (size_t)min(r, q_rows - 1) * row_words + c));
  }
  float qs[QJ];
  load_q_sq(qs, q_sq, metric, q0, q_rows, tx);

  A acc[kTM][QJ];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < QJ; ++j) acc[i][j] = A(0);

  for (int bin = bin0; bin < bin1; ++bin) {
    const uint32_t* t_base = table + (size_t)bin * kBin * row_words;
    for (int w0 = 0; w0 < row_words; w0 += kSW) {
      copy_slab<false>(t_s, t_base, row_words, kBin, kBin - 1, w0, tid);
      if (!once) copy_slab<false>(q_s, q_base, row_words, QT, q_rows - 1, w0, tid);
      __syncthreads();
      slab_mac<T, QJ>(acc, t_s + ty * kSP, kSP, q_s + tx * pq + (once ? w0 : 0), pq);
      __syncthreads();
    }
    bin_epilogue(acc, qs, metric, t_sq, penalty, bin * kBin, red_v, red_i, tx, ty);
    __syncthreads();
    if (tid < q_rows) {
      float best;
      int arg;
      bin_min<QT>(red_v, red_i, tid, best, arg);
      out_v[(size_t)bin * n_q + q0 + tid] = best;
      out_i[(size_t)bin * n_q + q0 + tid] = bin * kBin + arg;
    }
  }
}

int elem_bytes(int dtype) { return dtype == kI8 ? 1 : dtype == kBF16 ? 2 : dtype == kF32 ? 4 : 0; }

bool valid_shape(int n_q, int n_rows, int width, int dtype, int metric) {
  return n_q > 0 && n_rows > 0 && n_rows % kBin == 0 && metric >= kIP && metric <= kL2sq &&
         elem_bytes(dtype) > 0 && width > 0 && (width * elem_bytes(dtype)) % (4 * kSW) == 0;
}

template <typename T, bool kStream>
int launch_fused(const void* q, const void* table, const float* q_sq, const float* t_sq, const float* penalty,
                 float* out_d, int* out_i, int n_q, int n_bins, int row_words, int metric, int k,
                 int merge_every, cudaStream_t s) {
  constexpr int QT = kGroups * kFusedQJ;
  const size_t smem = 4 * ((kStream ? 2 : 1) * (kBin + QT) * kSP + 2 * kGroups * QT + 2 * merge_every * QT);
  auto kern = fused_kernel<T, kStream>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  kern<<<(n_q + QT - 1) / QT, kThreads, smem, s>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(table), q_sq, t_sq, penalty, out_d, out_i,
      n_q, n_bins, row_words, metric, k, merge_every);
  return static_cast<int>(cudaGetLastError());
}

template <bool kStream>
int fused(const void* q, const void* table, const float* q_sq, const float* t_sq, const float* penalty,
          float* out_d, int* out_i, int n_q, int n_rows, int width, int dtype, int metric, int k,
          int merge_every, void* stream) {
  if (!valid_shape(n_q, n_rows, width, dtype, metric) || k < 1 || k > kMaxK || merge_every < 1 ||
      merge_every > kMaxMerge)
    return cudaErrorInvalidValue;
  const int row_words = width * elem_bytes(dtype) / 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_bins = n_rows / kBin;
  switch (dtype) {
    case kI8:
      return launch_fused<int8_t, kStream>(q, table, q_sq, t_sq, penalty, out_d, out_i, n_q, n_bins, row_words,
                                           metric, k, merge_every, s);
    case kBF16:
      return launch_fused<__nv_bfloat16, kStream>(q, table, q_sq, t_sq, penalty, out_d, out_i, n_q, n_bins,
                                                  row_words, metric, k, merge_every, s);
    default:
      return launch_fused<float, kStream>(q, table, q_sq, t_sq, penalty, out_d, out_i, n_q, n_bins, row_words,
                                          metric, k, merge_every, s);
  }
}

template <typename T>
int launch_lanes(const void* q, const void* table, const float* q_sq, const float* t_sq, const float* penalty,
                 float* out_v, int* out_i, int n_q, int n_bins, int row_words, int metric, cudaStream_t s) {
  constexpr int QT = kGroups * kLanesQJ;
  const size_t smem = 4 * (QT * (row_words <= kMaxRowWords ? row_words + 2 : kSP) + kBin * kSP + 2 * kGroups * QT);
  auto kern = lanes_kernel<T>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  const dim3 grid((n_bins + kLanesBins - 1) / kLanesBins, (n_q + QT - 1) / QT);
  kern<<<grid, kThreads, smem, s>>>(static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(table), q_sq,
                                    t_sq, penalty, out_v, out_i, n_q, n_bins, row_words, metric);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// B8. out_d/out_i are [n_q, k], 1 <= k <= 128.
int usearch_fused_topk(const void* q, const void* table, const float* q_sq, const float* t_sq,
                       const float* penalty, float* out_d, int* out_i, int n_q, int n_rows, int width,
                       int dtype, int metric, int k, void* stream) {
  return fused<false>(q, table, q_sq, t_sq, penalty, out_d, out_i, n_q, n_rows, width, dtype, metric, k, 1,
                      stream);
}

// B9. As B8; 1 <= merge_every <= 64 bins between merges.
int usearch_fused_topk_stream(const void* q, const void* table, const float* q_sq, const float* t_sq,
                              const float* penalty, float* out_d, int* out_i, int n_q, int n_rows, int width,
                              int dtype, int metric, int k, int merge_every, void* stream) {
  return fused<true>(q, table, q_sq, t_sq, penalty, out_d, out_i, n_q, n_rows, width, dtype, metric, k,
                     merge_every, stream);
}

// B10. out_v/out_i are [n_rows / 128, n_q].
int usearch_binned_scan_lanes(const void* q, const void* table, const float* q_sq, const float* t_sq,
                              const float* penalty, float* out_v, int* out_i, int n_q, int n_rows, int width,
                              int dtype, int metric, void* stream) {
  if (!valid_shape(n_q, n_rows, width, dtype, metric)) return cudaErrorInvalidValue;
  const int row_words = width * elem_bytes(dtype) / 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_bins = n_rows / kBin;
  switch (dtype) {
    case kI8:
      return launch_lanes<int8_t>(q, table, q_sq, t_sq, penalty, out_v, out_i, n_q, n_bins, row_words, metric, s);
    case kBF16:
      return launch_lanes<__nv_bfloat16>(q, table, q_sq, t_sq, penalty, out_v, out_i, n_q, n_bins, row_words,
                                         metric, s);
    default:
      return launch_lanes<float>(q, table, q_sq, t_sq, penalty, out_v, out_i, n_q, n_bins, row_words, metric, s);
  }
}

}  // extern "C"
