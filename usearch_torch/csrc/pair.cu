// Per-query IVF probe kernel of usearch_torch, for Hopper (sm_90a).
//
// B6 `usearch_pair_probe` replaces the TPU kernel `_make_probe_kernel`
// (usearch_tpu/ops/pallas_probe.py:144), which `pallas_ivf_probe` (:948)
// launches for the `pair` flavour of the dense IVF probe. Query q probes
// nprobe windows, in the coarse selection's order; window j is the padded
// window of w_pad rows from the 128-aligned start starts[q, j], with its
// rows [start + offs, start + offs + lens) in play. For each window the
// kernel
//   1. scores every row in play in the rank form of `_window_dists` (ip
//      1 - dot, cos -dot/|t|, l2sq and hamming |t|^2 - 2 dot) plus the
//      deleted-row penalty when one is given; other rows are MASKED;
//   2. takes the bin_m smallest of each 128-row bin of the padded window
//      (bins counted from its start), the lower row first on ties: the
//      rounds of min/argmin of the TPU kernel, round j being a row's rank
//      in its bin;
//   3. folds them into the query's running top-k, which the TPU kernel
//      does by k min-extractions over [acc; round 0 of every bin; round 1;
//      ...], so on equal distances the older entry wins, then the lower
//      round, then the lower bin. Over all windows the order is (distance,
//      window, round, bin), and it is part of the result.
// After the last window `_rank_epilogue` maps the k entries back to the
// metric's distances; empty places are MASKED with id -1. dtypes: i8
// (__dp4a into int32, exact), bf16 and f32 (f32 FMAs, no TF32), and packed
// b1 rows with hamming (__popc of ANDed 32-bit words).
//
// Bound on this card. Nothing is shared between queries: each streams its
// own windows, Q x nprobe x w_pad rows of W bytes, where the grouped probe
// (B3) reads each window once per cell that probes it. The least the card
// needs is the rows the windows touch, read once, and 2 W operations per
// row in play per query: at bench.py's IVF shape (1M x 256 i8 rows, 16,384
// queries, nprobe 19, w_pad 1,280) ~0.1 ms, while the windows streamed are
// ~100 GB, tens of milliseconds at the memory rate (L2 serves part of it).
//
// Design, a simple one that is right first. One block of 128 threads per
// query. Per window, per 128-row bin that holds a row in play, the block
// streams the bin's rows through shared memory 128 bytes of the width at a
// time (coalesced 16-byte loads), and thread t scores row t against the
// query row, kept in shared memory. The bin's 128 scores go to shared
// memory; a thread whose score can still enter the top-k ranks it against
// the other 127 by (distance, row): the rank is its extraction round, and
// rows of rank < bin_m join the window's candidate list. After the window,
// each candidate and each accumulator entry computes its place in the
// merged order by counting (binary search over the sorted accumulator, a
// count over the candidates), and the k first are written to the other
// half of a double-buffered accumulator. No atomics decide an order: the
// places are a permutation fixed by the keys.
//
// The dot products, the rank-form distances and the staging loop are
// csrc/probe_common.cuh's, shared with B3, B5 and B7 (csrc/probe.cu). The
// entry point launches on the stream it is given, allocates nothing, and
// returns cudaGetLastError() after the launch.

#include "probe_common.cuh"

namespace {

constexpr int kThreads = 128;  // threads per block = rows per bin
constexpr int kMaxK = 128;

struct Params {
  const void* q;          // [Q, W]
  const float* q_sq;      // [Q]
  const void* table;      // [n_rows, W]
  const float* t_sq;      // [n_rows] or null (ip)
  const float* penalty;   // [n_rows] or null (every row live)
  const int* starts;      // [Q, nprobe] 128-aligned padded-window starts
  const int* offs;        // [Q, nprobe] window offsets inside them
  const int* lens;        // [Q, nprobe] window lengths
  float* out_d;           // [Q, k]
  int* out_i;
  int n_rows, width, metric, nprobe, w_pad, k, bin_m;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) pair_probe_kernel(const Params p) {
  using A = typename Acc<T>::type;
  extern __shared__ __align__(16) uint32_t smem[];
  const int row_words = p.width * static_cast<int>(sizeof(T)) / 4;
  const int nb_w = p.w_pad / kBin;
  uint32_t* q_s = smem;                                          // [row_words]
  uint32_t* t_s = q_s + row_words;                               // [kBin][kStride]
  float* bin_s = reinterpret_cast<float*>(t_s + kBin * kStride);  // [kBin]
  float* acc_d = bin_s + kBin;                                   // [2][kMaxK]
  int* acc_i = reinterpret_cast<int*>(acc_d + 2 * kMaxK);        // [2][kMaxK]
  int* n_cand = acc_i + 2 * kMaxK;                               // [4]
  float* cand_d = reinterpret_cast<float*>(n_cand + 4);          // [w_pad]
  int* cand_r = reinterpret_cast<int*>(cand_d + p.w_pad);        // [w_pad] rows
  int* cand_o = cand_r + p.w_pad;                                // [w_pad] round * nb_w + bin

  const int tid = threadIdx.x;
  const size_t query = blockIdx.x;
  const float qs = p.q_sq[query];
  const uint4* q_src = reinterpret_cast<const uint4*>(static_cast<const uint32_t*>(p.q) + query * row_words);
  for (int e = tid; e < row_words / 4; e += kThreads) reinterpret_cast<uint4*>(q_s)[e] = __ldg(q_src + e);
  if (tid == 0) *n_cand = 0;
  __syncthreads();

  const uint32_t* t_src = static_cast<const uint32_t*>(p.table);
  int cnt = 0;  // entries of the accumulator, the same in every thread
  int cur = 0;  // its live half
  for (int w = 0; w < p.nprobe; ++w) {
    const size_t pw = query * p.nprobe + w;
    const int st = p.starts[pw], off = p.offs[pw], ln = p.lens[pw];
    if (ln <= 0 || st < 0 || st % kBin || st > p.n_rows - p.w_pad || off < 0 || off > p.w_pad - ln) continue;
    const int lo = st + off, hi = lo + ln;
    // a score at or past the k-th entry cannot enter: the older entry wins
    const float thr = cnt == p.k ? acc_d[cur * kMaxK + p.k - 1] : kMasked * 0.5f;
    for (int b = 0; b < nb_w; ++b) {
      const int row0 = st + b * kBin;
      if (row0 + kBin <= lo || row0 >= hi) continue;
      A acc = A(0);
#pragma unroll 1
      for (int w0 = 0; w0 < row_words; w0 += kWords) {
        __syncthreads();  // the previous stage (and bin) is consumed
        stage(t_s, t_src, row0, 0, kBin, row_words, w0, tid, kThreads);
        __syncthreads();
        const uint4* trow = reinterpret_cast<const uint4*>(t_s + tid * kStride);
        const uint4* qrow = reinterpret_cast<const uint4*>(q_s + w0);
#pragma unroll
        for (int c = 0; c < kWords / 4; ++c) mac4(acc, trow[c], qrow[c], T());
      }
      const int row = row0 + tid;
      float d = kMasked;
      if (row >= lo && row < hi) {
        const float ts = p.metric != kIP ? p.t_sq[row] : 0.0f;
        const float pen = p.penalty != nullptr ? p.penalty[row] : 0.0f;
        d = window_dist(p.metric, to_float(acc), qs, ts, p.penalty != nullptr, pen);
      }
      bin_s[tid] = d;
      __syncthreads();
      if (d < thr) {
        // the extraction round of this row: its rank by (distance, row)
        int rank = 0;
#pragma unroll 4
        for (int j = 0; j < kBin; ++j) {
          const float o = bin_s[j];
          rank += (o < d) || (o == d && j < tid);
        }
        if (rank < p.bin_m) {
          const int c = atomicAdd(n_cand, 1);
          cand_d[c] = d;
          cand_r[c] = row;
          cand_o[c] = rank * nb_w + b;
        }
      }
    }
    __syncthreads();  // the window's candidates are written
    const int n = *n_cand;
    if (n == 0) continue;
    const float* a_d = acc_d + cur * kMaxK;
    const int* a_i = acc_i + cur * kMaxK;
    float* b_d = acc_d + (cur ^ 1) * kMaxK;
    int* b_i = acc_i + (cur ^ 1) * kMaxK;
    for (int c = tid; c < n; c += kThreads) {
      const float v = cand_d[c];
      const int o = cand_o[c];
      int l = 0, h = cnt;  // accumulator entries at or below v come first
      while (l < h) {
        const int mid = (l + h) >> 1;
        if (a_d[mid] <= v) l = mid + 1; else h = mid;
      }
      int place = l;
      for (int j = 0; j < n && place < p.k; ++j) {
        const float u = cand_d[j];
        place += (u < v) || (u == v && cand_o[j] < o);
      }
      if (place < p.k) {
        b_d[place] = v;
        b_i[place] = cand_r[c];
      }
    }
    for (int i = tid; i < cnt; i += kThreads) {
      const float v = a_d[i];
      int place = i;
      for (int j = 0; j < n && place < p.k; ++j) place += cand_d[j] < v;
      if (place < p.k) {
        b_d[place] = v;
        b_i[place] = a_i[i];
      }
    }
    cnt = min(p.k, cnt + n);
    cur ^= 1;
    __syncthreads();  // the new accumulator is written, the counter read
    if (tid == 0) *n_cand = 0;
    __syncthreads();
  }

  if (tid < p.k) {
    float d = kMasked;
    int id = -1;
    if (tid < cnt) {
      d = rank_epilogue(p.metric, acc_d[cur * kMaxK + tid], qs);
      id = d >= kMasked * 0.5f ? -1 : acc_i[cur * kMaxK + tid];
    }
    p.out_d[query * p.k + tid] = d;
    p.out_i[query * p.k + tid] = id;
  }
}

size_t smem_bytes(int row_words, int w_pad) {
  return sizeof(uint32_t) * (row_words + kBin * kStride) + sizeof(float) * kBin +
         (sizeof(float) + sizeof(int)) * 2 * kMaxK + sizeof(int) * 4 +
         (sizeof(float) + 2 * sizeof(int)) * static_cast<size_t>(w_pad);
}

template <typename T>
int launch_typed(const Params& p, int n_q, cudaStream_t stream) {
  auto kernel = pair_probe_kernel<T>;
  const size_t smem = smem_bytes(p.width * static_cast<int>(sizeof(T)) / 4, p.w_pad);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_q, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// B6 (B4's product for b1 rows with hamming). t_sq may be null for ip;
// penalty null means every row is live. bin_m is at most k.
int usearch_pair_probe(const void* q, const float* q_sq, const void* table, const float* t_sq,
                       const float* penalty, const int* starts, const int* offs, const int* lens, float* out_d,
                       int* out_i, int n_q, int n_rows, int width, int dtype, int metric, int nprobe, int w_pad,
                       int k, int bin_m, void* stream) {
  // hamming goes with packed b1 rows and they with it
  if (n_q <= 0 || n_rows % kBin || width % 128 || nprobe < 1 || w_pad <= 0 || w_pad % kBin ||
      w_pad > n_rows || k < 1 || k > kMaxK || bin_m < 1 || bin_m > k || metric < kIP || metric > kHamming ||
      (metric == kHamming) != (dtype == kB1) || (metric != kIP && t_sq == nullptr))
    return cudaErrorInvalidValue;
  const Params p{q, q_sq, table, t_sq, penalty, starts, offs, lens, out_d, out_i,
                 n_rows, width, metric, nprobe, w_pad, k, bin_m};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kI8:
      return launch_typed<int8_t>(p, n_q, s);
    case kBF16:
      return launch_typed<__nv_bfloat16>(p, n_q, s);
    case kF32:
      return launch_typed<float>(p, n_q, s);
    case kB1:
      return launch_typed<uint8_t>(p, n_q, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
