// The fold of the per-query IVF probe of usearch_torch, for Hopper (sm_90a).
//
// B6 (`ops/probe.pair_probe`) replaces the TPU kernel `_make_probe_kernel`
// (usearch_tpu/ops/pallas_probe.py:144), which `pallas_ivf_probe` (:948)
// launches for the `pair` flavour of the dense IVF probe. Query q probes
// nprobe windows, in the coarse selection's order; window j is the padded
// window of w_pad rows from the 128-aligned start starts[q, j], with its
// rows [start + offs, start + offs + lens) in play. The TPU kernel scores
// each window's rows in rank form, takes the bin_m smallest of each 128-row
// bin (round j being a row's rank in its bin), and folds them into the
// query's running top-k, so equal distances keep the order (distance,
// window, round, bin); `_rank_epilogue` then maps the k entries back to the
// metric's distances, MASKED with id -1 where nothing was found.
//
// Restricted to one window that order is (distance, round, bin), the order
// of the grouped probe's per-pair list (csrc/probe.cu, B3), and a window
// gives at most k entries of the result. So B6 runs in three steps on the
// card: the (query, window) pairs sorted by window into cells of 128 (torch,
// ops/probe.py `pair_cells`); B3's tensor-core kernel over them, each pair's
// first k in rank form (csrc/probe.cu `usearch_pair_lists`); and this fold:
// per query the k best of its nprobe lists, read in window order through the
// inverse permutation, by (rank value, window, place in the list), then the
// epilogue.
//
// Design: one warp a query. Lane l holds windows l, l + 32, ... and offers
// the head of the best of them by (value, window); a butterfly of shuffles
// gives the warp's best, whose lane writes it, moves that window's head on
// and offers its next best. Each list is sorted, so the heads give the order
// in k steps. The heads' places sit in shared memory, a warp's nprobe ints.
//
// Bound: the lists it reads, nprobe x k x 8 bytes a query, and the [Q, k]
// result; a few microseconds at bench.py's IVF shape, beside the lists'
// kernel. The entry point launches on the stream it is given, allocates
// nothing, and returns cudaGetLastError() after the launch.

#include <limits.h>

#include "probe_common.cuh"

namespace {

constexpr int kFoldThreads = 128;  // four queries a block
constexpr int kMaxK = 128;

struct FoldParams {
  const float* lists_d;  // [P, k] rank form, MASKED past a list's end
  const int* lists_i;    // [P, k]
  const int* inv;        // [Q, nprobe] the pair of each (query, window)
  const float* q_sq;     // [Q]
  float* out_d;          // [Q, k]
  int* out_i;
  int n_q, nprobe, k, metric;
};

// The best head of this lane's windows, by (value, window); +inf past the
// ends of all of them.
__device__ __forceinline__ void lane_best(const FoldParams& p, const int* inv, const int* head, int l, float& v,
                                          int& w) {
  v = __int_as_float(0x7f800000);
  w = INT_MAX;
  for (int j = l; j < p.nprobe; j += 32) {
    if (head[j] >= p.k) continue;
    const float x = p.lists_d[static_cast<size_t>(inv[j]) * p.k + head[j]];
    if (x < kMasked * 0.5f && x < v) {
      v = x;
      w = j;
    }
  }
}

__global__ void __launch_bounds__(kFoldThreads) pair_fold(const FoldParams p) {
  extern __shared__ int heads[];  // [warps][nprobe]
  const int warp = threadIdx.x / 32, l = threadIdx.x % 32;
  const int query = blockIdx.x * (kFoldThreads / 32) + warp;
  if (query >= p.n_q) return;
  int* head = heads + warp * p.nprobe;
  const int* inv = p.inv + static_cast<size_t>(query) * p.nprobe;
  for (int j = l; j < p.nprobe; j += 32) head[j] = 0;
  __syncwarp();
  const float qs = p.q_sq[query];
  const size_t out0 = static_cast<size_t>(query) * p.k;
  float v;
  int w;
  lane_best(p, inv, head, l, v, w);
  int s = 0;
  for (; s < p.k; ++s) {
    float bv = v;
    int bw = w;
#pragma unroll
    for (int m = 16; m > 0; m /= 2) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, m);
      const int ow = __shfl_xor_sync(0xffffffffu, bw, m);
      if (ov < bv || (ov == bv && ow < bw)) {
        bv = ov;
        bw = ow;
      }
    }
    if (bw == INT_MAX) break;  // every list is at its end
    if (bw % 32 == l) {
      const size_t at = static_cast<size_t>(inv[bw]) * p.k + head[bw];
      const float d = rank_epilogue(p.metric, bv, qs);
      p.out_d[out0 + s] = d;
      p.out_i[out0 + s] = d >= kMasked * 0.5f ? -1 : p.lists_i[at];
      ++head[bw];
      lane_best(p, inv, head, l, v, w);
    }
  }
  for (int e = s + l; e < p.k; e += 32) {
    p.out_d[out0 + e] = kMasked;
    p.out_i[out0 + e] = -1;
  }
}

}  // namespace

extern "C" {

// B6's fold: lists_d/lists_i are [n_pairs, k] (csrc/probe.cu
// `usearch_pair_lists`), inv [n_q, nprobe] the pair of each (query,
// window); out_d/out_i [n_q, k].
int usearch_pair_fold(const float* lists_d, const int* lists_i, const int* inv, const float* q_sq, float* out_d,
                      int* out_i, int n_q, int nprobe, int k, int metric, void* stream) {
  const size_t smem = sizeof(int) * static_cast<size_t>(nprobe) * (kFoldThreads / 32);
  if (n_q <= 0 || nprobe < 1 || k < 1 || k > kMaxK || metric < kIP || metric > kHamming || smem > 232448)
    return cudaErrorInvalidValue;
  const FoldParams p{lists_d, lists_i, inv, q_sq, out_d, out_i, n_q, nprobe, k, metric};
  const cudaError_t err =
      cudaFuncSetAttribute(pair_fold, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n_q + kFoldThreads / 32 - 1) / (kFoldThreads / 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  pair_fold<<<blocks, kFoldThreads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
