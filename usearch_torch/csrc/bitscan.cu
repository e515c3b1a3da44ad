// The exact scan over packed b1 rows of usearch_torch, for Hopper (sm_90a).
//
// `usearch_bit_scan` replaces no Pallas kernel: no Pallas scan kernel takes
// b1 rows (usearch_tpu/ops/pallas_scan.py `supports`), so the JAX package
// scans them with XLA, `exact._search_kernel_xla` (usearch_tpu/exact.py:167)
// through `ops/topk.scan_topk` (usearch_tpu/ops/topk.py:86): a `lax.scan`
// over row tiles whose product is `packbits.bit_dot`
// (usearch_tpu/ops/packbits.py:46), eight byte-plane i8 products, and whose
// merge is `lax.top_k` over [running k, tile]. Here one kernel does the
// and-counts, the hamming/tanimoto/sorensen epilogue and an exact running
// top-k, and no distance reaches memory:
//
//   out[i] = the k smallest (distance(q[i], table[r]), r) over live rows r,
//            ascending, ties to the lower row (what `lax.top_k` gives over
//            rows met in ascending order); (MASKED, -1) past the live rows.
//
// Distances come from the popcounts pq, pt and the and-count a in f32, in
// `ops/distances.binary_dists`' order: hamming (pq + pt) - 2a; tanimoto
// 1 - a / ((pq + pt) - a); sorensen 1 - 2a / (pq + pt); an empty union or
// sum gives 0. `round_bf16` rounds each distance to bf16 (to nearest even)
// before it is ranked and returned, where the JAX scan ranks its tiles in
// bf16 (approximate searches past its tile size).
//
// Bound on this card: operations. 2 Q N 8W bit operations at the b1 rate of
// the tensor cores (8 x 1,979e12 a second: the and-popc product issues at
// the s8 rate with 8 bits a byte) against N W + Q W bytes: 0.56 ms at Q =
// 4,096, N = 2^20, W = 128 bytes, where the packed table is 128 MiB (0.04 ms
// of reading).
//
// Design. The product runs on the tensor cores straight from the packed
// bytes: `wgmma` m64n128k256 b1 `.and.popc` (csrc/wgmma_common.cuh
// `mma_popc`, BGMMA in the SASS), both operands K-major from 128-byte-swizzled
// TMA boxes, so nothing is unpacked. A block of two warpgroups owns 128
// queries, 64 each (the M side), held in shared memory for the whole block
// when their rows are at most 512 bytes and streamed K-block by K-block with
// the table's otherwise; the table streams through one ring of 128-row tiles
// (16 KB a K-block) that both warpgroups read, B8's ring (csrc/fused.cu):
// thread 0 fills the first slots, then whichever warpgroup is the second to
// release a slot refills it. Each tile's row popcounts (-1 for a dead row)
// go to a per-warpgroup double buffer, loaded a tile ahead.
//
// Selection is where the time goes once the product is on the tensor cores:
// every (query, row) pair is a candidate, Q N of them, where B8 takes one a
// bin. So each thread first tests its 64 pairs (2 queries x 32 rows) against
// a bound read off the query's k-th (distance, row), in integer or FMA
// operations and no division: hamming pq + pt - 2a <= T, tanimoto and
// sorensen a - c u >= 0 and 2a - c s >= 0 with c = 1 - T - 2^-20, which no
// pair whose rounded distance reaches T fails (T: the k-th distance, or the
// bf16 value two steps above it when rounding). Only the pairs that pass
// (about k ln(N / k) a query on random data, nearly none after the first
// tiles) take the exact epilogue (one __fdiv_rn) and the comparison on
// (distance, row). The four threads of a query pass its list between them
// in turn, one warp-synchronous round each, and share the new k-th entry by
// shuffles. Lists of k <= 16 live in shared memory, longer ones in the
// output rows (as B8's).
//
// The table's rows split across blockIdx.y so that small batches fill the
// card: each split writes its sorted partial lists, and `bit_scan_merge`
// (one thread a query) merges them, in the same launch call.
//
// Every entry point launches on the stream it is given, allocates nothing,
// and returns cudaGetLastError() after its launches.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "scan_common.cuh"
#include "wgmma_common.cuh"

namespace {

// ops/bitscan.py METRIC_CODES: hamming is scan_common.cuh's kHamming
constexpr int kTanimoto = 4;
constexpr int kSorensen = 5;

constexpr int kBitRows = 128;              // table rows of one tile: the N of m64n128k256
constexpr int kBQ = 2 * kQT;               // queries of a block: 64 a warpgroup
constexpr int kRStage = kBitRows * kKB;    // 16 KB: a table K-block
constexpr int kResidentKB = 4;             // K-blocks of the queries kept for the block
constexpr int kMaxStages = 8;              // slots of the ring
constexpr int kSmemK = 16;                 // lists of at most this many entries live in shared memory
constexpr int kMaxK = 128;
constexpr int kMaxWidth = 1 << 17;         // bytes a row: popcounts below 2^21, exact in f32 by `exact_float`
constexpr int kNoRow = INT_MAX;            // the row of an empty list entry
constexpr int kMergeThreads = 128;

// Shared memory of a block: the resident queries (or none), the ring of
// `stages` slots (a table K-block, then the two query K-blocks when the
// queries stream), a double buffer of the tile's row popcounts per
// warpgroup, the lists when k <= kSmemK ([kSmemK][128] values, then rows),
// and the barriers: a full barrier per slot and one for the queries, then a
// counter per slot. Every buffer starts on 1 KB.
struct BitLayout {
  int n_kb, stages, stage_bytes, ring_off, pop_off, list_off, bar_off, bytes;
  bool resident;
};

__host__ __device__ __forceinline__ BitLayout bit_layout(int n_kb, int k) {
  BitLayout L;
  L.n_kb = n_kb;
  L.resident = n_kb <= kResidentKB;
  L.stage_bytes = kRStage + (L.resident ? 0 : 2 * kQStage);
  L.ring_off = L.resident ? 2 * n_kb * kQStage : 0;
  const int pop_bytes = 2 * 2 * kBitRows * 4;
  const int list_bytes = k <= kSmemK ? kBQ * kSmemK * 8 : 0;
  const int room = kSmem - 1024 - 256 - pop_bytes - list_bytes - L.ring_off;
  const int slots = room / L.stage_bytes;
  L.stages = slots < kMaxStages ? slots : kMaxStages;
  L.pop_off = L.ring_off + L.stages * L.stage_bytes;
  L.list_off = L.pop_off + pop_bytes;
  L.bar_off = L.list_off + list_bytes;
  L.bytes = L.bar_off + 256 + 1024;
  return L;
}

// Fills ring slot n % stages with step n of the block's walk: K-block
// n % n_kb of tile n / n_kb (from row r0), and the block's two query
// K-blocks when the queries stream. One thread issues it.
__device__ __forceinline__ void bit_fill(const BitLayout& L, uint8_t* ring, uint64_t* full, const CUtensorMap* q_map,
                                         const CUtensorMap* t_map, int n, int q0, int r0) {
  const int slot = n % L.stages;
  const int kb = n % L.n_kb;
  uint8_t* buf = ring + slot * L.stage_bytes;
  mbar_expect_tx(full + slot, L.stage_bytes);
  tma_load(buf, t_map, kb * kKB, r0 + n / L.n_kb * kBitRows, full + slot);
  if (!L.resident)
    for (int h = 0; h < 2; ++h) tma_load(buf + kRStage + h * kQStage, q_map, kb * kKB, q0 + kQT * h, full + slot);
}

// One warpgroup is done with step n's slot: the second of the two to say so
// refills it with step n + stages.
__device__ __forceinline__ void bit_release(const BitLayout& L, uint8_t* ring, uint64_t* full, uint32_t* taken,
                                            const CUtensorMap* q_map, const CUtensorMap* t_map, int n, int steps,
                                            int q0, int r0, int t) {
  if (t != 0) return;
  __threadfence_block();
  const uint32_t old = atomicAdd(taken + n % L.stages, 1u);
  __threadfence_block();
  if (old % 2 == 1 && n + L.stages < steps) bit_fill(L, ring, full, q_map, t_map, n + L.stages, q0, r0);
}

// An integer below 2^22 as f32, exactly, in two full-rate operations.
__device__ __forceinline__ float exact_float(int x) { return __fsub_rn(__int_as_float(x + 0x4B400000), 12582912.0f); }

// The distance of and-count a between rows of popcounts pq and pt, in
// `binary_dists`' f32 operations; rounded to bf16 when `round_bf16`.
template <int kMetric>
__device__ __forceinline__ float bit_distance(int a, int pq, int pt, bool round_bf16) {
  const float af = exact_float(a), sum = __fadd_rn(exact_float(pq), exact_float(pt));
  float d;
  if constexpr (kMetric == kHamming) {
    d = __fsub_rn(sum, __fmul_rn(2.0f, af));
  } else if constexpr (kMetric == kTanimoto) {
    const float u = __fsub_rn(sum, af);
    d = u == 0.0f ? 0.0f : __fsub_rn(1.0f, __fdiv_rn(af, u));
  } else {
    d = sum == 0.0f ? 0.0f : __fsub_rn(1.0f, __fdiv_rn(__fmul_rn(2.0f, af), sum));
  }
  return round_bf16 ? __bfloat162float(__float2bfloat16_rn(d)) : d;
}

// A value at or above every distance whose (rounded) value does not pass
// the k-th distance `thr` (>= 0): thr itself, or with rounding the bf16
// value two steps above it (a distance past that rounds past thr).
__device__ __forceinline__ float pass_bound(float thr, bool round_bf16) {
  if (!round_bf16) return thr;
  const uint32_t up = (__float_as_uint(thr) + 0xffffu) & 0xffff0000u;
  return __uint_as_float(up + 0x10000u);
}

// The prefilter's constant of a query from its k-th distance: hamming the
// largest pt - 2a that may pass (pq + pt - 2a <= bound), tanimoto and
// sorensen c = 1 - bound - 2^-20 as bits. Every pair that can enter the
// list passes (the file's note).
template <int kMetric>
__device__ __forceinline__ int pass_limit(float thr, int pq, bool round_bf16) {
  const float b = pass_bound(thr, round_bf16);
  if constexpr (kMetric == kHamming) return static_cast<int>(fminf(b, 1073741824.0f)) - pq;
  return __float_as_int(__fsub_rn(1.0f, __fadd_rn(b, 0x1p-20f)));
}

// Whether the pair (and-count a, row popcount pt) of a query with
// popcount pq and limit `lim` may enter its list.
template <int kMetric>
__device__ __forceinline__ bool may_pass(int a, int pt, int pq, int lim) {
  if constexpr (kMetric == kHamming) {
    return pt - 2 * a <= lim;
  } else {
    const float c = __int_as_float(lim);
    const float af = exact_float(a);
    if constexpr (kMetric == kTanimoto) return __fmaf_rn(-c, exact_float(pq + pt - a), af) >= 0.0f;
    return __fmaf_rn(-c, exact_float(pq + pt), __fmul_rn(2.0f, af)) >= 0.0f;
  }
}

// (v, r) before (d, s) in the lists' order.
__device__ __forceinline__ bool before(float v, int r, float d, int s) { return v < d || (v == d && r < s); }

// Inserts (v, r), which comes before the list's last entry, into a sorted
// list of k (entry j at j * ls).
__device__ __noinline__ void insert_pair(float* list_d, int* list_i, int k, int ls, float v, int r) {
  int j = k - 1;
  while (j > 0) {
    const float pd = list_d[(j - 1) * ls];
    const int pr = list_i[(j - 1) * ls];
    if (before(pd, pr, v, r)) break;
    list_d[j * ls] = pd;
    list_i[j * ls] = pr;
    --j;
  }
  list_d[j * ls] = v;
  list_i[j * ls] = r;
}

// The exact distance of each candidate of one query (bit b of `cand`: row
// 8 (b / 2) + c2 + b % 2 of the tile, its and-count acc[4 (b / 2) + 2 h +
// b % 2]) and its insertion where it comes before the list's last entry.
template <int kMetric, int kH>
__device__ __forceinline__ void insert_candidates(const int (&acc)[64], const int (&pt)[32], uint32_t cand, int pq,
                                                  int row0, int c2, bool round_bf16, float* list_d, int* list_i,
                                                  int k, int ls, float& thr, int& thr_r) {
#pragma unroll
  for (int b = 0; b < 32; ++b) {
    if (cand & (1u << b)) {
      const int row = row0 + 8 * (b / 2) + c2 + b % 2;
      const float v = bit_distance<kMetric>(acc[4 * (b / 2) + 2 * kH + b % 2], pq, pt[b], round_bf16);
      if (before(v, row, thr, thr_r)) {
        insert_pair(list_d, list_i, k, ls, v, row);
        thr = list_d[(k - 1) * ls];
        thr_r = list_i[(k - 1) * ls];
      }
    }
  }
}

// The rounds of one query's candidates: its four threads insert theirs in
// turn, then share the list's last entry; a turn no thread of the warp has
// candidates for is skipped. The whole warp runs it.
template <int kMetric, int kH>
__device__ __forceinline__ void select_query(const int (&acc)[64], const int (&pt)[32], uint32_t cand, int pq,
                                             int row0, int lane, bool round_bf16, float* list_d, int* list_i, int k,
                                             int ls, float& thr, int& thr_r, int& lim) {
  const uint32_t todo = __ballot_sync(0xffffffffu, cand != 0u);
  if (todo == 0u) return;
  const int own = lane % 4;
  for (int turn = 0; turn < 4; ++turn) {
    if (!(todo & (0x11111111u << turn))) continue;
    if (own == turn && cand)
      insert_candidates<kMetric, kH>(acc, pt, cand, pq, row0, 2 * own, round_bf16, list_d, list_i, k, ls, thr, thr_r);
    __syncwarp();
    const int src = (lane & ~3) | turn;
    thr = __shfl_sync(0xffffffffu, thr, src);
    thr_r = __shfl_sync(0xffffffffu, thr_r, src);
  }
  lim = pass_limit<kMetric>(thr, pq, round_bf16);
}

// The scan of rows [r0, min(n_rows, r0 + split_rows)) (split blockIdx.y)
// for queries [q0, q0 + 128) (blockIdx.x) into lists of k; kSmallList: k
// <= kSmemK, the lists in shared memory. The lists are written to
// out_d/out_i [gridDim.y, n_q, k]; `final_ids` gives entries at or above
// MASKED / 2 the id -1 (one split).
template <int kMetric, bool kSmallList>
__global__ void __launch_bounds__(kBlock, 1)
bit_scan_wgmma(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap t_map,
               const float* __restrict__ q_pop, const float* __restrict__ t_pop, const uint8_t* __restrict__ valid,
               float* out_d, int* out_i, int n_q, int n_rows, int row_bytes, int q_pop_stride, int t_pop_stride,
               int k, int round_flag, int split_rows, int final_ids) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const BitLayout L = bit_layout(row_bytes / kKB, kSmallList ? k : kMaxK);
  uint8_t* ring = smem + L.ring_off;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar_off);
  uint64_t* q_bar = full + L.stages;
  uint32_t* taken = reinterpret_cast<uint32_t*>(q_bar + 1);
  const bool round_bf16 = round_flag != 0;

  const int tid = threadIdx.x;
  const int g = tid / kWG;
  const int t = tid % kWG;
  const int lane = t % 32;
  const int q0 = blockIdx.x * kBQ;
  const int r0 = blockIdx.y * split_rows;
  const int r_end = min(n_rows, r0 + split_rows);
  const int n_tiles = (r_end - r0 + kBitRows - 1) / kBitRows;
  const int steps = n_tiles * L.n_kb;

  if (tid == 0) {
    for (int i = 0; i < L.stages + 1; ++i) mbar_init(full + i, 1);
    for (int i = 0; i < L.stages; ++i) taken[i] = 0;
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    if (L.resident) {
      mbar_expect_tx(q_bar, 2 * L.n_kb * kQStage);
      for (int h = 0; h < 2; ++h)
        for (int kb = 0; kb < L.n_kb; ++kb)
          tma_load(smem + (h * L.n_kb + kb) * kQStage, &q_map, kb * kKB, q0 + kQT * h, q_bar);
    }
    for (int n = 0; n < L.stages && n < steps; ++n) bit_fill(L, ring, full, &q_map, &t_map, n, q0, r0);
  }

  // this thread's queries: qa + 8 h, columns col[h] of the block's 128
  const int col0 = kQT * g + 16 * (t / 32) + lane / 4;
  int pq[2], lim[2], thr_r[2];
  float thr[2];
  bool live[2];
  float* list_d[2];
  int* list_i[2];
  const int ls = kSmallList ? kBQ : 1;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = q0 + col0 + 8 * h;
    live[h] = qi < n_q;
    pq[h] = live[h] ? __float2int_rn(q_pop[static_cast<size_t>(qi) * q_pop_stride]) : 0;
    thr[h] = kMasked;
    thr_r[h] = kNoRow;
    lim[h] = pass_limit<kMetric>(kMasked, pq[h], round_bf16);
    if (kSmallList) {
      list_d[h] = reinterpret_cast<float*>(smem + L.list_off) + col0 + 8 * h;
      list_i[h] = reinterpret_cast<int*>(smem + L.list_off + kSmemK * kBQ * 4) + col0 + 8 * h;
    } else {
      const size_t at = (static_cast<size_t>(blockIdx.y) * n_q + (live[h] ? qi : 0)) * k;
      list_d[h] = out_d + at;
      list_i[h] = out_i + at;
    }
    // the query's four threads fill its list's entries between them
    if (live[h])
      for (int j = lane % 4; j < k; j += 4) {
        list_d[h][j * ls] = kMasked;
        list_i[h][j * ls] = kNoRow;
      }
  }
  __syncwarp();
  if (L.resident) mbar_wait(q_bar, 0);

  auto row_pop = [&](int r) {
    return r < r_end && valid[r] ? __float2int_rn(t_pop[static_cast<size_t>(r) * t_pop_stride]) : -1;
  };
  int next_pop = row_pop(r0 + t);
  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  for (int i = 0; i < n_tiles; ++i) {
    const int row0 = r0 + i * kBitRows;
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    for (int kb = 0; kb < L.n_kb; ++kb) {
      const int n = i * L.n_kb + kb;
      const int slot = n % L.stages;
      mbar_wait(full + slot, (n / L.stages) & 1);
      const uint32_t ta = smem_addr(ring + slot * L.stage_bytes);
      const uint32_t qb = L.resident ? smem_addr(smem + (g * L.n_kb + kb) * kQStage) : ta + kRStage + g * kQStage;
      const uint64_t da = sw128_desc(qb), db = sw128_desc(ta);
#pragma unroll
      for (int s = 0; s < kKB / 32; ++s) mma_popc(acc, da + 2 * s, db + 2 * s, kb | s);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      if (kb > 0) {
        asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
        bit_release(L, ring, full, taken, &q_map, &t_map, n - 1, steps, q0, r0, t);
      }
    }
    // the tile's row popcounts while its product runs, then the next tile's
    int* pop = reinterpret_cast<int*>(smem + L.pop_off) + (2 * g + i % 2) * kBitRows;
    pop[t] = next_pop;
    next_pop = row_pop(row0 + kBitRows + t);
    asm volatile("bar.sync %0, 128;" ::"r"(1 + g) : "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc(acc);
    bit_release(L, ring, full, taken, &q_map, &t_map, (i + 1) * L.n_kb - 1, steps, q0, r0, t);

    // this thread's 32 rows: 8 j + c2 + e, j < 16, e < 2
    const int c2 = 2 * (lane % 4);
    int pt[32];
    uint32_t alive = 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int2 p = *reinterpret_cast<const int2*>(pop + 8 * j + c2);
      pt[2 * j] = p.x;
      pt[2 * j + 1] = p.y;
      alive |= (p.x >= 0 ? 1u : 0u) << (2 * j);
      alive |= (p.y >= 0 ? 1u : 0u) << (2 * j + 1);
    }
    uint32_t cand[2] = {0u, 0u};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int b = 0; b < 32; ++b)
        cand[h] |= (may_pass<kMetric>(acc[4 * (b / 2) + 2 * h + b % 2], pt[b], pq[h], lim[h]) ? 1u : 0u) << b;
      cand[h] = live[h] ? cand[h] & alive : 0u;
    }
    if (__any_sync(0xffffffffu, (cand[0] | cand[1]) != 0u)) {
      select_query<kMetric, 0>(acc, pt, cand[0], pq[0], row0, lane, round_bf16, list_d[0], list_i[0], k, ls, thr[0],
                               thr_r[0], lim[0]);
      select_query<kMetric, 1>(acc, pt, cand[1], pq[1], row0, lane, round_bf16, list_d[1], list_i[1], k, ls, thr[1],
                               thr_r[1], lim[1]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!live[h]) continue;
    const size_t at = (static_cast<size_t>(blockIdx.y) * n_q + q0 + col0 + 8 * h) * k;
    for (int j = lane % 4; j < k; j += 4) {
      const float d = list_d[h][j * ls];
      const int r = list_i[h][j * ls];
      out_d[at + j] = d;
      out_i[at + j] = final_ids && d >= kMasked / 2 ? -1 : r;
    }
  }
}

// The k best of each query's `splits` sorted partial lists ([splits, n_q,
// k], written by bit_scan_wgmma) into out_d/out_i [n_q, k]: the first list
// copied, then each other's entries inserted until one does not come before
// the list's last entry; ids -1 at or above MASKED / 2.
__global__ void __launch_bounds__(kMergeThreads)
bit_scan_merge(const float* __restrict__ part_d, const int* __restrict__ part_i, float* out_d, int* out_i, int n_q,
               int k, int splits) {
  const int qi = blockIdx.x * kMergeThreads + threadIdx.x;
  if (qi >= n_q) return;
  float* ld = out_d + static_cast<size_t>(qi) * k;
  int* li = out_i + static_cast<size_t>(qi) * k;
  for (int j = 0; j < k; ++j) {
    ld[j] = part_d[static_cast<size_t>(qi) * k + j];
    li[j] = part_i[static_cast<size_t>(qi) * k + j];
  }
  float thr = ld[k - 1];
  int thr_r = li[k - 1];
  for (int s = 1; s < splits; ++s) {
    const size_t at = (static_cast<size_t>(s) * n_q + qi) * k;
    for (int j = 0; j < k; ++j) {
      const float v = part_d[at + j];
      const int r = part_i[at + j];
      if (!before(v, r, thr, thr_r)) break;
      insert_pair(ld, li, k, 1, v, r);
      thr = ld[k - 1];
      thr_r = li[k - 1];
    }
  }
  for (int j = 0; j < k; ++j)
    if (ld[j] >= kMasked / 2) li[j] = -1;
}

template <int kMetric, bool kSmallList>
int run_bit_scan(const CUtensorMap& q_map, const CUtensorMap& t_map, const float* q_pop, const float* t_pop,
                 const uint8_t* valid, float* out_d, int* out_i, int n_q, int n_rows, int row_bytes,
                 int q_pop_stride, int t_pop_stride, int k, int round_flag, int split_rows, int splits,
                 cudaStream_t s) {
  const BitLayout L = bit_layout(row_bytes / kKB, kSmallList ? k : kMaxK);
  if (L.stages < 2) return cudaErrorInvalidValue;
  const auto kernel = bit_scan_wgmma<kMetric, kSmallList>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_q + kBQ - 1) / kBQ, splits);
  kernel<<<grid, kBlock, L.bytes, s>>>(q_map, t_map, q_pop, t_pop, valid, out_d, out_i, n_q, n_rows, row_bytes,
                                       q_pop_stride, t_pop_stride, k, round_flag, split_rows, splits == 1);
  return static_cast<int>(cudaGetLastError());
}

template <int kMetric>
int bit_scan_metric(const CUtensorMap& q_map, const CUtensorMap& t_map, const float* q_pop, const float* t_pop,
                    const uint8_t* valid, float* out_d, int* out_i, int n_q, int n_rows, int row_bytes,
                    int q_pop_stride, int t_pop_stride, int k, int round_flag, int split_rows, int splits,
                    cudaStream_t s) {
  if (k <= kSmemK)
    return run_bit_scan<kMetric, true>(q_map, t_map, q_pop, t_pop, valid, out_d, out_i, n_q, n_rows, row_bytes,
                                       q_pop_stride, t_pop_stride, k, round_flag, split_rows, splits, s);
  return run_bit_scan<kMetric, false>(q_map, t_map, q_pop, t_pop, valid, out_d, out_i, n_q, n_rows, row_bytes,
                                      q_pop_stride, t_pop_stride, k, round_flag, split_rows, splits, s);
}

}  // namespace

extern "C" {

// The k smallest (distance, row) pairs of each of n_q packed queries over
// the live rows of an [n_rows, width] packed table (metric 3 hamming, 4
// tanimoto, 5 sorensen), into out_d/out_i [n_q, k]. q_pop/t_pop are the
// rows' popcounts as f32, `stride` elements apart; valid is one byte a row.
// With splits > 1 each split of split_rows rows (a multiple of 128) writes
// part_d/part_i [splits, n_q, k] and a second kernel merges them.
int usearch_bit_scan(const void* q, const void* table, const float* q_pop, const float* t_pop, const uint8_t* valid,
                     float* out_d, int* out_i, float* part_d, int* part_i, int n_q, int n_rows, int width,
                     int q_pop_stride, int t_pop_stride, int metric, int k, int round_flag, int split_rows,
                     int splits, void* stream) {
  if (n_q < 1 || n_rows < 1 || width < kKB || width % kKB || width > kMaxWidth || k < 1 || k > kMaxK ||
      splits < 1 || split_rows < kBitRows || split_rows % kBitRows ||
      static_cast<long long>(split_rows) * (splits - 1) >= n_rows ||
      static_cast<long long>(split_rows) * splits < n_rows || (splits > 1 && (part_d == nullptr || part_i == nullptr)))
    return cudaErrorInvalidValue;
  CUtensorMap q_map, t_map;
  if (!tile_map(&q_map, q, width, n_q, kQT) || !tile_map(&t_map, table, width, n_rows, kBitRows))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* scan_d = splits > 1 ? part_d : out_d;
  int* scan_i = splits > 1 ? part_i : out_i;
  int err;
  switch (metric) {
    case kHamming:
      err = bit_scan_metric<kHamming>(q_map, t_map, q_pop, t_pop, valid, scan_d, scan_i, n_q, n_rows, width,
                                      q_pop_stride, t_pop_stride, k, round_flag, split_rows, splits, s);
      break;
    case kTanimoto:
      err = bit_scan_metric<kTanimoto>(q_map, t_map, q_pop, t_pop, valid, scan_d, scan_i, n_q, n_rows, width,
                                       q_pop_stride, t_pop_stride, k, round_flag, split_rows, splits, s);
      break;
    case kSorensen:
      err = bit_scan_metric<kSorensen>(q_map, t_map, q_pop, t_pop, valid, scan_d, scan_i, n_q, n_rows, width,
                                       q_pop_stride, t_pop_stride, k, round_flag, split_rows, splits, s);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || splits == 1) return err;
  bit_scan_merge<<<(n_q + kMergeThreads - 1) / kMergeThreads, kMergeThreads, 0, s>>>(part_d, part_i, out_d, out_i,
                                                                                     n_q, k, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
