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
// bytes: `wgmma` m64n64k256 b1 `.and.popc` (`mma_popc64_kblock`, BGMMA in the
// SASS), both operands K-major from 128-byte-swizzled TMA boxes, so nothing
// is unpacked. A block of two warpgroups owns 128 queries, 64 each (the M
// side), held in shared memory for the whole block when their rows are at
// most 256 bytes and streamed K-block by K-block with the table's
// otherwise; the table streams through one ring of 64-row tiles (8 KB a
// K-block) that both warpgroups read, B8's ring (csrc/fused.cu): thread 0
// fills the first slots, then whichever warpgroup is the second to release
// a slot refills it. Two blocks share an SM (at most 128 registers a
// thread), and each warpgroup keeps two accumulator sets: it issues tile
// i + 1's product before it filters tile i, so the tensor cores run while
// the ALUs filter, and four warpgroups an SM hide each other's latencies.
// Every path through the loop issues and waits for every product (tiles go
// in pairs, padded with dead rows, and one product past the end is issued
// and never read): a product issued on some paths only, or meeting
// undefined accumulators, makes the compiler serialize every product
// (ptxas C7520). Each tile's row popcounts (a sentinel above every popcount
// for a dead row) go to a per-warpgroup double buffer, loaded two tiles
// ahead by warps 2 and 3, so that the releasing thread 0 never waits on a
// global load at its fences.
//
// Selection. Every (query, row) pair is a candidate, Q N of them, so each
// thread first tests its 32 pairs (2 queries x 16 rows) against one line a
// query: no pair whose (rounded) distance can reach the list lies on its
// wrong side (`pass_line`, redrawn only when the bound moves). For
// tanimoto and sorensen a >= alpha pt + beta, one FFMA putting alpha pt +
// beta, biased by 1.5 2^23, where its bits are an integer, and one IADD
// taking it from a, fused with the max that keeps the nearest pair; for
// hamming 2a >= pt + pq - floor(b), exact, one FADD, one IADD3 and the
// max: no shift or select a pair. The line is
// drawn from the value just under the list's last entry (the rows after it
// lie past its row, so its ties cannot enter), or from the splits' shared
// bound where that is lower. Only a warp with a pair on the line's good
// side goes on: its threads mark their passing pairs, and the query's four
// threads, one turn each, take theirs in row order through the exact
// epilogue (one __fdiv_rn) and the comparison on (distance, row), insert
// into the list and share its new last entry by shuffles. That path is one
// loop over a mask of candidates (the and-count picked out by index, the
// popcount read again from shared memory), so its code stays small. Lists
// of k <= 16 live in shared memory, longer ones in the output rows (as
// B8's).
//
// The table's rows split across blockIdx.y so that small batches fill the
// card: each split writes its sorted partial lists, and `bit_scan_merge`
// (one thread a query) merges them, in the same launch call. The splits of
// a query share a bound, the least last entry of their full lists (in
// out_d until the merge writes it): no pair past it is among the query's k
// best, so each split's line takes it when it is lower than its own, read
// every kBoundEvery tiles.
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

constexpr int kBitRows = 64;               // table rows of one tile: the N of m64n64k256
constexpr int kBQ = 2 * kQT;               // queries of a block: 64 a warpgroup
constexpr int kRStage = kBitRows * kKB;    // 8 KB: a table K-block
constexpr int kResidentKB = 2;             // K-blocks of the queries kept for the block
constexpr int kMaxStages = 8;              // slots of the ring
constexpr int kBlocksPerSM = 2;            // ops/bitscan.py BLOCKS_PER_SM
constexpr int kBoundEvery = 4;             // tiles between reads of the splits' shared bounds
constexpr int kBitSmem = 115712;           // shared memory of one of two blocks on an SM
constexpr int kSmemK = 16;                 // lists of at most this many entries live in shared memory
constexpr int kMaxK = 128;
constexpr int kMaxWidth = 1 << 17;         // bytes a row: popcounts at most 2^20
constexpr int kNoRow = INT_MAX;            // the row of an empty list entry
constexpr int kMergeThreads = 128;
constexpr float kDeadPop = 1572864.0f;     // 1.5 2^20: the popcount of a dead row, above every row's
constexpr int kLimitClamp = 1 << 22;       // hamming: |pq - floor(b)| kept at most
constexpr float kLineBias = 12582912.0f;   // 1.5 2^23: floats within 2^22 of it are integers
constexpr int kLineBits = 0x4B400000;      // its bits
constexpr float kLineClamp = 2097152.0f;   // 2^21: |beta| kept below, past every and-count

// Shared memory of a block: the resident queries (or none), the ring of
// `stages` slots (a table K-block, then the two query K-blocks when the
// queries stream), a double buffer of the tile's row popcount words and
// the queries' shared bounds per warpgroup, the lists when k <= kSmemK
// ([kSmemK][128] values, then rows), and the barriers: a full barrier per
// slot and one for the queries, then a counter per slot. Every buffer
// starts on 1 KB.
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
  const int pop_bytes = 2 * 2 * 2 * kBitRows * 4;
  const int list_bytes = k <= kSmemK ? kBQ * kSmemK * 8 : 0;
  const int room = kBitSmem - 1024 - 256 - pop_bytes - list_bytes - L.ring_off;
  const int slots = room / L.stage_bytes;
  L.stages = slots < kMaxStages ? slots : kMaxStages;
  L.pop_off = L.ring_off + L.stages * L.stage_bytes;
  L.list_off = L.pop_off + pop_bytes;
  L.bar_off = L.list_off + list_bytes;
  L.bytes = L.bar_off + 256 + 1024;
  return L;
}

// A place in the ring's walk: step n, its slot (n % stages) and the
// parity of its fill (n / stages % 2), advanced without a division.
struct Cursor {
  int n, slot;
  uint32_t phase;
};

__device__ __forceinline__ void advance(Cursor& c, int stages) {
  ++c.n;
  if (++c.slot == stages) {
    c.slot = 0;
    c.phase ^= 1u;
  }
}

// Fills ring slot `slot` with step n of the block's walk: K-block
// n % n_kb of tile n / n_kb (from row r0), and the block's two query
// K-blocks when the queries stream. One thread issues it.
__device__ __forceinline__ void bit_fill(const BitLayout& L, uint8_t* ring, uint64_t* full, const CUtensorMap* q_map,
                                         const CUtensorMap* t_map, int n, int slot, int q0, int r0) {
  const int tile = L.n_kb == 1 ? n : n / L.n_kb;
  const int kb = n - tile * L.n_kb;
  uint8_t* buf = ring + slot * L.stage_bytes;
  mbar_expect_tx(full + slot, L.stage_bytes);
  tma_load(buf, t_map, kb * kKB, r0 + tile * kBitRows, full + slot);
  if (!L.resident)
    for (int h = 0; h < 2; ++h) tma_load(buf + kRStage + h * kQStage, q_map, kb * kKB, q0 + kQT * h, full + slot);
}

// One warpgroup is done with the step at `c` (its release cursor, then
// advanced): the second of the two to say so refills its slot with the
// step `stages` later.
__device__ __forceinline__ void bit_release(const BitLayout& L, uint8_t* ring, uint64_t* full, uint32_t* taken,
                                            const CUtensorMap* q_map, const CUtensorMap* t_map, Cursor& c, int steps,
                                            int q0, int r0, int t) {
  if (t == 0) {
    __threadfence_block();
    const uint32_t old = atomicAdd(taken + c.slot, 1u);
    __threadfence_block();
    if (old % 2 == 1 && c.n + L.stages < steps) bit_fill(L, ring, full, q_map, t_map, c.n + L.stages, c.slot, q0, r0);
  }
  advance(c, L.stages);
}

// d[64 x 64] (+)= popc(a[64 x 1024 b1] & b[64 x 1024 b1]^T), exact in
// int32: one 128-byte K-block of packed bits per row pair as four
// m64n64k256 and-popc steps (BGMMA) in one statement, so nothing the
// compiler places touches the accumulators between them; the first step
// accumulates unless `first`. The layout of the s8 m64n64k32 product:
// d[4 j + 2 h + e] is row 16 w + l / 4 + 8 h, column 8 j + 2 (l % 4) + e of
// warpgroup thread 32 w + l. Adding 2 to a descriptor moves it 32 bytes
// along K.
__device__ __forceinline__ void mma_popc64_kblock(int (&d)[32], uint64_t a, uint64_t b, int first) {
  asm volatile(
      "{\n.reg .pred p, q;\n.reg .b64 a1, a2, a3, b1, b2, b3;\nsetp.eq.b32 p, %34, 0;\nsetp.eq.b32 q, %34, %34;\n"
      "add.s64 a1, %32, 2;\nadd.s64 a2, %32, 4;\nadd.s64 a3, %32, 6;\n"
      "add.s64 b1, %33, 2;\nadd.s64 b2, %33, 4;\nadd.s64 b3, %33, 6;\n"
      "wgmma.mma_async.sync.aligned.m64n64k256.s32.b1.b1.and.popc " D_REGS32 ", %32, %33, p;\n"
      "wgmma.mma_async.sync.aligned.m64n64k256.s32.b1.b1.and.popc " D_REGS32 ", a1, b1, q;\n"
      "wgmma.mma_async.sync.aligned.m64n64k256.s32.b1.b1.and.popc " D_REGS32 ", a2, b2, q;\n"
      "wgmma.mma_async.sync.aligned.m64n64k256.s32.b1.b1.and.popc " D_REGS32 ", a3, b3, q;\n}\n"
      : D32("+r", 0)
      : "l"(a), "l"(b), "r"(first));
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

// A query's prefilter: its popcount, the distance `bound` its line was
// drawn from, and the line. Every pair (a, pt) whose distance can reach the
// list lies on its good side: `line_gap` >= -kLineBits. The rows'
// popcounts are f32 bits (kDeadPop for a dead row, above every live row's).
struct Line {
  int pq;
  float alpha, base;  // hamming: 2a >= pt + base - kLineBias; otherwise a >= alpha pt + base - kLineBias
  float bound;
};

// The line of `bound`, a distance the list's k-th entry has reached (its
// own, or the splits' shared one). With b = pass_bound(bound): hamming
// pq + pt - 2a <= b, so 2a >= pt + pq - floor(b), exact in integers
// (pq - floor(b) clamped to [-2^22, 2^21 + 1], past every 2a - pt);
// tanimoto and sorensen a / u >= c and 2a / s >= c with c = 1 - b - 2^-20
// (the f32 epilogue's rounding is below 2^-23), so a >= c / (1 + c)
// (pq + pt) and a >= c / 2 (pq + pt): alpha = c / (1 + c) or c / 2 and
// beta = alpha pq, each rounded down, beta clamped to kLineClamp (past
// every and-count), c <= 0 keeping every pair. beta is biased by
// kLineBias (rounded down).
template <int kMetric>
__device__ __forceinline__ void pass_line(float bound, bool round_bf16, Line& l) {
  const float b = pass_bound(bound, round_bf16);
  l.bound = bound;
  if constexpr (kMetric == kHamming) {
    const int limit = l.pq - static_cast<int>(floorf(fminf(b, static_cast<float>(kLimitClamp))));
    l.base = __fadd_rn(static_cast<float>(min(limit, kLimitClamp / 2 + 1)), kLineBias);
  } else {
    const float c = __fsub_rd(1.0f, __fadd_ru(b, 0x1p-20f));
    float beta = -kLineClamp;
    l.alpha = 0.0f;
    if (c > 0.0f) {
      l.alpha = kMetric == kTanimoto ? __fmul_rd(c, __frcp_rd(__fadd_ru(1.0f, c))) : __fmul_rd(0.5f, c);
      beta = fminf(__fmul_rd(l.alpha, exact_float(l.pq)), kLineClamp);
    }
    l.base = __fadd_rd(beta, kLineBias);
  }
}

// The largest list value under `thr`, the list's last entry (f32, or
// bf16 when ranking rounded; -1 under 0), or thr while the list is not
// full: every row after the entry's lies past its row, so of the pairs at
// its value none enters, and the list's own line may leave them out.
__device__ __forceinline__ float strictly_below(float thr, bool round_bf16) {
  if (thr >= kMasked) return thr;
  if (thr <= 0.0f) return -1.0f;
  return __uint_as_float(__float_as_uint(thr) - (round_bf16 ? 0x10000u : 1u));
}

// A line that no pair passes (a query past the batch): 2a and a past
// 2^21 + 2.
__device__ __forceinline__ void closed_line(Line& l) {
  l.alpha = 0.0f;
  l.base = kLineBias + kLineClamp + 2.0f;
}

// How far pair (a, popcount word w) lies from its line, an integer at or
// above -kLineBits on the good side: hamming 2a minus pt + base, one FADD
// and one IADD3; otherwise a minus alpha pt + base, one FFMA and one IADD
// (fused with the max that keeps the nearest pair). The sums lie in [2^23,
// 2^24), where f32 values are the integers and their bits that integer plus
// kLineBits - kLineBias: hamming's is exact, and the FFMA's one rounding
// cannot carry it past a + kLineBias, an integer.
template <int kMetric>
__device__ __forceinline__ int line_gap(int a, int w, const Line& l) {
  if constexpr (kMetric == kHamming) return a + a - __float_as_int(__fadd_rn(__int_as_float(w), l.base));
  return a - __float_as_int(__fmaf_rn(l.alpha, __int_as_float(w), l.base));
}

// (v, r) before (d, s) in the lists' order.
__device__ __forceinline__ bool before(float v, int r, float d, int s) { return v < d || (v == d && r < s); }

// Inserts (v, r), which comes before the list's last entry, into a sorted
// list of k (entry j at j * ls).
__device__ __forceinline__ void insert_pair(float* list_d, int* list_i, int k, int ls, float v, int r) {
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

// Query h's state in a thread: its list's last entry and its prefilter.
struct QueryState {
  int thr_r;
  float thr;
  Line line;
};

// The rounds of one query's candidates (bit r of `cand`: this thread's row
// 8 (r / 2) + c2 + r % 2 of the tile, its and-count acc[4 (r / 2) + 2 kH +
// r % 2], its popcount word w[8 (r / 2) + r % 2]): the query's four threads take theirs in
// turn, in row order, each inserting into the list (entry j at j * ls)
// where it comes before the last entry, then share that entry; a turn no
// thread of the warp has candidates for is skipped. Where the entry moved,
// the line follows the value just under it (`strictly_below`), and with
// several splits the query's thread 0 lowers the splits' shared bound
// `bound_q` to the entry once the list is full. The whole warp runs it.
template <int kMetric, int kH>
__device__ __forceinline__ void select_query(const int (&acc)[32], const volatile int* w, uint32_t cand, int row0,
                                             int lane, bool round_bf16, float* list_d, int* list_i, int k, int ls,
                                             int* bound_q, QueryState& s) {
  const uint32_t todo = __ballot_sync(0xffffffffu, cand != 0u);
  if (todo == 0u) return;
  const int own = lane % 4;
  const float thr0 = s.thr;
  const int thr_r0 = s.thr_r;
  for (int turn = 0; turn < 4; ++turn) {
    if (!(todo & (0x11111111u << turn))) continue;
    if (own == turn) {
      while (cand) {
        const int r = __ffs(cand) - 1;
        cand &= cand - 1;
        int a = 0;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          if (r == j) a = acc[4 * (j / 2) + 2 * kH + j % 2];
        const int p = w[8 * (r / 2) + r % 2];
        const int row = row0 + 8 * (r / 2) + 2 * own + r % 2;
        const int pt = static_cast<int>(__int_as_float(p));
        const float v = bit_distance<kMetric>(a, s.line.pq, pt, round_bf16);
        if (before(v, row, s.thr, s.thr_r)) {
          insert_pair(list_d, list_i, k, ls, v, row);
          s.thr = list_d[(k - 1) * ls];
          s.thr_r = list_i[(k - 1) * ls];
        }
      }
    }
    __syncwarp();
    const int src = (lane & ~3) | turn;
    s.thr = __shfl_sync(0xffffffffu, s.thr, src);
    s.thr_r = __shfl_sync(0xffffffffu, s.thr_r, src);
  }
  if (s.thr == thr0 && s.thr_r == thr_r0) return;
  if (bound_q != nullptr && own == 0 && s.thr < kMasked) atomicMin(bound_q, __float_as_int(s.thr));
  const float below = strictly_below(s.thr, round_bf16);
  if (below < s.line.bound) pass_line<kMetric>(below, round_bf16, s.line);
}

// The prefilter of one tile: this thread's 16 rows (8 j + c2 + e, j < 8,
// e < 2; popcount words from the warpgroup's buffer) against the lines of
// its two queries; where any pair of the warp lies on a line's good side,
// the candidates of each query go through `select_query` (query h's list
// at list_d/list_i + h * hstep, its shared bound at bound_q + 8 h).
template <int kMetric>
__device__ __forceinline__ void filter_tile(const int (&acc)[32], const int* pop, int row0, int lane,
                                            bool round_bf16, float* list_d, int* list_i, int hstep, int k, int ls,
                                            int* bound_q, QueryState (&s)[2]) {
  const int c2 = 2 * (lane % 4);
  int w[16];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int2 p = *reinterpret_cast<const int2*>(pop + 8 * j + c2);
    w[2 * j] = p.x;
    w[2 * j + 1] = p.y;
  }
  bool some[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int most = INT_MIN;
#pragma unroll
    for (int r = 0; r < 16; ++r)
      most = max(most, line_gap<kMetric>(acc[4 * (r / 2) + 2 * h + r % 2], w[r], s[h].line));
    some[h] = most >= -kLineBits;
  }
  if (!__any_sync(0xffffffffu, some[0] || some[1])) return;
  // the words again from shared memory: the fast path's registers end
  // with it
  const volatile int* mine = pop + c2;
  uint32_t cand[2] = {0u, 0u};
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (some[h])
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const int wr = mine[8 * (r / 2) + r % 2];
        if (line_gap<kMetric>(acc[4 * (r / 2) + 2 * h + r % 2], wr, s[h].line) >= -kLineBits &&
            wr != __float_as_int(kDeadPop))
          cand[h] |= 1u << r;
      }
  select_query<kMetric, 0>(acc, mine, cand[0], row0, lane, round_bf16, list_d, list_i, k, ls, bound_q, s[0]);
  select_query<kMetric, 1>(acc, mine, cand[1], row0, lane, round_bf16, list_d + hstep, list_i + hstep, k, ls,
                           bound_q == nullptr ? nullptr : bound_q + 8, s[1]);
}

// The next tile's product into `acc` (the issue cursor `ic` at its first
// K-block): n_kb K-blocks of four m64n64k256 steps (`mma_popc64_kblock`), a
// commit each; from the second K-block on, the one before is waited for
// and released (the release cursor `rc`), so the tile never holds more than
// two slots. The last K-block stays in flight.
__device__ __forceinline__ void issue_tile(int (&acc)[32], const BitLayout& L, uint8_t* smem, uint8_t* ring,
                                           uint64_t* full, uint32_t* taken, const CUtensorMap* q_map,
                                           const CUtensorMap* t_map, Cursor& ic, Cursor& rc, int steps, int q0,
                                           int r0, int g, int t) {
  fence_acc(acc);
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
  for (int kb = 0; kb < L.n_kb; ++kb) {
    const int slot = ic.slot;
    mbar_wait(full + slot, ic.phase);
    advance(ic, L.stages);
    const uint32_t ta = smem_addr(ring + slot * L.stage_bytes);
    const uint32_t qb = L.resident ? smem_addr(smem + (g * L.n_kb + kb) * kQStage) : ta + kRStage + g * kQStage;
    mma_popc64_kblock(acc, sw128_desc(qb), sw128_desc(ta), kb == 0);
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    if (kb > 0) {
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      bit_release(L, ring, full, taken, q_map, t_map, rc, steps, q0, r0, t);
    }
  }
}

// The scan of rows [r0, min(n_rows, r0 + split_rows)) (split blockIdx.y)
// for queries [q0, q0 + 128) (blockIdx.x) into lists of k; kSmallList: k
// <= kSmemK, the lists in shared memory. The lists are written to
// out_d/out_i [gridDim.y, n_q, k]; `final_ids` gives entries at or above
// MASKED / 2 the id -1 (one split). With several splits, bound_q [n_q]
// holds each query's least k-th distance over the splits' full lists (f32
// bits; above MASKED at the start): no pair past it can be among the
// query's k best, so each split's line is drawn from it where it is lower
// than its own list's.
template <int kMetric, bool kSmallList>
__global__ void __launch_bounds__(kBlock, kBlocksPerSM)
bit_scan_wgmma(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap t_map,
               const float* __restrict__ q_pop, const float* __restrict__ t_pop, const uint8_t* __restrict__ valid,
               float* out_d, int* out_i, int* bound_q, int n_q, int n_rows, int row_bytes, int q_pop_stride,
               int t_pop_stride, int k, int round_flag, int split_rows, int final_ids) {
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
  // tiles in pairs, the last pair padded with a tile of dead rows, and one
  // more whose product is issued and never read: the loop below then issues
  // and waits for every product on every path (a product issued on some
  // paths only makes the compiler serialize every product)
  const int n_tiles = (r_end - r0 + 2 * kBitRows - 1) / (2 * kBitRows) * 2;
  const int steps = (n_tiles + 1) * L.n_kb;

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
    for (int n = 0; n < L.stages && n < steps; ++n) bit_fill(L, ring, full, &q_map, &t_map, n, n, q0, r0);
  }

  // this thread's queries: qa + 8 h, columns col0 + 8 h of the block's 128
  const int col0 = kQT * g + 16 * (t / 32) + lane / 4;
  const int ls = kSmallList ? kBQ : 1;
  // the thread's lists: query h's at list_d/list_i + h * hstep (past n_q
  // never read or written)
  float* list_d = kSmallList ? reinterpret_cast<float*>(smem + L.list_off) + col0
                             : out_d + (static_cast<size_t>(blockIdx.y) * n_q + q0 + col0) * k;
  int* list_i = kSmallList ? reinterpret_cast<int*>(smem + L.list_off + kSmemK * kBQ * 4) + col0
                           : out_i + (static_cast<size_t>(blockIdx.y) * n_q + q0 + col0) * k;
  const int hstep = kSmallList ? 8 : 8 * k;
  const int qa = q0 + col0;  // the thread's first query
  int* bounds = bound_q == nullptr || qa >= n_q ? nullptr : bound_q + qa;
  QueryState s[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = qa + 8 * h;
    const bool live = qi < n_q;
    s[h].line.pq = live ? __float2int_rn(q_pop[static_cast<size_t>(qi) * q_pop_stride]) : 0;
    s[h].thr = kMasked;
    s[h].thr_r = kNoRow;
    pass_line<kMetric>(kMasked, round_bf16, s[h].line);
    if (!live) closed_line(s[h].line);  // no pair of a query past n_q passes
    // the query's four threads fill its list's entries between them
    if (live)
      for (int j = lane % 4; j < k; j += 4) {
        list_d[h * hstep + j * ls] = kMasked;
        list_i[h * hstep + j * ls] = kNoRow;
      }
  }
  __syncwarp();
  if (L.resident) mbar_wait(q_bar, 0);

  // Warps 2 and 3 of a warpgroup (threads 64 + j) load row j of a tile two
  // tiles ahead into a double buffer in shared memory, and every
  // kBoundEvery tiles the shared bound of the warpgroup's query j, read
  // kBoundEvery tiles earlier, into the bounds beside the popcount words
  // ([2][popcount words, then bounds]; bounds in the first buffer only), so
  // that no load's latency falls in a tile and thread 0 never waits on a
  // global load at its release's fences. A popcount word past the split's
  // rows is a dead row's; a bound past the batch, or with one split, lies
  // above MASKED.
  const int j = t - kBitRows;
  auto row_pop = [&](int row) {
    const int rc = row < r_end ? row : r0;
    const float p = t_pop[static_cast<size_t>(rc) * t_pop_stride];
    return __float_as_int(row < r_end && valid[rc] ? p : kDeadPop);
  };
  const int qj = q0 + kQT * g + j;
  auto shared_bound = [&]() { return bound_q != nullptr && qj < n_q ? __ldcg(bound_q + qj) : 0x7f7f7f7f; };
  int* words = reinterpret_cast<int*>(smem + L.pop_off) + 4 * g * kBitRows;
  int next_pop[2] = {0, 0}, next_bound = 0;
  if (j >= 0) {
    next_pop[0] = row_pop(r0 + j);
    next_pop[1] = row_pop(r0 + kBitRows + j);
    next_bound = shared_bound();
  }
  const int ql = col0 - kQT * g;  // the thread's first query in the warpgroup's 64
  // both sets defined before any product (a set whose registers a product
  // meets undefined makes the compiler serialize every product)
  int acc[2][32];
#pragma unroll
  for (int x = 0; x < 32; ++x) acc[0][x] = acc[1][x] = 0;
  Cursor ic = {0, 0, 0u}, rc = {0, 0, 0u};  // the warpgroup's issues and releases
  issue_tile(acc[0], L, smem, ring, full, taken, &q_map, &t_map, ic, rc, steps, q0, r0, g, t);
  // tile i in acc[i % 2], unrolled by two so that every register index is
  // known: wait for its product, release its last slot, publish its
  // popcounts and the bounds, issue tile i + 1's product, move the lines
  // to lower bounds, filter tile i
#pragma unroll 1
  for (int i0 = 0; i0 < n_tiles; i0 += 2) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = i0 + u;
      {
        asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
        fence_acc(acc[u]);
        bit_release(L, ring, full, taken, &q_map, &t_map, rc, steps, q0, r0, t);
        int* buf = words + 2 * u * kBitRows;
        const bool bound_tile = i % kBoundEvery == 0;
        if (j >= 0) {
          buf[j] = next_pop[u];
          next_pop[u] = row_pop(r0 + (i + 2) * kBitRows + j);
          if (bound_tile) {
            words[kBitRows + j] = next_bound;
            next_bound = shared_bound();
          }
        }
        issue_tile(acc[1 - u], L, smem, ring, full, taken, &q_map, &t_map, ic, rc, steps, q0, r0, g, t);
        asm volatile("bar.sync %0, 128;" ::"r"(1 + g) : "memory");
        if (bound_tile)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float shared = __int_as_float(words[kBitRows + ql + 8 * h]);
            if (shared < s[h].line.bound) pass_line<kMetric>(shared, round_bf16, s[h].line);
          }
        filter_tile<kMetric>(acc[u], buf, r0 + i * kBitRows, lane, round_bf16, list_d, list_i, hstep, k, ls, bounds,
                             s);
      }
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");  // the unread product
  __syncwarp();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = q0 + col0 + 8 * h;
    if (qi >= n_q) continue;
    const size_t at = (static_cast<size_t>(blockIdx.y) * n_q + qi) * k;
    for (int j = lane % 4; j < k; j += 4) {
      const float d = list_d[h * hstep + j * ls];
      const int r = list_i[h * hstep + j * ls];
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
                 const uint8_t* valid, float* out_d, int* out_i, int* bound_q, int n_q, int n_rows, int row_bytes,
                 int q_pop_stride, int t_pop_stride, int k, int round_flag, int split_rows, int splits,
                 cudaStream_t s) {
  const BitLayout L = bit_layout(row_bytes / kKB, kSmallList ? k : kMaxK);
  if (L.stages < 2) return cudaErrorInvalidValue;
  const auto kernel = bit_scan_wgmma<kMetric, kSmallList>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_q + kBQ - 1) / kBQ, splits);
  kernel<<<grid, kBlock, L.bytes, s>>>(q_map, t_map, q_pop, t_pop, valid, out_d, out_i, bound_q, n_q, n_rows,
                                       row_bytes, q_pop_stride, t_pop_stride, k, round_flag, split_rows, splits == 1);
  return static_cast<int>(cudaGetLastError());
}

template <int kMetric>
int bit_scan_metric(const CUtensorMap& q_map, const CUtensorMap& t_map, const float* q_pop, const float* t_pop,
                    const uint8_t* valid, float* out_d, int* out_i, int* bound_q, int n_q, int n_rows,
                    int row_bytes, int q_pop_stride, int t_pop_stride, int k, int round_flag, int split_rows,
                    int splits, cudaStream_t s) {
  if (k <= kSmemK)
    return run_bit_scan<kMetric, true>(q_map, t_map, q_pop, t_pop, valid, out_d, out_i, bound_q, n_q, n_rows,
                                       row_bytes, q_pop_stride, t_pop_stride, k, round_flag, split_rows, splits, s);
  return run_bit_scan<kMetric, false>(q_map, t_map, q_pop, t_pop, valid, out_d, out_i, bound_q, n_q, n_rows,
                                      row_bytes, q_pop_stride, t_pop_stride, k, round_flag, split_rows, splits, s);
}

}  // namespace

extern "C" {

// The k smallest (distance, row) pairs of each of n_q packed queries over
// the live rows of an [n_rows, width] packed table (metric 3 hamming, 4
// tanimoto, 5 sorensen), into out_d/out_i [n_q, k]. q_pop/t_pop are the
// rows' popcounts as f32, `stride` elements apart; valid is one byte a row.
// With splits > 1 each split of split_rows rows (a multiple of 128) writes
// part_d/part_i [splits, n_q, k] and a second kernel merges them; the
// splits share each query's bound through out_d's first n_q words until
// the merge writes it.
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
  int* bound_q = splits > 1 ? reinterpret_cast<int*>(out_d) : nullptr;
  int err = bound_q == nullptr ? cudaSuccess : cudaMemsetAsync(bound_q, 0x7f, n_q * sizeof(int), s);  // above MASKED
  if (err != cudaSuccess) return err;
  switch (metric) {
    case kHamming:
      err = bit_scan_metric<kHamming>(q_map, t_map, q_pop, t_pop, valid, scan_d, scan_i, bound_q, n_q, n_rows,
                                      width, q_pop_stride, t_pop_stride, k, round_flag, split_rows, splits, s);
      break;
    case kTanimoto:
      err = bit_scan_metric<kTanimoto>(q_map, t_map, q_pop, t_pop, valid, scan_d, scan_i, bound_q, n_q, n_rows,
                                       width, q_pop_stride, t_pop_stride, k, round_flag, split_rows, splits, s);
      break;
    case kSorensen:
      err = bit_scan_metric<kSorensen>(q_map, t_map, q_pop, t_pop, valid, scan_d, scan_i, bound_q, n_q, n_rows,
                                       width, q_pop_stride, t_pop_stride, k, round_flag, split_rows, splits, s);
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
