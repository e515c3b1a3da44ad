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
// MXU. Here the and-count popc(t & q) is one tensor-core product, `wgmma`
// m64n128k256 b1 with .and.popc (`mma_popc`), summed in int32: the same
// integer whatever the bit order, with the popcounts of the rows as their
// squared norms, so hamming is l2sq's expression and takes its epilogue.
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
// B6's lists `usearch_pair_lists`: the `pair` flavour (csrc/pair.cu) hands
// B3 its (query, window) pairs and takes each pair's first k in rank form,
// before `_rank_epilogue`, for bin_m up to k <= 128: a pass takes kM rounds
// of each bin, the next pass the rounds after the last (value, row) it took,
// while some lane still has rounds of its bin_m to take.
//
// B7 `usearch_binned_probe` replaces `_make_binned_probe_kernel`
// (pallas_probe.py:636), launched by `pallas_ivf_probe_binned` (:799), the
// `bin` flavour: i8 rows only, over each pair's whole padded window with no
// window mask, stats or penalty, the raw int32 dot of every row, and per
// bw-row sub-bin the `keep` largest, written round-major (round j of sub-bin
// b at column j * (w_pad / bw) + b) as f32 -dot beside the global row. The
// TPU kernel selects by min-reducing the packed key (-dot << 5) | row_in_bin
// (`pack`) or by f32 min and first argmin (`fminarg`); here the key is -dot,
// or -dot rounded to f32, with the lower row first on equal keys, which is
// the same order. It is a flavour of the tensor-core kernel below: lanes
// with one padded window are one segment, and B3's bound holds.
//
// Design over i8, bf16 and b1 rows (`grouped_wgmma`, the tensor cores). A
// block of two warpgroups takes a cell; warpgroup g owns lanes [64 g,
// 64 g + 64), the M side and A operand of `wgmma`. The cell's 128 query rows
// are loaded once by TMA when their rows are at most 512 bytes (wider rows
// stream their query K-blocks beside the table's). Lanes that share a
// window are a contiguous run of the cell (a segment, found by a ballot of
// the lanes whose window differs from the previous lane's); the block walks
// every segment's 128-row bins (tiles) in order, and one ring of TMA slots,
// a bin's 128-byte K-block each, feeds both warpgroups: every warp waits
// for every step and releases it, and the last of the eight to release a
// slot refills it (a counter per slot). A warpgroup with no lane
// in a segment only waits and releases, so a one-lane segment costs one
// warpgroup's product. For each tile the warpgroup runs `wgmma` m64n128,
// k32 s8 or k256 b1 and-popc (exact int32) or k16 bf16 (f32, no TF32), over
// the bin's K-blocks (a 1024-bit row is one);
// each thread then holds 32 rows of each of two lanes (four threads, a
// quad, hold a lane's 128). The epilogue stays in registers: each thread
// scores its rows in rank form in place of their dots (+inf outside the
// window, deleted, or, for B3, past the lane's full list), then round t
// takes out the lane's t-th best (value, row) of the bin: each thread's
// best of its rows (ascending, '<'), the quad's best of the four by
// (value, row), removed by the thread holding it; the rounds stop once no
// lane of the warp offers a row. B5 writes round t of each lane to its
// column. B3's quad inserts it into the lane's list, kept lane-major in
// shared memory with each entry's round: the quad counts the entries before
// it (lower value, or equal from an earlier round or bin) and moves the
// rest up one, sixteen at a time. The lists are written to [P, k] at the
// end, the cell's rows one coalesced block. The row values (t_sq, the
// penalty) are loaded a tile ahead into registers and parked in shared
// memory for the tile. i8 dots of rows of at most 256 bytes, and b1 dots
// (at most 8 W bits, W <= 2^19 bytes), convert to f32 exactly without I2F
// (`dot_value`). B6's lists are B3's with the list kept in rank form and,
// for bin_m above kM, the selection and fold repeated in passes while a lane
// of the warp took a full pass. B7 keeps the int32 dots: per lane and round
// each thread's best (key, row) of each of its runs of a sub-bin (a tree
// over its 32 rows in registers), the best of the quad's threads that share
// the sub-bin (shuffles), stored by one of them and removed by its holder;
// only the columns no round reaches are filled with MASKED/-1.
//
// Design over f32 rows (`grouped_probe_kernel`, SIMT). One
// block of 128 threads per cell, one thread per pair (lane). The block
// walks its segments in order, and for each 128-row bin of the segment's
// window streams the rows through shared memory, 64 rows and 128 bytes of
// the width at a time, beside the same slice of the segment's query rows.
// Only the segment's lanes compute: each thread keeps the dots of its query
// against the 64 rows in registers (f32 FMAs, no TF32), parks them in
// shared memory, then folds the rows in
// ascending order into a sorted list of the bin's best (strict '<', so the
// lower row wins ties). After each bin, B3 merges the bin's list into the
// lane's own sorted top-k_pad, kept lane-major in shared memory with each
// entry's extraction round; B5 writes the bin's list to its columns instead,
// after the block has filled its [128, out_pad] outputs with MASKED/-1 in
// coalesced stores (as the tensor-core kernel does). B6's lists over f32
// run B3 here in rank form, in passes of kMaxBinM rounds past kMaxBinM,
// each pass computing the bin's dots again.
//
// Bound on this card: each pair's window is a [w_pad, W] x [W] product,
// 2 x P x w_pad x W operations (a b1 row of B bytes counts as 8 B one-bit
// products, at eight times the int8 rate: the b1 product takes 256 bit
// pairs a step where s8 takes 32 byte pairs); the distinct windows of a
// cell are read once. At bench.py's IVF shape (1M x 256 i8 rows, 16,384
// queries, ~311k pairs, w_pad 1,280) and at the b1 IVF's (1M x 1024-bit
// rows, 4,096 queries, ~86k pairs, w_pad 1,792) the bytes of the distinct
// windows bound it, below half a millisecond at the card's memory rate.
// What holds the tensor-core kernel back there is its epilogue, not the
// product or the stream (PERF.md, Findings; `python -m
// usearch_torch.microbench.probe_breakdown`).
//
// The dot products, the rank-form distances, the staging loop and the
// window stream are csrc/probe_common.cuh's, shared with B6's fold
// (csrc/pair.cu); the tensor-core blocks
// (descriptors, TMA, mbarriers, `mma_k`) csrc/wgmma_common.cuh's. The
// entry points launch on the stream they are given, allocate nothing, and
// return cudaGetLastError() after the launch.

#include <limits.h>

#include "probe_common.cuh"
#include "wgmma_common.cuh"

namespace {

struct Params {
  const void* q_g;        // [P, W] the pairs' query rows
  const float* q_sq;      // [P]
  const void* table;      // [n_rows, W]
  const float* t_sq;      // [n_rows] or null (ip)
  const float* penalty;   // [n_rows] or null (every row live)
  const int* win_base;    // [P] B5: first row of the padded window
  const int* win_start;   // [P]
  const int* win_len;     // [P]
  float* out_d;           // B3, B6 [P, k]; B5, B7 [P, out_pad]
  int* out_i;
  int n_rows, width, metric, k, k_pad, bin_m, w_pad, out_pad;
  int bw, keep, fminarg;  // B7
};

// What a kernel does with each bin's candidates. B5 and B3 are 0 and 1,
// the false and true of the launchers' fold flag.
enum Flavour {
  kB5Store = 0,  // each bin's bin_m best written to its columns
  kB3Fold = 1,   // folded into a running top-k_pad per lane
  kB6Lists = 2,  // B3's fold in rank form, bin_m past kM in passes
  kB7Keys = 3,   // the keep best raw keys of each bw-row sub-bin written out
};

template <typename T, int kMaxBinM, int kFlavour>
__global__ void __launch_bounds__(kLanes) grouped_probe_kernel(const Params p) {
  using A = typename Acc<T>::type;
  constexpr bool kFold = kFlavour != kB5Store;  // B3 and B6; the SIMT kernel has no B7
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
      // B6: passes of kMaxBinM rounds while a lane has more of its bin_m to
      // take, each after the last (value, row) of the one before
      float lb_v = -__int_as_float(0x7f800000);
      int lb_r = -1;
      for (int base = 0;; base += kMaxBinM) {
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
              // B6: taken by an earlier pass
              if (kFlavour == kB6Lists && !(v > lb_v || (v == lb_v && row > lb_r))) continue;
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
          // merge the bin's candidates (round base + j = rank within the bin)
          // into the lane's list, ordered by (distance, round, bin)
#pragma unroll
          for (int j = 0; j < kMaxBinM; ++j) {
            const int round = kFlavour == kB6Lists ? base + j : j;
            if (round >= p.bin_m || bi[j] < 0) break;
            const float v = bv[j];
            int pos = cnt < p.k_pad ? cnt : p.k_pad - 1;
            if (cnt == p.k_pad) {
              const float lv = lst_v[pos * kLanes + lane];
              if (lv < v || (lv == v && lst_r[pos * kLanes + lane] <= round)) break;
            }
            while (pos > 0) {
              const int e = (pos - 1) * kLanes + lane;
              const float ev = lst_v[e];
              if (ev < v || (ev == v && lst_r[e] <= round)) break;
              lst_v[e + kLanes] = ev;
              lst_i[e + kLanes] = lst_i[e];
              lst_r[e + kLanes] = lst_r[e];
              --pos;
            }
            lst_v[pos * kLanes + lane] = v;
            lst_i[pos * kLanes + lane] = bi[j];
            lst_r[pos * kLanes + lane] = static_cast<uint8_t>(round);
            if (cnt < p.k_pad) ++cnt;
          }
        }
        if constexpr (kFlavour != kB6Lists) {
          break;
        } else {
          // another pass while an owner's pass was full and rounds remain
          lb_v = bv[kMaxBinM - 1];
          lb_r = bi[kMaxBinM - 1];
          if (!__syncthreads_or(owner && bi[kMaxBinM - 1] >= 0 && base + kMaxBinM < p.bin_m)) break;
        }
      }
    }
  }

  if (kFold) {
    for (int j = 0; j < p.k; ++j) {
      float d = kMasked;
      int id = -1;
      if (j < cnt) {
        if constexpr (kFlavour == kB6Lists) d = lst_v[j * kLanes + lane];  // rank form: B6's fold compares these
        else d = rank_epilogue(p.metric, lst_v[j * kLanes + lane], qs);
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

template <typename T, int kMaxBinM, int kFlavour>
int launch_typed(const Params& p, int n_pairs, cudaStream_t stream) {
  auto kernel = grouped_probe_kernel<T, kMaxBinM, kFlavour>;
  const size_t smem = smem_bytes(p.k_pad);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_pairs / kLanes, kLanes, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// B3 and B5 over i8 and bf16 on the tensor cores

constexpr int kPBlock = 2 * kWG;                 // two warpgroups, 64 lanes each
constexpr int kBinStage = kBin * kKB;            // 16 KB: one K-block of a bin's rows
constexpr int kPMaxStages = 8;                   // slots of the block's table ring
constexpr int kPResidentKB = 4;                  // K-blocks of the query tile kept for the block
constexpr int kAuxBytes = 2 * 2 * 2 * kBin * 4;  // [warpgroup][buffer][t_sq, penalty][row]
constexpr int kSegBytes = 5 * 1024;              // the lanes' windows, the segments, B3's list counts

// Shared memory of one block: the resident query tile (or none), the ring of
// `stages` slots (a bin's K-block, then the two query K-blocks when the
// queries stream), each warpgroup's two buffers of row values, B3's lists
// ([k_pad][128] values, rows, rounds), the segment tables, and the
// barriers: a full barrier per slot and one for the query tile, then a
// counter per slot. Every buffer starts on 1 KB; the ring takes what is
// left, up to kPMaxStages slots.
struct ProbeLayout {
  int n_kb, stages, stage_bytes, ring_off, aux_off, list_off, seg_off, bar_off, bytes;
  bool resident;
};

__host__ __device__ __forceinline__ ProbeLayout probe_layout(int n_kb, int k_pad) {
  ProbeLayout L;
  L.n_kb = n_kb;
  const int list_bytes = (k_pad * kLanes * 9 + 1023) / 1024 * 1024;
  const int fixed = kAuxBytes + list_bytes + kSegBytes + 256 + 1024;
  const int q_bytes = 2 * n_kb * kQStage;
  L.resident = n_kb <= kPResidentKB && fixed + q_bytes + 2 * kBinStage <= kSmem;
  L.stage_bytes = kBinStage + (L.resident ? 0 : 2 * kQStage);
  L.ring_off = L.resident ? q_bytes : 0;
  const int room = (kSmem - fixed - L.ring_off) / L.stage_bytes;
  L.stages = room < kPMaxStages ? room : kPMaxStages;
  L.aux_off = L.ring_off + L.stages * L.stage_bytes;
  L.list_off = L.aux_off + kAuxBytes;
  L.seg_off = L.list_off + list_bytes;
  L.bar_off = L.seg_off + kSegBytes;
  L.bytes = L.bar_off + 256 + 1024;  // barriers and counters, and slack to align the base to 1 KB
  return L;
}

// The cell's segments: per lane its window (st, ln, bs); segment s is lanes
// [lo[s], lo[s + 1]), its first bin b0[s] and its first tile t0[s] in the
// block's walk (t0[n] = every tile); B3's list counts by lane.
struct Segments {
  int *st, *ln, *bs, *lo, *b0, *t0, *n, *cnt, *masks;
};

__device__ __forceinline__ Segments segments_at(uint8_t* base) {
  Segments S;
  S.st = reinterpret_cast<int*>(base);
  S.ln = S.st + kLanes;
  S.bs = S.ln + kLanes;
  S.lo = S.bs + kLanes;   // [kLanes + 1]
  S.b0 = S.lo + kLanes + 1;
  S.t0 = S.b0 + kLanes;   // [kLanes + 1]
  S.n = S.t0 + kLanes + 1;
  S.cnt = S.n + 1;
  S.masks = S.cnt + kLanes;  // [4]
  return S;
}

// The first row of tile `tile` of the walk; `cur` is the caller's cursor
// into the segments, moved forward only.
__device__ __forceinline__ int tile_row0(const Segments& S, int& cur, int tile) {
  while (S.t0[cur + 1] <= tile) ++cur;
  return (S.b0[cur] + tile - S.t0[cur]) * kBin;
}

// The first row of the first tile of segment u0 or a later one that
// warpgroup g multiplies, -1 if none.
__device__ __forceinline__ int first_row0(const Segments& S, int u0, int segs, int g) {
  for (int u = u0; u < segs; ++u)
    if (S.t0[u + 1] > S.t0[u] && S.lo[u] < kQT * (g + 1) && S.lo[u + 1] > kQT * g) return S.b0[u] * kBin;
  return -1;
}

__device__ __forceinline__ void wg_sync(int id) { asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory"); }

// Fills ring slot n % stages with step n of the walk: K-block n % n_kb of
// the bin at row0, and the block's two query K-blocks (from query q0) when
// the queries stream. One thread issues it.
__device__ __forceinline__ void probe_fill(const ProbeLayout& L, uint8_t* ring, uint64_t* full,
                                           const CUtensorMap* q_map, const CUtensorMap* t_map, int n, int row0,
                                           int q0) {
  const int slot = n % L.stages;
  const int kb = n % L.n_kb;
  uint8_t* buf = ring + slot * L.stage_bytes;
  mbar_expect_tx(full + slot, L.stage_bytes);
  tma_load(buf, t_map, kb * kKB, row0, full + slot);
  if (!L.resident)
    for (int h = 0; h < 2; ++h) tma_load(buf + kBinStage + h * kQStage, q_map, kb * kKB, q0 + kQT * h, full + slot);
}

// One warp is done with step n's slot: the last of the block's eight warps
// to say so (a counter per slot) refills it with step n + stages. Every
// warp waits for every step in order, so no wait meets a slot a phase
// behind or two ahead. `cur`: the calling lane's cursor for tile_row0.
__device__ __forceinline__ void probe_release(const ProbeLayout& L, uint8_t* ring, uint64_t* full, uint32_t* taken,
                                              const CUtensorMap* q_map, const CUtensorMap* t_map, const Segments& S,
                                              int& cur, int n, int steps, int q0) {
  __syncwarp();
  if (threadIdx.x % 32 != 0) return;
  constexpr uint32_t kUsers = kPBlock / 32;  // warps that wait for every step
  // The warp's products that read the slot are complete (wgmma.wait_group)
  // and nothing else of the block reads it, so a plain counter orders the
  // refill after them.
  const uint32_t old = atomicAdd(taken + n % L.stages, 1u);
  const int m = n + L.stages;
  if (old % kUsers == kUsers - 1 && m < steps)
    probe_fill(L, ring, full, q_map, t_map, m, tile_row0(S, cur, m / L.n_kb), q0);
}

// a before b in a bin's order: (value, row)
__device__ __forceinline__ bool before(float av, int ar, float bv, int br) {
  return av < bv || (av == bv && ar < br);
}

// The four threads of a quad hold one lane's lists of the M best of their
// rows of a bin (interleaved rows, each list in (value, row) order); after
// two rounds of a bitonic merge with the thread across (xor 1, then xor 2)
// every one of them holds the M best of the bin.
template <int M>
__device__ __forceinline__ void quad_merge(float (&v)[M], int (&r)[M]) {
#pragma unroll
  for (int m = 1; m <= 2; m *= 2) {
    float ov[M];
    int orow[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      ov[i] = __shfl_xor_sync(0xffffffffu, v[i], m);
      orow[i] = __shfl_xor_sync(0xffffffffu, r[i], m);
    }
    // the M smallest of both lists, a bitonic sequence, then sorted
#pragma unroll
    for (int i = 0; i < M; ++i) {
      if (before(ov[M - 1 - i], orow[M - 1 - i], v[i], r[i])) {
        v[i] = ov[M - 1 - i];
        r[i] = orow[M - 1 - i];
      }
    }
#pragma unroll
    for (int s = M / 2; s > 0; s /= 2) {
#pragma unroll
      for (int i = 0; i < M; ++i) {
        if ((i & s) == 0 && before(v[i + s], r[i + s], v[i], r[i])) {
          const float tv = v[i];
          const int tr = r[i];
          v[i] = v[i + s];
          r[i] = r[i + s];
          v[i + s] = tv;
          r[i + s] = tr;
        }
      }
    }
  }
}

// B3 (a running top-k_pad per lane), B5 (the bins' lists written out) and
// B6's lists (B3 in rank form) over i8, bf16 or packed b1 (uint8) rows, and
// B7 (the sub-bins' keys written out) over i8 rows, on `wgmma`; kFlavour
// says which. kM: entries of a bin's list (4 or 16 for B3; 4 or 8 for B5, 8
// or 16 over b1; 4 for B6, bin_m <= k of them in passes of kM), bin_m <= kM
// of them kept. kSmall: i8 rows of at most 256 bytes and b1 rows, whose dots
// convert to f32 exactly without I2F.
template <typename T, int kMetric, int kM, int kFlavour, bool kSmall>
__global__ void __launch_bounds__(kPBlock, 1)
grouped_wgmma(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap t_map, const Params p) {
  using A = typename Acc<T>::type;
  constexpr bool kFold = kFlavour == kB3Fold || kFlavour == kB6Lists;  // a running list per lane
  constexpr bool kB1 = std::is_same<T, uint8_t>::value;
  constexpr int kTogether = kM <= 8 ? 2 : 1;  // lanes scored at once: two for ILP, one for 16-entry lists
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const ProbeLayout L = probe_layout(p.width * static_cast<int>(sizeof(T)) / kKB, kFold ? p.k_pad : 0);
  uint8_t* ring = smem + L.ring_off;
  float* aux = reinterpret_cast<float*>(smem + L.aux_off);     // [warpgroup][buffer][t_sq, penalty][kBin]
  int2* lst = reinterpret_cast<int2*>(smem + L.list_off);  // B3 [k_pad][kLanes]: (value bits, row)
  uint8_t* lst_r = reinterpret_cast<uint8_t*>(lst + p.k_pad * kLanes);  // and the entries' rounds
  const Segments S = segments_at(smem + L.seg_off);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar_off);
  uint64_t* q_bar = full + L.stages;
  uint32_t* taken = reinterpret_cast<uint32_t*>(q_bar + 1);

  const float below_half = __int_as_float(__float_as_int(kMasked * 0.5f) - 1);  // the largest float below it
  const int tid = threadIdx.x;
  const int g = tid / kWG;
  const int t = tid % kWG;
  const int warp = t / 32;
  const int l = t % 32;
  const size_t cell = blockIdx.x;
  const int q0 = static_cast<int>(cell) * kLanes;

  if (tid < kLanes) {
    const size_t pair = cell * kLanes + tid;
    int st = p.win_start[pair];
    int ln = kFlavour == kB7Keys ? p.w_pad : p.win_len[pair];  // B7: the whole padded window
    int bs = kFold ? 0 : p.win_base[pair];
    if (st < 0 || ln < 0 || st > p.n_rows - ln) ln = 0;
    if (!kFold && (bs < 0 || bs % kBin || bs > p.n_rows - p.w_pad || st < bs || st - bs > p.w_pad - ln)) ln = 0;
    if (ln == 0) st = bs = 0;
    S.st[tid] = st;
    S.ln[tid] = ln;
    S.bs[tid] = bs;
  }
  if (tid == 0) {
    for (int i = 0; i < L.stages + 1; ++i) mbar_init(full + i, 1);
    for (int i = 0; i < L.stages; ++i) taken[i] = 0;
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (kFlavour == kB5Store) {
    // MASKED/-1 everywhere first, in coalesced stores; the bins of each
    // window overwrite their columns below
    const size_t cell0 = cell * kLanes * p.out_pad;
    for (int e = tid; e < kLanes * p.out_pad; e += kPBlock) {
      p.out_d[cell0 + e] = kMasked;
      p.out_i[cell0 + e] = -1;
    }
  }
  __syncthreads();
  if constexpr (kFlavour == kB7Keys) {
    // MASKED/-1 only where no round lands: past keep * w_pad / bw, and the
    // whole row of a lane without a window; a warp a row, coalesced
    const int used = p.keep * (p.w_pad / p.bw);
    for (int lane = tid / 32; lane < kLanes; lane += kPBlock / 32) {
      const size_t row = (cell * kLanes + lane) * p.out_pad;
      for (int c = (S.ln[lane] > 0 ? used : 0) + tid % 32; c < p.out_pad; c += 32) {
        p.out_d[row + c] = kMasked;
        p.out_i[row + c] = -1;
      }
    }
  }
  // the runs of lanes that share a window: a ballot per warp of warpgroup 0
  if (tid < kLanes) {
    const bool start =
        tid == 0 || S.st[tid] != S.st[tid - 1] || S.ln[tid] != S.ln[tid - 1] || S.bs[tid] != S.bs[tid - 1];
    const unsigned mask = __ballot_sync(0xffffffffu, start);
    if (l == 0) S.masks[warp] = static_cast<int>(mask);
    wg_sync(1);
    int pos = __popc(mask & ((1u << l) - 1u));
    for (int w = 0; w < warp; ++w) pos += __popc(S.masks[w]);
    if (start) S.lo[pos] = tid;
    if (tid == 0) {
      const int n = __popc(S.masks[0]) + __popc(S.masks[1]) + __popc(S.masks[2]) + __popc(S.masks[3]);
      S.lo[n] = kLanes;
      *S.n = n;
    }
  }
  __syncthreads();
  if (tid == 0) {
    const int n = *S.n;
    int tiles = 0;
    for (int s = 0; s < n; ++s) {
      const int lo = S.lo[s];
      S.t0[s] = tiles;
      S.b0[s] = S.st[lo] / kBin;
      if (S.ln[lo] > 0) tiles += (S.st[lo] + S.ln[lo] - 1) / kBin + 1 - S.st[lo] / kBin;
    }
    S.t0[n] = tiles;
    if (tiles > 0) {
      if (L.resident) {
        mbar_expect_tx(q_bar, 2 * L.n_kb * kQStage);
        for (int h = 0; h < 2; ++h)
          for (int kb = 0; kb < L.n_kb; ++kb)
            tma_load(smem + (h * L.n_kb + kb) * kQStage, &q_map, kb * kKB, q0 + kQT * h, q_bar);
      }
      int cur = 0;
      for (int n = 0; n < L.stages && n < tiles * L.n_kb; ++n)
        probe_fill(L, ring, full, &q_map, &t_map, n, tile_row0(S, cur, n / L.n_kb), q0);
    }
  }
  __syncthreads();

  const int segs = *S.n;
  const int steps = S.t0[segs] * L.n_kb;
  const bool has_pen = p.penalty != nullptr;
  // this thread's lanes (the rows of its accumulators): m_h = 16 warp + l / 4
  // + 8 h of the warpgroup's 64; it holds rows 8 j + c2 + e of each bin
  const int lane0 = kQT * g + 16 * warp + l / 4;
  const int c2 = 2 * (l % 4);
  float qs[2];
  if constexpr (kFlavour != kB7Keys) {
#pragma unroll
    for (int h = 0; h < 2; ++h) qs[h] = p.q_sq[q0 + lane0 + 8 * h];
  }
  // B3: thread h < 2 of a quad owns lane lane0 + 8 h's list: its count and,
  // once the list is full, its last value
  int cnt = 0;
  float own_thr = below_half;
  float cv[kM];  // the owned lane's candidates of the current bin
  int ci[kM];
  const float inf = __int_as_float(0x7f800000);
  // this thread's row of the warpgroup's next tile: its squared norm and
  // penalty, loaded a tile ahead
  float ts_n = 0.0f, pen_n = 0.0f;
  auto load_row = [&](int r0) {
    if (r0 < 0) return;
    ts_n = kMetric != kIP ? __ldg(p.t_sq + r0 + t) : 0.0f;
    pen_n = has_pen ? __ldg(p.penalty + r0 + t) : 0.0f;
  };
  load_row(first_row0(S, 0, segs, g));
  if (L.resident && steps > 0) mbar_wait(q_bar, 0);

  int n = 0;     // steps of the walk so far
  int used = 0;  // tiles this warpgroup multiplied
  int cur = 0;   // cursor of this lane's refills
  A acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = A(0);
  for (int s = 0; s < segs; ++s) {
    const int lo = S.lo[s], hi = S.lo[s + 1];
    const int nt = S.t0[s + 1] - S.t0[s];
    if (nt == 0) continue;
    if (lo >= kQT * (g + 1) || hi <= kQT * g) {
      // none of this warpgroup's lanes: wait for each step and release it
      for (int e = 0; e < nt * L.n_kb; ++e, ++n) {
        mbar_wait(full + n % L.stages, (n / L.stages) & 1);
        probe_release(L, ring, full, taken, &q_map, &t_map, S, cur, n, steps, q0);
      }
      continue;
    }
    const int w_st = S.st[lo], w_end = w_st + S.ln[lo];
    bool act[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) act[h] = lane0 + 8 * h >= lo && lane0 + 8 * h < hi;
    const bool warp_active = kQT * g + 16 * warp < hi && kQT * g + 16 * warp + 16 > lo;
    for (int b = S.b0[s]; b < S.b0[s] + nt; ++b) {
      const int row0 = b * kBin;
      float* ax = aux + (2 * g + (used & 1)) * 2 * kBin;
      ax[t] = ts_n;
      ax[kBin + t] = pen_n;
      load_row(b + 1 < S.b0[s] + nt ? row0 + kBin : first_row0(S, s + 1, segs, g));

      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
      for (int kb = 0; kb < L.n_kb; ++kb, ++n) {
        const int slot = n % L.stages;
        mbar_wait(full + slot, (n / L.stages) & 1);
        const uint32_t ta = smem_addr(ring + slot * L.stage_bytes);
        const uint32_t qa = L.resident ? smem_addr(smem + (g * L.n_kb + kb) * kQStage) : ta + kBinStage + g * kQStage;
        const uint64_t da = sw128_desc(qa), db = sw128_desc(ta);
#pragma unroll
        for (int k = 0; k < kKB / 32; ++k) {
          if constexpr (kB1) mma_popc(acc, da + 2 * k, db + 2 * k, kb | k);
          else mma_k(acc, da + 2 * k, db + 2 * k, kb | k);
        }
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        if (kb > 0) {
          // the previous K-block's product is done: release its slot
          asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
          probe_release(L, ring, full, taken, &q_map, &t_map, S, cur, n - 1, steps, q0);
        }
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_acc(acc);
      probe_release(L, ring, full, taken, &q_map, &t_map, S, cur, n - 1, steps, q0);
      wg_sync(1 + g);  // the tile's row values are in ax
      ++used;
      if (!warp_active) continue;

      if constexpr (kFlavour == kB7Keys) {
        // B7, from the accumulators: per lane and bw-row sub-bin, round t
        // takes the best (key, row), key = -dot or -dot rounded to f32. A
        // thread holds `rows` of each sub-bin (row pairs of 8 j + c2 and a
        // run of j), `sharing` threads of the quad hold one: each thread's
        // best by a tree over its aligned runs, the sharing threads' best by
        // shuffles, written by one of them (a thread's sub-bins of a tile
        // are adjacent columns from bw = 8 on: 16-byte stores) and removed
        // by its holder. The two lanes' rounds interleave; each bw is a
        // compile-time shape of the rounds, all in this one instantiation.
        const int lg_bw = __ffs(p.bw) - 1;
        const int col0 = (row0 - S.bs[lo]) >> lg_bw;  // the tile's first sub-bin
        const int nbw = p.w_pad >> lg_bw;
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int x = -acc[i];
          acc[i] = p.fminarg ? __float2int_rz(__int2float_rn(x)) : x;
        }
        auto rounds = [&](auto shape) {
          constexpr int bw = decltype(shape)::value;
          constexpr int rows = bw / 4 > 2 ? bw / 4 : 2;
          constexpr int sharing = bw / rows;
          constexpr int run = rows / 2;     // row pairs of a thread's run
          constexpr int heads = 16 / run;   // a thread's sub-bins of the tile
          for (int t = 0; t < p.keep; ++t) {
            int bk[2][16], bc[2][16];  // per row pair, then per run: the best key and its column
#pragma unroll
            for (int h = 0; h < 2; ++h) {
#pragma unroll
              for (int i = 0; i < 16; ++i) {
                const int k0 = acc[4 * i + 2 * h], k1 = acc[4 * i + 2 * h + 1];
                bk[h][i] = k1 < k0 ? k1 : k0;
                bc[h][i] = 8 * i + c2 + (k1 < k0);
              }
            }
#pragma unroll
            for (int s = 1; s < run; s *= 2) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
#pragma unroll
                for (int i = 0; i < 16; i += 2 * s) {
                  if (bk[h][i + s] < bk[h][i]) {
                    bk[h][i] = bk[h][i + s];
                    bc[h][i] = bc[h][i + s];
                  }
                }
              }
            }
#pragma unroll
            for (int m = 1; m < sharing; m *= 2) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
#pragma unroll
                for (int i = 0; i < 16; i += run) {
                  const int ok = __shfl_xor_sync(0xffffffffu, bk[h][i], m);
                  const int oc = __shfl_xor_sync(0xffffffffu, bc[h][i], m);
                  if (ok < bk[h][i] || (ok == bk[h][i] && oc < bc[h][i])) {
                    bk[h][i] = ok;
                    bc[h][i] = oc;
                  }
                }
              }
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const bool writer = act[h] && (l & (sharing - 1)) == (t & (sharing - 1));
              const size_t at = static_cast<size_t>(q0 + lane0 + 8 * h) * p.out_pad + t * nbw + col0;
              if (sharing == 4 && heads % 4 == 0) {
                // columns at + u: the tile's sub-bins of this lane, in order
#pragma unroll
                for (int u = 0; u < heads; u += 4) {
                  if (!writer) break;
                  reinterpret_cast<float4*>(p.out_d + at)[u / 4] =
                      make_float4(__int2float_rn(bk[h][u * run]), __int2float_rn(bk[h][(u + 1) * run]),
                                  __int2float_rn(bk[h][(u + 2) * run]), __int2float_rn(bk[h][(u + 3) * run]));
                  reinterpret_cast<int4*>(p.out_i + at)[u / 4] =
                      make_int4(row0 + bc[h][u * run], row0 + bc[h][(u + 1) * run], row0 + bc[h][(u + 2) * run],
                                row0 + bc[h][(u + 3) * run]);
                }
              } else {
#pragma unroll
                for (int i = 0; i < 16; i += run) {
                  if (!writer) break;
                  p.out_d[at + ((8 * i + c2) >> lg_bw)] = __int2float_rn(bk[h][i]);
                  p.out_i[at + ((8 * i + c2) >> lg_bw)] = row0 + bc[h][i];
                }
              }
            }
#pragma unroll
            for (int s = run / 2; s >= 1; s /= 2) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
#pragma unroll
                for (int i = 0; i < 16; i += 2 * s) bc[h][i + s] = bc[h][i];
              }
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
#pragma unroll
              for (int r = 0; r < 32; ++r) {
                if (8 * (r / 2) + c2 + r % 2 == bc[h][r / 2]) acc[4 * (r / 2) + 2 * h + r % 2] = INT_MAX;
              }
            }
          }
        };
        switch (p.bw) {
          case 2: rounds(std::integral_constant<int, 2>()); break;
          case 4: rounds(std::integral_constant<int, 4>()); break;
          case 8: rounds(std::integral_constant<int, 8>()); break;
          case 16: rounds(std::integral_constant<int, 16>()); break;
          case 32: rounds(std::integral_constant<int, 32>()); break;
          case 64: rounds(std::integral_constant<int, 64>()); break;
          default: rounds(std::integral_constant<int, 128>()); break;
        }
        continue;
      }

      // The epilogue, from the accumulators: each thread scores its 32 rows
      // of each of its two lanes and keeps their kM best, the quad merges
      // its four lists of each lane, then B3's two owners fold the bin's
      // lists into their lanes' lists and B5 writes them out. B6 repeats
      // this in passes of kM rounds, each taking the rows after the last
      // (value, row) of the pass before, while a lane of the warp has a full
      // pass and rounds of its bin_m left.
      const int c_lo = max(w_st - row0, 0), span = min(w_end - row0, kBin) - c_lo;
      float lb_v[2] = {-inf, -inf};
      int lb_c[2] = {-1, -1};
      for (int base = 0;; base += kM) {
        bool more = false;
#pragma unroll
        for (int h0 = 0; h0 < 2; h0 += kTogether) {
          float bv[kTogether][kM];
          int bi[kTogether][kM];
          float thr[kTogether];
#pragma unroll
          for (int u = 0; u < kTogether; ++u) {
#pragma unroll
            for (int j = 0; j < kM; ++j) {
              bv[u][j] = inf;
              bi[u][j] = INT_MAX;
            }
            // B3: a row past the lane's full list cannot enter it (the bin's
            // kept candidates are a prefix of the bin's order, so dropping it
            // moves no round)
            thr[u] = kFold ? __shfl_sync(0xffffffffu, own_thr, (l & ~3) | (h0 + u)) : below_half;
          }
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int col = 8 * j + c2;
            float2 ts = make_float2(0.0f, 0.0f), pen = make_float2(0.0f, 0.0f);
            if (kMetric != kIP) ts = *reinterpret_cast<const float2*>(ax + col);
            if (has_pen) pen = *reinterpret_cast<const float2*>(ax + kBin + col);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const bool in = static_cast<unsigned>(col + e - c_lo) < static_cast<unsigned>(span);
#pragma unroll
              for (int u = 0; u < kTogether; ++u) {
                const int h = h0 + u;
                const float v = window_dist(kMetric, dot_value<kSmall>(acc[4 * j + 2 * h + e]), qs[h],
                                            e ? ts.y : ts.x, has_pen, e ? pen.y : pen.x);
                // rows in ascending order: '<' leaves the lower row first
                if (!act[h] || !in || !(v <= thr[u]) || !(v < bv[u][kM - 1])) continue;
                if constexpr (kFlavour == kB6Lists) {
                  if (!(v > lb_v[h] || (v == lb_v[h] && col + e > lb_c[h]))) continue;  // taken by an earlier pass
                }
                float x = v;
                int c = col + e;
                bool shift = false;  // past the insertion point every entry moves down one
#pragma unroll
                for (int i = 0; i < kM; ++i) {
                  if (shift || x < bv[u][i]) {
                    shift = true;
                    const float tv = bv[u][i];
                    const int tc = bi[u][i];
                    bv[u][i] = x;
                    bi[u][i] = c;
                    x = tv;
                    c = tc;
                  }
                }
              }
            }
          }
#pragma unroll
          for (int u = 0; u < kTogether; ++u) {
            const int h = h0 + u;
            quad_merge<kM>(bv[u], bi[u]);
            if (!act[h]) continue;
            if (kFold) {
              // the owner of lane h keeps the bin's list for the fold
              if ((l & 3) == h) {
#pragma unroll
                for (int j = 0; j < kM; ++j) {
                  cv[j] = bv[u][j];
                  ci[j] = bi[u][j];
                }
              }
              if constexpr (kFlavour == kB6Lists) {
                lb_v[h] = bv[u][kM - 1];
                lb_c[h] = bi[u][kM - 1];
                more |= bi[u][kM - 1] != INT_MAX;
              }
            } else {
              // round j of this bin at column j * nb_w + bin of the padded
              // window; the quad's threads take every fourth round
              const size_t out0 = static_cast<size_t>(q0 + lane0 + 8 * h) * p.out_pad + (row0 - S.bs[lo]) / kBin;
              const int nb_w = p.w_pad / kBin;
#pragma unroll
              for (int j = 0; j < kM; ++j) {
                if (j >= p.bin_m || bi[u][j] == INT_MAX) break;
                if ((j & 3) != (l & 3)) continue;
                p.out_d[out0 + j * nb_w] = rank_epilogue(kMetric, bv[u][j], qs[h]);
                p.out_i[out0 + j * nb_w] = row0 + bi[u][j];
              }
            }
          }
        }
        int m = 0;  // B3: the owned lane's candidates of this bin
        if (kFold && (l & 3) < 2 && ((l & 3) == 0 ? act[0] : act[1])) {
#pragma unroll
          for (int j = 0; j < kM; ++j) m += base + j < p.bin_m && ci[j] != INT_MAX;
        }
        if (m > 0) {
          // B3: the owner's lane takes the bin's candidates (round base + j =
          // rank within the bin) into its list, ordered by (distance, round,
          // bin): each candidate's place is the count of entries before it (a
          // lower value, or the same value from an earlier round or bin), then
          // the entries from the first place on move up past the candidates
          // before them, four at a time from the top; entries past k_pad drop
          const int lane = lane0 + 8 * (l & 3);
          int2* le = lst + lane;
          uint8_t* lr = lst_r + lane;
          int pos[kM];
#pragma unroll
          for (int j = 0; j < kM; ++j) pos[j] = 0;
#pragma unroll 4
          for (int e = 0; e < cnt; ++e) {
            const float ev = __int_as_float(le[e * kLanes].x);
            const int er = lr[e * kLanes];
#pragma unroll
            for (int j = 0; j < kM; ++j) pos[j] += ev < cv[j] || (ev == cv[j] && er <= base + j);
          }
          for (int top = cnt - 1; top >= pos[0]; top -= 4) {
            int2 me[4];
            int mr[4];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              if (top - c >= pos[0]) {
                me[c] = le[(top - c) * kLanes];
                mr[c] = lr[(top - c) * kLanes];
              }
            }
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int e = top - c;
              int to = e;
#pragma unroll
              for (int j = 0; j < kM; ++j) to += j < m && pos[j] <= e;
              if (e >= pos[0] && to < p.k_pad) {
                le[to * kLanes] = me[c];
                lr[to * kLanes] = static_cast<uint8_t>(mr[c]);
              }
            }
          }
#pragma unroll
          for (int j = 0; j < kM; ++j) {
            if (j < m && pos[j] + j < p.k_pad) {
              le[(pos[j] + j) * kLanes] = make_int2(__float_as_int(cv[j]), row0 + ci[j]);
              lr[(pos[j] + j) * kLanes] = static_cast<uint8_t>(base + j);
            }
          }
          cnt = min(cnt + m, p.k_pad);
          if (cnt == p.k_pad) own_thr = __int_as_float(lst[(p.k_pad - 1) * kLanes + lane].x);
        }
        if constexpr (kFlavour != kB6Lists) {
          break;
        } else if (!__any_sync(0xffffffffu, more && base + kM < p.bin_m)) {
          break;
        }
      }
    }
  }

  if (kFold) {
    // the lists to [P, k], the cell's rows one coalesced block
    if ((l & 3) < 2) S.cnt[lane0 + 8 * (l & 3)] = cnt;
    __syncthreads();
    const size_t cell0 = cell * kLanes * p.k;
    for (int e = tid; e < kLanes * p.k; e += kPBlock) {
      const int lane = e / p.k, j = e % p.k;
      float d = kMasked;
      int id = -1;
      if (j < S.cnt[lane]) {
        const int2 entry = lst[j * kLanes + lane];
        if constexpr (kFlavour == kB6Lists) d = __int_as_float(entry.x);  // rank form: B6's fold compares these
        else d = rank_epilogue(kMetric, __int_as_float(entry.x), p.q_sq[q0 + lane]);
        id = d >= kMasked * 0.5f ? -1 : entry.y;
      }
      p.out_d[cell0 + e] = d;
      p.out_i[cell0 + e] = id;
    }
  }
}

template <typename T, int kMetric, int kM, int kFlavour>
int run_wgmma(const CUtensorMap& q_map, const CUtensorMap& t_map, const Params& p, int n_pairs, cudaStream_t s) {
  constexpr bool kFold = kFlavour == kB3Fold || kFlavour == kB6Lists;
  const ProbeLayout L = probe_layout(p.width * static_cast<int>(sizeof(T)) / kKB, kFold ? p.k_pad : 0);
  if (L.stages < 2) return cudaErrorInvalidValue;
  constexpr bool kI8 = std::is_same<T, int8_t>::value;
  constexpr bool kB1 = std::is_same<T, uint8_t>::value;
  // kSmall: i8 dots of rows of at most 256 bytes, and b1 dots (at most 8 W
  // bits) of rows of at most 2^19 bytes, the one b1 instantiation; B7 keeps
  // its dots as integers
  if (kB1 && p.width > (1 << 19)) return cudaErrorInvalidValue;
  auto kernel = grouped_wgmma<T, kMetric, kM, kFlavour, (kI8 || kB1) && kFlavour != kB7Keys>;
  if constexpr (kI8) {
    if (p.width > 256) kernel = grouped_wgmma<T, kMetric, kM, kFlavour, false>;
  }
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (err != cudaSuccess) return err;
  kernel<<<n_pairs / kLanes, kPBlock, L.bytes, s>>>(q_map, t_map, p);
  return static_cast<int>(cudaGetLastError());
}

// B3/B5/B6/B7 over i8, bf16 or b1 rows on the tensor cores: the tensor maps
// (a query box of 64 rows, a table box of one 128-row bin), then the
// metric's kernel; b1 rows go with hamming alone, l2sq's rank form, and B7
// takes no metric. kFlavour: B5 (0, false) or B3 (1, true), B6's lists, B7.
template <typename T, int kM, int kFlavour>
int launch_wgmma(const Params& p, int n_pairs, cudaStream_t s) {
  const int row_bytes = p.width * static_cast<int>(sizeof(T));
  CUtensorMap q_map, t_map;
  if (!tile_map(&q_map, p.q_g, row_bytes, n_pairs, kQT) || !tile_map(&t_map, p.table, row_bytes, p.n_rows, kBin))
    return cudaErrorInvalidValue;
  if constexpr (std::is_same<T, uint8_t>::value) {
    return run_wgmma<T, kL2sq, kM, kFlavour>(q_map, t_map, p, n_pairs, s);
  } else if constexpr (kFlavour == kB7Keys) {
    return run_wgmma<T, kIP, kM, kFlavour>(q_map, t_map, p, n_pairs, s);
  } else {
    switch (p.metric) {
      case kIP:
        return run_wgmma<T, kIP, kM, kFlavour>(q_map, t_map, p, n_pairs, s);
      case kCos:
        return run_wgmma<T, kCos, kM, kFlavour>(q_map, t_map, p, n_pairs, s);
      default:
        return run_wgmma<T, kL2sq, kM, kFlavour>(q_map, t_map, p, n_pairs, s);
    }
  }
}

// B3: i8, bf16 and b1 on the tensor cores, f32 on the SIMT kernel.
template <typename T>
int launch_fold(const Params& p, int n_pairs, cudaStream_t stream) {
  constexpr bool kTC = !std::is_same<T, float>::value;
  if constexpr (kTC) {
    if (p.bin_m <= 4) return launch_wgmma<T, 4, true>(p, n_pairs, stream);
    return launch_wgmma<T, 16, true>(p, n_pairs, stream);
  } else {
    if (p.bin_m <= 4) return launch_typed<T, 4, true>(p, n_pairs, stream);
    return launch_typed<T, 16, true>(p, n_pairs, stream);
  }
}

// B6's lists: i8, bf16 and b1 on the tensor cores in passes of 4 rounds,
// f32 on the SIMT kernel in passes of 4 or 16 (each pass computes the dots
// again there).
template <typename T>
int launch_lists(const Params& p, int n_pairs, cudaStream_t stream) {
  if constexpr (!std::is_same<T, float>::value) {
    return launch_wgmma<T, 4, kB6Lists>(p, n_pairs, stream);
  } else {
    if (p.bin_m <= 4) return launch_typed<T, 4, kB6Lists>(p, n_pairs, stream);
    return launch_typed<T, 16, kB6Lists>(p, n_pairs, stream);
  }
}

bool bad_common(int n_pairs, int n_rows, int width, int dtype, int metric, const float* t_sq) {
  // hamming goes with packed b1 rows and they with it
  return n_pairs <= 0 || n_pairs % kLanes || n_rows % kBin || width % 128 || metric < kIP || metric > kHamming ||
         (metric == kHamming) != (dtype == kB1) || (metric != kIP && t_sq == nullptr);
}

template <int (*launch_i8)(const Params&, int, cudaStream_t), int (*launch_bf16)(const Params&, int, cudaStream_t),
          int (*launch_f32)(const Params&, int, cudaStream_t), int (*launch_b1)(const Params&, int, cudaStream_t)>
int by_dtype(int dtype, const Params& p, int n_pairs, cudaStream_t s) {
  switch (dtype) {
    case kI8:
      return launch_i8(p, n_pairs, s);
    case kBF16:
      return launch_bf16(p, n_pairs, s);
    case kF32:
      return launch_f32(p, n_pairs, s);
    case kB1:
      return launch_b1(p, n_pairs, s);
    default:
      return cudaErrorInvalidValue;
  }
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
  if (bad_common(n_pairs, n_rows, width, dtype, metric, t_sq) || k < 1 || k > 128 || bin_m < 1 || bin_m > 16 ||
      bin_m > k_pad)
    return cudaErrorInvalidValue;
  const Params p{q_g, q_sq, table, t_sq, penalty, nullptr, win_start, win_len, out_d, out_i,
                 n_rows, width, metric, k, k_pad, bin_m, 0, 0};
  return by_dtype<launch_fold<int8_t>, launch_fold<__nv_bfloat16>, launch_fold<float>, launch_fold<uint8_t>>(
      dtype, p, n_pairs, static_cast<cudaStream_t>(stream));
}

// B6's lists: B3 over the pair flavour's (query, window) pairs, each pair's
// first k (value, row) in rank form, before `_rank_epilogue`; bin_m <= k.
int usearch_pair_lists(const void* q_g, const float* q_sq, const void* table, const float* t_sq,
                       const float* penalty, const int* win_start, const int* win_len, float* out_d, int* out_i,
                       int n_pairs, int n_rows, int width, int dtype, int metric, int k, int bin_m, void* stream) {
  if (bad_common(n_pairs, n_rows, width, dtype, metric, t_sq) || k < 1 || k > 128 || bin_m < 1 || bin_m > k)
    return cudaErrorInvalidValue;
  const Params p{q_g, q_sq, table, t_sq, penalty, nullptr, win_start, win_len, out_d, out_i,
                 n_rows, width, metric, k, k > 8 ? k : 8, bin_m, 0, 0};
  return by_dtype<launch_lists<int8_t>, launch_lists<__nv_bfloat16>, launch_lists<float>, launch_lists<uint8_t>>(
      dtype, p, n_pairs, static_cast<cudaStream_t>(stream));
}

// B5: ip/cos/l2sq over i8/bf16/f32 rows with bin_m <= 8, hamming over b1
// rows with bin_m <= 16. out_d/out_i are [n_pairs, out_pad] with out_pad =
// ceil(bin_m * w_pad / 128 / 128) * 128. The penalty row is required.
int usearch_grouped_probe_nofold(const void* q_g, const float* q_sq, const void* table,
                                 const float* t_sq, const float* penalty, const int* win_base,
                                 const int* win_start, const int* win_len, float* out_d, int* out_i,
                                 int n_pairs, int n_rows, int width, int dtype, int metric, int w_pad,
                                 int bin_m, void* stream) {
  if (bad_common(n_pairs, n_rows, width, dtype, metric, t_sq) || bin_m < 1 || bin_m > 16 || penalty == nullptr ||
      (dtype != kB1 && bin_m > 8) || w_pad <= 0 || w_pad % kBin || w_pad > n_rows)
    return cudaErrorInvalidValue;
  const int n_cand = bin_m * (w_pad / kBin);
  const int out_pad = (n_cand + kLanes - 1) / kLanes * kLanes;
  const Params p{q_g, q_sq, table, t_sq, penalty, win_base, win_start, win_len, out_d, out_i,
                 n_rows, width, metric, 0, 0, bin_m, w_pad, out_pad};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kI8:
      if (bin_m <= 4) return launch_wgmma<int8_t, 4, false>(p, n_pairs, s);
      return launch_wgmma<int8_t, 8, false>(p, n_pairs, s);
    case kBF16:
      if (bin_m <= 4) return launch_wgmma<__nv_bfloat16, 4, false>(p, n_pairs, s);
      return launch_wgmma<__nv_bfloat16, 8, false>(p, n_pairs, s);
    case kF32:
      return launch_typed<float, 8, false>(p, n_pairs, s);
    case kB1:
      if (bin_m <= 8) return launch_wgmma<uint8_t, 8, false>(p, n_pairs, s);
      return launch_wgmma<uint8_t, 16, false>(p, n_pairs, s);
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
      w_pad % kBin || w_pad > n_rows || bw < 2 || (bw & (bw - 1)) || bw > (fminarg ? kBin : 32) || keep < 1 ||
      keep > 8 || 2 * keep > bw)
    return cudaErrorInvalidValue;
  const int out_pad = (keep * (w_pad / bw) + kLanes - 1) / kLanes * kLanes;
  // a lane's window is its padded window, from win_base (win_start) on
  const Params p{q_g, nullptr, table, nullptr, nullptr, win_base, win_base, nullptr, out_d, out_i,
                 n_rows, width, kIP, 0, 0, 0, w_pad, out_pad, bw, keep, fminarg != 0};
  return launch_wgmma<int8_t, 4, kB7Keys>(p, n_pairs, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
