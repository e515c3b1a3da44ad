// Flat-scan flavours of usearch_torch, for Hopper (sm_90a).
//
// B8 `usearch_fused_topk` replaces the TPU kernel `_make_kernel`
// (usearch_tpu/ops/pallas_scan.py:113), which `pallas_search` launches: the
// scan fused with a per-query running top-k, so the [n_q, n_bins] surface of
// bin minima never reaches memory. B9 `usearch_fused_topk_stream` replaces
// `_make_dma_kernel` (pallas_scan.py:228), which `pallas_search_dma`
// launches: B8's result, with the merge run once every `merge_every` bins.
// B10 `usearch_binned_scan_lanes` replaces `_make_binned_kernel`
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
// Dots are exact where B1's are: i8 x i8 in i32 (the TPU's B9 sums i8 in
// f32, equal while W <= 1024), bf16 in f32, and every distance comes from
// B1's own epilogue, so B8/B9's distances equal B1's over i8 and bf16. f32
// rows take the three-pass TF32 product (below), so B8/B9's f32 distances
// equal B10's f32 minima and hold B1's (the exact SIMT `simt_scan`) within
// the product's bound, 2^-22 (3 + 2^-10) |q_i t_i| a product.
//
// Bound on this card: the same [n_q, W] x [W, N] product as B1, so the
// tensor cores' rate bounds it (8.8e12 operations at N = 2^20, W = 256,
// Q = 16384: 4.4 ms at the int8 rate).
//
// B8/B9/B10 (`fused_wgmma`) run on the tensor cores with B1's building
// blocks (csrc/wgmma_common.cuh): `wgmma` m64n256 s8, bf16 or (f32) tf32,
// both operands K-major from 128-byte-swizzled TMA boxes, and B1's register
// epilogue (`tile_minima`). B1's loop order is flipped, since a running
// per-query list needs its queries to stay in one block:
// - A block of two warpgroups owns 128 queries, 64 each (the `wgmma` M side
//   and A operand), loaded once by TMA when their rows are at most 512 bytes
//   (kQResidentKB); wider rows stream their query K-blocks beside the
//   table's. TMA fills query rows past n_q with zeros; they write nothing.
// - The table streams through one ring of 256-row tiles (two bins, the B
//   operand, 32 KB a K-block) that both warpgroups read. Thread 0 of the
//   block fills the first slots; afterwards whichever warpgroup is the
//   second to finish with a slot (a shared counter per slot) refills it,
//   so neither waits for the other unless it runs a whole ring ahead.
// - Each tile's row values (B1's `Aux`) are computed by each warpgroup
//   into its own double buffer while the tile's product runs, from
//   penalties and norms loaded a tile ahead into registers (loaded in the
//   tile's own turn, their latency nearly doubled the product's time); the
//   per-query values stay in registers for the whole block.
// - The epilogue gives each query the (minimum, row) of both bins of the
//   tile; the thread that owns the query inserts bin 2t before bin 2t + 1
//   into its sorted list, the list's last value kept in a register as the
//   threshold, so a bin that does not beat it costs one compare (~k
//   ln(n_bins / k) bins enter a list on random data). Lists of k <= 16
//   live in shared memory (16 KB) and are copied to the [n_q, k] output at
//   the end; longer ones (up to 128: 128 lists of 128 do not fit beside the
//   ring) live in the output rows.
// - B8 inserts after every tile; B9 gathers the minima of merge_every bins
//   in shared memory and merges them at once; B10 keeps no list: the owner
//   stores each bin's (minimum, row) to [n_bins, n_q], 16 consecutive
//   queries a warp, so two whole 32-byte sectors per array and store. A
//   table of an odd bin count ends on a half tile, whose second bin is
//   skipped.
// The table is read once per 128 queries, 128 times at the serving shape
// (32 GiB, from L2). What holds it back on the card (PERF.md, Findings):
// product and stream overlap, and the epilogue and merges add to them.
//
// f32 rows: `mma_tf32x3` (csrc/wgmma_common.cuh), a . b as a_hi . b_lo +
// a_lo . b_hi + a_hi . b_hi, each half rounded to TF32, split in the
// kernel so an f32 table is held once. The queries always stream; per
// K-block both warpgroups split the slot's table K-block (hi in place, lo
// into the slot's 32 KB lo buffer) while the K-block before is multiplied,
// meet at a block-wide barrier, and each then loads its 64 query rows from
// the slot into registers, split (the `wgmma` RS form), once the K-block
// before is waited for. Two slots of 48 KB and their lo buffers fit beside
// lists of 16 and 8-bin merge groups.
//
// Every entry point launches on the stream it is given, allocates nothing,
// and returns cudaGetLastError() after its launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "scan_common.cuh"
#include "wgmma_common.cuh"

namespace {

constexpr int kMaxK = 128;
constexpr int kMaxMerge = 64;

// Inserts one candidate into a query's sorted list of k (entry j at
// j * ls) when it beats the list's last value `thr`; an entry already there
// wins a tie.
__device__ __forceinline__ void insert(float* list_d, int* list_i, int k, int ls, float& thr, float v, int id) {
  if (!(v < thr)) return;
  int j = k - 1;
  while (j > 0 && list_d[(j - 1) * ls] > v) {
    list_d[j * ls] = list_d[(j - 1) * ls];
    list_i[j * ls] = list_i[(j - 1) * ls];
    --j;
  }
  list_d[j * ls] = v;
  list_i[j * ls] = id;
  thr = list_d[(k - 1) * ls];
}

// Inserts candidates (in bin order, `stride` apart) into one query's list.
__device__ __forceinline__ void merge(float* list_d, int* list_i, int k, int ls, float& thr, const float* cand_v,
                                      const int* cand_i, int n, int stride) {
  for (int c = 0; c < n; ++c) insert(list_d, list_i, k, ls, thr, cand_v[c * stride], cand_i[c * stride]);
}

// What `fused_wgmma` does with each tile's bin minima.
enum Flavour {
  kInsert = 0,  // B8: insert them into the query's list
  kMerge = 1,   // B9: gather them, merge every merge_every bins
  kStore = 2,   // B10: store them to [n_bins, n_q]
};

constexpr int kFQ = 2 * kQT;     // queries of one block: a 64-query tile per warpgroup
constexpr int kQResidentKB = 4;  // K-blocks of the query tile kept for the block
constexpr int kFMaxStages = 8;   // slots of the block's table ring
constexpr int kSmemK = 16;       // lists of at most this many results live in shared memory

// Shared memory of one block: the resident query tile (or none), the ring
// of `stages` slots (a table K-block, then the two query K-blocks when the
// queries stream, as TMA fills them), for f32 rows (kTF32, whose queries
// always stream) a buffer per slot for its table K-block's lo half, two Aux
// buffers per warpgroup, each warpgroup's
// candidates [merge_every][64] (values, then rows), for k <= kSmemK each
// warpgroup's lists [k][64] (values, then rows), and the barriers: a full
// barrier per slot and one for the query tile, then a counter per slot.
// B10 (kStore) has neither candidates nor lists. Every buffer starts on
// 1 KB; the ring takes what is left.
struct FusedLayout {
  int n_kb, stages, stage_bytes, ring_off, lo_off, aux_off, cand_off, list_off, bar_off, bytes;
  bool resident;
};

template <int kFlavour, bool kTF32 = false>
__host__ __device__ __forceinline__ FusedLayout fused_layout(int n_kb, int merge_every, int k) {
  constexpr bool kLists = kFlavour != kStore;
  FusedLayout L;
  L.n_kb = n_kb;
  L.resident = !kTF32 && n_kb <= kQResidentKB;
  L.stage_bytes = kTStage + (L.resident ? 0 : 2 * kQStage);
  L.ring_off = L.resident ? 2 * n_kb * kQStage : 0;
  const int aux_bytes = 4 * static_cast<int>(sizeof(Aux));
  const int cand_bytes = kLists ? 2 * merge_every * kQT * 8 : 0;
  const int list_bytes = kLists && k <= kSmemK ? 2 * kSmemK * kQT * 8 : 0;
  const int room = kSmem - 1024 - 256 - aux_bytes - cand_bytes - list_bytes - L.ring_off;
  const int lo_bytes = kTF32 ? kTStage : 0;  // a slot's lo half
  const int slots = room / (L.stage_bytes + lo_bytes);
  L.stages = slots < kFMaxStages ? slots : kFMaxStages;
  L.lo_off = L.ring_off + L.stages * L.stage_bytes;
  L.aux_off = L.lo_off + L.stages * lo_bytes;
  L.cand_off = L.aux_off + aux_bytes;
  L.list_off = L.cand_off + cand_bytes;
  L.bar_off = L.list_off + list_bytes;
  L.bytes = L.bar_off + 256 + 1024;  // barriers and counters, and slack to align the base to 1 KB
  return L;
}

// OR of `p` over the 128 threads of a warpgroup, on its named barrier `id`;
// also orders their shared-memory writes before it ahead of reads after it.
__device__ __forceinline__ bool warpgroup_or(bool p, int id) {
  int r;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.b32 p, %1, 0;\n"
      "bar.red.or.pred q, %2, 128, p;\n"
      "selp.s32 %0, 1, 0, q;\n}\n"
      : "=r"(r)
      : "r"(static_cast<int>(p)), "r"(id)
      : "memory");
  return r != 0;
}

// Fills ring slot n % stages with step n of the walk: K-block n % n_kb of
// table tile n / n_kb, and the block's two query K-blocks (from query q0)
// when the queries stream. One thread issues it.
__device__ __forceinline__ void fused_fill(const FusedLayout& L, uint8_t* ring, uint64_t* full,
                                           const CUtensorMap* q_map, const CUtensorMap* t_map, int n, int q0) {
  const int slot = n % L.stages;
  const int kb = n % L.n_kb;
  uint8_t* buf = ring + slot * L.stage_bytes;
  mbar_expect_tx(full + slot, L.stage_bytes);
  tma_load(buf, t_map, kb * kKB, n / L.n_kb * kTileRows, full + slot);
  if (!L.resident)
    for (int h = 0; h < 2; ++h) tma_load(buf + kTStage + h * kQStage, q_map, kb * kKB, q0 + kQT * h, full + slot);
}

// One warpgroup is done with step n's slot: the second of the two to say so
// (a counter per slot) refills it with step n + stages.
__device__ __forceinline__ void fused_release(const FusedLayout& L, uint8_t* ring, uint64_t* full, uint32_t* taken,
                                              const CUtensorMap* q_map, const CUtensorMap* t_map, int n, int steps,
                                              int q0, int t) {
  if (t != 0) return;
  constexpr uint32_t kUsers = 2;  // warpgroups that read a slot
  __threadfence_block();
  const uint32_t old = atomicAdd(taken + n % L.stages, 1u);
  __threadfence_block();
  if (old % kUsers == kUsers - 1 && n + L.stages < steps) fused_fill(L, ring, full, q_map, t_map, n + L.stages, q0);
}

// The squared norms (cos, l2sq) and penalties of rows r and r + 128; 0 past
// n_rows.
template <int kMetric>
__device__ __forceinline__ void load_rows(const float* __restrict__ t_sq, const float* __restrict__ penalty, int r,
                                          int n_rows, float (&ts)[2], float (&pen)[2]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const bool in = r + kWG * j < n_rows;
    ts[j] = (in && kMetric != kIP) ? __ldg(t_sq + r + kWG * j) : 0.0f;
    pen[j] = in ? __ldg(penalty + r + kWG * j) : 0.0f;
  }
}

// B8 (kInsert: each tile's two bins inserted as soon as they are reduced),
// B9 (kMerge: the bins' minima gathered in shared memory and merged every
// merge_every bins) and B10 (kStore: the bins' minima and rows stored to
// out_d/out_i [n_bins, n_q]; k and merge_every unused), on `wgmma`. T:
// int8_t, bf16 or float (the three-pass TF32 product); kSmall: i8 rows of
// at most 256 bytes (B1's exact dot conversion and keyed ip).
template <typename T, int kMetric, bool kSmall, int kFlavour>
__global__ void __launch_bounds__(kBlock, 1)
fused_wgmma(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap t_map,
            const float* __restrict__ q_sq, const float* __restrict__ t_sq, const float* __restrict__ penalty,
            float* __restrict__ out_d, int* __restrict__ out_i, int n_q, int n_rows, int row_bytes, int k,
            int merge_every) {
  using A = typename Acc<T>::type;
  constexpr bool kTF32 = std::is_same<T, float>::value;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const FusedLayout L = fused_layout<kFlavour, kTF32>(row_bytes / kKB, merge_every, k);
  uint8_t* ring = smem + L.ring_off;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar_off);
  uint64_t* q_bar = full + L.stages;
  uint32_t* taken = reinterpret_cast<uint32_t*>(q_bar + 1);

  const int tid = threadIdx.x;
  const int g = tid / kWG;
  const int t = tid % kWG;
  const int lane = t % 32;
  const int n_bins = n_rows / kBin;
  const int n_tiles = (n_bins + 1) / 2;
  const int steps = n_tiles * L.n_kb;
  const int q0 = blockIdx.x * kFQ;
  const int qa = q0 + kQT * g + 16 * (t / 32) + lane / 4;  // this thread's queries: qa, qa + 8
  const int c2 = 2 * (lane % 4);
  Aux* aux = reinterpret_cast<Aux*>(smem + L.aux_off) + 2 * g;
  float* cand_v = reinterpret_cast<float*>(smem + L.cand_off) + g * 2 * merge_every * kQT;
  int* cand_i = reinterpret_cast<int*>(cand_v + merge_every * kQT);

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
    for (int n = 0; n < L.stages && n < steps; ++n) fused_fill(L, ring, full, &q_map, &t_map, n, q0);
  }

  float qs[2], qr[2], iqr[2];
  bool odd[2];
  query_values<kMetric>(q_sq, qa, n_q, qs, qr, iqr, odd);
  // thread c < 2 of a query's four owns query qa + 8 c and its list
  const int own = lane % 4;
  const int qi = qa + 8 * own;
  const bool owner = own < 2 && qi < n_q;
  const int col = qi - q0 - kQT * g;  // the query's column of the candidates and lists
  // the list: in shared memory for k <= kSmemK (entry j at j * 64), else in
  // the output row
  const bool shared_list = k <= kSmemK;
  const int ls = shared_list ? kQT : 1;
  float* list_d = shared_list ? reinterpret_cast<float*>(smem + L.list_off) + g * 2 * kSmemK * kQT + col
                              : out_d + (size_t)qi * k;
  int* list_i = shared_list ? reinterpret_cast<int*>(list_d + kSmemK * kQT) : out_i + (size_t)qi * k;
  float thr = kMasked;
  if (kFlavour != kStore && owner) {
    for (int j = 0; j < k; ++j) {
      list_d[j * ls] = kMasked;
      list_i[j * ls] = -1;
    }
  }
  if (L.resident) mbar_wait(q_bar, 0);

  float ts[2], pen[2];  // this thread's rows of the next tile: t, t + 128
  load_rows<kMetric>(t_sq, penalty, t, n_rows, ts, pen);
  A acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = A(0);
  int n_cand = 0;
  uint32_t qh[16], ql[16];  // f32: the query K-block's split A fragments
  for (int i = 0; i < n_tiles; ++i) {
    if constexpr (kTF32) {
      // f32: both warpgroups split the table K-block (hi in place, lo into
      // the slot's lo buffer) while the K-block before is multiplied; once
      // that is waited for, the warpgroup's query rows split into registers
      // (the `wgmma` RS form), then three products a k-step
      for (int kb = 0; kb < L.n_kb; ++kb) {
        const int n = i * L.n_kb + kb;
        const int slot = n % L.stages;
        uint8_t* buf = ring + slot * L.stage_bytes;
        uint8_t* lo = smem + L.lo_off + slot * kTStage;
        mbar_wait(full + slot, (n / L.stages) & 1);
        split_tile(buf, lo, kTStage, tid, kBlock);
        fence_proxy_async();
        block_sync();
        if (kb > 0) {
          asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
          fence_frags(qh);
          fence_frags(ql);
          fused_release(L, ring, full, taken, &q_map, &t_map, n - 1, steps, q0, t);
        }
        tf32_frags(buf + kTStage + g * kQStage, t, qh, ql);
        const uint64_t db = sw128_desc(smem_addr(buf)), dl = sw128_desc(smem_addr(lo));
        fence_acc(acc);
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
        for (int s = 0; s < kKB / 32; ++s) mma_tf32x3(acc, qh, ql, s, db + 2 * s, dl + 2 * s, kb | s);
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      }
    } else {
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
      for (int kb = 0; kb < L.n_kb; ++kb) {
        const int n = i * L.n_kb + kb;
        const int slot = n % L.stages;
        mbar_wait(full + slot, (n / L.stages) & 1);
        const uint32_t ta = smem_addr(ring + slot * L.stage_bytes);
        const uint32_t qb = L.resident ? smem_addr(smem + (g * L.n_kb + kb) * kQStage) : ta + kTStage + g * kQStage;
        const uint64_t da = sw128_desc(qb), db = sw128_desc(ta);
#pragma unroll
        for (int s = 0; s < kKB / 32; ++s) mma_k(acc, da + 2 * s, db + 2 * s, kb | s);
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        if (kb > 0) {
          // the previous K-block's product is done: release its slot
          asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
          fused_release(L, ring, full, taken, &q_map, &t_map, n - 1, steps, q0, t);
        }
      }
    }
    // The tile's row values, while its product runs, from the registers
    // loaded a tile ago; then the next tile's loads. `flag`: a row of
    // irregular norm (cos: the preselection goes off) or a penalty other than
    // 0 and MASKED (ip: no integer keys).
    const int row0 = i * kTileRows;
    Aux& ax = aux[i % 2];
    bool flag = false;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float tr = __fsqrt_rn(ts[j]);
      set_row<false>(ax, t + kWG * j, ts[j], tr, pen[j]);
      flag |= kMetric == kCos ? !regular_root(tr) : (pen[j] != 0.0f && pen[j] != kMasked);
    }
    load_rows<kMetric>(t_sq, penalty, row0 + kTileRows + t, n_rows, ts, pen);
    flag = warpgroup_or(flag, 1 + g);
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc(acc);
    if constexpr (kTF32) {
      fence_frags(qh);
      fence_frags(ql);
    }
    fused_release(L, ring, full, taken, &q_map, &t_map, (i + 1) * L.n_kb - 1, steps, q0, t);

    bool exact_all[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) exact_all[h] = (kMetric == kCos && flag) || odd[h];
    const bool keyed = kMetric == kIP && kSmall && !flag;
    float best[2][2];  // [bin][query]
    int arg[2][2];
    tile_minima<kMetric, false, kSmall>(acc, ax, keyed, c2, qs, qr, iqr, exact_all, best, arg);
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      if (b == 1 && 2 * i + 1 == n_bins) break;  // the half tile at an odd bin count's end
      const float v = own ? best[b][1] : best[b][0];
      const int id = row0 + (own ? arg[b][1] : arg[b][0]);
      if constexpr (kFlavour == kStore) {
        if (owner) {
          out_d[(size_t)(2 * i + b) * n_q + qi] = v;
          out_i[(size_t)(2 * i + b) * n_q + qi] = id;
        }
      } else if constexpr (kFlavour == kMerge) {
        if (owner) {
          cand_v[n_cand * kQT + col] = v;
          cand_i[n_cand * kQT + col] = id;
        }
        if (++n_cand == merge_every || 2 * i + b == n_bins - 1) {
          if (owner) merge(list_d, list_i, k, ls, thr, cand_v + col, cand_i + col, n_cand, kQT);
          n_cand = 0;
        }
      } else {
        if (owner) insert(list_d, list_i, k, ls, thr, v, id);
      }
    }
  }
  if (kFlavour != kStore && owner) {
    for (int j = 0; j < k; ++j) {
      const float d = list_d[j * ls];
      out_d[(size_t)qi * k + j] = d;
      out_i[(size_t)qi * k + j] = d >= kMasked / 2 ? -1 : list_i[j * ls];
    }
  }
}

int elem_bytes(int dtype) { return dtype == kI8 ? 1 : dtype == kBF16 ? 2 : dtype == kF32 ? 4 : 0; }

// The rows' bytes, a multiple of the 128-byte K-block, are checked by
// launch_fused_wgmma.
bool valid_shape(int n_q, int n_rows, int width, int dtype, int metric) {
  return n_q > 0 && n_rows > 0 && n_rows % kBin == 0 && metric >= kIP && metric <= kL2sq &&
         elem_bytes(dtype) > 0 && width > 0;
}

template <typename T, int kMetric, bool kSmall, int kFlavour>
int run_fused_wgmma(const CUtensorMap& q_map, const CUtensorMap& t_map, const float* q_sq, const float* t_sq,
                    const float* penalty, float* out_d, int* out_i, int n_q, int n_rows, int row_bytes, int k,
                    int merge_every, cudaStream_t s) {
  const FusedLayout L = fused_layout<kFlavour, std::is_same<T, float>::value>(row_bytes / kKB, merge_every, k);
  if (L.stages < 2) return cudaErrorInvalidValue;
  const auto kernel = fused_wgmma<T, kMetric, kSmall, kFlavour>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (err != cudaSuccess) return err;
  kernel<<<(n_q + kFQ - 1) / kFQ, kBlock, L.bytes, s>>>(q_map, t_map, q_sq, t_sq, penalty, out_d, out_i, n_q,
                                                        n_rows, row_bytes, k, merge_every);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kMetric, int kFlavour>
int fused_metric(const CUtensorMap& q_map, const CUtensorMap& t_map, const float* q_sq, const float* t_sq,
                 const float* penalty, float* out_d, int* out_i, int n_q, int n_rows, int row_bytes, int k,
                 int merge_every, cudaStream_t s) {
  if constexpr (std::is_same<T, int8_t>::value) {
    if (row_bytes <= 256)
      return run_fused_wgmma<T, kMetric, true, kFlavour>(q_map, t_map, q_sq, t_sq, penalty, out_d, out_i, n_q,
                                                         n_rows, row_bytes, k, merge_every, s);
  }
  return run_fused_wgmma<T, kMetric, false, kFlavour>(q_map, t_map, q_sq, t_sq, penalty, out_d, out_i, n_q, n_rows,
                                                      row_bytes, k, merge_every, s);
}

// B8/B9/B10 over i8, bf16 or f32 rows of `row_bytes` bytes, on the tensor
// cores.
template <typename T, int kFlavour>
int launch_fused_wgmma(const void* q, const void* table, const float* q_sq, const float* t_sq, const float* penalty,
                       float* out_d, int* out_i, int n_q, int n_rows, int row_bytes, int metric, int k,
                       int merge_every, cudaStream_t s) {
  if (row_bytes % kKB) return cudaErrorInvalidValue;
  CUtensorMap q_map, t_map;
  if (!tile_map(&q_map, q, row_bytes, n_q, kQT) || !tile_map(&t_map, table, row_bytes, n_rows, kTileRows))
    return cudaErrorInvalidValue;
  switch (metric) {
    case kIP:
      return fused_metric<T, kIP, kFlavour>(q_map, t_map, q_sq, t_sq, penalty, out_d, out_i, n_q, n_rows,
                                            row_bytes, k, merge_every, s);
    case kCos:
      return fused_metric<T, kCos, kFlavour>(q_map, t_map, q_sq, t_sq, penalty, out_d, out_i, n_q, n_rows,
                                             row_bytes, k, merge_every, s);
    default:
      return fused_metric<T, kL2sq, kFlavour>(q_map, t_map, q_sq, t_sq, penalty, out_d, out_i, n_q, n_rows,
                                              row_bytes, k, merge_every, s);
  }
}

template <bool kStream>
int fused(const void* q, const void* table, const float* q_sq, const float* t_sq, const float* penalty,
          float* out_d, int* out_i, int n_q, int n_rows, int width, int dtype, int metric, int k,
          int merge_every, void* stream) {
  if (!valid_shape(n_q, n_rows, width, dtype, metric) || k < 1 || k > kMaxK || merge_every < 1 ||
      merge_every > kMaxMerge)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kFlavour = kStream ? kMerge : kInsert;
  switch (dtype) {
    case kI8:
      return launch_fused_wgmma<int8_t, kFlavour>(q, table, q_sq, t_sq, penalty, out_d, out_i, n_q, n_rows, width,
                                                  metric, k, merge_every, s);
    case kBF16:
      return launch_fused_wgmma<__nv_bfloat16, kFlavour>(q, table, q_sq, t_sq, penalty, out_d, out_i, n_q, n_rows,
                                                         2 * width, metric, k, merge_every, s);
    default:
      return launch_fused_wgmma<float, kFlavour>(q, table, q_sq, t_sq, penalty, out_d, out_i, n_q, n_rows,
                                                 4 * width, metric, k, merge_every, s);
  }
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

// B10. out_v/out_i are [n_rows / 128, n_q]; rows must be a multiple of 128
// bytes.
int usearch_binned_scan_lanes(const void* q, const void* table, const float* q_sq, const float* t_sq,
                              const float* penalty, float* out_v, int* out_i, int n_q, int n_rows, int width,
                              int dtype, int metric, void* stream) {
  if (!valid_shape(n_q, n_rows, width, dtype, metric)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kI8:
      return launch_fused_wgmma<int8_t, kStore>(q, table, q_sq, t_sq, penalty, out_v, out_i, n_q, n_rows, width,
                                                metric, 0, 0, s);
    case kBF16:
      return launch_fused_wgmma<__nv_bfloat16, kStore>(q, table, q_sq, t_sq, penalty, out_v, out_i, n_q, n_rows,
                                                       2 * width, metric, 0, 0, s);
    default:
      return launch_fused_wgmma<float, kStore>(q, table, q_sq, t_sq, penalty, out_v, out_i, n_q, n_rows, 4 * width,
                                               metric, 0, 0, s);
  }
}

}  // extern "C"
