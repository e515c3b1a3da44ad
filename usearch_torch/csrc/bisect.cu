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
// Design: the cell design of B3's tensor-core kernel (csrc/probe.cu
// `grouped_wgmma`). A block of two warpgroups takes a cell; warpgroup g
// owns lanes [64 g, 64 g + 64), the M side of `wgmma`. The cell's 128 query
// rows are loaded once by TMA (rows of at most 512 bytes; wider rows stream
// their query K-blocks beside the table's). Every window inside the table
// is walked as 128-row tiles (a w_pad of 64 mod 128 ends in a half tile,
// whose rows past the window are read and left out), each tile's 128-byte
// K-blocks through one ring of TMA slots that both warpgroups read: every
// warp waits for every step and releases it, and the last of the eight to
// release a slot refills it. Each warpgroup runs `wgmma` m64n128k32 s8
// (exact int32) over every tile of every window, as the TPU kernel's matrix
// product covers every lane: no window or warpgroup is skipped. A thread
// then holds rows 8 j + c2 + e (j < 16, e < 2, c2 = 2 (l % 4)) of its two
// lanes, and a quad (the four threads of a lane) the lane's 128 rows; the
// selects run on these registers: a sel8 bin is one j across the quad (two
// rows a thread, then two xor shuffles), a 32-row bin four consecutive j (8
// rows a thread, then the quad), sel_none the c2 = 0 thread's row,
// dot_only rows 0-7 of the first tile into two f32 sums a lane and thread,
// in window order. Every lane's select runs in every window (an empty
// volatile asm takes its value, so it cannot be moved under the test); only
// the store depends on the lane's own window. A lane has one own window,
// so its entries are written straight to the output, which the block first
// fills with `init` in coalesced stores: no accumulator in shared memory. A
// window that does not lie inside the table is skipped (the TPU kernel's
// copy would fault).
//
// Bound on this card: the bytes of the table rows the windows touch, read
// once, plus the queries and the output; at the script's shape (10M x 128
// i8 rows, 1,024 queries x 16 probes, w_pad 1,408, 7,137 windows) 1.146 GB,
// 0.342 ms at the card's memory rate. The product of every window with
// every lane is 3.29e11 int8 operations, 0.166 ms at the tensor cores'
// int8 rate: the stream bounds it, with one cell a block and 128 cells.
//
// The entry point launches on the stream it is given, allocates nothing,
// and returns cudaGetLastError() after the launch.

#include "wgmma_common.cuh"

namespace {

constexpr int kLanes = 128;            // lanes (pairs) of a cell
constexpr int kMaxOutPad = 320;
constexpr int kBinStage = kBin * kKB;  // 16 KB: one K-block of a tile's 128 rows
constexpr int kMaxStages = 8;          // slots of the ring
constexpr int kResidentKB = 4;         // K-blocks of the query tile kept for the block

enum Variant { kDotOnly = 0, kSelNone = 1, kSel8 = 2, kSel32 = 3, kSel32f = 4 };

struct BisectParams {
  const int* meta;  // [cells, meta_rows, 128]: row 0 window starts, row 3 the window count
  const float* qa;  // [cells * 128, 8]: column 2 the lane's own window
  float* out;       // [cells * 128, out_pad]
  int meta_rows, n_rows, n_kb, w_pad, out_pad;
  float init;
};

// Shared memory of one block: the resident query tile (or none), the ring
// of `stages` slots (a tile's K-block, then the two query K-blocks when the
// queries stream), the windows inside the table, and the barriers: a full
// barrier per slot and one for the query tile, then a counter per slot.
struct BisectLayout {
  int stages, stage_bytes, ring_off, win_off, bar_off, bytes;
  bool resident;
};

__host__ __device__ __forceinline__ BisectLayout bisect_layout(int n_kb) {
  BisectLayout L;
  L.resident = n_kb <= kResidentKB;
  L.ring_off = L.resident ? 2 * n_kb * kQStage : 0;
  L.stage_bytes = kBinStage + (L.resident ? 0 : 2 * kQStage);
  const int fixed = 1024 + 256 + 1024;  // windows, barriers, slack to align the base to 1 KB
  const int room = (kSmem - fixed - L.ring_off) / L.stage_bytes;
  L.stages = room < kMaxStages ? room : kMaxStages;
  L.win_off = L.ring_off + L.stages * L.stage_bytes;
  L.bar_off = L.win_off + 1024;
  L.bytes = L.bar_off + 256 + 1024;
  return L;
}

// The windows of a cell inside the table, in window order: the first `lo`
// of them are windows below 127 (index `w`, first row `st`); windows 127 to
// n_win - 1 share meta[c, 0, 127] and follow when it lies inside.
struct Windows {
  int *w, *st, *info;  // info: four ballot masks, then lo
};

__device__ __forceinline__ Windows windows_at(uint8_t* base) {
  Windows W;
  W.w = reinterpret_cast<int*>(base);
  W.st = W.w + kLanes;
  W.info = W.st + kLanes;
  return W;
}

// Window v of the walk: its index and first row.
__device__ __forceinline__ int window_index(const Windows& W, int lo, int v) {
  return v < lo ? W.w[v] : kLanes - 1 + (v - lo);
}
__device__ __forceinline__ int window_start(const Windows& W, int lo, int last_st, int v) {
  return v < lo ? W.st[v] : last_st;
}

__device__ __forceinline__ void wg0_sync() { asm volatile("bar.sync 1, 128;" ::: "memory"); }

// Fills ring slot n % stages with step n of the walk: K-block n % n_kb of
// the tile at row0, and the block's two query K-blocks when the queries
// stream. One thread issues it.
__device__ __forceinline__ void bisect_fill(const BisectLayout& L, int n_kb, uint8_t* ring, uint64_t* full,
                                            const CUtensorMap* q_map, const CUtensorMap* t_map, int n, int row0,
                                            int q0) {
  const int slot = n % L.stages;
  const int kb = n % n_kb;
  uint8_t* buf = ring + slot * L.stage_bytes;
  mbar_expect_tx(full + slot, L.stage_bytes);
  tma_load(buf, t_map, kb * kKB, row0, full + slot);
  if (!L.resident)
    for (int h = 0; h < 2; ++h) tma_load(buf + kBinStage + h * kQStage, q_map, kb * kKB, q0 + kQT * h, full + slot);
}

// The first table row of step n: tile (n / n_kb) % nt of window n / (nt n_kb).
__device__ __forceinline__ int step_row(const Windows& W, int lo, int last_st, int n, int n_kb, int nt) {
  const int tile = n / n_kb;
  return window_start(W, lo, last_st, tile / nt) + (tile % nt) * kBin;
}

// One warp is done with step n's slot: the last of the block's eight warps
// to say so (a counter per slot) refills it with step n + stages. Every
// warp waits for every step in order, so no wait meets a slot a phase
// behind or two ahead.
__device__ __forceinline__ void bisect_release(const BisectLayout& L, int n_kb, int nt, uint8_t* ring, uint64_t* full,
                                               uint32_t* taken, const CUtensorMap* q_map, const CUtensorMap* t_map,
                                               const Windows& W, int lo, int last_st, int n, int steps, int q0) {
  __syncwarp();
  if (threadIdx.x % 32 != 0) return;
  constexpr uint32_t kUsers = kBlock / 32;
  // The warp's products that read the slot are complete (wgmma.wait_group)
  // and nothing else of the block reads it, so a plain counter orders the
  // refill after them.
  const uint32_t old = atomicAdd(taken + n % L.stages, 1u);
  const int m = n + L.stages;
  if (old % kUsers == kUsers - 1 && m < steps)
    bisect_fill(L, n_kb, ring, full, q_map, t_map, m, step_row(W, lo, last_st, m, n_kb, nt), q0);
}

// v reaches the output only where `own`, but is computed whatever own is.
__device__ __forceinline__ void keep_if_own(float* out, int entry, float v, bool own) {
  asm volatile("" ::"f"(v));
  if (own) out[entry] = v;
}

__device__ __forceinline__ int packed_key(int dot, int row) {
  return static_cast<int>(((0u - static_cast<uint32_t>(dot)) << 5) | static_cast<uint32_t>(row));
}

// The variant's select over one tile (tile tt of the window, its first
// `rows` rows inside it: 128, or 64 for a half last tile) from this
// thread's accumulators: rows 8 j + c2 + e of lanes lane0 + 8 h, acc[4 j +
// 2 h + e]; out_h the output rows of the two lanes, q4 = l % 4.
template <int kV>
__device__ __forceinline__ void tile_select(const int (&acc)[64], int tt, int rows, const bool (&own)[2],
                                            float (&sum)[2][2], float* const (&out_h)[2], int q4, int c2) {
  if constexpr (kV == kDotOnly) {
    if (tt == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) sum[h][e] = __fadd_rn(sum[h][e], __int2float_rn(acc[2 * h + e]));
    }
  } else if constexpr (kV == kSelNone) {
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) {
      if (32 * bb >= rows) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) keep_if_own(out_h[h], 4 * tt + bb, __int2float_rn(acc[16 * bb + 2 * h]), own[h] && q4 == 0);
    }
  } else if constexpr (kV == kSel8) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (8 * j >= rows) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int m = min(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        m = min(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = min(m, __shfl_xor_sync(0xffffffffu, m, 2));
        keep_if_own(out_h[h], 16 * tt + j, __int2float_rn(m), own[h] && q4 == (j & 3));
      }
    }
  } else if constexpr (kV == kSel32) {
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) {
      if (32 * bb >= rows) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int m = packed_key(acc[16 * bb + 2 * h], c2);
#pragma unroll
        for (int r = 1; r < 8; ++r)
          m = min(m, packed_key(acc[16 * bb + 4 * (r / 2) + 2 * h + r % 2], 8 * (r / 2) + c2 + r % 2));
        m = min(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = min(m, __shfl_xor_sync(0xffffffffu, m, 2));
        keep_if_own(out_h[h], 4 * tt + bb, __int2float_rn(m), own[h] && q4 == bb);
      }
    }
  } else {
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) {
      if (32 * bb >= rows) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // the thread's rows in ascending order, '<': its first minimum
        float m = __int2float_rn(acc[16 * bb + 2 * h]);
        int am = c2;
#pragma unroll
        for (int r = 1; r < 8; ++r) {
          const float v = __int2float_rn(acc[16 * bb + 4 * (r / 2) + 2 * h + r % 2]);
          if (v < m) {
            m = v;
            am = 8 * (r / 2) + c2 + r % 2;
          }
        }
        // the quad's: (value, row) in lexicographic order
#pragma unroll
        for (int s = 1; s <= 2; s *= 2) {
          const float om = __shfl_xor_sync(0xffffffffu, m, s);
          const int oa = __shfl_xor_sync(0xffffffffu, am, s);
          if (om < m || (om == m && oa < am)) {
            m = om;
            am = oa;
          }
        }
        keep_if_own(out_h[h], 4 * tt + bb, __fadd_rn(m, __int2float_rn(am)), own[h] && q4 == bb);
      }
    }
  }
}

template <int kV>
__global__ void __launch_bounds__(kBlock, 1)
bisect_wgmma(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap t_map,
             const BisectParams p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const BisectLayout L = bisect_layout(p.n_kb);
  uint8_t* ring = smem + L.ring_off;
  const Windows W = windows_at(smem + L.win_off);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar_off);
  uint64_t* q_bar = full + L.stages;
  uint32_t* taken = reinterpret_cast<uint32_t*>(q_bar + 1);

  const int tid = threadIdx.x;
  const int g = tid / kWG;
  const int warp = (tid % kWG) / 32;
  const int l = tid % 32;
  const size_t cell = blockIdx.x;
  const int q0 = static_cast<int>(cell) * kLanes;
  const int* meta = p.meta + cell * p.meta_rows * kLanes;
  const int n_win = meta[3 * kLanes];
  const int nt = (p.w_pad + kBin - 1) / kBin;  // tiles of a window
  const int n_kb = p.n_kb;

  // init everywhere first, in coalesced stores; the lanes' entries follow
  float* out = p.out + cell * kLanes * p.out_pad;
  for (int e = tid; e < kLanes * p.out_pad; e += kBlock) out[e] = p.init;

  const int last_st = meta[kLanes - 1];
  const bool last_in = last_st >= 0 && last_st <= p.n_rows - p.w_pad;
  if (tid < kLanes) {
    // the windows below 127 inside the table, in order: a ballot per warp
    const int st = meta[tid];
    const bool in = tid < n_win && tid < kLanes - 1 && st >= 0 && st <= p.n_rows - p.w_pad;
    const unsigned mask = __ballot_sync(0xffffffffu, in);
    if (l == 0) W.info[warp] = static_cast<int>(mask);
    wg0_sync();
    int pos = __popc(mask & ((1u << l) - 1u));
    for (int w = 0; w < warp; ++w) pos += __popc(W.info[w]);
    if (in) {
      W.w[pos] = tid;
      W.st[pos] = st;
    }
    if (tid == 0) W.info[4] = __popc(W.info[0]) + __popc(W.info[1]) + __popc(W.info[2]) + __popc(W.info[3]);
  }
  if (tid == 0) {
    for (int i = 0; i < L.stages + 1; ++i) mbar_init(full + i, 1);
    for (int i = 0; i < L.stages; ++i) taken[i] = 0;
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int lo = W.info[4];
  const int wins = lo + (n_win > kLanes - 1 && last_in ? n_win - (kLanes - 1) : 0);
  const int steps = wins * nt * n_kb;
  if (tid == 0 && steps > 0) {
    if (L.resident) {
      mbar_expect_tx(q_bar, 2 * n_kb * kQStage);
      for (int h = 0; h < 2; ++h)
        for (int kb = 0; kb < n_kb; ++kb)
          tma_load(smem + (h * n_kb + kb) * kQStage, &q_map, kb * kKB, q0 + kQT * h, q_bar);
    }
    for (int n = 0; n < L.stages && n < steps; ++n)
      bisect_fill(L, n_kb, ring, full, &q_map, &t_map, n, step_row(W, lo, last_st, n, n_kb, nt), q0);
  }

  // this thread's lanes (rows of its accumulators): lane0 and lane0 + 8
  const int lane0 = kQT * g + 16 * warp + l / 4;
  const int q4 = l % 4, c2 = 2 * q4;
  float own_w[2];
  float* out_h[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    own_w[h] = p.qa[(cell * kLanes + lane0 + 8 * h) * 8 + 2];
    out_h[h] = out + static_cast<size_t>(lane0 + 8 * h) * p.out_pad;
  }
  float sum[2][2] = {{p.init, p.init}, {p.init, p.init}};
  if (L.resident && steps > 0) mbar_wait(q_bar, 0);

  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  int n = 0;  // steps of the walk so far
  for (int v = 0; v < wins; ++v) {
    const float wf = static_cast<float>(window_index(W, lo, v));
    const bool own[2] = {own_w[0] == wf, own_w[1] == wf};
    for (int tt = 0; tt < nt; ++tt) {
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
      for (int kb = 0; kb < n_kb; ++kb, ++n) {
        const int slot = n % L.stages;
        mbar_wait(full + slot, (n / L.stages) & 1);
        const uint32_t ta = smem_addr(ring + slot * L.stage_bytes);
        const uint32_t qa = L.resident ? smem_addr(smem + (g * n_kb + kb) * kQStage) : ta + kBinStage + g * kQStage;
        const uint64_t da = sw128_desc(qa), db = sw128_desc(ta);
#pragma unroll
        for (int k = 0; k < kKB / 32; ++k) mma_k(acc, da + 2 * k, db + 2 * k, kb | k);
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        if (kb > 0) {
          // the previous K-block's product is done: release its slot
          asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
          bisect_release(L, n_kb, nt, ring, full, taken, &q_map, &t_map, W, lo, last_st, n - 1, steps, q0);
        }
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_acc(acc);
      bisect_release(L, n_kb, nt, ring, full, taken, &q_map, &t_map, W, lo, last_st, n - 1, steps, q0);
      const int rows = p.w_pad - tt * kBin < kBin ? p.w_pad - tt * kBin : kBin;
      tile_select<kV>(acc, tt, rows, own, sum, out_h, q4, c2);
    }
  }
  if constexpr (kV == kDotOnly) {
    // after the fill, which the block's barrier above ordered first
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) out_h[h][c2 + e] = sum[h][e];
  }
}

template <int kV>
int launch(const void* q, const void* table, const BisectParams& p, int cells, int width, cudaStream_t stream) {
  CUtensorMap q_map, t_map;
  if (!tile_map(&q_map, q, width, cells * kLanes, kQT) || !tile_map(&t_map, table, width, p.n_rows, kBin))
    return cudaErrorInvalidValue;
  const BisectLayout L = bisect_layout(p.n_kb);
  if (L.stages < 2) return cudaErrorInvalidValue;
  auto kernel = bisect_wgmma<kV>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<cells, kBlock, L.bytes, stream>>>(q_map, t_map, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// B13. meta: [cells, meta_rows >= 4, 128] int32; q: [cells * 128, width]
// i8; qa: [cells * 128, 8] f32; table: [n_rows, width] i8, width a multiple
// of 128, q and table 16-byte aligned; out: [cells * 128, out_pad] f32,
// out_pad <= 320 and at least the variant's entries (8; w_pad / 8 for sel8;
// w_pad / 32 otherwise); w_pad a multiple of 64.
int usearch_bisect_probe(const int* meta, const void* q, const float* qa, const void* table, float* out, int cells,
                         int meta_rows, int n_rows, int width, int w_pad, int out_pad, int variant, float init,
                         void* stream) {
  const int entries = variant == kDotOnly ? 8 : variant == kSel8 ? w_pad / 8 : w_pad / 32;
  if (cells <= 0 || meta_rows < 4 || n_rows <= 0 || width <= 0 || width % kKB || w_pad <= 0 || w_pad % 64 ||
      out_pad > kMaxOutPad || out_pad < entries || variant < kDotOnly || variant > kSel32f)
    return cudaErrorInvalidValue;
  const BisectParams p{meta, qa, out, meta_rows, n_rows, width / kKB, w_pad, out_pad, init};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kDotOnly:
      return launch<kDotOnly>(q, table, p, cells, width, s);
    case kSelNone:
      return launch<kSelNone>(q, table, p, cells, width, s);
    case kSel8:
      return launch<kSel8>(q, table, p, cells, width, s);
    case kSel32:
      return launch<kSel32>(q, table, p, cells, width, s);
    default:
      return launch<kSel32f>(q, table, p, cells, width, s);
  }
}

}  // extern "C"
