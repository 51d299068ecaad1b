// Fused embedding engine on Hopper: the lookup (value ids + D' sets and
// support for lma -> pool gather, optionally bag-pooled with weights), the
// three backward-side entry points that share its slot function, and the
// three of the chunked exchange (a pool sharded over the 'model' axis).
//
// Replaces the TPU kernels of repro/kernels/fused_embed/kernel.py:
//   fused_lookup_launch        <- _fwd_kernel (fused_lookup_fwd_pallas)
//   fused_locations_launch     <- _locations_kernel (fused_locations_pallas)
//   fused_scatter_add_launch   <- _scatter_kernel (fused_scatter_add_pallas)
//   fused_weight_grad_launch   <- _weight_grad_kernel (fused_weight_grad_pallas)
//   fused_chunk_lookup_launch  <- _chunk_fwd_kernel (fused_chunk_fwd_pallas)
//   fused_chunk_gather_launch  <- _gather_loc_kernel (fused_chunk_gather_pallas)
//   fused_chunk_scatter_launch <- _scatter_loc_kernel (fused_chunk_scatter_pallas)
// Same function: lma locations with the very-sparse A_h fallback (support <
// min_support -> hash_pair(v, i) under seed ^ 0x1234567, striped when
// stripe > 0), or hashed_elem / hashed_row locations; then the gather M[loc]
// written as [N, d], or with weights the bag sum over L accumulated on chip
// and written as [B, d].  The [N, d] locations and the [B, L, d] pre-pool
// tensor never reach device memory, except where the locations ARE the
// output (fused_locations: the SparseGrad's indices; the chunk lookup: the
// locations the ring circulates).
//
// Slab mode (the lookup, the scatter-add and the three chunk entry points):
// `mem` / `dmem` is one rank's [m_local] slab of the pool, starting at
// global slot `base`.  A location outside [base, base + m_local) gathers an
// exact 0 and scatters nothing (the reference's mask-local-gather).  The
// single-card callers pass base = 0 and m_local = m, where the mask is all
// true.  The TPU kernels tiled the slab into VMEM-sized blocks (a second
// grid axis) so that an over-budget slab still fused; here the gather reads
// device memory directly, so each element is one masked load and there is
// no slab tiling.
//
// What bounds it on Hopper: for lma, integer ALU issue.  Per looked-up
// value it evaluates d*n_h*S hashes of ~15 int32 operations (8,192 hashes,
// ~123K operations at dlrm-rm2's d=64, n_h=4, S=32) against ~650 bytes that
// must move (the set row, id and support in; d gathered floats; d floats
// out).  The design follows that: one warp per value, the set compacted
// into shared memory once (hash_core.cuh), the hash chain in registers,
// fallback rows skip the minhash entirely (a warp-uniform branch), and each
// lane owns its columns, so a warp's gathers, stores and atomics cover
// adjacent slots of a stripe row-wise.  hashed_* schemes are gather-bound
// and take the same path with no minhash.  A lookup of few rows (an LM's
// decode, 1-128 tokens; a rank's chunk of an exchange, 1-512 rows) splits
// each row's columns into tiles, one warp per (row, tile): one warp a row
// would leave most of the 132 SMs idle while each lane walks d / 32 columns
// in series.  Rows enough to fill the card keep one tile a row.  The flat
// lookup, the locations and the chunk lookup share that walk (`tile_walk`,
// `value_columns`); the bag lookup takes it too, its tile's sums in shared
// memory.  The chunk gather and scatter (given locations, no hashing) are
// bound by bytes: one thread per element, neighbouring threads on
// neighbouring locations and outputs.
//
// Backward:
//   - scatter-add: dM[loc] += g (bag: g * w, product first) with atomicAdd
//     into the [m_local] buffer, which the kernel zeroes itself (the TPU
//     kernel's _init; the wrapper allocates it with torch.empty).  At
//     dlrm-rm2's m that fill is 540 MB, ~0.17 ms of HBM writes that a
//     separate fill serialised before the hashing.  So the kernel is one
//     persistent cooperative grid (every block an SM holds, on every SM,
//     whatever the row count) around one grid barrier: before it, warp 0
//     of each block has the copy engine write the block's share of zeros
//     (bulk copies from shared memory) while warps 1-7 hash their first
//     values and stage the slots in shared memory; after it, the rest is
//     hashed and added, then the staged slots are added.  Its work items
//     are the lookup's (row, column tile) units, each value apart: each
//     block owns a share of the first half, which its warps take from a
//     shared-memory counter, and the second half goes in chunks to
//     whichever warps are free, so the SMs end together.  The sum order
//     over colliding values
//     follows the atomics, so it is not deterministic; hot slots
//     (small-vocabulary fields, LMA's shared slots) contend in L2;
//   - weight grad: dw[b, l] = <g[b], M[loc[b, l]]>, a warp per value (b,
//     l), products summed per lane, then across the warp by shuffles;
//   - chunk scatter: dM[loc - base] += g by given locations, atomicAdd into
//     the zeroed [m_local] slab, one thread per element.
// The locations (the slot function written to [N, d] int32, no gather) are
// the SparseGrad's indices and take the lookup's tiled walk.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hash_core.cuh"

namespace {

constexpr int WARPS_PER_BLOCK = 8;
// The scatter-add's staging: slots a warp holds across the grid barrier
// (1.25 KB a warp), STAGE_ROUNDS a lane.
constexpr int STAGE_SLOTS = 320;
constexpr int STAGE_ROUNDS = STAGE_SLOTS / lma::WARP;
// ... and its block's zeros, the source of its bulk copies into dM
constexpr int ZERO_BYTES = 4096;
constexpr int ZERO_F4 = ZERO_BYTES / 16;
// ... and the rate of this kernel's own fill on an H100 (its bulk copies
// of 540 MB with no rows to hash: ~0.21 ms, which chip_smoke.py logs
// beside row 5), which sets how long warps 1-7 stage: a constant of that
// card, not a setting; on another card only the time moves
constexpr double FILL_BYTES_PER_NS = 2.5;
// ... and its balance: the grid's last 1/TAIL_SHARE of the items go to
// whichever warps are free, in chunks of up to 8 (one chunk a warp per
// TAIL_CHUNK_ITEMS of a warp's items)
constexpr int TAIL_SHARE = 2;
constexpr int TAIL_CHUNK_ITEMS = 4;
enum Scheme { LMA = 0, HASHED_ELEM = 1, HASHED_ROW = 2 };

struct FusedArgs {
  int scheme;
  int min_support;
  lma::LmaArgs a;
};

// mem[loc - base] when loc lies in the [m_local] slab from base, else 0
__device__ __forceinline__ float slab_read(const float* __restrict__ mem,
                                           int32_t loc, int base,
                                           int m_local) {
  const unsigned rel = static_cast<unsigned>(loc - base);
  return rel < static_cast<unsigned>(m_local) ? __ldg(mem + rel) : 0.0f;
}

// dmem[loc - base] += g when loc lies in the [m_local] slab from base
__device__ __forceinline__ void slab_add(float* dmem, int32_t loc, int base,
                                         int m_local, float g) {
  const unsigned rel = static_cast<unsigned>(loc - base);
  if (rel < static_cast<unsigned>(m_local)) atomicAdd(dmem + rel, g);
}

// one pool slot of value v, column c; `n` is the staged set size
__device__ __forceinline__ int32_t slot(const FusedArgs& f, bool fallback,
                                        const uint32_t* set, int n,
                                        uint32_t gid, int c) {
  if (f.scheme == HASHED_ROW)
    return lma::hashed_row_column(gid, c, f.a.d, f.a.seed, f.a.m);
  if (f.scheme == HASHED_ELEM)
    return lma::hashed_elem_column(gid, c, f.a.seed, f.a.m, f.a.stripe);
  if (fallback)
    return lma::hashed_elem_column(gid, c, f.a.seed ^ lma::FALLBACK_XOR,
                                   f.a.m, f.a.stripe);
  return lma::lma_column(set, n, c, f.a);
}

// One value as the warp sees it: its id, whether the fallback applies, and
// (lma, no fallback) its set staged at `set` with n elements.
struct Value {
  uint32_t gid;
  bool fallback;
  int n;
};

__device__ __forceinline__ Value load_value(const FusedArgs& f,
                                            const uint32_t* sets,
                                            const int32_t* gids,
                                            const int32_t* support, size_t v,
                                            int S, uint32_t* set, int lane) {
  Value x{static_cast<uint32_t>(gids[v]),
          f.scheme == LMA && support[v] < f.min_support, 0};
  if (f.scheme == LMA && !x.fallback)   // warp-uniform branch
    x.n = lma::stage_set(sets + v * S, S, set, lane);
  return x;
}

// The (row, column tile) walk of the lookup, the locations and the chunk
// lookup.  Warp u of the grid owns row u / n_tiles and the columns [c0, c1)
// of tile u % n_tiles: `tile` adjacent columns (the binding's lookup_tile:
// d, one tile a row, when the rows alone fill the card; else 32, so that a
// few rows still give every SM several warps; d or any multiple of 32 is
// taken).  A row's tiles go to adjacent warps.  `unit(row, c0, c1)` runs on
// all 32 lanes of the warp.
template <typename Unit>
__device__ __forceinline__ void tile_walk(int rows, int d, int tile,
                                          Unit unit) {
  const int n_tiles = (d + tile - 1) / tile;
  const int units = rows * n_tiles;
  const int stride = gridDim.x * WARPS_PER_BLOCK;
  for (int u = blockIdx.x * WARPS_PER_BLOCK + threadIdx.x / lma::WARP;
       u < units; u += stride) {
    const int row = u / n_tiles;
    const int c0 = (u - row * n_tiles) * tile;
    unit(row, c0, min(d, c0 + tile));
  }
}

// Value v's slots over the columns [c0, c1).  The warp stages the value's
// set itself (one coalesced load of at most S words, from L2 after the
// row's first tile), then lane l calls emit(c, slot) for c = c0 + l,
// c0 + l + 32, ...: adjacent lanes on adjacent columns, so the writes
// coalesce.  An output element depends only on its value and column, so
// every tiling writes the same bits.
template <typename Emit>
__device__ __forceinline__ void value_columns(
    const FusedArgs& f, const uint32_t* sets, const int32_t* gids,
    const int32_t* support, size_t v, int S, uint32_t* set, int c0, int c1,
    Emit emit) {
  const int lane = threadIdx.x % lma::WARP;
  const Value x = load_value(f, sets, gids, support, v, S, set, lane);
  for (int c = c0 + lane; c < c1; c += lma::WARP)
    emit(c, slot(f, x.fallback, set, x.n, x.gid, c));
  __syncwarp();  // the set buffer is restaged for the next value
}

// rows: B output rows of L values each (L = 1 and weights == nullptr for
// the flat lookup).  sets [B*L, S] (lma only), gids/support [B*L].  A bag
// sums its tile's columns in l order (its own column's sum only, so the
// tiling keeps the bits).
__global__ void fused_lookup_kernel(const uint32_t* __restrict__ sets,
                                    const int32_t* __restrict__ gids,
                                    const int32_t* __restrict__ support,
                                    const float* __restrict__ weights,
                                    const float* __restrict__ mem, int B,
                                    int L, int S, int base, int m_local,
                                    int tile, FusedArgs f,
                                    float* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  const int d = f.a.d;
  const int warp = threadIdx.x / lma::WARP, lane = threadIdx.x % lma::WARP;
  // a warp's set, then (bag only) its tile's sums: lookup_smem's layout
  uint32_t* set = smem + warp * (weights ? S + tile : S);
  float* acc = reinterpret_cast<float*>(set + S);  // bag sums, own columns
  tile_walk(B, d, tile, [&](int b, int c0, int c1) {
    if (weights)
      for (int c = c0 + lane; c < c1; c += lma::WARP) acc[c - c0] = 0.0f;
    for (int l = 0; l < L; ++l) {
      const size_t v = static_cast<size_t>(b) * L + l;
      const float w = weights ? weights[v] : 0.0f;
      value_columns(f, sets, gids, support, v, S, set, c0, c1,
                    [&](int c, int32_t s) {
        const float e = slab_read(mem, s, base, m_local);
        if (weights)  // product, then sum: no fused multiply-add
          acc[c - c0] = __fadd_rn(acc[c - c0], __fmul_rn(w, e));
        else
          out[v * d + c] = e;
      });
    }
    if (weights)
      for (int c = c0 + lane; c < c1; c += lma::WARP)
        out[static_cast<size_t>(b) * d + c] = acc[c - c0];
  });
}

// out [N, d] int32: the slot of every (value, column).
// The bounds (256 threads, 6 blocks an SM) are a hint to ptxas, measured:
// without them it fit this kernel and the chunk lookup in 32 registers by
// computing the minhash's four unrolled hashes one after another (a lane's
// 64 columns of d = 2,048 in series took 1.6-2.2x as long); with them it
// interleaves the four, in the same 32 registers (8 blocks an SM).
__global__ void __launch_bounds__(WARPS_PER_BLOCK * lma::WARP, 6)
fused_locations_kernel(const uint32_t* __restrict__ sets,
                       const int32_t* __restrict__ gids,
                       const int32_t* __restrict__ support, int N, int S,
                       int tile, FusedArgs f, int32_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  const int d = f.a.d;
  uint32_t* set = smem + threadIdx.x / lma::WARP * S;
  tile_walk(N, d, tile, [&](int v, int c0, int c1) {
    value_columns(f, sets, gids, support, v, S, set, c0, c1,
                  [&](int c, int32_t s) {
      out[static_cast<size_t>(v) * d + c] = s;
    });
  });
}

// One bulk copy (the copy engine, async proxy) of `bytes` from shared
// memory to global; completion is awaited with bulk_wait.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(static_cast<uint32_t>(__cvta_generic_to_shared(src))), "r"(bytes)
      : "memory");
}

// Wait for this thread's bulk copies to complete, then order their writes
// before the thread's later generic accesses (and, through a barrier, the
// grid's).
__device__ __forceinline__ void bulk_wait() {
  asm volatile(
      "cp.async.bulk.commit_group;\n"
      "cp.async.bulk.wait_group 0;\n"
      "fence.proxy.async.global;\n" ::: "memory");
}

// The card's global nanosecond timer.
__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The next work item of the block's queue, for the whole warp: lane 0
// takes it from the shared counter, the lanes share it.
__device__ __forceinline__ int take(int* queue, int lane) {
  int q = 0;
  if (lane == 0) q = atomicAdd(queue, 1);
  return __shfl_sync(0xFFFFFFFFu, q, 0);
}

// dmem[slot(b*L + l, c) - base] += g[b, c] (* weights[b, l]) for in-slab
// slots, dmem [m_local] zeroed here.  Flat: L == 1, weights == nullptr.
// Launched cooperatively on a grid that the card holds at once.  Work
// items are the lookup's units, each value apart: item q is value
// l = q % L of unit u = q / L (row u / n_tiles, column tile u % n_tiles);
// an item of k columns is ceil(k / 32) slots a lane ("rounds").  Block b
// owns the items [n_own * b / grid, n_own * (b + 1) / grid) of the first
// n_own = n - n / TAIL_SHARE, which its warps take from a counter in
// shared memory, so a warp whose values hash fast takes more of them; the
// rest, the grid's tail, go to the warps whose blocks run out first, from
// a counter in global memory (`tail`), so that the SMs end together.
//   1. Warp 0 hands the block's 1/grid share of dmem to the copy engine,
//      as bulk copies of ZERO_BYTES of zeroed shared memory, and waits
//      for them (issuing them alone stalls it while the engine drains).
//   2. Meanwhile warps 1-7 take items and stage their slots (round r of
//      lane j at staged[r * 32 + j]) while they have room for a whole
//      tile's and the fill runs: until the block's copies have landed and
//      the grid's should have (m_local floats at FILL_BYTES_PER_NS), so
//      that no warp idles long at the barrier.
//   3. The grid barrier: every block's zeros are in dmem.
//   4. Each warp hashes and adds the block's other items, then the
//      tail's, both a chunk at a time, then adds its staged ones (g and w
//      re-read): last, since their atomics read dM's lines back from
//      memory and, all run at once after the barrier, stalled every warp
//      together.
__global__ void __launch_bounds__(WARPS_PER_BLOCK * lma::WARP, 6)
fused_scatter_kernel(const uint32_t* __restrict__ sets,
                     const int32_t* __restrict__ gids,
                     const int32_t* __restrict__ support,
                     const float* __restrict__ weights,
                     const float* __restrict__ g, int B, int L, int S,
                     int base, int m_local, int tile, FusedArgs f,
                     float* __restrict__ dmem, int* __restrict__ tail) {
  extern __shared__ float4 zeros[];     // ZERO_BYTES, then the warps' own
  __shared__ int queue;
  __shared__ volatile int filled;       // warp 0's copies have landed
  const int d = f.a.d;
  const int warp = threadIdx.x / lma::WARP, lane = threadIdx.x % lma::WARP;
  uint32_t* set = reinterpret_cast<uint32_t*>(zeros + ZERO_F4) + warp * S;
  int32_t* staged = reinterpret_cast<int32_t*>(
                        reinterpret_cast<uint32_t*>(zeros + ZERO_F4) +
                        WARPS_PER_BLOCK * S) +
                    warp * (STAGE_SLOTS + STAGE_ROUNDS);
  int32_t* items = staged + STAGE_SLOTS;     // the staged items, in order

  const int n_tiles = (d + tile - 1) / tile;
  const int n_items = B * n_tiles * L;     // < 2^30: the launch checks
  const int64_t n_own = n_items - n_items / TAIL_SHARE;
  const int lo = static_cast<int>(n_own * blockIdx.x / gridDim.x);
  const int hi = static_cast<int>(n_own * (blockIdx.x + 1) / gridDim.x);
  const int chunk =
      max(1, min(8, n_items / (static_cast<int>(gridDim.x) *
                               WARPS_PER_BLOCK * TAIL_CHUNK_ITEMS)));
  for (int i = threadIdx.x; i < ZERO_F4; i += blockDim.x)
    zeros[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (threadIdx.x == 0) {
    queue = lo;
    filled = 0;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  // item q: its value, row and columns [c0, c1) (no divisions for the
  // flat one-tile walk: value, row and item are one)
  const bool whole = L == 1 && n_tiles == 1;
  auto item = [&](int q, size_t& v, int& b, int& c0, int& c1) {
    if (whole) {
      b = q;
      c0 = 0;
      c1 = d;
      v = q;
      return;
    }
    const int u = q / L;
    b = u / n_tiles;
    c0 = (u - b * n_tiles) * tile;
    c1 = min(d, c0 + tile);
    v = static_cast<size_t>(b) * L + (q - u * L);
  };
  int n_staged = 0, used = 0;
  if (warp == 0) {
    // the fill: this block's share of dmem's float4s by the copy engine;
    // the floats past them (at most 3) are block 0's
    const int64_t n4 = m_local / 4;
    if (lane == 0) {
      float4* d4 = reinterpret_cast<float4*>(dmem);
      const int64_t z1 = n4 * (blockIdx.x + 1) / gridDim.x;
      for (int64_t z = n4 * blockIdx.x / gridDim.x; z < z1; z += ZERO_F4)
        bulk_store(d4 + z, zeros,
                   static_cast<uint32_t>(z1 - z < ZERO_F4 ? z1 - z
                                                          : ZERO_F4) *
                       16u);
      bulk_wait();
      filled = 1;
    }
    if (blockIdx.x == 0 && lane < m_local - 4 * n4)
      dmem[4 * n4 + lane] = 0.0f;
  } else {
    // the other warps stage while the fill runs and they have room
    const int k_max = (min(tile, d) + lma::WARP - 1) / lma::WARP;
    const uint64_t until =
        now_ns() + static_cast<uint64_t>(m_local * sizeof(float) /
                                         FILL_BYTES_PER_NS);
    while (used + k_max <= STAGE_ROUNDS &&
           __shfl_sync(0xFFFFFFFFu,
                       lane == 0 && (!filled || now_ns() < until), 0)) {
      const int q = take(&queue, lane);
      if (q >= hi) break;
      size_t v;
      int b, c0, c1;
      item(q, v, b, c0, c1);
      value_columns(f, sets, gids, support, v, S, set, c0, c1,
                    [&](int c, int32_t s) {
        staged[(used + (c - c0) / lma::WARP) * lma::WARP + lane] = s;
      });
      if (lane == 0) items[n_staged] = q;
      used += (c1 - c0 + lma::WARP - 1) / lma::WARP;
      ++n_staged;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *tail = static_cast<int>(n_own);
  cooperative_groups::this_grid().sync();

  // [q, end): the warp's items in hand; the block's own first, then
  // chunks of the grid's tail
  for (int q = 0, end = 0;; ++q) {
    if (q >= end) {
      int t = 0, e = 0;
      if (lane == 0) {
        t = atomicAdd(&queue, chunk);
        e = min(t + chunk, hi);
        if (t >= hi) {
          t = atomicAdd(tail, chunk);
          e = min(t + chunk, n_items);
        }
      }
      q = __shfl_sync(0xFFFFFFFFu, t, 0);
      end = __shfl_sync(0xFFFFFFFFu, e, 0);
      if (q >= end) break;
    }
    size_t v;
    int b, c0, c1;
    item(q, v, b, c0, c1);
    const float w = weights ? weights[v] : 1.0f;
    const float* gb = g + static_cast<size_t>(b) * d;
    value_columns(f, sets, gids, support, v, S, set, c0, c1,
                  [&](int c, int32_t s) {
      slab_add(dmem, s, base, m_local,
               weights ? __fmul_rn(gb[c], w) : gb[c]);
    });
  }
  used = 0;
  for (int i = 0; i < n_staged; ++i) {
    size_t v;
    int b, c0, c1;
    item(items[i], v, b, c0, c1);
    const float w = weights ? weights[v] : 1.0f;
    const float* gb = g + static_cast<size_t>(b) * d;
    for (int c = c0 + lane; c < c1; c += lma::WARP) {
      const float gv = weights ? __fmul_rn(gb[c], w) : gb[c];
      slab_add(dmem, staged[(used + (c - c0) / lma::WARP) * lma::WARP + lane],
               base, m_local, gv);
    }
    used += (c1 - c0 + lma::WARP - 1) / lma::WARP;
  }
}

// dw[b, l] = sum_c g[b, c] * mem[slot(b*L + l, c)], one warp per value
// v = b*L + l, as the locations kernel takes them.  Each lane
// sums its columns c = lane, lane + 32, ... (product, then sum: no fused
// multiply-add), then the warp adds the lanes by the xor-shuffle tree 16, 8,
// 4, 2, 1; lanes past d add 0.  g[b] is read once a value, from L2 after the
// first of a sample's L values.
__global__ void fused_weight_grad_kernel(const uint32_t* __restrict__ sets,
                                         const int32_t* __restrict__ gids,
                                         const int32_t* __restrict__ support,
                                         const float* __restrict__ mem,
                                         const float* __restrict__ g, int N,
                                         int L, int S, FusedArgs f,
                                         float* __restrict__ dw) {
  extern __shared__ uint32_t smem[];
  const int d = f.a.d;
  const int warp = threadIdx.x / lma::WARP, lane = threadIdx.x % lma::WARP;
  uint32_t* set = smem + warp * S;
  const int stride = gridDim.x * WARPS_PER_BLOCK;
  for (int v = blockIdx.x * WARPS_PER_BLOCK + warp; v < N; v += stride) {
    const float* gb = g + static_cast<size_t>(v / L) * d;
    const Value x = load_value(f, sets, gids, support, v, S, set, lane);
    float acc = 0.0f;
    for (int c = lane; c < d; c += lma::WARP) {
      const float e = __ldg(mem + slot(f, x.fallback, set, x.n, x.gid, c));
      acc = __fadd_rn(acc, __fmul_rn(e, gb[c]));
    }
    for (int off = lma::WARP / 2; off > 0; off /= 2)
      acc = __fadd_rn(acc, __shfl_xor_sync(0xFFFFFFFFu, acc, off));
    if (lane == 0) dw[v] = acc;
    __syncwarp();
  }
}

// The chunked exchange's step 0: the chunk's locations written to loc
// [N, d] int32 and their slab-masked gather to part [N, d].  Bounds as
// the locations kernel's.
__global__ void __launch_bounds__(WARPS_PER_BLOCK * lma::WARP, 6)
fused_chunk_lookup_kernel(const uint32_t* __restrict__ sets,
                          const int32_t* __restrict__ gids,
                          const int32_t* __restrict__ support,
                          const float* __restrict__ mem, int N, int S,
                          int base, int m_local, int tile, FusedArgs f,
                          float* __restrict__ part,
                          int32_t* __restrict__ loc) {
  extern __shared__ uint32_t smem[];
  const int d = f.a.d;
  uint32_t* set = smem + threadIdx.x / lma::WARP * S;
  tile_walk(N, d, tile, [&](int v, int c0, int c1) {
    value_columns(f, sets, gids, support, v, S, set, c0, c1,
                  [&](int c, int32_t s) {
      const size_t o = static_cast<size_t>(v) * d + c;
      loc[o] = s;
      part[o] = slab_read(mem, s, base, m_local);
    });
  });
}

// out[i] = mem[loc[i] - base] in the slab, else 0; i over all n elements.
__global__ void chunk_gather_kernel(const int32_t* __restrict__ loc,
                                    int64_t n, const float* __restrict__ mem,
                                    int base, int m_local,
                                    float* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride)
    out[i] = slab_read(mem, loc[i], base, m_local);
}

// dmem[loc[i] - base] += g[i] in the slab; dmem zeroed by the caller.
__global__ void chunk_scatter_kernel(const int32_t* __restrict__ loc,
                                     const float* __restrict__ g, int64_t n,
                                     int base, int m_local,
                                     float* __restrict__ dmem) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride)
    slab_add(dmem, loc[i], base, m_local, g[i]);
}

constexpr int ELEM_THREADS = 256;
constexpr int64_t MAX_ELEM_BLOCKS = 132 * 64;

int elem_blocks(int64_t n) {
  const int64_t b = (n + ELEM_THREADS - 1) / ELEM_THREADS;
  return static_cast<int>(b < MAX_ELEM_BLOCKS ? b : MAX_ELEM_BLOCKS);
}

int blocks_for(int rows) {
  return (rows + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
}

// Dynamic shared memory past the 48 KB a launch gets by default needs the
// kernel's opt-in (up to 227 KB a block on Hopper).  The bag lookup's sums
// take a tile of floats a warp, so one tile of d = 2,048 asks 66.5 KB; the
// other launches stage only sets, 8 * S * 4 bytes.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The tiled walk's shared memory: each warp's staged set, and for a bag
// its tile's sums; the flat lookup, the locations and the chunk lookup
// write straight out and keep none.
size_t lookup_smem(int S, int tile, bool bag) {
  return WARPS_PER_BLOCK * static_cast<size_t>(S + (bag ? tile : 0)) *
         sizeof(uint32_t);
}

// The scatter-add's: the block's zeros, then each warp's set, its
// STAGE_SLOTS staged slots and their items (15.3 KB a block at S = 32).
size_t scatter_smem(int S) {
  return ZERO_BYTES +
         WARPS_PER_BLOCK * static_cast<size_t>(S + STAGE_SLOTS + STAGE_ROUNDS) *
             sizeof(uint32_t);
}

// The tiled walk's grid: a warp per (row, tile), 8 warps a block.
int tiled_blocks(int rows, int d, int tile) {
  return blocks_for(rows * ((d + tile - 1) / tile));
}

}  // namespace

// Flat lookup: weights == nullptr, L == 1, out [N, d].
// Bag lookup: weights [B, L], out [B, d].
// mem is the [m_local] slab from global slot base (base 0, m_local m: the
// whole pool).  A warp covers `tile` columns of a row (0 < tile, d or a
// multiple of 32): ceil(B * ceil(d / tile) / 8) blocks.
extern "C" int fused_lookup_launch(const void* sets, const void* gids,
                                   const void* support, const void* weights,
                                   const void* mem, int B, int L, int S,
                                   int base, int m_local, int tile,
                                   int scheme, int d, int n_h,
                                   int independent, uint32_t seed,
                                   uint32_t m, uint32_t stripe,
                                   int min_support, void* out,
                                   cudaStream_t stream) {
  if (B == 0) return 0;
  FusedArgs f{scheme, min_support, {d, n_h, independent, seed, m, stripe}};
  const size_t shm = lookup_smem(S, tile, weights != nullptr);
  const cudaError_t attr = allow_smem(fused_lookup_kernel, shm);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  fused_lookup_kernel<<<tiled_blocks(B, d, tile),
                        WARPS_PER_BLOCK * lma::WARP, shm, stream>>>(
      static_cast<const uint32_t*>(sets), static_cast<const int32_t*>(gids),
      static_cast<const int32_t*>(support),
      static_cast<const float*>(weights), static_cast<const float*>(mem), B,
      L, S, base, m_local, tile, f, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Locations: out [N, d] int32; `tile` as the lookup's.
extern "C" int fused_locations_launch(const void* sets, const void* gids,
                                      const void* support, int N, int S,
                                      int tile, int scheme, int d, int n_h,
                                      int independent, uint32_t seed,
                                      uint32_t m, uint32_t stripe,
                                      int min_support, void* out,
                                      cudaStream_t stream) {
  if (N == 0) return 0;
  FusedArgs f{scheme, min_support, {d, n_h, independent, seed, m, stripe}};
  fused_locations_kernel<<<tiled_blocks(N, d, tile),
                           WARPS_PER_BLOCK * lma::WARP,
                           lookup_smem(S, tile, false), stream>>>(
      static_cast<const uint32_t*>(sets), static_cast<const int32_t*>(gids),
      static_cast<const int32_t*>(support), N, S, tile, f,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Blocks an SM holds at a launch's registers and shared memory
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) into *blocks: kernel 0
// the lookup (bag != 0: with its tile's sums), 1 the locations, 2 the chunk
// lookup, 3 the scatter-add (whose grid is that times the SM count).
extern "C" int fused_blocks_per_sm(int kernel, int S, int tile, int bag,
                                   int* blocks) {
  const int threads = WARPS_PER_BLOCK * lma::WARP;
  const size_t shm = lookup_smem(S, tile, kernel == 0 && bag);
  if (kernel == 1)
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, fused_locations_kernel, threads, shm));
  if (kernel == 2)
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, fused_chunk_lookup_kernel, threads, shm));
  if (kernel == 3) {
    const cudaError_t attr = allow_smem(fused_scatter_kernel,
                                        scatter_smem(S));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, fused_scatter_kernel, threads, scatter_smem(S)));
  }
  const cudaError_t attr = allow_smem(fused_lookup_kernel, shm);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fused_lookup_kernel, threads, shm));
}

// Scatter-add: g [B, d] (flat: weights == nullptr, L == 1) into the
// [m_local] slab dmem from global slot base, which the kernel zeroes
// (16-byte aligned; B == 0 still zeroes it).  A cooperative launch of
// `grid` blocks, which the card must hold at once (the binding's
// blocks_per_sm("scatter") times the SM count); `tile` as the lookup's.
// A refused launch (too large a grid, no cooperative launch) returns its
// error; nothing falls back.  `tail` is one int of scratch the kernel
// sets before its barrier (the grid's tail counter).
extern "C" int fused_scatter_add_launch(const void* sets, const void* gids,
                                        const void* support,
                                        const void* weights, const void* g,
                                        void* tail, int B, int L, int S,
                                        int base, int m_local, int tile,
                                        int grid, int scheme, int d, int n_h,
                                        int independent, uint32_t seed,
                                        uint32_t m, uint32_t stripe,
                                        int min_support, void* dmem,
                                        cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(dmem) % sizeof(float4) != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (static_cast<int64_t>(B) * ((d + tile - 1) / tile) * L > INT32_MAX / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  FusedArgs f{scheme, min_support, {d, n_h, independent, seed, m, stripe}};
  const size_t shm = scatter_smem(S);
  cudaError_t err = allow_smem(fused_scatter_kernel, shm);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute coop[1];
  coop[0].id = cudaLaunchAttributeCooperative;
  coop[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(WARPS_PER_BLOCK * lma::WARP);
  cfg.dynamicSmemBytes = shm;
  cfg.stream = stream;
  cfg.attrs = coop;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, fused_scatter_kernel, static_cast<const uint32_t*>(sets),
      static_cast<const int32_t*>(gids), static_cast<const int32_t*>(support),
      static_cast<const float*>(weights), static_cast<const float*>(g), B, L,
      S, base, m_local, tile, f, static_cast<float*>(dmem),
      static_cast<int*>(tail));
  const cudaError_t last = cudaGetLastError();   // clears a refused launch's
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// Bag weight gradient: g [B, d], mem [m] -> dw [B, L].
extern "C" int fused_weight_grad_launch(const void* sets, const void* gids,
                                        const void* support, const void* mem,
                                        const void* g, int B, int L, int S,
                                        int scheme, int d, int n_h,
                                        int independent, uint32_t seed,
                                        uint32_t m, uint32_t stripe,
                                        int min_support, void* dw,
                                        cudaStream_t stream) {
  const int N = B * L;
  if (N == 0) return 0;
  FusedArgs f{scheme, min_support, {d, n_h, independent, seed, m, stripe}};
  const size_t shm = WARPS_PER_BLOCK * S * sizeof(uint32_t);
  fused_weight_grad_kernel<<<blocks_for(N), WARPS_PER_BLOCK * lma::WARP, shm,
                             stream>>>(
      static_cast<const uint32_t*>(sets), static_cast<const int32_t*>(gids),
      static_cast<const int32_t*>(support), static_cast<const float*>(mem),
      static_cast<const float*>(g), N, L, S, f, static_cast<float*>(dw));
  return static_cast<int>(cudaGetLastError());
}

// Chunk lookup: loc [N, d] int32 and part [N, d] f32 out, mem the [m_local]
// slab from global slot base; `tile` as the lookup's.
extern "C" int fused_chunk_lookup_launch(const void* sets, const void* gids,
                                         const void* support, const void* mem,
                                         int N, int S, int base, int m_local,
                                         int tile, void* loc, int scheme,
                                         int d, int n_h, int independent,
                                         uint32_t seed, uint32_t m,
                                         uint32_t stripe, int min_support,
                                         void* part, cudaStream_t stream) {
  if (N == 0) return 0;
  FusedArgs f{scheme, min_support, {d, n_h, independent, seed, m, stripe}};
  fused_chunk_lookup_kernel<<<tiled_blocks(N, d, tile),
                              WARPS_PER_BLOCK * lma::WARP,
                              lookup_smem(S, tile, false), stream>>>(
      static_cast<const uint32_t*>(sets), static_cast<const int32_t*>(gids),
      static_cast<const int32_t*>(support), static_cast<const float*>(mem), N,
      S, base, m_local, tile, f, static_cast<float*>(part),
      static_cast<int32_t*>(loc));
  return static_cast<int>(cudaGetLastError());
}

// Chunk gather: loc [n] int32 (n = rows * d) -> out [n] f32.
extern "C" int fused_chunk_gather_launch(const void* loc, int64_t n,
                                         const void* mem, int base,
                                         int m_local, void* out,
                                         cudaStream_t stream) {
  if (n == 0) return 0;
  chunk_gather_kernel<<<elem_blocks(n), ELEM_THREADS, 0, stream>>>(
      static_cast<const int32_t*>(loc), n, static_cast<const float*>(mem),
      base, m_local, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Chunk scatter: g [n] f32 at loc [n] int32 into the [m_local] slab dmem
// from global slot base, which the caller zeroed.
extern "C" int fused_chunk_scatter_launch(const void* loc, const void* g,
                                          int64_t n, int base, int m_local,
                                          void* dmem, cudaStream_t stream) {
  if (n == 0) return 0;
  chunk_scatter_kernel<<<elem_blocks(n), ELEM_THREADS, 0, stream>>>(
      static_cast<const int32_t*>(loc), static_cast<const float*>(g), n, base,
      m_local, static_cast<float*>(dmem));
  return static_cast<int>(cudaGetLastError());
}
