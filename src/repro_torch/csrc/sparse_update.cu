// Lazy sparse optimizer updates over the K touched pool slots -- Adagrad,
// momentum SGD and Adam -- with the duplicate fold done in the same pass.
//
// Replaces the TPU kernels of repro/kernels/sparse_update/kernel.py
// (_adagrad_kernel, _sgd_kernel and _adam_kernel with _gather_keep, launched
// through _call by sparse_adagrad_pallas, sparse_sgd_pallas and
// sparse_adam_pallas).  Same functions, on the SparseGrad contract: indices
// [K] int32 sorted, either unique with a sentinel (= the state's leading
// dim) tail (unique = 1) or with duplicate runs (unique = 0, the bucketed
// stream).  Two layouts: flat states [m] with values [K], or [rows, d]
// states with values [K, d] (the row-mode SparseGrad; d = 0 below means
// flat).  Per live slot, with s the slot's value (the run's sum when
// unique = 0):
//   Adagrad  acc += s*s;  u = -lr * s / (sqrt(acc) + eps)
//   SGD      new = momentum*mo + s;  mo += new - mo;  u = -lr * new
//   Adam     mu' = b1*mu + (1-b1)*s;  nu' = b2*nu + (1-b2)*s*s;
//            mu += mu' - mu;  nu += nu' - nu;
//            u = -lr * (mu'/bc1) / (sqrt(nu'/bc2) + eps)
// Adam's nu may also be row-wise, nu [rows] against [K, d] values; it then
// takes the row's mean of s*s, summed in the order of ref.py's row_mean
// (zero-pad d to a power of two, halve until one column is left).
// u is written at the run's head and 0 everywhere else (sentinels, and the
// non-head positions of a run).  The states are updated in place, at touched
// slots only, by adding the delta as the reference does (so a stored moment
// is old + (new - old), not always new), and untouched slots keep their
// bits.
//
// The run sum is taken in the order of the reference's fold_duplicates
// (repro/kernels/sparse_update/ref.py): its segmented doubling scan leaves
// at a run's head the pairwise tree aligned at the head -- blocks of 2^l
// entries starting at the head, each block the sum of its left and right
// halves, a right half that starts past the run's end dropped.  (Dropping
// it adds +0 there, which turns a -0 sum into +0: the head's sum is -0 only
// when every entry is -0 and the run is the whole stream with a power-of-two
// length; the kernels add +0 to every other run's sum to match.)  Every
// product, sum, quotient and root below is rounded on its own (no fused
// multiply-add); the scalars (-lr, 1-b1, 1-b2, eps, bc1, bc2) arrive rounded
// to float32, as the reference's weakly typed Python floats are.  So the
// kernels are bit-identical to the plain versions, not merely close.
//
// What bounds them on Hopper: bytes.  Each entry's index, value and update
// (12 bytes) move once, and each touched slot's states are read and written
// once (8 bytes a state); the arithmetic is a few operations per entry.
// Flat layout with duplicate runs: runs are long and uneven (a B = 65,536
// dlrm-rm2 step has 3.7M runs over 109M entries, 85% of the entries in runs
// over 32, up to 22,296), so the fold keeps each run's entries in shared
// memory and follows the reference's doubling where it lies:
//   pass 1, a block of 256 threads for each tile of TILE = 2,048 entries:
//   - the tile is read once, coalesced, into shared memory (padded one word
//     in 32, so a lane's 8 consecutive entries are conflict-free); if its
//     last run goes on past the tile, up to HALO = 2,048 more entries of
//     that run are read after it (256, then the rest); every load of a
//     step is issued before the first store to shared memory;
//   - each warp walks its 256 entries as 8 windows of 32, a lane an entry:
//     heads are flagged, each lane's offset from its head and distance to
//     its run's end come from the window's ballot, and the runs that end in
//     the window are folded by the reference's doubling itself, five masked
//     levels of register shuffles (s[p] += s[p + 2^l] where p's offset is a
//     multiple of 2^(l+1) and p + 2^l is in the run);
//   - the one run of a window that goes on past it is folded by its warp
//     from shared memory, a lane an entry if it ends within 32 entries,
//     else in head-aligned rounds of 256 entries: each lane
//     sums its 8 entries as the tree's bottom three levels, five shuffle
//     levels finish the 256-block, and the blocks combine through a carry
//     stack whose slots have static indices, so it stays in registers;
//   - each folded head joins its warp's queue in shared memory, and the op
//     (the state reads, roots and quotients) runs on 32 queued heads at a
//     time, on full warps; every other entry's update is 0;
//   - a run that covers the whole halo is left to pass 2: the tile records
//     its head in long_head[tile] (-1 if none; a tile can start at most one
//     such run), with no atomic counter;
//   pass 2, a block for each group of 8 tiles: it collects the group's
//   long heads and folds each run with the whole block, in head-aligned
//   chunks of 2,048 (each warp stages 256 entries coalesced in shared
//   memory, folds them as above, and thread 0 adds the 8 warp sums as the
//   tree's next three levels and pushes the chunk on a carry stack kept in
//   shared memory).
// Unique streams have no runs: one thread an entry.  Row layout: one warp
// per index with its lanes over d, so a d = 64 row is one coalesced 256-byte
// read or write; a run is folded per column, one carry stack at a time.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WARP = 32;
constexpr int THREADS = 256;
constexpr int TILE = 2048;      // pass 1: entries a block owns
constexpr int HALO = 2048;      // entries of a tile's last run read past it
constexpr int ROUND = 256;      // entries a warp folds at a time (8 a lane)
constexpr int GROUP = 8;        // pass 2: tiles whose long runs a block folds
constexpr int CHUNK = THREADS / WARP * ROUND;   // pass 2: 2,048 a step
constexpr int BUF = TILE + HALO;
constexpr int MAX_DEPTH = 40;   // carry-stack depth: > log2(K) + 1
constexpr int TILE_DEPTH = 5;   // rounds of a run in one tile's buffer: 16
constexpr int MAX_COLS = 8;     // row layout: columns a lane holds, d <= 256
constexpr unsigned FULL = 0xFFFFFFFFu;
static_assert(BUF / ROUND <= (1 << (TILE_DEPTH - 1)), "tile carry depth");

// a shared-memory slot of entry q: one pad word in 32
__device__ __forceinline__ int pad(int q) { return q + (q >> 5); }

// Carry stack of the aligned pairwise tree: push() takes the leaves (or
// equal-sized blocks) in order, merging while the count's low bits are set;
// finish() combines what is left from the right, which is how the tree
// truncates at the run's end.  Slot k holds a block of 2^k leaves; every
// index is static once the loops unroll, so pass 1's shallow stack lives in
// registers (the row layout's, MAX_DEPTH deep, spills to local memory).
template <int DEPTH>
struct Carry {
  float c[DEPTH];
  uint64_t count = 0;

  __device__ __forceinline__ void push(float x) {
#pragma unroll
    for (int k = 0; k < DEPTH; ++k) {
      if (!((count >> k) & 1u)) {
        c[k] = x;
        break;
      }
      x = __fadd_rn(c[k], x);
    }
    ++count;
  }

  __device__ __forceinline__ float finish() const {  // count > 0
    float acc = 0.0f;
    bool have = false;
#pragma unroll
    for (int k = 0; k < DEPTH; ++k) {
      if ((count >> k) & 1u) {
        acc = have ? __fadd_rn(c[k], acc) : c[k];
        have = true;
      }
    }
    return acc;
  }
};

// The same stack for one thread's long run, its slots in shared memory
// (indexed at run time there, never in local memory).
struct SharedCarry {
  float* c;
  uint64_t count = 0;

  __device__ __forceinline__ void push(float x) {
    int k = 0;
    for (; (count >> k) & 1u; ++k) x = __fadd_rn(c[k], x);
    c[k] = x;
    ++count;
  }

  __device__ __forceinline__ float finish() const {  // count > 0
    int k = __ffsll(static_cast<long long>(count)) - 1;
    float acc = c[k];
    for (++k; k < 64; ++k)
      if ((count >> k) & 1u) acc = __fadd_rn(c[k], acc);
    return acc;
  }
};

// The truncated aligned tree of e[0:n], n <= 8: the bottom three levels.
__device__ __forceinline__ float tree8(float (&e)[8], int n) {
#pragma unroll
  for (int i = 0; i < 8; i += 2)
    if (i + 1 < n) e[i] = __fadd_rn(e[i], e[i + 1]);
#pragma unroll
  for (int i = 0; i < 8; i += 4)
    if (i + 2 < n) e[i] = __fadd_rn(e[i], e[i + 2]);
  if (4 < n) e[0] = __fadd_rn(e[0], e[4]);
  return e[0];
}

// Lane 0 gets the tree of a block of 32 * SPAN entries from each lane's
// SPAN-tree x, the block holding cnt entries (a prefix of the lanes' spans).
template <int SPAN>
__device__ __forceinline__ float warp_tree(float x, int cnt, int lane) {
#pragma unroll
  for (int off = 1; off < WARP; off *= 2) {
    const float y = __shfl_down_sync(FULL, x, off);
    if ((lane & (2 * off - 1)) == 0 && (lane + off) * SPAN < cnt)
      x = __fadd_rn(x, y);
  }
  return x;
}

// The reference turns a -0 sum into +0 unless no right half was ever
// dropped at the head: the run is the whole stream, of length 2^k.
__device__ __forceinline__ float as_reference(float s, int64_t n, int64_t K) {
  return (n == K && (n & (n - 1)) == 0) ? s : __fadd_rn(s, 0.0f);
}

// The per-slot updates: given the slot's folded value s and its flat state
// index, update the states at that index and return the update value.
struct AdagradOp {
  float* acc;
  float neg_lr, eps;

  __device__ __forceinline__ float operator()(float s, int64_t slot) const {
    const float a = __fadd_rn(acc[slot], __fmul_rn(s, s));
    acc[slot] = a;
    return __fdiv_rn(__fmul_rn(neg_lr, s), __fadd_rn(__fsqrt_rn(a), eps));
  }
};

struct SgdOp {
  float* mo;
  float momentum, neg_lr;

  __device__ __forceinline__ float operator()(float s, int64_t slot) const {
    const float old = mo[slot];
    const float nw = __fadd_rn(__fmul_rn(momentum, old), s);
    mo[slot] = __fadd_rn(old, __fsub_rn(nw, old));
    return __fmul_rn(neg_lr, nw);
  }
};

struct AdamOp {
  float* mu;
  float* nu;
  float b1, omb1, b2, omb2, neg_lr, bc1, bc2, eps;

  __device__ __forceinline__ float nu_next(float old, float v2) const {
    return __fadd_rn(__fmul_rn(b2, old), __fmul_rn(omb2, v2));
  }

  // mu's update and u, given the slot's new second moment
  __device__ __forceinline__ float with_nu(float s, int64_t slot,
                                           float nu_new) const {
    const float old = mu[slot];
    const float mn = __fadd_rn(__fmul_rn(b1, old), __fmul_rn(omb1, s));
    mu[slot] = __fadd_rn(old, __fsub_rn(mn, old));
    return __fdiv_rn(__fmul_rn(neg_lr, __fdiv_rn(mn, bc1)),
                     __fadd_rn(__fsqrt_rn(__fdiv_rn(nu_new, bc2)), eps));
  }

  __device__ __forceinline__ float operator()(float s, int64_t slot) const {
    const float old = nu[slot];
    const float nn = nu_next(old, __fmul_rn(s, s));
    nu[slot] = __fadd_rn(old, __fsub_rn(nn, old));
    return with_nu(s, slot, nn);
  }
};

// Unique stream: one thread per entry.
template <class Op>
__global__ void flat_unique_kernel(const int32_t* __restrict__ idx,
                                   const float* __restrict__ val, int64_t K,
                                   int32_t m, Op op, float* __restrict__ u) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < K; i += stride) {
    const int32_t slot = idx[i];
    u[i] = (slot >= 0 && slot < m) ? op(val[i], slot) : 0.0f;
  }
}

// Fold the run of `slot` that starts at buffer entry lh, in head-aligned
// rounds of 256 read from shared memory (entries [0, n_buf) are loaded).
// Every lane returns the sum; n gets the run's length.
__device__ __forceinline__ float fold_in_buffer(const int32_t* sidx,
                                                const float* sval, int lh,
                                                int n_buf, int32_t slot,
                                                int lane, int64_t& n) {
  if (lh + WARP >= n_buf || sidx[pad(lh + WARP)] != slot) {
    // at most 32 entries (most runs that leave their window): a lane each
    const int q = lh + lane;
    const bool in = q < n_buf && sidx[pad(q)] == slot;
    const int cnt = __popc(__ballot_sync(FULL, in));
    const float x = warp_tree<1>(in ? sval[pad(q)] : 0.0f, cnt, lane);
    n = cnt;
    return __shfl_sync(FULL, x, 0);
  }
  Carry<TILE_DEPTH> carry;
  n = 0;
  for (int base = lh;; base += ROUND) {
    float e[8];
    int mine = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int q = base + 8 * lane + j;
      const bool in = q < n_buf && sidx[pad(q)] == slot;
      e[j] = in ? sval[pad(q)] : 0.0f;
      mine += in;
    }
    const int cnt = __reduce_add_sync(FULL, mine);
    if (cnt == 0) break;           // the run ended on a round's edge
    const float x = warp_tree<8>(tree8(e, mine), cnt, lane);
    carry.push(__shfl_sync(FULL, x, 0));
    n += cnt;
    if (cnt < ROUND) break;
  }
  return carry.finish();
}

// A warp's folded heads, waiting for the op: applied 32 at a time, so the
// state reads and the op's arithmetic (roots, quotients) run on full warps,
// not once per window on a lane or two.
struct HeadList {
  int32_t* slot;
  float* sum;
  int16_t* pos;                 // the head's entry in the tile
  int count = 0;                // the same in every lane

  // append (slot, sum, pos) of each lane where `mine`, in lane order
  __device__ __forceinline__ void push(bool mine, int32_t s, float x, int p,
                                       int lane) {
    const unsigned got = __ballot_sync(FULL, mine);
    if (mine) {
      const int at = count + __popc(got & ((1u << lane) - 1u));
      slot[at] = s;
      sum[at] = x;
      pos[at] = static_cast<int16_t>(p);
    }
    count += __popc(got);
    __syncwarp();
  }

  // run the op on the first k entries (k <= 32), keep the rest
  template <class Op>
  __device__ __forceinline__ void flush(int k, int lane, const Op& op,
                                       int32_t m, float* u) {
    if (lane < k) {
      const int32_t s = slot[lane];
      u[pos[lane]] = (s >= 0 && s < m) ? op(sum[lane], s) : 0.0f;
    }
    const int rest = count - k;
    int32_t s = 0;
    float x = 0.0f;
    int16_t p = 0;
    if (lane < rest) {
      s = slot[k + lane];
      x = sum[k + lane];
      p = pos[k + lane];
    }
    __syncwarp();
    if (lane < rest) {
      slot[lane] = s;
      sum[lane] = x;
      pos[lane] = p;
    }
    count = rest;
    __syncwarp();
  }
};

// Pass 1's halo: entries [q0, q0 + STEP) of the tile's buffer, every load
// in flight before any store; -> whether this thread's entries all
// continue the run of `tail`.
template <int STEP>
__device__ __forceinline__ bool load_halo(const int32_t* __restrict__ idx,
                                          const float* __restrict__ val,
                                          int64_t K, int64_t ts, int q0,
                                          int tid, int32_t tail,
                                          int32_t* sidx, float* sval) {
  int32_t ri[STEP / THREADS];
  float rv[STEP / THREADS];
#pragma unroll
  for (int j = 0; j < STEP / THREADS; ++j) {
    const int64_t p = ts + q0 + tid + j * THREADS;
    ri[j] = p < K ? idx[p] : tail - 1;
    rv[j] = p < K ? val[p] : 0.0f;
  }
  bool in = true;
#pragma unroll
  for (int j = 0; j < STEP / THREADS; ++j) {
    const int q = q0 + tid + j * THREADS;
    sidx[pad(q)] = ri[j];
    sval[pad(q)] = rv[j];
    in = in && ri[j] == tail;
  }
  return in;
}

// Flat pass 1: a block per tile of TILE entries.
template <class Op>
__global__ void __launch_bounds__(THREADS)
    flat_tile_kernel(const int32_t* __restrict__ idx,
                     const float* __restrict__ val, int64_t K, int32_t m,
                     Op op, float* __restrict__ u,
                     int64_t* __restrict__ long_head) {
  __shared__ int32_t sidx[BUF + BUF / WARP];
  __shared__ float sval[BUF + BUF / WARP];
  __shared__ int s_max[THREADS / WARP];
  __shared__ int32_t s_slot[THREADS / WARP][2 * WARP];
  __shared__ float s_sum[THREADS / WARP][2 * WARP];
  __shared__ int16_t s_pos[THREADS / WARP][2 * WARP];
  const int tid = threadIdx.x, lane = tid % WARP, warp = tid / WARP;
  const int64_t ts = static_cast<int64_t>(blockIdx.x) * TILE;
  const int n_tile = static_cast<int>(K - ts < TILE ? K - ts : TILE);

  {                             // every load in flight before any store
    int32_t ri[TILE / THREADS];
    float rv[TILE / THREADS];
#pragma unroll
    for (int j = 0; j < TILE / THREADS; ++j) {
      const int q = tid + j * THREADS;
      if (q < n_tile) {
        ri[j] = idx[ts + q];
        rv[j] = val[ts + q];
      }
    }
#pragma unroll
    for (int j = 0; j < TILE / THREADS; ++j) {
      const int q = tid + j * THREADS;
      if (q < n_tile) {
        sidx[pad(q)] = ri[j];
        sval[pad(q)] = rv[j];
      }
    }
  }
  const int32_t before = ts > 0 ? idx[ts - 1] : 0;
  const bool more = n_tile == TILE && ts + TILE < K;
  const int32_t after = more ? idx[ts + TILE] : 0;   // the halo's first
  __syncthreads();
  // the tile's last head (-1: the whole tile continues an earlier run)
  int last = -1;
  for (int q = tid; q < n_tile; q += THREADS) {
    const int32_t prev = q > 0 ? sidx[pad(q - 1)] : before;
    if (ts + q == 0 || prev != sidx[pad(q)]) last = q;
  }
  last = __reduce_max_sync(FULL, last);
  if (lane == 0) s_max[warp] = last;
  // the halo: the rest of the tile's last run, up to HALO entries
  int n_buf = n_tile;
  bool long_run = false;
  const int32_t tail = sidx[pad(n_tile - 1)];
  if (more && after == tail) {     // a short step first: most such runs
    long_run = __syncthreads_and(load_halo<THREADS>(        // end in it
        idx, val, K, ts, TILE, tid, tail, sidx, sval));
    n_buf = static_cast<int>(K - ts < TILE + THREADS ? K - ts
                                                     : TILE + THREADS);
    if (long_run) {
      long_run = __syncthreads_and(load_halo<HALO - THREADS>(
          idx, val, K, ts, TILE + THREADS, tid, tail, sidx, sval));
      n_buf = static_cast<int>(K - ts < BUF ? K - ts : BUF);
    }
    // long_run: the run covers the whole halo; pass 2 folds it
  }
  __syncthreads();
  last = s_max[0];
#pragma unroll
  for (int w = 1; w < THREADS / WARP; ++w) last = max(last, s_max[w]);
  const int long_lh = long_run ? last : -1;     // its head, if in the tile
  if (tid == 0) long_head[blockIdx.x] = long_lh >= 0 ? ts + long_lh : -1;

  HeadList heads{s_slot[warp], s_sum[warp], s_pos[warp]};
  for (int k = 0; k < ROUND / WARP; ++k) {
    const int w0 = warp * ROUND + k * WARP;     // the window's first entry
    const int lp = w0 + lane;
    const int nv = n_tile - w0 < WARP ? n_tile - w0 : WARP;
    if (nv <= 0) break;
    const bool valid = lane < nv;
    const int32_t s = valid ? sidx[pad(lp)] : 0;
    const int32_t prev = lp > 0 ? sidx[pad(lp - 1)] : before;
    const bool head = valid && (ts + lp == 0 || prev != s);
    const unsigned hm = __ballot_sync(FULL, head);
    if (hm == 0) {                              // all continue a run
      if (valid) u[ts + lp] = 0.0f;
      continue;
    }
    const unsigned upto = (2u << lane) - 1u;    // lanes 0..lane
    const unsigned above = hm & ~upto, below = hm & upto;
    const int end = above ? __ffs(above) - 1 : nv;
    const int hl = below ? 31 - __clz(below) : -1;
    const int r = lane - hl, rem = end - lane;
    // does the window's last run go on past it?
    const int hc = 31 - __clz(hm);              // that run's head lane
    bool goes_on = false;
    if (lane == nv - 1) {
      const int64_t p = ts + lp + 1;
      goes_on = p < K && (lp + 1 < n_buf ? sidx[pad(lp + 1)] : after) == s;
    }
    goes_on = __shfl_sync(FULL, goes_on, nv - 1);
    float x = valid ? sval[pad(lp)] : 0.0f;
#pragma unroll
    for (int off = 1; off < WARP; off *= 2) {   // the reference's doubling
      const float y = __shfl_down_sync(FULL, x, off);
      if (hl >= 0 && (r & (2 * off - 1)) == 0 && off < rem)
        x = __fadd_rn(x, y);
    }
    if (valid && !head) u[ts + lp] = 0.0f;
    heads.push(head && !(goes_on && lane == hc), s,
               as_reference(x, rem, K), lp, lane);
    if (goes_on && w0 + hc != long_lh) {        // fold it here, by rounds
      const int32_t slot = __shfl_sync(FULL, s, hc);
      int64_t n;
      const float sum = fold_in_buffer(sidx, sval, w0 + hc, n_buf, slot,
                                       lane, n);
      heads.push(lane == 0, slot, as_reference(sum, n, K), w0 + hc, lane);
    } else if (goes_on && lane == 0) {
      u[ts + w0 + hc] = 0.0f;                   // pass 2 writes it
    }
    while (heads.count >= WARP) heads.flush(WARP, lane, op, m, u + ts);
  }
  heads.flush(heads.count, lane, op, m, u + ts);
}

// Flat pass 2: a block folds each run that covered a tile's halo.
template <class Op>
__global__ void __launch_bounds__(THREADS)
    flat_long_kernel(const int32_t* __restrict__ idx,
                     const float* __restrict__ val, int64_t K, int32_t m,
                     Op op, float* __restrict__ u,
                     const int64_t* __restrict__ long_head, int64_t n_tiles) {
  __shared__ int64_t heads[GROUP];
  __shared__ int n_heads;
  __shared__ float stage[THREADS / WARP][ROUND + ROUND / WARP];
  __shared__ float wsum[THREADS / WARP];
  __shared__ int wcnt[THREADS / WARP];
  __shared__ int done;
  __shared__ float s_carry[MAX_DEPTH];
  const int tid = threadIdx.x, lane = tid % WARP, warp = tid / WARP;
  if (warp == 0) {                // the group's long heads, in tile order
    const int64_t tile = static_cast<int64_t>(blockIdx.x) * GROUP + lane;
    const int64_t h = lane < GROUP && tile < n_tiles ? long_head[tile] : -1;
    const unsigned got = __ballot_sync(FULL, h >= 0);
    if (h >= 0) heads[__popc(got & ((1u << lane) - 1u))] = h;
    if (lane == 0) n_heads = __popc(got);
  }
  __syncthreads();
  float* mine_stage = stage[warp];
  for (int r = 0; r < n_heads; ++r) {
    const int64_t h = heads[r];
    const int32_t slot = idx[h];
    SharedCarry carry{s_carry};   // thread 0's, in shared memory
    int64_t n = 0;
    for (int64_t base = h;; base += CHUNK) {
      const int64_t wb = base + warp * ROUND;
      int in_warp = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {   // coalesced: lane + 32 j
        const int q = lane + WARP * j;
        int32_t s = slot - 1;
        float v = 0.0f;
        if (wb + q < K) {         // both loads in flight at once
          s = idx[wb + q];
          v = val[wb + q];
        }
        const bool in = s == slot;
        mine_stage[pad(q)] = in ? v : 0.0f;
        in_warp += in;
      }
      const int cnt = __reduce_add_sync(FULL, in_warp);
      __syncwarp();
      float e[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = mine_stage[pad(8 * lane + j)];
      const int mine = min(max(cnt - 8 * lane, 0), 8);
      const float x = warp_tree<8>(tree8(e, mine), cnt, lane);
      if (lane == 0) {
        wsum[warp] = x;
        wcnt[warp] = cnt;
      }
      __syncthreads();
      if (tid == 0) {
        int total = 0;
#pragma unroll
        for (int w = 0; w < THREADS / WARP; ++w) total += wcnt[w];
        if (total > 0) {    // warp sums: the tree's levels 8 to 10
          float s8[THREADS / WARP];
#pragma unroll
          for (int w = 0; w < THREADS / WARP; ++w) s8[w] = wsum[w];
#pragma unroll
          for (int step = 1; step < THREADS / WARP; step *= 2)
#pragma unroll
            for (int w = 0; w < THREADS / WARP; w += 2 * step)
              if ((w + step) * ROUND < total)
                s8[w] = __fadd_rn(s8[w], s8[w + step]);
          carry.push(s8[0]);
          n += total;
        }
        done = total < CHUNK;
      }
      __syncthreads();
      if (done) break;
    }
    if (tid == 0)
      u[h] = (slot >= 0 && slot < m) ? op(as_reference(carry.finish(), n, K),
                                           slot)
                                     : 0.0f;
    __syncthreads();              // the stage is reused by the next run
  }
}

// Row layout: one warp per index, lanes over the d columns (column
// lane + WARP*k in register k).  kRowwise: Adam with nu [rows]; width is d
// rounded up to a power of two (the row mean's tree).
template <class Op, bool kRowwise>
__global__ void row_kernel(const int32_t* __restrict__ idx,
                           const float* __restrict__ val, int64_t K,
                           int32_t rows, int d, int width, int unique, Op op,
                           float* __restrict__ u) {
  const int lane = threadIdx.x % WARP;
  const int64_t warps = static_cast<int64_t>(gridDim.x) *
                        (blockDim.x / WARP);
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * (blockDim.x / WARP) +
                   threadIdx.x / WARP;
       i < K; i += warps) {
    const int32_t row = idx[i];      // the same for every lane
    float* urow = u + i * d;
    const bool live = row >= 0 && row < rows;
    if (!live || !(unique || i == 0 || idx[i - 1] != row)) {
      for (int c = lane; c < d; c += WARP) urow[c] = 0.0f;
      continue;
    }
    int64_t n = 1;
    if (!unique)
      while (i + n < K && idx[i + n] == row) ++n;
    float s[MAX_COLS];
#pragma unroll
    for (int k = 0; k < MAX_COLS; ++k) {
      const int c = lane + k * WARP;
      s[k] = 0.0f;
      if (c < d) {
        Carry<MAX_DEPTH> tree;       // one column's run, in order
        for (int64_t j = 0; j < n; ++j) tree.push(val[(i + j) * d + c]);
        s[k] = tree.finish();
      }
    }
    const int64_t base = static_cast<int64_t>(row) * d;
    if constexpr (kRowwise) {
      float x[MAX_COLS];
#pragma unroll
      for (int k = 0; k < MAX_COLS; ++k) x[k] = __fmul_rn(s[k], s[k]);
      // halve while wider than a warp: column c and c + w/2 share a lane
#pragma unroll
      for (int half = MAX_COLS / 2; half >= 1; half /= 2)
        if (2 * WARP * half <= width)
#pragma unroll
          for (int k = 0; k < half; ++k) x[k] = __fadd_rn(x[k], x[k + half]);
      float t = x[0];
      for (int off = (width < WARP ? width : WARP) / 2; off > 0; off /= 2)
        t = __fadd_rn(t, __shfl_xor_sync(FULL, t, off));
      t = __shfl_sync(FULL, t, 0);   // lanes past a narrow row summed zeros
      const float mean = __fdiv_rn(t, static_cast<float>(d));
      float old = lane == 0 ? op.nu[row] : 0.0f;
      old = __shfl_sync(FULL, old, 0);
      const float nn = op.nu_next(old, mean);
      if (lane == 0) op.nu[row] = __fadd_rn(old, __fsub_rn(nn, old));
#pragma unroll
      for (int k = 0; k < MAX_COLS; ++k) {
        const int c = lane + k * WARP;
        if (c < d) urow[c] = op.with_nu(s[k], base + c, nn);
      }
    } else {
#pragma unroll
      for (int k = 0; k < MAX_COLS; ++k) {
        const int c = lane + k * WARP;
        if (c < d) urow[c] = op(s[k], base + c);
      }
    }
  }
}

int grid_for(int64_t items, int per_block) {
  const int64_t want = (items + per_block - 1) / per_block;
  return static_cast<int>(want < (1 << 30) ? want : (1 << 30));
}

template <class Op, bool kRowwise = false>
int launch(const void* idx_, const void* val_, int64_t K, int m, int d,
           int unique, Op op, void* u_, void* long_head, cudaStream_t stream) {
  if (K == 0) return 0;
  const auto* idx = static_cast<const int32_t*>(idx_);
  const auto* val = static_cast<const float*>(val_);
  auto* u = static_cast<float*>(u_);
  if (d > 0) {
    if (d > MAX_COLS * WARP) return static_cast<int>(cudaErrorInvalidValue);
    int width = 1;
    while (width < d) width *= 2;
    row_kernel<Op, kRowwise><<<grid_for(K, THREADS / WARP), THREADS, 0,
                               stream>>>(idx, val, K, m, d, width, unique,
                                         op, u);
    return static_cast<int>(cudaGetLastError());
  }
  if (unique) {
    flat_unique_kernel<Op><<<grid_for(K, THREADS), THREADS, 0, stream>>>(
        idx, val, K, m, op, u);
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t n_tiles = (K + TILE - 1) / TILE;
  if (n_tiles >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* heads = static_cast<int64_t*>(long_head);
  flat_tile_kernel<Op><<<static_cast<unsigned>(n_tiles), THREADS, 0,
                         stream>>>(idx, val, K, m, op, u, heads);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flat_long_kernel<Op><<<static_cast<unsigned>((n_tiles + GROUP - 1) / GROUP),
                         THREADS, 0, stream>>>(idx, val, K, m, op, u, heads,
                                               n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Common arguments: idx [K] int32, val [K] (d = 0) or [K, d] f32, m the
// states' leading dim (the sentinel), u [K] or [K, d] f32 out; long_head
// [ceil(K / 2048)] int64 is the flat layout's scratch when unique = 0
// (written by pass 1, read by pass 2).  States are updated in place.
extern "C" int sparse_adagrad_launch(const void* idx, const void* val,
                                     int64_t K, int m, int d, int unique,
                                     float neg_lr, float eps, void* acc,
                                     void* u, void* long_head,
                                     cudaStream_t stream) {
  return launch(idx, val, K, m, d, unique,
                AdagradOp{static_cast<float*>(acc), neg_lr, eps}, u,
                long_head, stream);
}

extern "C" int sparse_sgd_launch(const void* idx, const void* val, int64_t K,
                                 int m, int d, int unique, float momentum,
                                 float neg_lr, void* mo, void* u,
                                 void* long_head, cudaStream_t stream) {
  return launch(idx, val, K, m, d, unique,
                SgdOp{static_cast<float*>(mo), momentum, neg_lr}, u,
                long_head, stream);
}

// rowwise = 1: nu [rows] against [K, d] values (d > 0).
extern "C" int sparse_adam_launch(const void* idx, const void* val,
                                  int64_t K, int m, int d, int unique,
                                  int rowwise, float b1, float omb1, float b2,
                                  float omb2, float neg_lr, float bc1,
                                  float bc2, float eps, void* mu, void* nu,
                                  void* u, void* long_head,
                                  cudaStream_t stream) {
  const AdamOp op{static_cast<float*>(mu), static_cast<float*>(nu), b1, omb1,
                  b2, omb2, neg_lr, bc1, bc2, eps};
  if (rowwise)
    return d > 0 ? launch<AdamOp, true>(idx, val, K, m, d, unique, op, u,
                                         long_head, stream)
                 : static_cast<int>(cudaErrorInvalidValue);
  return launch(idx, val, K, m, d, unique, op, u, long_head, stream);
}
