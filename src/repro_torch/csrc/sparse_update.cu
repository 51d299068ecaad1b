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
// Unique streams have no runs: one thread an entry.  The row layout has its
// own kernels, described where they begin.
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
constexpr int MAX_D = 256;      // row layout: the widest row
constexpr unsigned FULL = 0xFFFFFFFFu;
static_assert(BUF / ROUND <= (1 << (TILE_DEPTH - 1)), "tile carry depth");

// a shared-memory slot of entry q: one pad word in 32
__device__ __forceinline__ int pad(int q) { return q + (q >> 5); }

// Carry stack of the aligned pairwise tree: push() takes the leaves (or
// equal-sized blocks) in order, merging while the count's low bits are set;
// finish() combines what is left from the right, which is how the tree
// truncates at the run's end.  Slot k holds a block of 2^k leaves; every
// index is static once the loops unroll, so pass 1's shallow stack lives in
// registers.
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

// The per-slot updates.  apply() takes the slot's folded value s and its
// states as loaded, leaves in them the values to store (old + (new - old),
// as the reference adds its delta) and returns the update value;
// operator() does the same at a flat state index.
struct AdagradOp {
  static constexpr int kStates = 1;
  float* acc;
  float neg_lr, eps;

  __host__ __device__ float* state(int) const { return acc; }

  __device__ __forceinline__ float apply(float s, float (&st)[1]) const {
    const float a = __fadd_rn(st[0], __fmul_rn(s, s));
    st[0] = a;
    return __fdiv_rn(__fmul_rn(neg_lr, s), __fadd_rn(__fsqrt_rn(a), eps));
  }

  __device__ __forceinline__ float operator()(float s, int64_t slot) const {
    float st[1] = {acc[slot]};
    const float out = apply(s, st);
    acc[slot] = st[0];
    return out;
  }
};

struct SgdOp {
  static constexpr int kStates = 1;
  float* mo;
  float momentum, neg_lr;

  __host__ __device__ float* state(int) const { return mo; }

  __device__ __forceinline__ float apply(float s, float (&st)[1]) const {
    const float old = st[0];
    const float nw = __fadd_rn(__fmul_rn(momentum, old), s);
    st[0] = __fadd_rn(old, __fsub_rn(nw, old));
    return __fmul_rn(neg_lr, nw);
  }

  __device__ __forceinline__ float operator()(float s, int64_t slot) const {
    float st[1] = {mo[slot]};
    const float out = apply(s, st);
    mo[slot] = st[0];
    return out;
  }
};

struct AdamOp {
  static constexpr int kStates = 2;   // element-wise nu; a row-wise nu
  float* mu;                          // leaves mu alone element-wise
  float* nu;
  float b1, omb1, b2, omb2, neg_lr, bc1, bc2, eps;

  __host__ __device__ float* state(int i) const {
    return i == 0 ? mu : nu;
  }

  __device__ __forceinline__ float nu_next(float old, float v2) const {
    return __fadd_rn(__fmul_rn(b2, old), __fmul_rn(omb2, v2));
  }

  // sqrt(nu'/bc2) + eps, the update's denominator
  __device__ __forceinline__ float denom(float nu_new) const {
    return __fadd_rn(__fsqrt_rn(__fdiv_rn(nu_new, bc2)), eps);
  }

  // mu's update in place and u, given the denominator of the slot's nu
  __device__ __forceinline__ float with_denom(float s, float& mu_st,
                                              float den) const {
    const float old = mu_st;
    const float mn = __fadd_rn(__fmul_rn(b1, old), __fmul_rn(omb1, s));
    mu_st = __fadd_rn(old, __fsub_rn(mn, old));
    return __fdiv_rn(__fmul_rn(neg_lr, __fdiv_rn(mn, bc1)), den);
  }

  __device__ __forceinline__ float apply(float s, float (&st)[2]) const {
    const float old = st[1];
    const float nn = nu_next(old, __fmul_rn(s, s));
    st[1] = __fadd_rn(old, __fsub_rn(nn, old));
    return with_denom(s, st[0], denom(nn));
  }

  __device__ __forceinline__ float operator()(float s, int64_t slot) const {
    float st[2] = {mu[slot], nu[slot]};
    const float out = apply(s, st);
    nu[slot] = st[1];
    mu[slot] = st[0];
    return out;
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

// ------------------------------------------------------------ row layout
//
// [rows, d] states, [K, d] values.  A warp takes a span of SPAN = 32
// consecutive entries, their indices read once, coalesced, a lane each.  A
// row is held in units of W floats (W = 4, 16-byte loads and stores, when
// d % 4 == 0 and the arrays are 16-byte aligned; else W = 1): padded to
// width = 2^ceil(log2 d) columns it is width / W units, held by LPR lanes
// (a power of two, at most 32), UPL units a lane, unit q = l + k * LPR in
// lane l's register k; a warp step covers RPI = 32 / LPR rows (a d = 64
// row: 16 float4s, a half-warp; a warp takes two rows an instruction).
// Unique stream: the warp walks its span's entries RPI at a time and loads
// the values and states of NF units a lane before it updates any, so every
// lane keeps 4 (W = 4) or 8 (W = 1) units of each array in flight; a
// sentinel writes zero units and reads nothing.  Bucketed stream: heads come
// from a ballot over the span; every entry that is not a live head gets a
// zero row, and each live head's run is folded by one row group, reading
// past the span's end if the run goes on, in head-aligned blocks of 8
// entries (the tree's bottom three levels in registers, both loads of a
// block in flight together) whose sums combine through a carry stack: its
// first REG_LEVELS levels in registers with static indices, the rest in
// shared memory, sized by K.  Adam's row-wise nu takes ref.py's row_mean
// order: zero-padded to width, halved by units of a lane, then by lanes
// (xor shuffles within the row's group), then within a unit; the
// denominator sqrt(nu'/bc2) + eps is then the row's, computed once.
constexpr int SPAN = 32;             // entries a warp takes at a time
constexpr int ROW_THREADS = 256;     // unique stream: 8 warps a block
constexpr int FOLD_THREADS = 128;    // bucketed: 4 warps (shared carries)
constexpr int FOLD_BLOCK = 8;        // entries a fold step loads
constexpr int REG_LEVELS = 5;        // carry levels in registers

// A row's geometry (see above): d, its units nq = d / W, log2 LPR and
// log2 UPL.
struct RowGeom {
  int d, nq, lpr_log2, upl_log2;
};

template <int W>
__device__ __forceinline__ void load(const float* p, float (&x)[W]) {
  if constexpr (W == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
    x[0] = *p;
  }
}

template <int W>
__device__ __forceinline__ void store(float* p, const float (&x)[W]) {
  if constexpr (W == 4)
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  else
    *p = x[0];
}

template <int W>
__device__ __forceinline__ void store_zero(float* p) {
  const float z[W] = {};
  store<W>(p, z);
}

// The units a lane has in flight: values, element-wise states (mu only for
// a row-wise Adam, whose row's old nu is nold), where they go, and whether
// a unit is one of the row's (valid) and the row a live one (live).
template <int NF, int W, int NS>
struct Slots {
  float v[NF][W];
  float st[NS][NF][W];
  float nold[NF];
  int32_t row[NF];
  int64_t uoff[NF], soff[NF];
  bool valid[NF], live[NF];
};

template <class Op, bool kRowwise, int NF, int W, int NS>
__device__ __forceinline__ void load_states(const Op& op,
                                            Slots<NF, W, NS>& sl) {
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    sl.nold[j] = 0.0f;
    if (!sl.live[j]) continue;
#pragma unroll
    for (int i = 0; i < NS; ++i) load<W>(op.state(i) + sl.soff[j], sl.st[i][j]);
    if constexpr (kRowwise) sl.nold[j] = op.nu[sl.row[j]];
  }
}

// The row mean's tree over x = s * s, as ref.row_mean sums it; the row's
// sum ends at its lane 0, unit 0, float 0.
template <int NF, int W>
__device__ __forceinline__ void row_tree(float (&x)[NF][W], const RowGeom& g) {
  const int upl = 1 << g.upl_log2;
#pragma unroll
  for (int h = NF / 2; h >= 1; h /= 2)          // units h apart in a lane
    if (h < upl)
#pragma unroll
      for (int j = 0; j + h < NF; ++j)
        if ((j & (upl - 1)) < h)
#pragma unroll
          for (int c = 0; c < W; ++c) x[j][c] = __fadd_rn(x[j][c], x[j + h][c]);
#pragma unroll
  for (int off = WARP / 2; off >= 1; off /= 2)  // lanes of the row's group
    if (off < (1 << g.lpr_log2))
#pragma unroll
      for (int j = 0; j < NF; ++j)
#pragma unroll
        for (int c = 0; c < W; ++c)
          x[j][c] = __fadd_rn(x[j][c], __shfl_xor_sync(FULL, x[j][c], off));
  if constexpr (W == 4)                         // within a unit
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      x[j][0] = __fadd_rn(x[j][0], x[j][2]);
      x[j][1] = __fadd_rn(x[j][1], x[j][3]);
      x[j][0] = __fadd_rn(x[j][0], x[j][1]);
    }
}

// The op on every valid unit (values v, states loaded), then the stores:
// update and states where live, a zero update elsewhere.  Every lane of
// the warp calls it (the row-wise tree shuffles).
template <class Op, bool kRowwise, int NF, int W, int NS>
__device__ __forceinline__ void update_slots(const Op& op,
                                             Slots<NF, W, NS>& sl,
                                             const RowGeom& g, int l, int grp,
                                             float* __restrict__ u) {
  float out[NF][W];
  if constexpr (kRowwise) {
    float x[NF][W];
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int c = 0; c < W; ++c)
        x[j][c] = sl.live[j] ? __fmul_rn(sl.v[j][c], sl.v[j][c]) : 0.0f;
    row_tree<NF, W>(x, g);
    float tot[NF];
#pragma unroll
    for (int j = 0; j < NF; ++j)
      tot[j] = __shfl_sync(FULL, x[j][0], grp << g.lpr_log2);
    const int upl = 1 << g.upl_log2;
#pragma unroll
    for (int h = 1; h < NF; h *= 2)             // every unit: its row's sum
      if (h < upl)
#pragma unroll
        for (int j = h; j < NF; ++j)
          if (j & h) tot[j] = tot[j - h];
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      if (!sl.live[j]) continue;
      const float nn = op.nu_next(
          sl.nold[j], __fdiv_rn(tot[j], static_cast<float>(g.d)));
      const float den = op.denom(nn);
#pragma unroll
      for (int c = 0; c < W; ++c)
        out[j][c] = op.with_denom(sl.v[j][c], sl.st[0][j][c], den);
      if (l == 0 && (j & (upl - 1)) == 0)
        op.nu[sl.row[j]] = __fadd_rn(sl.nold[j], __fsub_rn(nn, sl.nold[j]));
    }
  } else {
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int c = 0; c < W; ++c) {
        if (!sl.live[j]) continue;
        float st[NS];
#pragma unroll
        for (int i = 0; i < NS; ++i) st[i] = sl.st[i][j][c];
        out[j][c] = op.apply(sl.v[j][c], st);
#pragma unroll
        for (int i = 0; i < NS; ++i) sl.st[i][j][c] = st[i];
      }
  }
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    if (!sl.valid[j]) continue;
    if (!sl.live[j]) {
      store_zero<W>(u + sl.uoff[j]);
      continue;
    }
    store<W>(u + sl.uoff[j], out[j]);
#pragma unroll
    for (int i = 0; i < NS; ++i) store<W>(op.state(i) + sl.soff[j], sl.st[i][j]);
  }
}

// Unique stream (a sentinel tail): a span per warp.
template <class Op, bool kRowwise, int W>
__global__ void __launch_bounds__(ROW_THREADS)
    row_unique_kernel(const int32_t* __restrict__ idx,
                      const float* __restrict__ val, int64_t K, int32_t rows,
                      RowGeom g, Op op, float* __restrict__ u) {
  constexpr int NF = W == 4 ? 4 : 8;            // units in flight a lane
  constexpr int NS = kRowwise ? 1 : Op::kStates;
  const int lane = threadIdx.x % WARP;
  const int grp = lane >> g.lpr_log2, l = lane & ((1 << g.lpr_log2) - 1);
  const int rpi_log2 = 5 - g.lpr_log2;
  const int per_batch = NF >> g.upl_log2;       // warp steps a batch
  const int64_t s0 = (static_cast<int64_t>(blockIdx.x) * (blockDim.x / WARP) +
                      threadIdx.x / WARP) * SPAN;
  if (s0 >= K) return;
  const int n = K - s0 < SPAN ? static_cast<int>(K - s0) : SPAN;
  const int32_t mine = lane < n ? idx[s0 + lane] : rows;
  if (!__any_sync(FULL, mine >= 0 && mine < rows)) {    // all sentinels
    for (int64_t o = lane * W; o < static_cast<int64_t>(n) * g.d;
         o += WARP * W)
      store_zero<W>(u + s0 * g.d + o);
    return;
  }
  const int steps = (n + (1 << rpi_log2) - 1) >> rpi_log2;
  for (int t0 = 0; t0 < steps; t0 += per_batch) {
    Slots<NF, W, NS> sl;
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const int step = t0 + (j >> g.upl_log2);
      const int q = l + ((j & ((1 << g.upl_log2) - 1)) << g.lpr_log2);
      const int e = (step << rpi_log2) + grp;
      const int32_t row = __shfl_sync(FULL, mine, e & (WARP - 1));
      sl.valid[j] = step < steps && e < n && q < g.nq;
      sl.live[j] = sl.valid[j] && row >= 0 && row < rows;
      sl.row[j] = row;
      sl.uoff[j] = (s0 + e) * g.d + q * W;
      sl.soff[j] = static_cast<int64_t>(row) * g.d + q * W;
      if (sl.live[j]) load<W>(val + sl.uoff[j], sl.v[j]);
    }
    load_states<Op, kRowwise>(op, sl);
    update_slots<Op, kRowwise>(op, sl, g, l, grp, u);
  }
}

// Carry stack of one lane's run fold (as Carry above, over W floats at
// once): levels below REG_LEVELS in registers, the rest in shared memory
// (level k's float c at sh[(k * W + c) * WARP], this lane's column).
template <int W>
struct RowCarry {
  float* sh;
  float c[REG_LEVELS][W];
  uint32_t count = 0;

  // x merges with the levels below the first clear bit t of count (all
  // set) and lands on level t
  __device__ __forceinline__ void push(float (&x)[W]) {
    const int t = __ffs(~count) - 1;
#pragma unroll
    for (int k = 0; k < REG_LEVELS; ++k)
#pragma unroll
      for (int i = 0; i < W; ++i) {
        if (k < t) x[i] = __fadd_rn(c[k][i], x[i]);
        if (k == t) c[k][i] = x[i];
      }
    if (t >= REG_LEVELS) {
      for (int k = 0; k < t - REG_LEVELS; ++k)
#pragma unroll
        for (int i = 0; i < W; ++i)
          x[i] = __fadd_rn(sh[(k * W + i) * WARP], x[i]);
#pragma unroll
      for (int i = 0; i < W; ++i) sh[((t - REG_LEVELS) * W + i) * WARP] = x[i];
    }
    ++count;
  }

  __device__ __forceinline__ void finish(float (&out)[W]) const {  // count > 0
    bool have = false;
#pragma unroll
    for (int k = 0; k < REG_LEVELS; ++k)
      if ((count >> k) & 1u) {
#pragma unroll
        for (int i = 0; i < W; ++i)
          out[i] = have ? __fadd_rn(c[k][i], out[i]) : c[k][i];
        have = true;
      }
    for (int k = 0; (count >> (REG_LEVELS + k)) != 0; ++k)
      if ((count >> (REG_LEVELS + k)) & 1u) {
#pragma unroll
        for (int i = 0; i < W; ++i) {
          const float y = sh[(k * W + i) * WARP];
          out[i] = have ? __fadd_rn(y, out[i]) : y;
        }
        have = true;
      }
  }
};

// The run of `row` from its head h, columns [col, col + W): the aligned
// pairwise tree in head-aligned blocks of FOLD_BLOCK entries, as_reference
// applied.
template <int W>
__device__ __forceinline__ void fold_run(const int32_t* __restrict__ idx,
                                         const float* __restrict__ val,
                                         int64_t K, int64_t h, int32_t row,
                                         int d, int col, float* sh,
                                         float (&out)[W]) {
  RowCarry<W> carry{sh};
  int64_t n = 0;
  for (int64_t base = h;; base += FOLD_BLOCK) {
    int32_t ri[FOLD_BLOCK];
    float e[FOLD_BLOCK][W];
#pragma unroll
    for (int j = 0; j < FOLD_BLOCK; ++j) {      // both loads in flight
      const int64_t p = base + j;
      ri[j] = row + 1;
#pragma unroll
      for (int i = 0; i < W; ++i) e[j][i] = 0.0f;
      if (p < K) {
        ri[j] = idx[p];
        load<W>(val + p * d + col, e[j]);
      }
    }
    int cnt = 0;                 // sorted: the run's entries are a prefix
#pragma unroll
    for (int j = 0; j < FOLD_BLOCK; ++j) {
      const bool in = ri[j] == row;
      cnt += in;
#pragma unroll
      for (int i = 0; i < W; ++i) e[j][i] = in ? e[j][i] : 0.0f;
    }
    if (cnt == 0) break;         // the run ended on a block's edge
    float x[W];
#pragma unroll
    for (int i = 0; i < W; ++i) {
      float col8[FOLD_BLOCK];
#pragma unroll
      for (int j = 0; j < FOLD_BLOCK; ++j) col8[j] = e[j][i];
      x[i] = tree8(col8, cnt);
    }
    carry.push(x);
    n += cnt;
    if (cnt < FOLD_BLOCK) break;
  }
  carry.finish(out);
#pragma unroll
  for (int i = 0; i < W; ++i) out[i] = as_reference(out[i], n, K);
}

// Bucketed stream: a span per warp; sh_levels shared carry levels a lane.
template <class Op, bool kRowwise, int W>
__global__ void __launch_bounds__(FOLD_THREADS)
    row_fold_kernel(const int32_t* __restrict__ idx,
                    const float* __restrict__ val, int64_t K, int32_t rows,
                    RowGeom g, int sh_levels, Op op, float* __restrict__ u) {
  constexpr int NF = W == 4 ? 4 : 8;            // >= UPL: a row's units
  constexpr int NS = kRowwise ? 1 : Op::kStates;
  extern __shared__ float sh_carry[];
  const int lane = threadIdx.x % WARP;
  float* sh = sh_carry + (threadIdx.x / WARP) * sh_levels * W * WARP + lane;
  const int grp = lane >> g.lpr_log2, l = lane & ((1 << g.lpr_log2) - 1);
  const int rpi_log2 = 5 - g.lpr_log2;
  const int upl = 1 << g.upl_log2;
  const int64_t s0 = (static_cast<int64_t>(blockIdx.x) * (blockDim.x / WARP) +
                      threadIdx.x / WARP) * SPAN;
  if (s0 >= K) return;
  const int n = K - s0 < SPAN ? static_cast<int>(K - s0) : SPAN;
  const int32_t mine = lane < n ? idx[s0 + lane] : rows;
  int32_t prev = __shfl_up_sync(FULL, mine, 1);
  if (lane == 0) prev = s0 > 0 ? idx[s0 - 1] : ~mine;
  const bool head = lane < n && prev != mine;
  const unsigned live_heads =
      __ballot_sync(FULL, head && mine >= 0 && mine < rows);
  // a zero update for every entry that is not a live head
  const int steps = (n + (1 << rpi_log2) - 1) >> rpi_log2;
  for (int t = 0; t < steps; ++t) {
    const int e = (t << rpi_log2) + grp;
    if (e < n && !((live_heads >> e) & 1u))
      for (int k = 0; k < upl; ++k) {
        const int q = l + (k << g.lpr_log2);
        if (q < g.nq) store_zero<W>(u + (s0 + e) * g.d + q * W);
      }
  }
  // the live heads, a row group each: fold its run, then the op
  const int n_heads = __popc(live_heads);
  for (int h0 = 0; h0 < n_heads; h0 += 1 << rpi_log2) {
    const int hi = h0 + grp;
    unsigned rest = live_heads;                 // the hi-th live head
    for (int i = 0; i < hi && rest; ++i) rest &= rest - 1u;
    const bool has = hi < n_heads;
    const int e = has ? __ffs(rest) - 1 : 0;
    const int32_t row = __shfl_sync(FULL, mine, e);
    Slots<NF, W, NS> sl;
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const int q = l + (j << g.lpr_log2);
      sl.valid[j] = has && j < upl && q < g.nq;
      sl.live[j] = sl.valid[j];
      sl.row[j] = row;
      sl.uoff[j] = (s0 + e) * g.d + q * W;
      sl.soff[j] = static_cast<int64_t>(row) * g.d + q * W;
#pragma unroll
      for (int i = 0; i < W; ++i) sl.v[j][i] = 0.0f;
      if (sl.valid[j])
        fold_run<W>(idx, val, K, s0 + e, row, g.d, q * W, sh, sl.v[j]);
    }
    load_states<Op, kRowwise>(op, sl);
    update_slots<Op, kRowwise>(op, sl, g, l, grp, u);
  }
}

int grid_for(int64_t items, int per_block) {
  const int64_t want = (items + per_block - 1) / per_block;
  return static_cast<int>(want < (1 << 30) ? want : (1 << 30));
}

template <class Op, bool kRowwise, int W>
int launch_rows(const int32_t* idx, const float* val, int64_t K, int rows,
                int d, int unique, const Op& op, float* u,
                cudaStream_t stream) {
  int width = 1;
  while (width < d) width *= 2;
  const int units = width / W;
  const int lpr = units < WARP ? units : WARP;
  RowGeom g{d, d / W, 0, 0};
  while ((1 << g.lpr_log2) < lpr) ++g.lpr_log2;
  while ((lpr << g.upl_log2) < units) ++g.upl_log2;
  const int64_t n_spans = (K + SPAN - 1) / SPAN;      // a warp each
  if (unique) {
    row_unique_kernel<Op, kRowwise, W>
        <<<grid_for(n_spans, ROW_THREADS / WARP), ROW_THREADS, 0, stream>>>(
            idx, val, K, rows, g, op, u);
    return static_cast<int>(cudaGetLastError());
  }
  int bits = 0;                  // of the most 8-entry blocks a run can have
  for (int64_t c = (K + FOLD_BLOCK - 1) / FOLD_BLOCK; c; c >>= 1) ++bits;
  const int sh_levels = bits > REG_LEVELS + 1 ? bits - REG_LEVELS : 1;
  const size_t shm = static_cast<size_t>(FOLD_THREADS / WARP) * sh_levels *
                     W * WARP * sizeof(float);
  row_fold_kernel<Op, kRowwise, W>
      <<<grid_for(n_spans, FOLD_THREADS / WARP), FOLD_THREADS, shm, stream>>>(
          idx, val, K, rows, g, sh_levels, op, u);
  return static_cast<int>(cudaGetLastError());
}

// 16-byte units need the values, the updates and the element-wise states
// 16-byte aligned.
template <class Op, bool kRowwise>
bool aligned16(const void* val, const void* u, const Op& op) {
  constexpr int NS = kRowwise ? 1 : Op::kStates;
  uintptr_t bits = reinterpret_cast<uintptr_t>(val) |
                   reinterpret_cast<uintptr_t>(u);
  for (int i = 0; i < NS; ++i)
    bits |= reinterpret_cast<uintptr_t>(op.state(i));
  return bits % 16 == 0;
}

template <class Op, bool kRowwise = false>
int launch(const void* idx_, const void* val_, int64_t K, int m, int d,
           int unique, Op op, void* u_, void* long_head, cudaStream_t stream) {
  if (K == 0) return 0;
  const auto* idx = static_cast<const int32_t*>(idx_);
  const auto* val = static_cast<const float*>(val_);
  auto* u = static_cast<float*>(u_);
  if (d > 0) {
    if (d > MAX_D || K >= (int64_t{1} << 31))
      return static_cast<int>(cudaErrorInvalidValue);
    return d % 4 == 0 && aligned16<Op, kRowwise>(val, u, op)
               ? launch_rows<Op, kRowwise, 4>(idx, val, K, m, d, unique, op,
                                              u, stream)
               : launch_rows<Op, kRowwise, 1>(idx, val, K, m, d, unique, op,
                                              u, stream);
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
