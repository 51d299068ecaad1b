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
// halves, a right half that starts past the run's end dropped.  A carry
// stack (push each entry, merge the top two while their blocks are equal)
// adds in exactly that order, and every product, sum, quotient and root
// below is rounded on its own (no fused multiply-add); the scalars (-lr,
// 1-b1, 1-b2, eps, bc1, bc2) arrive rounded to float32, as the reference's
// weakly typed Python floats are.  So the kernels are bit-identical to the
// plain versions, not merely close.
//
// What bounds them on Hopper: bytes.  Each entry's index, value and update
// (12 bytes) move once, and each touched slot's states are read and written
// once (8 bytes a state); the arithmetic is a few operations per slot.
// Flat layout: runs can be long (a value of a 3-value field is looked up
// ~20,000 times in a 65,536 batch, and LMA shares slots across similar
// values on purpose), so the work splits by run length.  Pass 1 gives one
// thread to each entry: a head of a run of at most SHORT_RUN entries sums
// it serially (its reads hit the lines its neighbours read), non-heads
// write 0, and the heads of longer runs go on a list.  Pass 2 gives one
// warp to each listed run: 256 entries at a time, each lane sums its 8 in
// order, the warp combines lanes by shuffles in the same tree, and the
// 256-blocks go through the carry stack, so a run of 2^15 entries costs one
// warp 128 coalesced rounds.  Row layout: one warp per index with its lanes
// over d, so a d = 64 row is one coalesced 256-byte read or write; a run is
// folded per column, one carry stack at a time.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WARP = 32;
constexpr int THREADS = 256;
constexpr int SHORT_RUN = 32;   // longer runs go to the warp pass
constexpr int LANE_SPAN = 8;    // entries one lane sums per round
constexpr int MAX_DEPTH = 40;   // carry-stack depth: > log2(K) + 1
constexpr int MAX_COLS = 8;     // row layout: columns a lane holds, d <= 256
constexpr unsigned FULL = 0xFFFFFFFFu;

// Carry stack for the aligned pairwise tree.  push() takes the leaves (or
// equal-sized blocks) in order; finish() combines what is left from the
// right, which is how the tree truncates at the run's end.
struct Pairwise {
  float part[MAX_DEPTH];
  int top = 0;
  unsigned count = 0;

  __device__ __forceinline__ void push(float x) {
    for (unsigned k = ++count; (k & 1u) == 0; k >>= 1)
      x = __fadd_rn(part[--top], x);
    part[top++] = x;
  }

  __device__ __forceinline__ float finish() {
    float acc = part[--top];
    while (top > 0) acc = __fadd_rn(part[--top], acc);
    return acc;
  }
};

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

// Flat pass 1: one thread per entry.
template <class Op>
__global__ void flat_short_kernel(const int32_t* __restrict__ idx,
                                  const float* __restrict__ val, int64_t K,
                                  int32_t m, int unique, Op op,
                                  float* __restrict__ u,
                                  int64_t* __restrict__ long_heads,
                                  int* __restrict__ n_long) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < K; i += stride) {
    const int32_t slot = idx[i];
    float out = 0.0f;
    const bool live = slot >= 0 && slot < m;
    if (live && (unique || i == 0 || idx[i - 1] != slot)) {
      int n = 1;
      if (!unique)
        while (n <= SHORT_RUN && i + n < K && idx[i + n] == slot) ++n;
      if (n > SHORT_RUN) {          // pass 2 writes this head's update
        long_heads[atomicAdd(n_long, 1)] = i;
      } else {
        Pairwise tree;
        for (int j = 0; j < n; ++j) tree.push(val[i + j]);
        out = op(tree.finish(), slot);
      }
    }
    u[i] = out;
  }
}

// Flat pass 2: one warp per run longer than SHORT_RUN.
template <class Op>
__global__ void flat_long_kernel(const int32_t* __restrict__ idx,
                                 const float* __restrict__ val, int64_t K,
                                 Op op, float* __restrict__ u,
                                 const int64_t* __restrict__ long_heads,
                                 const int* __restrict__ n_long) {
  const int lane = threadIdx.x % WARP;
  const int warps = gridDim.x * (blockDim.x / WARP);
  const int count = *n_long;
  for (int r = blockIdx.x * (blockDim.x / WARP) + threadIdx.x / WARP;
       r < count; r += warps) {
    const int64_t h = long_heads[r];
    const int32_t slot = idx[h];
    Pairwise blocks;                 // every lane keeps the same stack
    for (int64_t base = h;; base += WARP * LANE_SPAN) {
      // this lane's 8 entries; the run is a prefix of the round
      float e[LANE_SPAN];
      int mine = 0;
#pragma unroll
      for (int k = 0; k < LANE_SPAN; ++k) {
        const int64_t p = base + lane * LANE_SPAN + k;
        const bool in = p < K && idx[p] == slot;
        e[k] = in ? val[p] : 0.0f;
        mine += in;
      }
      Pairwise lane_tree;
      for (int k = 0; k < mine; ++k) lane_tree.push(e[k]);
      float x = mine ? lane_tree.finish() : 0.0f;
      int cnt = mine;                // entries of the run in this round
      for (int off = WARP / 2; off > 0; off /= 2)
        cnt += __shfl_xor_sync(FULL, cnt, off);
      if (cnt == 0) break;           // the run ended on a round boundary
      for (int off = 1; off < WARP; off *= 2) {
        const float y = __shfl_down_sync(FULL, x, off);
        if ((lane & (2 * off - 1)) == 0 && (lane + off) * LANE_SPAN < cnt)
          x = __fadd_rn(x, y);
      }
      blocks.push(__shfl_sync(FULL, x, 0));
      if (cnt < WARP * LANE_SPAN) break;
    }
    const float s = blocks.finish();
    if (lane == 0) u[h] = op(s, slot);
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
        Pairwise tree;               // one column's run, in order
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
           int unique, Op op, void* u_, void* long_heads, void* n_long,
           cudaStream_t stream) {
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
  flat_short_kernel<Op><<<grid_for(K, THREADS), THREADS, 0, stream>>>(
      idx, val, K, m, unique, op, u, static_cast<int64_t*>(long_heads),
      static_cast<int*>(n_long));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || unique) return static_cast<int>(err);
  flat_long_kernel<Op><<<132 * 8, THREADS, 0, stream>>>(
      idx, val, K, op, u, static_cast<const int64_t*>(long_heads),
      static_cast<const int*>(n_long));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Common arguments: idx [K] int32, val [K] (d = 0) or [K, d] f32, m the
// states' leading dim (the sentinel), u [K] or [K, d] f32 out; long_heads
// [K / (SHORT_RUN + 1) + 1] int64 and n_long [1] int32 (zeroed by the
// caller) are the flat layout's scratch.  States are updated in place.
extern "C" int sparse_adagrad_launch(const void* idx, const void* val,
                                     int64_t K, int m, int d, int unique,
                                     float neg_lr, float eps, void* acc,
                                     void* u, void* long_heads, void* n_long,
                                     cudaStream_t stream) {
  return launch(idx, val, K, m, d, unique,
                AdagradOp{static_cast<float*>(acc), neg_lr, eps}, u,
                long_heads, n_long, stream);
}

extern "C" int sparse_sgd_launch(const void* idx, const void* val, int64_t K,
                                 int m, int d, int unique, float momentum,
                                 float neg_lr, void* mo, void* u,
                                 void* long_heads, void* n_long,
                                 cudaStream_t stream) {
  return launch(idx, val, K, m, d, unique,
                SgdOp{static_cast<float*>(mo), momentum, neg_lr}, u,
                long_heads, n_long, stream);
}

// rowwise = 1: nu [rows] against [K, d] values (d > 0).
extern "C" int sparse_adam_launch(const void* idx, const void* val,
                                  int64_t K, int m, int d, int unique,
                                  int rowwise, float b1, float omb1, float b2,
                                  float omb2, float neg_lr, float bc1,
                                  float bc2, float eps, void* mu, void* nu,
                                  void* u, void* long_heads, void* n_long,
                                  cudaStream_t stream) {
  const AdamOp op{static_cast<float*>(mu), static_cast<float*>(nu), b1, omb1,
                  b2, omb2, neg_lr, bc1, bc2, eps};
  if (rowwise)
    return d > 0 ? launch<AdamOp, true>(idx, val, K, m, d, unique, op, u,
                                         long_heads, n_long, stream)
                 : static_cast<int>(cudaErrorInvalidValue);
  return launch(idx, val, K, m, d, unique, op, u, long_heads, n_long, stream);
}
