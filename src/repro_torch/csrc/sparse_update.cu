// Lazy sparse Adagrad over the K touched pool slots, with the duplicate fold
// done in the same pass.
//
// Replaces the TPU kernel repro/kernels/sparse_update/kernel.py
// (_adagrad_kernel and _gather_keep, launched through _call by
// sparse_adagrad_pallas).  Same function, on the SparseGrad contract:
// indices [K] int32 sorted, either unique with a sentinel (= m) tail
// (unique = 1) or with duplicate runs (unique = 0, the bucketed stream).  Per
// live slot, with s the slot's value (the run's sum when unique = 0):
//   acc[slot] += s * s;   u = -lr * s / (sqrt(acc[slot]) + eps)
// u is written at the run's head and 0 everywhere else (sentinels, and the
// non-head positions of a run).  acc is updated in place, at touched slots
// only, so untouched slots keep their bits.
//
// The run sum is taken in the order of the reference's fold_duplicates
// (repro/kernels/sparse_update/ref.py): its segmented doubling scan leaves
// at a run's head the pairwise tree aligned at the head -- blocks of 2^l
// entries starting at the head, each block the sum of its left and right
// halves, a right half that starts past the run's end dropped.  A carry
// stack (push each entry, merge the top two while their blocks are equal)
// adds in exactly that order, and every product and sum below is rounded on
// its own (no fused multiply-add), so the kernel is bit-identical to the
// plain version, not merely close.
//
// What bounds it on Hopper: bytes.  Each entry's index, value and update
// (12 bytes) move once, and each touched slot's accumulator is read and
// written once; the arithmetic is a few operations per slot.  Runs can be
// long: a value of a 3-value field is looked up ~20,000 times in a 65,536
// batch, and LMA shares slots across similar values on purpose.  So the work
// splits by run length.  Pass 1 gives one thread to each entry: a head of a
// run of at most SHORT_RUN entries sums it serially (its reads hit the lines
// its neighbours read), non-heads write 0, and the heads of longer runs go
// on a list.  Pass 2 gives one warp to each listed run: 256 entries at a
// time, each lane sums its 8 in order, the warp combines lanes by shuffles
// in the same tree, and the 256-blocks go through the carry stack, so a run
// of 2^15 entries costs one warp 128 coalesced rounds.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WARP = 32;
constexpr int THREADS = 256;
constexpr int SHORT_RUN = 32;   // longer runs go to the warp pass
constexpr int LANE_SPAN = 8;    // entries one lane sums per round
constexpr int MAX_DEPTH = 40;   // carry-stack depth: > log2(K) + 1

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

__device__ __forceinline__ float adagrad_slot(float s, int32_t slot,
                                              float* acc, float neg_lr,
                                              float eps) {
  const float a = __fadd_rn(acc[slot], __fmul_rn(s, s));
  acc[slot] = a;
  return __fdiv_rn(__fmul_rn(neg_lr, s), __fadd_rn(__fsqrt_rn(a), eps));
}

// Pass 1: one thread per entry.
__global__ void adagrad_short_kernel(const int32_t* __restrict__ idx,
                                     const float* __restrict__ val, int64_t K,
                                     int32_t m, float neg_lr, float eps,
                                     int unique, float* __restrict__ acc,
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
        out = adagrad_slot(tree.finish(), slot, acc, neg_lr, eps);
      }
    }
    u[i] = out;
  }
}

// Pass 2: one warp per run longer than SHORT_RUN.
__global__ void adagrad_long_kernel(const int32_t* __restrict__ idx,
                                    const float* __restrict__ val, int64_t K,
                                    float neg_lr, float eps,
                                    float* __restrict__ acc,
                                    float* __restrict__ u,
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
        cnt += __shfl_xor_sync(0xFFFFFFFFu, cnt, off);
      if (cnt == 0) break;           // the run ended on a round boundary
      for (int off = 1; off < WARP; off *= 2) {
        const float y = __shfl_down_sync(0xFFFFFFFFu, x, off);
        if ((lane & (2 * off - 1)) == 0 && (lane + off) * LANE_SPAN < cnt)
          x = __fadd_rn(x, y);
      }
      blocks.push(__shfl_sync(0xFFFFFFFFu, x, 0));
      if (cnt < WARP * LANE_SPAN) break;
    }
    const float s = blocks.finish();
    if (lane == 0) u[h] = adagrad_slot(s, slot, acc, neg_lr, eps);
  }
}

}  // namespace

// idx [K] int32, val [K] f32, acc [m] f32 (updated in place), u [K] f32
// out; long_heads [K / (SHORT_RUN + 1) + 1] int64 and n_long [1] int32
// (zeroed by the caller) are scratch.
extern "C" int sparse_adagrad_launch(const void* idx, const void* val,
                                     int64_t K, int m, float neg_lr,
                                     float eps, int unique, void* acc,
                                     void* u, void* long_heads, void* n_long,
                                     cudaStream_t stream) {
  if (K == 0) return 0;
  const int64_t want = (K + THREADS - 1) / THREADS;
  const int blocks = static_cast<int>(want < (1 << 30) ? want : (1 << 30));
  adagrad_short_kernel<<<blocks, THREADS, 0, stream>>>(
      static_cast<const int32_t*>(idx), static_cast<const float*>(val), K, m,
      neg_lr, eps, unique, static_cast<float*>(acc), static_cast<float*>(u),
      static_cast<int64_t*>(long_heads), static_cast<int*>(n_long));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || unique) return static_cast<int>(err);
  adagrad_long_kernel<<<132 * 8, THREADS, 0, stream>>>(
      static_cast<const int32_t*>(idx), static_cast<const float*>(val), K,
      neg_lr, eps, static_cast<float*>(acc), static_cast<float*>(u),
      static_cast<const int64_t*>(long_heads),
      static_cast<const int*>(n_long));
  return static_cast<int>(cudaGetLastError());
}
