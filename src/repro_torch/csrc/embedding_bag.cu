// Full-table weighted embedding bag: out[b, :] = sum_l w[b, l] * T[ids[b, l], :].
//
// Replaces the TPU kernel repro/kernels/embedding_bag/kernel.py
// (_bag_kernel, launched by embedding_bag_pallas).  The TPU had no fast
// gather, so it built a one-hot matrix A[b, v] = sum_l w[b, l] [ids[b, l] ==
// v] a vocabulary tile at a time and multiplied it with the table tile on
// its matrix unit: O(B * V * d) operations for O(B * L * d) useful ones.
// Hopper gathers natively, so this is the gather itself: one warp per bag,
// its lanes over d (column lane + 32 k in register k, so a d = 64 row is one
// coalesced 256-byte read).  The warp reads the bag's ids and weights once,
// 32 at a time, one per lane, and hands each to every lane by a shuffle;
// each lane then adds w * T[id, c] to its columns, l in order.  An id
// outside [0, V) adds nothing, as a one-hot row with no 1 would.
//
// What bounds it: bytes -- the B * L gathered rows (4 d bytes each), the ids
// and weights (8 bytes a term) and the output (4 d bytes a bag); two flops a
// gathered element are far below the card's rate.  Rows of a large table
// are scattered, so each is its own 256-byte read.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WARP = 32;
constexpr int THREADS = 256;
constexpr int MAX_COLS = 8;     // columns a lane holds: d <= 256
constexpr unsigned FULL = 0xFFFFFFFFu;

__global__ void bag_kernel(const float* __restrict__ table,
                           const int32_t* __restrict__ ids,
                           const float* __restrict__ w, int64_t V, int d,
                           int B, int L, float* __restrict__ out) {
  const int lane = threadIdx.x % WARP;
  const int warps = gridDim.x * (blockDim.x / WARP);
  for (int b = blockIdx.x * (blockDim.x / WARP) + threadIdx.x / WARP; b < B;
       b += warps) {
    float acc[MAX_COLS];
#pragma unroll
    for (int k = 0; k < MAX_COLS; ++k) acc[k] = 0.0f;
    const int64_t bag = static_cast<int64_t>(b) * L;
    for (int l0 = 0; l0 < L; l0 += WARP) {
      const int mine = l0 + lane;
      const int32_t my_id = mine < L ? ids[bag + mine] : -1;
      const float my_w = mine < L ? w[bag + mine] : 0.0f;
      const int n = L - l0 < WARP ? L - l0 : WARP;
      for (int j = 0; j < n; ++j) {
        const int32_t id = __shfl_sync(FULL, my_id, j);
        const float wt = __shfl_sync(FULL, my_w, j);
        if (id < 0 || id >= V) continue;        // the same for every lane
        const float* row = table + static_cast<int64_t>(id) * d;
#pragma unroll
        for (int k = 0; k < MAX_COLS; ++k) {
          const int c = lane + k * WARP;
          if (c < d) acc[k] = fmaf(wt, row[c], acc[k]);
        }
      }
    }
    float* o = out + static_cast<int64_t>(b) * d;
#pragma unroll
    for (int k = 0; k < MAX_COLS; ++k) {
      const int c = lane + k * WARP;
      if (c < d) o[c] = acc[k];
    }
  }
}

}  // namespace

// table [V, d] f32, ids [B, L] int32, w [B, L] f32, out [B, d] f32.
extern "C" int embedding_bag_launch(const void* table, const void* ids,
                                    const void* w, int64_t V, int d, int B,
                                    int L, void* out, cudaStream_t stream) {
  if (B == 0 || d == 0) return 0;
  if (d > MAX_COLS * WARP) return static_cast<int>(cudaErrorInvalidValue);
  const int per_block = THREADS / WARP;
  const int64_t want = (static_cast<int64_t>(B) + per_block - 1) / per_block;
  const int blocks = static_cast<int>(want < (1 << 30) ? want : (1 << 30));
  bag_kernel<<<blocks, THREADS, 0, stream>>>(
      static_cast<const float*>(table), static_cast<const int32_t*>(ids),
      static_cast<const float*>(w), V, d, B, L, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
