// LMA locations: [N, S] D' sets -> [N, d] int32 pool slots.
//
// Replaces the TPU kernel repro/kernels/lma_locations/kernel.py
// (_locations_kernel, launched by lma_locations_pallas).  Same function:
// R = d*n_h (independent) or d+n_h-1 (sliding) minhashes over the
// PAD-masked set, the power-n_h fmix32 chain per column, then % m or the
// per-stripe offset.  No very-sparse fallback (that lives in fused_embed).
//
// What bounds it on Hopper: integer ALU issue, not bytes.  Per value it
// evaluates d*n_h*S hashes of ~15 int32 operations each (8,192 hashes at
// d=64, n_h=4, S=32) against ~384 bytes of traffic (the set row in, the
// location row out).  The design keeps everything on chip: one warp per
// value, the set compacted into shared memory once (hash_core.cuh), each
// lane computing whole columns in registers, so the only device-memory
// traffic is one read of the row and one coalesced write of the d slots.
// Sliding windows recompute each shared minhash in every window that uses
// it (n_h times); that mode is off the serving path and kept simple.
#include <cuda_runtime.h>

#include "hash_core.cuh"

namespace {

constexpr int WARPS_PER_BLOCK = 8;

__global__ void lma_locations_kernel(const uint32_t* __restrict__ sets, int N,
                                     int S, lma::LmaArgs a,
                                     int32_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  const int warp = threadIdx.x / lma::WARP, lane = threadIdx.x % lma::WARP;
  uint32_t* set = smem + warp * S;
  const int stride = gridDim.x * WARPS_PER_BLOCK;
  for (int v = blockIdx.x * WARPS_PER_BLOCK + warp; v < N; v += stride) {
    const int n = lma::stage_set(sets + static_cast<size_t>(v) * S, S, set,
                                 lane);
    for (int c = lane; c < a.d; c += lma::WARP)
      out[static_cast<size_t>(v) * a.d + c] = lma::lma_column(set, n, c, a);
    __syncwarp();  // the set buffer is restaged for the next value
  }
}

}  // namespace

extern "C" int lma_locations_launch(const void* sets, int N, int S, int d,
                                    int n_h, int independent, uint32_t seed,
                                    uint32_t m, uint32_t stripe, void* out,
                                    cudaStream_t stream) {
  if (N == 0) return 0;
  lma::LmaArgs a{d, n_h, independent, seed, m, stripe};
  const int blocks = (N + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  const size_t shm = WARPS_PER_BLOCK * S * sizeof(uint32_t);
  lma_locations_kernel<<<blocks, WARPS_PER_BLOCK * lma::WARP, shm, stream>>>(
      static_cast<const uint32_t*>(sets), N, S, a, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
