// Fused embedding lookup: value ids (+ D' sets and support for lma) ->
// pool gather, optionally bag-pooled with weights, in one pass.
//
// Replaces the TPU kernel repro/kernels/fused_embed/kernel.py (_fwd_kernel,
// launched by fused_lookup_fwd_pallas).  Same function: lma locations with
// the very-sparse A_h fallback (support < min_support -> hash_pair(v, i)
// under seed ^ 0x1234567, striped when stripe > 0), or hashed_elem /
// hashed_row locations; then the gather M[loc] written as [N, d], or with
// weights the bag sum over L accumulated on chip and written as [B, d].  The
// [N, d] locations and the [B, L, d] pre-pool tensor never reach device
// memory.
//
// The TPU kernel held the whole pool in VMEM and so had a size gate; here
// the gather reads device memory directly, so every pool size is served.
//
// What bounds it on Hopper: for lma, integer ALU issue.  Per looked-up
// value it evaluates d*n_h*S hashes of ~15 int32 operations (8,192 hashes,
// ~123K operations at dlrm-rm2's d=64, n_h=4, S=32) against ~650 bytes that
// must move (the set row, id and support in; d gathered floats; d floats
// out).  The design follows that: one warp per output row, the set
// compacted into shared memory once (hash_core.cuh), the hash chain in
// registers, fallback rows skip the minhash entirely (a warp-uniform
// branch), and each lane gathers and writes its own columns, so a warp's
// gathers and stores cover adjacent slots of a stripe row-wise.  hashed_*
// schemes are gather-bound and take the same path with no minhash.
#include <cuda_runtime.h>

#include "hash_core.cuh"

namespace {

constexpr int WARPS_PER_BLOCK = 8;
enum Scheme { LMA = 0, HASHED_ELEM = 1, HASHED_ROW = 2 };

struct FusedArgs {
  int scheme;
  int min_support;
  lma::LmaArgs a;
};

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

// rows: B output rows of L values each (L = 1 and weights == nullptr for
// the flat lookup).  sets [B*L, S] (lma only), gids/support [B*L].
__global__ void fused_lookup_kernel(const uint32_t* __restrict__ sets,
                                    const int32_t* __restrict__ gids,
                                    const int32_t* __restrict__ support,
                                    const float* __restrict__ weights,
                                    const float* __restrict__ mem, int B,
                                    int L, int S, FusedArgs f,
                                    float* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  const int d = f.a.d;
  const int warp = threadIdx.x / lma::WARP, lane = threadIdx.x % lma::WARP;
  uint32_t* set = smem + warp * (S + d);
  float* acc = reinterpret_cast<float*>(set + S);  // bag sums, own columns
  const int stride = gridDim.x * WARPS_PER_BLOCK;
  for (int b = blockIdx.x * WARPS_PER_BLOCK + warp; b < B; b += stride) {
    if (weights)
      for (int c = lane; c < d; c += lma::WARP) acc[c] = 0.0f;
    for (int l = 0; l < L; ++l) {
      const size_t v = static_cast<size_t>(b) * L + l;
      const uint32_t gid = static_cast<uint32_t>(gids[v]);
      const bool fallback = f.scheme == LMA && support[v] < f.min_support;
      int n = 0;
      if (f.scheme == LMA && !fallback) {   // warp-uniform branch
        n = lma::stage_set(sets + v * S, S, set, lane);
      }
      const float w = weights ? weights[v] : 0.0f;
      for (int c = lane; c < d; c += lma::WARP) {
        const float e = __ldg(mem + slot(f, fallback, set, n, gid, c));
        if (weights)  // product, then sum: no fused multiply-add
          acc[c] = __fadd_rn(acc[c], __fmul_rn(w, e));
        else
          out[v * d + c] = e;
      }
      __syncwarp();  // the set buffer is restaged for the next value
    }
    if (weights)
      for (int c = lane; c < d; c += lma::WARP)
        out[static_cast<size_t>(b) * d + c] = acc[c];
  }
}

}  // namespace

// Flat lookup: weights == nullptr, L == 1, out [N, d].
// Bag lookup: weights [B, L], out [B, d].
extern "C" int fused_lookup_launch(const void* sets, const void* gids,
                                   const void* support, const void* weights,
                                   const void* mem, int B, int L, int S,
                                   int scheme, int d, int n_h,
                                   int independent, uint32_t seed,
                                   uint32_t m, uint32_t stripe,
                                   int min_support, void* out,
                                   cudaStream_t stream) {
  if (B == 0) return 0;
  FusedArgs f{scheme, min_support, {d, n_h, independent, seed, m, stripe}};
  const int blocks = (B + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  const size_t shm = WARPS_PER_BLOCK * (S + d) * sizeof(uint32_t);
  fused_lookup_kernel<<<blocks, WARPS_PER_BLOCK * lma::WARP, shm, stream>>>(
      static_cast<const uint32_t*>(sets), static_cast<const int32_t*>(gids),
      static_cast<const int32_t*>(support),
      static_cast<const float*>(weights), static_cast<const float*>(mem), B,
      L, S, f, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
