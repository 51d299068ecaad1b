// DLRM dot interaction: X [B, F, d] -> the strictly lower triangle of
// X X^T per sample, packed in np.tril_indices(F, k=-1) order, [B, F(F-1)/2].
//
// Replaces the TPU kernel repro/kernels/dot_interaction/kernel.py
// (_dot_kernel, launched by dot_interaction_pallas).  The TPU kernel ran the
// full F x F product on the MXU and packed the triangle with a second,
// selector matmul, because a TPU kernel has no cheap gather.  Here each
// thread computes exactly one packed pair and writes it to its place.
//
// What bounds it on Hopper: bytes.  At DLRM's F=27, d=64 a sample reads
// 6.9 KB and writes 1.4 KB for 45K flops, ~5 flops per byte, far below the
// card's float32 ridge.  So the design reads each sample once: one block
// per sample stages X in shared memory (rows padded to d+1 floats, so the
// threads of a warp, which read different rows at the same column, hit
// different banks), then thread p computes pair p from shared memory and
// the block's stores of the packed row are contiguous.
#include <cuda_runtime.h>

namespace {

__global__ void dot_interaction_kernel(const float* __restrict__ x, int F,
                                       int d, float* __restrict__ out) {
  extern __shared__ float xs[];  // [F, d + 1]
  const int b = blockIdx.x;
  const int P = F * (F - 1) / 2;
  const float* xb = x + static_cast<size_t>(b) * F * d;
  for (int i = threadIdx.x; i < F * d; i += blockDim.x)
    xs[(i / d) * (d + 1) + i % d] = xb[i];
  __syncthreads();
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    int i = 1;  // p = i*(i-1)/2 + j with 0 <= j < i
    while ((i + 1) * i / 2 <= p) ++i;
    const int j = p - i * (i - 1) / 2;
    const float* xi = xs + i * (d + 1);
    const float* xj = xs + j * (d + 1);
    float s = 0.0f;
    for (int k = 0; k < d; ++k) s = fmaf(xi[k], xj[k], s);
    out[static_cast<size_t>(b) * P + p] = s;
  }
}

}  // namespace

extern "C" int dot_interaction_launch(const void* x, int B, int F, int d,
                                      void* out, cudaStream_t stream) {
  const int P = F * (F - 1) / 2;
  if (B == 0 || P == 0) return 0;
  int threads = ((P + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const size_t shm = static_cast<size_t>(F) * (d + 1) * sizeof(float);
  dot_interaction_kernel<<<B, threads, shm, stream>>>(
      static_cast<const float*>(x), F, d, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
