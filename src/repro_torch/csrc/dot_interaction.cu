// DLRM dot interaction: X [B, F, d] -> the strictly lower triangle of
// X X^T per sample, packed in np.tril_indices(F, k=-1) order, [B, F(F-1)/2].
//
// Replaces the TPU kernel repro/kernels/dot_interaction/kernel.py
// (_dot_kernel, launched by dot_interaction_pallas).  The TPU kernel ran the
// full F x F product on the MXU and packed the triangle with a second,
// selector matmul, because a TPU kernel has no cheap gather.  Here each pair
// is computed once and written to its packed place.
//
// What bounds it on Hopper: bytes, once the pairs are fed from registers.
// At DLRM's F=27, d=64 a sample reads 6.9 KB and writes 1.4 KB for 45K
// flops, ~5 flops per byte, far below the card's float32 ridge.  A design
// with one pair a thread re-reads both rows from shared memory for every
// multiply-add (2 scalar loads an FMA), and then the shared-load pipe, not
// device memory, sets the pace.  So:
//   - a thread owns a register tile of TI rows i by TJ rows j (2 x 4 pairs)
//     and reads its rows in 16-byte fragments (d % 4 == 0; scalar loads
//     otherwise): 6 loads feed 32 FMAs.  The tiles are listed once per F by
//     the binding (kernel.py, dot_tiles), so a thread finds its pairs with
//     no search.  A tile's j rows are j0, j0 + nt, ...,
//     j0 + 3 nt: neighbouring threads read neighbouring rows, which a row
//     stride of an odd number of 16-byte words puts in different banks;
//   - a block takes G samples at a time (the binding's group_size: 4 from
//     64 samples an SM on, else 1, whose finer groups spread a smaller batch
//     evenly over the SMs), staged into shared memory by cp.async and
//     double-buffered under a persistent loop over groups: group n + 1
//     loads while group n computes;
//   - the G packed rows, contiguous in the output, are staged in shared
//     memory and written by contiguous 16-byte stores where aligned.
// Each pair is one sequential fmaf chain over k = 0..d-1 in float32 on the
// CUDA cores, so the output's bits do not depend on the schedule.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TI = 2, TJ = 4;      // a thread's tile: TI rows i, TJ rows j
constexpr int MAX_THREADS = 512;   // leaves 128 registers a thread
constexpr int MAX_SMEM = 232448;   // a block's opt-in shared memory (227 KB)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one V-float copy from global to shared memory, asynchronous
template <int V>
__device__ __forceinline__ void copy(float* dst, const float* src) {
  if constexpr (V == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// all but this thread's newest group of copies have landed
__device__ __forceinline__ void wait_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// floats between staged rows: an odd number of V-float words, so rows that
// neighbouring threads read at the same k lie in different banks
__host__ __device__ __forceinline__ int row_stride(int d, int V) {
  return V * ((d / V) | 1);
}

// Stage the `rows` rows of d floats at src into dst, ds floats apart.
template <int V>
__device__ __forceinline__ void stage(const float* __restrict__ src,
                                      int rows, int d, int ds, float* dst) {
  const int per_row = d / V;
  const int n = rows * per_row;
  int r = threadIdx.x / per_row, c = threadIdx.x - r * per_row;
  const int dr = blockDim.x / per_row, dc = blockDim.x - dr * per_row;
  for (int q = threadIdx.x; q < n; q += blockDim.x) {
    copy<V>(dst + r * ds + c * V, src + static_cast<size_t>(r) * d + c * V);
    r += dr;
    c += dc;
    if (c >= per_row) {
      c -= per_row;
      ++r;
    }
  }
}

// x [B, F, d] -> out [B, P]; tiles [n_tiles] packed i0 | j0 << 10 | nt << 20
template <int V>
__global__ void __launch_bounds__(MAX_THREADS)
    dot_interaction_kernel(const float* __restrict__ x, int B, int F, int d,
                           int G, const int32_t* __restrict__ tiles,
                           int n_tiles, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int P = F * (F - 1) / 2;
  const int ds = row_stride(d, V);
  float* zs = smem;                                  // [G, P], packed rows
  float* xs0 = smem + ((G * P + 3) & ~3);            // [G, F, ds] x 2
  const int buf = G * F * ds;
  const int n_groups = (B + G - 1) / G;
  const bool vec_out = (G * P) % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;

  int grp = blockIdx.x;
  if (grp < n_groups)
    stage<V>(x + static_cast<size_t>(grp) * G * F * d,
             min(G, B - grp * G) * F, d, ds, xs0);
  commit();
  for (int it = 0; grp < n_groups; grp += gridDim.x, ++it) {
    const int next = grp + gridDim.x;
    if (next < n_groups)   // its buffer was last read before the last barrier
      stage<V>(x + static_cast<size_t>(next) * G * F * d,
               min(G, B - next * G) * F, d, ds, xs0 + ((it + 1) & 1) * buf);
    commit();
    wait_but_one();
    __syncthreads();
    const float* xb = xs0 + (it & 1) * buf;
    const int ns = min(G, B - grp * G);
    for (int w = threadIdx.x; w < ns * n_tiles; w += blockDim.x) {
      const int s = w / n_tiles;
      const int32_t tile = __ldg(tiles + (w - s * n_tiles));
      const int i0 = tile & 0x3FF, j0 = (tile >> 10) & 0x3FF, nt = tile >> 20;
      const float* xsam = xb + s * F * ds;
      const float* ra[TI];
      const float* rb[TJ];
#pragma unroll
      for (int a = 0; a < TI; ++a) ra[a] = xsam + min(i0 + a, F - 1) * ds;
#pragma unroll
      for (int b = 0; b < TJ; ++b) rb[b] = xsam + min(j0 + b * nt, F - 1) * ds;
      float acc[TI][TJ];
#pragma unroll
      for (int a = 0; a < TI; ++a)
#pragma unroll
        for (int b = 0; b < TJ; ++b) acc[a][b] = 0.0f;
      if constexpr (V == 4) {
#pragma unroll 2
        for (int k = 0; k < d; k += 4) {
          float4 av[TI], bv[TJ];
#pragma unroll
          for (int a = 0; a < TI; ++a)
            av[a] = *reinterpret_cast<const float4*>(ra[a] + k);
#pragma unroll
          for (int b = 0; b < TJ; ++b)
            bv[b] = *reinterpret_cast<const float4*>(rb[b] + k);
#pragma unroll
          for (int a = 0; a < TI; ++a)
#pragma unroll
            for (int b = 0; b < TJ; ++b) {
              acc[a][b] = fmaf(av[a].x, bv[b].x, acc[a][b]);
              acc[a][b] = fmaf(av[a].y, bv[b].y, acc[a][b]);
              acc[a][b] = fmaf(av[a].z, bv[b].z, acc[a][b]);
              acc[a][b] = fmaf(av[a].w, bv[b].w, acc[a][b]);
            }
        }
      } else {
#pragma unroll 4
        for (int k = 0; k < d; ++k) {
          float av[TI], bv[TJ];
#pragma unroll
          for (int a = 0; a < TI; ++a) av[a] = ra[a][k];
#pragma unroll
          for (int b = 0; b < TJ; ++b) bv[b] = rb[b][k];
#pragma unroll
          for (int a = 0; a < TI; ++a)
#pragma unroll
            for (int b = 0; b < TJ; ++b)
              acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
        }
      }
      float* zsam = zs + s * P;
#pragma unroll
      for (int a = 0; a < TI; ++a) {
        const int i = i0 + a;
#pragma unroll
        for (int b = 0; b < TJ; ++b) {
          const int j = j0 + b * nt;
          if (i < F && j < i) zsam[i * (i - 1) / 2 + j] = acc[a][b];
        }
      }
    }
    __syncthreads();
    // the group's ns packed rows are one contiguous span of the output
    float* o = out + static_cast<size_t>(grp) * G * P;
    const int n = ns * P;
    int q0 = 0;
    if (vec_out) {
      for (int q = threadIdx.x; q < n / 4; q += blockDim.x)
        reinterpret_cast<float4*>(o)[q] =
            reinterpret_cast<const float4*>(zs)[q];
      q0 = n & ~3;
    }
    for (int q = q0 + threadIdx.x; q < n; q += blockDim.x) o[q] = zs[q];
    // zs is rewritten only after the next group's first barrier
  }
}

template <int V>
cudaError_t launch(const float* x, int B, int F, int d, int G,
                   const int32_t* tiles, int n_tiles, float* out,
                   cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      dot_interaction_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      MAX_SMEM);
  if (attr != cudaSuccess) return attr;
  const int P = F * (F - 1) / 2;
  const size_t shm =
      sizeof(float) * (((G * P + 3) & ~3) +
                       2 * static_cast<size_t>(G) * F * row_stride(d, V));
  if (shm > static_cast<size_t>(MAX_SMEM)) return cudaErrorInvalidValue;
  const int work = G * n_tiles;
  const int threads =
      work >= MAX_THREADS ? MAX_THREADS : (work + 31) / 32 * 32;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, dot_interaction_kernel<V>, threads, shm);
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int n_groups = (B + G - 1) / G;
  const int grid = n_groups < per_sm * sms ? n_groups : per_sm * sms;
  dot_interaction_kernel<V><<<grid, threads, shm, stream>>>(
      x, B, F, d, G, tiles, n_tiles, out);
  return cudaGetLastError();
}

}  // namespace

// x [B, F, d] float32 -> out [B, F(F-1)/2]; G samples a group; vec: 16-byte
// fragments (d % 4 == 0 and x 16-byte aligned), else scalar; tiles: the
// binding's list for F (dot_tiles).
extern "C" int dot_interaction_launch(const void* x, int B, int F, int d,
                                      int G, int vec, const void* tiles,
                                      int n_tiles, void* out,
                                      cudaStream_t stream) {
  if (B == 0 || F < 2) return 0;
  if (d == 0)   // empty sums
    return static_cast<int>(cudaMemsetAsync(
        out, 0, sizeof(float) * B * (F * (F - 1) / 2), stream));
  if (G < 1 || n_tiles < 1 || F > 1023 ||
      (vec && (d % 4 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xf = static_cast<const float*>(x);
  const auto* t = static_cast<const int32_t*>(tiles);
  auto* o = static_cast<float*>(out);
  return static_cast<int>(vec ? launch<4>(xf, B, F, d, G, t, n_tiles, o,
                                          stream)
                              : launch<1>(xf, B, F, d, G, t, n_tiles, o,
                                          stream));
}
