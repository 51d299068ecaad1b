// xDeepFM Compressed Interaction Network layer:
//   out[b, o, e] = sum_{h, f} W[o, h, f] * Xk[b, h, e] * X0[b, f, e]
// with Xk [B, Hk, d], X0 [B, F, d], W [Ho, Hk, F] and out [B, Ho, d], all
// float32.
//
// Replaces the TPU kernel repro/kernels/cin/kernel.py (_cin_kernel, launched
// by cin_pallas).  The TPU kernel built Z[b, (h, f), e] = Xk * X0 in VMEM for
// a block of samples and ran one [Ho, Hk*F] x [Hk*F, d] product per sample on
// the MXU; Z never reached device memory.  Here the same function is one
// product [Ho x Q] . [Q x (B*d)], Q = Hk*F, whose right operand Z is made in
// shared memory a Q-chunk at a time and is never written to device memory.
//
// What bounds it on Hopper: operations.  At xDeepFM's Ho = 200, F = 39,
// d = 10 a layer does 2 * d * Ho * Q flops per sample (Q = 1,521 for the
// first layer, 7,800 for the others: 68.5 MFLOP per sample over the three)
// against a few KB of Xk and X0 per sample and W (at most 6.24 MB) once, far
// above the float32 ridge.  The arithmetic is float32 FMAs on the CUDA cores:
// the tensor cores would round the operands to TF32 and lose parity with the
// reference.  The design is a register-blocked SGEMM:
//   - a block of 256 threads computes a tile of 112 output channels o by 64
//     columns n = b * d + e of the flattened (sample, column) axis, so any B
//     and any d (10 is no power of two) tile the same way; the ragged last
//     tile and the channels past Ho are masked.  Two blocks share an SM (at
//     most 128 registers a thread), and a served batch of 512 still makes
//     160 blocks;
//   - each thread owns 7 x 4 outputs (rows ty + 16 i, columns tx + 16 j:
//     broadcast reads of the W chunk, conflict-free reads of the Z chunk);
//   - per Q-chunk of 16 the block stages W[o0:o0+112, q0:q0+16] (transposed,
//     rows padded by one float against bank conflicts) and Z[q0:q0+16, n0:
//     n0+64] = Xk[b, h, e] * X0[b, f, e], the product rounded to float32 as
//     the reference's Z is; the next chunk's loads are issued into registers
//     before this chunk's FMAs, so they overlap;
//   - W is streamed from device memory (L2) once per column tile and reused
//     across the tile's 64 columns; Xk and X0 are read through L1, each row
//     reused over the F consecutive q that share its h.
// Each output is a sequential float32 sum over q = h * F + f in increasing
// order, so it differs from the reference's einsum only by rounding.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TX = 16, TY = 16;    // thread grid: columns x channels
constexpr int TM = 7, TN = 4;      // outputs per thread: channels x columns
constexpr int BM = TY * TM;        // 112 channels per block
constexpr int BN = TX * TN;        // 64 columns per block
constexpr int BK = 16;             // Q-chunk depth
constexpr int THREADS = TX * TY;   // 256
constexpr int WS_STRIDE = BM + 1;  // padded W-chunk row
constexpr int W_ROWS = THREADS / BK;           // W loader: rows per pass
constexpr int W_LOADS = BM / W_ROWS;           // 7 W values per thread
constexpr int Z_ROW_STEP = THREADS / BN;       // Z loader: rows per pass
constexpr int Z_LOADS = BK / Z_ROW_STEP;       // 4 Z values per thread
static_assert(BM % W_ROWS == 0 && THREADS % BK == 0, "W loader tiling");
static_assert(THREADS % BN == 0 && BK % Z_ROW_STEP == 0, "Z loader tiling");

__global__ void __launch_bounds__(THREADS, 2)
    cin_kernel(const float* __restrict__ xk, const float* __restrict__ x0,
               const float* __restrict__ w, int B, int Hk, int F, int d,
               int Ho, float* __restrict__ out) {
  __shared__ float ws[BK * WS_STRIDE];  // W chunk, [k][o]
  __shared__ float zs[BK * BN];         // Z chunk, [k][n]
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int64_t N = static_cast<int64_t>(B) * d;
  const int Q = Hk * F;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * BN;
  const int o0 = blockIdx.y * BM;

  // Z loader: column zc of the tile, rows zr + i * Z_ROW_STEP of the chunk.
  // (zh, zf) is the (h, f) of that row's q, advanced one chunk per load.
  const int zc = tid % BN, zr = tid / BN;
  const int64_t zn = n0 + zc;
  const bool zn_ok = zn < N;
  int64_t xk_base = 0, x0_base = 0;
  if (zn_ok) {
    const int64_t b = zn / d;
    const int64_t e = zn - b * d;
    xk_base = b * Hk * d + e;
    x0_base = b * F * d + e;
  }
  int zh[Z_LOADS], zf[Z_LOADS];
#pragma unroll
  for (int i = 0; i < Z_LOADS; ++i) {
    const int q = zr + i * Z_ROW_STEP;
    zh[i] = q / F;
    zf[i] = q - zh[i] * F;
  }
  // W loader: column wk of the chunk, channels wr + i * W_ROWS of the tile
  const int wk = tid % BK, wr = tid / BK;

  float wreg[W_LOADS], areg[Z_LOADS], breg[Z_LOADS];
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  // issue the loads of chunk q0 into registers (zeros past the edges)
  auto load = [&](int q0) {
    const int q = q0 + wk;
#pragma unroll
    for (int i = 0; i < W_LOADS; ++i) {
      const int o = o0 + wr + i * W_ROWS;
      wreg[i] = (o < Ho && q < Q)
                    ? __ldg(w + static_cast<int64_t>(o) * Q + q) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < Z_LOADS; ++i) {
      const bool ok = zn_ok && zh[i] < Hk;   // zh < Hk  <=>  q < Q
      areg[i] = ok ? __ldg(xk + xk_base + static_cast<int64_t>(zh[i]) * d)
                   : 0.0f;
      breg[i] = ok ? __ldg(x0 + x0_base + static_cast<int64_t>(zf[i]) * d)
                   : 0.0f;
      zf[i] += BK;
      while (zf[i] >= F) {
        zf[i] -= F;
        ++zh[i];
      }
    }
  };

  load(0);
  for (int q0 = 0; q0 < Q; q0 += BK) {
#pragma unroll
    for (int i = 0; i < W_LOADS; ++i)
      ws[wk * WS_STRIDE + wr + i * W_ROWS] = wreg[i];
#pragma unroll
    for (int i = 0; i < Z_LOADS; ++i)  // Z rounded to float32, as the ref's
      zs[(zr + i * Z_ROW_STEP) * BN + zc] = __fmul_rn(areg[i], breg[i]);
    __syncthreads();
    if (q0 + BK < Q) load(q0 + BK);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], z[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = ws[k * WS_STRIDE + ty + i * TY];
#pragma unroll
      for (int j = 0; j < TN; ++j) z[j] = zs[k * BN + tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], z[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int64_t n = n0 + tx + j * TX;
    if (n >= N) continue;
    const int64_t b = n / d;
    float* ob = out + b * Ho * d + (n - b * d);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int o = o0 + ty + i * TY;
      if (o < Ho) ob[static_cast<int64_t>(o) * d] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int cin_launch(const void* xk, const void* x0, const void* w,
                          int B, int Hk, int F, int d, int Ho, void* out,
                          cudaStream_t stream) {
  const int64_t N = static_cast<int64_t>(B) * d;
  if (N == 0 || Ho == 0) return 0;
  if (Hk == 0 || F == 0) {  // an empty sum
    cudaMemsetAsync(out, 0, N * Ho * sizeof(float), stream);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid(static_cast<unsigned>((N + BN - 1) / BN),
                  static_cast<unsigned>((Ho + BM - 1) / BM));
  cin_kernel<<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(xk), static_cast<const float*>(x0),
      static_cast<const float*>(w), B, Hk, F, d, Ho, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
