// xDeepFM Compressed Interaction Network layer:
//   out[b, o, e] = sum_{h, f} W[o, h, f] * Xk[b, h, e] * X0[b, f, e]
// with Xk [B, Hk, d], X0 [B, F, d], W [Ho, Hk, F] and out [B, Ho, d], all
// float32.
//
// Replaces the TPU kernel repro/kernels/cin/kernel.py (_cin_kernel, launched
// by cin_pallas).  The TPU kernel built Z[b, (h, f), e] = Xk * X0 in VMEM for
// a block of samples and ran one [Ho, Hk*F] x [Hk*F, d] product per sample on
// the MXU; Z never reached device memory.  Here the same function is one
// product out^T [N x Ho] = Z^T [N x Q] . W^T [Q x Ho] over the columns
// n = b * d + e (N = B * d, Q = Hk * F), whose operand Z is made in shared
// memory a chunk at a time and is never written to device memory.
//
// What bounds it on Hopper: operations.  At xDeepFM's Ho = 200, F = 39,
// d = 10 a layer does 2 * d * Ho * Q flops per sample (68.5 MFLOP per
// sample over the three layers) against a few KB of Xk and X0 per sample
// and W (at most 6.24 MB), far above the ridge.  The products run on the
// tensor cores in TF32 with a 3xTF32 split, which keeps float32 accuracy:
// each operand x is split into big = tf32(x) (round to nearest, ties away,
// as cvt.rna.tf32.f32) and small = tf32(x - big), and the product is
// accumulated as small*big + big*small first, then big*big, in float32
// accumulators.  x - big is exact, the TF32 products are exact, and the
// dropped small*small term and small's rounding are below 2^-21 of |x y|,
// so every term keeps float32 accuracy and an output differs from the
// plain einsum by float32 rounding of the sum only (held to 1e-5 of its
// sum |terms|, as before; one TF32 pass alone would miss that by 5x).
// Three TF32 passes at 494.7 TFLOP/s run at 165 TFLOP/s of float32-exact
// work, against 67 TFLOP/s of float32 FMAs on the CUDA cores: that is the
// card's floor for this function.
//
// Design (warpgroup wgmma.m64n200k8 with TF32 operands in shared memory):
//   - a block of two warpgroups computes 128 columns (64 each) by all 200
//     channels of a channel tile: one wgmma's N is 200, so Ho = 200 needs
//     no padding, and the 100 accumulators a thread stay in registers;
//   - Q is walked in chunks of two h by eight f (f padded to a multiple of
//     8), so a chunk's Xk is two rows and its X0 eight rows of the block's
//     columns, and the X0 rows serve every h of an f-block;
//   - W is first cut, split and laid out once per launch by tile_w into a
//     scratch buffer in exactly the order a chunk's B tiles sit in shared
//     memory (big, then small; the canonical no-swizzle K-major layout of
//     8-row x 16-byte core matrices), so one bulk copy of 25.6 KB by the
//     copy engine (cp.async.bulk, completing an mbarrier) stages a chunk's
//     W; Xk and X0 rows arrive by 4-byte cp.async;
//   - five chunks are staged at once (the one being multiplied and four in
//     flight); while a chunk's six wgmma (3 passes x 2 k8 steps) run, the
//     threads form the next chunk's Z from its landed rows (rounded to
//     float32 as the reference's Z is), split it and store big and small
//     into the second of two A buffers; one barrier a chunk;
//   - a small batch's columns do not fill the card (512 samples: 40 column
//     tiles), so the chunks are cut into the number of splits (at most 4)
//     that needs the fewest rounds of one block a SM, each split writing a
//     partial to scratch that a second kernel sums in split order;
//   - channels past Ho, h past Hk, f past F and columns past N are zeros
//     in the tiles and masked at the store; any B, Hk, F, d and Ho work.
// The sum of an output runs over its split's chunks in order and within a
// chunk in the fixed order of the wgmma instructions, and the splits add in
// order: no atomics, so the same inputs give the same bits on every call.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BO = 200;            // channels per block: one wgmma's N
constexpr int BN = 128;            // columns per block: 2 warpgroups x 64
constexpr int BK = 16;             // a chunk: two h, eight f (2 k8 steps)
constexpr int FB = 8;              // f a chunk
constexpr int T = 256;             // threads: 2 warpgroups
constexpr int SMS = 132;
constexpr int MAX_SPLITS = 4;      // each split adds a [B, Ho, d] partial
// A tile [BN x BK] and B tile [BO x BK] in shared memory, K-major, as 8-row
// x 16-byte core matrices: slot(r, k) = ((r/8)*(BK/4) + k/4)*32 + (r%8)*4 +
// k%4, so the core matrix to the right (k + 4) is 128 bytes on and the one
// below (r + 8) 512 bytes on
constexpr int CM_K = 128;          // bytes between core matrices along K
constexpr int CM_R = BK / 4 * 128; // bytes between 8-row groups
constexpr int A_TILE = BN * BK;    // floats
constexpr int B_TILE = BO * BK;
constexpr int RING = 5;            // staged chunks: c, and c + 1..4 loading
constexpr int XS = BN + 8;         // a staged row of Xk or X0 (padded)
constexpr int OFF_A = 0;                              // [2][big, small]
constexpr int OFF_B = OFF_A + 2 * 2 * A_TILE;         // [RING][big, small]
constexpr int OFF_XK = OFF_B + RING * 2 * B_TILE;     // [RING][2][XS]
constexpr int OFF_X0 = OFF_XK + RING * 2 * XS;        // [RING][FB][XS]
constexpr int OFF_BAR = OFF_X0 + RING * FB * XS;      // RING mbarriers
constexpr size_t SMEM = sizeof(float) * OFF_BAR + 8 * RING;
constexpr uint32_t B_BYTES = 2 * B_TILE * sizeof(float);   // one chunk's W
constexpr int A_PER = A_TILE / T;  // Z elements a thread
static_assert(BK == 16 && BN == 128 && T == 256, "slot arithmetic below");
static_assert(OFF_BAR % 2 == 0, "mbarriers are 8-byte aligned");

// cvt.rna.tf32.f32 as two integer operations (ptxas emits the instruction
// as a guarded sequence with a branch)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = big + small, both TF32
__device__ __forceinline__ void split(float x, float& big, float& small) {
  big = __uint_as_float(tf32(x));
  small = __uint_as_float(tf32(__fsub_rn(x, big)));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint64_t desc(const float* p) {
  return static_cast<uint64_t>((smem_addr(p) >> 4) & 0x3FFF) |
         (static_cast<uint64_t>(CM_K >> 4) << 16) |
         (static_cast<uint64_t>(CM_R >> 4) << 32);   // no swizzle
}

__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// all but this thread's two newest groups of copies have landed
__device__ __forceinline__ void wait_but_two() {
  asm volatile("cp.async.wait_group 2;\n" ::: "memory");
}

__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// one thread: `bytes` from global src to shared dst by the copy engine,
// completing a phase of the mbarrier at bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void wait_phase(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\nwait:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra wait;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// d[100] += A (64 x 8) * B (8 x 200), both K-major in shared memory, TF32
// in, float32 accumulate (the layout of d: see the epilogue)
__device__ __forceinline__ void wgmma_n200(float* d, uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n200k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99}, "
      "%100, %101, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99])
      : "l"(da), "l"(db));
}

// W [Ho, Hk, F] -> its TF32 parts in the order the kernel reads them:
// wt [o-tile][chunk][big, small][slot of the B tile], one contiguous run
// of B_BYTES a chunk (channels past Ho, h past Hk and f past F are 0)
__global__ void tile_w(const float* __restrict__ w, int Ho, int Hk, int F,
                       int n_chunks, float* __restrict__ wt) {
  const int HP = (Hk + 1) / 2;
  const int64_t n = static_cast<int64_t>((Ho + BO - 1) / BO) * n_chunks *
                    2 * B_TILE;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int s = static_cast<int>(i % B_TILE);
    const int64_t tile = i / B_TILE;          // (o-tile, chunk, part)
    const int part = static_cast<int>(tile % 2);
    const int64_t oc = tile / 2;
    const int c = static_cast<int>(oc % n_chunks);
    const int oy = static_cast<int>(oc / n_chunks);
    // slot -> (channel row, k): s = ((r/8)*4 + k/4)*32 + (r%8)*4 + k%4
    const int cm = s / 32, in = s % 32;
    const int o = oy * BO + (cm / 4) * 8 + in / 4;
    const int k = (cm % 4) * 4 + in % 4;
    const int h = 2 * (c % HP) + k / FB, f = FB * (c / HP) + k % FB;
    float big = 0.0f, small = 0.0f;
    if (o < Ho && h < Hk && f < F)
      split(w[(static_cast<int64_t>(o) * Hk + h) * F + f], big, small);
    wt[i] = part == 0 ? big : small;
  }
}

// Grid (column tiles, channel tiles, K splits); a block sums the chunks of
// its split into `out` (splits = 1) or its slice of the partials.  Chunk c
// is (f-block c / HP, h pair c % HP): its k runs over h = 2 hp + k / 8 and
// f = 8 fb + k % 8.
__global__ void __launch_bounds__(T, 1)
    cin_kernel(const float* __restrict__ xk, const float* __restrict__ x0,
               const float* __restrict__ wt, int B, int Hk, int F,
               int n_chunks, int d, int Ho, float* __restrict__ out) {
  extern __shared__ __align__(128) float smem[];
  uint64_t* const bars = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int64_t N = static_cast<int64_t>(B) * d;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * BN;
  const int o0 = blockIdx.y * BO;
  const int HP = (Hk + 1) / 2;
  const int per_split = (n_chunks + gridDim.z - 1) / gridDim.z;
  const int c_begin = blockIdx.z * per_split;
  const int c_end = min(c_begin + per_split, n_chunks);
  out += static_cast<int64_t>(blockIdx.z) * N * Ho;
  const float* wtile = wt + static_cast<int64_t>(blockIdx.y) * n_chunks *
                                2 * B_TILE;

  if (tid == 0) {
    for (int i = 0; i < RING; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_addr(bars + i))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // staging: this thread's column r (Xk and X0 rows) of the block
  const int sr = tid % BN;
  const int64_t sn = n0 + sr;
  int xk_base = -1, x0_base = -1;         // -1: a column past N
  if (sn < N) {
    const int64_t b = sn / d, e = sn - (sn / d) * d;
    xk_base = static_cast<int>(b * Hk * d + e);
    x0_base = static_cast<int>(b * F * d + e);
  }

  // chunk c's copies into ring slot c % RING: its W tile (one bulk copy by
  // thread 0), its two Xk rows and, at an f-block's first chunk, the
  // block's 8 X0 rows
  auto stage = [&](int c) {
    const int fb = c / HP, hp = c - (c / HP) * HP;
    const int ring = (c - c_begin) % RING;
    if (tid == 0)
      bulk_copy(smem + OFF_B + ring * 2 * B_TILE,
                wtile + static_cast<int64_t>(c) * 2 * B_TILE, B_BYTES,
                bars + ring);
    {
      const int hh = tid / BN, h = 2 * hp + hh;
      const bool ok = xk_base >= 0 && h < Hk;
      copy4(smem + OFF_XK + (ring * 2 + hh) * XS + sr,
            ok ? xk + xk_base + h * d : xk, ok);
    }
    if (hp == 0 || c == c_begin) {
#pragma unroll
      for (int v = 0; v < FB * BN / T; ++v) {
        const int f8 = tid / BN + v * (T / BN), f = FB * fb + f8;
        const bool ok = x0_base >= 0 && f < F;
        copy4(smem + OFF_X0 + ((fb % RING) * FB + f8) * XS + sr,
              ok ? x0 + x0_base + f * d : x0, ok);
      }
    }
  };
  auto stage_or_empty = [&](int c) {
    if (c < c_end) stage(c);
    commit();
  };

  // Z of chunk c, split, into A buffer c & 1: this thread's elements are
  // slots tid + T j, all with one k (zk) and the columns 8 (warp / 4) +
  // 16 j + lane / 4
  const int zk = 4 * (warp % 4) + lane % 4;
  auto transform = [&](int c) {
    const int fb = c / HP;
    const int ring = (c - c_begin) % RING;
    float* a = smem + OFF_A + (c & 1) * 2 * A_TILE;
    const float* xkr = smem + OFF_XK + (ring * 2 + zk / FB) * XS;
    const float* x0r = smem + OFF_X0 + ((fb % RING) * FB + zk % FB) * XS;
#pragma unroll
    for (int j = 0; j < A_PER; ++j) {
      const int r = 8 * (warp / 4) + 16 * j + lane / 4;
      const float z = __fmul_rn(xkr[r], x0r[r]);
      split(z, a[tid + T * j], a[A_TILE + tid + T * j]);
    }
  };

  float acc[100];
#pragma unroll
  for (int i = 0; i < 100; ++i) acc[i] = 0.0f;

  // groups of copies, one a chunk (empty past the end): while chunk c is
  // multiplied, chunk c + 1 is formed from landed rows and chunks c + 2
  // to c + 4 are in flight
  stage_or_empty(c_begin);
  stage_or_empty(c_begin + 1);
  stage_or_empty(c_begin + 2);
  stage_or_empty(c_begin + 3);
  wait_but_two();                         // c0 and c0 + 1
  __syncthreads();
  if (c_begin < c_end) transform(c_begin);
  fence_async();
  __syncthreads();
  const int wg = warp / 4;                // this warpgroup's 64 columns
  for (int c = c_begin; c < c_end; ++c) {
    const int u = c - c_begin;
    const float* abig = smem + OFF_A + (c & 1) * 2 * A_TILE + wg * 64 * BK;
    const float* asmall = abig + A_TILE;
    const float* bbig = smem + OFF_B + (u % RING) * 2 * B_TILE;
    const float* bsmall = bbig + B_TILE;
    wait_phase(bars + u % RING, (u / RING) & 1);   // chunk c's W tile
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int s = 0; s < BK / 8; ++s) {      // k8 step s: 2 core matrices on
      const int off = s * 2 * 32;
      wgmma_n200(acc, desc(asmall + off), desc(bbig + off));
      wgmma_n200(acc, desc(abig + off), desc(bsmall + off));
      wgmma_n200(acc, desc(abig + off), desc(bbig + off));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (c + 1 < c_end) transform(c + 1);    // under chunk c's products
    stage_or_empty(c + 4);                  // into chunk c - 1's ring slot
    wait_but_two();                         // chunk c + 2's own rows
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_async();
    __syncthreads();                        // c + 1's A, c + 2's rows
  }

  // acc[4 i + v]: column n = 64 wg + 16 (warp % 4) + lane / 4 (+ 8 for
  // v >= 2), channel o = 8 i + 2 (lane % 4) (+ 1 for odd v)
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int64_t n = n0 + 64 * wg + 16 * (warp % 4) + lane / 4 + 8 * half;
    if (n >= N) continue;
    const int64_t b = n / d;
    float* ob = out + b * Ho * d + (n - b * d);
#pragma unroll
    for (int i = 0; i < BO / 8; ++i) {
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int o = o0 + 8 * i + 2 * (lane % 4) + v;
        if (o < Ho) ob[static_cast<int64_t>(o) * d] = acc[4 * i + 2 * half + v];
      }
    }
  }
}

// out = the splits' partials summed in split order
__global__ void sum_splits(const float* __restrict__ part, int splits,
                           int64_t n, float* __restrict__ out) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float s = part[i];
    for (int k = 1; k < splits; ++k) s = __fadd_rn(s, part[k * n + i]);
    out[i] = s;
  }
}

int chunks_of(int Hk, int F) { return (F + FB - 1) / FB * ((Hk + 1) / 2); }

// the number of splits (at most 4) of the chunks that takes the fewest
// rounds of one resident block a SM for the work
int plan_splits(int64_t N, int Hk, int F, int Ho) {
  const int64_t blocks = (N + BN - 1) / BN * ((Ho + BO - 1) / BO);
  const int64_t chunks = chunks_of(Hk, F);
  int best = 1;
  double best_rounds = static_cast<double>((blocks + SMS - 1) / SMS);
  for (int s = 2; s <= MAX_SPLITS && s <= chunks; ++s) {
    const double rounds =
        static_cast<double>((blocks * s + SMS - 1) / SMS) / s;
    if (rounds < best_rounds) {
      best = s;
      best_rounds = rounds;
    }
  }
  return best;
}

int64_t w_tile_floats(int Hk, int F, int Ho) {
  return static_cast<int64_t>((Ho + BO - 1) / BO) * chunks_of(Hk, F) * 2 *
         B_TILE;
}

}  // namespace

// Floats of scratch cin_launch needs for these shapes: W's TF32 tiles,
// then the splits' partials.
extern "C" int64_t cin_scratch_floats(int B, int Hk, int F, int d, int Ho) {
  const int64_t N = static_cast<int64_t>(B) * d;
  if (N == 0 || Ho == 0 || Hk == 0 || F == 0) return 0;
  const int s = plan_splits(N, Hk, F, Ho);
  return w_tile_floats(Hk, F, Ho) + (s > 1 ? s * N * Ho : 0);
}

extern "C" int cin_launch(const void* xk, const void* x0, const void* w,
                          int B, int Hk, int F, int d, int Ho, void* out,
                          void* scratch, cudaStream_t stream) {
  const int64_t N = static_cast<int64_t>(B) * d;
  if (N == 0 || Ho == 0) return 0;
  if (Hk == 0 || F == 0) {  // an empty sum
    cudaMemsetAsync(out, 0, N * Ho * sizeof(float), stream);
    return static_cast<int>(cudaGetLastError());
  }
  if (scratch == nullptr || reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      cin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int n_chunks = chunks_of(Hk, F);
  const int splits = plan_splits(N, Hk, F, Ho);
  auto* wt = static_cast<float*>(scratch);
  const int64_t w_floats = w_tile_floats(Hk, F, Ho);
  tile_w<<<static_cast<unsigned>(w_floats < 256 * 4 * SMS
                                     ? (w_floats + 255) / 256 : 4 * SMS),
           256, 0, stream>>>(static_cast<const float*>(w), Ho, Hk, F,
                             n_chunks, wt);
  auto* o = static_cast<float*>(out);
  float* dst = splits > 1 ? wt + w_floats : o;
  const dim3 grid(static_cast<unsigned>((N + BN - 1) / BN),
                  static_cast<unsigned>((Ho + BO - 1) / BO),
                  static_cast<unsigned>(splits));
  cin_kernel<<<grid, T, SMEM, stream>>>(static_cast<const float*>(xk),
                                        static_cast<const float*>(x0), wt,
                                        B, Hk, F, n_chunks, d, Ho, dst);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int64_t n = N * Ho;
  const int64_t blocks = (n + 255) / 256;
  sum_splits<<<static_cast<unsigned>(blocks < 4 * SMS ? blocks : 4 * SMS),
               256, 0, stream>>>(dst, splits, n, o);
  return static_cast<int>(cudaGetLastError());
}
