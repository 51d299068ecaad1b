// Full-table weighted embedding bag: out[b, :] = sum_l w[b, l] * T[ids[b, l], :].
//
// Replaces the TPU kernel repro/kernels/embedding_bag/kernel.py
// (_bag_kernel, launched by embedding_bag_pallas).  The TPU had no fast
// gather, so it built a one-hot matrix A[b, v] = sum_l w[b, l] [ids[b, l] ==
// v] a vocabulary tile at a time and multiplied it with the table tile on
// its matrix unit: O(B * V * d) operations for O(B * L * d) useful ones.
// Hopper gathers natively, so this is the gather itself.  An id outside
// [0, V) adds nothing, as a one-hot row with no 1 would.
//
// What bounds it: bytes -- the B * L gathered rows (4 d bytes each), the ids
// and weights (8 bytes a term) and the output (4 d bytes a bag); two flops a
// gathered element are far below the card's rate.  Rows of a large table
// are scattered, so each row is its own read, a device-memory round trip
// when the L2 is cold.  So the design keeps many rows in flight: a bag
// belongs to a group of LPB lanes (a power of two, at most 32: a d = 64 row
// is 16 float4s, so a half-warp takes a bag and a warp two), each lane UPL
// units of W floats (W = 4, 16-byte loads, when d % 4 == 0 and the table
// and output are 16-byte aligned; else W = 1); the group reads its bag's
// ids and weights once, coalesced, 2 LPB at a time (2 a lane), hands each
// to its lanes by a shuffle, and loads up to 16 rows before it adds any: a
// d = 64 bag of L = 32 takes one round trip for its ids and two for its
// rows, with 32 rows of 256 bytes in flight a warp.  (Four ids a lane put
// the ids in local memory; 32 rows ahead, about 210 registers, halve the
// blocks an SM holds.)  Each column keeps
// its fmaf chain in l order, so every output has the bits of adding one row
// at a time.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WARP = 32;
constexpr int THREADS = 128;    // 4 warps a block: more blocks than SMs
constexpr int IDS = 2;          // a bag's ids and weights a lane holds
constexpr int MAX_D = 256;
constexpr unsigned FULL = 0xFFFFFFFFu;

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

// lpb_log2: log2 of the lanes a bag; lane l of a group holds units
// q = l + k * LPB, k < UPL, of the d / W units of a row.  The group reads
// IDS * LPB ids and weights at a time (IDS a lane), then walks them AHEAD
// rows at a time.
template <int W, int UPL>
__global__ void bag_kernel(const float* __restrict__ table,
                           const int32_t* __restrict__ ids,
                           const float* __restrict__ w, int64_t V, int d,
                           int lpb_log2, int B, int L,
                           float* __restrict__ out) {
  // 64 floats of rows in flight a lane, at most 16 rows
  constexpr int AHEAD = 64 / (UPL * W) < 16 ? 64 / (UPL * W) : 16;
  const int lane = threadIdx.x % WARP;
  const int lpb = 1 << lpb_log2, nq = d / W;
  const int grp = lane >> lpb_log2, l = lane & (lpb - 1);
  const int first = grp << lpb_log2;            // the group's lane 0
  const int bpw_log2 = 5 - lpb_log2;            // bags a warp
  const int64_t warps = static_cast<int64_t>(gridDim.x) *
                        (blockDim.x / WARP);
  for (int64_t wb = static_cast<int64_t>(blockIdx.x) * (blockDim.x / WARP) +
                    threadIdx.x / WARP;
       (wb << bpw_log2) < B; wb += warps) {
    const int64_t b = (wb << bpw_log2) + grp;
    const bool has = b < B;
    float acc[UPL][W];
#pragma unroll
    for (int k = 0; k < UPL; ++k)
#pragma unroll
      for (int c = 0; c < W; ++c) acc[k][c] = 0.0f;
    for (int l0 = 0; l0 < L; l0 += IDS << lpb_log2) {   // the same in every
      int32_t my_id[IDS];                               // lane
      float my_w[IDS];
#pragma unroll
      for (int i = 0; i < IDS; ++i) {           // term l0 + i LPB + l
        const int t = l0 + (i << lpb_log2) + l;
        my_id[i] = -1;
        my_w[i] = 0.0f;
        if (has && t < L) {
          my_id[i] = ids[b * L + t];
          my_w[i] = w[b * L + t];
        }
      }
      const int cnt = L - l0 < (IDS << lpb_log2) ? L - l0 : IDS << lpb_log2;
      for (int j0 = 0; j0 < cnt; j0 += AHEAD) {
        float row[AHEAD][UPL][W];
        float wt[AHEAD];
        bool ok[AHEAD];
#pragma unroll
        for (int r = 0; r < AHEAD; ++r) {       // every load, then the adds
          const int j = j0 + r;                 // the same in every lane
          int32_t id = my_id[0];
          float wj = my_w[0];
#pragma unroll
          for (int i = 1; i < IDS; ++i)
            if ((j >> lpb_log2) == i) {
              id = my_id[i];
              wj = my_w[i];
            }
          const int src = first + (j & (lpb - 1));
          id = __shfl_sync(FULL, id, src);
          wt[r] = __shfl_sync(FULL, wj, src);
          ok[r] = j < cnt && id >= 0 && id < V;
#pragma unroll
          for (int k = 0; k < UPL; ++k)
#pragma unroll
            for (int c = 0; c < W; ++c) row[r][k][c] = 0.0f;
          if (!ok[r]) continue;
          const float* p = table + static_cast<int64_t>(id) * d;
#pragma unroll
          for (int k = 0; k < UPL; ++k) {
            const int q = l + (k << lpb_log2);
            if (q < nq) load<W>(p + q * W, row[r][k]);
          }
        }
#pragma unroll
        for (int r = 0; r < AHEAD; ++r) {
          if (!ok[r]) continue;
#pragma unroll
          for (int k = 0; k < UPL; ++k)
#pragma unroll
            for (int c = 0; c < W; ++c)
              acc[k][c] = fmaf(wt[r], row[r][k][c], acc[k][c]);
        }
      }
    }
    if (!has) continue;
#pragma unroll
    for (int k = 0; k < UPL; ++k) {
      const int q = l + (k << lpb_log2);
      if (q < nq) store<W>(out + b * d + q * W, acc[k]);
    }
  }
}

template <int W, int UPL>
int launch(const float* table, const int32_t* ids, const float* w, int64_t V,
           int d, int lpb_log2, int B, int L, float* out,
           cudaStream_t stream) {
  const int64_t warps = ((static_cast<int64_t>(B) - 1) >> (5 - lpb_log2)) + 1;
  const int64_t want = (warps + THREADS / WARP - 1) / (THREADS / WARP);
  const int blocks = static_cast<int>(want < (1 << 30) ? want : (1 << 30));
  bag_kernel<W, UPL><<<blocks, THREADS, 0, stream>>>(table, ids, w, V, d,
                                                      lpb_log2, B, L, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table [V, d] f32, ids [B, L] int32, w [B, L] f32, out [B, d] f32.
extern "C" int embedding_bag_launch(const void* table_, const void* ids_,
                                    const void* w_, int64_t V, int d, int B,
                                    int L, void* out_, cudaStream_t stream) {
  if (B == 0 || d == 0) return 0;
  if (d > MAX_D) return static_cast<int>(cudaErrorInvalidValue);
  const auto* table = static_cast<const float*>(table_);
  const auto* ids = static_cast<const int32_t*>(ids_);
  const auto* w = static_cast<const float*>(w_);
  auto* out = static_cast<float*>(out_);
  const bool vec = d % 4 == 0 && (reinterpret_cast<uintptr_t>(table) |
                                  reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  const int units = vec ? d / 4 : d;
  int lpb_log2 = 0, upl = 1;
  while ((1 << lpb_log2) < units && lpb_log2 < 5) ++lpb_log2;
  while ((upl << lpb_log2) < units) upl *= 2;
  if (vec)
    return upl == 1 ? launch<4, 1>(table, ids, w, V, d, lpb_log2, B, L, out,
                                   stream)
                    : launch<4, 2>(table, ids, w, V, d, lpb_log2, B, L, out,
                                   stream);
  switch (upl) {
    case 1:
      return launch<1, 1>(table, ids, w, V, d, lpb_log2, B, L, out, stream);
    case 2:
      return launch<1, 2>(table, ids, w, V, d, lpb_log2, B, L, out, stream);
    case 4:
      return launch<1, 4>(table, ids, w, V, d, lpb_log2, B, L, out, stream);
    default:
      return launch<1, 8>(table, ids, w, V, d, lpb_log2, B, L, out, stream);
  }
}
