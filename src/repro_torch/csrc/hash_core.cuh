// The LMA hash core shared by lma_locations.cu and fused_embed.cu.
//
// Native uint32 arithmetic on Z_{2^32}, bit-identical to the reference's
// repro/core/hashing.py (fmix32, seed_stream, hash_u32, hash_pair,
// combine_chain) and to repro/core/allocation.py's location math.
//
// Work split: one warp per value (fused_embed.cu, for few rows: one per
// value and column tile).  The warp stages the value's D' set in shared
// memory, compacted to its non-PAD elements (a ballot + popc, so the
// masked min needs no select and PAD slots cost nothing), and each lane then
// owns whole location columns c = lane, lane + 32, ...: the n_h minhashes of
// the column, the power-n_h chain and the final fmix32 stay lane-local, and
// the lanes of a warp write adjacent columns (coalesced).  Seeds are derived
// in-lane from the base seed (seed_at) instead of being loaded: one fmix32
// per seed per column, against S hash evaluations per seed.
#pragma once
#include <cstdint>

namespace lma {

constexpr uint32_t C1 = 0x85EBCA6Bu, C2 = 0xC2B2AE35u, GOLDEN = 0x9E3779B9u;
constexpr uint32_t M1 = 0xCC9E2D51u, M2 = 0x1B873593u, PAD = 0xFFFFFFFFu;
constexpr uint32_t REHASH_XOR = 0x7F4A7C15u, FALLBACK_XOR = 0x1234567u;
constexpr int WARP = 32;

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= C1;
  x ^= x >> 13;
  x *= C2;
  x ^= x >> 16;
  return x;
}

// seed_stream(base, n)[j]
__device__ __forceinline__ uint32_t seed_at(uint32_t base, uint32_t j) {
  return fmix32(base + GOLDEN * (j + 1u));
}

__device__ __forceinline__ uint32_t hash_u32(uint32_t x, uint32_t seed) {
  uint32_t h = (x ^ seed) * M1;
  h = (h ^ (h >> 15)) * M2;
  return fmix32(h ^ seed);
}

__device__ __forceinline__ uint32_t hash_pair(uint32_t x, uint32_t y,
                                              uint32_t seed) {
  return hash_u32(y ^ hash_u32(x, seed), seed ^ GOLDEN);
}

// hash -> slot: column c's own stripe when stripe > 0, else [0, m)
__device__ __forceinline__ int32_t to_slot(uint32_t h, int c, uint32_t m,
                                           uint32_t stripe) {
  return stripe ? static_cast<int32_t>(c * stripe + h % stripe)
                : static_cast<int32_t>(h % m);
}

// Copy the non-PAD elements of row[0:S] to set[0:n], return n.  Called by
// all 32 lanes of a warp.
__device__ __forceinline__ int stage_set(const uint32_t* row, int S,
                                         uint32_t* set, int lane) {
  int n = 0;
  for (int k0 = 0; k0 < S; k0 += WARP) {
    int k = k0 + lane;
    uint32_t x = k < S ? row[k] : PAD;
    bool valid = x != PAD;
    unsigned ballot = __ballot_sync(0xFFFFFFFFu, valid);
    if (valid) set[n + __popc(ballot & ((1u << lane) - 1u))] = x;
    n += __popc(ballot);
  }
  __syncwarp();
  return n;
}

// min over the staged set of hash_u32(x, seed); PAD for an empty set
__device__ __forceinline__ uint32_t minhash(const uint32_t* set, int n,
                                            uint32_t seed) {
  uint32_t mn = PAD;
#pragma unroll 4
  for (int k = 0; k < n; ++k) mn = min(mn, hash_u32(set[k], seed));
  return mn;
}

struct LmaArgs {
  int d;            // location columns
  int n_h;          // power of each LSH mapping
  int independent;  // 1: column c reads sigs[c*n_h + t]; 0: sigs[c + t]
  uint32_t seed;    // base seed (LMAParams.seed & 0xFFFFFFFF)
  uint32_t m;       // pool slots
  uint32_t stripe;  // m / d when striped, else 0
};

// LMA location of column c from the staged set (no fallback):
// locations_from_signatures(rows_signatures(...))[:, c]
__device__ __forceinline__ int32_t lma_column(const uint32_t* set, int n,
                                              int c, const LmaArgs& a) {
  uint32_t h = seed_at(a.seed ^ REHASH_XOR, c);
  for (int t = 0; t < a.n_h; ++t) {
    uint32_t j = a.independent ? c * a.n_h + t : c + t;
    uint32_t s = minhash(set, n, seed_at(a.seed, j));
    h = (h ^ fmix32(s)) * M1 + GOLDEN;
  }
  return to_slot(fmix32(h), c, a.m, a.stripe);
}

// alloc_hashed_elem(v, d, m, seed, stripe)[c]
__device__ __forceinline__ int32_t hashed_elem_column(uint32_t v, int c,
                                                      uint32_t seed,
                                                      uint32_t m,
                                                      uint32_t stripe) {
  return to_slot(hash_pair(v, static_cast<uint32_t>(c), seed_at(seed, c)), c,
                 m, stripe);
}

// alloc_hashed_row(v, d, m, seed)[c]
__device__ __forceinline__ int32_t hashed_row_column(uint32_t v, int c, int d,
                                                     uint32_t seed,
                                                     uint32_t m) {
  uint32_t n_rows = max(m / static_cast<uint32_t>(d), 1u);
  return static_cast<int32_t>((hash_u32(v, seed_at(seed, 0)) % n_rows) * d +
                              c);
}

}  // namespace lma
