// Counter-based pairwise-mask PRF on uint32_t — the device side of
// repro_torch/kernels/prf.py (and of the JAX package's kernels/prf.py).
//
//   pair key   (pk0, pk1) = threefry(session_key, (lo, hi))
//   element e  word       = threefry(pair_key, (e >> 1, tag))[e & 1]
//
// Threefry-2x32 at 13 rounds with the exact rotation and key-injection
// schedule of the reference: injections after every 4th round only.  All
// arithmetic is on uint32_t, where wraparound is defined.  One evaluation
// yields two stream words, those of elements 2c and 2c + 1: the kernels
// walk element pairs (stream_pair_at) and use both.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace repro_prf {

constexpr uint32_t kParity = 0x1BD11BDAu;
constexpr uint32_t kTagMask = 0u;
constexpr uint32_t kTagUniform = 1u;
constexpr uint32_t kTagSign = 2u;
constexpr int kRounds = 13;

__host__ __device__ constexpr int rotation(int i) {
  return (i % 8 == 0) ? 13 : (i % 8 == 1) ? 15 : (i % 8 == 2) ? 26
       : (i % 8 == 3) ? 6 : (i % 8 == 4) ? 17 : (i % 8 == 5) ? 29
       : (i % 8 == 6) ? 16 : 24;
}

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// In place: (x0, x1) <- Threefry-2x32-ROUNDS_{(k0, k1)}(x0, x1).
template <int ROUNDS = kRounds>
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  x0 += k0;
  x1 += k1;
#pragma unroll
  for (int i = 0; i < ROUNDS; ++i) {
    x0 += x1;
    x1 = rotl32(x1, rotation(i)) ^ x0;
    if ((i + 1) % 4 == 0) {
      const int j = (i + 1) / 4;
      const uint32_t ka = (j % 3 == 0) ? k0 : (j % 3 == 1) ? k1 : k2;
      const uint32_t kb = ((j + 1) % 3 == 0) ? k0 : ((j + 1) % 3 == 1) ? k1 : k2;
      x0 += ka;
      x1 += kb + static_cast<uint32_t>(j);
    }
  }
}

// Stream word at element position e of the stream keyed (pk0, pk1).
__device__ __forceinline__ uint32_t stream_at(uint32_t pk0, uint32_t pk1,
                                              uint32_t e, uint32_t tag) {
  uint32_t x0 = e >> 1, x1 = tag;
  threefry2x32(pk0, pk1, x0, x1);
  return (e & 1u) ? x1 : x0;
}

// Both stream words of counter c: x for element 2c, y for element 2c + 1.
// One Threefry evaluation serves the two elements (stream_at evaluates it
// once per element).
__device__ __forceinline__ uint2 stream_pair_at(uint32_t pk0, uint32_t pk1,
                                                uint32_t c, uint32_t tag) {
  uint32_t x0 = c, x1 = tag;
  threefry2x32(pk0, pk1, x0, x1);
  return make_uint2(x0, x1);
}

// Top 24 bits scaled by 2^-24: an exact f32 uniform in [0, 1).
__device__ __forceinline__ float bits_to_uniform(uint32_t w) {
  return __fmul_rn(__uint2float_rn(w >> 8), 5.9604644775390625e-08f);
}

// Neighbours per slot in the in-kernel enumeration: every slot of a complete
// graph (the diagonal is gated by sign 0), the degree of a ring, or the
// width of a neighbour table.
__host__ __device__ inline int neighbor_count(int num_slots, int degree,
                                              int table_width, bool table) {
  if (table) return table_width;
  if (degree <= 0 || degree >= num_slots - 1) return num_slots;
  return degree;
}

// Neighbour j of `slot`: complete graph j, ring offsets +1..+k/2 then
// -1..-k/2, or table row `slot`.
__device__ __forceinline__ int neighbor_at(int slot, int j, int num_slots,
                                           int degree, const int32_t* table,
                                           int table_width) {
  if (table != nullptr) return table[(int64_t)slot * table_width + j];
  if (degree <= 0 || degree >= num_slots - 1) return j;
  const int half = degree / 2;
  const int off = (j < half) ? (j + 1) : -(j - half + 1);
  return (slot + off + num_slots) % num_slots;
}

// Stage the LIVE mask neighbours of `slot` in shared memory: for each
// neighbour d != slot, its pair key (pk0, pk1) and the sign of its stream
// in the slot's mask as a multiplier, sgn = +1 when slot < d and
// 0xFFFFFFFF (-1 mod 2^32) when slot > d.  The diagonal of a complete graph
// (sign 0) is dropped, so the element loop has no branch.  Entries go to
// the positions an atomicAdd on *live hands out (the caller zeroes it);
// their order does not matter, the mask being a sum mod 2^32.  Threads
// `first`, `first + step`, ... of the block take neighbours j = 0, 1, ...;
// the caller synchronises before reading.
__device__ __forceinline__ void stage_live_keys(
    uint32_t k0, uint32_t k1, int slot, int count, int num_slots, int degree,
    const int32_t* table, int table_width, uint32_t* pk0, uint32_t* pk1,
    uint32_t* sgn, int* live, int first, int step) {
  for (int j = first; j < count; j += step) {
    const int d = neighbor_at(slot, j, num_slots, degree, table, table_width);
    if (d == slot) continue;
    uint32_t x0 = static_cast<uint32_t>(min(slot, d));
    uint32_t x1 = static_cast<uint32_t>(max(slot, d));
    threefry2x32(k0, k1, x0, x1);
    const int p = atomicAdd(live, 1);
    pk0[p] = x0;
    pk1[p] = x1;
    sgn[p] = (slot < d) ? 1u : 0xFFFFFFFFu;
  }
}

// The masks of the four elements 4g .. 4g + 3 (pair counters c = 2g and
// c + 1): m[k] += sgn * word, one Threefry per counter and neighbour, both
// of its words used.  NB > 0: NB staged neighbours whose keys the caller
// holds in registers; the loop is unrolled.
template <int NB>
__device__ __forceinline__ void mask_quad_regs(uint32_t c, const uint32_t* k0,
                                               const uint32_t* k1,
                                               const uint32_t* s,
                                               uint32_t* m) {
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const uint2 a = stream_pair_at(k0[j], k1[j], c, kTagMask);
    const uint2 b = stream_pair_at(k0[j], k1[j], c + 1u, kTagMask);
    m[0] += a.x * s[j];
    m[1] += a.y * s[j];
    m[2] += b.x * s[j];
    m[3] += b.y * s[j];
  }
}

// The same over `live` neighbours read from shared memory (any count).
__device__ __forceinline__ void mask_quad_smem(uint32_t c, int live,
                                               const uint32_t* k0,
                                               const uint32_t* k1,
                                               const uint32_t* s,
                                               uint32_t* m) {
  for (int j = 0; j < live; ++j) {
    const uint2 a = stream_pair_at(k0[j], k1[j], c, kTagMask);
    const uint2 b = stream_pair_at(k0[j], k1[j], c + 1u, kTagMask);
    m[0] += a.x * s[j];
    m[1] += a.y * s[j];
    m[2] += b.x * s[j];
    m[3] += b.y * s[j];
  }
}

// The kernels' launch size: as many blocks of `threads` as the card keeps
// resident at once (occupancy), or fewer when there is less work.
template <typename Kernel>
inline unsigned occupancy_grid(Kernel kernel, int threads, size_t smem,
                               int64_t blocks_needed) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                smem);
  int64_t blocks = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  if (blocks_needed < blocks) blocks = blocks_needed;
  return static_cast<unsigned>(blocks > 0 ? blocks : 1);
}

// Stochastic fixed-point rounding of xf with uniform u: floor(xf) + [u < frac]
// as the int32 bit pattern.  The operations are written as round-to-nearest
// intrinsics so no FMA contraction can change the bits.
__device__ __forceinline__ uint32_t stochastic_round(float xf, float u) {
  const float fl = floorf(xf);
  const float bit = (u < __fsub_rn(xf, fl)) ? 1.0f : 0.0f;
  return static_cast<uint32_t>(__float2int_rz(__fadd_rn(fl, bit)));
}

}  // namespace repro_prf
