// Counter-based pairwise-mask PRF on uint32_t — the device side of
// repro_torch/kernels/prf.py (and of the JAX package's kernels/prf.py).
//
//   pair key   (pk0, pk1) = threefry(session_key, (lo, hi))
//   element e  word       = threefry(pair_key, (e >> 1, tag))[e & 1]
//
// Threefry-2x32 at 13 rounds with the exact rotation and key-injection
// schedule of the reference: injections after every 4th round only.  All
// arithmetic is on uint32_t, where wraparound is defined.
#pragma once

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

// Stage the pair keys and signs of `slot`'s neighbours in shared memory:
// pk0[j], pk1[j], sign[j] (+1 when slot < d, -1 when slot > d, 0 on the
// diagonal).  Call from every thread of the block, then __syncthreads().
__device__ __forceinline__ void stage_pair_keys(
    uint32_t k0, uint32_t k1, int slot, int count, int num_slots, int degree,
    const int32_t* table, int table_width, uint32_t* pk0, uint32_t* pk1,
    int32_t* sign) {
  for (int j = threadIdx.x; j < count; j += blockDim.x) {
    const int d = neighbor_at(slot, j, num_slots, degree, table, table_width);
    uint32_t x0 = static_cast<uint32_t>(min(slot, d));
    uint32_t x1 = static_cast<uint32_t>(max(slot, d));
    threefry2x32(k0, k1, x0, x1);
    pk0[j] = x0;
    pk1[j] = x1;
    sign[j] = (d == slot) ? 0 : ((slot < d) ? 1 : -1);
  }
}

// Signed sum of the staged pair streams at element position e (mod 2^32).
__device__ __forceinline__ uint32_t mask_at(uint32_t e, int count,
                                            const uint32_t* pk0,
                                            const uint32_t* pk1,
                                            const int32_t* sign) {
  uint32_t m = 0u;
  for (int j = 0; j < count; ++j) {
    const int32_t s = sign[j];
    if (s == 0) continue;
    const uint32_t w = stream_at(pk0[j], pk1[j], e, kTagMask);
    m += (s > 0) ? w : (0u - w);
  }
  return m;
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
