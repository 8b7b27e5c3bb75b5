// Fused masked push: out[e] = q(x[e] * scale) + mask[slot][e]  (mod 2^32).
//
// Replaces the Pallas kernel repro/kernels/secure_agg.py::quantize_mask_prf
// (body _quantize_mask_prf_kernel, mask tile _session_mask_tile).
//
// Bound on an H100: the PRF's integer instructions, not memory.  Each
// element moves 8 bytes (one f32 in, one int32 out) but needs a uniform
// word and one mask word per live neighbour of the slot (7 in an 8-slot
// complete graph), and one Threefry-2x32-13 (about 40 integer instructions)
// yields two words.  Design:
//  - a thread owns element quads 4g .. 4g + 3, i.e. the two pairs of
//    counters c = 2g and 2g + 1, and evaluates every stream once per
//    counter, taking x0 for the even element and x1 for the odd one; the
//    two pairs' independent round chains interleave;
//  - the uniform stream is read at u_offset + e: with an even offset its
//    counters line up with the element pairs (two evaluations per quad),
//    with an odd one the quad's four words span three counters (ODD_U);
//  - the slot's live neighbours (the diagonal dropped) are staged once per
//    block in shared memory with their sign as a +-1 multiplier; for the
//    8-slot complete graph the main path runs (NB = 7) they are held in
//    registers and the neighbour loop is unrolled; other graphs loop over
//    shared memory;
//  - 16-byte loads and stores where x and out are aligned, scalar ones for
//    a ragged last quad;
//  - a grid of as many blocks as stay resident (occupancy), striding over
//    the quads.
// Bit-exact with the plain PyTorch version: (x * scale) rounds once (no FMA
// contraction; the build also passes --fmad=false), floor/+1 are exact, the
// float-to-int conversion truncates an integral value, and the mask sum
// wraps in uint32_t (in any order).
#include <cuda_runtime.h>

#include <cstdint>

#include "prf.cuh"

namespace {

constexpr int kThreads = 256;

template <int NB, bool ODD_U>
__global__ void __launch_bounds__(kThreads) quantize_mask_prf_kernel(
    const float* __restrict__ x, uint32_t* __restrict__ out, int64_t n,
    float scale, uint32_t k0, uint32_t k1, uint32_t u0, uint32_t u1, int slot,
    uint64_t u_off, int num_slots, int degree,
    const int32_t* __restrict__ table, int table_width, int count, int vec) {
  extern __shared__ uint32_t smem[];
  uint32_t* pk0 = smem;
  uint32_t* pk1 = smem + count;
  uint32_t* sgn = smem + 2 * count;
  int* live = reinterpret_cast<int*>(smem + 3 * count);
  if (threadIdx.x == 0) *live = 0;
  __syncthreads();
  repro_prf::stage_live_keys(k0, k1, slot, count, num_slots, degree, table,
                             table_width, pk0, pk1, sgn, live, threadIdx.x,
                             blockDim.x);
  __syncthreads();
  const int nlive = *live;
  uint32_t rk0[NB > 0 ? NB : 1], rk1[NB > 0 ? NB : 1], rs[NB > 0 ? NB : 1];
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    rk0[j] = pk0[j];
    rk1[j] = pk1[j];
    rs[j] = sgn[j];
  }
  const int64_t quads = (n + 3) / 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       g < quads; g += stride) {
    const int64_t i = 4 * g;
    const bool full = i + 3 < n;
    float xv[4];
    if (vec && full) {
      const float4 v = *reinterpret_cast<const float4*>(x + i);
      xv[0] = v.x;
      xv[1] = v.y;
      xv[2] = v.z;
      xv[3] = v.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) xv[k] = (i + k < n) ? x[i + k] : 0.0f;
    }
    const uint32_t e = static_cast<uint32_t>(i);
    // uniform words at stream positions u_off + e .. u_off + e + 3, taken in
    // 64 bits (the counter is their half mod 2^32), as the plain version
    // and the host streams take them
    const uint32_t uc = static_cast<uint32_t>((u_off + e) >> 1);
    uint32_t uw[4];
    const uint2 a = repro_prf::stream_pair_at(u0, u1, uc,
                                              repro_prf::kTagUniform);
    const uint2 b = repro_prf::stream_pair_at(u0, u1, uc + 1u,
                                              repro_prf::kTagUniform);
    if (ODD_U) {
      const uint2 c = repro_prf::stream_pair_at(u0, u1, uc + 2u,
                                                repro_prf::kTagUniform);
      uw[0] = a.y;
      uw[1] = b.x;
      uw[2] = b.y;
      uw[3] = c.x;
    } else {
      uw[0] = a.x;
      uw[1] = a.y;
      uw[2] = b.x;
      uw[3] = b.y;
    }
    uint32_t m[4] = {0u, 0u, 0u, 0u};
    if (NB > 0) {
      repro_prf::mask_quad_regs<NB>(e >> 1, rk0, rk1, rs, m);
    } else {
      repro_prf::mask_quad_smem(e >> 1, nlive, pk0, pk1, sgn, m);
    }
    uint32_t q[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      q[k] = repro_prf::stochastic_round(
                 __fmul_rn(xv[k], scale), repro_prf::bits_to_uniform(uw[k])) +
             m[k];
    }
    if (vec && full) {
      *reinterpret_cast<uint4*>(out + i) = make_uint4(q[0], q[1], q[2], q[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (i + k < n) out[i + k] = q[k];
    }
  }
}

template <int NB, bool ODD_U>
int launch(const float* x, uint32_t* out, int64_t n, float scale, uint32_t k0,
           uint32_t k1, uint32_t u0, uint32_t u1, int slot, uint64_t u_off,
           int num_slots, int degree, const int32_t* table, int table_width,
           int count, int vec, cudaStream_t stream) {
  const size_t smem = (3 * static_cast<size_t>(count) + 1) * sizeof(uint32_t);
  auto kernel = quantize_mask_prf_kernel<NB, ODD_U>;
  const int64_t quads = (n + 3) / 4;
  const unsigned grid = repro_prf::occupancy_grid(
      kernel, kThreads, smem, (quads + kThreads - 1) / kThreads);
  kernel<<<grid, kThreads, smem, stream>>>(
      x, out, n, scale, k0, k1, u0, u1, slot, u_off, num_slots, degree, table,
      table_width, count, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vec: x and out are 16-byte aligned.  Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int quantize_mask_prf_launch(
    const float* x, uint32_t* out, int64_t n, float scale, uint32_t k0,
    uint32_t k1, uint32_t u0, uint32_t u1, int32_t slot, uint64_t u_off,
    int32_t num_slots, int32_t degree, const int32_t* table,
    int32_t table_width, int32_t vec, void* stream) {
  if (n <= 0) return 0;
  const int count = repro_prf::neighbor_count(num_slots, degree, table_width,
                                              table != nullptr);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the main path: an 8-slot complete graph, 7 live neighbours
  const bool complete8 = table == nullptr && count == 8 && num_slots == 8;
  const bool odd = (u_off & 1u) != 0;
  if (complete8) {
    return odd ? launch<7, true>(x, out, n, scale, k0, k1, u0, u1, slot,
                                 u_off, num_slots, degree, table, table_width,
                                 count, vec, s)
               : launch<7, false>(x, out, n, scale, k0, k1, u0, u1, slot,
                                  u_off, num_slots, degree, table,
                                  table_width, count, vec, s);
  }
  return odd ? launch<0, true>(x, out, n, scale, k0, k1, u0, u1, slot, u_off,
                               num_slots, degree, table, table_width, count,
                               vec, s)
             : launch<0, false>(x, out, n, scale, k0, k1, u0, u1, slot, u_off,
                                num_slots, degree, table, table_width, count,
                                vec, s);
}
