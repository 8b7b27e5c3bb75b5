// Fused buffered-async flush:
//   out[d] = sum_c [ q(x[c,d] * w[c] * scale; u[c,d]) + m_c[d] ]  (mod 2^32)
//
// Replaces the Pallas kernel repro/kernels/secure_agg.py::
// weighted_quantize_accum, all three bodies: plain
// (_weighted_quantize_accum_kernel), explicit masks
// (_masked_weighted_quantize_accum_kernel) and in-kernel PRF session masks
// (_prf_masked_weighted_quantize_accum_kernel, with its slot_offset shard and
// the row < num_slots gate).
//
// Bound on an H100: the plain and explicit-mask bodies are memory-bound
// (8 or 12 bytes read per (client, element), nothing reused).  The PRF body
// adds one Threefry-2x32-13 (about 50 integer operations) per (client,
// element, mask neighbour) — 7 neighbours in an 8-slot complete graph, some
// 350 operations per 8 bytes — so it is bound by the integer pipes.
// Design: the TPU ran clients as a sequential grid axis accumulating into
// VMEM; here one block owns a tile of kThreads * kPerThread columns and
// loops over the clients itself, keeping the partial sums in registers, so
// no atomics and no second pass are needed and the sum order is fixed.
// Loads are coalesced (neighbouring threads, neighbouring columns).  For the
// PRF body each client row's pair keys are staged once per block in shared
// memory; the encoded per-client ints never leave registers.  Bit-exact with
// the plain PyTorch version: (x * w) * scale in the reference's order with
// round-to-nearest intrinsics (and --fmad=false), truncating conversion of
// an integral float, uint32_t wraparound sums.
#include <cuda_runtime.h>

#include <cstdint>

#include "prf.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kTile = kThreads * kPerThread;

enum Mode { kPlain = 0, kExplicitMasks = 1, kPrfMasks = 2 };

template <int MODE>
__global__ void weighted_quantize_accum_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ u, const int32_t* __restrict__ masks,
    uint32_t* __restrict__ out, int64_t C, int64_t D, float scale,
    uint32_t k0, uint32_t k1, int slot_offset, int num_slots, int degree,
    const int32_t* __restrict__ table, int table_width, int count) {
  extern __shared__ uint32_t smem[];
  uint32_t* pk0 = smem;
  uint32_t* pk1 = smem + count;
  int32_t* sign = reinterpret_cast<int32_t*>(smem + 2 * count);
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x;
  uint32_t acc[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) acc[k] = 0u;

  for (int64_t c = 0; c < C; ++c) {
    bool live = false;
    if (MODE == kPrfMasks) {
      const int64_t row = static_cast<int64_t>(slot_offset) + c;
      live = row < num_slots;
      __syncthreads();  // the previous row's keys are no longer read
      if (live) {
        repro_prf::stage_pair_keys(k0, k1, static_cast<int>(row), count,
                                   num_slots, degree, table, table_width, pk0,
                                   pk1, sign);
      }
      __syncthreads();
    }
    const float wc = w[c];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int64_t d = base + static_cast<int64_t>(k) * kThreads;
      if (d < D) {
        const int64_t idx = c * D + d;
        uint32_t q = repro_prf::stochastic_round(
            __fmul_rn(__fmul_rn(x[idx], wc), scale), u[idx]);
        if (MODE == kExplicitMasks) q += static_cast<uint32_t>(masks[idx]);
        if (MODE == kPrfMasks && live) {
          q += repro_prf::mask_at(static_cast<uint32_t>(d), count, pk0, pk1,
                                  sign);
        }
        acc[k] += q;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int64_t d = base + static_cast<int64_t>(k) * kThreads;
    if (d < D) out[d] = acc[k];
  }
}

}  // namespace

// mode: 0 plain, 1 explicit masks, 2 PRF session masks.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int weighted_quantize_accum_launch(
    const float* x, const float* w, const float* u, const int32_t* masks,
    uint32_t* out, int64_t C, int64_t D, float scale, int32_t mode,
    uint32_t k0, uint32_t k1, int32_t slot_offset, int32_t num_slots,
    int32_t degree, const int32_t* table, int32_t table_width, void* stream) {
  if (D <= 0) return 0;
  const int count =
      (mode == kPrfMasks)
          ? repro_prf::neighbor_count(num_slots, degree, table_width,
                                      table != nullptr)
          : 0;
  const size_t smem = 3 * sizeof(uint32_t) * static_cast<size_t>(count);
  const int64_t blocks = (D + kTile - 1) / kTile;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned g = static_cast<unsigned>(blocks);
  if (mode == kPlain) {
    weighted_quantize_accum_kernel<kPlain><<<g, kThreads, smem, s>>>(
        x, w, u, masks, out, C, D, scale, k0, k1, slot_offset, num_slots,
        degree, table, table_width, count);
  } else if (mode == kExplicitMasks) {
    weighted_quantize_accum_kernel<kExplicitMasks><<<g, kThreads, smem, s>>>(
        x, w, u, masks, out, C, D, scale, k0, k1, slot_offset, num_slots,
        degree, table, table_width, count);
  } else if (mode == kPrfMasks) {
    weighted_quantize_accum_kernel<kPrfMasks><<<g, kThreads, smem, s>>>(
        x, w, u, masks, out, C, D, scale, k0, k1, slot_offset, num_slots,
        degree, table, table_width, count);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
