// Fused masked push: out[e] = q(x[e] * scale) + mask[slot][e]  (mod 2^32).
//
// Replaces the Pallas kernel repro/kernels/secure_agg.py::quantize_mask_prf
// (body _quantize_mask_prf_kernel, mask tile _session_mask_tile).
//
// Bound on an H100: the PRF, not memory.  Each element moves 8 bytes (one
// f32 in, one int32 out) but needs one Threefry-2x32-13 for its
// stochastic-rounding uniform plus one per mask neighbour of the slot (7 for
// an 8-slot complete graph), about 50 integer operations each — some 400
// integer operations per 8 bytes, far above the card's operations-per-byte
// balance.  Design: one thread per element (grid-stride, 64-bit indexing) so
// the integer pipes of every SM stay busy; the slot's pair keys are computed
// once per block into shared memory (they do not depend on the element), so
// the element loop runs only the stream Threefrys.  Uniforms and masks are
// regenerated from counters and never touch device memory.  Bit-exact with
// the plain PyTorch version: (x * scale) rounds once (no FMA contraction; the
// build also passes --fmad=false), floor/+1 are exact, the float-to-int
// conversion truncates an integral value, and the mask sum wraps in uint32_t.
#include <cuda_runtime.h>

#include <cstdint>

#include "prf.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 32;

__global__ void quantize_mask_prf_kernel(
    const float* __restrict__ x, uint32_t* __restrict__ out, int64_t n,
    float scale, uint32_t k0, uint32_t k1, uint32_t u0, uint32_t u1, int slot,
    uint32_t u_off, int num_slots, int degree,
    const int32_t* __restrict__ table, int table_width, int count) {
  extern __shared__ uint32_t smem[];
  uint32_t* pk0 = smem;
  uint32_t* pk1 = smem + count;
  int32_t* sign = reinterpret_cast<int32_t*>(smem + 2 * count);
  repro_prf::stage_pair_keys(k0, k1, slot, count, num_slots, degree, table,
                             table_width, pk0, pk1, sign);
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const uint32_t e = static_cast<uint32_t>(i);
    const float u = repro_prf::bits_to_uniform(
        repro_prf::stream_at(u0, u1, u_off + e, repro_prf::kTagUniform));
    const uint32_t q = repro_prf::stochastic_round(__fmul_rn(x[i], scale), u);
    out[i] = q + repro_prf::mask_at(e, count, pk0, pk1, sign);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int quantize_mask_prf_launch(
    const float* x, uint32_t* out, int64_t n, float scale, uint32_t k0,
    uint32_t k1, uint32_t u0, uint32_t u1, int32_t slot, uint32_t u_off,
    int32_t num_slots, int32_t degree, const int32_t* table,
    int32_t table_width, void* stream) {
  if (n <= 0) return 0;
  const int count = repro_prf::neighbor_count(num_slots, degree, table_width,
                                              table != nullptr);
  const size_t smem = 3 * sizeof(uint32_t) * static_cast<size_t>(count);
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  quantize_mask_prf_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      x, out, n, scale, k0, k1, u0, u1, slot, u_off, num_slots, degree, table,
      table_width, count);
  return static_cast<int>(cudaGetLastError());
}
