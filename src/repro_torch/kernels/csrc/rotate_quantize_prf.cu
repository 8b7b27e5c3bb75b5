// Fused sketch encode: out[e] = q(H(signs ⊙ x)[e] * c), one 512-wide
// Walsh–Hadamard block per thread block, c = f32(f32(1/sqrt(512)) * scale).
//
// Replaces the Pallas kernel repro/kernels/secure_agg.py::rotate_quantize_prf
// (body _rotate_quantize_prf_kernel).
//
// Bound on an H100: the PRF, not memory.  Each element moves 8 bytes (one
// f32 in, one int32 out) and needs two Threefry-2x32-13 evaluations (its
// TAG_SIGN word and its TAG_UNIFORM word), about 100 integer operations,
// against 9 float adds of the butterflies.  Design: one thread per element,
// 512 threads per block = one Hadamard block, so the transform never leaves
// the SM.  Butterfly stages h = 1..16 pair lanes of one warp and run in
// registers with __shfl_xor_sync; stages h = 32..256 pair warps and go
// through one 2 KB shared-memory buffer.  At every stage the lower position
// of a pair gets a + b and the higher a - b, a being the LOWER element —
// the pairing order of the reference's reshape cascade, so the f32 results
// are bit-equal.  Signs and uniforms are regenerated from counters and never
// touch device memory.  Round-to-nearest intrinsics (and --fmad=false)
// keep every float operation single and uncontracted.
#include <cuda_runtime.h>

#include <cstdint>

#include "prf.cuh"

namespace {

constexpr int kBlock = 512;  // Hadamard block == threads per CTA

__global__ void __launch_bounds__(kBlock) rotate_quantize_prf_kernel(
    const float* __restrict__ x, uint32_t* __restrict__ out, int64_t n,
    float c, uint32_t o0, uint32_t o1, uint32_t u0, uint32_t u1,
    uint32_t u_off) {
  __shared__ float buf[kBlock];
  const int t = threadIdx.x;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + t;
  const uint32_t e = static_cast<uint32_t>(i);
  float v = (i < n) ? x[i] : 0.0f;  // zero past D: the Hadamard pad
  const uint32_t sbit =
      repro_prf::stream_at(o0, o1, e, repro_prf::kTagSign) & 1u;
  v = __fmul_rn(v, sbit ? -1.0f : 1.0f);
#pragma unroll
  for (int h = 1; h < 32; h <<= 1) {
    const float p = __shfl_xor_sync(0xffffffffu, v, h);
    v = (t & h) ? __fsub_rn(p, v) : __fadd_rn(v, p);
  }
#pragma unroll
  for (int h = 32; h < kBlock; h <<= 1) {
    buf[t] = v;
    __syncthreads();
    const float p = buf[t ^ h];
    __syncthreads();
    v = (t & h) ? __fsub_rn(p, v) : __fadd_rn(v, p);
  }
  const float u = repro_prf::bits_to_uniform(
      repro_prf::stream_at(u0, u1, u_off + e, repro_prf::kTagUniform));
  out[i] = repro_prf::stochastic_round(__fmul_rn(v, c), u);
}

}  // namespace

// x: (n,) f32; out: (full,) int32 with full = ceil(n / 512) * 512.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int rotate_quantize_prf_launch(const float* x, uint32_t* out,
                                          int64_t n, int64_t full, float c,
                                          uint32_t o0, uint32_t o1,
                                          uint32_t u0, uint32_t u1,
                                          uint32_t u_off, void* stream) {
  if (full <= 0) return 0;
  if (full % kBlock != 0 || full < n) return static_cast<int>(
      cudaErrorInvalidValue);
  const int64_t blocks = full / kBlock;
  rotate_quantize_prf_kernel<<<static_cast<unsigned>(blocks), kBlock, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      x, out, n, c, o0, o1, u0, u1, u_off);
  return static_cast<int>(cudaGetLastError());
}
