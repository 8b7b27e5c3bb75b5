// The secure-aggregation encode and decode of one flat vector:
//
//   K6 quantize_mask  out[d] = floor(xf) + [u[d] < xf - floor(xf)] + mask[d]
//                     with xf = clip(x[d], -vr, vr) * scale       (D,) int32
//   K7 dequantize     out[d] = f32(q[d]) * inv                     (D,) f32
//
// Replace the Pallas kernels repro/kernels/secure_agg.py::quantize_mask and
// ::dequantize.  The synchronous round encodes every client leaf through K6
// (value_range = +inf: the round's encode does not clip) and decodes the
// summed leaves through K7.
//
// Bound on an H100: bytes (a handful of operations per 12-16 bytes).  K6
// reads x, u (and mask) and writes out: 16 bytes an element with a mask,
// 12 without; K7 reads 4 and writes 4.  Design: one grid-stride pass, 16
// bytes a thread (float4 / int4) when the length is a multiple of 4 and
// every pointer 16-byte aligned, else 4.  Bit-exact with the plain PyTorch
// versions:
// - the clip is two compares, which keep NaN as jnp.clip does (fminf and
//   fmaxf would return the other operand);
// - the encode is repro_prf::stochastic_round (round-to-nearest
//   intrinsics, --fmad=false, and the saturating __float2int_rz, which maps
//   NaN to 0 and +-inf to INT_MAX / INT_MIN as XLA's conversion does);
// - the mask add wraps in uint32_t;
// - K7 never divides: the caller passes the f32 multiplier (the Pallas
//   kernel's f32(1/scale), or the jitted decode's f32(1)/f32(scale)).
#include <cuda_runtime.h>

#include <cstdint>

#include "prf.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t encode(float x, float u, float scale,
                                           float vr) {
  if (x < -vr) x = -vr;
  if (x > vr) x = vr;
  return repro_prf::stochastic_round(__fmul_rn(x, scale), u);
}

template <bool MASK, bool VEC>
__global__ void quantize_mask_kernel(const float* __restrict__ x,
                                     const int32_t* __restrict__ mask,
                                     const float* __restrict__ u,
                                     int32_t* __restrict__ out, int64_t D,
                                     float scale, float vr) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (VEC) {
    const int64_t n4 = D >> 2;
    for (int64_t i = first; i < n4; i += stride) {
      const float4 xv = reinterpret_cast<const float4*>(x)[i];
      const float4 uv = reinterpret_cast<const float4*>(u)[i];
      uint32_t q0 = encode(xv.x, uv.x, scale, vr);
      uint32_t q1 = encode(xv.y, uv.y, scale, vr);
      uint32_t q2 = encode(xv.z, uv.z, scale, vr);
      uint32_t q3 = encode(xv.w, uv.w, scale, vr);
      if (MASK) {
        const int4 m = reinterpret_cast<const int4*>(mask)[i];
        q0 += static_cast<uint32_t>(m.x);
        q1 += static_cast<uint32_t>(m.y);
        q2 += static_cast<uint32_t>(m.z);
        q3 += static_cast<uint32_t>(m.w);
      }
      reinterpret_cast<int4*>(out)[i] =
          make_int4(static_cast<int32_t>(q0), static_cast<int32_t>(q1),
                    static_cast<int32_t>(q2), static_cast<int32_t>(q3));
    }
  } else {
    for (int64_t d = first; d < D; d += stride) {
      uint32_t q = encode(x[d], u[d], scale, vr);
      if (MASK) q += static_cast<uint32_t>(mask[d]);
      out[d] = static_cast<int32_t>(q);
    }
  }
}

template <bool VEC>
__global__ void dequantize_kernel(const int32_t* __restrict__ q,
                                  float* __restrict__ out, int64_t D,
                                  float inv) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (VEC) {
    const int64_t n4 = D >> 2;
    for (int64_t i = first; i < n4; i += stride) {
      const int4 v = reinterpret_cast<const int4*>(q)[i];
      reinterpret_cast<float4*>(out)[i] = make_float4(
          __fmul_rn(__int2float_rn(v.x), inv), __fmul_rn(__int2float_rn(v.y), inv),
          __fmul_rn(__int2float_rn(v.z), inv), __fmul_rn(__int2float_rn(v.w), inv));
    }
  } else {
    for (int64_t d = first; d < D; d += stride)
      out[d] = __fmul_rn(__int2float_rn(q[d]), inv);
  }
}

unsigned grid_for(int64_t work) {
  const int64_t want = (work + kThreads - 1) / kThreads;
  const int64_t cap = 132 * 16;  // resident blocks of an H100, then stride
  return static_cast<unsigned>(want < 1 ? 1 : (want < cap ? want : cap));
}

}  // namespace

// mask may be null (no mask).  vec: D % 4 == 0 and every pointer 16-byte
// aligned.  Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int quantize_mask_launch(const float* x, const int32_t* mask,
                                    const float* u, int32_t* out, int64_t D,
                                    float scale, float value_range,
                                    int32_t vec, void* stream) {
  if (D <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned g = grid_for(vec ? (D >> 2) : D);
  if (mask != nullptr) {
    if (vec) {
      quantize_mask_kernel<true, true><<<g, kThreads, 0, st>>>(x, mask, u, out, D, scale, value_range);
    } else {
      quantize_mask_kernel<true, false><<<g, kThreads, 0, st>>>(x, mask, u, out, D, scale, value_range);
    }
  } else {
    if (vec) {
      quantize_mask_kernel<false, true><<<g, kThreads, 0, st>>>(x, mask, u, out, D, scale, value_range);
    } else {
      quantize_mask_kernel<false, false><<<g, kThreads, 0, st>>>(x, mask, u, out, D, scale, value_range);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dequantize_launch(const int32_t* q, float* out, int64_t D,
                                 float inv, int32_t vec, void* stream) {
  if (D <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec) {
    dequantize_kernel<true><<<grid_for(D >> 2), kThreads, 0, st>>>(q, out, D, inv);
  } else {
    dequantize_kernel<false><<<grid_for(D), kThreads, 0, st>>>(q, out, D, inv);
  }
  return static_cast<int>(cudaGetLastError());
}
