// The jax.random draws of repro_torch/kernels/prf.py in one pass a draw:
//
//   element i of an n-element draw under key (k0, k1)
//     w = y0 ^ y1,  (y0, y1) = Threefry-2x32-20_{(k0, k1)}(i >> 32, i & M32)
//   finished by mode:
//     kBits     w as int64 in [0, 2^32)            (random_bits, randint,
//                                                   permutation)
//     kUniform  (w >> 9) * 2^-23 as f32 in [0, 1)  (uniform)
//     kNormal   f32(sqrt 2) * erf_inv(max(lo, unit * span + lo)) as f32
//                                                  (normal)
//
// Replaces no Pallas kernel: on the TPU, XLA generated the draw from
// jax.random's threefry.  On the card the plain version (prf._draw's int64
// tile loop, ~150 torch launches a tile, and normal's op-by-op finish with
// its host round trips) left the device idle; this kernel is one launch a
// draw, with no host synchronisation.
//
// Bound on an H100: integer operations.  A Threefry-2x32-20 is ~60 of them
// (3 a round) against 4 bytes written: ~15 operations a byte, above the
// card's ~10 integer operations per byte of bandwidth (bits, 8 bytes an
// element, sit near the line; normal adds ~60 f32 operations).  Each
// thread takes four consecutive elements (four independent Threefry chains
// for the scheduler to interleave) and stores them as one 16-byte float4
// (two for int64); a grid-stride loop over such quads, the n % 4 tail
// element by element.
//
// Bits: equal to the CPU path for every key and length.  The counter is
// 64-bit.  normal's finish rebuilds XLA's f32 erf_inv, log1p and XLA CPU's
// log exactly as prf.erf_inv_f32, prf.log1p_f32 and prf.log_f32 compute
// them: every multiply-add of their fma_f32 is __fmaf_rn, every other
// product, sum, quotient and root an _rn intrinsic (and --fmad=false), so
// nothing contracts; both branches of log1p (|x| >= sqrt(2) - 1) and of
// erf_inv (w >= 5) are picked per element.  The constants are the module's
// f32-rounded ones.
#include <cuda_runtime.h>

#include <cstdint>

#include "prf.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kJaxRounds = 20;

enum Mode : int { kBits = 0, kUniform = 1, kNormal = 2 };

// prf's constants as the f32 values it computes with (hex, so no decimal
// literal is rounded twice): _NORMAL_LO, f32(_SQRT2_F32), _LOG1P_SMALL,
// _LOG_SQRTHF, _LOG_Q1, _LOG_Q2; the polynomials are at their call sites
constexpr float kNormalLo = -0x1.fffffep-1f;
constexpr float kSqrt2 = 0x1.6a09e6p+0f;
constexpr float kLog1pSmall = 0x1.a8279ap-2f;
constexpr float kLogSqrtHf = 0x1.6a09e6p-1f;
constexpr float kLogQ1 = -0x1.bd0106p-13f;
constexpr float kLogQ2 = 0x1.63p-1f;

// prf._horner: h = c0, then h = fma(h, x, c) for each further c
__device__ __forceinline__ float horner_steps(float, float h) { return h; }

template <typename... Cs>
__device__ __forceinline__ float horner_steps(float x, float h, float c,
                                              Cs... rest) {
  return horner_steps(x, __fmaf_rn(h, x, c), rest...);
}

template <typename... Cs>
__device__ __forceinline__ float horner(float x, float c0, Cs... rest) {
  return horner_steps(x, c0, rest...);
}

// prf.log_f32 for finite v > 0
__device__ __forceinline__ float log_f32(float v) {
  v = fmaxf(v, 0x1p-126f);
  const int bits = __float_as_int(v);
  float e = __fadd_rn(__int2float_rn((bits >> 23) - 127), 1.0f);
  const float m = __int_as_float((bits & 0x007FFFFF) | 0x3F000000);
  const bool small = m < kLogSqrtHf;
  const float x = __fadd_rn(__fsub_rn(m, 1.0f), small ? m : 0.0f);
  if (small) e = __fsub_rn(e, 1.0f);
  const float x2 = __fmul_rn(x, x);
  const float x3 = __fmul_rn(x2, x);
  // _LOG_P in three thirds
  float y = horner(x, 0x1.204376p-4f, -0x1.d7a370p-4f, 0x1.de4a34p-4f);
  const float y1 =
      horner(x, -0x1.fcba9ep-4f, 0x1.23d37ep-3f, -0x1.555ca0p-3f);
  const float y2 =
      horner(x, 0x1.999d58p-3f, -0x1.fffff8p-3f, 0x1.555554p-2f);
  y = __fmaf_rn(y, x3, y1);
  y = __fmaf_rn(y, x3, y2);
  y = __fmaf_rn(y, x3, __fmul_rn(e, kLogQ1));
  const float t = __fadd_rn(__fsub_rn(x, __fmul_rn(x2, 0.5f)), y);
  return __fadd_rn(t, __fmul_rn(e, kLogQ2));
}

// prf.log1p_f32 for x > -1: the log branch where |x| >= sqrt(2) - 1
__device__ __forceinline__ float log1p_f32(float x) {
  if (fabsf(x) >= kLog1pSmall) return log_f32(__fadd_rn(x, 1.0f));
  const float x2 = __fmul_rn(x, x);
  const float q =  // _LOG1P_Q
      horner(x, 0x1p+0f, 0x1.e2035ap+3f, 0x1.4c30b6p+6f, 0x1.bb865ap+7f,
             0x1.351946p+8f, 0x1.b0db14p+7f, 0x1.e0f304p+5f);
  const float p =  // _LOG1P_P
      horner(x, 0x1.7bc096p-15f, 0x1.fe818ap-2f, 0x1.a509f4p+2f,
             0x1.de9738p+4f, 0x1.e798ecp+5f, 0x1.c8e75ap+5f, 0x1.40a202p+4f);
  const float r = __fsub_rn(__fmul_rn(__fmul_rn(x, x2), __fdiv_rn(p, q)),
                            __fmul_rn(x2, 0.5f));
  return __fadd_rn(x, r);
}

// prf.erf_inv_f32 for |x| <= 1: the tail polynomial where w >= 5
__device__ __forceinline__ float erf_inv_f32(float x) {
  if (fabsf(x) == 1.0f) return __fmul_rn(x, __int_as_float(0x7F800000));
  const float w = -log1p_f32(__fmul_rn(x, -x));
  if (w >= 5.0f) {
    const float h = horner(  // _ERFINV_GE5
        __fsub_rn(__fsqrt_rn(w), 3.0f), -0x1.a3e136p-13f, 0x1.a76ad6p-14f,
        0x1.61b8e4p-10f, -0x1.e17bcep-9f, 0x1.7824f6p-8f, -0x1.f38baep-8f,
        0x1.354afcp-7f, 0x1.006db6p+0f, 0x1.6a9efcp+1f);
    return __fmul_rn(h, x);
  }
  const float h = horner(  // _ERFINV_LT5
      __fsub_rn(w, 2.5f), 0x1.e2cb10p-26f, 0x1.70966cp-22f, -0x1.d8e6aep-19f,
      -0x1.26b582p-18f, 0x1.ca65b6p-13f, -0x1.48a810p-10f, -0x1.11c9dep-8f,
      0x1.f91ec6p-3f, 0x1.805c5ep+0f);
  return __fmul_rn(h, x);
}

__device__ __forceinline__ uint32_t draw_word(uint32_t k0, uint32_t k1,
                                              int64_t i) {
  uint32_t x0 = static_cast<uint32_t>(static_cast<uint64_t>(i) >> 32);
  uint32_t x1 = static_cast<uint32_t>(i);
  repro_prf::threefry2x32<kJaxRounds>(k0, k1, x0, x1);
  return x0 ^ x1;
}

// prf._unit: JAX's mantissa trick, exactly (w >> 9) * 2^-23
__device__ __forceinline__ float unit(uint32_t w) {
  return __fmul_rn(__uint2float_rn(w >> 9), 0x1p-23f);
}

template <int MODE>
__device__ __forceinline__ float finish_f32(uint32_t w) {
  if constexpr (MODE == kUniform) {
    return unit(w);
  } else {
    const float span = __fsub_rn(1.0f, kNormalLo);
    const float u = fmaxf(kNormalLo, __fadd_rn(__fmul_rn(unit(w), span),
                                               kNormalLo));
    return __fmul_rn(erf_inv_f32(u), kSqrt2);
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
    jax_random_kernel(uint32_t k0, uint32_t k1, int64_t n, void* out) {
  const int64_t first =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t quads = n >> 2;
  for (int64_t g = first; g < quads; g += stride) {
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = draw_word(k0, k1, 4 * g + j);
    if constexpr (MODE == kBits) {
      longlong2* o = reinterpret_cast<longlong2*>(out) + 2 * g;
      o[0] = make_longlong2(w[0], w[1]);
      o[1] = make_longlong2(w[2], w[3]);
    } else {
      reinterpret_cast<float4*>(out)[g] =
          make_float4(finish_f32<MODE>(w[0]), finish_f32<MODE>(w[1]),
                      finish_f32<MODE>(w[2]), finish_f32<MODE>(w[3]));
    }
  }
  for (int64_t i = (quads << 2) + first; i < n; i += stride) {
    const uint32_t w = draw_word(k0, k1, i);
    if constexpr (MODE == kBits) {
      reinterpret_cast<int64_t*>(out)[i] = w;
    } else {
      reinterpret_cast<float*>(out)[i] = finish_f32<MODE>(w);
    }
  }
}

template <int MODE>
int launch(uint32_t k0, uint32_t k1, int64_t n, void* out,
           cudaStream_t stream) {
  const auto kernel = jax_random_kernel<MODE>;
  const int64_t work = (n >> 2) > 0 ? (n >> 2) : 1;
  const unsigned grid = repro_prf::occupancy_grid(
      kernel, kThreads, 0, (work + kThreads - 1) / kThreads);
  kernel<<<grid, kThreads, 0, stream>>>(k0, k1, n, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out: n int64 (mode 0) or n f32 (modes 1, 2), on the device and 16-byte
// aligned (a fresh torch.empty).  Returns cudaGetLastError() after the
// launch (0 = launched); n <= 0 launches nothing; an unknown mode returns
// -1.
extern "C" int jax_random_launch(uint32_t k0, uint32_t k1, int64_t n,
                                 int32_t mode, void* out, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kBits:
      return launch<kBits>(k0, k1, n, out, st);
    case kUniform:
      return launch<kUniform>(k0, k1, n, out, st);
    case kNormal:
      return launch<kNormal>(k0, k1, n, out, st);
    default:
      return -1;
  }
}
