// The DP-SGD clip-and-reduce pair over a (C clients x D elements) block:
//
//   K3 sq_norms     out[c] = sum_d x[c,d]^2                     (C,) f32
//   K8 scale_accum  out[d] = sum_c s[c] * x[c,d]                (D,) f32
//
// Replace the Pallas kernels repro/kernels/dp_clip.py::sq_norms and
// ::scale_accum (dp_clip_reduce = K3 -> clip scales -> K8 keeps the clipped
// rows out of device memory).
//
// Bound on an H100: bytes.  K3 reads C*D*4 bytes and writes C floats
// (2 operations per element: 0.5 per byte, far below the card's ~20 f32
// operations per byte of bandwidth); K8 reads C*D*4 + C*4 and writes D*4.
// Design: the TPU kernels carried the sums across a sequential grid axis in
// VMEM.  Here K3 splits each row over `nblk` blocks that write partial sums,
// and a second small kernel adds each row's partials in a fixed order, so
// the result is the same on every run (no atomics).  K8 gives each thread
// whole columns and loops over the C clients itself, summing in client
// order: 0 + s0*x0 + s1*x1 + ..., each product and sum rounded on its own
// (--fmad=false and the _rn intrinsics), which is the plain PyTorch
// version's order, so K8 equals it bit for bit.  Both read 16 bytes a
// thread (float4) when every row starts 16-byte aligned, else 4.
// Offsets are int64_t: at full width C*D passes 2^31.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float block_sum(float v, float* smem) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  float t = 0.f;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t = __fadd_rn(t, smem[w]);
  }
  return t;  // valid in thread 0
}

// Pass 1: grid (nblk, rows); block b of row c sums a strided share of it.
template <bool VEC>
__global__ void sq_norms_partial_kernel(const float* __restrict__ x,
                                        float* __restrict__ partial,
                                        int64_t D, int64_t row0, int nblk) {
  __shared__ float smem[kWarps];
  const int64_t c = row0 + blockIdx.y;
  const float* row = x + c * D;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(nblk) * kThreads;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  if (VEC) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
    const int64_t n4 = D >> 2;
    for (int64_t i = tid; i < n4; i += stride) {
      const float4 v = r4[i];
      a0 = __fadd_rn(a0, __fmul_rn(v.x, v.x));
      a1 = __fadd_rn(a1, __fmul_rn(v.y, v.y));
      a2 = __fadd_rn(a2, __fmul_rn(v.z, v.z));
      a3 = __fadd_rn(a3, __fmul_rn(v.w, v.w));
    }
  } else {
    for (int64_t i = tid; i < D; i += stride) {
      const float v = row[i];
      a0 = __fadd_rn(a0, __fmul_rn(v, v));
    }
  }
  const float t = block_sum(__fadd_rn(__fadd_rn(a0, a1), __fadd_rn(a2, a3)), smem);
  if (threadIdx.x == 0) partial[c * nblk + blockIdx.x] = t;
}

// Pass 2: one block per row adds the row's nblk partials.
__global__ void sq_norms_finish_kernel(const float* __restrict__ partial,
                                       float* __restrict__ out, int64_t row0,
                                       int nblk) {
  __shared__ float smem[kWarps];
  const int64_t c = row0 + blockIdx.x;
  float a = 0.f;
  for (int i = threadIdx.x; i < nblk; i += kThreads)
    a = __fadd_rn(a, partial[c * nblk + i]);
  const float t = block_sum(a, smem);
  if (threadIdx.x == 0) out[c] = t;
}

template <bool VEC>
__global__ void scale_accum_kernel(const float* __restrict__ x,
                                   const float* __restrict__ s,
                                   float* __restrict__ out, int64_t C,
                                   int64_t D) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (VEC) {
    const int64_t n4 = D >> 2;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (int64_t i = first; i < n4; i += stride) {
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int64_t c = 0; c < C; ++c) {
        const float sc = s[c];
        const float4 v = x4[c * n4 + i];
        a.x = __fadd_rn(a.x, __fmul_rn(sc, v.x));
        a.y = __fadd_rn(a.y, __fmul_rn(sc, v.y));
        a.z = __fadd_rn(a.z, __fmul_rn(sc, v.z));
        a.w = __fadd_rn(a.w, __fmul_rn(sc, v.w));
      }
      o4[i] = a;
    }
  } else {
    for (int64_t d = first; d < D; d += stride) {
      float a = 0.f;
      for (int64_t c = 0; c < C; ++c) a = __fadd_rn(a, __fmul_rn(s[c], x[c * D + d]));
      out[d] = a;
    }
  }
}

unsigned grid_for(int64_t work) {
  const int64_t want = (work + kThreads - 1) / kThreads;
  const int64_t cap = 132 * 16;  // resident blocks of an H100, then stride
  return static_cast<unsigned>(want < 1 ? 1 : (want < cap ? want : cap));
}

}  // namespace

// partial: nblk floats per row of scratch.  vec: D % 4 == 0 and x 16-byte
// aligned.  Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int sq_norms_launch(const float* x, float* partial, float* out,
                               int64_t C, int64_t D, int32_t nblk,
                               int32_t vec, void* stream) {
  if (C <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int64_t r0 = 0; r0 < C; r0 += 65535) {
    const int64_t rows = (C - r0 < 65535) ? (C - r0) : 65535;
    const dim3 grid(static_cast<unsigned>(nblk), static_cast<unsigned>(rows));
    if (vec) {
      sq_norms_partial_kernel<true><<<grid, kThreads, 0, st>>>(x, partial, D, r0, nblk);
    } else {
      sq_norms_partial_kernel<false><<<grid, kThreads, 0, st>>>(x, partial, D, r0, nblk);
    }
    sq_norms_finish_kernel<<<static_cast<unsigned>(rows), kThreads, 0, st>>>(
        partial, out, r0, nblk);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int scale_accum_launch(const float* x, const float* s, float* out,
                                  int64_t C, int64_t D, int32_t vec,
                                  void* stream) {
  if (D <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec) {
    scale_accum_kernel<true><<<grid_for(D >> 2), kThreads, 0, st>>>(x, s, out, C, D);
  } else {
    scale_accum_kernel<false><<<grid_for(D), kThreads, 0, st>>>(x, s, out, C, D);
  }
  return static_cast<int>(cudaGetLastError());
}
