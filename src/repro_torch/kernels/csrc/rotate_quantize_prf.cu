// Fused sketch encode: out[e] = q(H(signs ⊙ x)[e] * c), one 512-wide
// Walsh–Hadamard block per warp, c = f32(f32(1/sqrt(512)) * scale).
//
// Replaces the Pallas kernel repro/kernels/secure_agg.py::rotate_quantize_prf
// (body _rotate_quantize_prf_kernel).
//
// Bound on an H100: memory and the integer ALU pipe, about evenly.  Each
// element moves 8 bytes (one f32 in, one int32 out), needs a TAG_SIGN word
// and a TAG_UNIFORM word, and 9 float adds of the butterflies.  One
// Threefry-2x32-13 (about 31 integer-pipe instructions) yields two words,
// so at one evaluation per element the PRF needs about as much time as the
// bytes.  Design:
//  - one warp owns one Hadamard block, lane l the four element quads
//    4 (l + 32 j) + 0..3, j = 0..3: every load and store is a 16-byte
//    vector access, a warp's access 512 contiguous bytes;
//  - butterfly stages h = 1, 2 pair elements of one quad and h = 128, 256
//    quads of one lane, all in registers; h = 4..64 pair lanes of the warp
//    (__shfl_xor_sync with lane mask h / 4).  No shared memory, no barrier;
//  - both words of each Threefry evaluation are used: a quad's four sign
//    words are the two words of counters e/2 and e/2 + 1 (blocks start at
//    multiples of 512); its uniform words, at stream positions u_off + e ..
//    u_off + e + 3, are those of two counters when u_off is even and span
//    three when it is odd (ODD_U), the third being the next quad's first
//    counter, taken from the neighbouring lane by a shuffle;
//  - a grid of as many CTAs as stay resident (occupancy), each warp striding
//    over blocks.
// At every butterfly stage the lower position of a pair gets a + b and the
// higher a - b, a being the LOWER element: the pairing order of the
// reference's reshape cascade, so the f32 results are bit-equal to the
// plain version.  Stream positions u_off + e are taken in 64 bits (the
// counter is their half mod 2^32), as the plain version and the host
// streams take them.  Round-to-nearest intrinsics (and --fmad=false) keep
// every float operation single and uncontracted.
#include <cuda_runtime.h>

#include <cstdint>

#include "prf.cuh"

namespace {

constexpr int kBlock = 512;  // Hadamard block, one per warp
constexpr int kWarps = 8;    // warps (Hadamard blocks in flight) per CTA
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

// (a, b) <- (a + b, a - b), a the lower element of the pair.
__device__ __forceinline__ void butterfly(float& a, float& b) {
  const float s = __fadd_rn(a, b);
  b = __fsub_rn(a, b);
  a = s;
}

template <bool ODD_U>
__global__ void __launch_bounds__(kThreads) rotate_quantize_prf_kernel(
    const float* __restrict__ x, uint32_t* __restrict__ out, int64_t n,
    int64_t blocks, float c, uint32_t o0, uint32_t o1, uint32_t u0,
    uint32_t u1, uint64_t u_off, int vec) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t blk = static_cast<int64_t>(blockIdx.x) * kWarps +
                     (threadIdx.x >> 5);
       blk < blocks; blk += stride) {
    const int64_t base = blk * kBlock;
    float v[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t i = base + 4 * (lane + 32 * j);
      if (vec && i + 3 < n) {
        const float4 t = *reinterpret_cast<const float4*>(x + i);
        v[j][0] = t.x;
        v[j][1] = t.y;
        v[j][2] = t.z;
        v[j][3] = t.w;
      } else {  // zero past n: the Hadamard pad
#pragma unroll
        for (int k = 0; k < 4; ++k) v[j][k] = (i + k < n) ? x[i + k] : 0.0f;
      }
    }
    // signs, from the operator-domain position e: counters e/2, e/2 + 1
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t e = static_cast<uint32_t>(base + 4 * (lane + 32 * j));
      const uint2 a = repro_prf::stream_pair_at(o0, o1, e >> 1,
                                                repro_prf::kTagSign);
      const uint2 b = repro_prf::stream_pair_at(o0, o1, (e >> 1) + 1u,
                                                repro_prf::kTagSign);
      v[j][0] = __fmul_rn(v[j][0], (a.x & 1u) ? -1.0f : 1.0f);
      v[j][1] = __fmul_rn(v[j][1], (a.y & 1u) ? -1.0f : 1.0f);
      v[j][2] = __fmul_rn(v[j][2], (b.x & 1u) ? -1.0f : 1.0f);
      v[j][3] = __fmul_rn(v[j][3], (b.y & 1u) ? -1.0f : 1.0f);
    }
    // h = 1, 2: within a quad
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      butterfly(v[j][0], v[j][1]);
      butterfly(v[j][2], v[j][3]);
      butterfly(v[j][0], v[j][2]);
      butterfly(v[j][1], v[j][3]);
    }
    // h = 4 .. 64: element bit h is lane bit h / 4
#pragma unroll
    for (int m = 1; m < 32; m <<= 1) {
      const bool upper = (lane & m) != 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float p = __shfl_xor_sync(kFull, v[j][k], m);
          v[j][k] = upper ? __fsub_rn(p, v[j][k]) : __fadd_rn(v[j][k], p);
        }
      }
    }
    // h = 128, 256: element bits 7 and 8 are bits 0 and 1 of j
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      butterfly(v[0][k], v[1][k]);
      butterfly(v[2][k], v[3][k]);
      butterfly(v[0][k], v[2][k]);
      butterfly(v[1][k], v[3][k]);
    }
    // uniforms at positions u_off + e .. + 3 (64-bit), then quantize
    uint2 ua[4], ub[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint64_t p =
          u_off + static_cast<uint64_t>(base + 4 * (lane + 32 * j));
      const uint32_t uc = static_cast<uint32_t>(p >> 1);
      ua[j] = repro_prf::stream_pair_at(u0, u1, uc, repro_prf::kTagUniform);
      ub[j] = repro_prf::stream_pair_at(u0, u1, uc + 1u,
                                        repro_prf::kTagUniform);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t uw[4];
      if (ODD_U) {
        // the third counter is the next quad's first: lane l + 1's, lane
        // 0's of j + 1 for lane 31, and past the block's end evaluated here
        uint32_t next = __shfl_down_sync(kFull, ua[j].x, 1);
        if (j < 3) {
          const uint32_t wrap = __shfl_sync(kFull, ua[j < 3 ? j + 1 : j].x,
                                            0);
          if (lane == 31) next = wrap;
        } else if (lane == 31) {
          const uint64_t p = u_off + static_cast<uint64_t>(base + kBlock);
          next = repro_prf::stream_pair_at(u0, u1,
                                           static_cast<uint32_t>(p >> 1),
                                           repro_prf::kTagUniform).x;
        }
        uw[0] = ua[j].y;
        uw[1] = ub[j].x;
        uw[2] = ub[j].y;
        uw[3] = next;
      } else {
        uw[0] = ua[j].x;
        uw[1] = ua[j].y;
        uw[2] = ub[j].x;
        uw[3] = ub[j].y;
      }
      uint32_t q[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        q[k] = repro_prf::stochastic_round(
            __fmul_rn(v[j][k], c), repro_prf::bits_to_uniform(uw[k]));
      }
      const int64_t i = base + 4 * (lane + 32 * j);
      *reinterpret_cast<uint4*>(out + i) = make_uint4(q[0], q[1], q[2], q[3]);
    }
  }
}

template <bool ODD_U>
int launch(const float* x, uint32_t* out, int64_t n, int64_t blocks, float c,
           uint32_t o0, uint32_t o1, uint32_t u0, uint32_t u1, uint64_t u_off,
           int vec, cudaStream_t stream) {
  auto kernel = rotate_quantize_prf_kernel<ODD_U>;
  const unsigned grid = repro_prf::occupancy_grid(
      kernel, kThreads, 0, (blocks + kWarps - 1) / kWarps);
  kernel<<<grid, kThreads, 0, stream>>>(x, out, n, blocks, c, o0, o1, u0, u1,
                                        u_off, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (n,) f32; out: (full,) int32, 16-byte aligned, with full = ceil(n /
// 512) * 512.  vec: x is 16-byte aligned.  Returns cudaGetLastError() after
// the launch (0 = launched).
extern "C" int rotate_quantize_prf_launch(const float* x, uint32_t* out,
                                          int64_t n, int64_t full, float c,
                                          uint32_t o0, uint32_t o1,
                                          uint32_t u0, uint32_t u1,
                                          uint64_t u_off, int32_t vec,
                                          void* stream) {
  if (full <= 0) return 0;
  if (full % kBlock != 0 || full < n || full - n >= kBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = full / kBlock;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (u_off & 1u)
             ? launch<true>(x, out, n, blocks, c, o0, o1, u0, u1, u_off, vec, s)
             : launch<false>(x, out, n, blocks, c, o0, o1, u0, u1, u_off, vec,
                             s);
}
