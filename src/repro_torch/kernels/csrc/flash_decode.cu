// K10: single-token GQA decode attention over a (ring-buffer) KV cache.
//
// Replaces the Pallas kernel repro/kernels/flash_decode.py::flash_decode
// (body _flash_decode_kernel).  For each batch row b and query head h of
// kv-head g:
//   valid[s] = slot_pos[s] >= 0 && slot_pos[s] <= pos
//              && (window <= 0 || pos - slot_pos[s] < window)
//   score[s] = valid[s] ? q[b,h] . k[b,s,g] : -1e30   (q pre-scaled)
//   out[b,h] = sum_s exp(score[s] - m) v[b,s,g]
//              / max(sum_s exp(score[s] - m), 1e-30)
// with m the running maximum, as the Pallas kernel's online softmax keeps
// it: the mask value and the initial maximum are both -1e30, so a row whose
// slots are all invalid averages v over the cache, as there.  K and V are
// f32 or bf16 (B, W, KV, hd); every sum is f32.
//
// Bound on an H100: bytes.  Each call reads the whole cache once, about
// 2*B*W*KV*hd*4 bytes in f32 against 4*B*H*W*hd flops: 34 MB = 10 us at
// 3.35 TB/s on the serve path (B=8, W=2080, KV=2, hd=128) and 8.6 GB =
// 2.56 ms at the decode_32k shape (B=128, W=32768).  The TPU kernel walks
// W in 256-slot blocks in order, one (b, kv-head) per grid row; here
// B*KV = 16 would leave most of the 132 SMs idle, so the design splits W
// (flash-decoding): block (split, b*KV*group) owns one contiguous range of
// slots for up to 8 query rows of one kv-head, and a second kernel merges
// the splits.  The wrapper picks the split count for ~64 blocks per SM (5
// fit at once), so the last wave is short.  Inside a block, 4 warps take
// 32-slot tiles in turn: each lane scores one slot (its K row read once,
// 16 bytes a load; q in shared memory), the warp updates its own
// online-softmax state with shuffles, then walks the tile's V rows with
// the lanes across hd (coalesced).  The 4 warps' states merge in shared
// memory and each block writes one partial (m, l, acc) per query row.
// K/V bytes are read exactly once; the partials add B*H*splits*(hd+2)*4
// bytes (2.5% on the serve path).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;       // cache slots per warp step, one per lane
constexpr int kMaxRows = 8;     // query rows (one kv-head's group) per block
constexpr float kNeg = -1e30f;  // the reference's mask value and initial max
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// four consecutive elements as f32 (16 bytes of f32, 8 of bf16)
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  // bf16 is the high half of an f32: element 2i sits in the low 16 bits
  return make_float4(__uint_as_float(raw.x << 16),
                     __uint_as_float(raw.x & 0xFFFF0000u),
                     __uint_as_float(raw.y << 16),
                     __uint_as_float(raw.y & 0xFFFF0000u));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// grid (splits, B*KV*groups); part_acc (B, H, splits, hd), part_ml
// (B, H, splits, 2) = (m, l) of each split
template <typename T, int HPL>
__global__ void __launch_bounds__(kThreads)
    flash_decode_partial_kernel(const float* __restrict__ q,
                                const T* __restrict__ k,
                                const T* __restrict__ v,
                                const int32_t* __restrict__ slot_pos,
                                float* __restrict__ part_acc,
                                float* __restrict__ part_ml, int H, int KV,
                                int W, int pos, int window, int chunk,
                                int groups) {
  constexpr int HD = HPL * 32;
  __shared__ __align__(16) float qs[kMaxRows][HD];
  __shared__ float wm[kWarps][kMaxRows];
  __shared__ float wl[kWarps][kMaxRows];
  __shared__ float wacc[kWarps][kMaxRows][HD];

  const int split = blockIdx.x;
  const int nsplit = gridDim.x;
  int y = blockIdx.y;
  const int grp = y % groups;
  y /= groups;
  const int g = y % KV;
  const int b = y / KV;
  const int rep = H / KV;
  const int nr = min(kMaxRows, rep - grp * kMaxRows);
  const int h0 = g * rep + grp * kMaxRows;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int i = threadIdx.x; i < kMaxRows * HD; i += kThreads) {
    const int r = i / HD, d = i - r * HD;
    qs[r][d] = r < nr ? q[(static_cast<int64_t>(b) * H + h0 + r) * HD + d]
                      : 0.f;
  }
  __syncthreads();

  float m[kMaxRows], l[kMaxRows], acc[kMaxRows][HPL];
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < HPL; ++i) acc[r][i] = 0.f;
  }

  const int64_t row = static_cast<int64_t>(KV) * HD;  // slot to slot
  const int64_t base = (static_cast<int64_t>(b) * W * KV + g) * HD;
  const T* kb = k + base;
  const T* vb = v + base;
  const int s_end = min(W, (split + 1) * chunk);
  for (int t0 = split * chunk + warp * kTile; t0 < s_end;
       t0 += kWarps * kTile) {
    const int s = t0 + lane;
    const bool in = s < s_end;
    float sc[kMaxRows];
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) sc[r] = 0.f;
    bool valid = false;
    if (in) {
      const T* kr = kb + s * row;
#pragma unroll 8
      for (int d = 0; d < HD; d += 4) {
        const float4 kk = load4(kr + d);
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r) {
          if (r < nr) {
            const float4 qq = *reinterpret_cast<const float4*>(&qs[r][d]);
            sc[r] += qq.x * kk.x + qq.y * kk.y + qq.z * kk.z + qq.w * kk.w;
          }
        }
      }
      const int sp = slot_pos[s];
      valid = sp >= 0 && sp <= pos && (window <= 0 || pos - sp < window);
    }
    // online softmax over the tile; lanes past the range add nothing
    float p[kMaxRows];
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      p[r] = 0.f;
      if (r < nr) {
        const float x = valid ? sc[r] : kNeg;
        const float m_new = fmaxf(m[r], warp_max(x));
        const float alpha = expf(m[r] - m_new);
        p[r] = in ? expf(x - m_new) : 0.f;
        l[r] = l[r] * alpha + warp_sum(p[r]);
#pragma unroll
        for (int i = 0; i < HPL; ++i) acc[r][i] *= alpha;
        m[r] = m_new;
      }
    }
    const int n = min(kTile, s_end - t0);
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const T* vr = vb + (t0 + j) * row;
      float vv[HPL];
#pragma unroll
      for (int i = 0; i < HPL; ++i) vv[i] = to_f32(vr[lane + 32 * i]);
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < nr) {
          const float pj = __shfl_sync(kFull, p[r], j);
#pragma unroll
          for (int i = 0; i < HPL; ++i) acc[r][i] += pj * vv[i];
        }
      }
    }
  }

  // merge the warps' states, write the block's partial per query row
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    if (lane == 0) {
      wm[warp][r] = m[r];
      wl[warp][r] = l[r];
    }
#pragma unroll
    for (int i = 0; i < HPL; ++i) wacc[warp][r][lane + 32 * i] = acc[r][i];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nr * HD; i += kThreads) {
    const int r = i / HD, d = i - r * HD;
    float mx = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w][r]);
    float ls = 0.f, as = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(wm[w][r] - mx);
      ls += e * wl[w][r];
      as += e * wacc[w][r][d];
    }
    const int64_t o = (static_cast<int64_t>(b) * H + h0 + r) * nsplit + split;
    part_acc[o * HD + d] = as;
    if (d == 0) {
      part_ml[2 * o] = mx;
      part_ml[2 * o + 1] = ls;
    }
  }
}

// one block per (b, h); a thread per output element
__global__ void flash_decode_combine_kernel(const float* __restrict__ part_acc,
                                            const float* __restrict__ part_ml,
                                            float* __restrict__ out,
                                            int nsplit, int hd) {
  const int64_t bh = blockIdx.x;
  const float* ml = part_ml + bh * nsplit * 2;
  float mx = kNeg;
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, ml[2 * s]);
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float ls = 0.f, as = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const float e = expf(ml[2 * s] - mx);
      ls += e * ml[2 * s + 1];
      as += e * part_acc[(bh * nsplit + s) * hd + d];
    }
    out[bh * hd + d] = as / fmaxf(ls, 1e-30f);
  }
}

template <typename T, int HPL>
void launch_partial(dim3 grid, cudaStream_t stream, const float* q,
                    const void* k, const void* v, const int32_t* slot_pos,
                    float* part_acc, float* part_ml, int H, int KV, int W,
                    int pos, int window, int chunk, int groups) {
  flash_decode_partial_kernel<T, HPL><<<grid, kThreads, 0, stream>>>(
      q, static_cast<const T*>(k), static_cast<const T*>(v), slot_pos,
      part_acc, part_ml, H, KV, W, pos, window, chunk, groups);
}

template <typename T>
int dispatch_hd(int hd, dim3 grid, cudaStream_t stream, const float* q,
                const void* k, const void* v, const int32_t* slot_pos,
                float* part_acc, float* part_ml, int H, int KV, int W,
                int pos, int window, int chunk, int groups) {
  switch (hd) {
    case 32:
      launch_partial<T, 1>(grid, stream, q, k, v, slot_pos, part_acc,
                           part_ml, H, KV, W, pos, window, chunk, groups);
      return 0;
    case 64:
      launch_partial<T, 2>(grid, stream, q, k, v, slot_pos, part_acc,
                           part_ml, H, KV, W, pos, window, chunk, groups);
      return 0;
    case 128:
      launch_partial<T, 4>(grid, stream, q, k, v, slot_pos, part_acc,
                           part_ml, H, KV, W, pos, window, chunk, groups);
      return 0;
    case 256:
      launch_partial<T, 8>(grid, stream, q, k, v, slot_pos, part_acc,
                           part_ml, H, KV, W, pos, window, chunk, groups);
      return 0;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: (B, H, hd) f32; k, v: (B, W, KV, hd) f32 (kv_bf16 = 0) or bf16;
// slot_pos: (W,) int32; out: (B, H, hd) f32; part_acc: (B, H, nsplit, hd)
// and part_ml: (B, H, nsplit, 2) f32 scratch.  Slots [i*chunk, (i+1)*chunk)
// belong to split i; chunk is a multiple of 32.  hd is 32, 64, 128 or 256.
// Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int flash_decode_launch(const float* q, const void* k,
                                   const void* v, const int32_t* slot_pos,
                                   float* out, float* part_acc,
                                   float* part_ml, int32_t B, int32_t H,
                                   int32_t KV, int32_t W, int32_t hd,
                                   int32_t kv_bf16, int32_t pos,
                                   int32_t window, int32_t nsplit,
                                   int32_t chunk, cudaStream_t stream) {
  const int rep = H / KV;
  const int groups = (rep + kMaxRows - 1) / kMaxRows;
  const dim3 grid(static_cast<unsigned>(nsplit),
                  static_cast<unsigned>(B * KV * groups));
  const int status =
      kv_bf16 ? dispatch_hd<__nv_bfloat16>(hd, grid, stream, q, k, v,
                                           slot_pos, part_acc, part_ml, H, KV,
                                           W, pos, window, chunk, groups)
              : dispatch_hd<float>(hd, grid, stream, q, k, v, slot_pos,
                                   part_acc, part_ml, H, KV, W, pos, window,
                                   chunk, groups);
  if (status != 0) return status;
  flash_decode_combine_kernel<<<B * H, hd, 0, stream>>>(part_acc, part_ml,
                                                        out, nsplit, hd);
  return static_cast<int>(cudaGetLastError());
}
