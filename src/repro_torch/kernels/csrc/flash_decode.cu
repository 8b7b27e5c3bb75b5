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
// 2.56 ms at the decode_32k shape (B=128, W=32768).  So the design keeps
// tens of KB of K/V in flight on every SM and launches once:
//  - one CTA of 4 warps per (b, kv-head g, row group, split) holds up to 8
//    query rows of g in registers (lanes across hd); W is cut into nsplit
//    near-equal ranges, nsplit chosen by the wrapper so that the grid is a
//    whole number of waves (SMs x CTAs resident per SM);
//  - the CTA's range goes through a 2-stage shared-memory ring of 16-slot
//    K and V tiles filled by 16-byte cp.async.cg copies (zero-filled past
//    the range), the next tile in flight while one is scored (4 CTAs an
//    SM keep 64 KB in flight); one barrier a tile;
//  - warp w scores slots 4w .. 4w + 3 of a tile: each lane takes hd/32
//    contiguous elements of a K row from shared memory (conflict-free), and
//    the 4 slots x 8 rows partial dots are summed over the warp in one
//    reduce-scatter (31 shuffles, lane l ends with slot l / 8, row l % 8);
//  - each warp keeps its own online-softmax state and runs P.V with the
//    lanes across hd, V rows read from shared memory; the 4 warps' states
//    merge in shared memory once, at the end;
//  - the splits merge in the same launch: each CTA writes its partial
//    (m, l, acc), and the last CTA of each (b, g, row group) to take a
//    ticket (a global atomic counter it then resets to 0) merges them, one
//    online-softmax pass over the splits per output quad.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 16;        // cache slots per ring stage
constexpr int kSlotsPerWarp = kTile / kWarps;
constexpr int kStages = 2;
constexpr int kMaxRows = 8;      // query rows (one kv-head's group) per CTA
constexpr int kMaxSplits = 256;  // the wrapper's MAX_SPLITS
constexpr float kNeg = -1e30f;   // the reference's mask value and initial max
constexpr unsigned kFull = 0xFFFFFFFFu;

static_assert(kSlotsPerWarp * kMaxRows == 32, "reduce-scatter layout");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool fill) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = fill ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// E consecutive elements as f32 (shared or global memory, aligned to
// E * sizeof(T) bytes)
template <int E>
__device__ __forceinline__ void load_e(const float* p, float* o) {
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int i = 0; i < E / 4; ++i) {
      const float4 t = reinterpret_cast<const float4*>(p)[i];
      o[4 * i] = t.x;
      o[4 * i + 1] = t.y;
      o[4 * i + 2] = t.z;
      o[4 * i + 3] = t.w;
    }
  } else if constexpr (E == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    o[0] = t.x;
    o[1] = t.y;
  } else {
    o[0] = p[0];
  }
}

// bf16 is the high half of an f32: element 2i sits in the low 16 bits
__device__ __forceinline__ void unpack2(uint32_t w, float* o) {
  o[0] = __uint_as_float(w << 16);
  o[1] = __uint_as_float(w & 0xFFFF0000u);
}

template <int E>
__device__ __forceinline__ void load_e(const __nv_bfloat16* p, float* o) {
  if constexpr (E == 8) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    unpack2(t.x, o);
    unpack2(t.y, o + 2);
    unpack2(t.z, o + 4);
    unpack2(t.w, o + 6);
  } else if constexpr (E == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    unpack2(t.x, o);
    unpack2(t.y, o + 2);
  } else if constexpr (E == 2) {
    unpack2(*reinterpret_cast<const uint32_t*>(p), o);
  } else {
    o[0] = __bfloat162float(p[0]);
  }
}

// One step of a warp reduce-scatter over 2 * O values a lane: the lanes
// with bit O set keep (and are sent the partner's) upper half, the others
// the lower half; afterwards part[0 .. O) holds those sums.
template <int O>
__device__ __forceinline__ void scatter_step(float* part, int lane) {
  const bool up = (lane & O) != 0;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float send = up ? part[i] : part[i + O];
    const float keep = up ? part[i + O] : part[i];
    part[i] = keep + __shfl_xor_sync(kFull, send, O);
  }
}

// Dynamic shared memory of one CTA: the K/V ring, reused after the loop for
// the warps' states.
template <typename T, int HD>
constexpr size_t smem_bytes() {
  const size_t ring = static_cast<size_t>(kStages) * 2 * kTile * HD *
                      sizeof(T);
  const size_t warps = (static_cast<size_t>(kWarps) * kMaxRows * (HD + 3) +
                        2 * kMaxRows) * sizeof(float);
  return ring > warps ? ring : warps;
}

// grid (nsplit, B*KV*groups); part_acc (B, H, nsplit, hd), part_ml
// (B, H, nsplit, 2) = (m, l) of each split; tickets (B*KV*groups,) zero
// before the launch and after it
template <typename T, int HD, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
    flash_decode_kernel(const float* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int32_t* __restrict__ slot_pos,
                        float* __restrict__ out, float* __restrict__ part_acc,
                        float* __restrict__ part_ml,
                        int32_t* __restrict__ tickets, int H, int KV, int W,
                        int pos, int window, int groups) {
  constexpr int E = HD / 32;                         // elements per lane
  constexpr int CPR = HD * sizeof(T) / 16;           // 16-byte chunks a row
  constexpr int STAGE = 2 * kTile * HD;              // elements per stage
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  __shared__ __align__(16) float pbuf[kWarps][32];   // p of (slot, row)
  __shared__ __align__(16) float abuf[kWarps][kMaxRows];  // alpha per row
  __shared__ bool last;

  const int split = blockIdx.x;
  const int nsplit = gridDim.x;
  const int cta_row = blockIdx.y;
  int y = cta_row;
  const int grp = y % groups;
  y /= groups;
  const int g = y % KV;
  const int b = y / KV;
  const int rep = H / KV;
  const int nr = min(kMaxRows, rep - grp * kMaxRows);
  const int h0 = g * rep + grp * kMaxRows;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // this split's slots [s0, s1): near-equal ranges, none empty (nsplit <= W)
  const int s0 = static_cast<int>(static_cast<int64_t>(split) * W / nsplit);
  const int s1 =
      static_cast<int>(static_cast<int64_t>(split + 1) * W / nsplit);
  const int ntiles = (s1 - s0 + kTile - 1) / kTile;

  const int64_t row = static_cast<int64_t>(KV) * HD;  // slot to slot
  const T* kb = k + (static_cast<int64_t>(b) * W * KV + g) * HD;
  const T* vb = v + (static_cast<int64_t>(b) * W * KV + g) * HD;

  auto issue = [&](int tile, int stage) {
    T* dst = ring + stage * STAGE;
    for (int c = threadIdx.x; c < 2 * kTile * CPR; c += kThreads) {
      const int which = c / (kTile * CPR);  // 0: K, 1: V
      const int rem = c - which * kTile * CPR;
      const int r = rem / CPR;
      const int col = rem - r * CPR;
      const int s = s0 + tile * kTile + r;
      const bool fill = s < s1;
      const T* src = (which ? vb : kb) + (fill ? s : s0) * row;
      cp_async16(reinterpret_cast<unsigned char*>(dst + which * kTile * HD +
                                                  r * HD) + 16 * col,
                 reinterpret_cast<const unsigned char*>(src) + 16 * col,
                 fill);
    }
  };

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < ntiles) issue(t, t);
    cp_async_commit();
  }

  float qr[kMaxRows][E], acc[kMaxRows][E];
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    if (r < nr) {
      load_e<E>(q + (static_cast<int64_t>(b) * H + h0 + r) * HD + lane * E,
                qr[r]);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) qr[r][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  }
  // the online-softmax state of row lane % 8 (the same in its 4 lanes)
  float m = kNeg, l = 0.f;
  const int my_sl = lane >> 3;

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (t + kStages - 1 < ntiles) issue(t + kStages - 1, (t + kStages - 1) %
                                                             kStages);
    cp_async_commit();

    // this lane's slot and its mask, loaded early: used after the dots
    const int s = s0 + t * kTile + warp * kSlotsPerWarp + my_sl;
    const bool in = s < s1;
    const int sp = in ? slot_pos[s] : -1;
    const T* ks = ring + (t % kStages) * STAGE;
    const T* vs = ks + kTile * HD;
    // partial dots of this lane's elements: part[sl * 8 + r]
    float part[32];
#pragma unroll
    for (int sl = 0; sl < kSlotsPerWarp; ++sl) {
      float kk[E];
      load_e<E>(ks + (warp * kSlotsPerWarp + sl) * HD + lane * E, kk);
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) a = fmaf(qr[r][e], kk[e], a);
        part[sl * kMaxRows + r] = a;
      }
    }
    // reduce-scatter over the warp: lane l ends with the total of part[l]
    scatter_step<16>(part, lane);
    scatter_step<8>(part, lane);
    scatter_step<4>(part, lane);
    scatter_step<2>(part, lane);
    scatter_step<1>(part, lane);
    const bool valid =
        in && sp >= 0 && sp <= pos && (window <= 0 || pos - sp < window);
    const float x = valid ? part[0] : kNeg;
    float mt = fmaxf(x, __shfl_xor_sync(kFull, x, 8));
    mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, 16));
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);
    const float p = in ? expf(x - m_new) : 0.f;
    float ps = p + __shfl_xor_sync(kFull, p, 8);
    ps += __shfl_xor_sync(kFull, ps, 16);
    l = l * alpha + ps;
    m = m_new;
    pbuf[warp][lane] = p;
    if (lane < kMaxRows) abuf[warp][lane] = alpha;
    __syncwarp();
    // P.V over the warp's 4 slots, lanes across hd
    float al[kMaxRows];
#pragma unroll
    for (int r = 0; r < kMaxRows; r += 4) {
      const float4 a4 = *reinterpret_cast<const float4*>(&abuf[warp][r]);
      al[r] = a4.x;
      al[r + 1] = a4.y;
      al[r + 2] = a4.z;
      al[r + 3] = a4.w;
    }
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] *= al[r];
    }
#pragma unroll
    for (int sl = 0; sl < kSlotsPerWarp; ++sl) {
      float vv[E];
      load_e<E>(vs + (warp * kSlotsPerWarp + sl) * HD + lane * E, vv);
      float pr[kMaxRows];
#pragma unroll
      for (int r = 0; r < kMaxRows; r += 4) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(&pbuf[warp][sl * kMaxRows + r]);
        pr[r] = p4.x;
        pr[r + 1] = p4.y;
        pr[r + 2] = p4.z;
        pr[r + 3] = p4.w;
      }
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] = fmaf(pr[r], vv[e], acc[r][e]);
      }
    }
    __syncwarp();
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: merge the warps' states in it

  float* wacc = reinterpret_cast<float*>(smem_raw);  // [warp][row][HD]
  float* wm = wacc + kWarps * kMaxRows * HD;          // [warp][row]
  float* wl = wm + kWarps * kMaxRows;
  if (lane < kMaxRows) {
    wm[warp * kMaxRows + lane] = m;
    wl[warp * kMaxRows + lane] = l;
  }
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
#pragma unroll
    for (int e = 0; e < E; ++e)
      wacc[(warp * kMaxRows + r) * HD + lane * E + e] = acc[r][e];
  }
  __syncthreads();
  // each warp's weight exp(m_w - max) per row, the row's max and sum
  float* we = wl + kWarps * kMaxRows;  // [warp][row]
  float* rm = we + kWarps * kMaxRows;  // [row]: max, then sum
  if (threadIdx.x < kMaxRows) {
    const int r = threadIdx.x;
    float mx = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * kMaxRows + r]);
    float ls = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(wm[w * kMaxRows + r] - mx);
      we[w * kMaxRows + r] = e;
      ls += e * wl[w * kMaxRows + r];
    }
    rm[r] = mx;
    rm[kMaxRows + r] = ls;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nr * HD; i += kThreads) {
    const int r = i / HD, d = i - r * HD;
    float as = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      as += we[w * kMaxRows + r] * wacc[(w * kMaxRows + r) * HD + d];
    const int64_t bh = static_cast<int64_t>(b) * H + h0 + r;
    if (nsplit == 1) {
      out[bh * HD + d] = as / fmaxf(rm[kMaxRows + r], 1e-30f);
    } else {
      const int64_t o = bh * nsplit + split;
      part_acc[o * HD + d] = as;
      if (d == 0) {
        part_ml[2 * o] = rm[r];
        part_ml[2 * o + 1] = rm[kMaxRows + r];
      }
    }
  }
  if (nsplit == 1) return;

  // the last CTA of (b, g, row group) to finish merges the splits
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int done = atomicAdd(&tickets[cta_row], 1);
    last = done == nsplit - 1;
    if (last) tickets[cta_row] = 0;  // ready for the next launch
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // one output quad (row r, elements 4j .. 4j + 3) a thread at a time: an
  // online merge over the splits in one pass, eight splits' loads in flight
  const int64_t bh0 = static_cast<int64_t>(b) * H + h0;
  for (int i = threadIdx.x; i < nr * (HD / 4); i += kThreads) {
    const int r = i / (HD / 4), j = i - r * (HD / 4);
    const float2* ml = reinterpret_cast<const float2*>(part_ml) +
                       (bh0 + r) * nsplit;
    const float4* pa = reinterpret_cast<const float4*>(
                           part_acc + (bh0 + r) * nsplit * HD) + j;
    float mx = kNeg, ls = 0.f;
    float4 as = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int sp = 0; sp < nsplit; ++sp) {
      const float2 msp = __ldcg(ml + sp);
      const float4 a = __ldcg(pa + static_cast<int64_t>(sp) * (HD / 4));
      const float mn = fmaxf(mx, msp.x);
      const float c0 = expf(mx - mn), c1 = expf(msp.x - mn);
      ls = fmaf(ls, c0, msp.y * c1);
      as.x = fmaf(as.x, c0, a.x * c1);
      as.y = fmaf(as.y, c0, a.y * c1);
      as.z = fmaf(as.z, c0, a.z * c1);
      as.w = fmaf(as.w, c0, a.w * c1);
      mx = mn;
    }
    const float d = fmaxf(ls, 1e-30f);
    reinterpret_cast<float4*>(out + (bh0 + r) * HD)[j] =
        make_float4(as.x / d, as.y / d, as.z / d, as.w / d);
  }
}

template <typename T, int HD>
auto kernel_for() {
  return flash_decode_kernel<T, HD, (HD >= 256 ? 2 : 4)>;
}

// opt in to the kernel's dynamic shared memory (above 48 KB for some
// shapes), once per instantiation
template <typename T, int HD>
cudaError_t prepare() {
  static const cudaError_t status = cudaFuncSetAttribute(
      kernel_for<T, HD>(), cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes<T, HD>()));
  return status;
}

template <typename T, int HD>
int launch(dim3 grid, cudaStream_t stream, const float* q, const void* k,
           const void* v, const int32_t* slot_pos, float* out,
           float* part_acc, float* part_ml, int32_t* tickets, int H, int KV,
           int W, int pos, int window, int groups) {
  const cudaError_t prep = prepare<T, HD>();
  if (prep != cudaSuccess) return static_cast<int>(prep);
  const auto kernel = kernel_for<T, HD>();
  kernel<<<grid, kThreads, smem_bytes<T, HD>(), stream>>>(
      q, static_cast<const T*>(k), static_cast<const T*>(v), slot_pos, out,
      part_acc, part_ml, tickets, H, KV, W, pos, window, groups);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int occupancy() {
  const cudaError_t prep = prepare<T, HD>();
  if (prep != cudaSuccess) return -static_cast<int>(prep);
  int per_sm = 0;
  const cudaError_t st = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel_for<T, HD>(), kThreads, smem_bytes<T, HD>());
  return st == cudaSuccess ? per_sm : -static_cast<int>(st);
}

template <typename T>
int dispatch_hd(int hd, dim3 grid, cudaStream_t stream, const float* q,
                const void* k, const void* v, const int32_t* slot_pos,
                float* out, float* part_acc, float* part_ml, int32_t* tickets,
                int H, int KV, int W, int pos, int window, int groups) {
  switch (hd) {
    case 32:
      return launch<T, 32>(grid, stream, q, k, v, slot_pos, out, part_acc,
                           part_ml, tickets, H, KV, W, pos, window, groups);
    case 64:
      return launch<T, 64>(grid, stream, q, k, v, slot_pos, out, part_acc,
                           part_ml, tickets, H, KV, W, pos, window, groups);
    case 128:
      return launch<T, 128>(grid, stream, q, k, v, slot_pos, out, part_acc,
                            part_ml, tickets, H, KV, W, pos, window, groups);
    case 256:
      return launch<T, 256>(grid, stream, q, k, v, slot_pos, out, part_acc,
                            part_ml, tickets, H, KV, W, pos, window, groups);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int occupancy_hd(int hd) {
  switch (hd) {
    case 32:
      return occupancy<T, 32>();
    case 64:
      return occupancy<T, 64>();
    case 128:
      return occupancy<T, 128>();
    case 256:
      return occupancy<T, 256>();
    default:
      return -static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: (B, H, hd) f32; k, v: (B, W, KV, hd) f32 (kv_bf16 = 0) or bf16;
// slot_pos: (W,) int32; out: (B, H, hd) f32; part_acc: (B, H, nsplit, hd)
// and part_ml: (B, H, nsplit, 2) f32 scratch; tickets: (B * KV * groups,)
// int32, zero (the kernel leaves it zero).  1 <= nsplit <= min(W, 256).
// Every pointer is 16-byte aligned; hd is 32, 64, 128 or 256.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int flash_decode_launch(const float* q, const void* k,
                                   const void* v, const int32_t* slot_pos,
                                   float* out, float* part_acc,
                                   float* part_ml, int32_t* tickets,
                                   int32_t B, int32_t H, int32_t KV,
                                   int32_t W, int32_t hd, int32_t kv_bf16,
                                   int32_t pos, int32_t window,
                                   int32_t nsplit, void* stream) {
  if (nsplit < 1 || nsplit > kMaxSplits || nsplit > W || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rep = H / KV;
  const int groups = (rep + kMaxRows - 1) / kMaxRows;
  const dim3 grid(static_cast<unsigned>(nsplit),
                  static_cast<unsigned>(B * KV * groups));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return kv_bf16 ? dispatch_hd<__nv_bfloat16>(hd, grid, s, q, k, v, slot_pos,
                                              out, part_acc, part_ml, tickets,
                                              H, KV, W, pos, window, groups)
                 : dispatch_hd<float>(hd, grid, s, q, k, v, slot_pos, out,
                                      part_acc, part_ml, tickets, H, KV, W,
                                      pos, window, groups);
}

// CTAs of the kernel for (hd, kv_bf16) resident on one SM at once, or a
// negative CUDA error.
extern "C" int flash_decode_ctas_per_sm(int32_t hd, int32_t kv_bf16) {
  return kv_bf16 ? occupancy_hd<__nv_bfloat16>(hd) : occupancy_hd<float>(hd);
}
