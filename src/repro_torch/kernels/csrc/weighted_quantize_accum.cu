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
// adds a mask word per (client, element, live neighbour) — 7 neighbours in
// an 8-slot complete graph — and one Threefry-2x32-13 (about 40 integer
// instructions) yields two words, so it is bound by the integer pipes.
// Design of the plain lanes: the TPU ran clients as a sequential grid axis
// accumulating into VMEM; here one block owns a tile of kThreads *
// kPerThread columns and loops over the clients itself, keeping the partial
// sums in registers, so no atomics and no second pass are needed and the
// sum order is fixed.  Loads are coalesced (neighbouring threads,
// neighbouring columns).  Design of the PRF lane (its own kernel):
//  - a thread owns column quads (two pairs of mask counters) and walks the
//    clients in their fixed order, evaluating each mask stream once per
//    counter and using both words; 16-byte loads of x and u where rows are
//    aligned;
//  - every row's live neighbours (the diagonal dropped, the sign a +-1
//    multiplier) are staged in shared memory once per block, before the
//    tile loop; a launch whose C rows do not fit stages row by row instead;
//  - for the 8-slot complete graph (NB = 7) a row's keys are held in
//    registers and the neighbour loop is unrolled;
//  - every stream the reference's kernel generates is generated here: the
//    masks of a full session cancel in the sum, but the lane stands for the
//    clients' masking work;
//  - a grid of as many blocks as stay resident (occupancy), striding over
//    1024-column tiles.
// Bit-exact with the plain PyTorch version: (x * w) * scale in the
// reference's order with round-to-nearest intrinsics (and --fmad=false),
// truncating conversion of an integral float, uint32_t wraparound sums.
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
    uint32_t* __restrict__ out, int64_t C, int64_t D, float scale) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x;
  uint32_t acc[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) acc[k] = 0u;

  for (int64_t c = 0; c < C; ++c) {
    const float wc = w[c];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int64_t d = base + static_cast<int64_t>(k) * kThreads;
      if (d < D) {
        const int64_t idx = c * D + d;
        uint32_t q = repro_prf::stochastic_round(
            __fmul_rn(__fmul_rn(x[idx], wc), scale), u[idx]);
        if (MODE == kExplicitMasks) q += static_cast<uint32_t>(masks[idx]);
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

constexpr int kQuadThreads = 256;
constexpr int kQuadTile = 4 * kQuadThreads;  // columns per tile
// shared memory for staging every row at once (else row by row)
constexpr size_t kStageAllBytes = 48 * 1024;

__device__ __forceinline__ void load_quad(const float* __restrict__ p,
                                          int64_t d, int64_t D, bool vec,
                                          float* v) {
  if (vec && d + 3 < D) {
    const float4 t = *reinterpret_cast<const float4*>(p + d);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = (d + k < D) ? p[d + k] : 0.0f;
  }
}

// Row-major staging: row r's entries at r * count, its live count live[r].
__device__ __forceinline__ void stage_rows(
    int r0, int r1, uint32_t k0, uint32_t k1, int slot_offset, int num_slots,
    int degree, const int32_t* table, int table_width, int count,
    uint32_t* pk0, uint32_t* pk1, uint32_t* sgn, int* live) {
  for (int r = r0 + threadIdx.x; r < r1; r += blockDim.x) live[r - r0] = 0;
  __syncthreads();
  // thread t stages neighbours t, t + blockDim.x, ... of every row
  for (int r = r0; r < r1; ++r) {
    const int64_t row = static_cast<int64_t>(slot_offset) + r;
    if (row >= num_slots) continue;
    const int64_t base = static_cast<int64_t>(r - r0) * count;
    repro_prf::stage_live_keys(k0, k1, static_cast<int>(row), count,
                               num_slots, degree, table, table_width,
                               pk0 + base, pk1 + base, sgn + base,
                               live + (r - r0), threadIdx.x, blockDim.x);
  }
  __syncthreads();
}

template <int NB>
__global__ void __launch_bounds__(kQuadThreads) prf_accum_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ u, uint32_t* __restrict__ out, int64_t C,
    int64_t D, float scale, uint32_t k0, uint32_t k1, int slot_offset,
    int num_slots, int degree, const int32_t* __restrict__ table,
    int table_width, int count, int all_rows, int vec) {
  extern __shared__ uint32_t smem[];
  const int rows = all_rows ? static_cast<int>(C) : 1;
  uint32_t* pk0 = smem;
  uint32_t* pk1 = smem + static_cast<size_t>(rows) * count;
  uint32_t* sgn = smem + 2 * static_cast<size_t>(rows) * count;
  int* live = reinterpret_cast<int*>(smem + 3 * static_cast<size_t>(rows) *
                                                count);
  if (all_rows) {
    stage_rows(0, static_cast<int>(C), k0, k1, slot_offset, num_slots,
               degree, table, table_width, count, pk0, pk1, sgn, live);
  }
  const int64_t tiles = (D + kQuadTile - 1) / kQuadTile;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t d = t * kQuadTile + 4 * static_cast<int64_t>(threadIdx.x);
    const uint32_t c2 = static_cast<uint32_t>(d) >> 1;
    uint32_t acc[4] = {0u, 0u, 0u, 0u};
    for (int64_t c = 0; c < C; ++c) {
      const int r = all_rows ? static_cast<int>(c) : 0;
      if (!all_rows) {
        __syncthreads();  // the previous row's keys are no longer read
        stage_rows(static_cast<int>(c), static_cast<int>(c) + 1, k0, k1,
                   slot_offset, num_slots, degree, table, table_width, count,
                   pk0, pk1, sgn, live);
      }
      float xv[4], uv[4];
      load_quad(x + c * D, d, D, vec, xv);
      load_quad(u + c * D, d, D, vec, uv);
      const float wc = w[c];
      uint32_t m[4] = {0u, 0u, 0u, 0u};
      const bool masked = slot_offset + c < num_slots;
      const size_t base = static_cast<size_t>(r) * count;
      if (NB > 0) {
        if (masked) {
          uint32_t rk0[NB > 0 ? NB : 1], rk1[NB > 0 ? NB : 1],
              rs[NB > 0 ? NB : 1];
#pragma unroll
          for (int j = 0; j < NB; ++j) {
            rk0[j] = pk0[base + j];
            rk1[j] = pk1[base + j];
            rs[j] = sgn[base + j];
          }
          repro_prf::mask_quad_regs<NB>(c2, rk0, rk1, rs, m);
        }
      } else {
        repro_prf::mask_quad_smem(c2, live[r], pk0 + base, pk1 + base,
                                  sgn + base, m);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        acc[k] += repro_prf::stochastic_round(
                      __fmul_rn(__fmul_rn(xv[k], wc), scale), uv[k]) +
                  m[k];
      }
    }
    if (vec && d + 3 < D) {
      *reinterpret_cast<uint4*>(out + d) =
          make_uint4(acc[0], acc[1], acc[2], acc[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (d + k < D) out[d + k] = acc[k];
    }
  }
}

template <int NB>
int launch_prf(const float* x, const float* w, const float* u, uint32_t* out,
               int64_t C, int64_t D, float scale, uint32_t k0, uint32_t k1,
               int slot_offset, int num_slots, int degree,
               const int32_t* table, int table_width, int count, int vec,
               cudaStream_t stream) {
  const size_t per_row = (3 * static_cast<size_t>(count) + 1) * 4;
  const int all_rows = static_cast<size_t>(C) * per_row <= kStageAllBytes;
  const size_t smem = all_rows ? static_cast<size_t>(C) * per_row : per_row;
  auto kernel = prf_accum_kernel<NB>;
  const unsigned grid = repro_prf::occupancy_grid(
      kernel, kQuadThreads, smem, (D + kQuadTile - 1) / kQuadTile);
  kernel<<<grid, kQuadThreads, smem, stream>>>(
      x, w, u, out, C, D, scale, k0, k1, slot_offset, num_slots, degree,
      table, table_width, count, all_rows, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mode: 0 plain, 1 explicit masks, 2 PRF session masks; vec (mode 2): the
// rows of x and u and out are 16-byte aligned.  Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int weighted_quantize_accum_launch(
    const float* x, const float* w, const float* u, const int32_t* masks,
    uint32_t* out, int64_t C, int64_t D, float scale, int32_t mode,
    uint32_t k0, uint32_t k1, int32_t slot_offset, int32_t num_slots,
    int32_t degree, const int32_t* table, int32_t table_width, int32_t vec,
    void* stream) {
  if (D <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kPrfMasks) {
    const int count = repro_prf::neighbor_count(num_slots, degree,
                                                table_width, table != nullptr);
    // the main path: an 8-slot complete graph, 7 live neighbours a row
    if (table == nullptr && count == 8 && num_slots == 8) {
      return launch_prf<7>(x, w, u, out, C, D, scale, k0, k1, slot_offset,
                           num_slots, degree, table, table_width, count, vec,
                           s);
    }
    return launch_prf<0>(x, w, u, out, C, D, scale, k0, k1, slot_offset,
                         num_slots, degree, table, table_width, count, vec, s);
  }
  const int64_t blocks = (D + kTile - 1) / kTile;
  const unsigned g = static_cast<unsigned>(blocks);
  if (mode == kPlain) {
    weighted_quantize_accum_kernel<kPlain><<<g, kThreads, 0, s>>>(
        x, w, u, masks, out, C, D, scale);
  } else if (mode == kExplicitMasks) {
    weighted_quantize_accum_kernel<kExplicitMasks><<<g, kThreads, 0, s>>>(
        x, w, u, masks, out, C, D, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
