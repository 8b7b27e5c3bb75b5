// The flush's modular row sum of repro_torch/kernels/row_sum.py (sum_rows)
// in one pass:
//
//   out[j] = (acc_in[j] +) sum over the gated rows r of rows[r][j]  mod 2^32
//
// on the int32 words read as uint32 (wraparound is defined on unsigned
// integers; signed overflow is not), up to kMaxRows gated rows a launch.
//
// Replaces no Pallas kernel: on the TPU, XLA fused the reference's int32
// wraparound sum (repro/core/fl/aggregation.py sum_rows) into one pass.  On
// the card the plain version (an int64 accumulator, a mixed int32 + int64
// add a row, then to_int32's int64 passes) moves ~268 bytes an element for
// 10 rows, where one pass moves 44.
//
// Bound on an H100: memory.  Each gated row is read once and the result
// written once: (gated rows + 1) x D x 4 bytes (D x 4 more, read, where
// acc_in carries an earlier launch's group), against one integer add a word
// a row.  Design: a grid-stride loop at full occupancy; each thread owns 16
// bytes of columns and issues one 128-bit load a row, kGroup rows at a
// time, so ~kGroup loads a thread are in flight; the rows are read once, so
// their loads take the streaming cache hint (__ldcs).  TMA buys nothing in a
// pass with no reuse.  The sum is exact mod 2^32 and independent of order,
// so every block and thread layout gives the same bits.
//
// The gate arrives as the gated rows' base pointers, by value in the
// kernel's parameters (RowPtrs): no device read-back, no host-to-device
// copy.  Where every pointer is 16-byte aligned the columns go in uint4
// quads and a ragged D % 4 tail word by word; otherwise (a row stride or a
// base that is not a multiple of 4 words) every column goes word by word.
// Offsets are 64-bit: one chunk of a stacked leaf can pass 2^31 words.
#include <cuda_runtime.h>

#include <cstdint>

#include "prf.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 64;
constexpr int kGroup = 8;

struct RowPtrs {
  const uint32_t* p[kMaxRows];
};

__device__ __forceinline__ void add4(uint4& a, const uint4 v) {
  a.x += v.x;
  a.y += v.y;
  a.z += v.z;
  a.w += v.w;
}

__global__ void __launch_bounds__(kThreads)
    row_sum_kernel(const RowPtrs rows, int nrows, int64_t d,
                   const uint32_t* acc_in, uint32_t* out, bool vec) {
  const int64_t first =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  int64_t done = 0;
  if (vec) {
    const int64_t quads = d >> 2;
    for (int64_t g = first; g < quads; g += stride) {
      uint4 acc = acc_in ? reinterpret_cast<const uint4*>(acc_in)[g]
                         : make_uint4(0u, 0u, 0u, 0u);
      int r = 0;
      for (; r + kGroup <= nrows; r += kGroup) {
        uint4 v[kGroup];
#pragma unroll
        for (int k = 0; k < kGroup; ++k)
          v[k] = __ldcs(reinterpret_cast<const uint4*>(rows.p[r + k]) + g);
#pragma unroll
        for (int k = 0; k < kGroup; ++k) add4(acc, v[k]);
      }
#pragma unroll 4
      for (; r < nrows; ++r)
        add4(acc, __ldcs(reinterpret_cast<const uint4*>(rows.p[r]) + g));
      reinterpret_cast<uint4*>(out)[g] = acc;
    }
    done = quads << 2;
  }
  for (int64_t j = done + first; j < d; j += stride) {
    uint32_t acc = acc_in ? acc_in[j] : 0u;
#pragma unroll 8
    for (int r = 0; r < nrows; ++r) acc += __ldcs(rows.p[r] + j);
    out[j] = acc;
  }
}

}  // namespace

// row_ptrs: nrows device addresses of int32 rows of d words each (host
// array, copied into the launch); acc_in: null, or d int32 to add (may be
// out itself); out: d int32 on the device.  Returns cudaGetLastError() after
// the launch (0 = launched); d <= 0 launches nothing; nrows outside
// [0, kMaxRows] returns -1.  nrows 0 writes acc_in, or zeros.
extern "C" int row_sum_launch(const uint64_t* row_ptrs, int32_t nrows,
                              int64_t d, const void* acc_in, void* out,
                              void* stream) {
  if (d <= 0) return 0;
  if (nrows < 0 || nrows > kMaxRows) return -1;
  RowPtrs rows{};
  uint64_t addr_bits = reinterpret_cast<uint64_t>(acc_in) |
                       reinterpret_cast<uint64_t>(out);
  for (int r = 0; r < nrows; ++r) {
    rows.p[r] = reinterpret_cast<const uint32_t*>(row_ptrs[r]);
    addr_bits |= row_ptrs[r];
  }
  const bool vec = (addr_bits & 15u) == 0;
  const int64_t work = vec && d >= 4 ? d >> 2 : d;
  const unsigned grid = repro_prf::occupancy_grid(
      row_sum_kernel, kThreads, 0, (work + kThreads - 1) / kThreads);
  row_sum_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, nrows, d, static_cast<const uint32_t*>(acc_in),
      static_cast<uint32_t*>(out), vec);
  return static_cast<int>(cudaGetLastError());
}
