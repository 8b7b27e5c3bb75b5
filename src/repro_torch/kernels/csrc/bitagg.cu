// K9 bit_counts: the federated-analytics threshold vote with randomized
// response, summed over devices:
//
//   counts[f,t] = sum_n ( [u[n,f,t] < p/2] + [u[n,f,t] >= p] * [v[n,f] <= thr[t]] )
//
//   values (N, F) f32, thresholds (T,) f32, uniforms (N, F, T) f32
//   -> counts (F, T) f32
//
// Replaces the Pallas kernel repro/kernels/bitagg.py::bit_counts.  The
// caller passes p/2 and p already rounded to f32 (the Pallas kernel's
// weak-typed compares round them so).
//
// Bound on an H100: bytes.  Each vote reads one 4-byte uniform and does
// about six integer and compare operations (1.5 per byte, far below the
// card's ~20 operations per byte of bandwidth); the values are F/(F*T) of
// the bytes.  Design: the TPU kernel carried the count tile across a
// sequential device-axis grid in VMEM, with 128 x 8 blocks.  Here a thread
// owns one column c = f*T + t and walks a stripe of devices, so the 32
// threads of a warp read 32 neighbouring uniforms of one device row
// (coalesced, streamed past L1 with __ldcs), eight rows per loop trip so
// that eight loads are in flight per thread.  The grid is (F*T / 256
// column tiles) x (device-axis splits); each thread counts in a uint32
// register and adds its count to the (F, T) uint32 buffer with one
// atomicAdd; a second kernel converts the buffer to f32.  Integer adds do
// not depend on their order, so the result is the same on every run and
// equals the plain PyTorch version (and the Pallas kernel) bit for bit
// while N < 2^24, where f32 holds every count.  NaN values vote 0 at every
// threshold (`v <= thr` is false), as in the reference.  Offsets are
// int64_t: N*F*T passes 2^32 at a fleet query.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

__device__ __forceinline__ uint32_t vote(float v, float thr, float u,
                                         float p_half, float p) {
  return static_cast<uint32_t>(u < p_half) +
         (static_cast<uint32_t>(u >= p) & static_cast<uint32_t>(v <= thr));
}

__global__ void bit_counts_kernel(const float* __restrict__ values,
                                  const float* __restrict__ thresholds,
                                  const float* __restrict__ u,
                                  uint32_t* __restrict__ counts, int64_t N,
                                  int64_t F, int64_t T, int64_t rows,
                                  float p_half, float p) {
  const int64_t FT = F * T;
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= FT) return;
  const int64_t f = c / T;
  const float thr = thresholds[c - f * T];
  const int64_t n0 = static_cast<int64_t>(blockIdx.y) * rows;
  const int64_t n1 = (n0 + rows < N) ? (n0 + rows) : N;
  const float* up = u + n0 * FT + c;
  const float* vp = values + n0 * F + f;
  uint32_t count = 0;
  int64_t n = n0;
  for (; n + kUnroll <= n1; n += kUnroll) {
    float uu[kUnroll], vv[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      uu[k] = __ldcs(up + k * FT);
      vv[k] = __ldg(vp + k * F);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) count += vote(vv[k], thr, uu[k], p_half, p);
    up += kUnroll * FT;
    vp += kUnroll * F;
  }
  for (; n < n1; ++n) {
    count += vote(__ldg(vp), thr, __ldcs(up), p_half, p);
    up += FT;
    vp += F;
  }
  if (count != 0) atomicAdd(counts + c, count);
}

__global__ void counts_to_float_kernel(const uint32_t* __restrict__ counts,
                                       float* __restrict__ out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n) out[i] = __uint2float_rn(counts[i]);
}

}  // namespace

// counts: (F, T) uint32 scratch; out: (F, T) f32.  `splits` device-axis
// splits of `rows` devices each (splits * rows >= N, splits <= 65535).
extern "C" int bit_counts_launch(const float* values, const float* thresholds,
                                 const float* u, uint32_t* counts, float* out,
                                 int64_t N, int64_t F, int64_t T, int32_t splits,
                                 int64_t rows, float p_half, float p,
                                 void* stream) {
  const int64_t FT = F * T;
  if (FT <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counts, 0, FT * sizeof(uint32_t), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned col_blocks = static_cast<unsigned>((FT + kThreads - 1) / kThreads);
  if (N > 0 && splits > 0) {
    const dim3 grid(col_blocks, static_cast<unsigned>(splits));
    bit_counts_kernel<<<grid, kThreads, 0, st>>>(values, thresholds, u, counts,
                                                 N, F, T, rows, p_half, p);
  }
  counts_to_float_kernel<<<col_blocks, kThreads, 0, st>>>(counts, out, FT);
  return static_cast<int>(cudaGetLastError());
}
