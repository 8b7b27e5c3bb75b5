// The signed sum of pair streams of repro_torch/kernels/prf.py
// (signed_pair_sum) in one pass:
//
//   out[e] = (out[e] +) sum over the pairs p of gain[p] * word(pk(p), e)
//            mod 2^32,   pk(p) = threefry(session_key, (lo[p], hi[p]))
//
// for every element e of [0, length), word(pk, e) being
// threefry(pk, (e >> 1, TAG_MASK))[e & 1] at 13 rounds, as prf.words
// defines it.  It is the core of every mask on the card: a slot's session
// mask (gains +1 / -1 by the side of the pair) and the dropout-recovery
// sweep (gains present[hi] - present[lo], times an edge weight), summed
// into a fresh row or added into an existing one in place.
//
// Replaces no Pallas kernel: on the TPU, XLA generated the reference's
// recovery sweep (repro/core/fl/secure_agg.py recovery_sweep) from jnp ops.
// On the card the plain version is prf's host tile loop: one batch of ~150
// int64 torch launches for every ~4M words, 79 batches for a whisper-tiny
// recovery.
//
// Bound on an H100: the Threefry's integer instructions (about 45 an
// evaluation in SASS, tools/threefry_sass.py), one evaluation a counter and
// pair, two words an evaluation; each element is written once (and read
// once, where the words are added into a row).  Design:
//  - the pairs' keys are derived on the card from the session key and the
//    (lo, hi) slot ids, kStage pairs at a time, staged once a block in
//    shared memory with the gains as uint32 multipliers (mod 2^32), as K1
//    stages its neighbours; more pairs than a stage loop over stages inside
//    the launch, each stage adding into the row the previous one wrote (a
//    thread owns the same elements in every stage, so no block waits on
//    another);
//  - a thread owns element quads 4g .. 4g + 3, the counters 2g and 2g + 1,
//    and evaluates each pair's stream once a counter, both words used; the
//    two counters' round chains interleave (prf.cuh mask_quad_smem);
//  - 16-byte loads and stores where the row is 16-byte aligned; a ragged
//    tail, or a row that is not aligned, goes a counter (two words) at a
//    time;
//  - a grid of as many blocks as stay resident (occupancy), striding over
//    the quads.
// Exact: every product and sum wraps in uint32_t, in any order, so the
// result is the plain version's bit for bit.
#include <cuda_runtime.h>

#include <cstdint>

#include "prf.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStage = 256;  // pairs staged in shared memory at a time

// table: int32 (3, npairs) on the device: the pairs' lo slots, hi slots
// and gains (the gains' bits as uint32).
__global__ void __launch_bounds__(kThreads)
    pair_sum_kernel(uint32_t k0, uint32_t k1,
                    const int32_t* __restrict__ table, int npairs,
                    int64_t length, uint32_t* __restrict__ out,
                    bool accumulate, bool vec) {
  __shared__ uint32_t pk0[kStage], pk1[kStage], gain[kStage];
  const int64_t first =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t quads = vec ? (length >> 2) : 0;
  const int64_t counters = (length + 1) >> 1;
  for (int p0 = 0; p0 < npairs; p0 += kStage) {
    const int n = min(kStage, npairs - p0);
    __syncthreads();  // every thread is done with the previous stage's keys
    for (int j = threadIdx.x; j < n; j += kThreads) {
      uint32_t x0 = static_cast<uint32_t>(table[p0 + j]);
      uint32_t x1 = static_cast<uint32_t>(table[npairs + p0 + j]);
      repro_prf::threefry2x32(k0, k1, x0, x1);
      pk0[j] = x0;
      pk1[j] = x1;
      gain[j] = static_cast<uint32_t>(table[2 * npairs + p0 + j]);
    }
    __syncthreads();
    const bool read = accumulate || p0 > 0;
    for (int64_t g = first; g < quads; g += stride) {
      uint32_t m[4] = {0u, 0u, 0u, 0u};
      if (read) {
        const uint4 v = reinterpret_cast<const uint4*>(out)[g];
        m[0] = v.x;
        m[1] = v.y;
        m[2] = v.z;
        m[3] = v.w;
      }
      repro_prf::mask_quad_smem(static_cast<uint32_t>(2 * g), n, pk0, pk1,
                                gain, m);
      reinterpret_cast<uint4*>(out)[g] = make_uint4(m[0], m[1], m[2], m[3]);
    }
    for (int64_t c = 2 * quads + first; c < counters; c += stride) {
      const int64_t e = 2 * c;
      const bool two = e + 1 < length;
      uint32_t a = read ? out[e] : 0u;
      uint32_t b = (read && two) ? out[e + 1] : 0u;
      for (int j = 0; j < n; ++j) {
        const uint2 w = repro_prf::stream_pair_at(
            pk0[j], pk1[j], static_cast<uint32_t>(c), repro_prf::kTagMask);
        a += w.x * gain[j];
        b += w.y * gain[j];
      }
      out[e] = a;
      if (two) out[e + 1] = b;
    }
  }
}

}  // namespace

// k0, k1: the session key; table: int32 (3, npairs) on the device (lo, hi,
// gain); out: length int32 on the device, written (accumulate 0) or added
// into (accumulate 1).  Returns cudaGetLastError() after the launch (0 =
// launched); length <= 0 or npairs <= 0 launches nothing (the caller
// writes a zero row itself).
extern "C" int pair_sum_launch(uint32_t k0, uint32_t k1, const void* table,
                               int32_t npairs, int64_t length, void* out,
                               int32_t accumulate, void* stream) {
  if (length <= 0 || npairs <= 0) return 0;
  const bool vec = (reinterpret_cast<uint64_t>(out) & 15u) == 0;
  const int64_t work = vec && length >= 4 ? length >> 2 : (length + 1) >> 1;
  const unsigned grid = repro_prf::occupancy_grid(
      pair_sum_kernel, kThreads, 0, (work + kThreads - 1) / kThreads);
  pair_sum_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      k0, k1, static_cast<const int32_t*>(table), npairs, length,
      static_cast<uint32_t*>(out), accumulate != 0, vec);
  return static_cast<int>(cudaGetLastError());
}
