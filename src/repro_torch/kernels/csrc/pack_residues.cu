// The packed wire codec: field residues <-> a dense little-endian stream of
// 32-bit words.  Residue e occupies stream bits [e*bits, (e+1)*bits); word
// k holds stream bits [32k, 32k+32).
//
// Replaces the Pallas kernels repro/kernels/secure_agg.py::pack_residues
// and ::unpack_residues (bodies _pack_residues_kernel,
// _unpack_residues_kernel).
//
// Bound on an H100: memory.  Pack reads 4 bytes and writes bits/8 bytes per
// residue, unpack the reverse, with a few integer operations each.  Design:
// a pure gather in both directions, so no thread writes what another
// writes and no atomics are needed.  Pack runs one thread per OUTPUT word,
// which ORs in the <= ceil(32/bits)+1 residues overlapping its 32 stream
// bits (residues past n count as zero: the ragged tail).  Unpack runs one
// thread per residue, which reads the <= 2 words holding its bits.  Every
// offset is 64-bit (a 233M-residue stream spans 7e9 bits); the words are
// handled as uint32_t over the int32 tensors' bytes.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 64;

__device__ __forceinline__ uint32_t low_mask(int bits) {
  return bits >= 32 ? 0xFFFFFFFFu : ((1u << bits) - 1u);
}

__global__ void pack_residues_kernel(const uint32_t* __restrict__ q,
                                     uint32_t* __restrict__ out, int64_t n,
                                     int64_t nwords, int bits) {
  const uint32_t mask = low_mask(bits);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       k < nwords; k += stride) {
    const int64_t b0 = k * 32;
    int64_t last = (b0 + 31) / bits;
    if (last > n - 1) last = n - 1;
    uint32_t w = 0u;
    for (int64_t e = b0 / bits; e <= last; ++e) {
      const uint64_t v = q[e] & mask;
      // the residue starts at bit pos of the word, pos in (-bits, 32):
      // shift it into the high half of 64 bits, keep the word's 32
      const int pos = static_cast<int>(e * bits - b0);
      w |= static_cast<uint32_t>((v << (pos + 32)) >> 32);
    }
    out[k] = w;
  }
}

__global__ void unpack_residues_kernel(const uint32_t* __restrict__ words,
                                       uint32_t* __restrict__ out, int64_t n,
                                       int bits) {
  const uint32_t mask = low_mask(bits);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < n; e += stride) {
    const int64_t s = e * bits;
    const int64_t w0 = s >> 5;
    const int sh = static_cast<int>(s & 31);
    uint64_t v = words[w0];
    if (sh + bits > 32) v |= static_cast<uint64_t>(words[w0 + 1]) << 32;
    out[e] = static_cast<uint32_t>(v >> sh) & mask;
  }
}

unsigned grid_for(int64_t items) {
  int64_t blocks = (items + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return static_cast<unsigned>(blocks);
}

}  // namespace

// q: (n,) residues; out: (nwords,) with nwords = ceil(n * bits / 32).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int pack_residues_launch(const uint32_t* q, uint32_t* out,
                                    int64_t n, int64_t nwords, int32_t bits,
                                    void* stream) {
  if (bits < 1 || bits > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (nwords <= 0) return 0;
  pack_residues_kernel<<<grid_for(nwords), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(q, out, n,
                                                              nwords, bits);
  return static_cast<int>(cudaGetLastError());
}

// words: (ceil(n * bits / 32),); out: (n,) residues.
extern "C" int unpack_residues_launch(const uint32_t* words, uint32_t* out,
                                      int64_t n, int32_t bits, void* stream) {
  if (bits < 1 || bits > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  unpack_residues_kernel<<<grid_for(n), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(words, out, n,
                                                                bits);
  return static_cast<int>(cudaGetLastError());
}
