// Counter-mode `squares` PRF (Widynski 2020) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/prf_mask.py:prf_mask (_squares_kernel), the
// Pallas kernel behind repro.kernels.ops.lambda_masks.
//
// Word i of a stream is squares(key, i): 4 rounds of x*x + (y|z) with a
// 32-bit rotate, then t ^ ((x*x + y) >> 32), all in uint64_t so every
// product wraps mod 2^64 and every right shift is logical.  One thread per
// output word, the ragged tail masked (the TPU kernel padded to its
// 512-word block).
//
// One launch (prf_mask_group_u64 / _u32) draws up to kMaxStreams of the
// protocols' streams.  Each stream is given by its subset key (the two
// uint32 words of a threefry2x32 key), its protocol counter, its length,
// its offset in the output and a logical right shift (0, or ell - bits for
// a bounded draw).  The kernel derives the stream's squares key itself --
// threefry2x32 (20 rounds) of (0, counter) under the subset key, as
// jax.random.fold_in does, then ((hi << 32 | lo) ^ 0x9E3779B97F4A7C15) | 1
// -- so the host runs no key schedule.  The descriptors travel by value as
// one kernel parameter: no host-to-device copy precedes the launch.  For
// ell = 32 the kernel writes the low 32 bits of each word, shifted in 32
// bits.
//
// Bound on the H100: bytes.  Each word is 8 (or 4) bytes written against
// ~5 64-bit multiplies (and, per block, one 20-round threefry block per
// stream): far under the compute the card has per byte.  At the main path's sizes (at
// most 100,352 words a stream) one launch costs more than its work, so the
// protocols draw each round's streams -- lambda_z for j = 1, 2, 3, the
// zero shares, a vSh's three lambdas -- in one launch.
#include <cstdint>
#include <cuda_runtime.h>

// The descriptors of one grouped draw (outside the anonymous namespace:
// the C entry points take them).
constexpr int kMaxStreams = 8;

struct PrfStream {
  uint32_t key0, key1;   // subset key (threefry2x32 key words)
  uint32_t counter;      // protocol counter (fold_in data)
  uint32_t shift;        // logical right shift of each word
  int64_t offset;        // first word in the output
  int64_t n;             // words of the stream
};

struct PrfGroup {
  int32_t count;
  int32_t pad;
  PrfStream s[kMaxStreams];
};

namespace {

__device__ __forceinline__ uint64_t rot32(uint64_t v) {
  return (v >> 32) | (v << 32);
}

__device__ __forceinline__ uint64_t squares(uint64_t key, uint64_t ctr) {
  uint64_t x = ctr * key;
  uint64_t y = x;
  uint64_t z = y + key;
  x = rot32(x * x + y);
  x = rot32(x * x + z);
  x = rot32(x * x + y);
  x = x * x + z;
  uint64_t t = x;
  x = rot32(x);
  return t ^ ((x * x + y) >> 32);
}

__device__ __forceinline__ uint32_t rotl32(uint32_t v, int r) {
  return (v << r) | (v >> (32 - r));
}

// threefry2x32, 20 rounds, of the counter pair (0, data) under (k0, k1):
// jax.random.fold_in's block function.  Returns (x0 << 32) | x1.
__device__ __forceinline__ uint64_t fold_in(uint32_t k0, uint32_t k1,
                                            uint32_t data) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t x0 = ks[0];
  uint32_t x1 = data + ks[1];
#pragma unroll
  for (int step = 0; step < 5; ++step) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x0 += x1;
      x1 = rotl32(x1, rot[step % 2][i]) ^ x0;
    }
    x0 += ks[(step + 1) % 3];
    x1 += ks[(step + 2) % 3] + static_cast<uint32_t>(step + 1);
  }
  return (static_cast<uint64_t>(x0) << 32) | x1;
}

// The first threads of each block derive the group's squares keys into
// shared memory (one threefry block per stream, not per word); then one
// thread per output word finds its stream among the offsets.
template <typename W>
__global__ void squares_group_kernel(W* __restrict__ out, const PrfGroup g,
                                     int64_t total) {
  __shared__ uint64_t keys[kMaxStreams];
  if (threadIdx.x < g.count) {
    const PrfStream& st = g.s[threadIdx.x];
    keys[threadIdx.x] = (fold_in(st.key0, st.key1, st.counter) ^
                         0x9E3779B97F4A7C15ull) | 1ull;
  }
  __syncthreads();
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  int s = 0;
#pragma unroll
  for (int j = 1; j < kMaxStreams; ++j)
    if (j < g.count && i >= g.s[j].offset) s = j;
  const W w = static_cast<W>(
      squares(keys[s], static_cast<uint64_t>(i - g.s[s].offset)));
  out[i] = w >> g.s[s].shift;
}

template <typename W>
int launch_group(void* out, const PrfGroup* g, void* stream) {
  if (g->count < 1 || g->count > kMaxStreams)
    return static_cast<int>(cudaErrorInvalidValue);
  const PrfStream& last = g->s[g->count - 1];
  const int64_t total = last.offset + last.n;
  if (total <= 0) return 0;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  squares_group_kernel<W><<<static_cast<unsigned>(blocks), threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<W*>(out), *g, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Streams are laid out in order: offset[j] = offset[j-1] + n[j-1].
extern "C" int prf_mask_group_u64(void* out, const PrfGroup* g,
                                  void* stream) {
  return launch_group<uint64_t>(out, g, stream);
}

extern "C" int prf_mask_group_u32(void* out, const PrfGroup* g,
                                  void* stream) {
  return launch_group<uint32_t>(out, g, stream);
}
