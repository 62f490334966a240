// Counter-mode `squares` PRF (Widynski 2020) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/prf_mask.py:prf_mask (_squares_kernel), the
// Pallas kernel behind repro.kernels.ops.lambda_masks.
//
// Word i of a stream is squares(key, i): 4 rounds of x*x + (y|z) with a
// 32-bit rotate, then t ^ ((x*x + y) >> 32), all mod 2^64 with logical
// right shifts.  For ell = 32 the kernel keeps the low 32 bits of each
// word, shifted in 32 bits.
//
// One launch (prf_mask_group_u64 / _u32) draws every stream of one of the
// protocols' draw groups, up to kMaxStreams.  Each stream is given by its
// subset key (the two uint32 words of a threefry2x32 key), its protocol
// counter, its length, its offset in the output, a logical right shift (0,
// or ell - bits for a bounded draw) and the index of its first tile.  The
// descriptors travel by value as one kernel parameter: no host-to-device
// copy precedes the launch.  The kernel derives each stream's squares key
// itself -- threefry2x32 (20 rounds) of (0, counter) under the subset key,
// as jax.random.fold_in does, then ((hi << 32 | lo) ^ 0x9E3779B97F4A7C15)
// | 1 -- so keys never come from the host.
//
// Design:
//   * Tiles.  A stream is cut into tiles of kTileWords words laid on the
//     output's 16-byte grid: its first tile starts `head` words before the
//     stream, at a 16-byte boundary.  Each lane computes kLaneWords words of
//     a tile as 16-byte chunks, chunk c of the 32 lanes being 512 contiguous
//     bytes: a chunk wholly inside the stream is one 16-byte store, and only
//     a stream's ragged head and tail take masked scalar stores.
//   * A persistent grid of at most one wave (the SMs times the blocks an SM
//     holds).  The streams' tiles are numbered one after another; warp w
//     takes the `per` tiles from w * per on (per = 1 up to a wave of warps),
//     so a warp mostly stays in one stream; the launcher sets per, so no
//     thread divides.
//   * Keys in registers.  A warp finds its first tile's stream by a binary
//     search over the descriptors' first tiles and steps forward from there;
//     it derives a stream's key (all lanes alike) when it enters the stream.
//     No shared memory and no barrier.
//   * Sizes: 4 words a lane and 128-thread blocks, so the main path's
//     largest group (3 x 100,352 words, 2,352 tiles) spreads over the 132
//     SMs in 588 small blocks rather than a few large ones a SM.  The
//     squares are plain 64-bit products: nvcc already shares lo * hi
//     between the two cross terms (the identity x^2 = lo^2 + (lo hi << 33)
//     written out compiled to more instructions, not fewer).
//
// Bound on the H100: bytes.  A word is 8 (or 4) bytes written against 26
// integer instructions (chip_smoke.py counts those of one word in the SASS
// of squares_probe below), under the byte time at the card's INT32 rate.
// The key derivation (about 70 dependent instructions) is paid once a
// stream a warp, not once a word.  What stays above the bound is latency:
// a near-empty launch of this kernel (one 128-word draw) reads about
// 1.4 us, and the largest group about that plus its bytes at 2.7 TB/s.
#include <cstdint>
#include <atomic>
#include <cuda_runtime.h>

// The descriptors of one grouped draw (outside the anonymous namespace:
// the C entry points take them).
constexpr int kMaxStreams = 120;

struct PrfStream {
  uint32_t key0, key1;   // subset key (threefry2x32 key words)
  uint32_t counter;      // protocol counter (fold_in data)
  uint32_t shift;        // logical right shift of each word
  int64_t offset;        // first word in the output
  uint32_t n;            // words of the stream
  uint32_t first_tile;   // its first tile in the group's tile order
};
static_assert(sizeof(PrfStream) == 32, "PrfStream is 32 bytes");

struct PrfGroup {
  int32_t count;         // streams
  uint32_t misalign;     // words from a 16-byte boundary to out[0]
  uint32_t tiles;        // tiles of all streams
  uint32_t per;          // tiles a warp (set by the launcher)
  PrfStream s[kMaxStreams];
};
// the kernel parameter space holds 4 KB
static_assert(sizeof(PrfGroup) + 8 <= 4096,
              "the descriptors fit the kernel parameters");

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kLaneWords = 4;
constexpr int kTileWords = 32 * kLaneWords;

__device__ __forceinline__ uint64_t rot32(uint64_t v) {
  return (v >> 32) | (v << 32);
}

}  // namespace

// squares(key, ctr) for a counter below 2^32 (every stream is shorter)
__device__ __forceinline__ uint64_t squares(uint64_t key, uint32_t ctr) {
  uint64_t x = static_cast<uint64_t>(ctr) * key;
  const uint64_t y = x;
  const uint64_t z = y + key;
  x = rot32(x * x + y);
  x = rot32(x * x + z);
  x = rot32(x * x + y);
  const uint64_t t = x * x + z;
  x = rot32(t);
  return t ^ ((x * x + y) >> 32);
}

// Never launched: its SASS is one squares() word of a thread's own counter
// (vector, not uniform, instructions, as in the kernel), which
// chip_smoke.py counts (cuobjdump -sass) for the compute side of the
// kernel's bound.
extern "C" __global__ void squares_probe(uint64_t* out, uint64_t key,
                                         uint32_t ctr) {
  *out = squares(key, ctr + threadIdx.x);
}

namespace {

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

// 16 bytes of words, stored at once
template <typename W>
__device__ __forceinline__ void store16(W* p, const W* w);

template <>
__device__ __forceinline__ void store16<uint64_t>(uint64_t* p,
                                                  const uint64_t* w) {
  *reinterpret_cast<ulonglong2*>(p) = make_ulonglong2(w[0], w[1]);
}

template <>
__device__ __forceinline__ void store16<uint32_t>(uint32_t* p,
                                                  const uint32_t* w) {
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
    squares_group_kernel(W* __restrict__ out,
                         const __grid_constant__ PrfGroup g) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(W));
  constexpr int kChunks = kLaneWords / kVec;
  const uint32_t warp = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = static_cast<int>(threadIdx.x % 32);
  uint32_t t = warp * g.per;
  const uint32_t end = min(t + g.per, g.tiles);
  if (t >= end) return;
  // the stream of tile t: the last whose first tile is at or before it
  int s = 0;
  for (int hi = g.count - 1; s < hi;) {
    const int mid = (s + hi + 1) / 2;
    if (g.s[mid].first_tile <= t)
      s = mid;
    else
      hi = mid - 1;
  }
  int keyed = -1;
  uint64_t key = 0;
  for (; t < end; ++t) {
    while (s + 1 < g.count && g.s[s + 1].first_tile <= t) ++s;
    const PrfStream& st = g.s[s];
    if (s != keyed) {
      key = (fold_in(st.key0, st.key1, st.counter) ^ 0x9E3779B97F4A7C15ull) |
            1ull;
      keyed = s;
    }
    const int64_t n = st.n;
    const int64_t head = (g.misalign + st.offset) & (kVec - 1);
    // slot j of the tile is word j - head of the stream
    const int64_t slot0 =
        static_cast<int64_t>(t - st.first_tile) * kTileWords + lane * kVec;
    W w[kLaneWords];
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        w[c * kVec + e] = static_cast<W>(squares(
            key, static_cast<uint32_t>(slot0 + c * 32 * kVec + e - head)));
    if (st.shift != 0) {
#pragma unroll
      for (int k = 0; k < kLaneWords; ++k) w[k] >>= st.shift;
    }
    W* stream_out = out + st.offset;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int64_t i = slot0 + c * 32 * kVec - head;   // the chunk's word 0
      if (i >= 0 && i + kVec <= n) {
        store16(stream_out + i, w + c * kVec);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          if (i + e >= 0 && i + e < n) stream_out[i + e] = w[c * kVec + e];
      }
    }
  }
}

// one wave of the kernel on the current device: SMs x resident blocks
template <typename W>
int wave_blocks() {
  static std::atomic<int> cached[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  std::atomic<int>& slot = cached[dev & 63];
  int wave = slot.load(std::memory_order_relaxed);
  if (wave == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, squares_group_kernel<W>, kThreads, 0) != cudaSuccess)
      return 0;
    wave = sms * (per_sm > 0 ? per_sm : 1);
    slot.store(wave, std::memory_order_relaxed);
  }
  return wave;
}

template <typename W>
int launch_group(void* out, const PrfGroup* table, void* stream) {
  if (table->count < 1 || table->count > kMaxStreams || table->tiles == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int wave = wave_blocks<W>();
  if (wave == 0) return static_cast<int>(cudaGetLastError());
  PrfGroup g = *table;
  const int64_t want = (static_cast<int64_t>(g.tiles) + kWarps - 1) / kWarps;
  const int blocks = static_cast<int>(want < wave ? want : wave);
  const int64_t warps = static_cast<int64_t>(blocks) * kWarps;
  g.per = static_cast<uint32_t>((g.tiles + warps - 1) / warps);
  squares_group_kernel<W><<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<W*>(out), g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `g`: the address of a PrfGroup whose first count streams are filled,
// laid out in order (offset[j] = offset[j-1] + n[j-1]) with their first
// tiles counted on the 16-byte grid of `out` (see the design above); its
// `per` is set here.
extern "C" int prf_mask_group_u64(void* out, const void* g, void* stream) {
  return launch_group<uint64_t>(out, static_cast<const PrfGroup*>(g),
                                stream);
}

extern "C" int prf_mask_group_u32(void* out, const void* g, void* stream) {
  return launch_group<uint32_t>(out, static_cast<const PrfGroup*>(g),
                                stream);
}
