// Grouped elementwise gamma-piece / online-part kernel for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/gamma_parts.py:mult_terms (_mult_terms_kernel)
// and :and_terms (_and_terms_kernel), both launched through _grouped_call.
//
// One launch evaluates up to kMaxGroups groups, in one of two modes:
//
//   ring (mult_terms):  out = c_0 + c_1 + sum_t s_t * a_t * b_t  mod 2^ell
//   XOR  (and_terms):   out = c_0 ^ c_1 ^ XOR_t (a_t & b_t)
//
// A group has 1..kMaxTerms term pairs (a_t, b_t), a sign mask (bit t set =
// subtract term t; ring mode only), 0..kMaxConsts constant operands, n words
// and an output pointer.  Every operand is given by pointer: n contiguous
// words, or one word broadcast over all n (its bit in `bcast` set).  So the
// kernel reads each party's lambda, m, gamma and mask words where they lie,
// and the host builds no staging stack and runs no combine after the
// launch.  This is the runtime's batching: all parties' groups of one
// protocol round (P0's three gamma pieces and the three GAMMA_LOCAL pieces
// offline; the six online parts and three m_x op m_y products online) are
// one launch.  Words are uint64_t or uint32_t, so the ring arithmetic wraps
// by the type.
//
// The descriptor table travels by value as one __grid_constant__ kernel
// parameter (no host-to-device copy precedes the launch).  The launcher
// gives each group ceil(n / tile) blocks and records the prefix of those
// counts in the table; a block finds its group by scanning the prefix.
// Each thread handles one 16-byte vector of words (two uint64_t, four
// uint32_t): where the output and every streamed operand of a group are
// 16-byte aligned it loads and stores them as one 16-byte access each, and
// it takes a word-by-word path otherwise (views at odd offsets) and for a
// ragged tail.
//
// Bound on the H100: bytes (each operand word read once and each output word
// written once against at most 2 T + 2 integer operations).  At the main
// path's sizes -- groups of 128 x 128 words for BitExt's mult, 128 x 1 for
// an AND of smx's adder -- a round is a few MB at most, or a launch's fixed
// cost for the ANDs; grouping a round into one launch is what the design
// does about that.
#include <cstdint>
#include <cuda_runtime.h>

// The descriptors of one launch (outside the anonymous namespace: the C
// entry points take them).
constexpr int kMaxGroups = 16;
constexpr int kMaxTerms = 3;
constexpr int kMaxConsts = 2;

struct TermGroup {
  const void* a[kMaxTerms];
  const void* b[kMaxTerms];
  const void* c[kMaxConsts];
  void* out;
  int64_t n;           // words of the group
  int32_t first_tile;  // first block of the group (set by the launcher)
  int32_t terms;       // term pairs, 1..kMaxTerms
  int32_t consts;      // constant operands, 0..kMaxConsts
  uint32_t neg;        // bit t: subtract term t (ring mode)
  uint32_t bcast;      // bit t: a[t] is one word; bit 3 + t: b[t];
                       // bit 6 + k: c[k]
  uint32_t vec;        // 1: out and every streamed operand 16-byte aligned
};

struct TermLaunch {
  int32_t count;       // groups, 1..kMaxGroups
  int32_t tiles;       // blocks of the launch (set by the launcher)
  TermGroup g[kMaxGroups];
};

static_assert(sizeof(TermGroup) == 104, "TermGroup layout (ctypes mirror)");
static_assert(sizeof(TermLaunch) == 8 + kMaxGroups * 104,
              "TermLaunch layout (ctypes mirror)");

namespace {

constexpr int kThreads = 256;

// K words of operand `p` from word i: one broadcast word, one 16-byte load
// (kVec) or K word loads.
template <typename W, int K, bool kVec>
__device__ __forceinline__ void load_words(const void* p, bool one,
                                           int64_t i, W (&v)[K]) {
  const W* q = static_cast<const W*>(p);
  if (one) {
    const W s = *q;
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = s;
  } else if (kVec) {
    union { uint4 u; W w[K]; } x;
    x.u = __ldg(reinterpret_cast<const uint4*>(q + i));
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = x.w[k];
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = q[i + k];
  }
}

// Words i .. i + K - 1 of group G.
template <typename W, bool kXor, int K, bool kVec>
__device__ __forceinline__ void group_words(const TermGroup& G, int64_t i) {
  W acc[K], x[K], y[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0;
#pragma unroll
  for (int c = 0; c < kMaxConsts; ++c) {
    if (c < G.consts) {
      load_words<W, K, kVec>(G.c[c], (G.bcast >> (6 + c)) & 1u, i, x);
#pragma unroll
      for (int k = 0; k < K; ++k)
        acc[k] = kXor ? acc[k] ^ x[k] : acc[k] + x[k];
    }
  }
#pragma unroll
  for (int t = 0; t < kMaxTerms; ++t) {
    if (t < G.terms) {
      load_words<W, K, kVec>(G.a[t], (G.bcast >> t) & 1u, i, x);
      load_words<W, K, kVec>(G.b[t], (G.bcast >> (3 + t)) & 1u, i, y);
      const bool neg = (G.neg >> t) & 1u;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (kXor) {
          acc[k] ^= x[k] & y[k];
        } else {
          const W term = x[k] * y[k];
          acc[k] = neg ? acc[k] - term : acc[k] + term;
        }
      }
    }
  }
  W* out = static_cast<W*>(G.out);
  if (kVec) {
    union { uint4 u; W w[K]; } o;
#pragma unroll
    for (int k = 0; k < K; ++k) o.w[k] = acc[k];
    *reinterpret_cast<uint4*>(out + i) = o.u;
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) out[i + k] = acc[k];
  }
}

template <typename W, bool kXor>
__global__ void __launch_bounds__(kThreads)
terms_group_kernel(const __grid_constant__ TermLaunch L) {
  constexpr int V = 16 / sizeof(W);            // words per 16-byte vector
  int gi = 0;
#pragma unroll
  for (int j = 1; j < kMaxGroups; ++j)
    if (j < L.count && static_cast<int>(blockIdx.x) >= L.g[j].first_tile)
      gi = j;
  const TermGroup& G = L.g[gi];
  const int64_t i0 =
      (static_cast<int64_t>(blockIdx.x) - G.first_tile) * (kThreads * V) +
      static_cast<int64_t>(threadIdx.x) * V;
  if (i0 >= G.n) return;
  if (G.vec && i0 + V <= G.n) {
    group_words<W, kXor, V, true>(G, i0);
  } else {
    for (int k = 0; k < V && i0 + k < G.n; ++k)
      group_words<W, kXor, 1, false>(G, i0 + k);
  }
}

template <typename W, bool kXor>
int launch_group(const TermLaunch* in, void* stream) {
  if (in->count < 1 || in->count > kMaxGroups)
    return static_cast<int>(cudaErrorInvalidValue);
  TermLaunch L = *in;
  constexpr int64_t tile = kThreads * (16 / sizeof(W));
  int64_t tiles = 0;
  for (int j = 0; j < L.count; ++j) {
    TermGroup& g = L.g[j];
    if (g.n <= 0 || g.terms < 1 || g.terms > kMaxTerms || g.consts < 0 ||
        g.consts > kMaxConsts)
      return static_cast<int>(cudaErrorInvalidValue);
    g.first_tile = static_cast<int32_t>(tiles);
    tiles += (g.n + tile - 1) / tile;
    if (tiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  }
  L.tiles = static_cast<int32_t>(tiles);
  terms_group_kernel<W, kXor><<<static_cast<unsigned>(tiles), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mult_terms_group_u64(const TermLaunch* L, void* stream) {
  return launch_group<uint64_t, false>(L, stream);
}

extern "C" int mult_terms_group_u32(const TermLaunch* L, void* stream) {
  return launch_group<uint32_t, false>(L, stream);
}

extern "C" int and_terms_group_u64(const TermLaunch* L, void* stream) {
  return launch_group<uint64_t, true>(L, stream);
}

extern "C" int and_terms_group_u32(const TermLaunch* L, void* stream) {
  return launch_group<uint32_t, true>(L, stream);
}
