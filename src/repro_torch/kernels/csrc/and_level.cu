// Boolean AND levels of the joint simulation, fused, for Hopper (sm_90a):
// one level, the whole Sklansky adder, or the whole prefix-OR chain.
//
// Replaces: src/repro/kernels/ppa_msb.py:43 and_level (_and_level_kernel,
// :21), and through it the per-level work of the Sklansky loops
// (src/repro/kernels/ppa_msb.py:65 ppa_msb, src/repro/core/boolean.py's
// ppa_add and prefix_or), each of whose ANDs is one such level.
//
// One level (Fig. 4 with XOR/AND), on bit-sliced words, for share stacks
// x, y = (m, l1, l2, l3), fresh output lambdas (z1, z2, z3) and Pi_Zero
// shares (s0, s1, s2):
//
//   g1 = l1x&l1y ^ l1x&l2y ^ l2x&l1y ^ s2        (Fig. 4's gamma split)
//   g2 = l2x&l2y ^ l2x&l3y ^ l3x&l2y ^ s0
//   g3 = l3x&l3y ^ l3x&l1y ^ l1x&l3y ^ s1
//   p_i = lix&my ^ mx&liy ^ g_i ^ z_i             (the three m_z' parts)
//   out = (p1 ^ p2 ^ p3 ^ mx&my, z1, z2, z3)
//
// Entries (words uint64_t or uint32_t; stacks (4, n), contiguous):
//   and_level   x, y, lamz (3, n), zero (3, n) or null for zero shares (the
//               component-collapsed joint world, where g1 ^ g2 ^ g3 =
//               lx_sum & ly_sum): one level.
//   ppa_add     [[x + y + cin]] by the Sklansky adder: the first AND
//               g = x & y, then log2(ell) levels of the boundary smears,
//               the upper-half masks and two ANDs, then the sum.
//   prefix_or   [[OR_{j >= i} x_j]] from the msb down: log2(ell) ANDs of
//               NOT cur and NOT (cur >> j), each result inverted.
//   ppa_msb     msb(x + y) of (n,) public words (src/repro/kernels/
//               ppa_msb.py:65): the Sklansky adder on stacks whose lambdas
//               are 0, its log2(ell) + 1 levels of ANDs (the first AND, then
//               two a level sharing that level's draws) each opened as the
//               XOR of its output stack; lamz and zero (log2(ell) + 1, 3,
//               n), the zero shares given as they are.  Output (n,) words of
//               0/1.
// The two chains read their ANDs' draws where the protocol's one group of
// PRF draws put them: (A, S, n) words, AND a's streams S = 6 (z1, z2, z3,
// f1, f2, f3) faithful, S = 3 (z1, z2, z3) collapsed; the kernel forms
// Fig. 4's zero shares (f2 ^ f1, f3 ^ f2, f1 ^ f3) itself.
//
// The split twins, for the joint simulation's offline and online runs, in
// which an AND's gamma is a material the offline run hands out and the
// online run takes in (the fused entries form it inside the launch).  They
// replace no TPU kernel: the JAX package runs those modes' ANDs as jnp code
// AND by AND; here each chain is one launch on the same level math.  Each
// runs a chain of `kind` 0 (one AND: x AND y), 1 (the adder, arg = cin) or
// 2 (the prefix-OR of x, arg = NOT's mask):
//   and_chain_offline  x, y, draws (A, S, n) -> gammas (A, 3, n) and the
//               (4, n) stack the offline run gives: every AND's m word 0
//               and its lambdas (z1, z2, z3); the linear steps act on the
//               operands' m words as they are.  Gamma faithful (S = 6):
//               Fig. 4's split above with the zero shares (g1, g2, g3);
//               collapsed (S = 3): (l1x ^ l2x ^ l3x) & (l1y ^ l2y ^ l3y),
//               0, 0.
//   and_chain_online   x, y, lamz (A, 3, n), gammas (A, 3, n) -> (4, n):
//               each AND p_i = lix&my ^ mx&liy ^ g_i ^ z_i, m_z = p1 ^ p2
//               ^ p3 ^ mx&my (the XOR of the collapsed world's three terms
//               is the same word).
//
// Design: one thread per word.  Every shift, smear and mask of the adder
// works within a word and every AND is bitwise, so a chain is independent
// per word and its levels need no synchronisation: a thread holds both
// stacks in registers through all its ANDs and reads each input plane and
// draw once and writes the output stack once.  A chain loads all its
// draws before its first AND, so the loads' latencies overlap rather than
// add up along the chain's dependent levels.
//
// Bound on the H100: bytes.  A level moves 18 words an element (144 B at
// ell = 64) for about 30 integer operations; the adder 2 x 4 input words,
// 13 x 6 draws and 4 output words (720 B) for about 850; ppa_msb 2 input
// words, 7 x 6 draws and 1 output word (360 B) for about 450.  The split
// adder reads as many words and writes 13 x 3 gammas more (offline), or
// reads 13 x 3 lambdas and 13 x 3 gammas in place of the draws (online).
// At the main path's n = 128 every launch is one near-empty block: launch
// bound.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// A share stack of one word: (m, l1, l2, l3).
template <typename W>
struct Stack {
  W m, l1, l2, l3;
};

template <typename W>
__device__ __forceinline__ Stack<W> load(const W* __restrict__ s, int64_t n,
                                         int64_t i) {
  return {s[i], s[n + i], s[2 * n + i], s[3 * n + i]};
}

template <typename W>
__device__ __forceinline__ void store(W* __restrict__ s, int64_t n,
                                      int64_t i, const Stack<W>& v) {
  s[i] = v.m;
  s[n + i] = v.l1;
  s[2 * n + i] = v.l2;
  s[3 * n + i] = v.l3;
}

template <typename W>
__device__ __forceinline__ Stack<W> operator^(const Stack<W>& a,
                                              const Stack<W>& b) {
  return {a.m ^ b.m, a.l1 ^ b.l1, a.l2 ^ b.l2, a.l3 ^ b.l3};
}

template <typename W>
__device__ __forceinline__ Stack<W> operator&(const Stack<W>& a, W mask) {
  return {a.m & mask, a.l1 & mask, a.l2 & mask, a.l3 & mask};
}

template <typename W>
__device__ __forceinline__ Stack<W> operator<<(const Stack<W>& a, int k) {
  return {a.m << k, a.l1 << k, a.l2 << k, a.l3 << k};
}

template <typename W>
__device__ __forceinline__ Stack<W> operator>>(const Stack<W>& a, int k) {
  return {a.m >> k, a.l1 >> k, a.l2 >> k, a.l3 >> k};
}

// The level: (m_z, z1, z2, z3) of x AND y.
template <typename W>
__device__ __forceinline__ Stack<W> and_level(const Stack<W>& x,
                                              const Stack<W>& y, W z1, W z2,
                                              W z3, W s0, W s1, W s2) {
  const W g1 = (x.l1 & y.l1) ^ (x.l1 & y.l2) ^ (x.l2 & y.l1) ^ s2;
  const W g2 = (x.l2 & y.l2) ^ (x.l2 & y.l3) ^ (x.l3 & y.l2) ^ s0;
  const W g3 = (x.l3 & y.l3) ^ (x.l3 & y.l1) ^ (x.l1 & y.l3) ^ s1;
  const W p1 = (x.l1 & y.m) ^ (x.m & y.l1) ^ g1 ^ z1;
  const W p2 = (x.l2 & y.m) ^ (x.m & y.l2) ^ g2 ^ z2;
  const W p3 = (x.l3 & y.m) ^ (x.m & y.l3) ^ g3 ^ z3;
  return {p1 ^ p2 ^ p3 ^ (x.m & y.m), z1, z2, z3};
}

// A chain's draws, all loaded into registers before its first AND, so
// their loads overlap instead of waiting one after another on the chain's
// dependent levels: `kAnds` ANDs of S (6 or 3) planes of n words.
template <typename W, int kAnds, int S>
struct Draws {
  W d[kAnds][S];

  __device__ __forceinline__ Draws(const W* __restrict__ draws, int64_t n,
                                   int64_t i) {
#pragma unroll
    for (int a = 0; a < kAnds; ++a)
#pragma unroll
      for (int s = 0; s < S; ++s) d[a][s] = draws[(a * S + s) * n + i];
  }

  // AND number a of the chain with its draws (z1, z2, z3[, f1, f2, f3])
  __device__ __forceinline__ Stack<W> and_(int a, const Stack<W>& x,
                                           const Stack<W>& y) const {
    W s0 = 0, s1 = 0, s2 = 0;
    if (S == 6) {
      s0 = d[a][4 % S] ^ d[a][3 % S];
      s1 = d[a][5 % S] ^ d[a][4 % S];
      s2 = d[a][3 % S] ^ d[a][5 % S];
    }
    return and_level(x, y, d[a][0], d[a][1], d[a][2], s0, s1, s2);
  }
};

// The offline run's ANDs: each writes its gamma words (gammas (A, 3, n))
// and gives the stack (0, z1, z2, z3).
template <typename W, int kAnds, int S>
struct OfflineAnds {
  Draws<W, kAnds, S> draws;
  W* __restrict__ gam;
  int64_t n, i;

  __device__ __forceinline__ OfflineAnds(const W* __restrict__ d,
                                         W* __restrict__ gammas, int64_t n,
                                         int64_t i)
      : draws(d, n, i), gam(gammas), n(n), i(i) {}

  __device__ __forceinline__ Stack<W> and_(int a, const Stack<W>& x,
                                           const Stack<W>& y) const {
    const W(&d)[S] = draws.d[a];
    W g1, g2 = 0, g3 = 0;
    if (S == 6) {
      g1 = (x.l1 & y.l1) ^ (x.l1 & y.l2) ^ (x.l2 & y.l1) ^ d[3 % S] ^
           d[5 % S];
      g2 = (x.l2 & y.l2) ^ (x.l2 & y.l3) ^ (x.l3 & y.l2) ^ d[4 % S] ^
           d[3 % S];
      g3 = (x.l3 & y.l3) ^ (x.l3 & y.l1) ^ (x.l1 & y.l3) ^ d[5 % S] ^
           d[4 % S];
    } else {
      g1 = (x.l1 ^ x.l2 ^ x.l3) & (y.l1 ^ y.l2 ^ y.l3);
    }
    gam[3 * a * n + i] = g1;
    gam[(3 * a + 1) * n + i] = g2;
    gam[(3 * a + 2) * n + i] = g3;
    return {W(0), d[0], d[1], d[2]};
  }
};

// The online run's ANDs on their lambdas and gammas (A, 3, n) each, all
// loaded before the first AND as the draws are.
template <typename W, int kAnds>
struct OnlineAnds {
  W z[kAnds][3], g[kAnds][3];

  __device__ __forceinline__ OnlineAnds(const W* __restrict__ lamz,
                                        const W* __restrict__ gammas,
                                        int64_t n, int64_t i) {
#pragma unroll
    for (int a = 0; a < kAnds; ++a)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        z[a][c] = lamz[(3 * a + c) * n + i];
        g[a][c] = gammas[(3 * a + c) * n + i];
      }
  }

  __device__ __forceinline__ Stack<W> and_(int a, const Stack<W>& x,
                                           const Stack<W>& y) const {
    const W p1 = (x.l1 & y.m) ^ (x.m & y.l1) ^ g[a][0] ^ z[a][0];
    const W p2 = (x.l2 & y.m) ^ (x.m & y.l2) ^ g[a][1] ^ z[a][1];
    const W p3 = (x.l3 & y.m) ^ (x.m & y.l3) ^ g[a][2] ^ z[a][2];
    return {p1 ^ p2 ^ p3 ^ (x.m & y.m), z[a][0], z[a][1], z[a][2]};
  }
};

// log2(ell): the adder's levels and the prefix-OR's ANDs.
template <typename W>
constexpr int kLog2Ell = sizeof(W) == 8 ? 6 : 5;

template <typename W>
__global__ void and_level_kernel(const W* __restrict__ x,
                                 const W* __restrict__ y,
                                 const W* __restrict__ lamz,
                                 const W* __restrict__ zero,
                                 W* __restrict__ out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  W s0 = 0, s1 = 0, s2 = 0;
  if (zero != nullptr) {
    s0 = zero[i];
    s1 = zero[n + i];
    s2 = zero[2 * n + i];
  }
  store(out, n, i, and_level(load(x, n, i), load(y, n, i), lamz[i],
                             lamz[n + i], lamz[2 * n + i], s0, s1, s2));
}

// Shift the isolated boundary bits of every component up across `width`
// positions (shift-XOR doubling of disjoint bits: linear over GF(2)).
template <typename W>
__device__ __forceinline__ Stack<W> smear(Stack<W> v, int width) {
  for (int j = 1; j < width; j <<= 1) v = v ^ (v << j);
  return v;
}

// The Sklansky adder [[X + Y + cin]] with AND a being d.and_(a, ., .).
template <typename W, typename Ands>
__device__ __forceinline__ Stack<W> adder(const Ands& d, const Stack<W>& X,
                                          const Stack<W>& Y, W cin) {
  constexpr int kLevels = kLog2Ell<W>;
  const Stack<W> p0 = X ^ Y;
  // g_0 ^= p_0 AND the public carry-in (cin is 0 or 1)
  Stack<W> g = d.and_(0, X, Y) ^ (p0 & cin);
  Stack<W> p = p0;
#pragma unroll
  for (int k = 0; k < kLevels; ++k) {
    const int half = 1 << k;
    // the lower half of every 2 * half block, its top bit (the boundary)
    // and the upper half
    const W lower = W(~W(0)) / W((W(1) << half) + W(1));
    const W upper = W(~lower);
    const W bnd = lower & W(upper >> 1);
    const Stack<W> gb = smear((g & bnd) << 1, half);
    const Stack<W> pb = smear((p & bnd) << 1, half);
    const Stack<W> pu = p & upper;
    g = g ^ d.and_(1 + 2 * k, pu, gb);
    p = (p & lower) ^ d.and_(2 + 2 * k, pu, pb);
  }
  Stack<W> s = p0 ^ (g << 1);            // sum_i = p0_i ^ carry_i
  s.m ^= cin;
  return s;
}

// The prefix-OR of `cur` from the msb down with AND a being d.and_(a, ., .).
template <typename W, typename Ands>
__device__ __forceinline__ Stack<W> prefix_or_chain(const Ands& d,
                                                    Stack<W> cur, W mask) {
#pragma unroll
  for (int a = 0; a < kLog2Ell<W>; ++a) {
    // OR(cur, cur >> j) = NOT(AND(NOT cur, NOT (cur >> j))), NOT being
    // the public XOR of `mask` into m
    Stack<W> sh = cur >> (1 << a);
    Stack<W> nc = cur;
    nc.m ^= mask;
    sh.m ^= mask;
    cur = d.and_(a, nc, sh);
    cur.m ^= mask;
  }
  return cur;
}

template <typename W, int S>
__global__ void ppa_add_kernel(const W* __restrict__ x,
                               const W* __restrict__ y,
                               const W* __restrict__ draws, W cin,
                               W* __restrict__ out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  const Draws<W, 2 * kLog2Ell<W> + 1, S> d(draws, n, i);
  store(out, n, i, adder(d, load(x, n, i), load(y, n, i), cin));
}

template <typename W, int S>
__global__ void prefix_or_kernel(const W* __restrict__ x,
                                 const W* __restrict__ draws, W mask,
                                 W* __restrict__ out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  const Draws<W, kLog2Ell<W>, S> d(draws, n, i);
  store(out, n, i, prefix_or_chain(d, load(x, n, i), mask));
}

// The split chains: kind 0 one AND, 1 the adder (arg = cin), 2 the
// prefix-OR (arg = mask; y unused).
template <typename W, int kKind>
constexpr int kChainAnds =
    kKind == 0 ? 1 : (kKind == 1 ? 2 * kLog2Ell<W> + 1 : kLog2Ell<W>);

template <typename W, int kKind, typename Ands>
__device__ __forceinline__ Stack<W> chain(const Ands& d, const W* x,
                                          const W* y, W arg, int64_t n,
                                          int64_t i) {
  const Stack<W> X = load(x, n, i);
  if constexpr (kKind == 0) {
    return d.and_(0, X, load(y, n, i));
  } else if constexpr (kKind == 1) {
    return adder(d, X, load(y, n, i), arg);
  } else {
    return prefix_or_chain(d, X, arg);
  }
}

template <typename W, int kKind, int S>
__global__ void and_chain_offline_kernel(const W* __restrict__ x,
                                         const W* __restrict__ y,
                                         const W* __restrict__ draws, W arg,
                                         W* __restrict__ gammas,
                                         W* __restrict__ out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  const OfflineAnds<W, kChainAnds<W, kKind>, S> d(draws, gammas, n, i);
  store(out, n, i, chain<W, kKind>(d, x, y, arg, n, i));
}

template <typename W, int kKind>
__global__ void and_chain_online_kernel(const W* __restrict__ x,
                                        const W* __restrict__ y,
                                        const W* __restrict__ lamz,
                                        const W* __restrict__ gammas, W arg,
                                        W* __restrict__ out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  const OnlineAnds<W, kChainAnds<W, kKind>> d(lamz, gammas, n, i);
  store(out, n, i, chain<W, kKind>(d, x, y, arg, n, i));
}

// msb(x + y) of public words: every AND of the adder on (v, 0, 0, 0)
// stacks with its level's draws, opened (the XOR of the output stack) as
// the Python loop opens it, so any zero shares give the loop's words.
template <typename W>
__global__ void ppa_msb_kernel(const W* __restrict__ x,
                               const W* __restrict__ y,
                               const W* __restrict__ lamz,
                               const W* __restrict__ zero,
                               W* __restrict__ out, int64_t n) {
  constexpr int kLevels = kLog2Ell<W>;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  const Draws<W, kLevels + 1, 3> lz(lamz, n, i), zr(zero, n, i);
  auto open_and = [&](int lvl, W a, W b) {
    const Stack<W> z = and_level(Stack<W>{a, 0, 0, 0}, Stack<W>{b, 0, 0, 0},
                                 lz.d[lvl][0], lz.d[lvl][1], lz.d[lvl][2],
                                 zr.d[lvl][0], zr.d[lvl][1], zr.d[lvl][2]);
    return W(z.m ^ z.l1 ^ z.l2 ^ z.l3);
  };
  const W X = x[i], Y = y[i];
  W g = open_and(0, X, Y);
  W p = X ^ Y;
#pragma unroll
  for (int k = 0; k < kLevels; ++k) {
    const int half = 1 << k;
    const W lower = W(~W(0)) / W((W(1) << half) + W(1));
    const W upper = W(~lower);
    const W bnd = lower & W(upper >> 1);
    W gb = W((g & bnd) << 1), pb = W((p & bnd) << 1);
    for (int j = 1; j < half; j <<= 1) {
      gb ^= W(gb << j);
      pb ^= W(pb << j);
    }
    const W pu = p & upper;
    g ^= open_and(k + 1, pu, gb);
    p = W((p & lower) ^ open_and(k + 1, pu, pb));
  }
  out[i] = W(W(X ^ Y ^ W(g << 1)) >> (8 * sizeof(W) - 1));
}

constexpr int kThreads = 256;

unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

template <typename W>
int launch(const void* x, const void* y, const void* lamz, const void* zero,
           void* out, int64_t n, void* stream) {
  if (n <= 0) return 0;
  and_level_kernel<W><<<blocks_for(n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const W*>(x), static_cast<const W*>(y),
      static_cast<const W*>(lamz), static_cast<const W*>(zero),
      static_cast<W*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

template <typename W>
int launch_add(const void* x, const void* y, const void* draws, int streams,
               int cin, void* out, int64_t n, void* stream) {
  if (n <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const W* xs = static_cast<const W*>(x);
  const W* ys = static_cast<const W*>(y);
  const W* ds = static_cast<const W*>(draws);
  const W c = cin ? W(1) : W(0);
  if (streams == 6)
    ppa_add_kernel<W, 6><<<blocks_for(n), kThreads, 0, s>>>(
        xs, ys, ds, c, static_cast<W*>(out), n);
  else if (streams == 3)
    ppa_add_kernel<W, 3><<<blocks_for(n), kThreads, 0, s>>>(
        xs, ys, ds, c, static_cast<W*>(out), n);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

template <typename W>
int launch_or(const void* x, const void* draws, int streams, uint64_t mask,
              void* out, int64_t n, void* stream) {
  if (n <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const W* xs = static_cast<const W*>(x);
  const W* ds = static_cast<const W*>(draws);
  if (streams == 6)
    prefix_or_kernel<W, 6><<<blocks_for(n), kThreads, 0, s>>>(
        xs, ds, static_cast<W>(mask), static_cast<W*>(out), n);
  else if (streams == 3)
    prefix_or_kernel<W, 3><<<blocks_for(n), kThreads, 0, s>>>(
        xs, ds, static_cast<W>(mask), static_cast<W*>(out), n);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

template <typename W>
int launch_msb(const void* x, const void* y, const void* lamz,
               const void* zero, void* out, int64_t n, void* stream) {
  if (n <= 0) return 0;
  ppa_msb_kernel<W><<<blocks_for(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const W*>(x), static_cast<const W*>(y),
      static_cast<const W*>(lamz), static_cast<const W*>(zero),
      static_cast<W*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

template <typename W, int kKind>
void offline_kind(int streams, const W* x, const W* y, const W* d, W arg,
                  W* gam, W* out, int64_t n, cudaStream_t s) {
  const unsigned blocks = blocks_for(n);
  if (streams == 6)
    and_chain_offline_kernel<W, kKind, 6><<<blocks, kThreads, 0, s>>>(
        x, y, d, arg, gam, out, n);
  else
    and_chain_offline_kernel<W, kKind, 3><<<blocks, kThreads, 0, s>>>(
        x, y, d, arg, gam, out, n);
}

template <typename W>
int launch_offline(int kind, const void* x, const void* y, const void* draws,
                   int streams, uint64_t arg, void* gammas, void* out,
                   int64_t n, void* stream) {
  if (n <= 0) return 0;
  if ((streams != 6 && streams != 3) || kind < 0 || kind > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const W* xs = static_cast<const W*>(x);
  const W* ys = static_cast<const W*>(y);
  const W* ds = static_cast<const W*>(draws);
  W* gam = static_cast<W*>(gammas);
  W* o = static_cast<W*>(out);
  const W a = static_cast<W>(arg);
  if (kind == 0)
    offline_kind<W, 0>(streams, xs, ys, ds, a, gam, o, n, s);
  else if (kind == 1)
    offline_kind<W, 1>(streams, xs, ys, ds, a, gam, o, n, s);
  else
    offline_kind<W, 2>(streams, xs, ys, ds, a, gam, o, n, s);
  return static_cast<int>(cudaGetLastError());
}

template <typename W>
int launch_online(int kind, const void* x, const void* y, const void* lamz,
                  const void* gammas, uint64_t arg, void* out, int64_t n,
                  void* stream) {
  if (n <= 0) return 0;
  if (kind < 0 || kind > 2) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const W* xs = static_cast<const W*>(x);
  const W* ys = static_cast<const W*>(y);
  const W* lz = static_cast<const W*>(lamz);
  const W* gam = static_cast<const W*>(gammas);
  W* o = static_cast<W*>(out);
  const W a = static_cast<W>(arg);
  if (kind == 0)
    and_chain_online_kernel<W, 0><<<blocks_for(n), kThreads, 0, s>>>(
        xs, ys, lz, gam, a, o, n);
  else if (kind == 1)
    and_chain_online_kernel<W, 1><<<blocks_for(n), kThreads, 0, s>>>(
        xs, ys, lz, gam, a, o, n);
  else
    and_chain_online_kernel<W, 2><<<blocks_for(n), kThreads, 0, s>>>(
        xs, ys, lz, gam, a, o, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int and_level_u64(const void* x, const void* y, const void* lamz,
                             const void* zero, void* out, int64_t n,
                             void* stream) {
  return launch<uint64_t>(x, y, lamz, zero, out, n, stream);
}

extern "C" int and_level_u32(const void* x, const void* y, const void* lamz,
                             const void* zero, void* out, int64_t n,
                             void* stream) {
  return launch<uint32_t>(x, y, lamz, zero, out, n, stream);
}

extern "C" int ppa_add_u64(const void* x, const void* y, const void* draws,
                           int streams, int cin, void* out, int64_t n,
                           void* stream) {
  return launch_add<uint64_t>(x, y, draws, streams, cin, out, n, stream);
}

extern "C" int ppa_add_u32(const void* x, const void* y, const void* draws,
                           int streams, int cin, void* out, int64_t n,
                           void* stream) {
  return launch_add<uint32_t>(x, y, draws, streams, cin, out, n, stream);
}

extern "C" int prefix_or_u64(const void* x, const void* draws, int streams,
                             uint64_t mask, void* out, int64_t n,
                             void* stream) {
  return launch_or<uint64_t>(x, draws, streams, mask, out, n, stream);
}

extern "C" int prefix_or_u32(const void* x, const void* draws, int streams,
                             uint64_t mask, void* out, int64_t n,
                             void* stream) {
  return launch_or<uint32_t>(x, draws, streams, mask, out, n, stream);
}

extern "C" int ppa_msb_u64(const void* x, const void* y, const void* lamz,
                           const void* zero, void* out, int64_t n,
                           void* stream) {
  return launch_msb<uint64_t>(x, y, lamz, zero, out, n, stream);
}

extern "C" int ppa_msb_u32(const void* x, const void* y, const void* lamz,
                           const void* zero, void* out, int64_t n,
                           void* stream) {
  return launch_msb<uint32_t>(x, y, lamz, zero, out, n, stream);
}

extern "C" int and_chain_offline_u64(int kind, const void* x, const void* y,
                                     const void* draws, int streams,
                                     uint64_t arg, void* gammas, void* out,
                                     int64_t n, void* stream) {
  return launch_offline<uint64_t>(kind, x, y, draws, streams, arg, gammas,
                                  out, n, stream);
}

extern "C" int and_chain_offline_u32(int kind, const void* x, const void* y,
                                     const void* draws, int streams,
                                     uint64_t arg, void* gammas, void* out,
                                     int64_t n, void* stream) {
  return launch_offline<uint32_t>(kind, x, y, draws, streams, arg, gammas,
                                  out, n, stream);
}

extern "C" int and_chain_online_u64(int kind, const void* x, const void* y,
                                    const void* lamz, const void* gammas,
                                    uint64_t arg, void* out, int64_t n,
                                    void* stream) {
  return launch_online<uint64_t>(kind, x, y, lamz, gammas, arg, out, n,
                                 stream);
}

extern "C" int and_chain_online_u32(int kind, const void* x, const void* y,
                                    const void* lamz, const void* gammas,
                                    uint64_t arg, void* out, int64_t n,
                                    void* stream) {
  return launch_online<uint32_t>(kind, x, y, lamz, gammas, arg, out, n,
                                 stream);
}
