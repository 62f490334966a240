// The int8 tensor-core limb core of the ring matmuls, for Hopper (sm_90a):
// one block's 64 x 64 output tile of
//
//   C = (A_0 + ... + A_{NA-1}) @ (B_0 + ... + B_{NB-1})  mod 2^ell
//
// over one K chunk, added into C by atomicAdd or stored.  The operand sums
// wrap in the word type W (uint64_t or uint32_t, ell = 64 or 32) and are
// formed as the tiles are split, so they never go to device memory.
// ring_matmul.cu runs it with one plane a side (NA = NB = 1);
// mpc_matmul_fused.cu with one or three (a lambda sum) a side.
//
// Limbs.  Each word splits into 8-bit limbs, byte i of the little-endian
// word being limb i: L = ell / 8 limbs.  Mod 2^ell only the pairs with
// i + j < L survive (36 for ell = 64, 10 for ell = 32), and
//   C = sum_s T_s << 8s  mod 2^ell,   T_s = sum_{i+j=s} A_i @ B_j.
// Each limb-pair product is a `wgmma.mma_async ... .s32.u8.u8` (m64n64k32)
// with the sum kept in s32 registers.
//
// Exactness.  A u8 x u8 product is at most 255^2 = 65,025.  A block sums
// all (s + 1) pairs of a diagonal over its K chunk into one accumulator, so
// the largest sum is L * 65,025 * k_chunk.  The core never lets an
// accumulator leave [0, 2^31): k_chunk <= (2^31 - 1) / (L * 65,025), that
// is 4,128 words for ell = 64 and 8,256 for ell = 32 (kMaxKChunk below;
// the launchers refuse more).  The limbs are those of the wrapped operand
// sums, so the bound holds whatever NA and NB are.  Longer K runs in chunks
// whose partial tiles meet in C by u64/u32 atomicAdd, exact and order-free
// because ring addition is.
//
// Data movement.  A block walks its K chunk in steps of 32 words.  Each
// step's NA + NB operand tiles come into shared memory by cp.async, in a
// ring of kStages stages (two where they fit, one for the two three-plane
// sides of 64-bit words), so each operand byte is read from device memory
// once per tile; the block sums the planes and splits the sums in shared
// memory into limb planes in the layout wgmma reads: K-major, no swizzle,
// 8-row x 16-byte core matrices.  B's planes are transposed to (N, K) on
// the way, since 8-bit wgmma takes both operands K-major.  The limb planes
// are double-buffered, so one step's split overlaps the previous step's
// wgmma.
//
// Parallelism.  One 64-row wgmma tile with a 64 x 64 s32 accumulator costs
// 32 registers a thread, so the L diagonals are spread over L / 2 warpgroups
// of one block: warpgroup g sums diagonals g and L - 1 - g (L + 1 pairs,
// the same for every warpgroup).  The warpgroups' shifted partials are
// summed in shared memory and the block adds its tile into C.
//
// What holds the design back is shared memory: with both operands in
// shared memory an m64n64k32 u8 wgmma reads 4 KB for 32 clocks of tensor
// work, the SM's whole 128 bytes a clock, and each step's staging and split
// move another 96 KB a plane a side.  The eight diagonal accumulators fill
// half the register file at a 64 x 64 tile, so no wider N amortises the A
// reads.  The staged rows are padded and the split's tasks laid out so that
// its shared-memory accesses spread over the banks.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace limb {

constexpr int kBM = 64;             // output rows of a block (one wgmma M)
constexpr int kBN = 64;             // output columns of a block (wgmma N)
constexpr int kBK = 32;             // K words per step (one k32 wgmma)
constexpr int kPlane = kBM * kBK;   // bytes of one limb plane (64 x 32)
constexpr int kWarpgroup = 128;
constexpr int kMaxSmem = 232448;    // dynamic shared memory a block may use
static_assert(kBM == 64 && kBN == 64 && kBK == 32, "split task layout");

template <typename W>
constexpr int kLimbs = static_cast<int>(sizeof(W));

// Threads of a block: one warpgroup a pair of diagonals.
template <typename W>
constexpr int kThreads = kLimbs<W> / 2 * kWarpgroup;

// Largest K chunk whose accumulators stay in [0, 2^31) (see the header).
template <typename W>
constexpr int kMaxKChunk =
    static_cast<int>(0x7FFFFFFFLL / (static_cast<long long>(sizeof(W)) *
                                     255 * 255));
static_assert(kMaxKChunk<uint64_t> == 4128, "ell = 64 chunk bound");
static_assert(kMaxKChunk<uint32_t> == 8256, "ell = 32 chunk bound");

// Shared memory of a block with NA planes of A and NB of B a step.
template <typename W, int NA, int NB>
struct Cfg {
  static constexpr int kLimbs = limb::kLimbs<W>;
  static constexpr int kGroups = kLimbs / 2;            // warpgroups
  static constexpr int kThreads = limb::kThreads<W>;
  // staged rows are padded by 16 bytes, so the split's reads of 8 rows
  // (or 4 K rows) at once spread over the banks
  static constexpr int kPad = 16 / static_cast<int>(sizeof(W));
  static constexpr int kAS = kBK + kPad;       // A stage row stride, words
  static constexpr int kBS = kBN + kPad;       // B stage row stride, words
  static constexpr int kAPlane = kBM * kAS;    // words of one staged A plane
  static constexpr int kBPlane = kBK * kBS;    // words of one staged B plane
  static constexpr int kStageWords = NA * kAPlane + NB * kBPlane;
  static constexpr int kStageBytes = kStageWords * static_cast<int>(sizeof(W));
  static constexpr int kPlanesBytes = 2 * kLimbs * kPlane;   // A and B
  // two staging stages where they fit beside two plane buffers, else one
  static constexpr int kStages =
      2 * kStageBytes + 2 * kPlanesBytes <= kMaxSmem ? 2 : 1;
  static constexpr int kSmem = kStages * kStageBytes + 2 * kPlanesBytes;
  static_assert(kSmem <= kMaxSmem, "shared memory of a block");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One copy of global memory into shared memory; src_bytes = 0 zero-fills.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "n"(kBytes), "r"(valid ? kBytes : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Shared-memory matrix descriptor: no swizzle, K-major.  lbo = byte stride
// between core matrices adjacent in K, sbo = between 8-row groups.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32);
}

// Plane layout: core matrix (row group rg, K half kc) at (2 rg + kc) * 128.
constexpr uint32_t kLbo = 128;
constexpr uint32_t kSbo = 256;

__device__ __forceinline__ int plane_offset(int row, int k) {
  return ((row >> 3) * 2 + (k >> 4)) * 128 + (row & 7) * 16 + (k & 15);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// d += A(64 x 32 u8) @ B(32 x 64 u8), s32 accumulators.
__device__ __forceinline__ void wgmma_u8(uint32_t (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.u8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// Bytes p of four words, packed little-endian: out[p] = the 4 K-consecutive
// limb-p bytes of w[0..3].
template <typename W>
__device__ __forceinline__ void split4(const W (&w)[4],
                                       uint32_t (&out)[sizeof(W)]) {
#pragma unroll
  for (int h = 0; h < static_cast<int>(sizeof(W)) / 4; ++h) {
    uint32_t x[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      x[q] = static_cast<uint32_t>(static_cast<uint64_t>(w[q]) >> (32 * h));
    const uint32_t t01 = __byte_perm(x[0], x[1], 0x5140);
    const uint32_t t23 = __byte_perm(x[2], x[3], 0x5140);
    const uint32_t u01 = __byte_perm(x[0], x[1], 0x7362);
    const uint32_t u23 = __byte_perm(x[2], x[3], 0x7362);
    out[4 * h + 0] = __byte_perm(t01, t23, 0x5410);
    out[4 * h + 1] = __byte_perm(t01, t23, 0x7632);
    out[4 * h + 2] = __byte_perm(u01, u23, 0x5410);
    out[4 * h + 3] = __byte_perm(u01, u23, 0x7632);
  }
}

// One step of warpgroup g: the limb pairs of diagonals g and L - 1 - g,
// A plane i (at i * kPlane) against B plane s - i (at (L + s - i) * kPlane).
template <int L, int g>
__device__ __forceinline__ void diagonals(uint32_t (&acc0)[32],
                                          uint32_t (&acc1)[32],
                                          uint32_t base) {
#pragma unroll
  for (int i = 0; i <= g; ++i)
    wgmma_u8(acc0, make_desc(base + i * kPlane, kLbo, kSbo),
             make_desc(base + (L + g - i) * kPlane, kLbo, kSbo));
#pragma unroll
  for (int i = 0; i <= L - 1 - g; ++i)
    wgmma_u8(acc1, make_desc(base + i * kPlane, kLbo, kSbo),
             make_desc(base + (2 * L - 1 - g - i) * kPlane, kLbo, kSbo));
}

// Two adjacent words, stored and loaded as one vector.
template <typename W>
struct alignas(2 * sizeof(W)) Pair {
  W lo, hi;
};

__device__ __forceinline__ void atomic_add_word(uint64_t* p, uint64_t v) {
  atomicAdd(reinterpret_cast<unsigned long long*>(p),
            static_cast<unsigned long long>(v));
}

__device__ __forceinline__ void atomic_add_word(uint32_t* p, uint32_t v) {
  atomicAdd(reinterpret_cast<unsigned int*>(p), static_cast<unsigned int>(v));
}

// The block's work: the 64 x 64 tile at (m0, n0) of C (M x N, row-major)
// over K words [kbeg, kend) of A (M x K) and B (K x N), each the sum of NA
// (NB) planes a_plane (b_plane) words apart.  kVec: operand rows and planes
// are 16-byte aligned (16-byte copies), else one word a copy.  `smem` holds
// Cfg<W, NA, NB>::kSmem bytes.
template <typename W, bool kVec, int NA, int NB>
__device__ __forceinline__ void tile(const W* __restrict__ A, int64_t a_plane,
                                     const W* __restrict__ B, int64_t b_plane,
                                     W* __restrict__ C, int M, int N, int K,
                                     int m0, int n0, int kbeg, int kend,
                                     bool accumulate, unsigned char* smem) {
  using G = Cfg<W, NA, NB>;
  constexpr int L = G::kLimbs;
  constexpr int kS = G::kStages;
  constexpr int kPer = kVec ? 16 / static_cast<int>(sizeof(W)) : 1;
  auto stage = [&](int t) {
    return reinterpret_cast<W*>(smem + (t % kS) * G::kStageBytes);
  };
  auto planes = [&](int t) {
    return smem + kS * G::kStageBytes + (t & 1) * G::kPlanesBytes;
  };

  const int tid = threadIdx.x;
  const int steps = max(0, (kend - kbeg + kBK - 1) / kBK);

  // stage layout: the NA A tiles (64 rows x 32 words), then the NB B tiles
  // (32 x 64); a copy moves kPer words, zero-filled outside the operands
  auto load = [&](int t, W* st) {
    const int k0 = kbeg + t * kBK;
    for (int idx = tid; idx < kBM * kBK / kPer; idx += G::kThreads) {
      const int r = idx / (kBK / kPer), c = (idx % (kBK / kPer)) * kPer;
      const int gr = m0 + r, gk = k0 + c;
      const bool ok = gr < M && gk < kend;
      const W* src = A + static_cast<int64_t>(gr) * K + gk;
#pragma unroll
      for (int p = 0; p < NA; ++p)
        cp_async<kPer * sizeof(W)>(st + p * G::kAPlane + r * G::kAS + c,
                                   ok ? src + p * a_plane : A, ok);
    }
    W* sb = st + NA * G::kAPlane;
    for (int idx = tid; idx < kBK * kBN / kPer; idx += G::kThreads) {
      const int r = idx / (kBN / kPer), c = (idx % (kBN / kPer)) * kPer;
      const int gk = k0 + r, gc = n0 + c;
      const bool ok = gk < kend && gc < N;
      const W* src = B + static_cast<int64_t>(gk) * N + gc;
#pragma unroll
      for (int p = 0; p < NB; ++p)
        cp_async<kPer * sizeof(W)>(sb + p * G::kBPlane + r * G::kBS + c,
                                   ok ? src + p * b_plane : B, ok);
    }
  };

  // limb planes of one step: A plane p at p * kPlane ((m, k) K-major),
  // B plane p at (L + p) * kPlane ((n, k) K-major).  A task is 4 K-
  // consecutive words of one row, summed over the staged planes; a warp's
  // 32 tasks are one core matrix (8 rows x 4 word quads), so its plane
  // stores hit 32 banks.
  auto task_rc = [](int task, int& r, int& k) {
    r = ((task >> 5) & 7) * 8 + (task & 7);
    k = ((task >> 8) * 4 + ((task >> 3) & 3)) * 4;
  };
  auto split = [&](const W* st, unsigned char* pl) {
    for (int task = tid; task < kBM * (kBK / 4); task += G::kThreads) {
      int r, k;
      task_rc(task, r, k);
      W w[4] = {0, 0, 0, 0};
#pragma unroll
      for (int p = 0; p < NA; ++p)
#pragma unroll
        for (int q = 0; q < 4; q += G::kPad) {
          alignas(16) W v[G::kPad];
          *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(
              st + p * G::kAPlane + r * G::kAS + k + q);
#pragma unroll
          for (int e = 0; e < G::kPad; ++e) w[q + e] += v[e];
        }
      uint32_t out[L];
      split4<W>(w, out);
      const int off = plane_offset(r, k);
#pragma unroll
      for (int p = 0; p < L; ++p)
        *reinterpret_cast<uint32_t*>(pl + p * kPlane + off) = out[p];
    }
    const W* sb = st + NA * G::kAPlane;
    for (int task = tid; task < kBN * (kBK / 4); task += G::kThreads) {
      int n, k;
      task_rc(task, n, k);
      W w[4] = {0, 0, 0, 0};
#pragma unroll
      for (int p = 0; p < NB; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          w[q] += sb[p * G::kBPlane + (k + q) * G::kBS + n];
      uint32_t out[L];
      split4<W>(w, out);
      const int off = plane_offset(n, k);
#pragma unroll
      for (int p = 0; p < L; ++p)
        *reinterpret_cast<uint32_t*>(pl + (L + p) * kPlane + off) = out[p];
    }
    // make the generic-proxy stores visible to wgmma's async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };

  // warpgroup index through a shuffle, so the compiler sees it uniform and
  // keeps the wgmma sequence asynchronous
  const int wg = __shfl_sync(0xFFFFFFFFu, tid / kWarpgroup, 0);
  const int s0 = wg, s1 = L - 1 - wg;          // this warpgroup's diagonals
  uint32_t acc0[32], acc1[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc0[i] = acc1[i] = 0u;

#pragma unroll
  for (int t = 0; t < kS; ++t) {
    if (t < steps) load(t, stage(t));
    cp_async_commit();
  }
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<kS - 1>();
    __syncthreads();              // stage t landed; planes[t % 2] are free
    unsigned char* pl = planes(t);
    split(stage(t), pl);
    __syncthreads();              // planes written, stage t consumed
    if (t + kS < steps) load(t + kS, stage(t));
    cp_async_commit();
    const uint32_t base = smem_u32(pl);
    wgmma_fence();
    switch (wg) {
      case 0: diagonals<L, 0>(acc0, acc1, base); break;
      case 1: diagonals<L, 1>(acc0, acc1, base); break;
      case 2: diagonals<L, 2 % (L / 2)>(acc0, acc1, base); break;
      default: diagonals<L, 3 % (L / 2)>(acc0, acc1, base); break;
    }
    wgmma_commit();
    // the step before this one is done: its planes may be overwritten
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  cp_async_wait<0>();

  // this warpgroup's partial sum_s T_s << 8s, read out of the accumulators
  // on the path every warpgroup takes
  W part[32];
#pragma unroll
  for (int i = 0; i < 32; ++i)
    part[i] = (static_cast<W>(acc0[i]) << (8 * s0)) +
              (static_cast<W>(acc1[i]) << (8 * s1));
  __syncthreads();

  // the block's tile: the warpgroups' partials summed in shared memory.
  // The upper half of the warpgroups stores into kSlots padded tiles, the
  // lower half adds its own, and every thread sums the slots of its words.
  // A thread's two column-adjacent words go as one store.
  constexpr int kSlots = G::kGroups / 2;
  constexpr int kTS = kBN + 8;                   // slot row stride, words
  static_assert(kSlots * kBM * kTS * sizeof(W) <= G::kSmem, "epilogue");
  W* slots = reinterpret_cast<W*>(smem);
  const int lane = tid % 32, warp = (tid % kWarpgroup) / 32;
  const int row = warp * 16 + lane / 4, col = (lane % 4) * 2;
  for (int half = 1; half >= 0; --half) {
    if ((wg >= kSlots) == (half == 1)) {
      W* slot = slots + (wg % kSlots) * kBM * kTS;
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        W* dst = slot + (row + ((i >> 1) & 1) * 8) * kTS + col +
                 (i >> 2) * 8;
        Pair<W> v = {part[i], part[i + 1]};
        if (half == 0) {
          const Pair<W> had = *reinterpret_cast<const Pair<W>*>(dst);
          v.lo += had.lo;
          v.hi += had.hi;
        }
        *reinterpret_cast<Pair<W>*>(dst) = v;
      }
    }
    __syncthreads();
  }

  for (int idx = tid; idx < kBM * kBN; idx += G::kThreads) {
    const int r = m0 + idx / kBN, c = n0 + idx % kBN;
    if (r >= M || c >= N) continue;
    W v = 0;
#pragma unroll
    for (int q = 0; q < kSlots; ++q)
      v += slots[q * kBM * kTS + (idx / kBN) * kTS + idx % kBN];
    W* dst = C + static_cast<int64_t>(r) * N + c;
    if (accumulate) {
      atomic_add_word(dst, v);
    } else {
      *dst = v;
    }
  }
}

// 16-byte copies need every operand row and plane to start on a 16-byte
// boundary: aligned base pointers and word counts that are multiples of
// the words a copy moves.
inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace limb
