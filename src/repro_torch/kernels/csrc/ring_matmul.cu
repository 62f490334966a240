// Ring matmul C = A @ B mod 2^ell (ell = 64 or 32) on Hopper's int8 tensor
// cores (sm_90a).
//
// Replaces: src/repro/kernels/limb_matmul.py:79 limb_matmul (_limb_kernel at
// :38: 4-bit limbs in f32 on the MXU), and through the stacked call
// src/repro/kernels/mpc_matmul_fused.py:46 mpc_matmul_grid, which is this
// kernel launched once on row- and column-stacked operands.
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
// the largest sum is L * 65,025 * k_chunk.  The kernel never lets an
// accumulator leave [0, 2^31): k_chunk <= (2^31 - 1) / (L * 65,025), that
// is 4,128 words for ell = 64 and 8,256 for ell = 32 (kMaxKChunk below;
// the wrapper refuses more).  So every T_s is exact as a non-negative s32,
// with no reliance on wrap-around.  Longer K runs in chunks whose partial
// tiles meet in C by u64/u32 atomicAdd, exact and order-free because ring
// addition is.  The main path's longest K (3 * 784 = 2,352) fits one chunk.
//
// Data movement.  A block owns a 64 x 64 output tile and one K chunk, which
// it walks in steps of 32 words.  Each step's u64/u32 operand tiles come
// into shared memory by cp.async, in a ring of two stages, so each operand
// byte is read from device memory once per tile; the block splits them in
// shared memory into limb planes in the layout wgmma reads: K-major, no
// swizzle, 8-row x 16-byte core matrices.  B's planes are transposed to
// (N, K) on the way, since 8-bit wgmma takes both operands K-major.  The
// planes are double-buffered, so one step's split overlaps the previous
// step's wgmma.
//
// Parallelism.  One 64-row wgmma tile with a 64 x 64 s32 accumulator costs
// 32 registers a thread, so the L diagonals are spread over L / 2 warpgroups
// of one block: warpgroup g sums diagonals g and L - 1 - g (L + 1 pairs,
// the same for every warpgroup).  The main path's products are short in
// M x N and long in K, so the wrapper splits K into chunks until the grid
// has about one block per SM.  The warpgroups' shifted partials are summed
// in shared memory and the block adds its tile into C.
//
// Bound on the H100: at 128x2352x128, the bytes (4.95 MB over 3.35 TB/s,
// 1.48 us) and the limb-pair int8 operations (36 * 2 * M * N * K = 2.77 G
// over 1,979 TOP/s, 1.40 us) about equally; at 384x784x384 the operations
// (8.32 G, 4.21 us).  What holds this design back is shared memory: with
// both operands in shared memory an m64n64k32 u8 wgmma reads 4 KB for 32
// clocks of tensor work, the SM's whole 128 bytes a clock, and each step's
// staging and split move another 96 KB; the eight diagonal accumulators
// fill half the register file at a 64 x 64 tile, so no wider N amortises
// the A reads.  The staged rows are padded and the split's tasks laid out
// so that its shared-memory accesses spread over the banks.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;             // output rows of a block (one wgmma M)
constexpr int kBN = 64;             // output columns of a block (wgmma N)
constexpr int kBK = 32;             // K words per step (one k32 wgmma)
constexpr int kPlane = kBM * kBK;   // bytes of one limb plane (64 x 32)
constexpr int kWarpgroup = 128;

template <typename W>
struct Cfg {
  static constexpr int kLimbs = static_cast<int>(sizeof(W));
  static constexpr int kGroups = kLimbs / 2;            // warpgroups
  static constexpr int kThreads = kGroups * kWarpgroup;
  // staged rows are padded by 16 bytes, so the split's reads of 8 rows
  // (or 4 K rows) at once spread over the banks
  static constexpr int kPad = 16 / static_cast<int>(sizeof(W));
  static constexpr int kAS = kBK + kPad;       // A stage row stride, words
  static constexpr int kBS = kBN + kPad;       // B stage row stride, words
  static constexpr int kStageWords = kBM * kAS + kBK * kBS;
  static constexpr int kStageBytes = kStageWords * static_cast<int>(sizeof(W));
  static constexpr int kPlanesBytes = 2 * kLimbs * kPlane;   // A and B
  // two staging stages, two plane buffers; the epilogue reuses them
  static constexpr int kSmem = 2 * kStageBytes + 2 * kPlanesBytes;
};
static_assert(kBM == 64 && kBN == 64 && kBK == 32, "split task layout");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One word of global memory into shared memory; src_bytes = 0 zero-fills.
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

// The kernel: one 64 x 64 output tile and one K chunk per block.  kVec:
// operand rows are 16-byte aligned (16-byte copies), else one word a copy.
template <typename W, bool kVec>
__global__ void __launch_bounds__(Cfg<W>::kThreads, 1)
ring_matmul_kernel(const W* __restrict__ A, const W* __restrict__ B,
                   W* __restrict__ C, int M, int N, int K, int k_chunk,
                   bool accumulate) {
  using G = Cfg<W>;
  constexpr int L = G::kLimbs;
  constexpr int kPer = kVec ? 16 / static_cast<int>(sizeof(W)) : 1;
  extern __shared__ __align__(128) unsigned char smem[];
  auto stage = [&](int t) {
    return reinterpret_cast<W*>(smem + (t & 1) * G::kStageBytes);
  };
  auto planes = [&](int t) {
    return smem + 2 * G::kStageBytes + (t & 1) * G::kPlanesBytes;
  };

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int kbeg = blockIdx.z * k_chunk;
  const int kend = min(K, kbeg + k_chunk);
  const int steps = max(0, (kend - kbeg + kBK - 1) / kBK);

  // stage layout: A tile (64 rows x 32 words), then B tile (32 x 64); a
  // copy moves kPer words, zero-filled outside the operands
  auto load = [&](int t, W* st) {
    const int k0 = kbeg + t * kBK;
    for (int idx = tid; idx < kBM * kBK / kPer; idx += G::kThreads) {
      const int r = idx / (kBK / kPer), c = (idx % (kBK / kPer)) * kPer;
      const int gr = m0 + r, gk = k0 + c;
      const bool ok = gr < M && gk < kend;
      cp_async<kPer * sizeof(W)>(
          st + r * G::kAS + c,
          ok ? A + static_cast<int64_t>(gr) * K + gk : A,
          ok);
    }
    W* sb = st + kBM * G::kAS;
    for (int idx = tid; idx < kBK * kBN / kPer; idx += G::kThreads) {
      const int r = idx / (kBN / kPer), c = (idx % (kBN / kPer)) * kPer;
      const int gk = k0 + r, gc = n0 + c;
      const bool ok = gk < kend && gc < N;
      cp_async<kPer * sizeof(W)>(
          sb + r * G::kBS + c,
          ok ? B + static_cast<int64_t>(gk) * N + gc : B,
          ok);
    }
  };

  // limb planes of one step: A plane p at p * kPlane ((m, k) K-major),
  // B plane p at (L + p) * kPlane ((n, k) K-major).  A task is 4 K-
  // consecutive words of one row; a warp's 32 tasks are one core matrix
  // (8 rows x 4 word quads), so its plane stores hit 32 banks.
  auto task_rc = [](int task, int& r, int& k) {
    r = ((task >> 5) & 7) * 8 + (task & 7);
    k = ((task >> 8) * 4 + ((task >> 3) & 3)) * 4;
  };
  auto split = [&](const W* st, unsigned char* pl) {
    for (int task = tid; task < kBM * (kBK / 4); task += G::kThreads) {
      int r, k;
      task_rc(task, r, k);
      W w[4];
#pragma unroll
      for (int q = 0; q < 4; q += G::kPad)
        *reinterpret_cast<uint4*>(w + q) =
            *reinterpret_cast<const uint4*>(st + r * G::kAS + k + q);
      uint32_t out[L];
      split4<W>(w, out);
      const int off = plane_offset(r, k);
#pragma unroll
      for (int p = 0; p < L; ++p)
        *reinterpret_cast<uint32_t*>(pl + p * kPlane + off) = out[p];
    }
    const W* sb = st + kBM * G::kAS;
    for (int task = tid; task < kBN * (kBK / 4); task += G::kThreads) {
      int n, k;
      task_rc(task, n, k);
      W w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) w[q] = sb[(k + q) * G::kBS + n];
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

  load(0, stage(0));
  cp_async_commit();
  if (steps > 1) load(1, stage(1));
  cp_async_commit();
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<1>();
    __syncthreads();              // stage t landed; planes[t % 2] are free
    unsigned char* pl = planes(t);
    split(stage(t), pl);
    __syncthreads();              // planes written, stage t consumed
    if (t + 2 < steps) load(t + 2, stage(t));
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

// Largest K chunk whose accumulators stay in [0, 2^31) (see the header).
template <typename W>
constexpr int kMaxKChunk =
    static_cast<int>(0x7FFFFFFFLL / (static_cast<long long>(sizeof(W)) *
                                     255 * 255));
static_assert(kMaxKChunk<uint64_t> == 4128, "ell = 64 chunk bound");
static_assert(kMaxKChunk<uint32_t> == 8256, "ell = 32 chunk bound");

template <typename W, bool kVec>
int launch_as(const W* A, const W* B, W* C, int M, int N, int K, int k_chunk,
              cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      ring_matmul_kernel<W, kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<W>::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int chunks = (K + k_chunk - 1) / k_chunk;
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, chunks);
  ring_matmul_kernel<W, kVec><<<grid, Cfg<W>::kThreads, Cfg<W>::kSmem,
                                stream>>>(A, B, C, M, N, K, k_chunk,
                                          chunks > 1);
  return static_cast<int>(cudaGetLastError());
}

// C must be zeroed by the caller when K spans more than one chunk.
template <typename W>
int launch(const void* A, const void* B, void* C, int M, int N, int K,
           int k_chunk, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return 0;
  if (k_chunk <= 0 || k_chunk > kMaxKChunk<W> || k_chunk % kBK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const W* a = static_cast<const W*>(A);
  const W* b = static_cast<const W*>(B);
  constexpr int kPer = 16 / static_cast<int>(sizeof(W));
  const bool vec = K % kPer == 0 && N % kPer == 0 &&
                   reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0;
  auto s = static_cast<cudaStream_t>(stream);
  return vec ? launch_as<W, true>(a, b, static_cast<W*>(C), M, N, K,
                                  k_chunk, s)
             : launch_as<W, false>(a, b, static_cast<W*>(C), M, N, K,
                                   k_chunk, s);
}

}  // namespace

extern "C" int ring_matmul_u64(const void* A, const void* B, void* C, int M,
                               int N, int K, int k_chunk, void* stream) {
  return launch<uint64_t>(A, B, C, M, N, K, k_chunk, stream);
}

extern "C" int ring_matmul_u32(const void* A, const void* B, void* C, int M,
                               int N, int K, int k_chunk, void* stream) {
  return launch<uint32_t>(A, B, C, M, N, K, k_chunk, stream);
}
