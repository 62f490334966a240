// Fused secure-matmul local products of the collapsed joint simulation on
// Hopper's int8 tensor cores (sm_90a).
//
// Replaces: src/repro/kernels/mpc_matmul_fused.py:72 mpc_matmul_fused, the
// 2x2 case of the all-pairs limb pass (mpc_matmul_grid, :46) over
// (m_x, lam_x_sum) x (m_y, lam_y_sum).
//
// From mx (M, K), lx (3, M, K), my (K, N), ly (3, K, N) it computes, mod
// 2^ell,
//
//   out[0] = mm    = mx @ my
//   out[1] = cross = lxs @ my + mx @ lys
//   out[2] = gamma = lxs @ lys
//
// with lxs = lx[0] + lx[1] + lx[2] and lys = ly[0] + ly[1] + ly[2]; out is
// (5, M, N), zeroed by the caller (out[3:5] stay zero: out[2:5] is the
// collapsed gamma stack [gamma, 0, 0]).  Words are uint64_t or uint32_t.
//
// Design: ring_matmul.cu's limb core (limb_core.cuh: 8-bit limbs, `wgmma`
// m64n64k32 u8 x u8 -> s32, operand tiles staged by cp.async and split into
// K-major limb planes, K chunks of at most 4,128 words).  The grid is
// (N tiles, M tiles, 4 quadrants x K chunks): quadrant q pairs one source
// a side, (mx | lxs) x (my | lys), so no tile straddles two operands (at
// layer 3, N = 10 is not a multiple of 64).  A lambda side stages its
// three planes and the split sums them as it forms the limbs, so the sums
// wrap like the words and never go to device memory; the limbs are those
// of the wrapped sums, so the chunk bound holds as it is.  Quadrants and
// chunks meet in the output by atomicAdd, cross's two quadrants included.
// A lambda side's three staged planes leave room for one staging stage
// only at ell = 64 when both sides are lambdas (quadrant 3); the others
// keep two.
//
// Bound on the H100: at the main path's 128x784x128, the bytes (8 operand
// planes read once, 3 output planes written once: 6.82 MB over 3.35 TB/s,
// 2.04 us) over the limb-pair int8 operations (4 quadrants x 36 pairs x
// 2 M N K = 3.70 G over 1,979 TOP/s, 1.87 us).  Each quadrant reads its
// sources once per output tile, so an operand is read twice as often as by
// one tile of all four products; the staging of the three lambda planes
// triples a lambda side's shared-memory traffic (limb_core.cuh).
#include "limb_core.cuh"

namespace {

using limb::Cfg;

constexpr int max2(int a, int b) { return a > b ? a : b; }

// dynamic shared memory of a launch: the most any quadrant takes
template <typename W>
constexpr int kSmem = max2(max2(Cfg<W, 1, 1>::kSmem, Cfg<W, 3, 1>::kSmem),
                           max2(Cfg<W, 1, 3>::kSmem, Cfg<W, 3, 3>::kSmem));

// One 64 x 64 output tile of one quadrant and one K chunk per block.
template <typename W, bool kVec>
__global__ void __launch_bounds__(limb::kThreads<W>, 1)
mpc_matmul_fused_kernel(const W* __restrict__ mx, const W* __restrict__ lx,
                        const W* __restrict__ my, const W* __restrict__ ly,
                        W* __restrict__ out, int M, int N, int K,
                        int k_chunk, bool chunked) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int q = blockIdx.z & 3;
  const int kbeg = (blockIdx.z >> 2) * k_chunk;
  const int kend = min(K, kbeg + k_chunk);
  const int m0 = blockIdx.y * limb::kBM, n0 = blockIdx.x * limb::kBN;
  const int64_t pa = static_cast<int64_t>(M) * K;
  const int64_t pb = static_cast<int64_t>(K) * N;
  const int64_t pc = static_cast<int64_t>(M) * N;
  // quadrant q: A = q & 1 ? lxs : mx, B = q & 2 ? lys : my; into mm (q = 0),
  // cross (q = 1, 2) or gamma (q = 3)
  W* C = out + (q == 0 ? 0 : q == 3 ? 2 : 1) * pc;
  const bool acc = chunked || q == 1 || q == 2;
  switch (q) {
    case 0:
      limb::tile<W, kVec, 1, 1>(mx, 0, my, 0, C, M, N, K, m0, n0, kbeg, kend,
                                acc, smem);
      break;
    case 1:
      limb::tile<W, kVec, 3, 1>(lx, pa, my, 0, C, M, N, K, m0, n0, kbeg,
                                kend, acc, smem);
      break;
    case 2:
      limb::tile<W, kVec, 1, 3>(mx, 0, ly, pb, C, M, N, K, m0, n0, kbeg,
                                kend, acc, smem);
      break;
    default:
      limb::tile<W, kVec, 3, 3>(lx, pa, ly, pb, C, M, N, K, m0, n0, kbeg,
                                kend, acc, smem);
      break;
  }
}

template <typename W, bool kVec>
int launch_as(const W* mx, const W* lx, const W* my, const W* ly, W* out,
              int M, int N, int K, int k_chunk, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      mpc_matmul_fused_kernel<W, kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem<W>);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int chunks = (K + k_chunk - 1) / k_chunk;
  dim3 grid((N + limb::kBN - 1) / limb::kBN, (M + limb::kBM - 1) / limb::kBM,
            4 * chunks);
  mpc_matmul_fused_kernel<W, kVec><<<grid, limb::kThreads<W>, kSmem<W>,
                                     stream>>>(mx, lx, my, ly, out, M, N, K,
                                               k_chunk, chunks > 1);
  return static_cast<int>(cudaGetLastError());
}

// out (5, M, N) must be zeroed by the caller.
template <typename W>
int launch(const void* mx, const void* lx, const void* my, const void* ly,
           void* out, int M, int N, int K, int k_chunk, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return 0;
  if (k_chunk <= 0 || k_chunk > limb::kMaxKChunk<W> ||
      k_chunk % limb::kBK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const W* a = static_cast<const W*>(mx);
  const W* la = static_cast<const W*>(lx);
  const W* b = static_cast<const W*>(my);
  const W* lb = static_cast<const W*>(ly);
  constexpr int kPer = 16 / static_cast<int>(sizeof(W));
  // rows, and so the lambda planes (M K and K N words apart), 16-byte
  // aligned
  const bool vec = K % kPer == 0 && N % kPer == 0 && limb::aligned16(a) &&
                   limb::aligned16(la) && limb::aligned16(b) &&
                   limb::aligned16(lb);
  auto s = static_cast<cudaStream_t>(stream);
  W* o = static_cast<W*>(out);
  return vec ? launch_as<W, true>(a, la, b, lb, o, M, N, K, k_chunk, s)
             : launch_as<W, false>(a, la, b, lb, o, M, N, K, k_chunk, s);
}

}  // namespace

extern "C" int mpc_matmul_fused_u64(const void* mx, const void* lx,
                                    const void* my, const void* ly,
                                    void* out, int M, int N, int K,
                                    int k_chunk, void* stream) {
  return launch<uint64_t>(mx, lx, my, ly, out, M, N, K, k_chunk, stream);
}

extern "C" int mpc_matmul_fused_u32(const void* mx, const void* lx,
                                    const void* my, const void* ly,
                                    void* out, int M, int N, int K,
                                    int k_chunk, void* stream) {
  return launch<uint32_t>(mx, lx, my, ly, out, M, N, K, k_chunk, stream);
}
