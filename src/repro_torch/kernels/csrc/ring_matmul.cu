// Ring matmul C = A @ B mod 2^ell (ell = 64 or 32) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/limb_matmul.py:limb_matmul (_limb_kernel),
// and through it src/repro/kernels/mpc_matmul_fused.py:mpc_matmul_grid,
// which is this kernel launched once on row- and column-stacked operands.
//
// The TPU kernel split each word into 4-bit limbs so the MXU's float
// matmul could carry the products exactly.  This first Hopper version needs
// no limbs: CUDA cores multiply-add uint64_t / uint32_t natively (64-bit as
// a few 32-bit IMADs), and the unsigned type wraps mod 2^ell, so the result
// is exact by construction.
//
// Design: a shared-memory tiled GEMM.  Each 256-thread block owns a 64x64
// output tile (4x4 words per thread, strided by 16 so shared-memory reads are
// conflict-free) and walks one chunk of K in steps of 16.  The main path's
// products are small in M x N (128 x 128 at most) and long in K (up to
// 3 * 784), so K is split into chunks that fill the card with blocks; the
// chunks' partial tiles meet in C by atomicAdd, which is exact and
// order-independent because ring addition is associative and commutative.
// One chunk writes C directly.
//
// Bound on the H100: integer multiply-adds (2*M*N*K operations) at the
// product sizes of the main path, bytes below them.  The card has no 64-bit
// integer multiplier, so this kernel runs far under its tensor-core peak.
// Left on the table: the tensor-core design -- 8-bit limbs through
// mma/wgmma u8 x u8 -> s32 (36 limb pairs below 2^64 for ell = 64, K chunks
// with 255^2 * K < 2^31 so every s32 accumulation stays exact), a
// combine step folding the limb-pair products back mod 2^ell.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kTM = 4;
constexpr int kTN = 4;
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);   // 256

__device__ __forceinline__ void atomic_add_word(uint64_t* p, uint64_t v) {
  atomicAdd(reinterpret_cast<unsigned long long*>(p),
            static_cast<unsigned long long>(v));
}

__device__ __forceinline__ void atomic_add_word(uint32_t* p, uint32_t v) {
  atomicAdd(reinterpret_cast<unsigned int*>(p), static_cast<unsigned int>(v));
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
ring_matmul_kernel(const W* __restrict__ A, const W* __restrict__ B,
                   W* __restrict__ C, int M, int N, int K, int k_chunk,
                   bool accumulate) {
  __shared__ W As[kBK][kBM + 1];     // A tile, transposed; +1 breaks conflicts
  __shared__ W Bs[kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);
  const int ty = tid / (kBN / kTN);
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  const int kbeg = blockIdx.z * k_chunk;
  const int kend = min(K, kbeg + k_chunk);

  W acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = W(0);

  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
    for (int idx = tid; idx < kBM * kBK; idx += kThreads) {
      const int r = idx / kBK, c = idx % kBK;
      const int gr = row0 + r, gk = k0 + c;
      As[c][r] = (gr < M && gk < kend)
                     ? A[static_cast<int64_t>(gr) * K + gk] : W(0);
    }
    for (int idx = tid; idx < kBK * kBN; idx += kThreads) {
      const int r = idx / kBN, c = idx % kBN;
      const int gk = k0 + r, gc = col0 + c;
      Bs[r][c] = (gk < kend && gc < N)
                     ? B[static_cast<int64_t>(gk) * N + gc] : W(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      W a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c >= N) continue;
      W* dst = C + static_cast<int64_t>(r) * N + c;
      if (accumulate) {
        atomic_add_word(dst, acc[i][j]);
      } else {
        *dst = acc[i][j];
      }
    }
  }
}

// C must be zeroed by the caller when K spans more than one chunk.
template <typename W>
int launch(const void* A, const void* B, void* C, int M, int N, int K,
           int k_chunk, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return 0;
  if (k_chunk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (K + k_chunk - 1) / k_chunk;
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, chunks);
  ring_matmul_kernel<W><<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const W*>(A), static_cast<const W*>(B),
      static_cast<W*>(C), M, N, K, k_chunk, chunks > 1);
  return static_cast<int>(cudaGetLastError());
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
