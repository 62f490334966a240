// Ring matmul C = A @ B mod 2^ell (ell = 64 or 32) on Hopper's int8 tensor
// cores (sm_90a).
//
// Replaces: src/repro/kernels/limb_matmul.py:79 limb_matmul (_limb_kernel at
// :38: 4-bit limbs in f32 on the MXU), and through the stacked call
// src/repro/kernels/mpc_matmul_fused.py:46 mpc_matmul_grid, which is this
// kernel launched once on row- and column-stacked operands.
//
// The work is limb_core.cuh's with one plane a side: 8-bit limbs, the limb
// pairs that survive mod 2^ell as `wgmma` u8 x u8 -> s32 products, K
// chunks of at most 4,128 words (ell = 64) so every s32 sum stays exact,
// and the chunks' partial tiles meeting in C by atomicAdd.  A block owns a
// 64 x 64 output tile and one K chunk; the main path's products are short
// in M x N and long in K, so the wrapper splits K into chunks until the
// grid has about one block per SM.  The main path's longest K
// (3 * 784 = 2,352) fits one chunk.
//
// Bound on the H100: at 128x2352x128, the bytes (4.95 MB over 3.35 TB/s,
// 1.48 us) and the limb-pair int8 operations (36 * 2 * M * N * K = 2.77 G
// over 1,979 TOP/s, 1.40 us) about equally; at 384x784x384 the operations
// (8.32 G, 4.21 us).  What holds the design back is shared memory (see
// limb_core.cuh).
//
// The same kernel runs a batch of products C[i] = A[i] @ B[i]
// (ring_matmul_batched_*; a 2-D product is a batch of one): the batch
// index and the K chunk share blockIdx.z (batch x chunks, at most
// 65,535), each operand steps by its own batch stride in words (0 for an
// operand broadcast over the batch) and C by M x N.  It carries the LM
// stack's products that jnp.matmul computes outside any Pallas kernel in
// the JAX package (src/repro/core/protocols.py:189): attention scores and
// probs @ v (B, H, S, dh) @ (B, H, dh, S_k), and the MoE experts' (E, C,
// D) @ (E, D, F).  A decode step's (B, H, 1, dh) @ (B, H, dh, S + 1) fills
// 1 row of a 64-row tile.
#include "limb_core.cuh"

namespace {

using limb::Cfg;

// One 64 x 64 output tile of one product and one K chunk per block.
template <typename W, bool kVec>
__global__ void __launch_bounds__(limb::kThreads<W>, 1)
ring_matmul_kernel(const W* __restrict__ A, const W* __restrict__ B,
                   W* __restrict__ C, int M, int N, int K, int k_chunk,
                   int chunks, int64_t a_batch, int64_t b_batch,
                   bool accumulate) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int64_t batch = blockIdx.z / chunks;
  const int kbeg = (blockIdx.z % chunks) * k_chunk;
  limb::tile<W, kVec, 1, 1>(A + batch * a_batch, 0, B + batch * b_batch, 0,
                            C + batch * M * N, M, N, K,
                            blockIdx.y * limb::kBM, blockIdx.x * limb::kBN,
                            kbeg, min(K, kbeg + k_chunk), accumulate, smem);
}

template <typename W, bool kVec>
int launch_as(const W* A, const W* B, W* C, int batch, int M, int N, int K,
              int k_chunk, int64_t a_batch, int64_t b_batch,
              cudaStream_t stream) {
  constexpr int kSmem = Cfg<W, 1, 1>::kSmem;
  static const cudaError_t attr = cudaFuncSetAttribute(
      ring_matmul_kernel<W, kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int chunks = (K + k_chunk - 1) / k_chunk;
  if (static_cast<int64_t>(batch) * chunks > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  dim3 grid((N + limb::kBN - 1) / limb::kBN, (M + limb::kBM - 1) / limb::kBM,
            batch * chunks);
  ring_matmul_kernel<W, kVec><<<grid, limb::kThreads<W>, kSmem, stream>>>(
      A, B, C, M, N, K, k_chunk, chunks, a_batch, b_batch, chunks > 1);
  return static_cast<int>(cudaGetLastError());
}

// C (batch x M x N) must be zeroed by the caller when K spans more than
// one chunk.  a_batch / b_batch: words from one product's operand to the
// next (0: the same operand for every product).
template <typename W>
int launch(const void* A, const void* B, void* C, int batch, int M, int N,
           int K, int k_chunk, int64_t a_batch, int64_t b_batch,
           void* stream) {
  if (batch <= 0 || M <= 0 || N <= 0 || K <= 0) return 0;
  if (k_chunk <= 0 || k_chunk > limb::kMaxKChunk<W> ||
      k_chunk % limb::kBK != 0 || a_batch < 0 || b_batch < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const W* a = static_cast<const W*>(A);
  const W* b = static_cast<const W*>(B);
  constexpr int kPer = 16 / static_cast<int>(sizeof(W));
  const bool vec = K % kPer == 0 && N % kPer == 0 && a_batch % kPer == 0 &&
                   b_batch % kPer == 0 && limb::aligned16(a) &&
                   limb::aligned16(b);
  auto s = static_cast<cudaStream_t>(stream);
  return vec ? launch_as<W, true>(a, b, static_cast<W*>(C), batch, M, N, K,
                                  k_chunk, a_batch, b_batch, s)
             : launch_as<W, false>(a, b, static_cast<W*>(C), batch, M, N, K,
                                   k_chunk, a_batch, b_batch, s);
}

}  // namespace

// C = A @ B, (M, K) @ (K, N): a batch of one.
extern "C" int ring_matmul_u64(const void* A, const void* B, void* C, int M,
                               int N, int K, int k_chunk, void* stream) {
  return launch<uint64_t>(A, B, C, 1, M, N, K, k_chunk, 0, 0, stream);
}

extern "C" int ring_matmul_u32(const void* A, const void* B, void* C, int M,
                               int N, int K, int k_chunk, void* stream) {
  return launch<uint32_t>(A, B, C, 1, M, N, K, k_chunk, 0, 0, stream);
}

extern "C" int ring_matmul_batched_u64(const void* A, const void* B, void* C,
                                       int batch, int M, int N, int K,
                                       int k_chunk, int64_t a_batch,
                                       int64_t b_batch, void* stream) {
  return launch<uint64_t>(A, B, C, batch, M, N, K, k_chunk, a_batch, b_batch,
                          stream);
}

extern "C" int ring_matmul_batched_u32(const void* A, const void* B, void* C,
                                       int batch, int M, int N, int K,
                                       int k_chunk, int64_t a_batch,
                                       int64_t b_batch, void* stream) {
  return launch<uint32_t>(A, B, C, batch, M, N, K, k_chunk, a_batch, b_batch,
                          stream);
}
