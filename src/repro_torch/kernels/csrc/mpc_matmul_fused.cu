// Fused secure-matmul local products of the collapsed joint simulation, for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/mpc_matmul_fused.py:mpc_matmul_fused, the 2x2
// case of the all-pairs limb pass over (m_x, lam_x_sum) x (m_y, lam_y_sum).
//
// From mx (M, K), lx (3, M, K), my (K, N), ly (3, K, N) it computes, mod
// 2^ell,
//
//   out[0] = mm    = mx @ my
//   out[1] = cross = lxs @ my + mx @ lys
//   out[2] = gamma = lxs @ lys
//
// with lxs = lx[0] + lx[1] + lx[2] and lys = ly[0] + ly[1] + ly[2]; out is
// (3, M, N).  Words are uint64_t or uint32_t, so every product and sum wraps
// by the type and the result is exact.
//
// Design: ring_matmul.cu's shared-memory tiled GEMM, widened to four operand
// tiles.  Each 256-thread block owns a 64x64 output tile of all three
// products (4x4 words per thread, three accumulators each) and walks one
// chunk of K in steps of 16, loading per step the tiles of mx, lxs (summed
// from the three lambda planes as the tile is loaded, so the sums never go
// to device memory), my and lys: each operand is read once per output tile,
// where three separate products would read mx and my twice.  As in
// ring_matmul.cu, K is split into chunks that fill the card with blocks and
// the chunks' partial tiles meet in the output by atomicAdd -- exact and
// order-free because ring addition is.
//
// Bound on the H100: integer multiply-adds (8*M*N*K operations: four
// products, two of them into one accumulator) against the 8 operand planes
// read once and 3 output planes written once; at the main path's
// 128x784x128 the bytes (6.82 MB) bound it.  The card has no 64-bit integer
// multiplier on its tensor cores; the limb design of the ring matmul's later
// work applies here too.
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
mpc_matmul_fused_kernel(const W* __restrict__ mx, const W* __restrict__ lx,
                        const W* __restrict__ my, const W* __restrict__ ly,
                        W* __restrict__ out, int M, int N, int K,
                        int k_chunk, bool accumulate) {
  // A-side tiles transposed; +1 breaks shared-memory bank conflicts
  __shared__ W Ms[kBK][kBM + 1];     // mx
  __shared__ W Ls[kBK][kBM + 1];     // lx_sum
  __shared__ W Bs[kBK][kBN];         // my
  __shared__ W Rs[kBK][kBN];         // ly_sum

  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);
  const int ty = tid / (kBN / kTN);
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  const int kbeg = blockIdx.z * k_chunk;
  const int kend = min(K, kbeg + k_chunk);
  const int64_t plane_a = static_cast<int64_t>(M) * K;
  const int64_t plane_b = static_cast<int64_t>(K) * N;

  W mm[kTM][kTN], cross[kTM][kTN], gamma[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      mm[i][j] = W(0);
      cross[i][j] = W(0);
      gamma[i][j] = W(0);
    }

  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
    for (int idx = tid; idx < kBM * kBK; idx += kThreads) {
      const int r = idx / kBK, c = idx % kBK;
      const int gr = row0 + r, gk = k0 + c;
      W m = W(0), l = W(0);
      if (gr < M && gk < kend) {
        const int64_t off = static_cast<int64_t>(gr) * K + gk;
        m = mx[off];
        l = lx[off] + lx[plane_a + off] + lx[2 * plane_a + off];
      }
      Ms[c][r] = m;
      Ls[c][r] = l;
    }
    for (int idx = tid; idx < kBK * kBN; idx += kThreads) {
      const int r = idx / kBN, c = idx % kBN;
      const int gk = k0 + r, gc = col0 + c;
      W m = W(0), l = W(0);
      if (gk < kend && gc < N) {
        const int64_t off = static_cast<int64_t>(gk) * N + gc;
        m = my[off];
        l = ly[off] + ly[plane_b + off] + ly[2 * plane_b + off];
      }
      Bs[r][c] = m;
      Rs[r][c] = l;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      W a[kTM], la[kTM], b[kTN], lb[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        a[i] = Ms[kk][ty + 16 * i];
        la[i] = Ls[kk][ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        b[j] = Bs[kk][tx + 16 * j];
        lb[j] = Rs[kk][tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          mm[i][j] += a[i] * b[j];
          cross[i][j] += la[i] * b[j] + a[i] * lb[j];
          gamma[i][j] += la[i] * lb[j];
        }
    }
    __syncthreads();
  }

  const int64_t plane_c = static_cast<int64_t>(M) * N;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c >= N) continue;
      W* dst = out + static_cast<int64_t>(r) * N + c;
      if (accumulate) {
        atomic_add_word(dst, mm[i][j]);
        atomic_add_word(dst + plane_c, cross[i][j]);
        atomic_add_word(dst + 2 * plane_c, gamma[i][j]);
      } else {
        dst[0] = mm[i][j];
        dst[plane_c] = cross[i][j];
        dst[2 * plane_c] = gamma[i][j];
      }
    }
  }
}

// out must be zeroed by the caller when K spans more than one chunk.
template <typename W>
int launch(const void* mx, const void* lx, const void* my, const void* ly,
           void* out, int M, int N, int K, int k_chunk, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return 0;
  if (k_chunk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (K + k_chunk - 1) / k_chunk;
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, chunks);
  mpc_matmul_fused_kernel<W><<<grid, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const W*>(mx), static_cast<const W*>(lx),
      static_cast<const W*>(my), static_cast<const W*>(ly),
      static_cast<W*>(out), M, N, K, k_chunk, chunks > 1);
  return static_cast<int>(cudaGetLastError());
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
