// Counter-mode `squares` PRF (Widynski 2020) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/prf_mask.py:prf_mask (_squares_kernel), the
// Pallas kernel behind repro.kernels.ops.lambda_masks.
//
// out[i] = squares(key, counter0 + i): 4 rounds of x*x + (y|z) with a 32-bit
// rotate, then t ^ ((x*x + y) >> 32), all in uint64_t so every product wraps
// mod 2^64 and every right shift is logical.  The stream is indexed by
// counter, so one thread per output word needs no padding: the TPU kernel
// padded to its 512-word block, this one masks the ragged tail.
//
// Bound on the H100: bytes.  Each word is 8 bytes written and ~5 64-bit
// multiplies (a few 32-bit IMADs each), far under the compute the card has
// per byte of HBM traffic.  The runtime samples many small streams (one per
// lambda / zero-share draw), so at the main path's sizes the launch, not
// the work, sets the time.  Left on the table: fusing the draws of one
// protocol round into one launch (several keys, one grid), and writing
// 32-bit words directly for the 32-bit ring.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint64_t rot32(uint64_t v) {
  return (v >> 32) | (v << 32);
}

__global__ void squares_kernel(uint64_t* __restrict__ out, uint64_t key,
                               uint64_t counter0, int64_t n) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint64_t x = (counter0 + static_cast<uint64_t>(i)) * key;
  uint64_t y = x;
  uint64_t z = y + key;
  x = rot32(x * x + y);
  x = rot32(x * x + z);
  x = rot32(x * x + y);
  x = x * x + z;
  uint64_t t = x;
  x = rot32(x);
  out[i] = t ^ ((x * x + y) >> 32);
}

}  // namespace

extern "C" int prf_mask_u64(void* out, uint64_t key, uint64_t counter0,
                            int64_t n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  squares_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint64_t*>(out), key, counter0, n);
  return static_cast<int>(cudaGetLastError());
}
