// Grouped elementwise gamma-piece / online-part kernels for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/gamma_parts.py:mult_terms (_mult_terms_kernel)
// and :and_terms (_and_terms_kernel), both launched through _grouped_call.
//
//   mult_terms: out[j,i] = sum_t s_t * a[j,t,i] * b[j,t,i] + c[j,i]  mod 2^ell
//   and_terms:  out[j,i] = XOR_t (a[j,t,i] & b[j,t,i]) ^ c[j,i]
//
// a, b are (J, T, n) and c, out are (J, n), contiguous.  The signs s_t are
// a bitmask (bit t set = subtract).  Words are uint64_t or uint32_t, so the
// ring arithmetic wraps by the type.  One thread per output word reads each
// operand once and writes once, the fusion the TPU kernel was built for.
//
// Bound on the H100: bytes ((2T + 2) words moved per output word, a few
// integer operations each).  Left on the table: vector loads (two words per
// 16-byte access), and batching all parties' groups of a round into one
// launch (the runtime launches once per party per round).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <typename W>
__global__ void mult_terms_kernel(const W* __restrict__ a,
                                  const W* __restrict__ b,
                                  const W* __restrict__ c,
                                  W* __restrict__ out, int J, int T,
                                  int64_t n, uint32_t neg_mask) {
  int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<int64_t>(J) * n) return;
  int64_t j = idx / n;
  int64_t i = idx - j * n;
  W acc = c[idx];
  for (int t = 0; t < T; ++t) {
    int64_t k = (j * T + t) * n + i;
    W term = a[k] * b[k];
    acc = ((neg_mask >> t) & 1u) ? acc - term : acc + term;
  }
  out[idx] = acc;
}

template <typename W>
__global__ void and_terms_kernel(const W* __restrict__ a,
                                 const W* __restrict__ b,
                                 const W* __restrict__ c,
                                 W* __restrict__ out, int J, int T,
                                 int64_t n) {
  int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<int64_t>(J) * n) return;
  int64_t j = idx / n;
  int64_t i = idx - j * n;
  W acc = c[idx];
  for (int t = 0; t < T; ++t) {
    int64_t k = (j * T + t) * n + i;
    acc ^= a[k] & b[k];
  }
  out[idx] = acc;
}

constexpr int kThreads = 256;

inline unsigned blocks_for(int J, int64_t n) {
  return static_cast<unsigned>((static_cast<int64_t>(J) * n + kThreads - 1)
                               / kThreads);
}

template <typename W>
int launch_mult(const void* a, const void* b, const void* c, void* out,
                int J, int T, int64_t n, uint32_t neg_mask, void* stream) {
  if (J <= 0 || n <= 0) return 0;
  mult_terms_kernel<W><<<blocks_for(J, n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const W*>(a), static_cast<const W*>(b),
      static_cast<const W*>(c), static_cast<W*>(out), J, T, n, neg_mask);
  return static_cast<int>(cudaGetLastError());
}

template <typename W>
int launch_and(const void* a, const void* b, const void* c, void* out,
               int J, int T, int64_t n, void* stream) {
  if (J <= 0 || n <= 0) return 0;
  and_terms_kernel<W><<<blocks_for(J, n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const W*>(a), static_cast<const W*>(b),
      static_cast<const W*>(c), static_cast<W*>(out), J, T, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mult_terms_u64(const void* a, const void* b, const void* c,
                              void* out, int J, int T, int64_t n,
                              uint32_t neg_mask, void* stream) {
  return launch_mult<uint64_t>(a, b, c, out, J, T, n, neg_mask, stream);
}

extern "C" int mult_terms_u32(const void* a, const void* b, const void* c,
                              void* out, int J, int T, int64_t n,
                              uint32_t neg_mask, void* stream) {
  return launch_mult<uint32_t>(a, b, c, out, J, T, n, neg_mask, stream);
}

extern "C" int and_terms_u64(const void* a, const void* b, const void* c,
                             void* out, int J, int T, int64_t n,
                             void* stream) {
  return launch_and<uint64_t>(a, b, c, out, J, T, n, stream);
}

extern "C" int and_terms_u32(const void* a, const void* b, const void* c,
                             void* out, int J, int T, int64_t n,
                             void* stream) {
  return launch_and<uint32_t>(a, b, c, out, J, T, n, stream);
}
