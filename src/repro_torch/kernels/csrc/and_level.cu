// One boolean AND level of the joint simulation, fused, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ppa_msb.py:and_level (_and_level_kernel), and
// through it the per-level work of src/repro/kernels/ppa_msb.py:ppa_msb,
// whose Python loop (kernels/ppa_msb.py) launches this kernel per level.
//
// On bit-sliced words, for share stacks x, y = (m, l1, l2, l3), fresh output
// lambdas lamz = (z1, z2, z3) and Pi_Zero shares zero = (s0, s1, s2):
//
//   g1 = l1x&l1y ^ l1x&l2y ^ l2x&l1y ^ s2        (Fig. 4's gamma split)
//   g2 = l2x&l2y ^ l2x&l3y ^ l3x&l2y ^ s0
//   g3 = l3x&l3y ^ l3x&l1y ^ l1x&l3y ^ s1
//   p_i = lix&my ^ mx&liy ^ g_i ^ z_i             (the three m_z' parts)
//   out = (p1 ^ p2 ^ p3 ^ mx&my, z1, z2, z3)
//
// x, y, out are (4, n), lamz and zero (3, n), all contiguous.  A null
// `zero` stands for zero shares (the component-collapsed joint world, where
// g1 ^ g2 ^ g3 = lx_sum & ly_sum).  Words are uint64_t or uint32_t.
//
// Design: one thread per word reads the 14 input planes once and writes the
// 4 output planes once (no padding: the grid masks its own tail) -- the
// fusion the TPU kernel was built for, keeping the ~25 intermediate word ops
// in registers.
//
// Bound on the H100: bytes (18 words per element, 144 B at ell = 64, for
// about 30 integer operations).  Left on the table: 16-byte vector loads, and
// the launch itself -- at the main path's n = 128 the kernel is launch bound.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <typename W>
__global__ void and_level_kernel(const W* __restrict__ x,
                                 const W* __restrict__ y,
                                 const W* __restrict__ lamz,
                                 const W* __restrict__ zero,
                                 W* __restrict__ out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  const W mx = x[i], lx1 = x[n + i], lx2 = x[2 * n + i], lx3 = x[3 * n + i];
  const W my = y[i], ly1 = y[n + i], ly2 = y[2 * n + i], ly3 = y[3 * n + i];
  const W z1 = lamz[i], z2 = lamz[n + i], z3 = lamz[2 * n + i];
  W s0 = 0, s1 = 0, s2 = 0;
  if (zero != nullptr) {
    s0 = zero[i];
    s1 = zero[n + i];
    s2 = zero[2 * n + i];
  }
  const W g1 = (lx1 & ly1) ^ (lx1 & ly2) ^ (lx2 & ly1) ^ s2;
  const W g2 = (lx2 & ly2) ^ (lx2 & ly3) ^ (lx3 & ly2) ^ s0;
  const W g3 = (lx3 & ly3) ^ (lx3 & ly1) ^ (lx1 & ly3) ^ s1;
  const W p1 = (lx1 & my) ^ (mx & ly1) ^ g1 ^ z1;
  const W p2 = (lx2 & my) ^ (mx & ly2) ^ g2 ^ z2;
  const W p3 = (lx3 & my) ^ (mx & ly3) ^ g3 ^ z3;
  out[i] = p1 ^ p2 ^ p3 ^ (mx & my);
  out[n + i] = z1;
  out[2 * n + i] = z2;
  out[3 * n + i] = z3;
}

constexpr int kThreads = 256;

template <typename W>
int launch(const void* x, const void* y, const void* lamz, const void* zero,
           void* out, int64_t n, void* stream) {
  if (n <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) /
                                                kThreads);
  and_level_kernel<W><<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const W*>(x), static_cast<const W*>(y),
      static_cast<const W*>(lamz), static_cast<const W*>(zero),
      static_cast<W*>(out), n);
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
