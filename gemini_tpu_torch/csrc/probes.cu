// Hand-written Hopper kernels for the two benchmark probes (the port of
// the Pallas kernels of benches/vpubench.py and benches/mmbench.py).
//
//   vpu_chain_u32 / vpu_chain_f32  replace benches/vpubench.py
//       `make_kernel`: K dependent `acc = acc * b + a` per element on a
//       (ROWS, n) block, in wrapping 32-bit unsigned arithmetic (one IMAD
//       each) or in float32 (one FFMA each).  a and b are read from
//       memory per element and every element stores its final acc, so
//       the compiler cannot fold or drop the chain; the loop count is a
//       run-time argument.  Bound by multiply-add issue: the marginal
//       time between K/4 and K gives the card's int32 IMAD (or FFMA)
//       rate, the denominator of the group-law kernels' operations
//       bounds.
//   copy_add  replaces benches/mmbench.py `_copy_kernel`: o = a + b on
//       (24, n) int32 limbs (wrapping).  A chain of such launches at
//       2^16 lanes is bound by launch latency plus 3 * 96 bytes per
//       lane; it isolates the per-launch cost beside a chain of
//       g1_mont_mul launches.  Bound by bytes: at mmbench's 24 x 2^16
//       limbs the 18.9 MB stay in the 50 MB L2 from launch to launch, at
//       24 x 2^20 (302 MB) they stream from HBM.  So the kernel issues
//       16-byte accesses (a quarter of the load and store instructions
//       and L2 requests of 4-byte ones), one vector per thread in
//       128-thread blocks, a block per 512 elements; an odd count is
//       handled inside (a scalar tail), and an operand that is not
//       16-byte aligned is read word by word.  benches/l2bench.py times
//       the other launch shapes (2 or 4 vectors per thread with their
//       loads issued before the adds, 256 or 512 threads, a grid of one
//       wave of resident blocks striding over the vectors) beside this
//       one.
//
// vpu_chain runs one thread per element in 128-thread blocks.  C
// interface for ctypes: device pointers, the element count, the chain
// length where there is one and the CUDA stream; each returns
// cudaGetLastError() after the launch (0 = launched).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;

template <typename T>
__device__ __forceinline__ T mul_add(T acc, T b, T a) {
  return acc * b + a;
}

template <>
__device__ __forceinline__ float mul_add<float>(float acc, float b, float a) {
  return __fmaf_rn(acc, b, a);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    vpu_chain_kernel(const T* __restrict__ a, const T* __restrict__ b,
                     T* __restrict__ out, long long n, int k) {
  long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const T av = a[j], bv = b[j];
  T acc = av;
  // Unrolled by 32: the loop's own 3 instructions per 32 multiply-adds
  // leave the issue slots to the chain.
#pragma unroll 32
  for (int i = 0; i < k; ++i) acc = mul_add(acc, bv, av);
  out[j] = acc;
}

// Four words at p: one 16-byte load where p is 16-byte aligned (`vec`,
// the same for every thread of a launch), else four 4-byte loads.
__device__ __forceinline__ uint4 load4(const uint32_t* __restrict__ p, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
  return make_uint4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

// out = a + b: one 16-byte vector of out per thread, and a scalar tail
// for a count that is not a multiple of 4.  out is the wrapper's fresh
// allocation, so 16-byte aligned; a and b are read as vectors where they
// are 16-byte aligned, else word by word.
__global__ void __launch_bounds__(kThreads)
    copy_add_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                    uint32_t* __restrict__ out, long long n) {
  const long long nvec = n >> 2;
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v < (n & 3)) out[4 * nvec + v] = a[4 * nvec + v] + b[4 * nvec + v];
  if (v >= nvec) return;
  const uint4 x = load4(a + 4 * v, ((uintptr_t)a & 15u) == 0);
  const uint4 y = load4(b + 4 * v, ((uintptr_t)b & 15u) == 0);
  reinterpret_cast<uint4*>(out)[v] =
      make_uint4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
}

unsigned blocks_for(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int probe_vpu_chain_u32(const uint32_t* a, const uint32_t* b, uint32_t* out,
                                   long long n, int k, void* stream) {
  if (n <= 0) return 0;
  vpu_chain_kernel<uint32_t><<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      a, b, out, n, k);
  return (int)cudaGetLastError();
}

extern "C" int probe_vpu_chain_f32(const float* a, const float* b, float* out,
                                   long long n, int k, void* stream) {
  if (n <= 0) return 0;
  vpu_chain_kernel<float><<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      a, b, out, n, k);
  return (int)cudaGetLastError();
}

extern "C" int probe_copy_add(const uint32_t* a, const uint32_t* b, uint32_t* out,
                              long long n, void* stream) {
  if (n <= 0) return 0;
  // a thread per 16-byte vector (at least 3 threads for the tail)
  copy_add_kernel<<<blocks_for((n + 3) / 4), kThreads, 0, (cudaStream_t)stream>>>(
      a, b, out, n);
  return (int)cudaGetLastError();
}
