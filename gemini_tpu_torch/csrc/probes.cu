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
//       g1_mont_mul launches.
//
// One thread per element, 128-thread blocks.  C interface for ctypes:
// device pointers, the element count, the chain length where there is
// one and the CUDA stream; each returns cudaGetLastError() after the
// launch (0 = launched).

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

__global__ void __launch_bounds__(kThreads)
    copy_add_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                    uint32_t* __restrict__ out, long long n) {
  long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  out[j] = a[j] + b[j];
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
  copy_add_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(a, b, out, n);
  return (int)cudaGetLastError();
}
