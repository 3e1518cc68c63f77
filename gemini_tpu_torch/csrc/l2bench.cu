// Measurement kernels of benches/l2bench.py: the card's L2 read-write
// rate, and copy_add's other launch shapes.  Neither runs on a path of
// the port; both compute out = a + b on 16-byte vectors of uint32
// (wrapping), so their outputs are checked against copy_add's plain
// version.
//
//   l2bench_sweep  `reps` passes of out = a + b over the same nvec
//       vectors in one launch, `blocks` blocks of 256 threads striding
//       over them.  Loads and stores are ld/st.global.cg (cached in L2, not
//       in L1) and volatile, so every pass reaches the L2 and none is
//       folded away.  At a working set that fits the 50 MB L2, the bytes
//       of the passes over the kernel's time is the L2's read-write
//       rate, with the ramp of a short launch spread over all passes.
//   l2bench_copy_add  copy_add's kernel in other shapes: `vecs` (1, 2
//       or 4) 16-byte vectors per thread with all their loads issued
//       before the adds, `threads` per block, and either a grid that
//       covers the vectors once (`blocks` = 0) or `blocks` blocks that
//       stride over them.
//
// C interface for ctypes: device pointers (16-byte aligned), the count
// of 16-byte vectors, the shape, the CUDA stream; each returns
// cudaGetLastError() after the launch (0 = launched).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ uint4 ld_cg(const uint4* p) {
  uint4 r;
  asm volatile("ld.global.cg.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p));
  return r;
}

__device__ __forceinline__ void st_cg(uint4* p, uint4 v) {
  asm volatile("st.global.cg.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(p), "r"(v.x),
               "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ uint4 add4(uint4 x, uint4 y) {
  return make_uint4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
}

__global__ void sweep_kernel(const uint4* a, const uint4* b, uint4* out, long long nvec,
                             int reps) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long v0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (int r = 0; r < reps; ++r)
    for (long long v = v0; v < nvec; v += stride) st_cg(out + v, add4(ld_cg(a + v), ld_cg(b + v)));
}

template <int V>
__global__ void copy_add_shape_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b,
                                      uint4* __restrict__ out, long long nvec) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v0 = (long long)blockIdx.x * blockDim.x + threadIdx.x; v0 < nvec;
       v0 += V * stride) {
    uint4 x[V], y[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const long long v = v0 + i * stride;
      if (v < nvec) {
        x[i] = __ldg(a + v);
        y[i] = __ldg(b + v);
      }
    }
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const long long v = v0 + i * stride;
      if (v < nvec) out[v] = add4(x[i], y[i]);
    }
  }
}

}  // namespace

extern "C" int l2bench_sweep(const uint4* a, const uint4* b, uint4* out, long long nvec,
                             int reps, int blocks, void* stream) {
  if (nvec <= 0) return 0;
  sweep_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(a, b, out, nvec, reps);
  return (int)cudaGetLastError();
}

extern "C" int l2bench_copy_add(const uint4* a, const uint4* b, uint4* out, long long nvec,
                                int vecs, int threads, int blocks, void* stream) {
  if (nvec <= 0) return 0;
  if (blocks == 0) blocks = (int)((nvec + (long long)vecs * threads - 1) / ((long long)vecs * threads));
  cudaStream_t s = (cudaStream_t)stream;
  switch (vecs) {
    case 1: copy_add_shape_kernel<1><<<blocks, threads, 0, s>>>(a, b, out, nvec); break;
    case 2: copy_add_shape_kernel<2><<<blocks, threads, 0, s>>>(a, b, out, nvec); break;
    case 4: copy_add_shape_kernel<4><<<blocks, threads, 0, s>>>(a, b, out, nvec); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
