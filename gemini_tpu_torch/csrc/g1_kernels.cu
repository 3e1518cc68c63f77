// Hand-written Hopper kernels for the G1 group law and the Fq Montgomery
// product: the port of the three Pallas kernels on the SNARK's main path.
//
//   g1_padd      replaces gemini_tpu/curve/pallas_g1.py `_padd_kernel`
//                (complete RCB projective add, Renes-Costello-Batina
//                Alg. 7, b3 = 12; 12 Montgomery products, three of the
//                product pairs sharing one reduction; relaxed [0, 2p)).
//   g1_padd01    replaces `_padd01_kernel` (the same add for operands
//                with z in {0, 1} given as masks; 9 products).
//   g1_mont_mul  replaces `_mm_kernel` (canonical a*b*2^-384 mod p), the
//                core the other two share.
//
// Layout: every coordinate is a (24, n) int32 tensor of 16-bit limbs,
// masks are (n,) int32 (nonzero = live).  One thread per lane; limbs
// are repacked into 12 32-bit words in registers (fq.cuh).
//
// What bounds them on an H100: 32-bit integer multiply-add issue.  A
// 12-word product is 144 32x32->64 word products and a word-serial REDC
// another 144, so a padd issues 21 * 144 word products (12 products + 9
// reductions), a padd01 15 * 144 and a mont_mul 2 * 144, each two IMADs
// (low and high word) at half the float32 FMA rate.  Memory is the
// smaller bound: a padd moves 864 bytes per lane (6 coordinates in, 3
// out).  This first design is the plain one: the whole add lives in one
// thread's registers (no intermediate leaves the SM), schoolbook
// products with 64-bit accumulators, and selects instead of branches, so
// warps never diverge on identity or doubling lanes.  Karatsuba, wgmma
// or batched-affine adds are later work.

#include <cuda_runtime.h>

#include "fq.cuh"

using fq::F;

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    mont_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                    int32_t* __restrict__ out, long long n) {
  long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  fq::store(out, n, j, fq::mm(fq::load(a, n, j), fq::load(b, n, j)));
}

// _padd_core: the same formula, the same order of operations.
__global__ void __launch_bounds__(kThreads)
    padd_kernel(const int32_t* __restrict__ px1, const int32_t* __restrict__ py1,
                const int32_t* __restrict__ pz1, const int32_t* __restrict__ px2,
                const int32_t* __restrict__ py2, const int32_t* __restrict__ pz2,
                int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                int32_t* __restrict__ oz, long long n) {
  long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const F x1 = fq::load(px1, n, j), y1 = fq::load(py1, n, j), z1 = fq::load(pz1, n, j);
  const F x2 = fq::load(px2, n, j), y2 = fq::load(py2, n, j), z2 = fq::load(pz2, n, j);
  F t0 = fq::rmm(x1, x2);
  F t1 = fq::rmm(y1, y2);
  F t2 = fq::rmm(z1, z2);
  F t3 = fq::rmm(fq::radd(x1, y1), fq::radd(x2, y2));
  t3 = fq::rsub(fq::rsub(t3, t0), t1);  // x1y2 + x2y1
  F t4 = fq::rmm(fq::radd(y1, z1), fq::radd(y2, z2));
  t4 = fq::rsub(fq::rsub(t4, t1), t2);  // y1z2 + y2z1
  F x3 = fq::rmm(fq::radd(x1, z1), fq::radd(x2, z2));
  F y3 = fq::rsub(fq::rsub(x3, t0), t2);  // x1z2 + x2z1
  t0 = fq::radd(fq::radd(t0, t0), t0);    // 3 x1x2
  t2 = fq::rmul12(t2);                    // b3 z1z2
  F z3 = fq::radd(t1, t2);
  t1 = fq::rsub(t1, t2);
  y3 = fq::rmul12(y3);  // b3 (x1z2 + x2z1)
  fq::store(ox, n, j, fq::rmm_sub(t3, t1, t4, y3));
  fq::store(oy, n, j, fq::rmm_add(t1, z3, y3, t0));
  fq::store(oz, n, j, fq::rmm_add(z3, t4, t0, t3));
}

// _padd01_core: z1, z2 in {0, 1} from the masks; dead lanes are (0 : y : 0).
__global__ void __launch_bounds__(kThreads)
    padd01_kernel(const int32_t* __restrict__ px1, const int32_t* __restrict__ py1,
                  const int32_t* __restrict__ pm1, const int32_t* __restrict__ px2,
                  const int32_t* __restrict__ py2, const int32_t* __restrict__ pm2,
                  int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                  int32_t* __restrict__ oz, long long n) {
  long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const F x1 = fq::load(px1, n, j), y1 = fq::load(py1, n, j);
  const F x2 = fq::load(px2, n, j), y2 = fq::load(py2, n, j);
  const bool live1 = pm1[j] != 0, live2 = pm2[j] != 0;
  const F zero = fq::zero();
  F t0 = fq::rmm(x1, x2);
  F t1 = fq::rmm(y1, y2);
  F t3 = fq::rmm(fq::radd(x1, y1), fq::radd(x2, y2));
  t3 = fq::rsub(fq::rsub(t3, t0), t1);  // x1y2 + x2y1
  F t4 = fq::radd(fq::select(live2, y1, zero), fq::select(live1, y2, zero));
  F y3 = fq::radd(fq::select(live2, x1, zero), fq::select(live1, x2, zero));
  t0 = fq::radd(fq::radd(t0, t0), t0);  // 3 x1x2
  F twelve;
#pragma unroll
  for (int k = 0; k < fq::NW; ++k) twelve.w[k] = (live1 && live2) ? fq::TWELVE_M[k] : 0u;
  F z3 = fq::radd(t1, twelve);
  t1 = fq::rsub(t1, twelve);
  y3 = fq::rmul12(y3);  // b3 (x1z2 + x2z1)
  fq::store(ox, n, j, fq::rmm_sub(t3, t1, t4, y3));
  fq::store(oy, n, j, fq::rmm_add(t1, z3, y3, t0));
  fq::store(oz, n, j, fq::rmm_add(z3, t4, t0, t3));
}

unsigned blocks_for(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

// C interface for ctypes: pointers to contiguous int32 device tensors,
// the lane count and the CUDA stream.  Each returns cudaGetLastError()
// right after the launch (0 = launched).

extern "C" int g1_mont_mul(const int32_t* a, const int32_t* b, int32_t* out,
                           long long n, void* stream) {
  if (n <= 0) return 0;
  mont_mul_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(a, b, out, n);
  return (int)cudaGetLastError();
}

extern "C" int g1_padd(const int32_t* x1, const int32_t* y1, const int32_t* z1,
                       const int32_t* x2, const int32_t* y2, const int32_t* z2,
                       int32_t* ox, int32_t* oy, int32_t* oz, long long n,
                       void* stream) {
  if (n <= 0) return 0;
  padd_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      x1, y1, z1, x2, y2, z2, ox, oy, oz, n);
  return (int)cudaGetLastError();
}

extern "C" int g1_padd01(const int32_t* x1, const int32_t* y1, const int32_t* m1,
                         const int32_t* x2, const int32_t* y2, const int32_t* m2,
                         int32_t* ox, int32_t* oy, int32_t* oz, long long n,
                         void* stream) {
  if (n <= 0) return 0;
  padd01_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      x1, y1, m1, x2, y2, m2, ox, oy, oz, n);
  return (int)cudaGetLastError();
}
