// Hand-written Hopper kernels for the G1 group law and the Fq Montgomery
// product: the port of the five Pallas kernels of
// gemini_tpu/curve/pallas_g1.py (padd, padd01 and add redesigned for
// the H100, mont_mul and dbl sharing their field core).
//
//   g1_padd      replaces gemini_tpu/curve/pallas_g1.py `_padd_kernel`
//                (complete RCB projective add, Renes-Costello-Batina
//                Alg. 7, b3 = 12; 12 Montgomery products, three of the
//                product pairs sharing one reduction; relaxed [0, 2p)).
//   g1_padd01    replaces `_padd01_kernel` (the same add for operands
//                with z in {0, 1} given as masks; 9 products).
//   g1_mont_mul  replaces `_mm_kernel` (canonical a*b*2^-384 mod p), the
//                core the other two share.
//   g1_add       replaces `_add_kernel` (complete Jacobian add-2007-bl;
//                where h = r = 0 the dbl-2009-l result; then the
//                identity selects on z1 = 0 and z2 = 0, in that order),
//                redesigned: 16 relaxed products, 15 reductions.
//   g1_dbl       replaces `_dbl_kernel` (Jacobian dbl-2009-l, 7
//                canonical products).
//
// Layout: every coordinate is (24, *batch) int32 16-bit limbs.  padd,
// padd01 and add read their operands as the MSM hands them (halves of a
// (24, W, n) tensor, stride-2 even/odd views, the SRS tree's transposed
// halves; bool masks as they are) through a (limb, row, lane) stride
// triple per operand, so no copy runs before them, and write their
// outputs the same way (the stop-level scan's even and odd slots of one
// buffer, ops/ec_scan.py); outputs must not overlap the operands.  The
// bodies of padd and add are g1_core.cuh's, which the MSM walk-down
// (msm_kernels.cu) shares.  mont_mul and dbl take contiguous (24, n).
// One thread per lane; limbs are repacked into 12 32-bit words in
// registers (fq.cuh).  padd and padd01 select instead of branching, so
// their warps never diverge; add branches on rare lanes (below).
//
// What bounds them on an H100: 32-bit integer multiply-add issue.  A
// 12-word product is 144 32x32->64 word products and a word-serial REDC
// another 144, so a padd issues 21 * 144 word products (12 products + 9
// reductions), a padd01 15 * 144 and a mont_mul 2 * 144, each two IMADs
// (low and high word) at half the float32 FMA rate: the data sheet's
// 16.75 T IMAD/s.  Memory is the smaller bound: a padd moves 864 bytes
// per lane (6 coordinates in, 3 out), 71% of its operations bound.
//
// The design (padd and padd01; mont_mul, add and dbl share the core,
// add's own design is below):
// - fq.cuh's Montgomery core runs CIOS on the carry flag, so each word
//   product is one IMAD.WIDE.U32(.X) and the instruction count is close
//   to the bound's (chip_smoke.py's `sass` line: padd 5680 instructions,
//   3000 of them wide multiply-adds for its 3024 word products; the
//   first design's C u64 arithmetic compiled to 15952).
// - Register budget: __launch_bounds__(128, 3) for padd (168 registers,
//   12 warps per SM), (128, 4) for padd01 (128 registers, 16 warps), no
//   spills.  At two blocks padd needed more registers and ran slower; at
//   four it spilled.  The products' order is free where they are
//   independent (each relaxed value still comes out of the reference's
//   sequence of field ops), so padd loads z last and, in its last three
//   products, parks t1, t4 and t0 in shared memory as word operands
//   (mont_core reads them one word per step); the lane index is read
//   again before the stores.
// - Launch shape from the lane count (threads_for): 128-thread blocks,
//   or fewer (a multiple of 32) when n < 128 x SMs, so a small launch
//   puts one block on every SM.  Up to 2^14 lanes (most of the prove's
//   launches) a lone warp per scheduler runs one thread's dependent
//   chain: there the time is latency, not issue.
// Considered and not used:
// - Tensor cores (the TPU kernel's redc_mxu runs REDC's two
//   constant-operand products on the MXU): int8 mma.sync could take
//   m = T_lo N' and m p, but each lane's bytes would have to move into
//   fragment layout and the int32 column sums back, through shared
//   memory (about 0.7 KB per lane per REDC), which costs about what it
//   saves in IMAD issue.  A measured experiment for later (ROADMAP).
// - TMA / cp.async: every limb row is one coalesced 4-byte load, read
//   once, with no reuse across lanes to stage.
// - A (12, n) word layout would halve the bytes, but (24, n) 16-bit
//   limbs are the whole pipeline's contract; a pipeline change.
//
// g1_dbl works in the canonical domain ([0, p), fq::mm and
// fq::fadd/fdbl/fsub): 7 * 288 word products, an operations bound of
// about 0.25 ms at 2^20 lanes (bytes: 576 per lane, 0.18 ms).
//
// g1_add's outputs are canonical residues, so any correct computation
// of the same field values gives the reference's limbs.  The design:
// - Relaxed inside: fq::rmm products in [0, 2p), canonicalised only for
//   the outputs (fq::canon); h and r are tested for zero as relaxed
//   values (0 mod p iff 0 or p).  y3 = r (V - x3) - 2 s1 J is one
//   rmm_add (two products, one reduction).  Field-identical rewrite:
//   z3 = ((z1 + z2)^2 - z1^2 - z2^2) h = 2 z1 z2 h = rmm(z1 z2, 2h).
//   Total per lane: 16 products and 15 reductions, 31 * 144 word
//   products (the first design: 23 canonical products, 23 * 288, with
//   the doubling on every lane).
// - The doubling runs only where its result survives: needs_dbl = h = 0
//   and r = 0 and neither operand the identity, under a warp-uniform
//   branch (__any_sync), from operands read again.  The z tests matter:
//   O + O lanes also have h = r = 0, and the MSM's padding and empty
//   buckets are full of them.  Identity lanes store the other operand,
//   read again.  Every lane first stores the add's result, and the rare
//   lanes store over it.
// - Register budget: __launch_bounds__(128, 3), 168 registers, no
//   spills (at 4 blocks it spilled); each output is stored as soon as it
//   is known, and the values that later enter products only as word
//   operands are parked in shared memory (z1 z2, z1^2, z2^2 and s1, then
//   V - x3), the order of the products chosen for that (a*b = b*a).
//   Launch shape from threads_for, as padd's.
// At 2^20 lanes the operations bound is about 0.56 ms at the data
// sheet's IMAD rate (bytes: 864 per lane, 0.27 ms).

#include <cuda_runtime.h>

#include "fq.cuh"
#include "g1_core.cuh"

using fq::F;
using g1::kThreads;

namespace {

// Blocks of kThreads each SM must hold: the register budget (168
// registers for padd, 128 for padd01; see the note above).
constexpr int kPaddMinBlocks = 3;
constexpr int kPadd01MinBlocks = 4;
constexpr int kAddMinBlocks = 3;

__global__ void __launch_bounds__(kThreads)
    mont_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                    int32_t* __restrict__ out, long long n) {
  long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  fq::store(out, n, j, fq::mm(fq::load(a, n, j), fq::load(b, n, j)));
}

// g1_core.cuh's padd_core on lane j = b * cols + i of the operands, the
// results to the same lane of the outputs.
__global__ void __launch_bounds__(kThreads, kPaddMinBlocks)
    padd_kernel(const g1::Operands in, const g1::Outputs out, unsigned n,
                unsigned cols) {
  unsigned j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  unsigned b = j / cols, i = j - b * cols;
  __shared__ volatile uint32_t sm[3][fq::NW][kThreads];
  g1::padd_core(g1::LaneLoad{in, b, i}, g1::LaneStore{out, cols}, &sm[0][0][threadIdx.x]);
}

// _padd01_core: z1, z2 in {0, 1} from the masks; dead lanes are (0 : y : 0).
__global__ void __launch_bounds__(kThreads, kPadd01MinBlocks)
    padd01_kernel(const g1::Operands in, const g1::Outputs out, unsigned n,
                  unsigned cols) {
  unsigned j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  unsigned b = j / cols, i = j - b * cols;
  const F x1 = g1::load_op(in.o[0], b, i), y1 = g1::load_op(in.o[1], b, i);
  const F x2 = g1::load_op(in.o[3], b, i), y2 = g1::load_op(in.o[4], b, i);
  const bool live1 = g1::load_mask(in.o[2], b, i), live2 = g1::load_mask(in.o[5], b, i);
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
  const g1::LaneStore put{out, cols};
  put(0, fq::rmm_sub(t3, t1, t4, y3));
  put(1, fq::rmm_add(t1, z3, y3, t0));
  put(2, fq::rmm_add(z3, t4, t0, t3));
}

__global__ void __launch_bounds__(kThreads)
    dbl_kernel(const int32_t* __restrict__ px, const int32_t* __restrict__ py,
               const int32_t* __restrict__ pz, int32_t* __restrict__ ox,
               int32_t* __restrict__ oy, int32_t* __restrict__ oz, long long n) {
  long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  F x3, y3, z3;
  g1::dbl_core(fq::load(px, n, j), fq::load(py, n, j), fq::load(pz, n, j), x3, y3, z3);
  fq::store(ox, n, j, x3);
  fq::store(oy, n, j, y3);
  fq::store(oz, n, j, z3);
}

// g1_core.cuh's add_core on lane j = b * cols + i: the first reads with
// the lane index held, the doubling and identity lanes' reads and every
// store with it read again.
__global__ void __launch_bounds__(kThreads, kAddMinBlocks)
    add_kernel(const g1::Operands in, const g1::Outputs out, unsigned n,
               unsigned cols) {
  unsigned j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  unsigned b = j / cols, i = j - b * cols;
  __shared__ volatile uint32_t sm[4][fq::NW][kThreads];
  g1::add_core(g1::LaneLoad{in, b, i}, g1::LaneReload{in, cols},
               g1::LaneStore{out, cols}, &sm[0][0][threadIdx.x]);
}

unsigned blocks_for(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

// C interface for ctypes: device pointers, the lane count and the CUDA
// stream (padd/padd01/add: operand and output descriptors and the lanes
// per batch row, n = rows * cols <= 2^31; the others: contiguous int32
// tensors).  Each returns cudaGetLastError() right after the launch (0 =
// launched).

extern "C" int g1_mont_mul(const int32_t* a, const int32_t* b, int32_t* out,
                           long long n, void* stream) {
  if (n <= 0) return 0;
  mont_mul_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(a, b, out, n);
  return (int)cudaGetLastError();
}

extern "C" int g1_padd(const long long* desc, const long long* out, long long n,
                       long long cols, void* stream) {
  if (n <= 0) return 0;
  int t = g1::threads_for(n);
  padd_kernel<<<(unsigned)((n + t - 1) / t), t, 0, (cudaStream_t)stream>>>(
      g1::operands(desc), g1::outputs(out), (unsigned)n, (unsigned)cols);
  return (int)cudaGetLastError();
}

extern "C" int g1_padd01(const long long* desc, const long long* out, long long n,
                         long long cols, void* stream) {
  if (n <= 0) return 0;
  int t = g1::threads_for(n);
  padd01_kernel<<<(unsigned)((n + t - 1) / t), t, 0, (cudaStream_t)stream>>>(
      g1::operands(desc), g1::outputs(out), (unsigned)n, (unsigned)cols);
  return (int)cudaGetLastError();
}

extern "C" int g1_add(const long long* desc, const long long* out, long long n,
                      long long cols, void* stream) {
  if (n <= 0) return 0;
  int t = g1::threads_for(n);
  add_kernel<<<(unsigned)((n + t - 1) / t), t, 0, (cudaStream_t)stream>>>(
      g1::operands(desc), g1::outputs(out), (unsigned)n, (unsigned)cols);
  return (int)cudaGetLastError();
}

extern "C" int g1_dbl(const int32_t* x1, const int32_t* y1, const int32_t* z1,
                      int32_t* ox, int32_t* oy, int32_t* oz, long long n,
                      void* stream) {
  if (n <= 0) return 0;
  dbl_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      x1, y1, z1, ox, oy, oz, n);
  return (int)cudaGetLastError();
}
