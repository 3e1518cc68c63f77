// Hand-written Hopper kernels for the sumcheck time prover's round: the
// round message, the fused fold + next message, and the terminal fold.
//
//   sc_message_kernel,  compute what gemini_tpu/subprotocols/sumcheck.py
//   sc_message_split_   `_round_message_kernel` (:77-114) computes:
//   kernel              a = sum_k f[2k] g[2k] T_k,
//                       b = sum_k (f[2k] g[2k+1] + g[2k] f[2k+1] twist) T_k
//   sc_fused_split_     `_fused_round_body` (:117-127): the fold
//   kernel              f2[k] = f[2k] + r twist f[2k+1], g2[k] = g[2k] + r g[2k+1]
//                       and the next round's (a, b) over (f2, g2, T_2k)
//                       with twist^2, in one launch
//   sc_fold_kernel      `_fold_kernel` (:186-202) alone: the terminal fold,
//                       with no message after it
//
// The reference has no Pallas kernel here (XLA fuses the round).  Each
// output equals the port's plain version (subprotocols/sumcheck.py
// `_round_message_plain`, `_fused_round_plain`, `_fold_plain`) bit for
// bit: products and sums are canonical Fr values (fr.cuh), and (a, b) is
// the exact integer sum of the canonical Montgomery values, carry-
// normalized to 16-bit limbs with two overflow limbs, as fp.lane_sum
// returns it.
//
// Layout: f, g and t are (16, lanes) int32 16-bit limbs read through a
// (limb stride, lane stride) pair, so the twist powers' subsampled views
// (t[:, 0::2] after each fold, lane strides 2^k in deep rounds) and a
// mesh shard's lane block are read as they lie, never copied.  Where f
// and g have lane stride 1 and 8-byte aligned rows (checked on the host
// from the pointers and limb strides), a thread's two adjacent lanes
// come in one int2 load per limb row; any other view takes one scalar
// load per limb and lane.  Outputs (f2, g2: (16, m); ab: (2, 18)) are
// contiguous.  The scalars (twist, r, r * twist, twist^2) travel by value
// in the launch's arguments, in Montgomery form: no per-round
// host-to-device copy.
//
// A pair to a lane, or to two.  sc_message_kernel gives a pair to a
// thread: its six products in one chain.  The split kernels give a pair
// to two neighbouring lanes of a warp, h = lane & 1, which trade operands
// by __shfl_xor_sync: each runs three of the message's products (h = 0:
// P3 = fe go, P1 = fe ge, a = P1 T; h = 1: P4 = ge fo, P5 = P4 twist,
// b = (P3 + P5) T with P3 from its partner), and in the fused round one
// of the pair's two folded lanes of f and of g first (two products, so
// five in a chain, not ten).  A small round is latency-bound (one unit a
// thread), so the halved chain pays there; the fused round also fits
// 128 registers split and spills unsplit, so it always splits.  Both
// lanes run the same code on operands picked by h, so the shuffles are
// convergent; a warp runs while any of its lanes has a pair, and a lane
// past the end repeats the last pair and stores and adds nothing.
//
// The sum: each thread keeps its terms as 288-bit (9-word) running sums,
// a and b (a pair a lane) or one of them (split: a on h = 0, b on h = 1),
// added on the carry chain (9 instructions a term).  A warp adds its
// lanes' sums with __shfl_down_sync (18 words a level, five levels; every
// lane of the warp takes part, so lanes past the end add zeros and the
// loops never return early), lane 0 of each warp puts its 18 words in
// shared memory (at most 8 x 18 words), one __syncthreads, and warp 0
// adds those.  Thread 0 writes the block's 18-word partial; the last
// block to finish (an atomic ticket after a __threadfence, the CUDA
// samples' threadFenceReduction) adds the blocks' partials with all its
// threads by the same scheme, writes (2, 18) limbs (word k of a sum is
// limbs 2k, 2k + 1) and resets the ticket.  So a round is one launch.
// Exactness and headroom: every term is below r < 2^255 and a launch
// takes fewer than 2^31 pairs (the wrappers refuse more), so any sum of
// any subset of the terms is below 2^286 < 2^288: no partial sum ever
// wraps, whatever order the lanes, warps and blocks add in, and an exact
// integer sum does not depend on that order.  (A lane whose shuffle
// source lies past lane 31 adds its own value and may wrap, but no such
// lane feeds lane 0.)
//
// Launch shape (the wrapper's launch_shape picks it from the SM count
// and the occupancy API, read once per device): up to one 128-thread
// block per SM, 128-thread blocks with one unit (a pair, or half of one
// split) a thread, so one warp a scheduler runs one chain; beyond,
// 256-thread blocks in a grid-stride loop with no more blocks than the
// card holds at once, so the ticket's last block is resident with the
// rest.  __launch_bounds__(256, 2) caps every round kernel at 128
// registers: 16 resident warps an SM (4 a scheduler) to hide the load
// latency and the CIOS chains, whose instructions depend on one another
// through the carry flag; none spills.
//
// What bounds them on an H100 (n input lanes; 64 bytes per (16,) int32
// element): the message reads f, g (128n bytes) and half of t (32n) and
// does 3n Fr products; the fused round reads f, g and a quarter of t
// (144n), writes f2, g2 (64n) and does 2.5n products.  An 8-word CIOS
// product is 128 word products, 256 IMADs at the data sheet's 16.75 T/s,
// so both are bound by bytes at 3.35 TB/s, close to their operations, at
// 2^20 lanes and more; a round of 2^16 lanes or fewer is bound by the
// latency of one unit's chain and of the launch.

#include <cuda_runtime.h>

#include "fr.cuh"

using fq::u32;
using fr::F;

namespace {

constexpr int kWarp = 32;
constexpr int kMaxThreads = 256;  // a block: 32-256 threads, a multiple of 32
constexpr int kMinBlocks = 2;     // resident 256-thread blocks an SM: <= 128 registers
constexpr int kMaxWarps = kMaxThreads / kWarp;
constexpr int kMaxBlocks = 4096;  // the grid's cap; the scratch holds its partials
constexpr int kSumWords = fr::SW;  // a 288-bit running sum
constexpr int kPartial = 2 * kSumWords;  // a's words, then b's
constexpr int kOutLimbs = 18;
constexpr int kFoldThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;

// One operand as the caller's view lays it out: limb row r of lane i at
// p[r * ls + i * es].
struct Vec {
  const int32_t* p;
  long long ls;
  long long es;
};

struct Ops {
  Vec f, g, t;
};

__device__ __forceinline__ F lane(const Vec& v, long long i) {
  return fr::load(v.p, v.ls, i * v.es);
}

__device__ __forceinline__ u32 word(int lo, int hi) {
  return ((u32)lo & 0xFFFFu) | ((u32)hi << 16);
}

// Lanes i and i + 1 (lane stride 1, i even, rows 8-byte aligned): one
// int2 per limb row.
__device__ __forceinline__ void lanes2(const Vec& v, long long i, F& x0, F& x1) {
  const int2* p = reinterpret_cast<const int2*>(v.p + i);
  const long long ls = v.ls / 2;
#pragma unroll
  for (int k = 0; k < fr::NW; ++k) {
    int2 lo = __ldg(p + (2 * k) * ls);
    int2 hi = __ldg(p + (2 * k + 1) * ls);
    x0.w[k] = word(lo.x, hi.x);
    x1.w[k] = word(lo.y, hi.y);
  }
}

// Lanes i and i + 1: the vector load where the host found the view
// aligned for it, else one scalar load per limb and lane.
template <bool kVec>
__device__ __forceinline__ void two_lanes(const Vec& v, long long i, F& x0, F& x1) {
  if (kVec) {
    lanes2(v, i, x0, x1);
  } else {
    x0 = lane(v, i);
    x1 = lane(v, i + 1);
  }
}

// a and b as 288-bit running sums, 9 little-endian words each.
struct Sums {
  u32 a[kSumWords], b[kSumWords];
};

__device__ __forceinline__ void clear(Sums& s) {
#pragma unroll
  for (int k = 0; k < kSumWords; ++k) s.a[k] = s.b[k] = 0;
}

// One pair's message terms:
// a = (fe ge) T, b = (fe go + (ge fo) twist) T (_round_partials' order).
__device__ __forceinline__ void pair_terms(Sums& s, const F& fe, const F& fo,
                                           const F& ge, const F& go, const F& t,
                                           const F& twist) {
  fr::add_term(s.a, fr::mul(fr::mul(fe, ge), t));
  F cross = fr::add(fr::mul(fe, go), fr::mul(fr::mul(ge, fo), twist));
  fr::add_term(s.b, fr::mul(cross, t));
}

// Lane 0 gets the sum of lanes 0 .. 2 * kTop - 1 (all 32 lanes call it).
template <int kTop>
__device__ __forceinline__ void warp_sum(Sums& s) {
#pragma unroll
  for (int off = kTop; off > 0; off >>= 1) {
    u32 xa[kSumWords], xb[kSumWords];
#pragma unroll
    for (int k = 0; k < kSumWords; ++k) {
      xa[k] = __shfl_down_sync(kFullMask, s.a[k], off);
      xb[k] = __shfl_down_sync(kFullMask, s.b[k], off);
    }
    fr::add_sum(s.a, xa);
    fr::add_sum(s.b, xb);
  }
}

// Thread 0 gets the block's sum (every thread calls it).
__device__ __forceinline__ void block_sum(Sums& s, u32 (*sh)[kPartial]) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  warp_sum<kWarp / 2>(s);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kSumWords; ++k) {
      sh[warp][k] = s.a[k];
      sh[warp][kSumWords + k] = s.b[k];
    }
  }
  __syncthreads();
  if (warp == 0) {
    const bool live = lane < (int)(blockDim.x / kWarp);
    const u32* w = sh[live ? lane : 0];
#pragma unroll
    for (int k = 0; k < kSumWords; ++k) {
      s.a[k] = live ? w[k] : 0u;
      s.b[k] = live ? w[kSumWords + k] : 0u;
    }
    warp_sum<kMaxWarps / 2>(s);
  }
}

// Adds the block's sums, then the last block adds every block's partials
// (each thread a strided share of the blocks, then block_sum) and writes
// (2, 18) limbs to `out`.
__device__ void reduce_and_finish(Sums& s, u32* partials, unsigned* ticket,
                                  int32_t* __restrict__ out) {
  __shared__ u32 sh[kMaxWarps][kPartial];
  __shared__ bool last;
  block_sum(s, sh);
  if (threadIdx.x == 0) {
    u32* p = partials + (long long)blockIdx.x * kPartial;
#pragma unroll
    for (int k = 0; k < kSumWords; ++k) {
      p[k] = s.a[k];
      p[kSumWords + k] = s.b[k];
    }
    __threadfence();  // visible to the last block before the ticket
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  clear(s);
  for (unsigned b = threadIdx.x; b < gridDim.x; b += blockDim.x) {
    const u32* p = partials + (long long)b * kPartial;
    u32 x[kSumWords];
#pragma unroll
    for (int k = 0; k < kSumWords; ++k) x[k] = __ldcg(p + k);
    fr::add_sum(s.a, x);
#pragma unroll
    for (int k = 0; k < kSumWords; ++k) x[k] = __ldcg(p + kSumWords + k);
    fr::add_sum(s.b, x);
  }
  block_sum(s, sh);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kSumWords; ++k) {
      out[2 * k] = (int32_t)(s.a[k] & 0xFFFFu);
      out[2 * k + 1] = (int32_t)(s.a[k] >> 16);
      out[kOutLimbs + 2 * k] = (int32_t)(s.b[k] & 0xFFFFu);
      out[kOutLimbs + 2 * k + 1] = (int32_t)(s.b[k] >> 16);
    }
    *ticket = 0;  // ready for the next launch on the stream
  }
}

// Pair k: f[2k], f[2k+1], g[2k], g[2k+1] and T_k.
template <bool kVec>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
    sc_message_kernel(Ops in, F twist, long long pairs, int32_t* __restrict__ out,
                      u32* partials, unsigned* ticket) {
  Sums s;
  clear(s);
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x; k < pairs;
       k += (long long)gridDim.x * blockDim.x) {
    F fe, fo, ge, go;
    two_lanes<kVec>(in.f, 2 * k, fe, fo);
    two_lanes<kVec>(in.g, 2 * k, ge, go);
    pair_terms(s, fe, fo, ge, go, lane(in.t, k), twist);
  }
  reduce_and_finish(s, partials, ticket, out);
}

// The split kernels (a pair to lanes h = 0 and 1 of a warp, as the
// header sets out).

__device__ __forceinline__ F pick(bool c, const F& x, const F& y) {
  F r;
#pragma unroll
  for (int k = 0; k < fr::NW; ++k) r.w[k] = c ? x.w[k] : y.w[k];
  return r;
}

// x from the partner lane (lane ^ 1); all 32 lanes call it.
__device__ __forceinline__ F partner(const F& x) {
  F y;
#pragma unroll
  for (int k = 0; k < fr::NW; ++k) y.w[k] = __shfl_xor_sync(kFullMask, x.w[k], 1);
  return y;
}

// Lane h's term of the pair from fx = f[2k + h] and gx = g[2k + h] (fe
// and ge on lane 0, fo and go on lane 1) and T.
__device__ __forceinline__ F half_term(bool h, const F& fx, const F& gx, const F& t,
                                       const F& twist) {
  F gy = partner(gx);
  F ge = pick(h, gy, gx), go = pick(h, gx, gy);
  F x1 = fr::mul(pick(h, ge, fx), pick(h, fx, go));     // P4 | P3
  F x2 = fr::mul(pick(h, x1, fx), pick(h, twist, ge));  // P5 | P1
  F y = partner(x1);                                    // P3 on lane 1
  return fr::mul(pick(h, fr::add(y, x2), x2), t);       // b | a
}

// The lane's sum as the block reduction's (a, b): a on h = 0, b on h = 1.
__device__ __forceinline__ Sums as_sums(bool h, const u32* acc) {
  Sums s;
#pragma unroll
  for (int k = 0; k < kSumWords; ++k) {
    s.a[k] = h ? 0u : acc[k];
    s.b[k] = h ? acc[k] : 0u;
  }
  return s;
}

// Unit q: lane h = q & 1 of pair k = q / 2, from f[2k + h], g[2k + h], T_k.
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
    sc_message_split_kernel(Ops in, F twist, long long pairs, int32_t* __restrict__ out,
                            u32* partials, unsigned* ticket) {
  const bool h = threadIdx.x & 1;
  const long long halves = 2 * pairs;
  u32 acc[kSumWords] = {};
  for (long long q0 = (long long)blockIdx.x * blockDim.x + (threadIdx.x & ~(kWarp - 1));
       q0 < halves; q0 += (long long)gridDim.x * blockDim.x) {
    const long long q = q0 + threadIdx.x % kWarp;
    const bool live = q < halves;
    const long long k = live ? q >> 1 : pairs - 1;
    F x = half_term(h, lane(in.f, 2 * k + h), lane(in.g, 2 * k + h), lane(in.t, k), twist);
    if (live) fr::add_term(acc, x);
  }
  Sums s = as_sums(h, acc);
  reduce_and_finish(s, partials, ticket, out);
}

// Unit q: lane h = q & 1 of output pair j = q / 2 folds input lanes
// 4j + 2h, 4j + 2h + 1 into f2[2j + h], g2[2j + h], then takes its half
// of pair j's message terms with T'_j = t[2j].
template <bool kVec>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
    sc_fused_split_kernel(Ops in, F r, F r_twist, F twist_next, long long pairs,
                          int32_t* __restrict__ f2, int32_t* __restrict__ g2,
                          int32_t* __restrict__ out, u32* partials, unsigned* ticket) {
  const bool h = threadIdx.x & 1;
  const long long halves = 2 * pairs;
  u32 acc[kSumWords] = {};
  for (long long q0 = (long long)blockIdx.x * blockDim.x + (threadIdx.x & ~(kWarp - 1));
       q0 < halves; q0 += (long long)gridDim.x * blockDim.x) {
    const long long q = q0 + threadIdx.x % kWarp;
    const bool live = q < halves;
    const long long j = live ? q >> 1 : pairs - 1;
    F x0, x1;
    two_lanes<kVec>(in.f, 4 * j + 2 * h, x0, x1);
    F xf = fr::add(x0, fr::mul(x1, r_twist));  // f2[2j + h]
    two_lanes<kVec>(in.g, 4 * j + 2 * h, x0, x1);
    F xg = fr::add(x0, fr::mul(x1, r));  // g2[2j + h]
    if (live) {
      fr::store(f2, halves, 2 * j + h, xf);
      fr::store(g2, halves, 2 * j + h, xg);
    }
    F x = half_term(h, xf, xg, lane(in.t, 2 * j), twist_next);
    if (live) fr::add_term(acc, x);
  }
  Sums s = as_sums(h, acc);
  reduce_and_finish(s, partials, ticket, out);
}

// Output lane k: f2[k] = f[2k] + r_twist f[2k+1], g2[k] = g[2k] + r g[2k+1].
__global__ void __launch_bounds__(kFoldThreads)
    sc_fold_kernel(Ops in, F r, F r_twist, long long m, int32_t* __restrict__ f2,
                   int32_t* __restrict__ g2) {
  long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= m) return;
  fr::store(f2, m, k, fr::add(lane(in.f, 2 * k), fr::mul(lane(in.f, 2 * k + 1), r_twist)));
  fr::store(g2, m, k, fr::add(lane(in.g, 2 * k), fr::mul(lane(in.g, 2 * k + 1), r)));
}

}  // namespace

namespace {

// desc: f, g, t x (pointer, limb stride, lane stride).
Ops operands(const long long* desc) {
  Ops in;
  Vec* v[3] = {&in.f, &in.g, &in.t};
  for (int k = 0; k < 3; ++k) {
    v[k]->p = (const int32_t*)desc[3 * k];
    v[k]->ls = desc[3 * k + 1];
    v[k]->es = desc[3 * k + 2];
  }
  return in;
}

// Whether `width` adjacent lanes of v load as one vector per limb row:
// lane stride 1 and every row aligned to the vector.
bool vector_ok(const Vec& v, int width) {
  return v.es == 1 && v.ls % width == 0 &&
         (unsigned long long)v.p % (width * sizeof(int32_t)) == 0;
}

F scalar(const uint32_t* words) {
  F s;
  for (int k = 0; k < fr::NW; ++k) s.w[k] = words[k];
  return s;
}

// The instance a launch takes: the message a pair to a lane (vector or
// scalar loads) or split; the fused round always split.
const void* round_kernel(int kernel, bool vec, bool split) {
  if (kernel != 0)
    return vec ? (const void*)sc_fused_split_kernel<true>
               : (const void*)sc_fused_split_kernel<false>;
  if (split) return (const void*)sc_message_split_kernel;
  return vec ? (const void*)sc_message_kernel<true> : (const void*)sc_message_kernel<false>;
}

// Launches round kernel `fn` with its arguments by value.
template <class... Args>
int launch(const void* fn, int blocks, int threads, void* stream, Args... args) {
  void* argv[] = {&args...};
  cudaError_t err =
      cudaLaunchKernel(fn, dim3(blocks), dim3(threads), argv, 0, (cudaStream_t)stream);
  cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

bool shape_ok(int threads, int blocks, long long cap) {
  return threads >= kWarp && threads <= kMaxThreads && threads % kWarp == 0 &&
         blocks >= 1 && blocks <= kMaxBlocks && (long long)blocks * kPartial <= cap;
}

}  // namespace

// C interface for ctypes: `desc` and `scalars` are host arrays (operand
// descriptors; 8 Montgomery words per scalar), the rest device pointers,
// counts, the launch shape and the CUDA stream.  `partials` holds `cap`
// u32 words and `ticket` is a device u32 that is 0 between launches (the
// last block resets it).  Each launch returns cudaGetLastError() right
// after the launch (0 = launched), or cudaErrorInvalidValue for a shape
// outside 32-256 threads (a multiple of 32) and 1-4096 blocks, or one
// whose partials do not fit `partials`.

extern "C" int sc_max_partials() { return kMaxBlocks * kPartial; }

// For round kernel `kernel` (0 sc_message, 1 sc_fused) with vector loads
// (vec = 1) or without, a pair to a lane (split = 0) or to two: its
// resident blocks per SM at `threads` a block,
// its registers and its local memory (spill) bytes per thread, on the
// current device.
extern "C" int sc_occupancy(int kernel, int vec, int split, int threads,
                            int* blocks_per_sm, int* registers, int* local_bytes) {
  const void* fn = round_kernel(kernel, vec != 0, split != 0);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, threads, 0);
  if (err != cudaSuccess) return (int)err;
  *registers = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

extern "C" int sc_message(const long long* desc, const uint32_t* scalars,
                          long long pairs, int split, int threads, int blocks,
                          int32_t* out, unsigned* partials, long long cap,
                          unsigned* ticket, void* stream) {
  if (!shape_ok(threads, blocks, cap)) return (int)cudaErrorInvalidValue;
  Ops in = operands(desc);
  const bool vec = vector_ok(in.f, 2) && vector_ok(in.g, 2);
  return launch(round_kernel(0, vec, split != 0), blocks, threads, stream, in,
                scalar(scalars), pairs, out, (u32*)partials, ticket);
}

extern "C" int sc_fused(const long long* desc, const uint32_t* scalars,
                        long long pairs, int threads, int blocks, int32_t* f2,
                        int32_t* g2, int32_t* out, unsigned* partials, long long cap,
                        unsigned* ticket, void* stream) {
  if (!shape_ok(threads, blocks, cap)) return (int)cudaErrorInvalidValue;
  Ops in = operands(desc);
  const bool vec = vector_ok(in.f, 2) && vector_ok(in.g, 2);
  return launch(round_kernel(1, vec, true), blocks, threads, stream, in,
                scalar(scalars), scalar(scalars + fr::NW), scalar(scalars + 2 * fr::NW),
                pairs, f2, g2, out, (u32*)partials, ticket);
}

extern "C" int sc_fold(const long long* desc, const uint32_t* scalars, long long m,
                       int32_t* f2, int32_t* g2, void* stream) {
  if (m <= 0) return 0;
  unsigned blocks = (unsigned)((m + kFoldThreads - 1) / kFoldThreads);
  sc_fold_kernel<<<blocks, kFoldThreads, 0, (cudaStream_t)stream>>>(
      operands(desc), scalar(scalars), scalar(scalars + fr::NW), m, f2, g2);
  return (int)cudaGetLastError();
}
