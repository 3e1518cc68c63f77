// Hand-written Hopper kernels for the sumcheck time prover's round: the
// round message, the fused fold + next message, and the terminal fold.
//
//   sc_message_kernel   computes what gemini_tpu/subprotocols/sumcheck.py
//                       `_round_message_kernel` (:77-114) computes:
//                       a = sum_k f[2k] g[2k] T_k,
//                       b = sum_k (f[2k] g[2k+1] + g[2k] f[2k+1] twist) T_k
//   sc_fused_kernel     `_fused_round_body` (:117-127): the fold
//                       f2[k] = f[2k] + r twist f[2k+1], g2[k] = g[2k] + r g[2k+1]
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
// returns it.  An exact integer sum does not depend on the order of
// addition, so the per-word u64 partial sums below are deterministic.
// Headroom: each word is below 2^32, so a u64 word sum holds 2^32 pairs,
// and 2^32 values below 2^255 sum below 2^288 = 18 limbs (the wrappers
// refuse 2^31 pairs or more).
//
// Layout: f, g and t are (16, lanes) int32 16-bit limbs read through a
// (limb stride, lane stride) pair, so the twist powers' subsampled views
// (t[:, 0::2] after each fold) and a mesh shard's lane block are read as
// they lie, never copied.  Outputs (f2, g2: (16, m); ab: (2, 18)) are
// contiguous.  The scalars (twist, r, r * twist, twist^2) travel by
// value in the launch's arguments, in Montgomery form: no per-round
// host-to-device copy.
//
// Design (one thread per pair, a grid-stride loop): each thread keeps 16
// u64 word sums (a's 8 words, b's 8) over its pairs; a block adds them in
// shared memory, writes 16 partial words, and the last block to finish
// (an atomic ticket after a __threadfence, the CUDA samples'
// threadFenceReduction) adds the blocks' partials, carry-normalizes to
// (2, 18) limbs and resets the ticket.  So a message is one launch.  The
// last block adds the partials with all its threads (a strided share of
// the blocks each, then the shared-memory tree); the first design gave
// that sum to 16 threads, one word each, reading up to 1024 partials
// one after another.
//
// What bounds them on an H100 (n input lanes; 64 bytes per (16,) int32
// element): the message reads f, g (128n bytes) and half of t (32n) and
// does 3n Fr products; the fused round reads f, g and a quarter of t
// (144n), writes f2, g2 (64n) and does 2.5n products.  An 8-word CIOS
// product is 128 word products, 256 IMADs at the data sheet's 16.75 T/s,
// so both are bound by bytes at 3.35 TB/s, close to their operations.

#include <cuda_runtime.h>

#include "fr.cuh"

using fr::F;
typedef unsigned long long ull;

namespace {

constexpr int kThreads = 256;  // a power of two: the shared-memory tree
constexpr int kMaxBlocks = 1024;
constexpr int kWords = 2 * fr::NW;  // a's words, then b's
constexpr int kOutLimbs = 18;

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

__device__ __forceinline__ void accumulate(ull* acc, const F& a, const F& b) {
#pragma unroll
  for (int k = 0; k < fr::NW; ++k) {
    acc[k] += a.w[k];
    acc[fr::NW + k] += b.w[k];
  }
}

// One pair's message terms:
// a = (fe ge) T, b = (fe go + (ge fo) twist) T (_round_partials' order).
__device__ __forceinline__ void pair_terms(ull* acc, const F& fe, const F& fo,
                                           const F& ge, const F& go, const F& t,
                                           const F& twist) {
  F a = fr::mul(fr::mul(fe, ge), t);
  F cross = fr::add(fr::mul(fe, go), fr::mul(fr::mul(ge, fo), twist));
  accumulate(acc, a, fr::mul(cross, t));
}

// The block's sums of the threads' kWords words into red[.][0].
__device__ __forceinline__ void block_sum(ull (*red)[kThreads], const ull* acc) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int k = 0; k < kWords; ++k) red[k][tid] = acc[k];
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (tid < s) {
#pragma unroll
      for (int k = 0; k < kWords; ++k) red[k][tid] += red[k][tid + s];
    }
    __syncthreads();
  }
}

// Adds the block's word sums, then the last block adds every block's
// partials (each thread a strided share of the blocks, then the tree)
// and writes (2, 18) carry-normalized limbs to `out`.
__device__ void reduce_and_finish(const ull* acc, ull* partials,
                                  unsigned* ticket, int32_t* __restrict__ out) {
  __shared__ ull red[kWords][kThreads];
  __shared__ bool last;
  const int tid = threadIdx.x;
  block_sum(red, acc);
  for (int k = tid; k < kWords; k += blockDim.x) {
    partials[(long long)blockIdx.x * kWords + k] = red[k][0];
    __threadfence();  // visible to the last block before the ticket
  }
  __syncthreads();
  if (tid == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  ull share[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) share[k] = 0;
  for (unsigned b = tid; b < gridDim.x; b += blockDim.x) {
#pragma unroll
    for (int k = 0; k < kWords; ++k) share[k] += __ldcg(partials + (long long)b * kWords + k);
  }
  __syncthreads();
  block_sum(red, share);
  if (tid == 0) {
    // value = sum_w S_w 2^(32 w): 16-bit limbs, low first; the carry
    // into word w + 1 stays below 2^33.
    for (int c = 0; c < 2; ++c) {
      ull carry = 0;
      for (int w = 0; w < fr::NW; ++w) {
        ull s = red[c * fr::NW + w][0];
        ull lo = (s & 0xFFFFFFFFull) + carry;
        carry = (s >> 32) + (lo >> 32);
        out[c * kOutLimbs + 2 * w] = (int32_t)(lo & 0xFFFFu);
        out[c * kOutLimbs + 2 * w + 1] = (int32_t)((lo >> 16) & 0xFFFFu);
      }
      out[c * kOutLimbs + 16] = (int32_t)(carry & 0xFFFFu);
      out[c * kOutLimbs + 17] = (int32_t)((carry >> 16) & 0xFFFFu);
    }
    *ticket = 0;  // ready for the next launch on the stream
  }
}

__global__ void __launch_bounds__(kThreads)
    sc_message_kernel(Ops in, F twist, long long pairs, int32_t* __restrict__ out,
                      ull* partials, unsigned* ticket) {
  ull acc[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) acc[k] = 0;
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x; k < pairs;
       k += (long long)gridDim.x * blockDim.x) {
    pair_terms(acc, lane(in.f, 2 * k), lane(in.f, 2 * k + 1), lane(in.g, 2 * k),
               lane(in.g, 2 * k + 1), lane(in.t, k), twist);
  }
  reduce_and_finish(acc, partials, ticket, out);
}

// Output pair j: f2[2j], f2[2j+1], g2[2j], g2[2j+1] from input lanes
// 4j..4j+3, then the message terms of the pair with T'_j = t[2j].
__global__ void __launch_bounds__(kThreads)
    sc_fused_kernel(Ops in, F r, F r_twist, F twist_next, long long pairs,
                    int32_t* __restrict__ f2, int32_t* __restrict__ g2,
                    int32_t* __restrict__ out, ull* partials, unsigned* ticket) {
  const long long m = 2 * pairs;  // output lanes
  ull acc[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) acc[k] = 0;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < pairs;
       j += (long long)gridDim.x * blockDim.x) {
    F fe = fr::add(lane(in.f, 4 * j), fr::mul(lane(in.f, 4 * j + 1), r_twist));
    F fo = fr::add(lane(in.f, 4 * j + 2), fr::mul(lane(in.f, 4 * j + 3), r_twist));
    F ge = fr::add(lane(in.g, 4 * j), fr::mul(lane(in.g, 4 * j + 1), r));
    F go = fr::add(lane(in.g, 4 * j + 2), fr::mul(lane(in.g, 4 * j + 3), r));
    fr::store(f2, m, 2 * j, fe);
    fr::store(f2, m, 2 * j + 1, fo);
    fr::store(g2, m, 2 * j, ge);
    fr::store(g2, m, 2 * j + 1, go);
    pair_terms(acc, fe, fo, ge, go, lane(in.t, 2 * j), twist_next);
  }
  reduce_and_finish(acc, partials, ticket, out);
}

// Output lane k: f2[k] = f[2k] + r_twist f[2k+1], g2[k] = g[2k] + r g[2k+1].
__global__ void __launch_bounds__(kThreads)
    sc_fold_kernel(Ops in, F r, F r_twist, long long m, int32_t* __restrict__ f2,
                   int32_t* __restrict__ g2) {
  long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= m) return;
  fr::store(f2, m, k, fr::add(lane(in.f, 2 * k), fr::mul(lane(in.f, 2 * k + 1), r_twist)));
  fr::store(g2, m, k, fr::add(lane(in.g, 2 * k), fr::mul(lane(in.g, 2 * k + 1), r)));
}

unsigned blocks_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  return (unsigned)(b < 1 ? 1 : b > kMaxBlocks ? kMaxBlocks : b);
}

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

F scalar(const uint32_t* words) {
  F s;
  for (int k = 0; k < fr::NW; ++k) s.w[k] = words[k];
  return s;
}

}  // namespace

// C interface for ctypes: `desc` and `scalars` are host arrays (operand
// descriptors; 8 Montgomery words per scalar), the rest device pointers,
// counts and the CUDA stream.  `partials` holds `cap` u64 words and
// `ticket` is a device u32 that is 0 between launches (the last block
// resets it).  Each returns cudaGetLastError() right after the launch
// (0 = launched), or cudaErrorInvalidValue when `partials` is too small.

extern "C" int sc_max_partials() { return kMaxBlocks * kWords; }

extern "C" int sc_message(const long long* desc, const uint32_t* scalars,
                          long long pairs, int32_t* out, unsigned long long* partials,
                          long long cap, unsigned* ticket, void* stream) {
  unsigned blocks = blocks_for(pairs);
  if ((long long)blocks * kWords > cap) return (int)cudaErrorInvalidValue;
  sc_message_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      operands(desc), scalar(scalars), pairs, out, partials, ticket);
  return (int)cudaGetLastError();
}

extern "C" int sc_fused(const long long* desc, const uint32_t* scalars,
                        long long pairs, int32_t* f2, int32_t* g2, int32_t* out,
                        unsigned long long* partials, long long cap, unsigned* ticket,
                        void* stream) {
  unsigned blocks = blocks_for(pairs);
  if ((long long)blocks * kWords > cap) return (int)cudaErrorInvalidValue;
  sc_fused_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      operands(desc), scalar(scalars), scalar(scalars + fr::NW),
      scalar(scalars + 2 * fr::NW), pairs, f2, g2, out, partials, ticket);
  return (int)cudaGetLastError();
}

extern "C" int sc_fold(const long long* desc, const uint32_t* scalars, long long m,
                       int32_t* f2, int32_t* g2, void* stream) {
  if (m <= 0) return 0;
  unsigned blocks = (unsigned)((m + kThreads - 1) / kThreads);
  sc_fold_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      operands(desc), scalar(scalars), scalar(scalars + fr::NW), m, f2, g2);
  return (int)cudaGetLastError();
}
