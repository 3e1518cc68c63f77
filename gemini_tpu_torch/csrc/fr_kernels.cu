// Hand-written Hopper kernels for the BLS12-381 scalar field's vector ops,
// the Fr branches of fields/fp.py on CUDA tensors:
//
//   fr_mul_kernel       gemini_tpu/fields/fp.py `mont_mul` (:273, the CIOS
//                       at :224-271): canonical a * b * 2^-256 mod r
//   fr_addsub_kernel    `add` (:199) and `sub` (:206), `neg` (:219) as
//                       0 - a: canonical a + b or a - b mod r
//   fr_reduce_kernel    `reduce_relaxed` (:327): V mod r of relaxed rows
//   fr_lane_sum_kernel  `lane_sum` (:412), and `lane_sum(mont_mul(a, b))`
//                       in one pass: exact sums over the last batch axis
//
// The reference has no Pallas kernel here: each op is one jax.jit
// executable that XLA fuses.  Each output equals the port's plain
// version (fp.py `_mont_mul_plain`, `_add_plain`, `_sub_plain`,
// `_reduce_relaxed_plain`, `_lane_sum_plain`) bit for bit.
//
// Layout.  Operands are int32 16-bit limb tensors (16 limb rows; the
// reduction's rows are int32 or int64), read through (limb, outer, inner)
// strides: element (o, j) of limb row k lies at p[k ls + o os + j is].
// So broadcast scalars (os = is = 0), a weight row against a grouped
// block (os = 0), halves and even/odd views go in as they lie, uncopied.
// Outputs are contiguous: (16, outer * inner) for the elementwise ops,
// (18, groups) for the lane sum.  Launches go on the caller's stream.
//
// fr_mul, fr_addsub: a thread an element.  fr_mul reads 128 bytes and
// writes 64 and issues one 8-word CIOS product (256 IMADs); at 3.35 TB/s
// and 16.75 T IMAD/s the bytes bound it (0.057 ms per 2^20 elements, the
// IMADs 0.016 ms).  fr_addsub moves the same bytes and does 16 adds.
//
// fr_reduce: a thread an element.  The rows (each < 2^47, E of them) are
// carry-propagated into 32-bit words as they are read, lowest first, and
// fed straight into the CIOS word steps (fr::mont_words) against
// K = 2^(32 W) mod r: V K 2^(-32 W) = V mod r, W the word count rounded
// up to even (V < 2^(16 E + 32), so E + 2 limbs).  Any exact method gives
// the same limbs, V mod r being unique; the plain version takes E + 3
// 16-bit limbs against 2^(16 (E + 3)) mod r.
//
// fr_lane_sum: (16, G, m) -> (18, G), each output the exact integer sum
// of its group's m elements (kMul: of the canonical products a * b) as
// 288-bit sums on the carry chain (fr::add_term).  A group takes `seg`
// neighbouring lanes of a warp (seg = 1, 2, ..., 32: lanes stride the
// group by seg, then add their sums with __shfl_down_sync inside the
// segment), or, with seg = 0, `parts` whole blocks: each block strides
// its share, adds its threads' sums (warp shuffles, one shared array,
// warp 0), and the last of a group's blocks to finish (an atomic ticket
// per group after a __threadfence) adds the group's partials and resets
// the ticket.  The wrapper picks seg and parts from G and m so that a
// thread takes a few terms and the grid fills the card.  Fewer than 2^31
// terms a group (the wrapper refuses more) keep every partial sum below
// 2^287, so no order of addition wraps.  The sum reads 64 bytes a term
// (128 with b) and writes 72 a group: bound by bytes.

#include <cuda_runtime.h>

#include "fr.cuh"

using fq::u32;
using fr::F;

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kWarps = kThreads / kWarp;
constexpr int kMaxBlocks = 4096;  // partial sums and tickets held for this many
constexpr unsigned kFullMask = 0xffffffffu;

// Limb row k of element (o, j) at p[k ls + o os + j is].
template <class T>
struct Op {
  const T* p;
  long long ls, os, is;
};

__device__ __forceinline__ F at(const Op<int32_t>& v, long long o, long long j) {
  return fr::load(v.p, v.ls, o * v.os + j * v.is);
}

// Element i of an outer x inner batch, row-major.
__device__ __forceinline__ void split(long long i, long long inner, long long& o,
                                      long long& j) {
  o = inner == 1 ? i : i / inner;
  j = i - o * inner;
}

__global__ void __launch_bounds__(kThreads)
    fr_mul_kernel(Op<int32_t> a, Op<int32_t> b, long long n, long long inner,
                  int32_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  long long o, j;
  split(i, inner, o, j);
  // fp.mont_mul's contract: a any 256-bit value, b < r; fr::mul wants its
  // first operand below r.
  fr::store(out, n, i, fr::mul(at(b, o, j), at(a, o, j)));
}

__global__ void __launch_bounds__(kThreads)
    fr_addsub_kernel(Op<int32_t> a, Op<int32_t> b, long long n, long long inner,
                     int subtract, int32_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  long long o, j;
  split(i, inner, o, j);
  const F x = at(a, o, j), y = at(b, o, j);
  fr::store(out, n, i, subtract ? fr::sub(x, y) : fr::add(x, y));
}

// Rows of element (o, j), carry-propagated into 32-bit words, lowest
// first, zeros past the top.
template <class T>
struct Words {
  const T* p;
  long long ls;
  int rows, row;
  fq::u64 carry;

  __device__ __forceinline__ u32 limb() {
    fq::u64 x = carry;
    if (row < rows) x += (fq::u64)__ldg(p + row * ls);
    ++row;
    carry = x >> 16;
    return (u32)x & 0xFFFFu;
  }
  __device__ __forceinline__ u32 operator()() {
    u32 lo = limb();
    return lo | (limb() << 16);
  }
};

template <class T>
__global__ void __launch_bounds__(kThreads)
    fr_reduce_kernel(Op<T> v, int rows, int words, F k, long long n, long long inner,
                     int32_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  long long o, j;
  split(i, inner, o, j);
  Words<T> next{v.p + o * v.os + j * v.is, v.ls, rows, 0, 0};
  fr::store(out, n, i, fr::mont_words(k, words, next));
}

// Lane 0 of each `seg`-lane segment gets the segment's sum (all 32 lanes
// call it; seg a power of two, at most 32).
__device__ __forceinline__ void segment_sum(u32* s, int seg) {
  for (int off = seg / 2; off > 0; off >>= 1) {
    u32 x[fr::SW];
#pragma unroll
    for (int k = 0; k < fr::SW; ++k) x[k] = __shfl_down_sync(kFullMask, s[k], off);
    fr::add_sum(s, x);
  }
}

// Thread 0 gets the block's sum (every thread calls it).
__device__ __forceinline__ void block_sum(u32* s, u32 (*sh)[fr::SW]) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  segment_sum(s, kWarp);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < fr::SW; ++k) sh[warp][k] = s[k];
  }
  __syncthreads();
  if (warp == 0) {
    const bool live = lane < kWarps;
#pragma unroll
    for (int k = 0; k < fr::SW; ++k) s[k] = live ? sh[live ? lane : 0][k] : 0u;
    segment_sum(s, kWarps);
  }
}

__device__ __forceinline__ void store_sum(int32_t* __restrict__ out, long long groups,
                                          long long g, const u32* s) {
#pragma unroll
  for (int k = 0; k < fr::SW; ++k) {
    out[(2 * k) * groups + g] = (int32_t)(s[k] & 0xFFFFu);
    out[(2 * k + 1) * groups + g] = (int32_t)(s[k] >> 16);
  }
}

template <bool kMul>
__device__ __forceinline__ F term(const Op<int32_t>& a, const Op<int32_t>& b,
                                  long long g, long long j) {
  if (kMul) return fr::mul(at(b, g, j), at(a, g, j));  // b < r, as fr_mul
  return at(a, g, j);
}

// seg > 0: a group to each seg-lane segment.  seg = 0: a group to `parts`
// blocks (blocks g * parts .. g * parts + parts - 1), the last of them to
// finish adding the group's partials.
template <bool kMul>
__global__ void __launch_bounds__(kThreads)
    fr_lane_sum_kernel(Op<int32_t> a, Op<int32_t> b, long long groups, long long m,
                       int seg, int parts, int32_t* __restrict__ out, u32* partials,
                       unsigned* tickets) {
  u32 s[fr::SW] = {};
  if (seg > 0) {
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long g = t / seg;
    const int lane = (int)(t % seg);
    if (g < groups)
      for (long long j = lane; j < m; j += seg) fr::add_term(s, term<kMul>(a, b, g, j));
    segment_sum(s, seg);
    if (lane == 0 && g < groups) store_sum(out, groups, g, s);
    return;
  }
  __shared__ u32 sh[kWarps][fr::SW];
  __shared__ bool last;
  const long long g = blockIdx.x / parts;
  const int part = blockIdx.x % parts;
  for (long long j = (long long)part * blockDim.x + threadIdx.x; j < m;
       j += (long long)parts * blockDim.x)
    fr::add_term(s, term<kMul>(a, b, g, j));
  block_sum(s, sh);
  if (parts == 1) {
    if (threadIdx.x == 0) store_sum(out, groups, g, s);
    return;
  }
  if (threadIdx.x == 0) {
    u32* p = partials + (long long)blockIdx.x * fr::SW;
#pragma unroll
    for (int k = 0; k < fr::SW; ++k) p[k] = s[k];
    __threadfence();  // visible to the group's last block before its ticket
    last = atomicAdd(tickets + g, 1u) == (unsigned)parts - 1;
  }
  __syncthreads();
  if (!last) return;
#pragma unroll
  for (int k = 0; k < fr::SW; ++k) s[k] = 0;
  for (int q = threadIdx.x; q < parts; q += blockDim.x) {
    const u32* p = partials + (g * parts + q) * fr::SW;
    u32 x[fr::SW];
#pragma unroll
    for (int k = 0; k < fr::SW; ++k) x[k] = __ldcg(p + k);
    fr::add_sum(s, x);
  }
  block_sum(s, sh);
  if (threadIdx.x == 0) {
    store_sum(out, groups, g, s);
    tickets[g] = 0;  // ready for the next launch on the stream
  }
}

}  // namespace

namespace {

// desc: (pointer, limb stride, outer stride, inner stride), in elements.
template <class T>
Op<T> operand(const long long* desc) {
  return Op<T>{(const T*)desc[0], desc[1], desc[2], desc[3]};
}

F value(const uint32_t* words) {
  F s;
  for (int k = 0; k < fr::NW; ++k) s.w[k] = words[k];
  return s;
}

unsigned blocks_for(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

bool elementwise_ok(long long n, long long inner) {
  return n > 0 && inner > 0 && n % inner == 0 &&
         (n + kThreads - 1) / kThreads <= 0x7fffffffLL;
}

}  // namespace

// C interface for ctypes.  `desc` arrays are host arrays of operand
// descriptors (4 long longs each, as operand() reads them); `k` is 8
// host words; the rest are device pointers, counts and the CUDA stream.
// Each returns cudaGetLastError() right after the launch (0 = launched),
// or cudaErrorInvalidValue for counts or a shape the kernel does not take.

// out (16, n) = a * b for n = outer * inner elements.
extern "C" int fr_mul(const long long* desc, long long n, long long inner, int32_t* out,
                      void* stream) {
  if (!elementwise_ok(n, inner)) return (int)cudaErrorInvalidValue;
  fr_mul_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      operand<int32_t>(desc), operand<int32_t>(desc + 4), n, inner, out);
  return (int)cudaGetLastError();
}

// out (16, n) = a + b (subtract = 0) or a - b (subtract = 1).
extern "C" int fr_addsub(const long long* desc, long long n, long long inner,
                         int subtract, int32_t* out, void* stream) {
  if (!elementwise_ok(n, inner)) return (int)cudaErrorInvalidValue;
  fr_addsub_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      operand<int32_t>(desc), operand<int32_t>(desc + 4), n, inner, subtract, out);
  return (int)cudaGetLastError();
}

// out (16, n) = V mod r for `rows` relaxed rows (int64 when wide = 1, else
// int32), through `words` words (even) against k = 2^(32 words) mod r.
extern "C" int fr_reduce(const long long* desc, int wide, int rows, int words,
                         const uint32_t* k, long long n, long long inner, int32_t* out,
                         void* stream) {
  if (!elementwise_ok(n, inner) || rows < 1 || words < 2 || words % 2 ||
      2 * words < rows + 2)
    return (int)cudaErrorInvalidValue;
  if (wide)
    fr_reduce_kernel<long long><<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        operand<long long>(desc), rows, words, value(k), n, inner, out);
  else
    fr_reduce_kernel<int32_t><<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        operand<int32_t>(desc), rows, words, value(k), n, inner, out);
  return (int)cudaGetLastError();
}

// out (18, groups) = the exact sums over m terms a group of a (mul = 0)
// or of a * b (mul = 1), a group to each seg-lane segment (seg = 1, 2,
// ..., 32) or to `parts` blocks (seg = 0; groups * parts <= kMaxBlocks
// when parts > 1).  `partials` holds kMaxBlocks x 9 words and `tickets`
// kMaxBlocks words, 0 between launches.
extern "C" int fr_lane_sum(const long long* desc, int mul, long long groups,
                           long long m, int seg, int parts, int32_t* out,
                           unsigned* partials, unsigned* tickets, void* stream) {
  long long blocks;
  if (seg > 0) {
    if (seg > kWarp || (seg & (seg - 1))) return (int)cudaErrorInvalidValue;
    blocks = (groups * seg + kThreads - 1) / kThreads;
  } else {
    if (parts < 1 || (parts > 1 && groups * parts > kMaxBlocks))
      return (int)cudaErrorInvalidValue;
    blocks = groups * parts;
  }
  if (groups < 1 || m < 1 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Op<int32_t> x = operand<int32_t>(desc), y = operand<int32_t>(desc + 4);
  if (mul)
    fr_lane_sum_kernel<true><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        x, y, groups, m, seg, parts, out, partials, tickets);
  else
    fr_lane_sum_kernel<false><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        x, y, groups, m, seg, parts, out, partials, tickets);
  return (int)cudaGetLastError();
}
