// Hand-written Hopper kernels for the MSM window chunk's glue: the work
// between the group-law launches of ops/msm.py `_window_chunk`, which
// gemini_tpu runs inside one jitted program per chunk (XLA-fused, no
// Pallas kernel).
//
//   msm_digits       replaces gemini_tpu/ops/msm.py `extract_digits` +
//                    `extract_signed_digits` (:110-150): the signed
//                    c-bit digits of all W windows in one launch, as
//                    the chunk sort's keys mag << 2 | (neg ^ flip) << 1 |
//                    inf (`flip`: the GLV component's sign; either flag
//                    may be absent, and reads as 0).
//   msm_pack         replaces `_pack_xy` (:178-196), which packs x and y
//                    into one array of limb rows: here each point's x and
//                    y become one 96-byte row of 24 32-bit words (x's
//                    words, then y's, word k = limb 2k | limb 2k+1 << 16),
//                    once per MSM, so the chunks' gathers read 3 sectors a
//                    lane where the (24, N) limb rows take 48.
//   msm_sort_gather  replaces `_sort_gather_proj` (:198-243) after the
//                    sort: the flip and partial bit reversal of the
//                    sorted order (ops/ec_scan.py partial_bitrev_last),
//                    the gather of x and y from the packed rows, negation
//                    of y where the digit is negative, the identity
//                    (0 : 1_mont : 0) for infinity and x = 0 on dead
//                    lanes, the live mask and the ascending digits
//                    sd = skey >> 2.
//   msm_walk_down    replaces gemini_tpu/ops/ec_scan.py `prefix_sums_at`'s
//                    walk-down (:265): the gather at the stop level's scan
//                    and every level's fix-up add, one launch per chunk.
//   msm_combine      replaces gemini_tpu/ops/msm.py `_horner_host` (:153),
//                    which reads the W window totals back and combines
//                    sum_w 2^(c w) T_w on the host: here each set's
//                    Horner chain (c doublings and one add a window, the
//                    highest window first) runs on the card, one launch
//                    per MSM for all its sets, and the result stays there.
//                    Projective only: ops/msm.py `_combine` hands it
//                    Jacobian totals as (X Z, Y, Z^3).
//
// Each equals its plain PyTorch version (ops/msm.py `_digits_plain`,
// `_pack_plain`, `_sort_gather_plain`; ops/ec_scan.py
// `_walk_down_plain`; msm_combine: the chain of padd_core on the same
// operands, and so `_horner_host` once normalized to affine) bit for bit:
// the same digits with every limb a window spans read (gemini_tpu's
// extract_digits reads two limbs at most and drops bits at c = 19), the
// negation is fq::fsub(0, y), which is fields/fp.py's neg (0 - y, plus p
// on a borrow: 0 stays 0), and the walk-down adds with g1_core.cuh's
// padd_core (or add_core under GEMINI_TPU_PROJ=0), the code of padd_kernel
// and add_kernel, on the operands the plain version feeds them; the
// projective walk-down splits padd_core's values over three threads
// (g1_core.cuh padd_split_*), each from the same fq:: call.
//
// What bounds them on an H100:
// - msm_digits: bytes.  A lane reads its L limbs (4 bytes each) and its
//   flags and writes W keys of 8 bytes: at 2^20 lanes and c = 16, 208
//   bytes a lane.  No multiplies.
// - msm_pack: bytes, 192 read and 96 written a point.  The rows go out
//   through a shared tile, so each warp's stores cover whole sectors (a
//   thread's own 6 16-byte stores at a 96-byte stride took 0.208 ms at
//   2^20 points, 43% of the bound, NVIDIA H100 80GB HBM3, 700 W).
// - msm_sort_gather: bytes, each input sector counted once.  A point's
//   packed row is 3 sectors (in the (24, N) limb layout its x and y are
//   48 words in 48 separate sectors: the first design gathered those,
//   1.54 ms at 2^20 lanes, NVIDIA H100 80GB HBM3, 700 W); the keys and
//   the order are a permutation, read whole (8 bytes each a lane); the
//   outputs 209 bytes a lane: 321 bytes a lane at 2^20.  The rows are
//   random reads (96 of the 128 bytes of two DRAM bursts); the keys and
//   the order are read in the partial bit-reversed order, which puts
//   neighbouring output lanes 2^rb keys apart.
// - msm_walk_down: operations.  Each (window, bucket) lane runs one
//   padd (21 x 144 word products, two IMADs each) per reduce-chain level
//   kept; the distinct sectors of its gathers (8 lanes share one where
//   their indices are consecutive) take less time at the HBM rate (at
//   the 2^20 plan 0.044 ms against 0.059 ms of IMADs, NVIDIA H100 80GB
//   HBM3, 700 W).  But its lanes are few: Wc x 2^(c-1), 416 to 32,768
//   over the plans, 8 warps an SM at the 2^20 plan with a thread a lane,
//   where padd needs 12 to reach three quarters of its bound, and each
//   padd is one chain of carries.
// - msm_combine: latency.  Each set is one serial chain of c (W - 1)
//   doublings and W - 1 adds (255 at the 2^20 plan, c = 16, W = 16),
//   and an MSM has 1 to about 20 sets: one SM, a warp or three, and
//   each step waits on the one before.
//
// The design:
// - digits: a thread per scalar, walking the windows in order with the
//   bit buffer and the recode carry in registers; pack: a thread per
//   point.
// - gather: a thread per output lane; where rb >= 2 and n >= 2^(rb+5),
//   a block's lanes are 32 consecutive hi times 4 jtop, its keys and
//   order read as whole sectors into shared memory and each warp's
//   stores whole lines (a warp of 8 hi x 4 jtop writing 4 runs of 8
//   lanes was slower at the 2^14 and 2^18 plans, NVIDIA H100 80GB HBM3,
//   700 W).  Other shapes (c = 19 at 2^16, c = 2 at 2^18, the 2^8 GLV
//   plan) keep a thread on its own lane.
// - walk-down, projective: three threads a (window, bucket) lane, one
//   warp per role, each with 7 of padd's 21 products (g1_core.cuh
//   padd_split_*), the products and their combinations exchanged in
//   shared memory: three times the warps of a thread a lane (24 an SM
//   at the 2^20 plan).  A block is 32 lanes, the smallest that keeps the
//   roles warp-uniform, so a small launch still spreads over all SMs.
//   __launch_bounds__(96, 8) holds it to 80 registers, so that the 2^20
//   plan's 1,024 blocks are resident in one wave; the exchange is 18 KB
//   a block, so the SM keeps most of its L1 for the level gathers (with
//   the shared carveout at its maximum the same kernel was 28% slower).
//   Jacobian (GEMINI_TPU_PROJ=0): a thread a lane with add_core, whose
//   doubling branch a split would diverge on; __launch_bounds__(128)
//   lets it take registers rather than occupancy.
// - The walk-down's levels are passed as up to kMaxLevels descriptors
//   (x, y, z or mask, each with (limb, row, lane) strides; the lane
//   count's log and the level's reversed bits) in a __grid_constant__
//   parameter, indexed by the level in a loop whose body is one add.  rb
//   (the levels kept) reaches 7 in the plans from 2^8 to 2^22 lanes, GLV
//   included; a caller's smaller window (msm's c=) can give more, which
//   take one launch per kMaxLevels, each after the first starting from
//   the sums the one before wrote.
// - The pack runs once per MSM (per shard), the gather once per chunk:
//   at 2^20 lanes 16 chunks read the same points.
// - combine: three threads a set, one warp per role, as in
//   the walk-down (each doubling is padd_core(acc, acc), which is
//   complete, so the identity needs no branch): 1.00 ms at the 2^20
//   plan, where a thread a set with padd_core took 2.58 ms, and a thread
//   a set with the Jacobian dbl_core and add_core 1.90 ms (NVIDIA H100
//   80GB HBM3, 700 W).

#include <cuda_runtime.h>

#include "fq.cuh"
#include "g1_core.cuh"

using fq::F;
using g1::kThreads;

namespace {

constexpr int kMaxLevels = 8;
// Blocks of the split walk-down an SM holds: 8 x 96 threads at up to 80
// registers (65,536 / 768 = 85, in ptxas's granule of 8), and 8 x 18 KB
// of exchange in the SM's 228 KB of shared memory.
constexpr int kSplitBlocks = 8;

// 1_mont = 2^384 mod p, the identity's y.
__constant__ uint32_t ONE_M[fq::NW] = {
    0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau, 0x5f489857u,
    0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u};

__device__ __forceinline__ F one_mont() {
  F r;
#pragma unroll
  for (int k = 0; k < fq::NW; ++k) r.w[k] = ONE_M[k];
  return r;
}

// The low r bits of v reversed (r in 1..31).
__device__ __forceinline__ unsigned rev_bits(unsigned v, int r) {
#ifdef __CUDA_ARCH__
  return __brev(v) >> (32 - r);
#else
  unsigned out = 0;
  for (int k = 0; k < r; ++k) out |= ((v >> k) & 1u) << (r - 1 - k);
  return out;
#endif
}

struct Digits {
  const int32_t* s;  // (L, n) canonical limbs
  long long ls, es;
  int limbs, c, windows;
  long long n;
  const uint8_t* inf;  // (n,) bool or null
  long long inf_es;
  const uint8_t* flip;  // (n,) bool or null
  long long flip_es;
  long long* key;  // (W, n)
};

// Window w's raw digit is bits [w c, w c + c) of the scalar, from a bit
// buffer refilled one 16-bit limb at a time (limbs past L read as 0);
// d = raw + carry, negative (2^c - d, carry 1) when d > 2^(c-1).
__global__ void __launch_bounds__(kThreads) msm_digits_kernel(const Digits d) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= d.n) return;
  const int32_t* s = d.s + j * d.es;
  const uint32_t mask = (1u << d.c) - 1u, half = 1u << (d.c - 1);
  const uint32_t full = half << 1;
  const long long inf = d.inf ? (d.inf[j * d.inf_es] != 0) : 0;
  const uint32_t flip = d.flip ? (d.flip[j * d.flip_es] != 0) : 0u;
  uint64_t buf = 0;
  int have = 0, next = 0;
  uint32_t carry = 0;
  for (int w = 0; w < d.windows; ++w) {
    while (have < d.c) {
      const uint32_t limb = next < d.limbs ? ((uint32_t)__ldg(s + next * d.ls) & 0xFFFFu) : 0u;
      buf |= (uint64_t)limb << have;
      have += 16;
      ++next;
    }
    const uint32_t dd = ((uint32_t)buf & mask) + carry;
    buf >>= d.c;
    have -= d.c;
    const uint32_t neg = dd > half;
    const uint32_t mag = neg ? full - dd : dd;
    carry = neg;
    d.key[(long long)w * d.n + j] =
        ((long long)mag << 2) | (long long)((neg ^ flip) << 1) | inf;
  }
}

struct Pack {
  const int32_t* px;  // (24, N) x limbs
  long long xls, xes;
  const int32_t* py;  // (24, N) y limbs
  long long yls, yes;
  long long n;
  uint4* out;  // (N, 24) words: 6 uint4 a point
};

// One thread per point: its 48 limbs (coalesced rows) into 6 16-byte
// words of a shared tile, then the block's rows (contiguous in the
// output) written out 16 bytes a thread, consecutive threads at
// consecutive addresses.
__global__ void __launch_bounds__(kThreads) msm_pack_kernel(const Pack k) {
  __shared__ uint4 tile[6 * kThreads];
  const long long base = (long long)blockIdx.x * blockDim.x;
  const long long j = base + threadIdx.x;
  if (j < k.n) {
    const F x = fq::load(k.px, k.xls, j * k.xes);
    const F y = fq::load(k.py, k.yls, j * k.yes);
    uint4* row = tile + 6 * threadIdx.x;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      row[q] = make_uint4(x.w[4 * q], x.w[4 * q + 1], x.w[4 * q + 2], x.w[4 * q + 3]);
      row[3 + q] = make_uint4(y.w[4 * q], y.w[4 * q + 1], y.w[4 * q + 2], y.w[4 * q + 3]);
    }
  }
  __syncthreads();
  const long long rows = k.n - base < (long long)blockDim.x ? k.n - base : blockDim.x;
  uint4* out = k.out + 6 * base;
  for (int q = threadIdx.x; q < 6 * rows; q += blockDim.x) out[q] = tile[q];
}

struct Gather {
  const uint4* pp;  // (N, 24) packed points (msm_pack)
  const long long* skey;  // (Wc, n) sorted keys, ascending
  const long long* order;  // (Wc, n) the sort's indices
  int log_n, rb;
  long long lanes;  // Wc * n
  int32_t* x;       // (24, Wc * n)
  int32_t* y;
  uint8_t* mask;    // (Wc * n)
  long long* sd;    // (Wc * n)
};

// Output storage lane (w, j) of the partial bit-reversed layout holds
// logical index p = (hi << rb) | rev(jtop) of the flipped (descending)
// order, j = (jtop: rb bits, hi: log_n - rb bits), so its source is the
// sorted position n - 1 - p: neighbouring lanes' sources are 2^rb keys
// apart.  Where rb >= 2 and n >= 2^(rb + 5), a block of 128 threads
// fills 32 consecutive hi times 4 values of jtop that differ in their
// top two bits (whose reversals are 4 consecutive values), warp a the
// 32 lanes of jtop = J | a << (rb - 2): whole 128-byte lines of each
// limb row.  Its keys and order come in first through shared memory,
// each warp reading 8 hi times the 4 jtop: for each hi one aligned
// 32-byte sector of each array (8 sectors a warp, where 32 lanes 2^rb
// keys apart take 32).  Other shapes take a thread on its own lane.
// sd = skey >> 2 goes out at the thread's own lane either way.
__host__ __device__ __forceinline__ bool gather_blocked(int log_n, int rb) {
  return rb >= 2 && log_n - rb >= 5;
}

__global__ void __launch_bounds__(kThreads) msm_sort_gather_kernel(const Gather g) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= g.lanes) return;
  const unsigned nmask = (1u << g.log_n) - 1u;
  const long long row = t & ~(long long)nmask;
  const unsigned i = (unsigned)(t & nmask);
  g.sd[t] = g.skey[t] >> 2;
  const int shift = g.log_n - g.rb;
  unsigned j = i;
  long long k, o;
  if (gather_blocked(g.log_n, g.rb)) {  // the whole launch: its blocks are whole
    __shared__ long long sk[kThreads], so[kThreads];
    const unsigned x = threadIdx.x, blk = i >> 7;
    const unsigned hp = blk & ((1u << (shift - 5)) - 1u), jlo = blk >> (shift - 5);
    // this thread reads for lane (a, hoff) of the block
    const unsigned a = (x >> 3) & 3u, hoff = (x & 7u) | ((x >> 5) << 3);
    const unsigned p =
        (((hp << 5) | hoff) << g.rb) | rev_bits(jlo | (a << (g.rb - 2)), g.rb);
    sk[a * 32 + hoff] = g.skey[row + (nmask - p)];
    so[a * 32 + hoff] = g.order[row + (nmask - p)];
    __syncthreads();
    k = sk[x];
    o = so[x];
    j = (x & 31u) | (hp << 5) | (jlo << shift) | ((x >> 5) << (g.log_n - 2));
  } else {
    const unsigned hi = j & ((1u << shift) - 1u);
    const unsigned p = (hi << g.rb) | (g.rb ? rev_bits(j >> shift, g.rb) : 0u);
    k = g.skey[row + (nmask - p)];
    o = g.order[row + (nmask - p)];
  }
  const bool inf = k & 1, neg = (k >> 1) & 1, dead = inf || (k >> 2) == 0;
  const F zero = fq::zero();
  F gx, gy;
  const uint4* packed = g.pp + 6 * o;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const uint4 a = __ldg(packed + q);
    const uint4 b = __ldg(packed + 3 + q);
    gx.w[4 * q] = a.x;
    gx.w[4 * q + 1] = a.y;
    gx.w[4 * q + 2] = a.z;
    gx.w[4 * q + 3] = a.w;
    gy.w[4 * q] = b.x;
    gy.w[4 * q + 1] = b.y;
    gy.w[4 * q + 2] = b.z;
    gy.w[4 * q + 3] = b.w;
  }
  const long long out = row + j;
  fq::store(g.x, g.lanes, out, fq::select(dead, zero, gx));
  fq::store(g.y, g.lanes, out,
            inf ? one_mont() : (neg ? fq::fsub(zero, gy) : gy));
  g.mask[out] = !dead;
}

struct Level {
  g1::Operand c[3];  // x, y, z (or the bool mask)
  int log_n, r, is01;
};

struct Walk {
  Level lv[kMaxLevels];  // reduce-chain levels lo.., the lowest first
  int levels;
  int lo;       // the first level's index in the chain
  int chained;  // top: the sums at level lo + levels (a launch's output)
  g1::Operand top[3];    // the stop level's inclusive scan, or (chained)
                         // the previous launch's (24, Wc, m) sums
  const long long* pos;  // (Wc, m) positions in [-1, n - 1] at level 0
  unsigned m, lanes;     // positions per window, Wc * m
  int32_t* out[3];       // (24, Wc * m)
};

struct RegLoad {
  const F* acc;
  const F* op;
  __device__ __forceinline__ F operator()(int k) const { return k < 3 ? acc[k] : op[k - 3]; }
};

struct RegPut {
  F* out;
  __device__ __forceinline__ void operator()(int c, const F& v) const { out[c] = v; }
};

// A lane's position at level lo of the chain, ((p + 1) >> lo) - 1 (p's
// (p - 1) >> 1 taken lo times), and at the top, `levels` levels up.
__device__ __forceinline__ long long level_pos(const Walk& d, unsigned t, int levels) {
  long long pk = ((d.pos[t] + 1) >> d.lo) - 1;
  for (int k = 0; k < levels; ++k) pk = (pk - 1) >> 1;
  return pk;
}

// Coordinate c of the accumulator's start: the previous launch's sum at
// the lane (chained), else the scan at the top position, or the
// identity (0 : 1_mont : 0) where that is -1.
__device__ __forceinline__ F walk_top(const Walk& d, unsigned t, unsigned w, int c) {
  if (d.chained) return g1::load_op(d.top[c], w, t - w * d.m);
  const long long top = level_pos(d, t, d.levels);
  if (top >= 0) return g1::load_op(d.top[c], w, (unsigned)top);
  return c == 1 ? one_mont() : fq::zero();
}

// Coordinate c of level lev's operand at the lane's position pk: (x or
// 0, y, z or 0), x and z kept where pk is even, y unmasked as in the
// plain version (RCB scales its output by the identity's y); on a 0/1
// level z is 1_mont where the position is even and the mask set.
__device__ __forceinline__ F walk_op(const Level& L, unsigned w, long long pk, int c) {
  const bool even = pk >= 0 && (pk & 1) == 0;
  const unsigned pc = pk < 0 ? 0u : (unsigned)pk;
  const unsigned sidx =
      L.r > 0 ? (rev_bits(pc, L.r) << (L.log_n - L.r)) | (pc >> L.r) : pc;
  if (c == 1) return g1::load_op(L.c[1], w, sidx);
  if (c == 2 && L.is01)
    return (even && g1::load_mask(L.c[2], w, sidx)) ? one_mont() : fq::zero();
  return even ? g1::load_op(L.c[c], w, sidx) : fq::zero();
}

// S(p) = S_reduced((p - 1) >> 1) + (P[p] if p is even else the identity),
// from the stop level down: the accumulator starts at walk_top, then
// each level adds walk_op at its position's stored index.  A chain of
// more than kMaxLevels levels takes one launch per kMaxLevels, the
// highest first, each after the first starting from the sums the one
// before wrote.
//
// The Jacobian walk-down (GEMINI_TPU_PROJ=0): one thread per lane, the
// accumulator in registers, add_core (the code of add_kernel).
__global__ void __launch_bounds__(kThreads)
    msm_walk_down_kernel(const __grid_constant__ Walk d) {
  const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= d.lanes) return;
  const unsigned w = t / d.m;
  F acc[3], op[3], out[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) acc[c] = walk_top(d, t, w, c);
  __shared__ volatile uint32_t sm[4][fq::NW][kThreads];
  for (int lev = d.levels - 1; lev >= 0; --lev) {
    const long long pk = level_pos(d, t, lev);
#pragma unroll
    for (int c = 0; c < 3; ++c) op[c] = walk_op(d.lv[lev], w, pk, c);
    const RegLoad ld{acc, op};
    g1::add_core(ld, ld, RegPut{out}, &sm[0][0][threadIdx.x]);
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[c] = out[c];
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) fq::store(d.out[c], d.lanes, t, acc[c]);
}

// The projective walk-down: each lane's padd split over three threads
// (g1_core.cuh padd_split_*), one warp per role, a block per
// kSplitLanes lanes.  Role c loads coordinate c of the start and of each
// level's operand into the exchange and keeps coordinate c of the
// accumulator; the next level's operand is read in step 2 and stored
// after step 3 (read in step 1, or copied by cp.async in step 3, it
// measured slower).
// The threads of lanes past the last run with the last lane's operands
// and store nothing.
__global__ void __launch_bounds__(g1::kSplitThreads, kSplitBlocks)
    msm_walk_down_split_kernel(const __grid_constant__ Walk d) {
  __shared__ __align__(16) uint32_t ex[g1::kSplitWords];
  const int role = threadIdx.x / g1::kSplitLanes;
  const unsigned l = threadIdx.x % g1::kSplitLanes;
  const unsigned t0 = blockIdx.x * g1::kSplitLanes + l;
  const unsigned t = t0 < d.lanes ? t0 : d.lanes - 1;
  const unsigned w = t / d.m;
  const g1::SplitLane s{ex + fq::NW * l};
  F acc = walk_top(d, t, w, role);
  int x = 0;  // the set that holds the accumulator and the operand
  if (d.levels > 0) {
    const int lev = d.levels - 1;
    s.put(x + role, acc);
    s.put(x + 3 + role, walk_op(d.lv[lev], w, level_pos(d, t, lev), role));
  }
  for (int lev = d.levels - 1; lev >= 0; --lev) {
    const int y = g1::kSplitSet - x;
    __syncthreads();
    g1::padd_split_products(role, s, x, y);
    __syncthreads();
    F next;
    if (lev > 0) next = walk_op(d.lv[lev - 1], w, level_pos(d, t, lev - 1), role);
    g1::padd_split_finals(role, s, y, x);
    __syncthreads();
    acc = g1::padd_split_result(role, s, x);
    if (lev > 0) {
      s.put(y + role, acc);
      s.put(y + 3 + role, next);
    }
    x = y;
  }
  if (t0 < d.lanes) fq::store(d.out[role], d.lanes, t, acc);
}

struct Combine {
  g1::Operand in[3];  // x, y, z of (24, sets * W): set s's window w at
                      // batch s, lane w
  int sets, windows, c;
  int32_t* out[3];  // (24, sets)
};

// acc = T_(W-1); then for w = W - 2 down to 0, c doublings and acc += T_w,
// on projective totals (< 2p, identity (0 : y : 0), y nonzero): each set's padd split over three threads (g1_core.cuh
// padd_split_*), one warp per role, a block per kSplitLanes sets; role r
// keeps coordinate r of the accumulator and puts it, with coordinate r
// of the operand (the accumulator itself for a doubling, else T_w, read
// before the window's doublings), into the exchange before each padd.
// The threads of sets past the last run with the last set's operands and
// store nothing.
__global__ void __launch_bounds__(g1::kSplitThreads)
    msm_combine_kernel(const __grid_constant__ Combine d) {
  __shared__ __align__(16) uint32_t ex[g1::kSplitWords];
  const int role = threadIdx.x / g1::kSplitLanes;
  const unsigned l = threadIdx.x % g1::kSplitLanes;
  const unsigned s0 = blockIdx.x * g1::kSplitLanes + l;
  const unsigned s = s0 < (unsigned)d.sets ? s0 : d.sets - 1;
  const g1::SplitLane lane{ex + fq::NW * l};
  F acc = g1::load_op(d.in[role], s, d.windows - 1);
  int x = 0;  // the set that holds the accumulator and the operand
  for (int w = d.windows - 2; w >= 0; --w) {
    const F op = g1::load_op(d.in[role], s, w);
    for (int k = 0; k <= d.c; ++k) {
      const int y = g1::kSplitSet - x;
      lane.put(x + role, acc);
      lane.put(x + 3 + role, k < d.c ? acc : op);
      __syncthreads();
      g1::padd_split_products(role, lane, x, y);
      __syncthreads();
      g1::padd_split_finals(role, lane, y, x);
      __syncthreads();
      acc = g1::padd_split_result(role, lane, x);
      x = y;
    }
  }
  if (s0 < (unsigned)d.sets) fq::store(d.out[role], d.sets, s, acc);
}

unsigned blocks_for(long long n, int t) { return (unsigned)((n + t - 1) / t); }

g1::Operand operand(const long long* q) {
  return g1::Operand{(const void*)q[0], q[1], q[2], q[3]};
}

}  // namespace

// C interface for ctypes: device pointers, strides in elements, lane
// counts and the CUDA stream.  Each returns cudaGetLastError() right after
// the launch (0 = launched), or cudaErrorInvalidValue for arguments the
// kernel does not take.

extern "C" int msm_digits(const int32_t* s, long long ls, long long es, int limbs,
                          long long n, int c, int windows, const uint8_t* inf,
                          long long inf_es, const uint8_t* flip, long long flip_es,
                          long long* key, void* stream) {
  if (c < 2 || c > 31 || limbs < 1) return (int)cudaErrorInvalidValue;
  if (n <= 0 || windows <= 0) return 0;
  const Digits d{s, ls, es, limbs, c, windows, n, inf, inf_es, flip, flip_es, key};
  msm_digits_kernel<<<blocks_for(n, kThreads), kThreads, 0, (cudaStream_t)stream>>>(d);
  return (int)cudaGetLastError();
}

extern "C" int msm_pack(const int32_t* px, long long xls, long long xes,
                        const int32_t* py, long long yls, long long yes, long long n,
                        int32_t* out, void* stream) {
  if (n <= 0) return 0;
  const Pack k{px, xls, xes, py, yls, yes, n, (uint4*)out};
  msm_pack_kernel<<<blocks_for(n, kThreads), kThreads, 0, (cudaStream_t)stream>>>(k);
  return (int)cudaGetLastError();
}

extern "C" int msm_sort_gather(const int32_t* pp, const long long* skey,
                               const long long* order, int log_n, int rb,
                               long long lanes, int32_t* x, int32_t* y, uint8_t* mask,
                               long long* sd, void* stream) {
  if (log_n < 0 || log_n > 30 || rb < 0 || rb > log_n) return (int)cudaErrorInvalidValue;
  if (lanes <= 0) return 0;
  const Gather g{(const uint4*)pp, skey, order, log_n, rb, lanes, x, y, mask, sd};
  msm_sort_gather_kernel<<<blocks_for(lanes, kThreads), kThreads, 0,
                           (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}

// Whether msm_sort_gather fills windows of 2^log_n lanes with rb
// reversed bits by its block mapping (1) or a thread a lane (0).
extern "C" int msm_sort_gather_blocked(int log_n, int rb) {
  return gather_blocked(log_n, rb);
}

// levels: per level x, y, z (pointer, limb, row and lane strides), then
// the lane count's log, the reversed bits and is01 (15 values), from
// level lo up; top: the scan's x, y, z, or with `chained` the previous
// launch's sums (12 values).
extern "C" int msm_walk_down(const long long* levels, int nlev, int lo, int chained,
                             const long long* top, const long long* pos, long long m,
                             long long lanes, int32_t* ox, int32_t* oy, int32_t* oz,
                             int proj, void* stream) {
  if (nlev < 0 || nlev > kMaxLevels || lo < 0 || lo > 62 || m <= 0 ||
      lanes >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  if (lanes <= 0) return 0;
  Walk d;
  for (int k = 0; k < nlev; ++k) {
    const long long* q = levels + 15 * k;
    for (int c = 0; c < 3; ++c) d.lv[k].c[c] = operand(q + 4 * c);
    d.lv[k].log_n = (int)q[12];
    d.lv[k].r = (int)q[13];
    d.lv[k].is01 = (int)q[14];
  }
  for (int k = nlev; k < kMaxLevels; ++k) d.lv[k] = Level{};
  d.levels = nlev;
  d.lo = lo;
  d.chained = chained;
  for (int c = 0; c < 3; ++c) d.top[c] = operand(top + 4 * c);
  d.pos = pos;
  d.m = (unsigned)m;
  d.lanes = (unsigned)lanes;
  d.out[0] = ox;
  d.out[1] = oy;
  d.out[2] = oz;
  if (proj) {
    msm_walk_down_split_kernel<<<blocks_for(lanes, g1::kSplitLanes), g1::kSplitThreads, 0,
                                 (cudaStream_t)stream>>>(d);
  } else {
    const int t = g1::threads_for(lanes);
    msm_walk_down_kernel<<<blocks_for(lanes, t), t, 0, (cudaStream_t)stream>>>(d);
  }
  return (int)cudaGetLastError();
}

// in: the totals' x, y, z (pointer, limb, batch and lane strides: 12
// values), set s's window w at batch s, lane w.
extern "C" int msm_combine(const long long* in, int sets, int windows, int c,
                           int32_t* ox, int32_t* oy, int32_t* oz, void* stream) {
  if (sets < 0 || windows < 1 || c < 1 || (long long)sets * windows >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  if (sets == 0) return 0;
  Combine d;
  for (int k = 0; k < 3; ++k) d.in[k] = operand(in + 4 * k);
  d.sets = sets;
  d.windows = windows;
  d.c = c;
  d.out[0] = ox;
  d.out[1] = oy;
  d.out[2] = oz;
  msm_combine_kernel<<<blocks_for(sets, g1::kSplitLanes), g1::kSplitThreads, 0,
                       (cudaStream_t)stream>>>(d);
  return (int)cudaGetLastError();
}

// The split walk-down's resources on the current device: blocks an SM
// holds (the occupancy API), registers a thread, local (spill) bytes a
// thread, static shared bytes a block.
extern "C" int msm_walk_down_occupancy(int* out) {
  cudaFuncAttributes a;
  int err = (int)cudaFuncGetAttributes(&a, msm_walk_down_split_kernel);
  if (err) return err;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, msm_walk_down_split_kernel, g1::kSplitThreads, 0);
  out[1] = a.numRegs;
  out[2] = (int)a.localSizeBytes;
  out[3] = (int)a.sharedSizeBytes;
  return err;
}
