// BLS12-381 scalar-field (Fr) arithmetic for one CUDA thread.
//
// r = 0x73eda753...00000001 (255 bits).  An element is 8 little-endian
// 32-bit words held in registers.  The port's tensors keep 16 16-bit
// limbs in int32 (the reference's layout); load()/store() repack limb
// pairs (2k, 2k+1) into word k and back, as fq.cuh's do.
//
// The Montgomery radix is 2^256 (16 x 16 bits = 8 x 32 bits, params.py
// FR_MONT_R).  REDC returns the unique (T + m*r) / 2^256 with
// m = -T * r^-1 mod 2^256, whatever the limb width, so the functions
// below are bit-identical to the plain versions of fields/fp.py on
// canonical operands (< r):
//   mul   canonical Montgomery product: CIOS, then one conditional
//         subtraction (fp.mont_mul_wide = _redc + _cond_sub); its first
//         operand must be below r, its second may be any 256-bit value
//   add   canonical a + b (fp.add: the sum, minus r unless that borrows)
//   sub   canonical a - b (fp.sub: the difference, plus r on a borrow)
//   mont_words  redc over a word stream: x * v * 2^(-32 nw) mod r for a
//         v of nw words, any length (fr_kernels.cu's fr_reduce)
// add and sub drop carries off 2^256 as the plain versions do, so they
// agree with them bit for bit on any 256-bit operands.
//
// Exact sums: add_term / add_sum keep a sum of elements as 288 bits
// (9 words) on the carry chain.  Fewer than 2^31 terms below 2^256 sum
// below 2^287, so such a sum never wraps, in whatever order its parts
// are added; 18 16-bit limbs of it are fp.lane_sum's output.
//
// The Montgomery core is fq.cuh's CIOS on the carry flag with 8 words:
// the same even/odd split of the accumulator (X: pairs at words 0-1,
// 2-3, ..., 6-7; Y: pairs at words 1-2, ..., 7-8), built on fq.cuh's
// carry primitives (add_cc ... mad_pair_from), which emulate the PTX
// instructions in a host build.  r = 1 mod 2^32, so the per-word factor
// -r^-1 mod 2^32 is 0xffffffff.
//
// Why nothing overflows (r < 2^255): the core adds a * b_i for each word
// b_i of b in turn, so after word i the accumulator is
// (a B_i + M_i r) / 2^(32(i+1)) < a + r < 2r < 2^256 for a < r, B_i and
// M_i the low i+1 words of b and m (b itself may be any 256-bit value,
// or, in mont_words, any number of words); within a word it grows by at
// most 2^32 (a + r) < 2^288, so it fits X and Y's 9 words and no carry
// leaves Y's top word.  The result is below 2r, so one subtraction of r
// makes it canonical.
#pragma once

#include <cstdint>

#include "fq.cuh"

namespace fr {

using fq::u32;
using fq::u64;

constexpr int NW = 8;  // 32-bit words per element

__constant__ u32 R[NW] = {0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u,
                          0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};
constexpr u32 NR0 = 0xffffffffu;  // -r^{-1} mod 2^32

struct F {
  u32 w[NW];
};

// Limb rows `ls` int32 apart, lane at `off`: limb pair (2k, 2k+1) -> word k.
__device__ __forceinline__ F load(const int32_t* __restrict__ src, long long ls,
                                  long long off) {
  F r;
  src += off;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    u32 lo = (u32)__ldg(src + (2 * k) * ls);
    u32 hi = (u32)__ldg(src + (2 * k + 1) * ls);
    r.w[k] = (lo & 0xFFFFu) | (hi << 16);
  }
  return r;
}

// (16, n) contiguous output, lane j.
__device__ __forceinline__ void store(int32_t* __restrict__ dst, long long n,
                                      long long j, const F& a) {
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    dst[(2 * k) * n + j] = (int32_t)(a.w[k] & 0xFFFFu);
    dst[(2 * k + 1) * n + j] = (int32_t)(a.w[k] >> 16);
  }
}

// Canonical a + b: a + b < 2r < 2^256 never carries out; minus r unless
// that borrows.
__device__ __forceinline__ F add(const F& a, const F& b) {
  F s, d;
  s.w[0] = fq::add_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int k = 1; k < NW - 1; ++k) s.w[k] = fq::addc_cc(a.w[k], b.w[k]);
  s.w[NW - 1] = fq::addc(a.w[NW - 1], b.w[NW - 1]);
  d.w[0] = fq::sub_cc(s.w[0], R[0]);
#pragma unroll
  for (int k = 1; k < NW; ++k) d.w[k] = fq::subc_cc(s.w[k], R[k]);
  u32 borrow = fq::subc(0u, 0u) & 1u;
  F r;
#pragma unroll
  for (int k = 0; k < NW; ++k) r.w[k] = borrow ? s.w[k] : d.w[k];
  return r;
}

// Canonical a - b: on a borrow, plus r (mod 2^256).
__device__ __forceinline__ F sub(const F& a, const F& b) {
  F d, s;
  d.w[0] = fq::sub_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int k = 1; k < NW; ++k) d.w[k] = fq::subc_cc(a.w[k], b.w[k]);
  u32 borrow = fq::subc(0u, 0u) & 1u;
  s.w[0] = fq::add_cc(d.w[0], R[0]);
#pragma unroll
  for (int k = 1; k < NW - 1; ++k) s.w[k] = fq::addc_cc(d.w[k], R[k]);
  s.w[NW - 1] = fq::addc(d.w[NW - 1], R[NW - 1]);
  F r;
#pragma unroll
  for (int k = 0; k < NW; ++k) r.w[k] = borrow ? s.w[k] : d.w[k];
  return r;
}

// X += a_even * bi (pairs at words j, j+1 for even j), carry out into
// Y's top word (weight 2^256).
__device__ __forceinline__ void row_even(u32* X, u32* Y, const u32* a, u32 bi) {
  fq::mad_pair<false, true>(X[0], X[1], a[0], bi);
#pragma unroll
  for (int j = 2; j < NW; j += 2) fq::mad_pair<true, true>(X[j], X[j + 1], a[j], bi);
  Y[NW - 1] = fq::addc(Y[NW - 1], 0u);
}

// Y += a_odd * bi (pairs at words j + 1, j + 2); its top cannot carry.
__device__ __forceinline__ void row_odd(u32* Y, const u32* a, u32 bi) {
  fq::mad_pair<false, true>(Y[0], Y[1], a[1], bi);
#pragma unroll
  for (int j = 2; j < NW - 2; j += 2)
    fq::mad_pair<true, true>(Y[j], Y[j + 1], a[j + 1], bi);
  fq::mad_pair<true, false>(Y[NW - 2], Y[NW - 1], a[NW - 1], bi);
}

// One word of CIOS: t += a * bi, then m = t[0] * (-r^-1) and t += m * r,
// leaving X[0] = 0.  On entry X, Y hold the state with X[0] already
// shifted out (see mont_core); `first` starts from t = 0.
__device__ __forceinline__ void word_step(u32* X, u32* Y, const F& a, u32 bi,
                                          bool first) {
  if (first) {
#pragma unroll
    for (int j = 0; j < NW; j += 2) {
      fq::mul_pair(X[j], X[j + 1], a.w[j], bi);
      fq::mul_pair(Y[j], Y[j + 1], a.w[j + 1], bi);
    }
  } else {
    // t / 2^32 = (X / 2^32) + Y: X' = Y + X[1], Y' = X >> 64 (in place),
    // the carry of X'[0] + X[1] riding into Y'[0], plus the row a_odd*bi.
    X[0] = fq::add_cc(X[0], Y[1]);
#pragma unroll
    for (int j = 0; j < NW - 2; j += 2)
      fq::mad_pair_from<true>(Y[j], Y[j + 1], a.w[j + 1], bi, Y[j + 2], Y[j + 3]);
    fq::mad_pair_from<false>(Y[NW - 2], Y[NW - 1], a.w[NW - 1], bi, 0u, 0u);
    row_even(X, Y, a.w, bi);
  }
  u32 m = X[0] * NR0;
  row_odd(Y, R, m);
  row_even(X, Y, R, m);
}

// redc(a * b), no final subtraction: below 2r for a, b < r.
__device__ __forceinline__ F mont_core(const F& a, const F& b) {
  u32 even[NW], odd[NW];
#pragma unroll
  for (int i = 0; i < NW; i += 2) {
    word_step(even, odd, a, b.w[i], i == 0);
    word_step(odd, even, a, b.w[i + 1], false);
  }
  // t = odd + 2^32 even with odd[0] = 0: the result is t / 2^32.
  F r;
  r.w[0] = fq::add_cc(even[0], odd[1]);
#pragma unroll
  for (int k = 1; k < NW - 1; ++k) r.w[k] = fq::addc_cc(even[k], odd[k + 1]);
  r.w[NW - 1] = fq::addc(even[NW - 1], 0u);
  return r;
}

// [0, 2r) -> [0, r): minus r unless that borrows.
__device__ __forceinline__ F canon(const F& a) {
  F d;
  d.w[0] = fq::sub_cc(a.w[0], R[0]);
#pragma unroll
  for (int k = 1; k < NW; ++k) d.w[k] = fq::subc_cc(a.w[k], R[k]);
  u32 borrow = fq::subc(0u, 0u) & 1u;
  F r;
#pragma unroll
  for (int k = 0; k < NW; ++k) r.w[k] = borrow ? a.w[k] : d.w[k];
  return r;
}

// Canonical Montgomery product: a < r, b any 256-bit value; output in
// [0, r).
__device__ __forceinline__ F mul(const F& a, const F& b) { return canon(mont_core(a, b)); }

// Canonical x * V * 2^(-32 nw) mod r for x < r and V the nw words that
// next() returns, lowest first (nw even, any length): the core's word
// steps in a loop, from a zero state (a word step from zeros is the
// first word's).
template <class Next>
__device__ __forceinline__ F mont_words(const F& x, int nw, Next next) {
  u32 even[NW], odd[NW];
#pragma unroll
  for (int k = 0; k < NW; ++k) even[k] = odd[k] = 0;
  for (int i = 0; i < nw; i += 2) {
    word_step(even, odd, x, next(), false);
    word_step(odd, even, x, next(), false);
  }
  F r;
  r.w[0] = fq::add_cc(even[0], odd[1]);
#pragma unroll
  for (int k = 1; k < NW - 1; ++k) r.w[k] = fq::addc_cc(even[k], odd[k + 1]);
  r.w[NW - 1] = fq::addc(even[NW - 1], 0u);
  return canon(r);
}

// ---------------------------------------------------------------------------
// Exact sums: 288 bits, 9 little-endian words
// ---------------------------------------------------------------------------

constexpr int SW = NW + 1;  // words of a sum

// s += x for x < 2^256; no carry leaves the top word (headroom above).
__device__ __forceinline__ void add_term(u32* s, const F& x) {
  s[0] = fq::add_cc(s[0], x.w[0]);
#pragma unroll
  for (int k = 1; k < NW; ++k) s[k] = fq::addc_cc(s[k], x.w[k]);
  s[NW] = fq::addc(s[NW], 0u);
}

// s += x, both 288-bit.
__device__ __forceinline__ void add_sum(u32* s, const u32* x) {
  s[0] = fq::add_cc(s[0], x[0]);
#pragma unroll
  for (int k = 1; k < SW - 1; ++k) s[k] = fq::addc_cc(s[k], x[k]);
  s[SW - 1] = fq::addc(s[SW - 1], x[SW - 1]);
}

}  // namespace fr
