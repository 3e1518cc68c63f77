// BLS12-381 base-field (Fq) arithmetic for one CUDA thread.
//
// An element is 12 little-endian 32-bit words held in registers.  The
// port's tensors keep 24 16-bit limbs in int32 (the reference's layout);
// load()/store() repack limb pairs (2k, 2k+1) into word k and back.
//
// The Montgomery radix is 2^384 as in the reference (24 x 16 bits =
// 12 x 32 bits), and REDC returns the unique (T + m*p) / 2^384 with
// m = -T * p^-1 mod 2^384, whatever the limb width and whether the
// reduction runs after the product or interleaved with it, so every
// function below is bit-identical to its counterpart in
// gemini_tpu/curve/pallas_g1.py (`_F`) on the contract's domain
// (operands < 2p; rneg's 2p included), relaxed values included:
//   rmm      redc(a*b), no final subtraction       (_F.rmm)
//   rmm_add  redc(a*b + c*d), one shared reduction (_F.rmm_add)
//   rmm_sub  redc(a*b + c*(2p - d))                (_F.rmm_sub, rneg(0) = 2p)
//   radd     a + b, minus 2p when the sum is >= 2p (_F.radd)
//   rsub     a - b, plus 2p on a borrow            (_F.rsub)
//   mm       redc(a*b) reduced into [0, p)         (_F.mm)
//   canon    [0, 2p) reduced into [0, p)
//   is_zero_rel  a in [0, 2p) is 0 mod p (a = 0 or a = p)
//   fadd, fdbl, fsub, is_zero: the canonical ops (_F.fadd/fdbl/fsub)
// Additions and subtractions are taken mod 2^384, dropping carries off
// the top exactly where the reference drops them.
//
// The Montgomery core (mont_core) is CIOS on the carry flag: product and
// reduction interleaved word by word, every word product one
// mad.lo.cc / madc.hi.cc pair into a 64-bit register pair, which ptxas
// can issue as one wide multiply-add with carry in and out.  Neighbouring
// word products of one row overlap by a word, so the accumulator is split
// into an even half X (pairs at words 0-1, 2-3, ..., 10-11) and an odd
// half Y (pairs at words 1-2, ..., 11-12): t = X + 2^32 Y, two
// independent carry chains per row.  After each word's reduction X[0] is
// 0 and the shift by one word is a change of roles: X' = Y plus X[1],
// Y' = X shifted by two words, folded into the next row's chain (sppark's
// even/odd layout, Emmart et al.'s "Optimizing modular multiplication for
// NVIDIA's Maxwell GPUs" for the split).  24 accumulator words are live,
// against the 25-word product plus the operands of a separate
// multiply-then-reduce.
//
// Why nothing overflows (p < 2^381): after word i the accumulator is
// (A_i B + C_i D + M_i p) / 2^(32(i+1)) < B + D + p <= 5p < 2^384, where
// A_i, C_i, M_i are the low i+1 words of a, c, m; within a word it grows
// by at most 2^32 (B + D + p), so it stays below 2^416 = 13 words, Y
// below 2^384, and no carry leaves Y's top word.
//
// The carry primitives are one PTX instruction each, in `asm volatile`
// so the compiler keeps their order (the carry flag is not a C value).
// Without __CUDA_ARCH__ (a host build of the kernel bodies, used to hold
// them against the plain versions before a chip run) they emulate the
// same instructions with a carry variable.
#pragma once

#include <cstdint>

namespace fq {

typedef uint32_t u32;
typedef uint64_t u64;

constexpr int NW = 12;  // 32-bit words per element

__constant__ u32 P[NW] = {
    0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u,
    0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
__constant__ u32 P2[NW] = {  // 2p
    0xffff5556u, 0x73fdffffu, 0x62a7ffffu, 0x3d57fffdu, 0xed61ec48u, 0xce61a541u,
    0xe70a257eu, 0xc8ee9709u, 0x869759aeu, 0x96374f6cu, 0x72ffcd34u, 0x340223d4u};
__constant__ u32 TWELVE_M[NW] = {  // 12 in Montgomery form (12 * 2^384 mod p)
    0x0027552eu, 0x44760000u, 0x43480020u, 0xdcb8009au, 0x4a6e8b59u, 0x6f7ee9ceu,
    0xc0a95bc6u, 0xb10330b7u, 0xfb1e54b7u, 0x6140b1fcu, 0x7f0bb4e1u, 0x0381be09u};
constexpr u32 NP0 = 0xfffcfffdu;  // -p^{-1} mod 2^32

struct F {
  u32 w[NW];
  __device__ __forceinline__ u32 operator[](int k) const { return w[k]; }
};

// ---------------------------------------------------------------------------
// Carry-flag primitives
// ---------------------------------------------------------------------------

#ifdef __CUDA_ARCH__
#define FQ_ASM(...) asm volatile(__VA_ARGS__)
#else
static u32 host_cf;  // the emulated carry flag
#endif

__device__ __forceinline__ u32 add_cc(u32 a, u32 b) {  // a + b, carry out
#ifdef __CUDA_ARCH__
  u32 r;
  FQ_ASM("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
#else
  u64 s = (u64)a + b;
  host_cf = (u32)(s >> 32);
  return (u32)s;
#endif
}

__device__ __forceinline__ u32 addc_cc(u32 a, u32 b) {  // a + b + cf, carry out
#ifdef __CUDA_ARCH__
  u32 r;
  FQ_ASM("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
#else
  u64 s = (u64)a + b + host_cf;
  host_cf = (u32)(s >> 32);
  return (u32)s;
#endif
}

__device__ __forceinline__ u32 addc(u32 a, u32 b) {  // a + b + cf
#ifdef __CUDA_ARCH__
  u32 r;
  FQ_ASM("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
#else
  return (u32)((u64)a + b + host_cf);
#endif
}

__device__ __forceinline__ u32 sub_cc(u32 a, u32 b) {  // a - b, borrow out
#ifdef __CUDA_ARCH__
  u32 r;
  FQ_ASM("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
#else
  host_cf = a < b;
  return a - b;
#endif
}

__device__ __forceinline__ u32 subc_cc(u32 a, u32 b) {  // a - b - cf, borrow out
#ifdef __CUDA_ARCH__
  u32 r;
  FQ_ASM("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
#else
  u64 d = (u64)a - b - host_cf;
  host_cf = (u32)(d >> 32) & 1u;
  return (u32)d;
#endif
}

__device__ __forceinline__ u32 subc(u32 a, u32 b) {  // a - b - cf
#ifdef __CUDA_ARCH__
  u32 r;
  FQ_ASM("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
#else
  return a - b - host_cf;
#endif
}

// (lo, hi) = a * b, no carry in or out.
__device__ __forceinline__ void mul_pair(u32& lo, u32& hi, u32 a, u32 b) {
#ifdef __CUDA_ARCH__
  FQ_ASM("mul.lo.u32 %0, %2, %3; mul.hi.u32 %1, %2, %3;"
         : "=&r"(lo), "=r"(hi) : "r"(a), "r"(b));
#else
  u64 p = (u64)a * b;
  lo = (u32)p;
  hi = (u32)(p >> 32);
#endif
}

// (lo, hi) += a * b [+ cf]: the first pair of a chain (no carry in), a
// middle pair (carry in and out) and the last pair of a chain whose top
// cannot carry (carry in, none out).
template <bool CIN, bool COUT>
__device__ __forceinline__ void mad_pair(u32& lo, u32& hi, u32 a, u32 b) {
#ifdef __CUDA_ARCH__
  if (!CIN)
    FQ_ASM("mad.lo.cc.u32 %0, %2, %3, %0; madc.hi.cc.u32 %1, %2, %3, %1;"
           : "+r"(lo), "+r"(hi) : "r"(a), "r"(b));
  else if (COUT)
    FQ_ASM("madc.lo.cc.u32 %0, %2, %3, %0; madc.hi.cc.u32 %1, %2, %3, %1;"
           : "+r"(lo), "+r"(hi) : "r"(a), "r"(b));
  else
    FQ_ASM("madc.lo.cc.u32 %0, %2, %3, %0; madc.hi.u32 %1, %2, %3, %1;"
           : "+r"(lo), "+r"(hi) : "r"(a), "r"(b));
#else
  u64 p = (u64)a * b;
  u64 s = (u64)lo + (u32)p + (CIN ? host_cf : 0u);
  lo = (u32)s;
  s = (u64)hi + (u32)(p >> 32) + (u32)(s >> 32);
  hi = (u32)s;
  host_cf = (u32)(s >> 32);
#endif
}

// (lo, hi) = a * b + (c0, c1) + cf, carry out: a row's pair that also
// moves the previous accumulator down by two words.
template <bool COUT>
__device__ __forceinline__ void mad_pair_from(u32& lo, u32& hi, u32 a, u32 b,
                                              u32 c0, u32 c1) {
#ifdef __CUDA_ARCH__
  if (COUT)
    FQ_ASM("madc.lo.cc.u32 %0, %2, %3, %4; madc.hi.cc.u32 %1, %2, %3, %5;"
           : "=&r"(lo), "=r"(hi) : "r"(a), "r"(b), "r"(c0), "r"(c1));
  else
    FQ_ASM("madc.lo.cc.u32 %0, %2, %3, %4; madc.hi.u32 %1, %2, %3, %5;"
           : "=&r"(lo), "=r"(hi) : "r"(a), "r"(b), "r"(c0), "r"(c1));
#else
  u64 p = (u64)a * b;
  u64 s = (u64)c0 + (u32)p + host_cf;
  lo = (u32)s;
  s = (u64)c1 + (u32)(p >> 32) + (u32)(s >> 32);
  hi = (u32)s;
  host_cf = (u32)(s >> 32);
#endif
}

// ---------------------------------------------------------------------------
// Loads, stores, selects
// ---------------------------------------------------------------------------

// Limb rows `ls` int32 apart, lane at `off`: limb pair (2k, 2k+1) -> word
// k.  Neighbouring threads read neighbouring lanes (lane stride 1 or 2),
// so a limb row is one coalesced load.
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

// (24, n) contiguous output, lane j.
__device__ __forceinline__ void store(int32_t* __restrict__ dst, long long n,
                                      long long j, const F& a) {
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    dst[(2 * k) * n + j] = (int32_t)(a.w[k] & 0xFFFFu);
    dst[(2 * k + 1) * n + j] = (int32_t)(a.w[k] >> 16);
  }
}

__device__ __forceinline__ F zero() {
  F r;
#pragma unroll
  for (int k = 0; k < NW; ++k) r.w[k] = 0;
  return r;
}

__device__ __forceinline__ F select(bool c, const F& a, const F& b) {
  F r;
#pragma unroll
  for (int k = 0; k < NW; ++k) r.w[k] = c ? a.w[k] : b.w[k];
  return r;
}

// ---------------------------------------------------------------------------
// Additive ops on carry chains
// ---------------------------------------------------------------------------

// (a + b) mod 2^384; `carry` = the carry out of the top word.
__device__ __forceinline__ F add_raw(const u32* a, const u32* b, u32& carry) {
  F r;
  r.w[0] = add_cc(a[0], b[0]);
#pragma unroll
  for (int k = 1; k < NW; ++k) r.w[k] = addc_cc(a[k], b[k]);
  carry = addc(0u, 0u);
  return r;
}

// (a - b) mod 2^384; `borrow` = 1 when a < b.
__device__ __forceinline__ F sub_raw(const u32* a, const u32* b, u32& borrow) {
  F r;
  r.w[0] = sub_cc(a[0], b[0]);
#pragma unroll
  for (int k = 1; k < NW; ++k) r.w[k] = subc_cc(a[k], b[k]);
  borrow = subc(0u, 0u) & 1u;
  return r;
}

// (a + (mask & b)) mod 2^384: a conditional add of a constant.
__device__ __forceinline__ F add_masked(const F& a, const u32* b, u32 mask) {
  F r;
  r.w[0] = add_cc(a.w[0], b[0] & mask);
#pragma unroll
  for (int k = 1; k < NW - 1; ++k) r.w[k] = addc_cc(a.w[k], b[k] & mask);
  r.w[NW - 1] = addc(a.w[NW - 1], b[NW - 1] & mask);
  return r;
}

__device__ __forceinline__ F radd(const F& a, const F& b) {
  u32 c, br;
  F s = add_raw(a.w, b.w, c);
  F d = sub_raw(s.w, P2, br);
  return select(br != 0, s, d);
}

__device__ __forceinline__ F rsub(const F& a, const F& b) {
  u32 br;
  F d = sub_raw(a.w, b.w, br);
  return add_masked(d, P2, 0u - br);
}

__device__ __forceinline__ F rneg(const F& a) {
  u32 br;
  return sub_raw(P2, a.w, br);
}

__device__ __forceinline__ F rmul12(const F& x) {
  F x2 = radd(x, x);
  F x4 = radd(x2, x2);
  F x8 = radd(x4, x4);
  return radd(x8, x4);
}

// ---------------------------------------------------------------------------
// The Montgomery core
// ---------------------------------------------------------------------------

// X += a_even * bi (pairs at words j, j+1 for even j), carry out into
// Y's top word (weight 2^384).
__device__ __forceinline__ void row_even(u32* X, u32* Y, const u32* a, u32 bi) {
  mad_pair<false, true>(X[0], X[1], a[0], bi);
#pragma unroll
  for (int j = 2; j < NW; j += 2) mad_pair<true, true>(X[j], X[j + 1], a[j], bi);
  Y[NW - 1] = addc(Y[NW - 1], 0u);
}

// Y += a_odd * bi (pairs at words j + 1, j + 2); its top cannot carry.
__device__ __forceinline__ void row_odd(u32* Y, const u32* a, u32 bi) {
  mad_pair<false, true>(Y[0], Y[1], a[1], bi);
#pragma unroll
  for (int j = 2; j < NW - 2; j += 2) mad_pair<true, true>(Y[j], Y[j + 1], a[j + 1], bi);
  mad_pair<true, false>(Y[NW - 2], Y[NW - 1], a[NW - 1], bi);
}

// One word of CIOS: t += a * bi [+ c * di], then m = t[0] * (-p^-1) and
// t += m * p, leaving X[0] = 0.  On entry X, Y hold the state with X[0]
// already shifted out (see mont_core); `first` starts from t = 0.
template <bool ADD>
__device__ __forceinline__ void word_step(u32* X, u32* Y, const F& a, u32 bi,
                                          const F& c, u32 di, bool first) {
  if (first) {
#pragma unroll
    for (int j = 0; j < NW; j += 2) {
      mul_pair(X[j], X[j + 1], a.w[j], bi);
      mul_pair(Y[j], Y[j + 1], a.w[j + 1], bi);
    }
  } else {
    // t / 2^32 = (X / 2^32) + Y: X' = Y + X[1], Y' = X >> 64 (in place),
    // the carry of X'[0] + X[1] riding into Y'[0], plus the row a_odd*bi.
    X[0] = add_cc(X[0], Y[1]);
#pragma unroll
    for (int j = 0; j < NW - 2; j += 2)
      mad_pair_from<true>(Y[j], Y[j + 1], a.w[j + 1], bi, Y[j + 2], Y[j + 3]);
    mad_pair_from<false>(Y[NW - 2], Y[NW - 1], a.w[NW - 1], bi, 0u, 0u);
    row_even(X, Y, a.w, bi);
  }
  if (ADD) {
    row_odd(Y, c.w, di);
    row_even(X, Y, c.w, di);
  }
  u32 m = X[0] * NP0;
  row_odd(Y, P, m);
  row_even(X, Y, P, m);
}

// redc(a * b [+ c * d]) with no final subtraction, for operands whose sum
// of products stays below 4p * 2^384 (any a, b, c, d < 2p).  a and c are
// read whole, b and d one word per step: B and D are F or any type whose
// operator[] gives word k (a value kept outside the registers).
template <bool ADD, class B, class D>
__device__ __forceinline__ F mont_core(const F& a, const B& b, const F& c,
                                       const D& d) {
  u32 even[NW], odd[NW];
#pragma unroll
  for (int i = 0; i < NW; i += 2) {
    word_step<ADD>(even, odd, a, b[i], c, ADD ? d[i] : 0u, i == 0);
    word_step<ADD>(odd, even, a, b[i + 1], c, ADD ? d[i + 1] : 0u, false);
  }
  // t = odd + 2^32 even with odd[0] = 0: the result is t / 2^32.
  F r;
  r.w[0] = add_cc(even[0], odd[1]);
#pragma unroll
  for (int k = 1; k < NW - 1; ++k) r.w[k] = addc_cc(even[k], odd[k + 1]);
  r.w[NW - 1] = addc(even[NW - 1], 0u);
  return r;
}

// b may be a word source other than F (see mont_core).
template <class B>
__device__ __forceinline__ F rmm(const F& a, const B& b) {
  return mont_core<false>(a, b, a, b);
}


// b and d may be word sources other than F (see mont_core).
template <class B, class D>
__device__ __forceinline__ F rmm_add(const F& a, const B& b, const F& c, const D& d) {
  return mont_core<true>(a, b, c, d);
}

__device__ __forceinline__ F rmm_sub(const F& a, const F& b, const F& c, const F& d) {
  return rmm_add(a, b, c, rneg(d));
}

// [0, 2p) -> [0, p): minus p unless that borrows.
__device__ __forceinline__ F canon(const F& a) {
  u32 br;
  F d = sub_raw(a.w, P, br);
  return select(br != 0, a, d);
}

// a in [0, 2p) is 0 mod p: a = 0 or a = p.
__device__ __forceinline__ bool is_zero_rel(const F& a) {
  u32 z = 0, e = 0;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    z |= a.w[k];
    e |= a.w[k] ^ P[k];
  }
  return z == 0 || e == 0;
}

// Canonical Montgomery product: inputs < p, output in [0, p).
__device__ __forceinline__ F mm(const F& a, const F& b) { return canon(rmm(a, b)); }

// Canonical domain (inputs < p, outputs < p): the Jacobian group law's
// field ops, with the integer semantics of `_F.fadd` / `_F.fsub` for
// any 384-bit input:
//   fadd     s = a + b mod 2^384, minus p when s >= p or the sum carried out
//   fdbl     fadd(a, a)
//   fsub     d = a - b mod 2^384, plus p (mod 2^384) on a borrow
//   is_zero  every word 0
__device__ __forceinline__ F fadd(const F& a, const F& b) {
  u32 c, br;
  F s = add_raw(a.w, b.w, c);
  F d = sub_raw(s.w, P, br);
  return select(br == 0 || c != 0, d, s);
}

__device__ __forceinline__ F fdbl(const F& a) { return fadd(a, a); }

__device__ __forceinline__ F fsub(const F& a, const F& b) {
  u32 br;
  F d = sub_raw(a.w, b.w, br);
  return add_masked(d, P, 0u - br);
}

__device__ __forceinline__ bool is_zero(const F& a) {
  u32 acc = 0;
#pragma unroll
  for (int k = 0; k < NW; ++k) acc |= a.w[k];
  return acc == 0;
}

}  // namespace fq
