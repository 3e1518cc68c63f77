// BLS12-381 base-field (Fq) arithmetic for one CUDA thread.
//
// An element is 12 little-endian 32-bit words held in registers.  The
// port's tensors keep 24 16-bit limbs in int32 (the reference's layout);
// load()/store() repack limb pairs (2k, 2k+1) into word k and back.
//
// The Montgomery radix is 2^384 as in the reference (24 x 16 bits =
// 12 x 32 bits), and REDC returns the unique (T + m*p) / 2^384 with
// m in [0, 2^384), whatever the limb width, so every function below is
// bit-identical to its counterpart in gemini_tpu/curve/pallas_g1.py
// (`_F`), relaxed values included:
//   rmm      redc(a*b), no final subtraction       (_F.rmm)
//   rmm_add  redc(a*b + c*d), one shared reduction (_F.rmm_add)
//   rmm_sub  redc(a*b + c*(2p - d))                (_F.rmm_sub, rneg(0) = 2p)
//   radd     a + b, minus 2p when the sum is >= 2p (_F.radd)
//   rsub     a - b, plus 2p on a borrow            (_F.rsub)
//   mm       redc(a*b) reduced into [0, p)         (_F.mm)
//   fadd, fdbl, fsub, is_zero: the canonical ops (_F.fadd/fdbl/fsub)
// All sums are taken mod 2^384, dropping carries off the top exactly
// where the reference drops them.
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
};

// (24, n) int32 16-bit limbs, lane j -> 12 words.  Neighbouring threads
// read neighbouring lanes, so every limb row is one coalesced load.
__device__ __forceinline__ F load(const int32_t* __restrict__ src, long long n,
                                  long long j) {
  F r;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    u32 lo = (u32)src[(2 * k) * n + j];
    u32 hi = (u32)src[(2 * k + 1) * n + j];
    r.w[k] = (lo & 0xFFFFu) | (hi << 16);
  }
  return r;
}

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

// (a + b) mod 2^384.
__device__ __forceinline__ F add_raw(const F& a, const u32* b) {
  F r;
  u64 c = 0;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    u64 s = (u64)a.w[k] + b[k] + c;
    r.w[k] = (u32)s;
    c = s >> 32;
  }
  return r;
}

// (a - b) mod 2^384; borrow = 1 when a < b.
__device__ __forceinline__ F sub_raw(const u32* a, const u32* b, u32& borrow) {
  F r;
  u32 br = 0;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    u64 d = (u64)a[k] - b[k] - br;
    r.w[k] = (u32)d;
    br = (u32)(d >> 32) & 1u;
  }
  borrow = br;
  return r;
}

__device__ __forceinline__ F radd(const F& a, const F& b) {
  F s = add_raw(a, b.w);
  u32 br;
  F d = sub_raw(s.w, P2, br);
  return select(br != 0, s, d);
}

__device__ __forceinline__ F rsub(const F& a, const F& b) {
  u32 br;
  F d = sub_raw(a.w, b.w, br);
  F f = add_raw(d, P2);
  return select(br != 0, f, d);
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

// T = a * b (25 words; the top word stays 0).
__device__ __forceinline__ void mul_wide(u32 T[2 * NW + 1], const F& a, const F& b) {
#pragma unroll
  for (int k = 0; k < 2 * NW + 1; ++k) T[k] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    u64 c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      u64 s = (u64)a.w[i] * b.w[j] + T[i + j] + c;
      T[i + j] = (u32)s;
      c = s >> 32;
    }
    T[i + NW] = (u32)c;  // untouched before row i
  }
}

// T += a * b, carries propagated through the top word.
__device__ __forceinline__ void mul_acc(u32 T[2 * NW + 1], const F& a, const F& b) {
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    u64 c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      u64 s = (u64)a.w[i] * b.w[j] + T[i + j] + c;
      T[i + j] = (u32)s;
      c = s >> 32;
    }
#pragma unroll
    for (int k = i + NW; k < 2 * NW + 1; ++k) {
      u64 s = (u64)T[k] + c;
      T[k] = (u32)s;
      c = s >> 32;
    }
  }
}

// (T + m*p) / 2^384 mod 2^384 with m = -T * p^{-1} mod 2^384: word-serial
// REDC (one 32-bit m per word), no final subtraction.
__device__ __forceinline__ F redc(u32 T[2 * NW + 1]) {
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    u32 m = T[i] * NP0;
    u64 c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      u64 s = (u64)m * P[j] + T[i + j] + c;
      T[i + j] = (u32)s;
      c = s >> 32;
    }
#pragma unroll
    for (int k = i + NW; k < 2 * NW + 1; ++k) {
      u64 s = (u64)T[k] + c;
      T[k] = (u32)s;
      c = s >> 32;
    }
  }
  F r;
#pragma unroll
  for (int k = 0; k < NW; ++k) r.w[k] = T[NW + k];
  return r;
}

__device__ __forceinline__ F rmm(const F& a, const F& b) {
  u32 T[2 * NW + 1];
  mul_wide(T, a, b);
  return redc(T);
}

__device__ __forceinline__ F rmm_add(const F& a, const F& b, const F& c, const F& d) {
  u32 T[2 * NW + 1];
  mul_wide(T, a, b);
  mul_acc(T, c, d);
  return redc(T);
}

__device__ __forceinline__ F rmm_sub(const F& a, const F& b, const F& c, const F& d) {
  return rmm_add(a, b, c, rneg(d));
}

// Canonical Montgomery product: inputs < p, output in [0, p).
__device__ __forceinline__ F mm(const F& a, const F& b) {
  F r = rmm(a, b);
  u32 br;
  F d = sub_raw(r.w, P, br);
  return select(br != 0, r, d);
}

// Canonical domain (inputs < p, outputs < p): the Jacobian group law's
// field ops, with the integer semantics of `_F.fadd` / `_F.fsub` for
// any 384-bit input:
//   fadd     s = a + b mod 2^384, minus p when s >= p or the sum carried out
//   fdbl     fadd(a, a)
//   fsub     d = a - b mod 2^384, plus p (mod 2^384) on a borrow
//   is_zero  every word 0
__device__ __forceinline__ F fadd(const F& a, const F& b) {
  F s;
  u64 c = 0;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    u64 t = (u64)a.w[k] + b.w[k] + c;
    s.w[k] = (u32)t;
    c = t >> 32;
  }
  u32 br;
  F d = sub_raw(s.w, P, br);
  return select(br == 0 || c != 0, d, s);
}

__device__ __forceinline__ F fdbl(const F& a) { return fadd(a, a); }

__device__ __forceinline__ F fsub(const F& a, const F& b) {
  u32 br;
  F d = sub_raw(a.w, b.w, br);
  F f = add_raw(d, P);
  return select(br != 0, f, d);
}

__device__ __forceinline__ bool is_zero(const F& a) {
  u32 acc = 0;
#pragma unroll
  for (int k = 0; k < NW; ++k) acc |= a.w[k];
  return acc == 0;
}

}  // namespace fq
