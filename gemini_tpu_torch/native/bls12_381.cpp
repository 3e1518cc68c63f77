// Native host BLS12-381: Fq/Fq2/Fq6/Fq12 tower, G1/G2 group ops,
// Pippenger MSM, optimal ate pairing (Miller loop + final
// exponentiation).
//
// Role: the host-side verifier/runtime hot path (VERDICT r4 item 3).
// The reference gets this layer from ark-ff/ark-ec asm
// (reference Cargo.toml:79, kzg/mod.rs:155-244); here the TPU
// owns the prover arithmetic and this library owns host verification,
// which was pure-Python bigints (refimpl/) and seconds-slow.
//
// Algorithms mirror gemini_tpu/refimpl exactly (same tower, same
// affine-in-E(Fq12) Miller loop, same naive hard part) so results are
// bit-identical to the Python ground truth; tests assert that.
//
// ABI (all buffers canonical little-endian bytes):
//   fq:  48 B          fq2: 96 B (c0 || c1)        fq12: 576 B
//   G1:  97 B  [flag(1: infinity) || x(48) || y(48)]
//   G2: 193 B  [flag || x.c0 || x.c1 || y.c0 || y.c1]
//   scalars: 32 B unsigned LE (canonical, any value < 2^256)

#include <cstdint>
#include <cstring>
#include <vector>

typedef unsigned __int128 u128;
typedef uint64_t u64;

static const u64 QL[6] = {
    0xb9feffffffffaaabULL, 0x1eabfffeb153ffffULL, 0x6730d2a0f6b0f624ULL,
    0x64774b84f38512bfULL, 0x4b1ba7b6434bacd7ULL, 0x1a0111ea397fe69aULL};
static const u64 R2L[6] = {
    0xf4df1f341c341746ULL, 0x0a76e6a609d104f1ULL, 0x8de5476c4c95b6d5ULL,
    0x67eb88a9939d83c0ULL, 0x9a793e85b519952dULL, 0x11988fe592cae3aaULL};
static const u64 INV = 0x89f3fffcfffcfffdULL;
static const u64 BLS_X_ABS = 0xd201000000010000ULL;

// (q^4 - q^2 + 1) / r, little-endian bytes (the naive hard-part
// exponent, refimpl/pairing.py:88).
static const unsigned char HARD_EXP[159] = {
    0x79,0xba,0xe3,0x38,0xf4,0xc3,0x16,0xe5,0xf1,0xcc,0x08,0xe2,0xaa,0x12,
    0x99,0xfa,0x68,0x5b,0x5d,0x33,0x37,0xe9,0x5c,0x90,0x36,0xa2,0xde,0xb0,
    0x29,0x26,0x1a,0xc7,0xc8,0x54,0x67,0x99,0x40,0x49,0x77,0x83,0x99,0xe7,
    0xa1,0xb6,0xae,0x60,0xd1,0x21,0xb4,0x7d,0x23,0xed,0x83,0xb2,0xd0,0x2e,
    0x21,0x18,0x6f,0x6c,0xf3,0x97,0x5c,0x91,0x65,0x37,0x78,0xde,0xcb,0x7f,
    0xf1,0x67,0xb7,0xd1,0x96,0x90,0x03,0xb9,0x78,0x23,0xdc,0x51,0xdc,0x1b,
    0x76,0xf8,0x88,0x79,0xa1,0x77,0xfc,0x03,0x50,0x99,0x76,0x20,0x5b,0x31,
    0x21,0xa6,0x0b,0xca,0x7e,0x82,0x9f,0xcb,0x63,0x8d,0xce,0x2b,0xa7,0xe5,
    0x8a,0x6f,0x8b,0xc2,0x64,0x77,0x8f,0xf6,0x17,0x15,0x08,0xcf,0x63,0x00,
    0x23,0x2f,0x9a,0x6a,0x8d,0x52,0x32,0x66,0x50,0x94,0xa3,0x6c,0x99,0xeb,
    0x8e,0xe8,0xcd,0xd3,0x9e,0x89,0x5c,0x19,0xc3,0x38,0xbd,0xc0,0x01,0x7d,
    0x80,0x3d,0x6b,0x68,0x0f};

struct fp { u64 l[6]; };

static void fp_zero(fp* r) { std::memset(r->l, 0, sizeof(r->l)); }

static bool fp_is_zero(const fp* a) {
  u64 acc = 0;
  for (int i = 0; i < 6; i++) acc |= a->l[i];
  return acc == 0;
}

static bool fp_eq(const fp* a, const fp* b) {
  for (int i = 0; i < 6; i++)
    if (a->l[i] != b->l[i]) return false;
  return true;
}

static bool fp_geq_q(const u64* t) {
  for (int i = 5; i >= 0; i--) {
    if (t[i] > QL[i]) return true;
    if (t[i] < QL[i]) return false;
  }
  return true;  // equal
}

static void fp_sub_q(u64* t) {
  u128 borrow = 0;
  for (int i = 0; i < 6; i++) {
    u128 d = (u128)t[i] - QL[i] - (u64)borrow;
    t[i] = (u64)d;
    borrow = (d >> 64) ? 1 : 0;
  }
}

static void fp_add(fp* r, const fp* a, const fp* b) {
  u128 c = 0;
  for (int i = 0; i < 6; i++) {
    c += (u128)a->l[i] + b->l[i];
    r->l[i] = (u64)c;
    c >>= 64;
  }
  if (c || fp_geq_q(r->l)) fp_sub_q(r->l);
}

static void fp_sub(fp* r, const fp* a, const fp* b) {
  u128 borrow = 0;
  u64 t[6];
  for (int i = 0; i < 6; i++) {
    u128 d = (u128)a->l[i] - b->l[i] - (u64)borrow;
    t[i] = (u64)d;
    borrow = (d >> 64) ? 1 : 0;
  }
  if (borrow) {
    u128 c = 0;
    for (int i = 0; i < 6; i++) {
      c += (u128)t[i] + QL[i];
      t[i] = (u64)c;
      c >>= 64;
    }
  }
  std::memcpy(r->l, t, sizeof(t));
}

static void fp_neg(fp* r, const fp* a) {
  if (fp_is_zero(a)) { *r = *a; return; }
  u128 borrow = 0;
  for (int i = 0; i < 6; i++) {
    u128 d = (u128)QL[i] - a->l[i] - (u64)borrow;
    r->l[i] = (u64)d;
    borrow = (d >> 64) ? 1 : 0;
  }
}

// SOS Montgomery multiply: 12-word schoolbook product then reduction.
static void fp_mul(fp* r, const fp* a, const fp* b) {
  u64 t[12];
  std::memset(t, 0, sizeof(t));
  for (int i = 0; i < 6; i++) {
    u128 c = 0;
    for (int j = 0; j < 6; j++) {
      c += (u128)a->l[i] * b->l[j] + t[i + j];
      t[i + j] = (u64)c;
      c >>= 64;
    }
    t[i + 6] = (u64)c;  // slot was untouched for this i
  }
  for (int i = 0; i < 6; i++) {
    u64 m = t[i] * INV;
    u128 c = 0;
    for (int j = 0; j < 6; j++) {
      c += (u128)m * QL[j] + t[i + j];
      t[i + j] = (u64)c;
      c >>= 64;
    }
    for (int k = i + 6; c; k++) {  // k < 12 always (result < 2q)
      c += t[k];
      t[k] = (u64)c;
      c >>= 64;
    }
  }
  std::memcpy(r->l, t + 6, 6 * sizeof(u64));
  if (fp_geq_q(r->l)) fp_sub_q(r->l);
}

static void fp_sqr(fp* r, const fp* a) { fp_mul(r, a, a); }

static void fp_one(fp* r) {  // Montgomery 1 = 2^384 mod q
  fp rr;
  std::memcpy(rr.l, R2L, sizeof(rr.l));
  fp one_raw;
  fp_zero(&one_raw);
  one_raw.l[0] = 1;
  fp_mul(r, &one_raw, &rr);
}

static void fp_from_bytes(fp* r, const unsigned char* b) {
  fp raw;
  for (int i = 0; i < 6; i++) {
    u64 v = 0;
    for (int j = 7; j >= 0; j--) v = (v << 8) | b[i * 8 + j];
    raw.l[i] = v;
  }
  fp r2;
  std::memcpy(r2.l, R2L, sizeof(r2.l));
  fp_mul(r, &raw, &r2);
}

static void fp_to_bytes(unsigned char* b, const fp* a) {
  fp one_raw, canon;
  fp_zero(&one_raw);
  one_raw.l[0] = 1;
  fp_mul(&canon, a, &one_raw);  // Montgomery reduce
  for (int i = 0; i < 6; i++)
    for (int j = 0; j < 8; j++) b[i * 8 + j] = (unsigned char)(canon.l[i] >> (8 * j));
}

// pow by little-endian byte exponent (top byte nonzero not required)
static void fp_pow_bytes(fp* r, const fp* a, const unsigned char* e, int n) {
  fp acc, base = *a;
  fp_one(&acc);
  for (int i = 0; i < n; i++) {
    unsigned char byte = e[i];
    for (int bit = 0; bit < 8; bit++) {
      if (byte & 1) fp_mul(&acc, &acc, &base);
      byte >>= 1;
      if (i == n - 1 && byte == 0 && bit == 7) break;
      fp_sqr(&base, &base);
    }
  }
  *r = acc;
}

static void fp_inv(fp* r, const fp* a) {  // a^(q-2)
  unsigned char e[48];
  u64 qm2[6];
  std::memcpy(qm2, QL, sizeof(qm2));
  qm2[0] -= 2;  // q is odd, q-2 no borrow past limb 0? q[0]=...aaab >= 2, ok
  for (int i = 0; i < 6; i++)
    for (int j = 0; j < 8; j++) e[i * 8 + j] = (unsigned char)(qm2[i] >> (8 * j));
  fp_pow_bytes(r, a, e, 48);
}

// ---------------------------------------------------------------------------
// Fq2 = Fq[u]/(u^2+1); Fq6 = Fq2[v]/(v^3 - (1+u)); Fq12 = Fq6[w]/(w^2 - v)
// (refimpl/fields.py:89-330)
// ---------------------------------------------------------------------------

struct fp2 { fp c0, c1; };

static void fp2_zero(fp2* r) { fp_zero(&r->c0); fp_zero(&r->c1); }
static void fp2_one(fp2* r) { fp_one(&r->c0); fp_zero(&r->c1); }
static bool fp2_is_zero(const fp2* a) { return fp_is_zero(&a->c0) && fp_is_zero(&a->c1); }
static bool fp2_eq(const fp2* a, const fp2* b) { return fp_eq(&a->c0, &b->c0) && fp_eq(&a->c1, &b->c1); }

static void fp2_add(fp2* r, const fp2* a, const fp2* b) {
  fp_add(&r->c0, &a->c0, &b->c0);
  fp_add(&r->c1, &a->c1, &b->c1);
}
static void fp2_sub(fp2* r, const fp2* a, const fp2* b) {
  fp_sub(&r->c0, &a->c0, &b->c0);
  fp_sub(&r->c1, &a->c1, &b->c1);
}
static void fp2_neg(fp2* r, const fp2* a) {
  fp_neg(&r->c0, &a->c0);
  fp_neg(&r->c1, &a->c1);
}
static void fp2_conj(fp2* r, const fp2* a) {
  r->c0 = a->c0;
  fp_neg(&r->c1, &a->c1);
}

static void fp2_mul(fp2* r, const fp2* x, const fp2* y) {
  fp ac, bd, s1, s2, t;
  fp_mul(&ac, &x->c0, &y->c0);
  fp_mul(&bd, &x->c1, &y->c1);
  fp_add(&s1, &x->c0, &x->c1);
  fp_add(&s2, &y->c0, &y->c1);
  fp_mul(&t, &s1, &s2);
  fp2 out;
  fp_sub(&out.c0, &ac, &bd);
  fp_sub(&t, &t, &ac);
  fp_sub(&out.c1, &t, &bd);
  *r = out;
}

static void fp2_sqr(fp2* r, const fp2* a) { fp2_mul(r, a, a); }

static void fp2_inv(fp2* r, const fp2* x) {
  fp a2, b2, t;
  fp_sqr(&a2, &x->c0);
  fp_sqr(&b2, &x->c1);
  fp_add(&t, &a2, &b2);
  fp_inv(&t, &t);
  fp2 out;
  fp_mul(&out.c0, &x->c0, &t);
  fp_mul(&out.c1, &x->c1, &t);
  fp_neg(&out.c1, &out.c1);
  *r = out;
}

// multiply by xi = 1 + u: (a + bu)(1 + u) = (a - b) + (a + b) u
static void fp2_mul_xi(fp2* r, const fp2* x) {
  fp2 out;
  fp_sub(&out.c0, &x->c0, &x->c1);
  fp_add(&out.c1, &x->c0, &x->c1);
  *r = out;
}

static void fp2_pow_bytes(fp2* r, const fp2* a, const unsigned char* e, int n) {
  fp2 acc, base = *a;
  fp2_one(&acc);
  for (int i = 0; i < n; i++) {
    unsigned char byte = e[i];
    for (int bit = 0; bit < 8; bit++) {
      if (byte & 1) fp2_mul(&acc, &acc, &base);
      byte >>= 1;
      fp2_sqr(&base, &base);
    }
  }
  *r = acc;
}

struct fp6 { fp2 c0, c1, c2; };

static void fp6_zero(fp6* r) { fp2_zero(&r->c0); fp2_zero(&r->c1); fp2_zero(&r->c2); }
static void fp6_one(fp6* r) { fp2_one(&r->c0); fp2_zero(&r->c1); fp2_zero(&r->c2); }

static void fp6_add(fp6* r, const fp6* a, const fp6* b) {
  fp2_add(&r->c0, &a->c0, &b->c0);
  fp2_add(&r->c1, &a->c1, &b->c1);
  fp2_add(&r->c2, &a->c2, &b->c2);
}
static void fp6_sub(fp6* r, const fp6* a, const fp6* b) {
  fp2_sub(&r->c0, &a->c0, &b->c0);
  fp2_sub(&r->c1, &a->c1, &b->c1);
  fp2_sub(&r->c2, &a->c2, &b->c2);
}
static void fp6_neg(fp6* r, const fp6* a) {
  fp2_neg(&r->c0, &a->c0);
  fp2_neg(&r->c1, &a->c1);
  fp2_neg(&r->c2, &a->c2);
}

static void fp6_mul(fp6* r, const fp6* x, const fp6* y) {
  fp2 t0, t1, t2, s, u, v;
  fp2_mul(&t0, &x->c0, &y->c0);
  fp2_mul(&t1, &x->c1, &y->c1);
  fp2_mul(&t2, &x->c2, &y->c2);
  fp6 out;
  // c0 = t0 + xi*((a1+a2)(b1+b2) - t1 - t2)
  fp2_add(&s, &x->c1, &x->c2);
  fp2_add(&u, &y->c1, &y->c2);
  fp2_mul(&v, &s, &u);
  fp2_sub(&v, &v, &t1);
  fp2_sub(&v, &v, &t2);
  fp2_mul_xi(&v, &v);
  fp2_add(&out.c0, &t0, &v);
  // c1 = (a0+a1)(b0+b1) - t0 - t1 + xi*t2
  fp2_add(&s, &x->c0, &x->c1);
  fp2_add(&u, &y->c0, &y->c1);
  fp2_mul(&v, &s, &u);
  fp2_sub(&v, &v, &t0);
  fp2_sub(&v, &v, &t1);
  fp2 xt2;
  fp2_mul_xi(&xt2, &t2);
  fp2_add(&out.c1, &v, &xt2);
  // c2 = (a0+a2)(b0+b2) - t0 - t2 + t1
  fp2_add(&s, &x->c0, &x->c2);
  fp2_add(&u, &y->c0, &y->c2);
  fp2_mul(&v, &s, &u);
  fp2_sub(&v, &v, &t0);
  fp2_sub(&v, &v, &t2);
  fp2_add(&out.c2, &v, &t1);
  *r = out;
}

static void fp6_mul_by_v(fp6* r, const fp6* a) {
  fp6 out;
  fp2_mul_xi(&out.c0, &a->c2);
  out.c1 = a->c0;
  out.c2 = a->c1;
  *r = out;
}

static void fp6_inv(fp6* r, const fp6* x) {
  // refimpl/fields.py:212-218
  fp2 t0, t1, t2, s, d;
  fp2_sqr(&t0, &x->c0);
  fp2_mul(&s, &x->c1, &x->c2);
  fp2_mul_xi(&s, &s);
  fp2_sub(&t0, &t0, &s);
  fp2_sqr(&t1, &x->c2);
  fp2_mul_xi(&t1, &t1);
  fp2_mul(&s, &x->c0, &x->c1);
  fp2_sub(&t1, &t1, &s);
  fp2_sqr(&t2, &x->c1);
  fp2_mul(&s, &x->c0, &x->c2);
  fp2_sub(&t2, &t2, &s);
  // d = a0*t0 + xi*(a2*t1 + a1*t2)
  fp2 u, v;
  fp2_mul(&u, &x->c2, &t1);
  fp2_mul(&v, &x->c1, &t2);
  fp2_add(&u, &u, &v);
  fp2_mul_xi(&u, &u);
  fp2_mul(&v, &x->c0, &t0);
  fp2_add(&d, &u, &v);
  fp2_inv(&d, &d);
  fp6 out;
  fp2_mul(&out.c0, &t0, &d);
  fp2_mul(&out.c1, &t1, &d);
  fp2_mul(&out.c2, &t2, &d);
  *r = out;
}

struct fp12 { fp6 c0, c1; };

static void fp12_one(fp12* r) { fp6_one(&r->c0); fp6_zero(&r->c1); }
static bool fp12_eq(const fp12* a, const fp12* b) {
  return fp2_eq(&a->c0.c0, &b->c0.c0) && fp2_eq(&a->c0.c1, &b->c0.c1) &&
         fp2_eq(&a->c0.c2, &b->c0.c2) && fp2_eq(&a->c1.c0, &b->c1.c0) &&
         fp2_eq(&a->c1.c1, &b->c1.c1) && fp2_eq(&a->c1.c2, &b->c1.c2);
}

static void fp12_mul(fp12* r, const fp12* x, const fp12* y) {
  fp6 t0, t1, s, u, v;
  fp6_mul(&t0, &x->c0, &y->c0);
  fp6_mul(&t1, &x->c1, &y->c1);
  fp12 out;
  fp6_mul_by_v(&v, &t1);
  fp6_add(&out.c0, &t0, &v);
  fp6_add(&s, &x->c0, &x->c1);
  fp6_add(&u, &y->c0, &y->c1);
  fp6_mul(&v, &s, &u);
  fp6_sub(&v, &v, &t0);
  fp6_sub(&out.c1, &v, &t1);
  *r = out;
}

static void fp12_sqr(fp12* r, const fp12* a) { fp12_mul(r, a, a); }

static void fp12_conj(fp12* r, const fp12* a) {
  r->c0 = a->c0;
  fp6_neg(&r->c1, &a->c1);
}

static void fp12_sub(fp12* r, const fp12* a, const fp12* b) {
  fp6_sub(&r->c0, &a->c0, &b->c0);
  fp6_sub(&r->c1, &a->c1, &b->c1);
}

static void fp12_inv(fp12* r, const fp12* x) {
  fp6 a2, b2, d;
  fp6_mul(&a2, &x->c0, &x->c0);
  fp6_mul(&b2, &x->c1, &x->c1);
  fp6_mul_by_v(&b2, &b2);
  fp6_sub(&d, &a2, &b2);
  fp6_inv(&d, &d);
  fp12 out;
  fp6_mul(&out.c0, &x->c0, &d);
  fp6_mul(&out.c1, &x->c1, &d);
  fp6_neg(&out.c1, &out.c1);
  *r = out;
}

static void fp12_pow_bytes(fp12* r, const fp12* a, const unsigned char* e, int n) {
  fp12 acc, base = *a;
  fp12_one(&acc);
  for (int i = 0; i < n; i++) {
    unsigned char byte = e[i];
    for (int bit = 0; bit < 8; bit++) {
      if (byte & 1) fp12_mul(&acc, &acc, &base);
      byte >>= 1;
      fp12_sqr(&base, &base);
    }
  }
  *r = acc;
}

// Frobenius: coefficient basis of powers of w (refimpl _frob1).
static fp2 FROB_G[6];
static bool frob_init_done = false;

static void frob_init() {
  if (frob_init_done) return;
  // g = xi^((q-1)/6); FROB_G[i] = g^i.  (q-1)/6 by limb-wise division.
  u64 qm1[6];
  std::memcpy(qm1, QL, sizeof(qm1));
  qm1[0] -= 1;
  u64 div[6];
  u128 rem = 0;
  for (int i = 5; i >= 0; i--) {
    u128 cur = (rem << 64) | qm1[i];
    div[i] = (u64)(cur / 6);
    rem = cur % 6;
  }
  unsigned char e[48];
  for (int i = 0; i < 6; i++)
    for (int j = 0; j < 8; j++) e[i * 8 + j] = (unsigned char)(div[i] >> (8 * j));
  fp2 xi, g;
  fp_one(&xi.c0);
  fp_one(&xi.c1);
  fp2_pow_bytes(&g, &xi, e, 48);
  fp2_one(&FROB_G[0]);
  for (int i = 1; i < 6; i++) fp2_mul(&FROB_G[i], &FROB_G[i - 1], &g);
  frob_init_done = true;
}

static void fp12_frob1(fp12* r, const fp12* a) {
  frob_init();
  const fp2* coeffs[6] = {&a->c0.c0, &a->c1.c0, &a->c0.c1,
                          &a->c1.c1, &a->c0.c2, &a->c1.c2};
  fp2 nw[6];
  for (int i = 0; i < 6; i++) {
    fp2 c;
    fp2_conj(&c, coeffs[i]);
    fp2_mul(&nw[i], &c, &FROB_G[i]);
  }
  r->c0.c0 = nw[0]; r->c0.c1 = nw[2]; r->c0.c2 = nw[4];
  r->c1.c0 = nw[1]; r->c1.c1 = nw[3]; r->c1.c2 = nw[5];
}

// ---------------------------------------------------------------------------
// G1 (Jacobian over fp) and G2 (Jacobian over fp2); a = 0, b = 4 / 4(1+u)
// ---------------------------------------------------------------------------

template <typename F>
struct jac { F x, y, z; };

template <typename F, void FZERO(F*), void FONE(F*), bool FIS0(const F*),
          void FADD(F*, const F*, const F*), void FSUB(F*, const F*, const F*),
          void FNEG(F*, const F*), void FMUL(F*, const F*, const F*),
          bool FEQ(const F*, const F*)>
struct curveops {
  static bool is_inf(const jac<F>* p) { return FIS0(&p->z); }
  static void set_inf(jac<F>* p) { FZERO(&p->x); FONE(&p->y); FZERO(&p->z); }

  static void dbl(jac<F>* r, const jac<F>* p) {
    if (is_inf(p) || FIS0(&p->y)) { set_inf(r); return; }
    F a, b, c, d, e, f, t, t2;
    FMUL(&a, &p->x, &p->x);
    FMUL(&b, &p->y, &p->y);
    FMUL(&c, &b, &b);
    FADD(&t, &p->x, &b);
    FMUL(&t, &t, &t);
    FSUB(&t, &t, &a);
    FSUB(&t, &t, &c);
    FADD(&d, &t, &t);          // D = 2((X+B)^2 - A - C)
    FADD(&e, &a, &a);
    FADD(&e, &e, &a);          // E = 3A
    FMUL(&f, &e, &e);
    jac<F> out;
    FSUB(&out.x, &f, &d);
    FSUB(&out.x, &out.x, &d);  // X3 = F - 2D
    FSUB(&t, &d, &out.x);
    FMUL(&t, &e, &t);
    FADD(&t2, &c, &c); FADD(&t2, &t2, &t2); FADD(&t2, &t2, &t2);  // 8C
    FSUB(&out.y, &t, &t2);
    FMUL(&t, &p->y, &p->z);
    FADD(&out.z, &t, &t);      // Z3 = 2YZ
    *r = out;
  }

  static void add(jac<F>* r, const jac<F>* p, const jac<F>* q) {
    if (is_inf(p)) { *r = *q; return; }
    if (is_inf(q)) { *r = *p; return; }
    F z1z1, z2z2, u1, u2, s1, s2, t;
    FMUL(&z1z1, &p->z, &p->z);
    FMUL(&z2z2, &q->z, &q->z);
    FMUL(&u1, &p->x, &z2z2);
    FMUL(&u2, &q->x, &z1z1);
    FMUL(&t, &q->z, &z2z2);
    FMUL(&s1, &p->y, &t);
    FMUL(&t, &p->z, &z1z1);
    FMUL(&s2, &q->y, &t);
    if (FEQ(&u1, &u2)) {
      if (FEQ(&s1, &s2)) { dbl(r, p); return; }
      set_inf(r);
      return;
    }
    F h, i, j, rr, v;
    FSUB(&h, &u2, &u1);
    FADD(&i, &h, &h);
    FMUL(&i, &i, &i);          // I = (2H)^2
    FMUL(&j, &h, &i);          // J = H*I
    FSUB(&rr, &s2, &s1);
    FADD(&rr, &rr, &rr);       // r = 2(S2-S1)
    FMUL(&v, &u1, &i);         // V = U1*I
    jac<F> out;
    F t2;
    FMUL(&out.x, &rr, &rr);
    FSUB(&out.x, &out.x, &j);
    FSUB(&out.x, &out.x, &v);
    FSUB(&out.x, &out.x, &v);  // X3 = r^2 - J - 2V
    FSUB(&t, &v, &out.x);
    FMUL(&t, &rr, &t);
    FMUL(&t2, &s1, &j);
    FADD(&t2, &t2, &t2);
    FSUB(&out.y, &t, &t2);     // Y3 = r(V-X3) - 2 S1 J
    FADD(&t, &p->z, &q->z);
    FMUL(&t, &t, &t);
    FSUB(&t, &t, &z1z1);
    FSUB(&t, &t, &z2z2);
    FMUL(&out.z, &t, &h);      // Z3 = ((Z1+Z2)^2 - Z1Z1 - Z2Z2) H
    *r = out;
  }

  static void mul_bytes(jac<F>* r, const jac<F>* p, const unsigned char* k, int n) {
    jac<F> acc;
    set_inf(&acc);
    for (int i = n - 1; i >= 0; i--) {
      for (int bit = 7; bit >= 0; bit--) {
        dbl(&acc, &acc);
        if ((k[i] >> bit) & 1) add(&acc, &acc, p);
      }
    }
    *r = acc;
  }
};

typedef curveops<fp, fp_zero, fp_one, fp_is_zero, fp_add, fp_sub, fp_neg,
                 fp_mul, fp_eq> g1ops;
typedef curveops<fp2, fp2_zero, fp2_one, fp2_is_zero, fp2_add, fp2_sub,
                 fp2_neg, fp2_mul, fp2_eq> g2ops;

// affine <-> jacobian, byte codecs ------------------------------------------

static void g1_from_bytes(jac<fp>* p, const unsigned char* b) {
  if (b[0]) { g1ops::set_inf(p); return; }
  fp_from_bytes(&p->x, b + 1);
  fp_from_bytes(&p->y, b + 49);
  fp_one(&p->z);
}

static void g1_to_bytes(unsigned char* b, const jac<fp>* p) {
  std::memset(b, 0, 97);
  if (g1ops::is_inf(p)) { b[0] = 1; return; }
  fp zi, zi2, zi3, ax, ay;
  fp_inv(&zi, &p->z);
  fp_sqr(&zi2, &zi);
  fp_mul(&zi3, &zi2, &zi);
  fp_mul(&ax, &p->x, &zi2);
  fp_mul(&ay, &p->y, &zi3);
  fp_to_bytes(b + 1, &ax);
  fp_to_bytes(b + 49, &ay);
}

static void fp2_from_bytes(fp2* r, const unsigned char* b) {
  fp_from_bytes(&r->c0, b);
  fp_from_bytes(&r->c1, b + 48);
}

static void fp2_to_bytes(unsigned char* b, const fp2* a) {
  fp_to_bytes(b, &a->c0);
  fp_to_bytes(b + 48, &a->c1);
}

static void g2_from_bytes(jac<fp2>* p, const unsigned char* b) {
  if (b[0]) { g2ops::set_inf(p); return; }
  fp2_from_bytes(&p->x, b + 1);
  fp2_from_bytes(&p->y, b + 97);
  fp2_one(&p->z);
}

static void g2_to_bytes(unsigned char* b, const jac<fp2>* p) {
  std::memset(b, 0, 193);
  if (g2ops::is_inf(p)) { b[0] = 1; return; }
  fp2 zi, zi2, zi3, ax, ay;
  fp2_inv(&zi, &p->z);
  fp2_sqr(&zi2, &zi);
  fp2_mul(&zi3, &zi2, &zi);
  fp2_mul(&ax, &p->x, &zi2);
  fp2_mul(&ay, &p->y, &zi3);
  fp2_to_bytes(b + 1, &ax);
  fp2_to_bytes(b + 97, &ay);
}

static void fp12_to_bytes(unsigned char* b, const fp12* a) {
  const fp2* cs[6] = {&a->c0.c0, &a->c0.c1, &a->c0.c2,
                      &a->c1.c0, &a->c1.c1, &a->c1.c2};
  for (int i = 0; i < 6; i++) fp2_to_bytes(b + 96 * i, cs[i]);
}

// ---------------------------------------------------------------------------
// Pairing: affine Miller loop in E(Fq12) with the sextic untwist,
// exactly refimpl/pairing.py:22-96.
// ---------------------------------------------------------------------------

struct pt12 { fp12 x, y; bool inf; };

static void fp12_from_fp2_slot(fp12* r, const fp2* a, int c6, int c2) {
  // place `a` at (c6 ? c1 : c0).(c2 slot), zero elsewhere
  fp6_zero(&r->c0);
  fp6_zero(&r->c1);
  fp6* tgt = c6 ? &r->c1 : &r->c0;
  if (c2 == 0) tgt->c0 = *a;
  else if (c2 == 1) tgt->c1 = *a;
  else tgt->c2 = *a;
}

static void untwist(pt12* r, const unsigned char* g2b) {
  fp2 x, y;
  fp2_from_bytes(&x, g2b + 1);
  fp2_from_bytes(&y, g2b + 97);
  fp2 onef2;
  fp2_one(&onef2);
  fp12 w2, w3, xe, ye, w2i, w3i;
  fp12_from_fp2_slot(&w2, &onef2, 0, 1);  // v
  fp12_from_fp2_slot(&w3, &onef2, 1, 1);  // v*w
  fp12_from_fp2_slot(&xe, &x, 0, 0);
  fp12_from_fp2_slot(&ye, &y, 0, 0);
  fp12_inv(&w2i, &w2);
  fp12_inv(&w3i, &w3);
  fp12_mul(&r->x, &xe, &w2i);
  fp12_mul(&r->y, &ye, &w3i);
  r->inf = false;
}

static void fp12_scalar_small(fp12* r, u64 n) {
  fp12_one(r);
  fp t;
  fp_zero(&t);
  fp raww;
  fp_zero(&raww);
  raww.l[0] = n;
  fp r2;
  std::memcpy(r2.l, R2L, sizeof(r2.l));
  fp_mul(&t, &raww, &r2);
  r->c0.c0.c0 = t;
  fp_zero(&r->c0.c0.c1);
}

// line through t, u evaluated at (px, py); refimpl _line
static void line_eval(fp12* out, const pt12* t, const pt12* u,
                      const fp12* px, const fp12* py) {
  fp12 lam;
  if (fp12_eq(&t->x, &u->x) && fp12_eq(&t->y, &u->y)) {
    fp12 n, d, three, two;
    fp12_sqr(&n, &t->x);
    fp12_scalar_small(&three, 3);
    fp12_mul(&n, &n, &three);
    fp12_scalar_small(&two, 2);
    fp12_mul(&d, &t->y, &two);
    fp12_inv(&d, &d);
    fp12_mul(&lam, &n, &d);
  } else if (fp12_eq(&t->x, &u->x)) {
    fp12_sub(out, px, &t->x);
    return;
  } else {
    fp12 n, d;
    fp12_sub(&n, &u->y, &t->y);
    fp12_sub(&d, &u->x, &t->x);
    fp12_inv(&d, &d);
    fp12_mul(&lam, &n, &d);
  }
  fp12 t1, t2;
  fp12_sub(&t1, px, &t->x);
  fp12_mul(&t1, &lam, &t1);
  fp12_sub(&t2, py, &t->y);
  fp12_sub(out, &t2, &t1);
}

static void ec12_add(pt12* r, const pt12* t, const pt12* u) {
  if (t->inf) { *r = *u; return; }
  if (u->inf) { *r = *t; return; }
  fp12 lam;
  if (fp12_eq(&t->x, &u->x)) {
    fp12 s;
    fp12 negy;
    fp12 zero12;
    fp6_zero(&zero12.c0); fp6_zero(&zero12.c1);
    fp12_sub(&negy, &zero12, &u->y);
    if (fp12_eq(&t->y, &negy)) { r->inf = true; return; }
    fp12 n, d, three, two;
    fp12_sqr(&n, &t->x);
    fp12_scalar_small(&three, 3);
    fp12_mul(&n, &n, &three);
    fp12_scalar_small(&two, 2);
    fp12_mul(&d, &t->y, &two);
    fp12_inv(&d, &d);
    fp12_mul(&lam, &n, &d);
    (void)s;
  } else {
    fp12 n, d;
    fp12_sub(&n, &u->y, &t->y);
    fp12_sub(&d, &u->x, &t->x);
    fp12_inv(&d, &d);
    fp12_mul(&lam, &n, &d);
  }
  pt12 out;
  fp12 l2, t1;
  fp12_sqr(&l2, &lam);
  fp12_sub(&l2, &l2, &t->x);
  fp12_sub(&out.x, &l2, &u->x);
  fp12_sub(&t1, &t->x, &out.x);
  fp12_mul(&t1, &lam, &t1);
  fp12_sub(&out.y, &t1, &t->y);
  out.inf = false;
  *r = out;
}

static void miller_loop(fp12* f, const unsigned char* g1b,
                        const unsigned char* g2b) {
  if (g1b[0] || g2b[0]) { fp12_one(f); return; }
  fp gx, gy;
  fp_from_bytes(&gx, g1b + 1);
  fp_from_bytes(&gy, g1b + 49);
  fp12 px, py;
  fp6_zero(&px.c0); fp6_zero(&px.c1);
  fp6_zero(&py.c0); fp6_zero(&py.c1);
  px.c0.c0.c0 = gx;
  py.c0.c0.c0 = gy;
  pt12 qe, t;
  untwist(&qe, g2b);
  t = qe;
  fp12 acc;
  fp12_one(&acc);
  // bits of BLS_X_ABS below the MSB, high to low
  int msb = 63;
  while (!((BLS_X_ABS >> msb) & 1)) msb--;
  for (int i = msb - 1; i >= 0; i--) {
    fp12 l;
    fp12_sqr(&acc, &acc);
    line_eval(&l, &t, &t, &px, &py);
    fp12_mul(&acc, &acc, &l);
    ec12_add(&t, &t, &t);
    if ((BLS_X_ABS >> i) & 1) {
      line_eval(&l, &t, &qe, &px, &py);
      fp12_mul(&acc, &acc, &l);
      ec12_add(&t, &t, &qe);
    }
  }
  fp12_conj(f, &acc);  // BLS_X < 0
}

static void final_exp(fp12* r, const fp12* f) {
  // easy part: f^((q^6-1)(q^2+1)) = conj(f)/f, then frob^2 * self
  fp12 c, inv, e, e2;
  fp12_conj(&c, f);
  fp12_inv(&inv, f);
  fp12_mul(&e, &c, &inv);
  fp12_frob1(&e2, &e);
  fp12_frob1(&e2, &e2);
  fp12_mul(&e, &e2, &e);
  fp12_pow_bytes(r, &e, HARD_EXP, (int)sizeof(HARD_EXP));
}

// ---------------------------------------------------------------------------
// Exports
// ---------------------------------------------------------------------------

extern "C" {

void bls_g1_add(const unsigned char* a, const unsigned char* b,
                unsigned char* out) {
  jac<fp> p, q, r;
  g1_from_bytes(&p, a);
  g1_from_bytes(&q, b);
  g1ops::add(&r, &p, &q);
  g1_to_bytes(out, &r);
}

void bls_g1_mul(const unsigned char* a, const unsigned char* k,
                unsigned char* out) {
  jac<fp> p, r;
  g1_from_bytes(&p, a);
  g1ops::mul_bytes(&r, &p, k, 32);
  g1_to_bytes(out, &r);
}

void bls_g2_add(const unsigned char* a, const unsigned char* b,
                unsigned char* out) {
  jac<fp2> p, q, r;
  g2_from_bytes(&p, a);
  g2_from_bytes(&q, b);
  g2ops::add(&r, &p, &q);
  g2_to_bytes(out, &r);
}

void bls_g2_mul(const unsigned char* a, const unsigned char* k,
                unsigned char* out) {
  jac<fp2> p, r;
  g2_from_bytes(&p, a);
  g2ops::mul_bytes(&r, &p, k, 32);
  g2_to_bytes(out, &r);
}

// Pippenger MSM: pts = n*97 bytes, scalars = n*32 bytes.
void bls_g1_msm(const unsigned char* pts, const unsigned char* scalars,
                size_t n, unsigned char* out) {
  jac<fp> acc;
  g1ops::set_inf(&acc);
  if (n == 0) { g1_to_bytes(out, &acc); return; }
  int c = 3;
  size_t m = n;
  while (m >>= 1) c++;  // c ~ log2(n) + 3... keep moderate
  c = c / 2 + 2;
  if (c > 16) c = 16;
  if (c < 2) c = 2;
  std::vector<jac<fp>> base(n);
  for (size_t i = 0; i < n; i++) g1_from_bytes(&base[i], pts + 97 * i);
  int windows = (256 + c - 1) / c;
  size_t nbuckets = ((size_t)1 << c) - 1;
  std::vector<jac<fp>> buckets(nbuckets);
  jac<fp> total;
  g1ops::set_inf(&total);
  for (int w = windows - 1; w >= 0; w--) {
    for (int d = 0; d < c; d++) g1ops::dbl(&total, &total);
    for (size_t i = 0; i < nbuckets; i++) g1ops::set_inf(&buckets[i]);
    for (size_t i = 0; i < n; i++) {
      // digit = bits [w*c, w*c+c) of scalar i
      int bit0 = w * c;
      u64 d = 0;
      for (int b = 0; b < c; b++) {
        int bit = bit0 + b;
        if (bit >= 256) break;
        if ((scalars[32 * i + bit / 8] >> (bit % 8)) & 1) d |= (u64)1 << b;
      }
      if (d) g1ops::add(&buckets[d - 1], &buckets[d - 1], &base[i]);
    }
    jac<fp> run, sum;
    g1ops::set_inf(&run);
    g1ops::set_inf(&sum);
    for (size_t k = nbuckets; k > 0; k--) {
      g1ops::add(&run, &run, &buckets[k - 1]);
      g1ops::add(&sum, &sum, &run);
    }
    g1ops::add(&total, &total, &sum);
  }
  g1_to_bytes(out, &total);
}

// Fixed-base MSM: out[i] = scalars[i] * base, windowed (c = 8) with a
// shared 32x255 table — the SRS-setup workload (kzg/time.rs:49-72).
void bls_g1_fixed_base(const unsigned char* base97,
                       const unsigned char* scalars, size_t n,
                       unsigned char* out) {
  jac<fp> g;
  g1_from_bytes(&g, base97);
  const int C = 8, WINDOWS = 32, ENTRIES = 255;
  std::vector<jac<fp>> table((size_t)WINDOWS * ENTRIES);
  // row 0: G, 2G, ..., 255G
  table[0] = g;
  for (int d = 1; d < ENTRIES; d++)
    g1ops::add(&table[d], &table[d - 1], &g);
  // row w = 2^8 * row w-1
  for (int w = 1; w < WINDOWS; w++) {
    for (int d = 0; d < ENTRIES; d++) {
      jac<fp> t = table[(size_t)(w - 1) * ENTRIES + d];
      for (int s = 0; s < C; s++) g1ops::dbl(&t, &t);
      table[(size_t)w * ENTRIES + d] = t;
    }
  }
  for (size_t i = 0; i < n; i++) {
    const unsigned char* k = scalars + 32 * i;
    jac<fp> acc;
    g1ops::set_inf(&acc);
    for (int w = 0; w < WINDOWS; w++) {
      unsigned d = k[w];
      if (d) g1ops::add(&acc, &acc, &table[(size_t)w * ENTRIES + d - 1]);
    }
    g1_to_bytes(out + 97 * i, &acc);
  }
}

void bls_pairing(const unsigned char* g1b, const unsigned char* g2b,
                 unsigned char* out576) {
  fp12 f;
  miller_loop(&f, g1b, g2b);
  fp12 r;
  final_exp(&r, &f);
  fp12_to_bytes(out576, &r);
}

// prod_i e(P_i, Q_i): shared final exponentiation.
void bls_multi_pairing(const unsigned char* g1s, const unsigned char* g2s,
                       size_t n, unsigned char* out576) {
  fp12 acc;
  fp12_one(&acc);
  for (size_t i = 0; i < n; i++) {
    fp12 f;
    miller_loop(&f, g1s + 97 * i, g2s + 193 * i);
    fp12_mul(&acc, &acc, &f);
  }
  fp12 r;
  final_exp(&r, &acc);
  fp12_to_bytes(out576, &r);
}

}  // extern "C"
