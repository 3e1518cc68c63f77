// The G1 group law for one CUDA thread, shared by csrc/g1_kernels.cu
// (padd, add, dbl) and csrc/msm_kernels.cu (the MSM walk-down, which
// adds into an accumulator held in registers with the same code).
//
// The bodies are templates over where their operands come from and
// where their results go:
//   ld(k)      operand k = x1, y1, z1, x2, y2, z2 (k = 0..5), in the
//              order the body asks for them
//   again(k)   the same operand read again (add's doubling and identity
//              lanes: the kernels read it from memory once more, so it
//              is held in no register in between)
//   put(c, v)  result c = x3, y3, z3 (c = 0..2); add writes some lanes
//              twice (the doubling and the identity lanes last)
// so one instruction sequence serves a kernel that loads and stores
// lanes of tensors and a kernel that keeps its points in registers.
// The design notes are in g1_kernels.cu.
#pragma once

#include <cstdint>

#include "fq.cuh"

namespace g1 {

using fq::F;

constexpr int kThreads = 128;  // threads per block, and Parked's stride

// One operand of a kernel as the caller's view lays it out: lane
// (batch row b, column i) of limb row r at p[r * ls + b * bs + i * es]
// (a bool mask: p[b * bs + i * es]).
struct Operand {
  const void* p;
  long long ls, bs, es;
};
struct Operands {
  Operand o[6];
};
// An output the same way: a (24, rows, cols) view, lane j = b * cols + i.
struct Output {
  int32_t* p;
  long long ls, bs, es;
};
struct Outputs {
  Output o[3];
};

// The lane index, read again where it is used: a value the compiler
// cannot carry through the kernel in a register (or spill) between the
// loads and the stores.
__device__ __forceinline__ unsigned lane_index() {
#ifdef __CUDA_ARCH__
  unsigned t, c, d;
  asm volatile("mov.u32 %0, %%tid.x; mov.u32 %1, %%ctaid.x; mov.u32 %2, %%ntid.x;"
               : "=r"(t), "=r"(c), "=r"(d));
  return c * d + t;
#else
  return blockIdx.x * blockDim.x + threadIdx.x;
#endif
}

// Shared memory as a word source for mont_core: a value that enters the
// last products only as a word operand (one word per CIOS step) is
// parked there, so those products hold 36 fewer words in registers.
// Each thread reads back only its own words: no barrier.
struct Parked {
  volatile uint32_t* s;  // word k at s[k * kThreads]
  __device__ __forceinline__ uint32_t operator[](int k) const { return s[k * kThreads]; }
};

__device__ __forceinline__ Parked park(volatile uint32_t* s, const F& a) {
#pragma unroll
  for (int k = 0; k < fq::NW; ++k) s[k * kThreads] = a.w[k];
  return Parked{s};
}

// The k-th [NW][kThreads] plane of a thread's shared column.
__device__ __forceinline__ volatile uint32_t* plane(volatile uint32_t* col, int k) {
  return col + k * fq::NW * kThreads;
}

__device__ __forceinline__ F load_op(const Operand& o, unsigned b, unsigned i) {
  return fq::load((const int32_t*)o.p, o.ls, (long long)b * o.bs + (long long)i * o.es);
}

__device__ __forceinline__ bool load_mask(const Operand& o, unsigned b, unsigned i) {
  return ((const uint8_t*)o.p)[(long long)b * o.bs + (long long)i * o.es] != 0;
}

__device__ __forceinline__ void store_op(const Output& o, unsigned b, unsigned i,
                                         const F& a) {
  int32_t* dst = o.p + (long long)b * o.bs + (long long)i * o.es;
#pragma unroll
  for (int k = 0; k < fq::NW; ++k) {
    dst[(2 * k) * o.ls] = (int32_t)(a.w[k] & 0xFFFFu);
    dst[(2 * k + 1) * o.ls] = (int32_t)(a.w[k] >> 16);
  }
}

// Operands of lane (b, i), that lane's index held from the start.
struct LaneLoad {
  const Operands& in;
  unsigned b, i;
  __device__ __forceinline__ F operator()(int k) const { return load_op(in.o[k], b, i); }
};

// Operands of this thread's lane, its index read again (lane_index).
struct LaneReload {
  const Operands& in;
  unsigned cols;
  __device__ __forceinline__ F operator()(int k) const {
    const unsigned j = lane_index(), b = j / cols;
    return load_op(in.o[k], b, j - b * cols);
  }
};

// Results to this thread's lane of the outputs, its index read again.
struct LaneStore {
  const Outputs& out;
  unsigned cols;
  __device__ __forceinline__ void operator()(int c, const F& v) const {
    const unsigned j = lane_index(), b = j / cols;
    store_op(out.o[c], b, j - b * cols, v);
  }
};

// _padd_core: complete RCB projective add, the same formula, each relaxed
// value computed by the same sequence of field ops as in the reference;
// independent products run in another order (z read last) to shorten
// the inputs' lives.  `col`: this thread's column of a [3][NW][kThreads]
// shared array.
template <class Ld, class Put>
__device__ __forceinline__ void padd_core(const Ld& ld, const Put& put,
                                          volatile uint32_t* col) {
  const F x1 = ld(0), x2 = ld(3);
  const F y1 = ld(1), y2 = ld(4);
  F t0 = fq::rmm(x1, x2);
  F t3 = fq::rmm(fq::radd(x1, y1), fq::radd(x2, y2));
  const F z1 = ld(2), z2 = ld(5);
  F x3 = fq::rmm(fq::radd(x1, z1), fq::radd(x2, z2));
  F t1 = fq::rmm(y1, y2);
  F t4 = fq::rmm(fq::radd(y1, z1), fq::radd(y2, z2));
  F t2 = fq::rmm(z1, z2);
  t3 = fq::rsub(fq::rsub(t3, t0), t1);  // x1y2 + x2y1
  t4 = fq::rsub(fq::rsub(t4, t1), t2);  // y1z2 + y2z1
  F y3 = fq::rsub(fq::rsub(x3, t0), t2);  // x1z2 + x2z1
  t0 = fq::radd(fq::radd(t0, t0), t0);    // 3 x1x2
  t2 = fq::rmul12(t2);                    // b3 z1z2
  F z3 = fq::radd(t1, t2);
  t1 = fq::rsub(t1, t2);
  y3 = fq::rmul12(y3);  // b3 (x1z2 + x2z1)
  // The same three sums of products with each pair's operands in the
  // order that makes t1, t4, t0 word operands only (a*b + c*d is
  // symmetric, so the integers and their reductions are the same).
  const Parked w1 = park(plane(col, 0), t1);
  const Parked w4 = park(plane(col, 1), t4);
  const Parked w0 = park(plane(col, 2), t0);
  put(0, fq::rmm_add(t3, w1, fq::rneg(y3), w4));  // t3 t1 - t4 y3
  put(1, fq::rmm_add(z3, w1, y3, w0));            // t1 z3 + y3 t0
  put(2, fq::rmm_add(z3, w4, t3, w0));            // z3 t4 + t0 t3
}

// padd_core split over three threads of one lane, one warp per role
// (csrc/msm_kernels.cu's walk-down), in three steps with a block barrier
// between them: role r computes two of the six products (7 of the
// 21 x 144 word products with its output's), then some of the
// combinations of the products each computed once, then output
// coordinate r, padd_core's put(r).  Every value is padd_core's, from
// the same fq:: call on the same operands in the same order, so the
// limbs are the same.
//
// The exchange of a group of kSplitLanes lanes is two sets of six planes
// of [kSplitLanes][NW] words: a lane's value is 48 contiguous bytes, read
// and written as three 16-byte accesses (lanes 48 bytes apart: no bank
// conflict), ordered between threads by the block barriers alone.
// With the accumulator (x1 y1 z1) and the operand (x2 y2 z2) in set X,
// the products go to set Y (t0 t1 t2 = x1x2, y1y2, z1z2; then t3 x3 t4
// = (x1+y1)(x2+y2), (x1+z1)(x2+z2), (y1+z1)(y2+z2), raw), the
// combinations back to set X (SplitFinal), and the next accumulator and
// operand to set Y: each step writes only planes whose readers have
// passed the barrier before it.
constexpr int kSplitLanes = 32;
constexpr int kSplitThreads = 3 * kSplitLanes;
constexpr int kSplitSet = 6;  // planes a set
constexpr int kSplitPlane = fq::NW * kSplitLanes;
constexpr int kSplitWords = 2 * kSplitSet * kSplitPlane;
// The combinations: t3 = x1y2 + x2y1, t4 = y1z2 + y2z1, 3 x1x2,
// y3 = b3 (x1z2 + x2z1), z3 = t1 + b3 z1z2, t1 - b3 z1z2.
enum SplitFinal { kT3 = 0, kT4 = 1, kT0x3 = 2, kY3 = 3, kZ3 = 4, kT1 = 5 };

// Words k of a value at s[k]: a word operand for mont_core.
struct Words {
  const uint32_t* s;
  __device__ __forceinline__ uint32_t operator[](int k) const { return s[k]; }
};

// The lane's value in plane v (`ex`: the exchange + NW * lane, 16-byte
// aligned).
struct SplitLane {
  uint32_t* ex;
  __device__ __forceinline__ uint32_t* plane(int v) const { return ex + v * kSplitPlane; }
  __device__ __forceinline__ F get(int v) const {
    const uint4* p = (const uint4*)plane(v);
    F r;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const uint4 a = p[q];
      r.w[4 * q] = a.x;
      r.w[4 * q + 1] = a.y;
      r.w[4 * q + 2] = a.z;
      r.w[4 * q + 3] = a.w;
    }
    return r;
  }
  __device__ __forceinline__ void put(int v, const F& a) const {
    uint4* p = (uint4*)plane(v);
#pragma unroll
    for (int q = 0; q < 3; ++q)
      p[q] = make_uint4(a.w[4 * q], a.w[4 * q + 1], a.w[4 * q + 2], a.w[4 * q + 3]);
  }
  __device__ __forceinline__ Words words(int v) const { return Words{plane(v)}; }
};

// Step 1, the accumulator and the operand in set `x`: role r's product
// of coordinate r and its raw sum of products over the coordinate pair
// (x, y), (x, z), (y, z), into set `y`.
__device__ __forceinline__ void padd_split_products(int role, const SplitLane& s, int x,
                                                    int y) {
  const int i = role == 2 ? 1 : 0, j = role == 0 ? 1 : 2;
  const F s2 = fq::radd(s.get(x + 3 + i), s.get(x + 3 + j));
  s.put(y + 3 + role, fq::rmm(fq::radd(s.get(x + i), s.get(x + j)), s2));
  s.put(y + role, fq::rmm(s.get(x + role), s.get(x + 3 + role)));
}

// Step 2, the products in set `y`: role 0 t3, t4 and 3 x1x2, role 1 y3,
// role 2 z3 and t1 (about the same work each), into set `x`.
__device__ __forceinline__ void padd_split_finals(int role, const SplitLane& s, int y,
                                                  int x) {
  if (role == 0) {
    s.put(x + kT3, fq::rsub(fq::rsub(s.get(y + 3), s.get(y + 0)), s.get(y + 1)));
    s.put(x + kT4, fq::rsub(fq::rsub(s.get(y + 5), s.get(y + 1)), s.get(y + 2)));
    const F t0 = s.get(y + 0);
    s.put(x + kT0x3, fq::radd(fq::radd(t0, t0), t0));
  } else if (role == 1) {
    s.put(x + kY3, fq::rmul12(fq::rsub(fq::rsub(s.get(y + 4), s.get(y + 0)), s.get(y + 2))));
  } else {
    const F t2 = fq::rmul12(s.get(y + 2));
    const F t1 = s.get(y + 1);
    s.put(x + kZ3, fq::radd(t1, t2));
    s.put(x + kT1, fq::rsub(t1, t2));
  }
}

// Step 3, the combinations in set `x`: output coordinate r,
//   x3 = t3 t1 - t4 y3, y3' = t1 z3 + y3 3x1x2, z3' = z3 t4 + 3x1x2 t3,
// with padd_core's operand order (t1, t4, 3x1x2 word operands only).
__device__ __forceinline__ F padd_split_result(int role, const SplitLane& s, int x) {
  const F a = s.get(x + (role == 0 ? kT3 : kZ3));
  F c = s.get(x + (role == 2 ? kT3 : kY3));
  if (role == 0) c = fq::rneg(c);
  return fq::rmm_add(a, s.words(x + (role == 2 ? kT4 : kT1)), c,
                     s.words(x + (role == 0 ? kT4 : kT0x3)));
}

// _dbl_core: dbl-2009-l.  Maps the identity (z = 0) to z3 = 0.
__device__ __forceinline__ void dbl_core(const F& x, const F& y, const F& z,
                                         F& x3, F& y3, F& z3) {
  F a = fq::mm(x, x);
  F b = fq::mm(y, y);
  F c = fq::mm(b, b);
  F xb = fq::fadd(x, b);
  F d = fq::fdbl(fq::fsub(fq::mm(xb, xb), fq::fadd(a, c)));
  F e = fq::fadd(fq::fdbl(a), a);
  F f = fq::mm(e, e);
  x3 = fq::fsub(f, fq::fdbl(d));
  F c8 = fq::fdbl(fq::fdbl(fq::fdbl(c)));
  y3 = fq::fsub(fq::mm(e, fq::fsub(d, x3)), c8);
  z3 = fq::fdbl(fq::mm(y, z));
}

// _add_core (add-2007-bl; the doubling where h = r = 0; p = O -> q;
// q = O -> p, both O: p), redesigned (g1_kernels.cu): relaxed products,
// each output canonicalised and put as soon as it is known; then the
// lanes whose result is not the add's put again: the doubling (in warps
// that hold such a lane) and the identity lanes, from operands read
// again.  `col`: this thread's column of a [4][NW][kThreads] shared
// array.
template <class Ld, class Again, class Put>
__device__ __forceinline__ void add_core(const Ld& ld, const Again& again,
                                         const Put& put, volatile uint32_t* col) {
  F r, u1, h;
  bool p_inf, q_inf;
  const Parked zz = {plane(col, 2)}, s1 = {plane(col, 3)};
  {
    const F z1 = ld(2), z2 = ld(5);
    p_inf = fq::is_zero(z1);
    q_inf = fq::is_zero(z2);
    park(zz.s, fq::rmm(z1, z2));
    const Parked z1z1 = park(plane(col, 0), fq::rmm(z1, z1));
    const Parked z2z2 = park(plane(col, 1), fq::rmm(z2, z2));
    const F y1z2z2z2 = fq::rmm(fq::rmm(ld(1), z2), z2z2);  // s1
    park(s1.s, y1z2z2z2);
    r = fq::rmm(fq::rmm(ld(4), z1), z1z1);  // s2 = y2 z1^3
    r = fq::rsub(r, y1z2z2z2);
    r = fq::radd(r, r);                     // 2 (s2 - s1)
    u1 = fq::rmm(ld(0), z2z2);              // x1 z2^2
    h = fq::rsub(fq::rmm(ld(3), z1z1), u1);  // u2 - u1
  }
  const bool same = fq::is_zero_rel(h) && fq::is_zero_rel(r);
  const F h2 = fq::radd(h, h);
  put(2, fq::canon(fq::rmm(h2, zz)));  // 2 z1 z2 h
  const F ii = fq::rmm(h2, h2);        // I = (2h)^2
  const F jj = fq::rmm(h, ii);         // J = h I
  const F v = fq::rmm(u1, ii);         // V = u1 I
  const F x3 = fq::rsub(fq::rsub(fq::rmm(r, r), jj), fq::radd(v, v));
  put(0, fq::canon(x3));
  // y3 = r (V - x3) - 2 s1 J, one reduction; V - x3 and s1 enter as
  // word operands only.
  const Parked w = park(plane(col, 0), fq::rsub(v, x3));
  put(1, fq::canon(fq::rmm_add(r, w, fq::rneg(fq::radd(jj, jj)), s1)));

  const bool needs_dbl = same && !p_inf && !q_inf;
  if (__any_sync(__activemask(), needs_dbl)) {  // uniform in the warp
    F xd, yd, zd;
    dbl_core(again(0), again(1), again(2), xd, yd, zd);
    if (needs_dbl) {
      put(0, xd);
      put(1, yd);
      put(2, zd);
    }
  }
  if (q_inf) {
    put(0, again(0));
    put(1, again(1));
    put(2, again(2));
  } else if (p_inf) {
    put(0, again(3));
    put(1, again(4));
    put(2, again(5));
  }
}

// Threads per block for a launch of n lanes: kThreads, or fewer (a
// multiple of 32) when n < kThreads * SMs, so that a small launch still
// puts one block on each SM instead of leaving SMs idle.
inline int threads_for(long long n) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  long long per_sm = (n + sms - 1) / sms;
  long long t = (per_sm + 31) / 32 * 32;
  return (int)(t < 32 ? 32 : t > kThreads ? kThreads : t);
}

// desc: 6 operands x (pointer, limb stride, batch stride, lane stride).
inline Operands operands(const long long* desc) {
  Operands in;
  for (int k = 0; k < 6; ++k) {
    in.o[k].p = (const void*)desc[4 * k];
    in.o[k].ls = desc[4 * k + 1];
    in.o[k].bs = desc[4 * k + 2];
    in.o[k].es = desc[4 * k + 3];
  }
  return in;
}

// desc: 3 outputs x (pointer, limb stride, batch stride, lane stride).
inline Outputs outputs(const long long* desc) {
  Outputs out;
  for (int k = 0; k < 3; ++k) {
    out.o[k].p = (int32_t*)desc[4 * k];
    out.o[k].ls = desc[4 * k + 1];
    out.o[k].bs = desc[4 * k + 2];
    out.o[k].es = desc[4 * k + 3];
  }
  return out;
}

}  // namespace g1
