// Native merlin-compatible transcript engine (Keccak-f[1600] +
// STROBE-128 + merlin framing) — the host-side Fiat-Shamir hot path.
//
// The reference gets this from the `merlin` Rust crate (a native
// dependency); the pure-Python implementation in ../transcript.py is
// the specification and fallback, and this library must match it
// byte-for-byte (tests/test_native.py).
//
// C ABI (used via ctypes, no pybind11 in this image):
//   void* merlin_new(const uint8_t* label, size_t len);
//   void  merlin_append(void* h, const uint8_t* label, size_t llen,
//                       const uint8_t* msg, size_t mlen);
//   void  merlin_challenge(void* h, const uint8_t* label, size_t llen,
//                          uint8_t* out, size_t outlen);
//   void  merlin_free(void* h);
//
// Build: g++ -O2 -shared -fPIC transcript.cpp -o libgemini_transcript.so

#include <cstdint>
#include <cstring>
#include <cstdlib>

namespace {

constexpr int STROBE_R = 166;
constexpr uint8_t FLAG_I = 1;
constexpr uint8_t FLAG_A = 1 << 1;
constexpr uint8_t FLAG_C = 1 << 2;
constexpr uint8_t FLAG_M = 1 << 4;

constexpr uint64_t RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,
    0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
    0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

inline uint64_t rotl(uint64_t x, int n) {
  return (x << n) | (x >> (64 - n));
}

void keccak_f1600(uint64_t* a) {
  // lanes indexed a[x + 5*y]
  static const int ROTC[5][5] = {{0, 36, 3, 41, 18},
                                 {1, 44, 10, 45, 2},
                                 {62, 6, 43, 15, 61},
                                 {28, 55, 25, 21, 56},
                                 {27, 20, 39, 8, 14}};
  uint64_t b[25], c[5], d[5];
  for (int rnd = 0; rnd < 24; ++rnd) {
    for (int x = 0; x < 5; ++x)
      c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
    for (int x = 0; x < 5; ++x)
      d[x] = c[(x + 4) % 5] ^ rotl(c[(x + 1) % 5], 1);
    for (int x = 0; x < 5; ++x)
      for (int y = 0; y < 5; ++y) a[x + 5 * y] ^= d[x];
    for (int x = 0; x < 5; ++x)
      for (int y = 0; y < 5; ++y)
        b[y + 5 * ((2 * x + 3 * y) % 5)] = rotl(a[x + 5 * y], ROTC[x][y]);
    for (int x = 0; x < 5; ++x)
      for (int y = 0; y < 5; ++y)
        a[x + 5 * y] =
            b[x + 5 * y] ^ ((~b[(x + 1) % 5 + 5 * y]) & b[(x + 2) % 5 + 5 * y]);
    a[0] ^= RC[rnd];
  }
}

struct Strobe {
  uint8_t state[200];
  uint8_t pos;
  uint8_t pos_begin;
  uint8_t cur_flags;

  void run_f() {
    state[pos] ^= pos_begin;
    state[pos + 1] ^= 0x04;
    state[STROBE_R + 1] ^= 0x80;
    keccak_f1600(reinterpret_cast<uint64_t*>(state));
    pos = 0;
    pos_begin = 0;
  }

  void absorb(const uint8_t* data, size_t n) {
    for (size_t i = 0; i < n; ++i) {
      state[pos] ^= data[i];
      if (++pos == STROBE_R) run_f();
    }
  }

  void squeeze(uint8_t* out, size_t n) {
    for (size_t i = 0; i < n; ++i) {
      out[i] = state[pos];
      state[pos] = 0;
      if (++pos == STROBE_R) run_f();
    }
  }

  void begin_op(uint8_t flags, bool more) {
    if (more) return;  // continuation: caller guarantees same flags
    uint8_t old_begin = pos_begin;
    pos_begin = pos + 1;
    cur_flags = flags;
    uint8_t hdr[2] = {old_begin, flags};
    absorb(hdr, 2);
    if ((flags & FLAG_C) && pos != 0) run_f();
  }

  void meta_ad(const uint8_t* d, size_t n, bool more) {
    begin_op(FLAG_M | FLAG_A, more);
    absorb(d, n);
  }
  void ad(const uint8_t* d, size_t n, bool more) {
    begin_op(FLAG_A, more);
    absorb(d, n);
  }
  void prf(uint8_t* out, size_t n) {
    begin_op(FLAG_I | FLAG_A | FLAG_C, false);
    squeeze(out, n);
  }

  void init(const uint8_t* proto, size_t plen) {
    memset(state, 0, 200);
    const uint8_t hdr[6] = {1, STROBE_R + 2, 1, 0, 1, 96};
    memcpy(state, hdr, 6);
    memcpy(state + 6, "STROBEv1.0.2", 12);
    keccak_f1600(reinterpret_cast<uint64_t*>(state));
    pos = 0;
    pos_begin = 0;
    cur_flags = 0;
    meta_ad(proto, plen, false);
  }
};

struct Merlin {
  Strobe strobe;

  void append(const uint8_t* label, size_t llen, const uint8_t* msg,
              size_t mlen) {
    uint8_t len_le[4] = {
        static_cast<uint8_t>(mlen & 0xff),
        static_cast<uint8_t>((mlen >> 8) & 0xff),
        static_cast<uint8_t>((mlen >> 16) & 0xff),
        static_cast<uint8_t>((mlen >> 24) & 0xff)};
    strobe.meta_ad(label, llen, false);
    strobe.meta_ad(len_le, 4, true);
    strobe.ad(msg, mlen, false);
  }

  void challenge(const uint8_t* label, size_t llen, uint8_t* out,
                 size_t outlen) {
    uint8_t len_le[4] = {
        static_cast<uint8_t>(outlen & 0xff),
        static_cast<uint8_t>((outlen >> 8) & 0xff),
        static_cast<uint8_t>((outlen >> 16) & 0xff),
        static_cast<uint8_t>((outlen >> 24) & 0xff)};
    strobe.meta_ad(label, llen, false);
    strobe.meta_ad(len_le, 4, true);
    strobe.prf(out, outlen);
  }
};

}  // namespace

extern "C" {

void* merlin_new(const uint8_t* label, size_t len) {
  Merlin* m = new Merlin();
  m->strobe.init(reinterpret_cast<const uint8_t*>("Merlin v1.0"), 11);
  m->append(reinterpret_cast<const uint8_t*>("dom-sep"), 7, label, len);
  return m;
}

void merlin_append(void* h, const uint8_t* label, size_t llen,
                   const uint8_t* msg, size_t mlen) {
  static_cast<Merlin*>(h)->append(label, llen, msg, mlen);
}

void merlin_challenge(void* h, const uint8_t* label, size_t llen,
                      uint8_t* out, size_t outlen) {
  static_cast<Merlin*>(h)->challenge(label, llen, out, outlen);
}

void merlin_free(void* h) { delete static_cast<Merlin*>(h); }
}
