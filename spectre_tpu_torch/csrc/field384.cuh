// BLS12-381 Fq for K6 (csrc/field384_kernels.cu), one value spread over a
// group of kGroup lanes of a warp: lane j < kLanes holds the 64-bit digit j
// of the value (word j of the [n, 6] int64 tensors of
// spectre_tpu_torch/ops/field384.py, 32-bit limbs little-endian: the value
// of the JAX package's 24 x 16-bit limbs); the lanes above hold 0. Values are
// in Montgomery form with R = 2^384.
//
// The arithmetic is written once, over a lane policy W. On the card
// (WarpLanes) a lane is a thread, and lanes exchange digits with
// __shfl_sync and carry bits with __ballot_sync. On the host (HostLanes) a
// lane is one element of an array of kGroup values and a shuffle is a
// permutation, so g++ runs the same rounds lane by lane, and
// tests/test_torch_field384.py holds them against the plain PyTorch version.
// Products return values below 2p with exact digits; canonical() and add()
// return the representative in [0, p), so any two correct evaluations of one
// formula agree limb for limb.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define SPT384_FN __device__ __forceinline__
#define SPT384_CONST __constant__
#else
#define SPT384_FN inline
#define SPT384_CONST static const
#endif

namespace spt384 {

constexpr int kLanes = 6;  // the lanes that hold a value's digits
// lanes a key: a power of two (the shuffles' width) above kLanes, so that
// the top digit's lane shifts in the 0 of the lane above it
constexpr int kGroup = 8;
constexpr uint32_t kLive = (1u << kLanes) - 1;
constexpr uint64_t kLo32 = 0xffffffffull;
// -p^-1 mod 2^64: a round's quotient
constexpr uint64_t kNp0 = 0x89f3fffcfffcfffdull;

// p and 4 R mod p (the curve's b = 4 in Montgomery form), a digit a lane
SPT384_CONST uint64_t kP[kLanes] = {
    0xb9feffffffffaaabull, 0x1eabfffeb153ffffull, 0x6730d2a0f6b0f624ull,
    0x64774b84f38512bfull, 0x4b1ba7b6434bacd7ull, 0x1a0111ea397fe69aull};
SPT384_CONST uint64_t kFour[kLanes] = {
    0xaa270000000cfff3ull, 0x53cc0032fc34000aull, 0x478fe97a6b0a807full,
    0xb1d37ebee6ba24d7ull, 0x8ec9733bbf78ab2full, 0x09d645513d83de7eull};

// The square-root exponent (p + 1) / 4 as a sliding-window chain of 5-bit
// windows (chip_smoke.window_chain's): start from the table's power
// kSqrtFirst, then for each step square `squarings` times and multiply by
// the table's power `digit` (odd). The table holds the odd powers 1, 3, ...,
// 31. 375 squarings and 66 multiplies, the same for every key, so no warp
// diverges.
struct Step {
  uint8_t squarings, digit;
};
constexpr int kTable = 16;
constexpr int kSqrtFirst = 13;
constexpr int kSqrtSteps = 66;
SPT384_CONST Step kSqrtChain[kSqrtSteps] = {
    {13, 17}, {7, 15}, {4, 5},  {6, 7},  {7, 23}, {5, 31}, {5, 25}, {3, 5},  {6, 13},
    {6, 9},   {3, 3},  {8, 27}, {3, 5},  {6, 15}, {6, 27}, {3, 1},  {8, 13}, {7, 23},
    {5, 11},  {6, 13}, {6, 29}, {4, 9},  {8, 29}, {4, 13}, {7, 23}, {9, 19}, {5, 25},
    {2, 3},   {7, 5},  {7, 9},  {6, 23}, {5, 29}, {5, 19}, {5, 19}, {8, 13}, {7, 21},
    {9, 15},  {5, 13}, {3, 3},  {8, 15}, {3, 3},  {7, 9},  {9, 15}, {6, 21}, {6, 31},
    {5, 31},  {5, 31}, {4, 13}, {3, 3},  {8, 21}, {7, 31}, {5, 31}, {5, 31}, {4, 15},
    {4, 7},   {7, 31}, {5, 29}, {5, 31}, {5, 31}, {5, 31}, {5, 31}, {5, 31}, {5, 31},
    {4, 13},  {6, 21}, {5, 11}};

#if defined(__CUDACC__)
// A lane is a thread; a group is kGroup neighbouring threads of one warp.
// Every thread of the warp takes part in every shuffle and ballot.
struct WarpLanes {
  using U64 = uint64_t;
  using B = bool;
  static constexpr unsigned kAll = 0xffffffffu;
  static SPT384_FN U64 lane() { return threadIdx.x & (kGroup - 1); }
  // lane src's value, to every lane of the group
  static SPT384_FN U64 shfl(U64 v, int src) {
    return __shfl_sync(kAll, (unsigned long long)v, src, kGroup);
  }
  // the value of the lane above (the top lane keeps its own)
  static SPT384_FN U64 down(U64 v) {
    return __shfl_down_sync(kAll, (unsigned long long)v, 1, kGroup);
  }
  // the value of the lane below (lane 0 keeps its own)
  static SPT384_FN U64 up(U64 v) {
    return __shfl_up_sync(kAll, (unsigned long long)v, 1, kGroup);
  }
  // bit j: pred of the group's lane j
  static SPT384_FN uint32_t ballot(B pred) {
    return __ballot_sync(kAll, pred) >> ((threadIdx.x & 31) & ~(kGroup - 1));
  }
  static SPT384_FN U64 sel(B c, U64 a, U64 b) { return c ? a : b; }
  // the 64-bit product of the low halves
  static SPT384_FN U64 wide(U64 a, U64 b) { return (uint64_t)(uint32_t)a * (uint32_t)b; }
  // this lane's digit of a constant's kLanes digits
  static SPT384_FN U64 digit(const uint64_t* digits) {
    return lane() < kLanes ? digits[lane()] : 0;
  }
  static SPT384_FN Step step(int k) { return kSqrtChain[k]; }
};
#else
// kGroup values, one a lane, with the operators of a scalar applied lane by
// lane: the host's stand-in for a lane group.
template <class T>
struct Lanes {
  T v[kGroup];
  Lanes() : v{} {}
  Lanes(T s) {
    for (T& e : v) e = s;
  }
  T& operator[](int j) { return v[j]; }
  const T& operator[](int j) const { return v[j]; }
#define SPT384_LANES_OP(op)                                          \
  friend Lanes operator op(const Lanes& a, const Lanes& b) {         \
    Lanes r;                                                         \
    for (int j = 0; j < kGroup; ++j) r.v[j] = a.v[j] op b.v[j];      \
    return r;                                                        \
  }                                                                  \
  Lanes& operator op##=(const Lanes& b) { return *this = *this op b; }
  SPT384_LANES_OP(+)
  SPT384_LANES_OP(-)
  SPT384_LANES_OP(*)
  SPT384_LANES_OP(&)
  SPT384_LANES_OP(|)
  SPT384_LANES_OP(<<)
  SPT384_LANES_OP(>>)
#undef SPT384_LANES_OP
#define SPT384_LANES_CMP(op)                                           \
  friend Lanes<bool> operator op(const Lanes& a, const Lanes& b) {     \
    Lanes<bool> r;                                                     \
    for (int j = 0; j < kGroup; ++j) r.v[j] = a.v[j] op b.v[j];        \
    return r;                                                          \
  }
  SPT384_LANES_CMP(==)
  SPT384_LANES_CMP(<)
#undef SPT384_LANES_CMP
};

struct HostLanes {
  using U64 = Lanes<uint64_t>;
  using B = Lanes<bool>;
  static U64 lane() {
    U64 r;
    for (int j = 0; j < kGroup; ++j) r[j] = j;
    return r;
  }
  static U64 shfl(const U64& v, int src) { return U64(v[src]); }
  static U64 down(const U64& v) {
    U64 r;
    for (int j = 0; j < kGroup; ++j) r[j] = v[j + 1 < kGroup ? j + 1 : j];
    return r;
  }
  static U64 up(const U64& v) {
    U64 r;
    for (int j = 0; j < kGroup; ++j) r[j] = v[j > 0 ? j - 1 : j];
    return r;
  }
  static uint32_t ballot(const B& pred) {
    uint32_t m = 0;
    for (int j = 0; j < kGroup; ++j) m |= (uint32_t)pred[j] << j;
    return m;
  }
  static U64 sel(const B& c, const U64& a, const U64& b) {
    U64 r;
    for (int j = 0; j < kGroup; ++j) r[j] = c[j] ? a[j] : b[j];
    return r;
  }
  static U64 wide(const U64& a, const U64& b) { return (a & kLo32) * (b & kLo32); }
  static U64 digit(const uint64_t* digits) {
    U64 r;
    for (int j = 0; j < kLanes; ++j) r[j] = digits[j];
    return r;
  }
  static Step step(int k) { return kSqrtChain[k]; }
};
#endif

// The arithmetic of one lane group; every call is made by all its lanes,
// and a U64 is this lane's digit of a value.
template <class W>
struct Group {
  using U64 = typename W::U64;
  using B = typename W::B;
  const U64 lane;
  const U64 pd, four;  // this lane's digits of p and of 4 R mod p

  SPT384_FN Group() : lane(W::lane()), pd(W::digit(kP)), four(W::digit(kFour)) {}

  // What each lane receives in a carry (or borrow) chain in which lane j
  // starts one (gen) or passes on the one it receives (prop), resolved for
  // all lanes at once by one addition of the two masks: bit j is what lane
  // j receives, bit kLanes what leaves the top digit.
  SPT384_FN uint32_t chain(B gen, B prop) const {
    const uint32_t g = W::ballot(gen) & kLive, p = W::ballot(prop) & kLive;
    return (p + (g << 1)) ^ p;
  }
  SPT384_FN U64 bit(uint32_t mask) const { return (U64(mask) >> lane) & U64(1); }

  // d += x; whether it carried out
  static SPT384_FN B add_in(U64& d, U64 x) {
    d += x;
    return d < x;
  }

  // The lazy columns, 32 bits apart from bit 0 of this lane's digit, of the
  // product of digits a and b: r[0], r[1] for this lane, r[2], r[3] for the
  // one above.
  static SPT384_FN void columns(U64 a, U64 b, U64 (&r)[4]) {
    const U64 a0 = a & kLo32, a1 = a >> 32, b0 = b & kLo32, b1 = b >> 32;
    const U64 s00 = W::wide(a0, b0), s01 = W::wide(a0, b1), s10 = W::wide(a1, b0),
              s11 = W::wide(a1, b1);
    r[0] = s00 & kLo32;
    r[1] = (s00 >> 32) + (s01 & kLo32) + (s10 & kLo32);
    r[2] = (s01 >> 32) + (s10 >> 32) + (s11 & kLo32);
    r[3] = s11 >> 32;
  }

  // The exact digit of c[0] + c[1] 2^32, into d; returns what is above it
  // (the carry out of the digit)
  static SPT384_FN U64 resolve(const U64 (&c)[2], U64& d) {
    const U64 hi = c[1] + (c[0] >> 32);
    d = (c[0] & kLo32) | (hi << 32);
    return hi >> 32;
  }

  // Exact digits of t = sum over lanes of their columns < 2^384: within
  // each lane, then what a lane carries (< 2^11) to the one above, then the
  // last one-bit carries through digits that are all ones, by chain().
  SPT384_FN U64 normalize(const U64 (&c)[2]) const {
    U64 d;
    const U64 k = resolve(c, d);
    const B gen = add_in(d, W::sel(lane == U64(0), U64(0), W::up(k)));
    add_in(d, bit(chain(gen, d == U64(~0ull))));
    return d;
  }

  // Montgomery product a * b * 2^-384 mod p, below 2p for a and b below 2p
  // (p < R / 8), in kLanes rounds of a digit of b (CIOS over the lanes).
  // Lane j keeps the two 32-bit columns of the running sum t from bit 64 j
  // on in 64-bit words that take the carries lazily, so nothing moves
  // between lanes but b_i, m and t's shift. Round i: each lane adds its
  // digit of a times b_i (broadcast from lane i): half the columns to its
  // own, half kept for after the shift. Lane 0 forms m = t * -p^-1 mod 2^64
  // from its columns and broadcasts it; each lane adds m times its digit of
  // p the same way; t shifts down a digit (from the lane above), and lane
  // 0's digit, now 0, carries into the new digit 0.
  SPT384_FN U64 mul(U64 a, U64 b) const {
    U64 c[2] = {U64(0), U64(0)};
#pragma unroll
    for (int i = 0; i < kLanes; ++i) {
      U64 r[4], q[4], t;
      columns(a, W::shfl(b, i), r);
      c[0] += r[0];
      c[1] += r[1];
      resolve(c, t);
      columns(W::shfl(t * U64(kNp0), 0), pd, q);
      c[0] += q[0];
      c[1] += q[1];
      const U64 out = resolve(c, t);
      c[0] = W::down(c[0]) + r[2] + q[2] + W::sel(lane == U64(0), out, U64(0));
      c[1] = W::down(c[1]) + r[3] + q[3];
    }
    return normalize(c);
  }
  // A squaring is a product of a with itself: doubling the cross products
  // in round i (a_i a_j, j > i) takes selects and shifts on every lane, and
  // in lock step a lane below the diagonal waits all the same, so both
  // forms tried ran slower than the product (scripts/torch_kernel_variants.py).
  SPT384_FN U64 sqr(U64 a) const { return mul(a, a); }

  // a mod p for a below 2p: a - p by a borrow chain, kept where it borrows
  // out of the top digit
  SPT384_FN U64 canonical(U64 a) const {
    const uint32_t borrow = chain(a < pd, a == pd);
    if ((borrow >> kLanes) & 1) return a;
    return a - pd - bit(borrow);
  }

  // a + b mod p for a, b in [0, p)
  SPT384_FN U64 add(U64 a, U64 b) const {
    U64 d = a + b;
    const B carry = d < a;
    add_in(d, bit(chain(carry, d == U64(~0ull))));
    return canonical(d);
  }

  SPT384_FN bool equal(U64 a, U64 b) const { return (W::ballot(a == b) & kLive) == kLive; }

  // One key: x (this lane's digit, in [0, p)) -> y = (x^3 + 4)^((p + 1) / 4)
  // in [0, p), and whether y^2 = x^3 + 4, i.e. whether x is on the curve.
  // 460 products: x^3 (2), the table (16), the chain (375 + 66), the check.
  SPT384_FN int decompress(U64 x, U64& y) const {
    const U64 rhs = add(canonical(mul(sqr(x), x)), four);
    U64 table[kTable];
    table[0] = rhs;
    const U64 rhs2 = sqr(rhs);
#pragma unroll 1
    for (int k = 1; k < kTable; ++k) table[k] = mul(table[k - 1], rhs2);
    U64 acc = table[kSqrtFirst >> 1];
#pragma unroll 1
    for (int s = 0; s < kSqrtSteps; ++s) {
      const Step st = W::step(s);
      const U64 t = table[st.digit >> 1];
#pragma unroll 1
      for (int q = 0; q < st.squarings; ++q) acc = sqr(acc);
      acc = mul(acc, t);
    }
    y = canonical(acc);
    return equal(canonical(sqr(y)), rhs) ? 1 : 0;
  }
};

}  // namespace spt384
