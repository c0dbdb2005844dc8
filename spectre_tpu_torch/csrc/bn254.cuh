// BN254 Montgomery arithmetic and the complete projective G1 addition,
// shared by the port's CUDA kernels (msm_kernels.cu, field_kernels.cu and
// the per-block bodies in bucket.cuh and ntt.cuh).
//
// Everything here is __host__ __device__: the same per-element bodies the
// kernels launch can be compiled by a host C++ compiler and checked against
// the Python oracle without a GPU. add, sub and mont_mul have a second,
// PTX carry-chain body for the card (`__CUDA_ARCH__`); the host build checks
// the portable one, and the card's kernels are held against the plain
// PyTorch versions by tests/test_torch_cuda.py and chip_smoke.py.
//
// Values are 8 little-endian 32-bit limbs in Montgomery form with radix
// R = 2^256, the radix of the JAX reference's 16 x 16-bit limbs: a reference
// limb pair (lo, hi) is one 32-bit limb lo | hi << 16 here, so both hold the
// same Montgomery values. Every operation returns the canonical
// representative in [0, p), so any two correct evaluations of one formula
// agree limb for limb.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define SPT_HD __host__ __device__ __forceinline__
#else
#define SPT_HD inline
#endif

// atomicAdd on the card; a plain add where a host compiler runs one block's
// threads one after another. Returns the old value either way.
#if defined(__CUDA_ARCH__)
#define SPT_ATOMIC_ADD(ptr, v) atomicAdd((ptr), (v))
#else
#define SPT_ATOMIC_ADD(ptr, v) ((*(ptr) += (v)) - (v))
#endif

namespace spt {

enum FieldId { FQ = 0, FR = 1 };

// p, -p^-1 mod 2^32 and R mod p (the Montgomery one) of each field.
template <int F> struct Consts;

template <> struct Consts<FQ> {
  static constexpr uint32_t n0 = 0xe4866389u;
  SPT_HD static uint32_t p(int i) {
    constexpr uint32_t v[8] = {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du,
                               0x97816a91u, 0x8181585du, 0xb85045b6u,
                               0xe131a029u, 0x30644e72u};
    return v[i];
  }
  SPT_HD static uint32_t one(int i) {
    constexpr uint32_t v[8] = {0xc58f0d9du, 0xd35d438du, 0xf5c70b3du,
                               0x0a78eb28u, 0x7879462cu, 0x666ea36fu,
                               0x9a07df2fu, 0x0e0a77c1u};
    return v[i];
  }
};

template <> struct Consts<FR> {
  static constexpr uint32_t n0 = 0xefffffffu;
  SPT_HD static uint32_t p(int i) {
    constexpr uint32_t v[8] = {0xf0000001u, 0x43e1f593u, 0x79b97091u,
                               0x2833e848u, 0x8181585du, 0xb85045b6u,
                               0xe131a029u, 0x30644e72u};
    return v[i];
  }
  SPT_HD static uint32_t one(int i) {
    constexpr uint32_t v[8] = {0x4ffffffbu, 0xac96341cu, 0x9f60cd29u,
                               0x36fc7695u, 0x7879462eu, 0x666ea36fu,
                               0x9a07df2fu, 0x0e0a77c1u};
    return v[i];
  }
};

struct Fe {
  uint32_t v[8];
};

// a if a < p else a - p, for a < 2p.
template <int F> SPT_HD Fe cond_sub_p(const Fe& a) {
  Fe d;
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t cur = (uint64_t)a.v[i] - Consts<F>::p(i) - borrow;
    d.v[i] = (uint32_t)cur;
    borrow = (cur >> 63) & 1;
  }
  return borrow ? a : d;
}

#if defined(__CUDA_ARCH__)
// The card's versions of add, sub and mont_mul: the same values, with the
// limb carries in the PTX carry flag (add.cc / addc, mad.lo.cc / madc.hi.cc)
// instead of 64-bit sums; each carry chain is one asm statement, so nothing
// can come between its instructions.

template <int F> __device__ __forceinline__ Fe add_dev(const Fe& a, const Fe& b) {
  Fe s, d;
  uint32_t bw;
  asm("add.cc.u32 %0, %8, %16;\n\t"
      "addc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.u32 %7, %15, %23;\n\t"
      : "=r"(s.v[0]), "=r"(s.v[1]), "=r"(s.v[2]), "=r"(s.v[3]), "=r"(s.v[4]), "=r"(s.v[5]), "=r"(s.v[6]), "=r"(s.v[7])
      : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]), "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]),
        "r"(b.v[0]), "r"(b.v[1]), "r"(b.v[2]), "r"(b.v[3]), "r"(b.v[4]), "r"(b.v[5]), "r"(b.v[6]), "r"(b.v[7]));
  asm("sub.cc.u32 %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, 0, 0;"
      : "=r"(d.v[0]), "=r"(d.v[1]), "=r"(d.v[2]), "=r"(d.v[3]), "=r"(d.v[4]), "=r"(d.v[5]), "=r"(d.v[6]), "=r"(d.v[7]), "=r"(bw)
      : "r"(s.v[0]), "r"(s.v[1]), "r"(s.v[2]), "r"(s.v[3]), "r"(s.v[4]), "r"(s.v[5]), "r"(s.v[6]), "r"(s.v[7]),
        "r"(Consts<F>::p(0)), "r"(Consts<F>::p(1)), "r"(Consts<F>::p(2)), "r"(Consts<F>::p(3)), "r"(Consts<F>::p(4)), "r"(Consts<F>::p(5)), "r"(Consts<F>::p(6)), "r"(Consts<F>::p(7)));
  return bw ? s : d;  // a + b < 2p < 2^256: borrow iff a + b < p
}

template <int F> __device__ __forceinline__ Fe sub_dev(const Fe& a, const Fe& b) {
  Fe d, r;
  uint32_t bw;
  asm("sub.cc.u32 %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, 0, 0;"
      : "=r"(d.v[0]), "=r"(d.v[1]), "=r"(d.v[2]), "=r"(d.v[3]), "=r"(d.v[4]), "=r"(d.v[5]), "=r"(d.v[6]), "=r"(d.v[7]), "=r"(bw)
      : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]), "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]),
        "r"(b.v[0]), "r"(b.v[1]), "r"(b.v[2]), "r"(b.v[3]), "r"(b.v[4]), "r"(b.v[5]), "r"(b.v[6]), "r"(b.v[7]));
  asm("add.cc.u32 %0, %8, %16;\n\t"
      "addc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.u32 %7, %15, %23;\n\t"
      : "=r"(r.v[0]), "=r"(r.v[1]), "=r"(r.v[2]), "=r"(r.v[3]), "=r"(r.v[4]), "=r"(r.v[5]), "=r"(r.v[6]), "=r"(r.v[7])
      : "r"(d.v[0]), "r"(d.v[1]), "r"(d.v[2]), "r"(d.v[3]), "r"(d.v[4]), "r"(d.v[5]), "r"(d.v[6]), "r"(d.v[7]),
        "r"(Consts<F>::p(0) & bw), "r"(Consts<F>::p(1) & bw), "r"(Consts<F>::p(2) & bw), "r"(Consts<F>::p(3) & bw), "r"(Consts<F>::p(4) & bw), "r"(Consts<F>::p(5) & bw), "r"(Consts<F>::p(6) & bw), "r"(Consts<F>::p(7) & bw));
  return r;  // a - b, plus p where it borrowed
}

// CIOS, 8 rounds: t += a * b[i] (low halves into t[0..7], high halves into
// t[1..8], carries into t[8], t[9]), m = t[0] * n0, t += m * p the same
// way (t[0] becomes 0), shift down one limb.
template <int F> __device__ __forceinline__ Fe mont_mul_dev(const Fe& a, const Fe& b) {
  uint32_t t0 = 0, t1 = 0, t2 = 0, t3 = 0, t4 = 0, t5 = 0, t6 = 0, t7 = 0, t8 = 0,
           t9 = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t bi = b.v[i];
    asm("mad.lo.cc.u32 %0, %10, %18, %0;\n\t"
        "madc.lo.cc.u32 %1, %11, %18, %1;\n\t"
        "madc.lo.cc.u32 %2, %12, %18, %2;\n\t"
        "madc.lo.cc.u32 %3, %13, %18, %3;\n\t"
        "madc.lo.cc.u32 %4, %14, %18, %4;\n\t"
        "madc.lo.cc.u32 %5, %15, %18, %5;\n\t"
        "madc.lo.cc.u32 %6, %16, %18, %6;\n\t"
        "madc.lo.cc.u32 %7, %17, %18, %7;\n\t"
        "addc.cc.u32 %8, %8, 0;\n\t"
        "addc.u32 %9, %9, 0;\n\t"
        "mad.hi.cc.u32 %1, %10, %18, %1;\n\t"
        "madc.hi.cc.u32 %2, %11, %18, %2;\n\t"
        "madc.hi.cc.u32 %3, %12, %18, %3;\n\t"
        "madc.hi.cc.u32 %4, %13, %18, %4;\n\t"
        "madc.hi.cc.u32 %5, %14, %18, %5;\n\t"
        "madc.hi.cc.u32 %6, %15, %18, %6;\n\t"
        "madc.hi.cc.u32 %7, %16, %18, %7;\n\t"
        "madc.hi.cc.u32 %8, %17, %18, %8;\n\t"
        "addc.u32 %9, %9, 0;"
        : "+r"(t0), "+r"(t1), "+r"(t2), "+r"(t3), "+r"(t4), "+r"(t5), "+r"(t6), "+r"(t7), "+r"(t8), "+r"(t9)
        : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]), "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]), "r"(bi));
    const uint32_t m = t0 * Consts<F>::n0;
    asm("mad.lo.cc.u32 %0, %10, %18, %0;\n\t"
        "madc.lo.cc.u32 %1, %11, %18, %1;\n\t"
        "madc.lo.cc.u32 %2, %12, %18, %2;\n\t"
        "madc.lo.cc.u32 %3, %13, %18, %3;\n\t"
        "madc.lo.cc.u32 %4, %14, %18, %4;\n\t"
        "madc.lo.cc.u32 %5, %15, %18, %5;\n\t"
        "madc.lo.cc.u32 %6, %16, %18, %6;\n\t"
        "madc.lo.cc.u32 %7, %17, %18, %7;\n\t"
        "addc.cc.u32 %8, %8, 0;\n\t"
        "addc.u32 %9, %9, 0;\n\t"
        "mad.hi.cc.u32 %1, %10, %18, %1;\n\t"
        "madc.hi.cc.u32 %2, %11, %18, %2;\n\t"
        "madc.hi.cc.u32 %3, %12, %18, %3;\n\t"
        "madc.hi.cc.u32 %4, %13, %18, %4;\n\t"
        "madc.hi.cc.u32 %5, %14, %18, %5;\n\t"
        "madc.hi.cc.u32 %6, %15, %18, %6;\n\t"
        "madc.hi.cc.u32 %7, %16, %18, %7;\n\t"
        "madc.hi.cc.u32 %8, %17, %18, %8;\n\t"
        "addc.u32 %9, %9, 0;"
        : "+r"(t0), "+r"(t1), "+r"(t2), "+r"(t3), "+r"(t4), "+r"(t5), "+r"(t6), "+r"(t7), "+r"(t8), "+r"(t9)
        : "r"(Consts<F>::p(0)), "r"(Consts<F>::p(1)), "r"(Consts<F>::p(2)), "r"(Consts<F>::p(3)), "r"(Consts<F>::p(4)), "r"(Consts<F>::p(5)), "r"(Consts<F>::p(6)), "r"(Consts<F>::p(7)), "r"(m));
    t0 = t1; t1 = t2; t2 = t3; t3 = t4; t4 = t5; t5 = t6; t6 = t7; t7 = t8; t8 = t9;
    t9 = 0;
  }
  Fe r;
  r.v[0] = t0; r.v[1] = t1; r.v[2] = t2; r.v[3] = t3;
  r.v[4] = t4; r.v[5] = t5; r.v[6] = t6; r.v[7] = t7;
  return cond_sub_p<F>(r);  // p < R/4: the result is < 2p, t8 == 0
}
#endif

template <int F> SPT_HD Fe add(const Fe& a, const Fe& b) {
#if defined(__CUDA_ARCH__)
  return add_dev<F>(a, b);
#else
  Fe s;
  uint64_t carry = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t cur = (uint64_t)a.v[i] + b.v[i] + carry;
    s.v[i] = (uint32_t)cur;
    carry = cur >> 32;
  }
  return cond_sub_p<F>(s);  // a + b < 2p < 2^255: no carry out
#endif
}

template <int F> SPT_HD Fe sub(const Fe& a, const Fe& b) {
#if defined(__CUDA_ARCH__)
  return sub_dev<F>(a, b);
#else
  Fe d;
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t cur = (uint64_t)a.v[i] - b.v[i] - borrow;
    d.v[i] = (uint32_t)cur;
    borrow = (cur >> 63) & 1;
  }
  if (borrow) {  // a < b: add p back
    uint64_t carry = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      uint64_t cur = (uint64_t)d.v[i] + Consts<F>::p(i) + carry;
      d.v[i] = (uint32_t)cur;
      carry = cur >> 32;
    }
  }
  return d;
#endif
}

// CIOS Montgomery product a * b * 2^-256 mod p: 8 rounds, each one row of
// 32x32->64 products of a by b[i] and one row of m*p.
template <int F> SPT_HD Fe mont_mul(const Fe& a, const Fe& b) {
#if defined(__CUDA_ARCH__)
  return mont_mul_dev<F>(a, b);
#else
  uint32_t t[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint64_t cur = (uint64_t)a.v[j] * b.v[i] + t[j] + c;
      t[j] = (uint32_t)cur;
      c = cur >> 32;
    }
    uint64_t cur = (uint64_t)t[8] + c;
    t[8] = (uint32_t)cur;
    t[9] = (uint32_t)(cur >> 32);
    uint32_t m = t[0] * Consts<F>::n0;
    cur = (uint64_t)m * Consts<F>::p(0) + t[0];
    c = cur >> 32;
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      cur = (uint64_t)m * Consts<F>::p(j) + t[j] + c;
      t[j - 1] = (uint32_t)cur;
      c = cur >> 32;
    }
    cur = (uint64_t)t[8] + c;
    t[7] = (uint32_t)cur;
    t[8] = t[9] + (uint32_t)(cur >> 32);
  }
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = t[i];
  return cond_sub_p<F>(r);  // p < R/4: the result is < 2p, t[8] == 0
#endif
}

template <int F> SPT_HD Fe zero() {
  Fe z;
#pragma unroll
  for (int i = 0; i < 8; ++i) z.v[i] = 0;
  return z;
}

// ---------------------------------------------------------------------------
// BN254 G1, homogeneous projective (X:Y:Z) over Fq, infinity = (0:1:0)
// ---------------------------------------------------------------------------

struct Point {
  Fe x, y, z;
};

SPT_HD Point infinity() {
  Point r;
  r.x = zero<FQ>();
  r.z = zero<FQ>();
#pragma unroll
  for (int i = 0; i < 8; ++i) r.y.v[i] = Consts<FQ>::one(i);
  return r;
}

// Complete addition, Renes-Costello-Batina 2015 alg. 7 (a = 0, b3 = 3b = 9):
// the operation sequence of the reference's Pallas `_k_padd`, 12 Montgomery
// products with the two multiplications by b3 done as additions. One
// branch-free formula covers generic add, doubling, inverses and infinity.
SPT_HD Point padd(const Point& p, const Point& q) {
  Fe t0 = mont_mul<FQ>(p.x, q.x);
  Fe t1 = mont_mul<FQ>(p.y, q.y);
  Fe t2 = mont_mul<FQ>(p.z, q.z);
  Fe m3 = mont_mul<FQ>(add<FQ>(p.x, p.y), add<FQ>(q.x, q.y));
  Fe m4 = mont_mul<FQ>(add<FQ>(p.y, p.z), add<FQ>(q.y, q.z));
  Fe m5 = mont_mul<FQ>(add<FQ>(p.x, p.z), add<FQ>(q.x, q.z));
  Fe t3 = sub<FQ>(sub<FQ>(m3, t0), t1);
  Fe t4 = sub<FQ>(sub<FQ>(m4, t1), t2);
  Fe yc = sub<FQ>(sub<FQ>(m5, t0), t2);
  Fe t0_3 = add<FQ>(add<FQ>(t0, t0), t0);
  Fe t2_2 = add<FQ>(t2, t2);
  Fe t2_4 = add<FQ>(t2_2, t2_2);
  Fe b3t2 = add<FQ>(add<FQ>(t2_4, t2_4), t2);
  Fe y_2 = add<FQ>(yc, yc);
  Fe y_4 = add<FQ>(y_2, y_2);
  Fe b3y = add<FQ>(add<FQ>(y_4, y_4), yc);
  Fe z3p = add<FQ>(t1, b3t2);
  Fe t1m = sub<FQ>(t1, b3t2);
  Point r;
  r.x = sub<FQ>(mont_mul<FQ>(t3, t1m), mont_mul<FQ>(t4, b3y));
  r.y = add<FQ>(mont_mul<FQ>(t1m, z3p), mont_mul<FQ>(b3y, t0_3));
  r.z = add<FQ>(mont_mul<FQ>(z3p, t4), mont_mul<FQ>(t0_3, t3));
  return r;
}

// ---------------------------------------------------------------------------
// memory layouts
//   field vector: [n, 4] uint64 = [n, 8] uint32 limbs per element
//   point (AoS32): [n, 24] uint32 = X[8] | Y[8] | Z[8]
// ---------------------------------------------------------------------------

SPT_HD Fe load_fe(const uint32_t* src) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = src[i];
  return r;
}

SPT_HD void store_fe(uint32_t* dst, const Fe& a) {
#pragma unroll
  for (int i = 0; i < 8; ++i) dst[i] = a.v[i];
}

SPT_HD Point load_point(const uint32_t* src) {
  Point r;
  r.x = load_fe(src);
  r.y = load_fe(src + 8);
  r.z = load_fe(src + 16);
  return r;
}

SPT_HD void store_point(uint32_t* dst, const Point& a) {
  store_fe(dst, a.x);
  store_fe(dst + 8, a.y);
  store_fe(dst + 16, a.z);
}

// Y -> -Y (infinity (0:1:0) becomes (0:p-1:0), still infinity).
SPT_HD Point neg(const Point& a) {
  Point r = a;
  r.y = sub<FQ>(zero<FQ>(), a.y);
  return r;
}

// the low `bits` bits of x in reverse order
SPT_HD uint32_t bitrev(uint32_t x, int bits) {
  if (bits == 0) return 0;
#if defined(__CUDA_ARCH__)
  return __brev(x) >> (32 - bits);
#else
  uint32_t r = 0;
  for (int i = 0; i < bits; ++i) r |= ((x >> i) & 1u) << (bits - 1 - i);
  return r;
#endif
}

// 16 bytes from src to dst (one 128-bit access on the card)
SPT_HD void copy16(uint32_t* dst, const uint32_t* src) {
#if defined(__CUDA_ARCH__)
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
#else
  for (int i = 0; i < 4; ++i) dst[i] = src[i];
#endif
}

// ---------------------------------------------------------------------------
// per-thread bodies of the kernels
// ---------------------------------------------------------------------------

// K2: out[i] = p[i] + q[i].
SPT_HD void padd_one(long i, const uint32_t* p, const uint32_t* q,
                     uint32_t* out) {
  store_point(out + 24 * i,
              padd(load_point(p + 24 * i), load_point(q + 24 * i)));
}

// K3: out[i] = a[i] * b[i % nb] (Montgomery), field F.
template <int F>
SPT_HD void mont_mul_one(long i, const uint32_t* a, const uint32_t* b,
                         long nb, uint32_t* out) {
  store_fe(out + 8 * i,
           mont_mul<F>(load_fe(a + 8 * i), load_fe(b + 8 * (i % nb))));
}

}  // namespace spt
