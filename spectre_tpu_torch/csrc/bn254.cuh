// BN254 Montgomery arithmetic and the complete projective G1 addition,
// shared by the port's CUDA kernels (msm_kernels.cu, field_kernels.cu and
// the per-block bodies in bucket.cuh, aggregate.cuh and ntt.cuh).
//
// Everything here is __host__ __device__: the same per-element bodies the
// kernels launch can be compiled by a host C++ compiler and checked against
// the Python oracle without a GPU. add and sub have a second, PTX
// carry-chain body for the card (`__CUDA_ARCH__`); mont_mul runs the same
// rows and carry chains on both, its chains in PTX on the card. The card's
// kernels are held against the plain PyTorch versions by
// tests/test_torch_cuda.py and chip_smoke.py.
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
// The card's versions of add and sub, and the carry chains of mont_mul: the
// same values, with the limb carries in the PTX carry flag (add.cc / addc)
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

// One round of the product on the card (see mont_mul): the row a * bi as
// eight independent mul.wide.u32, its low halves added into t[0..7] by one
// carry chain and its high halves into t[1..8] by a second; *w8 is t[8].
__device__ __forceinline__ void mont_row_dev(uint32_t t[8], uint32_t* w8,
                                             const Fe& a, uint32_t bi) {
  asm("{\n\t.reg .u64 q0, q1, q2, q3, q4, q5, q6, q7;\n\t"
      ".reg .u32 l0, l1, l2, l3, l4, l5, l6, l7, h0, h1, h2, h3, h4, h5, h6, h7;\n\t"
      "mul.wide.u32 q0, %9, %17;\n\tmul.wide.u32 q1, %10, %17;\n\t"
      "mul.wide.u32 q2, %11, %17;\n\tmul.wide.u32 q3, %12, %17;\n\t"
      "mul.wide.u32 q4, %13, %17;\n\tmul.wide.u32 q5, %14, %17;\n\t"
      "mul.wide.u32 q6, %15, %17;\n\tmul.wide.u32 q7, %16, %17;\n\t"
      "mov.b64 {l0, h0}, q0;\n\tmov.b64 {l1, h1}, q1;\n\tmov.b64 {l2, h2}, q2;\n\tmov.b64 {l3, h3}, q3;\n\t"
      "mov.b64 {l4, h4}, q4;\n\tmov.b64 {l5, h5}, q5;\n\tmov.b64 {l6, h6}, q6;\n\tmov.b64 {l7, h7}, q7;\n\t"
      "add.cc.u32 %0, %0, l0;\n\taddc.cc.u32 %1, %1, l1;\n\taddc.cc.u32 %2, %2, l2;\n\t"
      "addc.cc.u32 %3, %3, l3;\n\taddc.cc.u32 %4, %4, l4;\n\taddc.cc.u32 %5, %5, l5;\n\t"
      "addc.cc.u32 %6, %6, l6;\n\taddc.cc.u32 %7, %7, l7;\n\taddc.u32 %8, 0, 0;\n\t"
      "add.cc.u32 %1, %1, h0;\n\taddc.cc.u32 %2, %2, h1;\n\taddc.cc.u32 %3, %3, h2;\n\t"
      "addc.cc.u32 %4, %4, h3;\n\taddc.cc.u32 %5, %5, h4;\n\taddc.cc.u32 %6, %6, h5;\n\t"
      "addc.cc.u32 %7, %7, h6;\n\taddc.u32 %8, %8, h7;\n\t}"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "=r"(*w8)
      : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]), "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]), "r"(bi));
}

// The reduction half of a round on the card: t + m * p shifted down one
// limb, the same two chains (the low word of t + m * p is 0 and dropped).
template <int F>
__device__ __forceinline__ void mont_reduce_dev(uint32_t t[8], uint32_t w8, uint32_t m) {
  asm("{\n\t.reg .u64 q0, q1, q2, q3, q4, q5, q6, q7;\n\t"
      ".reg .u32 l0, l1, l2, l3, l4, l5, l6, l7, h0, h1, h2, h3, h4, h5, h6, h7;\n\t"
      "mul.wide.u32 q0, %10, %9;\n\tmul.wide.u32 q1, %11, %9;\n\t"
      "mul.wide.u32 q2, %12, %9;\n\tmul.wide.u32 q3, %13, %9;\n\t"
      "mul.wide.u32 q4, %14, %9;\n\tmul.wide.u32 q5, %15, %9;\n\t"
      "mul.wide.u32 q6, %16, %9;\n\tmul.wide.u32 q7, %17, %9;\n\t"
      "mov.b64 {l0, h0}, q0;\n\tmov.b64 {l1, h1}, q1;\n\tmov.b64 {l2, h2}, q2;\n\tmov.b64 {l3, h3}, q3;\n\t"
      "mov.b64 {l4, h4}, q4;\n\tmov.b64 {l5, h5}, q5;\n\tmov.b64 {l6, h6}, q6;\n\tmov.b64 {l7, h7}, q7;\n\t"
      "add.cc.u32 l0, %0, l0;\n\taddc.cc.u32 %0, %1, l1;\n\taddc.cc.u32 %1, %2, l2;\n\t"
      "addc.cc.u32 %2, %3, l3;\n\taddc.cc.u32 %3, %4, l4;\n\taddc.cc.u32 %4, %5, l5;\n\t"
      "addc.cc.u32 %5, %6, l6;\n\taddc.cc.u32 %6, %7, l7;\n\taddc.u32 %7, %8, 0;\n\t"
      "add.cc.u32 %0, %0, h0;\n\taddc.cc.u32 %1, %1, h1;\n\taddc.cc.u32 %2, %2, h2;\n\t"
      "addc.cc.u32 %3, %3, h3;\n\taddc.cc.u32 %4, %4, h4;\n\taddc.cc.u32 %5, %5, h5;\n\t"
      "addc.cc.u32 %6, %6, h6;\n\taddc.u32 %7, %7, h7;\n\t}"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7])
      : "r"(w8), "r"(m), "r"(Consts<F>::p(0)), "r"(Consts<F>::p(1)), "r"(Consts<F>::p(2)), "r"(Consts<F>::p(3)),
        "r"(Consts<F>::p(4)), "r"(Consts<F>::p(5)), "r"(Consts<F>::p(6)), "r"(Consts<F>::p(7)));
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

// One round of the product (see mont_mul): t += a * bi, then t += m * p
// for m = t[0] * n0, shifted down one limb.
template <int F> SPT_HD void mont_round(uint32_t t[8], const Fe& a, uint32_t bi) {
  uint32_t w8;
#if defined(__CUDA_ARCH__)
  mont_row_dev(t, &w8, a, bi);
  mont_reduce_dev<F>(t, w8, t[0] * Consts<F>::n0);
#else
  uint64_t q[8];
  for (int j = 0; j < 8; ++j) q[j] = (uint64_t)a.v[j] * bi;
  uint64_t c = 0;
  for (int j = 0; j < 8; ++j) {             // low halves at limbs 0..7
    c += (uint64_t)t[j] + (uint32_t)q[j];
    t[j] = (uint32_t)c;
    c >>= 32;
  }
  w8 = (uint32_t)c;
  c = 0;
  for (int j = 1; j < 8; ++j) {             // high halves at limbs 1..8
    c += (uint64_t)t[j] + (uint32_t)(q[j - 1] >> 32);
    t[j] = (uint32_t)c;
    c >>= 32;
  }
  w8 += (uint32_t)(q[7] >> 32) + (uint32_t)c;
  const uint32_t m = t[0] * Consts<F>::n0;
  for (int j = 0; j < 8; ++j) q[j] = (uint64_t)m * Consts<F>::p(j);
  c = ((uint64_t)t[0] + (uint32_t)q[0]) >> 32;   // limb 0 becomes 0
  for (int j = 1; j < 8; ++j) {             // low halves, shifted down
    c += (uint64_t)t[j] + (uint32_t)q[j];
    t[j - 1] = (uint32_t)c;
    c >>= 32;
  }
  t[7] = w8 + (uint32_t)c;
  c = 0;
  for (int j = 0; j < 7; ++j) {             // high halves, shifted down
    c += (uint64_t)t[j] + (uint32_t)(q[j] >> 32);
    t[j] = (uint32_t)c;
    c >>= 32;
  }
  t[7] += (uint32_t)(q[7] >> 32) + (uint32_t)c;
#endif
}

// Montgomery product a * b * 2^-256 mod p, CIOS over 8 x 32-bit limbs in
// 8 rounds. A round adds the row a * b[i] into the running sum t (< 2p,
// 8 limbs, t[8] = w8 the limb above), then m * p for m = t[0] * n0, and
// shifts down one limb. A row is 8 independent 32 x 32 -> 64-bit products
// (IMAD.WIDE.U32 on the card) with no carry between them; the sum takes
// their low halves at limbs 0..7 in one carry chain and their high halves
// at limbs 1..8 in a second, so each limb product costs one wide multiply
// and two carry-chain adds, and only the adds are serial. On the card the
// chains are PTX add.cc/addc (mont_row_dev, mont_reduce_dev); the host runs
// the same two chains with 64-bit sums.
//
// STEP is how many rounds one pass of the round loop holds, a matter of code
// size only: 8 (straight-line code, ~440 instructions) where one product
// stands alone (K3, K4, K2's single add); 2 in the complete add of the
// kernels that inline several adds (K1c, K1d, K2b), where 12 straight-line
// products an add outgrew the instruction cache and ran slower
// (scripts/torch_kernel_variants.py).
template <int F, int STEP = 8> SPT_HD Fe mont_mul(const Fe& a, const Fe& b) {
  static_assert(8 % STEP == 0, "STEP divides the 8 rounds");
  uint32_t t[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll 1
  for (int i0 = 0; i0 < 8; i0 += STEP)
#pragma unroll
  for (int k = 0; k < STEP; ++k) mont_round<F>(t, a, b.v[i0 + k]);
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = t[i];
  return cond_sub_p<F>(r);  // p < R/4: the sum stays below 2p
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
// STEP: the products' rounds per loop pass (mont_mul); 2 unless the caller
// inlines this one add alone.
template <int STEP = 2> SPT_HD Point padd(const Point& p, const Point& q) {
  Fe t0 = mont_mul<FQ, STEP>(p.x, q.x);
  Fe t1 = mont_mul<FQ, STEP>(p.y, q.y);
  Fe t2 = mont_mul<FQ, STEP>(p.z, q.z);
  Fe m3 = mont_mul<FQ, STEP>(add<FQ>(p.x, p.y), add<FQ>(q.x, q.y));
  Fe m4 = mont_mul<FQ, STEP>(add<FQ>(p.y, p.z), add<FQ>(q.y, q.z));
  Fe m5 = mont_mul<FQ, STEP>(add<FQ>(p.x, p.z), add<FQ>(q.x, q.z));
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
  r.x = sub<FQ>(mont_mul<FQ, STEP>(t3, t1m), mont_mul<FQ, STEP>(t4, b3y));
  r.y = add<FQ>(mont_mul<FQ, STEP>(t1m, z3p), mont_mul<FQ, STEP>(b3y, t0_3));
  r.z = add<FQ>(mont_mul<FQ, STEP>(z3p, t4), mont_mul<FQ, STEP>(t0_3, t3));
  return r;
}

// 9 a (b3 = 3b = 9), by additions.
SPT_HD Fe times_b3(const Fe& a) {
  const Fe a2 = add<FQ>(a, a);
  const Fe a4 = add<FQ>(a2, a2);
  return add<FQ>(add<FQ>(a4, a4), a);
}

// Complete mixed addition P + (x2 : y2 : 1), Renes-Costello-Batina 2016
// alg. 8 (a = 0, b3 = 9): 11 Montgomery products and the two by b3 as
// additions, no Z operand for the second point. Complete for any P,
// doubling and inverses included, for a second point that is not infinity
// (which has no Z = 1 form: the caller skips it). STEP as in padd.
template <int STEP = 2>
SPT_HD Point madd(const Point& p, const Fe& x2, const Fe& y2) {
  const Fe t0 = mont_mul<FQ, STEP>(p.x, x2);
  const Fe t1 = mont_mul<FQ, STEP>(p.y, y2);
  const Fe m3 = mont_mul<FQ, STEP>(add<FQ>(x2, y2), add<FQ>(p.x, p.y));
  const Fe m4 = mont_mul<FQ, STEP>(y2, p.z);
  const Fe m5 = mont_mul<FQ, STEP>(x2, p.z);
  const Fe t3 = sub<FQ>(m3, add<FQ>(t0, t1));         // X1 Y2 + X2 Y1
  const Fe t4 = add<FQ>(m4, p.y);                     // Y2 Z1 + Y1
  const Fe y3 = times_b3(add<FQ>(m5, p.x));           // b3 (X2 Z1 + X1)
  const Fe t0_3 = add<FQ>(add<FQ>(t0, t0), t0);
  const Fe t2 = times_b3(p.z);
  const Fe z3 = add<FQ>(t1, t2);
  const Fe t1m = sub<FQ>(t1, t2);
  Point r;
  r.x = sub<FQ>(mont_mul<FQ, STEP>(t3, t1m), mont_mul<FQ, STEP>(t4, y3));
  r.y = add<FQ>(mont_mul<FQ, STEP>(t1m, z3), mont_mul<FQ, STEP>(y3, t0_3));
  r.z = add<FQ>(mont_mul<FQ, STEP>(z3, t4), mont_mul<FQ, STEP>(t0_3, t3));
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

// A point row is 96 bytes at a 16-byte aligned address (torch allocations
// are 256-byte aligned, rows are 96 bytes): the card moves it as six 16-byte
// accesses.
SPT_HD Point load_point(const uint32_t* src) {
  Point r;
#if defined(__CUDA_ARCH__)
  const uint4* q = reinterpret_cast<const uint4*>(src);
  uint32_t* coord[3] = {r.x.v, r.y.v, r.z.v};
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const uint4 v = q[i];
    uint32_t* d = coord[i >> 1] + 4 * (i & 1);
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
#else
  r.x = load_fe(src);
  r.y = load_fe(src + 8);
  r.z = load_fe(src + 16);
#endif
  return r;
}

SPT_HD void store_point(uint32_t* dst, const Point& a) {
#if defined(__CUDA_ARCH__)
  uint4* q = reinterpret_cast<uint4*>(dst);
  const uint32_t* coord[3] = {a.x.v, a.y.v, a.z.v};
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const uint32_t* s = coord[i >> 1] + 4 * (i & 1);
    q[i] = make_uint4(s[0], s[1], s[2], s[3]);
  }
#else
  store_fe(dst, a.x);
  store_fe(dst + 8, a.y);
  store_fe(dst + 16, a.z);
#endif
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
              padd<8>(load_point(p + 24 * i), load_point(q + 24 * i)));
}

// K3: out[i] = a[i] * b[i % nb] (Montgomery), field F.
template <int F>
SPT_HD void mont_mul_one(long i, const uint32_t* a, const uint32_t* b,
                         long nb, uint32_t* out) {
  store_fe(out + 8 * i,
           mont_mul<F>(load_fe(a + 8 * i), load_fe(b + 8 * (i % nb))));
}

}  // namespace spt
