// BN254 Montgomery arithmetic and the complete projective G1 addition,
// shared by the port's four CUDA kernels (msm_kernels.cu, field_kernels.cu).
//
// Everything here is __host__ __device__: the same per-element bodies the
// kernels launch can be compiled by a host C++ compiler and checked against
// the Python oracle without a GPU.
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

template <int F> SPT_HD Fe add(const Fe& a, const Fe& b) {
  Fe s;
  uint64_t carry = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t cur = (uint64_t)a.v[i] + b.v[i] + carry;
    s.v[i] = (uint32_t)cur;
    carry = cur >> 32;
  }
  return cond_sub_p<F>(s);  // a + b < 2p < 2^255: no carry out
}

template <int F> SPT_HD Fe sub(const Fe& a, const Fe& b) {
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
}

// CIOS Montgomery product a * b * 2^-256 mod p: 8 rounds, each one row of
// 32x32->64 products of a by b[i] and one row of m*p.
template <int F> SPT_HD Fe mont_mul(const Fe& a, const Fe& b) {
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

// ---------------------------------------------------------------------------
// per-thread bodies of the kernels
// ---------------------------------------------------------------------------

// K2: out[i] = p[i] + q[i].
SPT_HD void padd_one(long i, const uint32_t* p, const uint32_t* q,
                     uint32_t* out) {
  store_point(out + 24 * i,
              padd(load_point(p + 24 * i), load_point(q + 24 * i)));
}

// K1, pass 1: walk the sorted entries of chunk c (at most L of one bucket)
// and complete-add each point, negated where the entry's top bit says so,
// into a partial sum that starts at infinity. entry = point index | sign<<31.
SPT_HD void bucket_chunk_one(long c, const uint32_t* pts,
                             const int32_t* entries,
                             const int64_t* chunk_start,
                             const int32_t* chunk_len, uint32_t* partials) {
  Point acc = infinity();
  const long s = chunk_start[c];
  const int len = chunk_len[c];
  for (int k = 0; k < len; ++k) {
    const int32_t e = entries[s + k];
    const long idx = (long)(e & 0x7fffffff);
    Point pt = load_point(pts + 24 * idx);
    if (e < 0) pt.y = sub<FQ>(zero<FQ>(), pt.y);
    acc = padd(acc, pt);
  }
  store_point(partials + 24 * c, acc);
}

// K3: out[i] = a[i] * b[i % nb] (Montgomery), field F.
template <int F>
SPT_HD void mont_mul_one(long i, const uint32_t* a, const uint32_t* b,
                         long nb, uint32_t* out) {
  store_fe(out + 8 * i,
           mont_mul<F>(load_fe(a + 8 * i), load_fe(b + 8 * (i % nb))));
}

// K4: one radix-2 decimation-in-time butterfly of one stage over Fr.
// t indexes [batch, n/2]; the stage pairs rows j and j + half inside each
// block of 2*half rows and twists the upper one by tw[j * tw_stride].
SPT_HD void ntt_butterfly_one(long t, uint32_t* a, const uint32_t* tw,
                              long n, long half, long tw_stride) {
  const long nh = n >> 1;
  const long b = t / nh, r = t % nh;
  const long g = r / half, j = r % half;
  const long i0 = b * n + g * 2 * half + j, i1 = i0 + half;
  const Fe u = load_fe(a + 8 * i0);
  const Fe v = mont_mul<FR>(load_fe(a + 8 * i1), load_fe(tw + 8 * (j * tw_stride)));
  store_fe(a + 8 * i0, add<FR>(u, v));
  store_fe(a + 8 * i1, sub<FR>(u, v));
}

}  // namespace spt
