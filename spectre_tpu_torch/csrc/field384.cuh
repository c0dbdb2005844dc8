// BLS12-381 Fq for K6 (csrc/field384_kernels.cu): Montgomery form with
// R = 2^384 over 12 x 32-bit limbs, little-endian, which is the bit layout of
// the [n, 6] int64 words of spectre_tpu_torch/ops/field384.py (and the value
// of the JAX package's 24 x 16-bit limbs, spectre_tpu/ops/field384.py).
//
// Everything here is __host__ __device__: the per-key body that every K6
// thread runs also builds with a host compiler, and tests/test_torch_field384.py
// runs it on the CPU against the plain PyTorch version and the integer
// oracle. Every operation returns the canonical representative in [0, p), so
// any two correct evaluations of one formula agree limb for limb.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define SPT384_HD __host__ __device__ __forceinline__
#else
#define SPT384_HD inline
#endif

namespace spt384 {

constexpr int L = 12;
// -p^-1 mod 2^32
constexpr uint32_t kN0 = 0xfffcfffdu;
// bits of the square-root exponent (p + 1) / 4 (p = 3 mod 4)
constexpr int kSqrtExpBits = 379;

SPT384_HD uint32_t p(int i) {
  constexpr uint32_t v[L] = {0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu,
                             0xf6b0f624u, 0x6730d2a0u, 0xf38512bfu, 0x64774b84u,
                             0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
  return v[i];
}

// 4 R mod p: the curve's b = 4 in Montgomery form
SPT384_HD uint32_t four(int i) {
  constexpr uint32_t v[L] = {0x000cfff3u, 0xaa270000u, 0xfc34000au, 0x53cc0032u,
                             0x6b0a807fu, 0x478fe97au, 0xe6ba24d7u, 0xb1d37ebeu,
                             0xbf78ab2fu, 0x8ec9733bu, 0x3d83de7eu, 0x09d64551u};
  return v[i];
}

// (p + 1) / 4, read one word at a time by a loop that is not unrolled: from
// constant memory on the card, from a plain array on the host
#define SPT384_SQRT_EXP                                                       \
  {0xffffeaabu, 0xee7fbfffu, 0xac54ffffu, 0x07aaffffu, 0x3dac3d89u, 0xd9cc34a8u, \
   0x3ce144afu, 0xd91dd2e1u, 0x90d2eb35u, 0x92c6e9edu, 0x8e5ff9a6u, 0x0680447au}
#if defined(__CUDACC__)
__constant__ uint32_t kSqrtExpDev[L] = SPT384_SQRT_EXP;
#endif
static const uint32_t kSqrtExpHost[L] = SPT384_SQRT_EXP;

SPT384_HD uint32_t sqrt_exp_word(int w) {
#if defined(__CUDA_ARCH__)
  return kSqrtExpDev[w];
#else
  return kSqrtExpHost[w];
#endif
}

struct Fq {
  uint32_t v[L];
};

// t - p if t >= p else t, for t = t[0..L] < 2p (t[L] the limb above).
SPT384_HD Fq cond_sub_p(const uint32_t t[L + 1]) {
  Fq d, r;
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const uint64_t s = (uint64_t)t[j] - p(j) - borrow;
    d.v[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  const bool keep = borrow && t[L] == 0;
#pragma unroll
  for (int j = 0; j < L; ++j) r.v[j] = keep ? t[j] : d.v[j];
  return r;
}

// Montgomery product a * b * 2^-384 mod p, CIOS in 12 rounds: a round adds
// the row a * b[i] into the running sum t (t[L], t[L + 1] the limbs above),
// then m * p for m = t[0] * n0, which zeroes limb 0, and shifts down one
// limb. Each 32 x 32 -> 64-bit product takes its carry in a 64-bit sum
// (a * b + t + c < 2^64). p < R / 4 keeps t below 2p, so one conditional
// subtraction ends it.
SPT384_HD Fq mont_mul(const Fq& a, const Fq& b) {
  uint32_t t[L + 2];
#pragma unroll
  for (int j = 0; j < L + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      c += (uint64_t)a.v[j] * b.v[i] + t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[L];
    t[L] = (uint32_t)c;
    t[L + 1] = (uint32_t)(c >> 32);
    const uint32_t m = t[0] * kN0;
    c = ((uint64_t)m * p(0) + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < L; ++j) {
      c += (uint64_t)m * p(j) + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[L];
    t[L - 1] = (uint32_t)c;
    t[L] = t[L + 1] + (uint32_t)(c >> 32);
  }
  return cond_sub_p(t);
}

SPT384_HD Fq add(const Fq& a, const Fq& b) {
  uint32_t t[L + 1];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    c += (uint64_t)a.v[j] + b.v[j];
    t[j] = (uint32_t)c;
    c >>= 32;
  }
  t[L] = (uint32_t)c;
  return cond_sub_p(t);
}

SPT384_HD bool equal(const Fq& a, const Fq& b) {
  bool eq = true;
#pragma unroll
  for (int j = 0; j < L; ++j) eq = eq && a.v[j] == b.v[j];
  return eq;
}

SPT384_HD Fq load(const uint32_t* src) {
  Fq a;
#pragma unroll
  for (int j = 0; j < L; ++j) a.v[j] = src[j];
  return a;
}

SPT384_HD void store(uint32_t* dst, const Fq& a) {
#pragma unroll
  for (int j = 0; j < L; ++j) dst[j] = a.v[j];
}

// One key: x (Montgomery) -> y = (x^3 + 4)^((p + 1) / 4), written to y[i];
// returns whether y^2 = x^3 + 4, i.e. whether x is on the curve. The pow
// runs left to right over the fixed exponent: 378 squarings and 228
// products, the same for every key, so a warp never diverges.
SPT384_HD int decompress_one(long i, const uint32_t* x, uint32_t* y) {
  const Fq xm = load(x + (long)L * i);
  Fq b;
#pragma unroll
  for (int j = 0; j < L; ++j) b.v[j] = four(j);
  const Fq rhs = add(mont_mul(mont_mul(xm, xm), xm), b);
  Fq r = rhs;  // the exponent's top bit
#pragma unroll 1
  for (int bit = kSqrtExpBits - 2; bit >= 0; --bit) {
    r = mont_mul(r, r);
    if ((sqrt_exp_word(bit >> 5) >> (bit & 31)) & 1u) r = mont_mul(r, rhs);
  }
  store(y + (long)L * i, r);
  return equal(mont_mul(r, r), rhs) ? 1 : 0;
}

}  // namespace spt384
