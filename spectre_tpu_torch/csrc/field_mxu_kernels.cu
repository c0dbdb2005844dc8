// K7: the Montgomery product over BN254's Fr or Fq with its two
// constant-operand products on the int8 tensor cores (the port of
// spectre_tpu/ops/field_mxu.py `mont_mul`, XLA code in the JAX package: no
// Pallas kernel). Plain version: ops/field_mxu.py `mont_mul_mxu_plain`.
//
// One product a * b * 2^-256 mod p over 8-bit limbs (separated operand
// scanning, the reference's form):
//   t = a * b                 512 bits; on the integer units (no shared
//                             operand): 64 32 x 32 -> 64-bit products a lane
//   m = t_lo * p' mod 2^256   [16 elements, 32 bytes] x Toeplitz(p') [32, 32]
//   u = (t + m * p) / 2^256   [16 elements, 32 bytes] x Toeplitz(p)  [32, 64]
// then one conditional subtract (u < 2p). The two Toeplitz products are
// mma.sync.m16n8k32 u8 x u8 -> s32 (a column sums at most 32 products below
// 2^16, so s32 is exact), their constant B fragments built once a thread.
//
// Everything stays in registers. A warp takes 32 elements, two m-tiles; the
// quad of lanes with group g holds rows g and g + 8 of both, four elements,
// and lane tq of the quad owns one of them (slot tq: m-tile tq / 2, row g +
// 8 (tq & 1)): it loads a and b with 16-byte loads, computes t and, at the
// end, subtracts and stores u. In between each lane holds words tq + 4 k of
// all four: the A fragment of m16n8k32 is words tq and 4 + tq of its rows,
// and the Toeplitz matrices' columns are ordered so that a lane's
// accumulators are the four bytes of whole words tq + 4 k (column n of
// n-tile nt is byte 2 (nt & 1) + (n & 1) of word n / 2 + 4 (nt / 2)). t goes
// to that layout and u comes back by a quad transpose (two shuffle stages);
// a number's carries cross the quad by one shuffle a word a round (a
// second round only for a run of all-ones words), so the m words
// land where the second product's A fragment needs them; the low half of t
// + m p is 0 by construction, so only word 7's carry out is computed. The loads of a
// lane's next element are issued before the current one's products.
//
// Bound on the H100: memory (96 bytes an element: two operands read, one
// written); 24 tensor-core products a 32 elements are far below the tensor
// cores' rate, and t = a * b is 64 wide products against K3's 257
// multiply-adds. The second operand is read at i % nb, as K3's.
//
// Plain C interface, loaded with ctypes by spectre_tpu_torch/ops/kernel_lib.py;
// the launcher enqueues on the stream it is given and returns
// cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

#include "bn254.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

// p' = -p^-1 mod 2^256, 8 little-endian words
template <int F> __device__ __forceinline__ uint32_t pinv_word(int i) {
  constexpr uint32_t fq[8] = {0xe4866389u, 0x87d20782u, 0x1eca6ac9u, 0x9ede7d65u,
                              0x1833da80u, 0xd8afcbd0u, 0x91888c6bu, 0xf57a22b7u};
  constexpr uint32_t fr[8] = {0xefffffffu, 0xc2e1f593u, 0x4c6911b3u, 0x6586864bu,
                              0x99062391u, 0xe39a9828u, 0x0d8341b2u, 0x73f82f1du};
  return F == spt::FQ ? fq[i] : fr[i];
}

// byte d (0..31) of p' (which = 0) or of p (which = 1)
template <int F> __device__ __forceinline__ uint32_t const_byte(int which, int d) {
  const uint32_t w = which ? spt::Consts<F>::p(d >> 2) : pinv_word<F>(d >> 2);
  return (w >> (8 * (d & 3))) & 0xFFu;
}

// The B fragment of n-tile nt of a Toeplitz matrix B[i][c] = v[c - i]
// (0 <= c - i < 32, else 0): rows (K) tq * 4 + q + 16 h, column (N) g, which
// is column c = 4 (g / 2 + 4 (nt / 2)) + 2 (nt & 1) + (g & 1) of the product;
// four bytes packed low to high.
template <int F>
__device__ __forceinline__ uint32_t toeplitz_frag(int which, int nt, int h, int g, int tq) {
  const int c = 4 * ((g >> 1) + 4 * (nt >> 1)) + 2 * (nt & 1) + (g & 1);
  uint32_t word = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int d = c - (h * 16 + tq * 4 + q);
    if (d >= 0 && d < 32) word |= const_byte<F>(which, d) << (8 * q);
  }
  return word;
}

__device__ __forceinline__ void mma_u8(int32_t d[4], const uint32_t a[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Lane tq of each quad holds row tq, x[0..3]; after, x[s] is row s's x[tq]
// (two butterfly stages of one shuffle pair each).
__device__ __forceinline__ void quad_transpose(uint32_t x[4], int tq) {
  const bool hi = tq & 2, odd = tq & 1;
  uint32_t r0 = __shfl_xor_sync(kFull, hi ? x[0] : x[2], 2);
  uint32_t r1 = __shfl_xor_sync(kFull, hi ? x[1] : x[3], 2);
  if (hi) {
    x[0] = r0;
    x[1] = r1;
  } else {
    x[2] = r0;
    x[3] = r1;
  }
  r0 = __shfl_xor_sync(kFull, odd ? x[0] : x[1], 1);
  r1 = __shfl_xor_sync(kFull, odd ? x[2] : x[3], 1);
  if (odd) {
    x[0] = r0;
    x[2] = r1;
  } else {
    x[1] = r0;
    x[3] = r1;
  }
}

// A number spread over a quad, word tq + 4 k (k < K) in lane tq as a column
// sum v[k] < 2^63, plus lane 3's `below` into word 0: its words mod
// 2^(128 K). Each round adds every word's carry (its high half) into the
// next word, in the next lane (one shuffle a word); the rounds end when no
// lane of the warp holds a carry: after the first for all but runs of
// all-ones words (the carry past the top word is dropped).
template <int K>
__device__ __forceinline__ void quad_carry(const uint64_t v[K], uint32_t out[K], int lane,
                                           uint32_t below) {
  const int tq = lane & 3;
  const int src = (lane & ~3) | ((tq + 3) & 3);
  uint32_t c[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    out[k] = (uint32_t)v[k];
    c[k] = (uint32_t)(v[k] >> 32);
  }
  uint32_t first = __shfl_sync(kFull, below, src);
  bool left = true;
  while (left) {
    // word tq + 4 k takes the carry of word tq - 1 + 4 k: lane tq - 1's
    // k-th, or for tq = 0 lane 3's (k - 1)-th
    uint32_t prev = first, any = 0;
    first = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const uint32_t x = __shfl_sync(kFull, c[k], src);
      const uint64_t s = (uint64_t)out[k] + (tq ? x : prev);
      prev = x;
      out[k] = (uint32_t)s;
      c[k] = (uint32_t)(s >> 32);
      any |= (tq == 3 && k == K - 1) ? 0u : c[k];
    }
    left = __any_sync(kFull, any != 0);
  }
}

// The word sums of a lane's accumulators for one row (hh): word tq + 4 k
// from n-tiles 2 k (bytes 0, 1) and 2 k + 1 (bytes 2, 3).
template <int K>
__device__ __forceinline__ void row_words(const int32_t acc[][4], int hh, uint64_t v[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    uint64_t s = 0;
#pragma unroll
    for (int nt = 2 * k; nt < 2 * k + 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        s += (uint64_t)(uint32_t)acc[nt][2 * hh + e] << (8 * (2 * (nt & 1) + e));
    v[k] = s;
  }
}

template <int F>
__global__ void __launch_bounds__(kThreads)
    mont_mul_mxu_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                        long nb, uint32_t* __restrict__ out, long n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;

  uint32_t bm[4][2], bp[8][2];   // Toeplitz fragments of p' (32 columns) and p (64)
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) bm[nt][h] = toeplitz_frag<F>(0, nt, h, g, tq);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) bp[nt][h] = toeplitz_frag<F>(1, nt, h, g, tq);

  // this lane's element of each group of 32: slot tq of quad g
  const int own = 16 * (tq >> 1) + g + 8 * (tq & 1);
  const long stride = (long)gridDim.x * kWarps * 32;
  long base = ((long)blockIdx.x * kWarps + warp) * 32;
  long eb = (base + own) % nb;          // b's row, advanced by stride mod nb
  const long eb_step = stride % nb;
  const uint4 zero4 = make_uint4(0, 0, 0, 0);
  uint4 na0 = zero4, na1 = zero4, nb0 = zero4, nb1 = zero4;   // the next element's operands
  if (base + own < n) {
    const uint4* pa = reinterpret_cast<const uint4*>(a + 8 * (base + own));
    const uint4* pb = reinterpret_cast<const uint4*>(b + 8 * eb);
    na0 = pa[0], na1 = pa[1], nb0 = pb[0], nb1 = pb[1];
  }
  for (; base < n; base += stride) {
    const long e = base + own;
    const uint32_t x[8] = {na0.x, na0.y, na0.z, na0.w, na1.x, na1.y, na1.z, na1.w};
    const uint32_t y[8] = {nb0.x, nb0.y, nb0.z, nb0.w, nb1.x, nb1.y, nb1.z, nb1.w};
    eb += eb_step;
    if (eb >= nb) eb -= nb;
    if (e + stride < n) {
      const uint4* pa = reinterpret_cast<const uint4*>(a + 8 * (e + stride));
      const uint4* pb = reinterpret_cast<const uint4*>(b + 8 * eb);
      na0 = pa[0], na1 = pa[1], nb0 = pb[0], nb1 = pb[1];
    }
    // t = a * b, 16 words: row i adds a * b[i] at word i (zero past n)
    uint32_t t[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) t[i] = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      uint64_t c = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c += (uint64_t)x[j] * y[i] + t[i + j];
        t[i + j] = (uint32_t)c;
        c >>= 32;
      }
      t[i + 8] = (uint32_t)c;
    }

    // tt[k][s]: word tq + 4 k of slot s's t
    uint32_t tt[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int j = 0; j < 4; ++j) tt[k][j] = t[4 * k + j];
      quad_transpose(tt[k], tq);
    }

    // m = t_lo p' mod 2^256: words tq and 4 + tq of each slot
    uint32_t m[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const uint32_t af[4] = {tt[0][2 * mt], tt[0][2 * mt + 1], tt[1][2 * mt], tt[1][2 * mt + 1]};
      int32_t acc[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0;
        mma_u8(acc[nt], af, bm[nt][0], bm[nt][1]);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        uint64_t v[2];
        uint32_t w[2];
        row_words<2>(acc, hh, v);
        quad_carry<2>(v, w, lane, 0);
        m[0][2 * mt + hh] = w[0];
        m[1][2 * mt + hh] = w[1];
      }
    }

    // u = (t + m p) / 2^256: words 8 + tq and 12 + tq of t + m p
    uint32_t u[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const uint32_t af[4] = {m[0][2 * mt], m[0][2 * mt + 1], m[1][2 * mt], m[1][2 * mt + 1]};
      int32_t acc[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0;
        mma_u8(acc[nt], af, bp[nt][0], bp[nt][1]);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int s = 2 * mt + hh;
        uint64_t v[4];
        uint32_t w[2];
        row_words<4>(acc, hh, v);
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] += tt[k][s];
        // the low 8 words of t + m p end as 0: word 7 (lane 3's v[1]) takes
        // in whatever makes it 0 mod 2^32, so its carry out is its high
        // half plus one unless its low half is 0; no carry of the low words
        // needs propagating
        const uint32_t below = tq == 3 ? (uint32_t)(v[1] >> 32) + ((uint32_t)v[1] != 0u) : 0u;
        const uint64_t vh[2] = {v[2], v[3]};
        quad_carry<2>(vh, w, lane, below);
        u[0][s] = w[0];
        u[1][s] = w[1];
      }
    }

    // back to the owner: words 4 k + j of its own slot
    quad_transpose(u[0], tq);
    quad_transpose(u[1], tq);
    if (e < n) {
      spt::Fe r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        r.v[j] = u[0][j];
        r.v[4 + j] = u[1][j];
      }
      r = spt::cond_sub_p<F>(r);
      uint4* po = reinterpret_cast<uint4*>(out + 8 * e);
      po[0] = make_uint4(r.v[0], r.v[1], r.v[2], r.v[3]);
      po[1] = make_uint4(r.v[4], r.v[5], r.v[6], r.v[7]);
    }
  }
}

template <int F>
int launch(const void* a, const void* b, long nb, void* out, long n, cudaStream_t s) {
  static int blocks_per_sm = 0, sms = 0;   // read once a field
  if (blocks_per_sm == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm, mont_mul_mxu_kernel<F>,
                                                  kThreads, 0);
    if (blocks_per_sm < 1) blocks_per_sm = 1;
  }
  const long want = (n + kThreads - 1) / kThreads;
  const long cap = (long)sms * blocks_per_sm;
  const unsigned blocks = (unsigned)(want < cap ? want : cap);
  mont_mul_mxu_kernel<F><<<blocks, kThreads, 0, s>>>(
      (const uint32_t*)a, (const uint32_t*)b, nb, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int spt_mont_mul_mxu(const void* a, const void* b, long nb, void* out, long n,
                                int field, void* stream) {
  if (n > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    return field == spt::FQ ? launch<spt::FQ>(a, b, nb, out, n, s)
                            : launch<spt::FR>(a, b, nb, out, n, s);
  }
  return (int)cudaGetLastError();
}
