// K7: the Montgomery product over BN254's Fr or Fq with its two
// constant-operand products on the int8 tensor cores (the port of
// spectre_tpu/ops/field_mxu.py `mont_mul`, XLA code in the JAX package: no
// Pallas kernel). Plain version: ops/field_mxu.py `mont_mul_mxu_plain`.
//
// One product a * b * 2^-256 mod p over 8-bit limbs (separated operand
// scanning, the reference's form):
//   t = a * b                 512 bits; on the integer units (no shared
//                             operand): 64 32 x 32 -> 64-bit products a lane
//   m = t_lo * p' mod 2^256   [32 elements, 32 bytes] x Toeplitz(p') [32, 32]
//   u = (t + m * p) / 2^256   [32 elements, 32 bytes] x Toeplitz(p)  [32, 64]
// then one conditional subtract (u < 2p). The two Toeplitz products are
// mma.sync.m16n8k32 u8 x u8 -> s32 (16 elements an m-tile; a column sums
// at most 32 products below 2^16, so s32 is exact), their constant B
// fragments built once a thread. A warp takes 32 elements, a lane's t
// staged through shared memory into the A fragments and the columns back
// to the lane that carries them (column sums into 32-bit words by 64-bit
// adds).
//
// Bound on the H100: memory (96 bytes an element: two operands read, one
// written); 24 tensor-core products a 32 elements are far below the
// tensor cores' rate, and t = a * b is 64 wide products against K3's 257
// multiply-adds. The second operand is read at i % nb, as K3's.
//
// Plain C interface, loaded with ctypes by spectre_tpu_torch/ops/kernel_lib.py;
// the launcher enqueues on the stream it is given and returns
// cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

#include "bn254.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTStride = 9;    // words a staged row of t_lo or m (odd: rows spread over banks)
constexpr int kCStride = 65;   // words a staged row of columns
constexpr int kBlocksPerSm = 6;

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
// (0 <= c - i < 32, else 0): rows (K) tq * 4 + q + 16 h, column (N)
// nt * 8 + g, four bytes packed low to high.
template <int F>
__device__ __forceinline__ uint32_t toeplitz_frag(int which, int nt, int h, int g, int tq) {
  uint32_t word = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int d = nt * 8 + g - (h * 16 + tq * 4 + q);
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

// The A fragment of m-tile mt from 32 staged rows of 8 words (byte k of a
// row is its K index k): rows mt * 16 + g and + 8, words tq and 4 + tq.
__device__ __forceinline__ void a_frag(uint32_t a[4], const uint32_t* T, int mt, int g,
                                       int tq) {
  const int r = mt * 16 + g;
  a[0] = T[r * kTStride + tq];
  a[1] = T[(r + 8) * kTStride + tq];
  a[2] = T[r * kTStride + 4 + tq];
  a[3] = T[(r + 8) * kTStride + 4 + tq];
}

// An accumulator fragment into the staged columns: rows (elements)
// mt * 16 + g and + 8, columns nt * 8 + tq * 2 and + 1.
__device__ __forceinline__ void c_store(int32_t* C, const int32_t d[4], int mt, int nt, int g,
                                        int tq) {
  const int r = mt * 16 + g, c = nt * 8 + tq * 2;
  C[r * kCStride + c] = d[0];
  C[r * kCStride + c + 1] = d[1];
  C[(r + 8) * kCStride + c] = d[2];
  C[(r + 8) * kCStride + c + 1] = d[3];
}

// Word q of a row of byte columns: sum_b col[4 q + b] 2^(8 b), 64-bit
// (a column is below 2^21).
__device__ __forceinline__ uint64_t col_word(const int32_t* row, int q) {
  uint64_t s = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) s += (uint64_t)(uint32_t)row[4 * q + b] << (8 * b);
  return s;
}

template <int F>
__global__ void __launch_bounds__(kThreads)
    mont_mul_mxu_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                        long nb, uint32_t* __restrict__ out, long n) {
  __shared__ uint32_t st[kWarps][32 * kTStride];
  __shared__ int32_t sc[kWarps][32 * kCStride];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  uint32_t* T = st[warp];
  int32_t* C = sc[warp];

  uint32_t bm[4][2], bp[8][2];   // Toeplitz fragments of p' (32 columns) and p (64)
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) bm[nt][h] = toeplitz_frag<F>(0, nt, h, g, tq);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) bp[nt][h] = toeplitz_frag<F>(1, nt, h, g, tq);

  const long stride = (long)gridDim.x * kWarps * 32;
  for (long base = ((long)blockIdx.x * kWarps + warp) * 32; base < n; base += stride) {
    const long e = base + lane;
    const bool live = e < n;
    // t = a * b, 16 words: row i adds a * b[i] at word i
    uint32_t t[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) t[i] = 0;
    if (live) {
      const spt::Fe x = spt::load_fe(a + 8 * e), y = spt::load_fe(b + 8 * (e % nb));
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        uint64_t c = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          c += (uint64_t)x.v[j] * y.v[i] + t[i + j];
          t[i + j] = (uint32_t)c;
          c >>= 32;
        }
        t[i + 8] = (uint32_t)c;
      }
    }
#pragma unroll
    for (int w = 0; w < 8; ++w) T[lane * kTStride + w] = t[w];
    __syncwarp();

    // m's columns: t_lo times the Toeplitz of p', then carried by the lane
    // that owns the element (mod 2^256)
    {
      int32_t acc[2][4][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        uint32_t af[4];
        a_frag(af, T, mt, g, tq);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0;
          mma_u8(acc[mt][nt], af, bm[nt][0], bm[nt][1]);
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) c_store(C, acc[mt][nt], mt, nt, g, tq);
    }
    __syncwarp();
    uint32_t m[8];
    {
      uint64_t c = 0;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        c += col_word(C + lane * kCStride, q);
        m[q] = (uint32_t)c;
        c >>= 32;
      }
    }
    __syncwarp();
#pragma unroll
    for (int w = 0; w < 8; ++w) T[lane * kTStride + w] = m[w];
    __syncwarp();

    // m p's 64 columns
    {
      int32_t acc[2][8][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        uint32_t af[4];
        a_frag(af, T, mt, g, tq);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0;
          mma_u8(acc[mt][nt], af, bp[nt][0], bp[nt][1]);
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) c_store(C, acc[mt][nt], mt, nt, g, tq);
    }
    __syncwarp();

    // u = (t + m p) / 2^256: the low 8 words are 0 mod 2^256, only their
    // carry reaches the high half
    spt::Fe u;
    {
      uint64_t c = 0;
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        c += (uint64_t)t[q] + col_word(C + lane * kCStride, q);
        if (q >= 8) u.v[q - 8] = (uint32_t)c;
        c >>= 32;
      }
    }
    __syncwarp();   // the next round stages over T and C
    if (live) spt::store_fe(out + 8 * e, spt::cond_sub_p<F>(u));
  }
}

}  // namespace

extern "C" int spt_mont_mul_mxu(const void* a, const void* b, long nb, void* out, long n,
                                int field, void* stream) {
  if (n > 0) {
    static int sms = 0;   // the card's SMs, read once
    if (sms == 0) {
      int dev = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    const long want = (n + kThreads - 1) / kThreads;
    const long cap = (long)sms * kBlocksPerSm;
    const unsigned blocks = (unsigned)(want < cap ? want : cap);
    cudaStream_t s = (cudaStream_t)stream;
    if (field == spt::FQ)
      mont_mul_mxu_kernel<spt::FQ><<<blocks, kThreads, 0, s>>>(
          (const uint32_t*)a, (const uint32_t*)b, nb, (uint32_t*)out, n);
    else
      mont_mul_mxu_kernel<spt::FR><<<blocks, kThreads, 0, s>>>(
          (const uint32_t*)a, (const uint32_t*)b, nb, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}
