// K8: the four-step NTT's short transforms as DFT matrix products on the
// int8 tensor cores (the port of spectre_tpu/ops/ntt.py `_ntt_dft_matmul`,
// XLA code in the JAX package: no Pallas kernel). Plain version:
// ops/ntt.py `dft_matmul_plain`.
//
// For each row r of R rows of n points (Montgomery, canonical) and each
// output point k:
//   G[k, i1, i2] = sum_j W8[j, (k, i1)] x8[r, j, i2]         u8 GEMM, s32
//   T[k]         = sum_{i1, i2} G[k, i1, i2] 2^(8 (i1 + i2)) < n p^2
//   out[r, k]    = T[k] 2^-272 mod p                        one REDC
// with W8[j, (k, i1)] byte i1 of omega^(jk) 2^272 mod p (`_dft_matrix8`,
// [n, 32 n]), so out[r, k] = sum_j omega^(jk) x[r, j], Montgomery and
// canonical (u < n p^2 / 2^272 + p < 2p for n <= 4096).
//
// The GEMM is M = 32 n (point k, limb i1), N = 32 R (row r, limb i2),
// K = n (point j): a block takes 4 points x 4 rows (128 x 128) and walks
// K in stages of 64, each operand staged into shared memory transposed
// so that K is contiguous (a thread loads 4 x 4 bytes, moves them with
// byte permutes), 80-byte rows (no bank conflicts on the fragment
// loads). Its 8 warps each own one point and two rows (2 x 8 tiles of
// mma.sync.m16n8k32 u8 x u8 -> s32, exact: a sum is below n 255^2 < 2^31).
// The GEMM's output is never written: each warp folds a (point, row)
// block of 32 x 32 products in shared memory into its 63 columns (64-bit:
// a column is below 32 n 255^2 < 2^34), the columns into 16 words by a
// quad shuffle, and 16 threads of the block reduce the 16 (point, row)
// outputs at 2^272 (eight 32-bit steps and one 16-bit step) and subtract
// p once.
//
// Bound on the H100: the tensor cores' u8 rate (32 x 32 x n multiply-adds
// an output point against 64 bytes). The design's simplicity costs: each
// x byte is read n / 4 times and each W8 byte R / 4 times (from L2 at the
// committee's n = 1024), and the fragments come from shared memory with
// 32-bit loads.
//
// Plain C interface, loaded with ctypes by spectre_tpu_torch/ops/kernel_lib.py;
// the launcher enqueues on the stream it is given and returns
// cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

#include "bn254.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 64;              // points j a stage
constexpr int kRowBytes = kBK + 16;  // a staged row of 64 bytes and 16 of padding
constexpr int kTile = 128;           // staged rows of an operand: 4 x 32 limbs
constexpr int kGStride = 33;         // words a row of a warp's 32 x 32 product block

struct Smem {
  union {
    struct {
      uint8_t a[kTile * kRowBytes];   // W8: rows (point, i1), bytes j
      uint8_t b[kTile * kRowBytes];   // x8: rows (row, i2), bytes j
    } ops;
    int32_t g[8][32 * kGStride];      // a warp's (point, row) block of products
  } u;
  unsigned long long s[16][16];       // each (point, row) output's 16 words
};

// Stage one operand: 4 sub-tiles of kBK x 32 bytes, byte (kk, i) of
// sub-tile s at src + s * sstride + kk * kstride + i (zero where
// s >= svalid or kk >= kvalid), to dst row s * 32 + i, byte kk.
__device__ __forceinline__ void stage(uint8_t* dst, const uint8_t* __restrict__ src,
                                      long sstride, long kstride, int svalid, int kvalid) {
  for (int unit = threadIdx.x; unit < 4 * (kBK / 4) * 8; unit += kThreads) {
    const int w = unit & 7, jg = (unit >> 3) & (kBK / 4 - 1), s = unit >> 7;
    uint32_t v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int kk = jg * 4 + q;
      v[q] = (s < svalid && kk < kvalid)
                 ? *reinterpret_cast<const uint32_t*>(src + s * sstride + kk * kstride + 4 * w)
                 : 0u;
    }
    // 4 x 4 byte transpose: o[b] holds byte b of v[0..3], low to high
    const uint32_t t0 = __byte_perm(v[0], v[1], 0x5140), t1 = __byte_perm(v[2], v[3], 0x5140);
    const uint32_t t2 = __byte_perm(v[0], v[1], 0x7362), t3 = __byte_perm(v[2], v[3], 0x7362);
    const uint32_t o[4] = {__byte_perm(t0, t1, 0x5410), __byte_perm(t0, t1, 0x7632),
                           __byte_perm(t2, t3, 0x5410), __byte_perm(t2, t3, 0x7632)};
#pragma unroll
    for (int b = 0; b < 4; ++b)
      *reinterpret_cast<uint32_t*>(dst + (s * 32 + 4 * w + b) * kRowBytes + 4 * jg) = o[b];
  }
}

__device__ __forceinline__ uint32_t ld32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_u8(int32_t d[4], const uint32_t a[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// T = sum_q s[q] 2^(32 q) (each s[q] < 2^60) reduced: T 2^-272 mod p over Fr,
// canonical, for T < 2^272 p (eight 32-bit REDC steps, then one of 16 bits).
__device__ spt::Fe redc272(const unsigned long long s[16]) {
  uint32_t t[18];
  unsigned long long c = 0;
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    c += s[q];
    t[q] = (uint32_t)c;
    c >>= 32;
  }
  t[16] = (uint32_t)c;
  t[17] = (uint32_t)(c >> 32);
  const uint32_t n0 = spt::Consts<spt::FR>::n0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t m = t[i] * n0;
    unsigned long long cc = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      cc += (unsigned long long)m * spt::Consts<spt::FR>::p(k) + t[i + k];
      t[i + k] = (uint32_t)cc;
      cc >>= 32;
    }
#pragma unroll
    for (int k = i + 8; k < 18; ++k) {
      cc += t[k];
      t[k] = (uint32_t)cc;
      cc >>= 32;
    }
  }
  const uint32_t m16 = (t[8] * n0) & 0xFFFFu;
  unsigned long long cc = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    cc += (unsigned long long)m16 * spt::Consts<spt::FR>::p(k) + t[8 + k];
    t[8 + k] = (uint32_t)cc;
    cc >>= 32;
  }
#pragma unroll
  for (int k = 16; k < 18; ++k) {
    cc += t[k];
    t[k] = (uint32_t)cc;
    cc >>= 32;
  }
  spt::Fe u;
#pragma unroll
  for (int k = 0; k < 8; ++k) u.v[k] = (t[8 + k] >> 16) | (t[9 + k] << 16);
  return spt::cond_sub_p<spt::FR>(u);
}

// grid (ceil(R / 4) row tiles, ceil(n / 4) point tiles)
__global__ void __launch_bounds__(kThreads)
    dft_matmul_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ w8,
                      uint32_t* __restrict__ out, long rows, int logn) {
  __shared__ __align__(16) Smem sm;
  const long n = 1L << logn;
  const long rt = blockIdx.x;
  const long kt = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int p = warp & 3, r0 = (warp >> 2) * 2;   // this warp's point and first row
  const int wvalid = (int)(n - kt * 4 < 4 ? n - kt * 4 : 4);
  const int xvalid = (int)(rows - rt * 4 < 4 ? rows - rt * 4 : 4);

  int32_t acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0;

  for (long k0 = 0; k0 < n; k0 += kBK) {
    const int kvalid = (int)(n - k0 < kBK ? n - k0 : kBK);
    stage(sm.u.ops.a, w8 + k0 * 32 * n + kt * 4 * 32, 32, 32 * n, wvalid, kvalid);
    stage(sm.u.ops.b, x + (rt * 4 * n + k0) * 32, 32 * n, 32, xvalid, kvalid);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const uint8_t* ra = sm.u.ops.a + (p * 32 + mt * 16 + g) * kRowBytes + ks + tq * 4;
        af[mt][0] = ld32(ra);
        af[mt][1] = ld32(ra + 8 * kRowBytes);
        af[mt][2] = ld32(ra + 16);
        af[mt][3] = ld32(ra + 8 * kRowBytes + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const uint8_t* rb = sm.u.ops.b + (r0 * 32 + nt * 8 + g) * kRowBytes + ks + tq * 4;
        const uint32_t b0 = ld32(rb), b1 = ld32(rb + 16);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_u8(acc[mt][nt], af[mt], b0, b1);
      }
    }
    __syncthreads();
  }

  // each of the warp's two (point, row) blocks: the 32 x 32 products into
  // shared memory, lane l sums column l (i1 <= l) and column l + 32, the
  // columns become words 2^(32 q) by a quad sum
  int32_t* gs = sm.u.g[warp];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int32_t* d = acc[mt][h * 4 + nt];
        const int i1 = mt * 16 + g, i2 = nt * 8 + tq * 2;
        gs[i1 * kGStride + i2] = d[0];
        gs[i1 * kGStride + i2 + 1] = d[1];
        gs[(i1 + 8) * kGStride + i2] = d[2];
        gs[(i1 + 8) * kGStride + i2 + 1] = d[3];
      }
    __syncwarp();
    unsigned long long lo = 0, hi = 0;
#pragma unroll 8
    for (int i1 = 0; i1 < 32; ++i1) {
      if (i1 <= lane)
        lo += (uint32_t)gs[i1 * kGStride + lane - i1];
      else
        hi += (uint32_t)gs[i1 * kGStride + lane + 32 - i1];
    }
    __syncwarp();
    lo <<= 8 * (lane & 3);
    hi <<= 8 * (lane & 3);
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      lo += __shfl_xor_sync(0xffffffffu, lo, off);
      hi += __shfl_xor_sync(0xffffffffu, hi, off);
    }
    if ((lane & 3) == 0) {
      sm.s[p * 4 + r0 + h][lane >> 2] = lo;
      sm.s[p * 4 + r0 + h][8 + (lane >> 2)] = hi;
    }
  }
  __syncthreads();
  if (threadIdx.x < 16) {
    const int pp = threadIdx.x >> 2, rr = threadIdx.x & 3;
    if (pp < wvalid && rr < xvalid) {
      const spt::Fe v = redc272(sm.s[threadIdx.x]);
      spt::store_fe(out + ((rt * 4 + rr) * n + kt * 4 + pp) * 8, v);
    }
  }
}

}  // namespace

extern "C" int spt_ntt_dft_matmul(const void* x, const void* w8, void* out, long rows,
                                  int logn, void* stream) {
  const long n = 1L << logn;
  const dim3 grid((unsigned)((rows + 3) / 4), (unsigned)((n + 3) / 4));
  dft_matmul_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)x, (const uint8_t*)w8, (uint32_t*)out, rows, logn);
  return (int)cudaGetLastError();
}
