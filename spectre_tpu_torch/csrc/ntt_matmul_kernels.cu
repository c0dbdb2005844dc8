// K8: the four-step NTT's short transforms on the int8 tensor cores (the
// port of spectre_tpu/ops/ntt.py `_ntt_dft_matmul`, XLA code in the JAX
// package: no Pallas kernel). Plain versions: ops/ntt.py `dft_matmul_plain`
// (the reference's dense DFT) and `dft_factored_plain` (this kernel's steps,
// from the same tables).
//
// The algorithm differs from the reference's, the bytes do not. The
// reference contracts each row of n points with the dense n x n DFT matrix
// (O(n^2) products). Here a length-n leg is factored, n = n1 n2 with n1, n2
// <= 64 (lengths up to 64 stay one direct DFT), into two launches of this
// kernel over the rows (ops/ntt.py `dft_plan`):
//   pass A: for each j1 < n1, the n2-point DFT over j2 of x[j1 + n1 j2]
//           (root omega^n1), each output times omega^(j1 k2), written back
//           to the slots it came from;
//   pass B: for each k2 < n2, the n1-point DFT over j1 of those n1
//           contiguous values (root omega^n2), written to out[n2 k1 + k2].
// Each short DFT of L points is, for each output point k and each of the
// 64 byte columns c of the 520-bit sum,
//   col[k, c] = sum_j sum_i1 W8[j, k, i1] x8[j, c - i1]     (u8 x u8, s32)
//   T[k]      = sum_c col[k, c] 2^(8 c) < L p^2 < 2^272 p
//   out[k]    = T[k] 2^-272 mod p                          (one REDC, one
//                                                          conditional subtract)
// with W8[j, k] the bytes of omega_L^(jk) 2^272 mod p (Montgomery times
// 2^16), so out[k] = sum_j omega_L^(jk) x_j in Montgomery form, canonical.
// The GEMM is D[k, (vector, c)] = sum_(j, i1) A[k, (j, i1)] B[(j, i1), (vector, c)]
// on mma.sync u8: A is the DFT matrix, built on the host in the fragment
// order (`dft_fragments`: a lane's 16 bytes of a k-step are one 16-byte
// shared-memory load, the i1 axis reversed within each word), and B is the
// Toeplitz expansion of the data bytes, made in registers from 6
// shared-memory words a k-step (funnel shifts: the column order puts the
// byte offset of every B word at a shift the lane knows). The Toeplitz form
// does more products than the limb-pair form, but the column sums come out
// of the tensor cores: each lane holds whole 32-bit words of its rows' sums
// (column n of n-tile (w, b) is c = 4 (4 w + n / 2) + 2 b + (n & 1): lane
// tq holds words tq + 4 w), so the epilogue stages 16 words a row in shared
// memory and each lane reduces one output point. Columns below 16 meet only
// the low 16 bytes of W and columns from 48 only the high 16: their n-tiles
// take m16n8k16 products, the others m16n8k32, 1.5 x the limb pairs'
// products in all. The twiddle of pass A is a Montgomery product on the
// integer units (bn254.cuh) in the same epilogue.
//
// A block holds the DFT matrix of its length in shared memory (L^2 / 16
// x 512 bytes: 128 KiB at L = 64) and its 16 warps (8 at L = 64) walk the
// vectors (a row's n / L short transforms, rows after rows) with a grid
// stride; a warp streams its next vector in by cp.async while it computes
// the current one, and moves its outputs and twiddles 16 bytes at a time
// (faster than 4-byte accesses: scripts/torch_kernel_variants.py).
//
// Bound on the H100: at n = 2^10 the tensor cores' u8 rate (48 x 32 L
// products a point and pass) against 4 x 32 bytes a point (each pass reads
// and writes its rows); the REDCs and the twiddle product are ~400 32-bit
// multiply-adds a point.
//
// Plain C interface, loaded with ctypes by spectre_tpu_torch/ops/kernel_lib.py;
// the launcher enqueues on the stream it is given and returns
// cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

#include "bn254.cuh"

namespace {

// warps a block: 16 share a DFT matrix of up to 32 points; the matrix of
// 64 (128 KiB) leaves shared memory for 8
template <int LOGL> constexpr int kWarpsOf = LOGL >= 6 ? 8 : 16;
constexpr int kEStride = 18;   // 64-bit words a staged row of the epilogue (16, 16-byte aligned)
constexpr int kE4 = 32 * kEStride / 2;   // the epilogue's 32 rows in 16-byte units

struct PassArgs {
  const uint8_t* x;        // [rows, n] points of 32 bytes
  uint32_t* out;           // [rows, n] points
  const uint4* frag;       // the DFT matrix in fragment order
  const uint32_t* tw;      // [n] omega^(u k) at u L + k (Montgomery), or null
  long nvec;               // rows * (n / L) short transforms
  int logn, logu;          // log2 n, log2 (n / L)
  long bu_in, s_in;        // point j of vector u of row r at r n + u bu_in + j s_in
  long bu_out, s_out;      // output k at r n + u bu_out + k s_out
};

__device__ __forceinline__ void mma_u8(int32_t d[4], const uint32_t a[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the half-depth form: K = 16 bytes, A rows g and g + 8 (a0, a1), B one word
__device__ __forceinline__ void mma_u8_k16(int32_t d[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.u8.u8.s32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
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

// A point at a 32-byte aligned address, as two 16-byte accesses.
__device__ __forceinline__ spt::Fe load16(const uint32_t* src) {
  const uint4* q = reinterpret_cast<const uint4*>(src);
  const uint4 lo = q[0], hi = q[1];
  return spt::Fe{{lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w}};
}

__device__ __forceinline__ void store16(uint32_t* dst, const spt::Fe& y) {
  uint4* q = reinterpret_cast<uint4*>(dst);
  q[0] = make_uint4(y.v[0], y.v[1], y.v[2], y.v[3]);
  q[1] = make_uint4(y.v[4], y.v[5], y.v[6], y.v[7]);
}

// Start copying vector v's L points (2 L chunks of 16 bytes) into a warp's
// buffer; one commit group a call, empty past the last vector.
template <int L>
__device__ __forceinline__ void stage_vector(uint4* buf, const PassArgs& a, long v, int lane) {
  if (v < a.nvec) {
    const long r = v >> a.logu, u = v & ((1L << a.logu) - 1);
    const long base = (r << a.logn) + u * a.bu_in;
    const uint32_t dst = (uint32_t)__cvta_generic_to_shared(buf);
#pragma unroll
    for (int c = lane; c < 2 * L; c += 32) {
      const uint8_t* src = a.x + (base + (long)(c >> 1) * a.s_in) * 32 + (c & 1) * 16;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst + 16 * c), "l"(src));
    }
  }
  asm volatile("cp.async.commit_group;");
}

// smem: the DFT matrix ([L][MT_ALL][32] uint4), then per warp two vector
// buffers (2 L uint4 each) and the epilogue's rows (32 x kEStride u64)
template <int LOGL>
__global__ void __launch_bounds__(32 * kWarpsOf<LOGL>)
    dft_pass_kernel(PassArgs a) {
  constexpr int L = 1 << LOGL;
  constexpr int MT_ALL = (L + 15) / 16;            // m-tiles of output points
  constexpr int MT = MT_ALL < 2 ? MT_ALL : 2;      // m-tiles a sweep (registers)
  constexpr int SWEEPS = MT_ALL / MT;
  extern __shared__ uint4 smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  uint4* fragS = smem;
  uint4* bufs = smem + L * MT_ALL * 32 + warp * (4 * L + kE4);
  unsigned long long* E = reinterpret_cast<unsigned long long*>(bufs + 4 * L);

  constexpr int kWarps = kWarpsOf<LOGL>;
  for (int i = threadIdx.x; i < L * MT_ALL * 32; i += 32 * kWarps) fragS[i] = a.frag[i];
  __syncthreads();

  const long stride = (long)gridDim.x * kWarps;
  long v = (long)blockIdx.x * kWarps + warp;
  stage_vector<L>(bufs, a, v, lane);
  for (int it = 0; v < a.nvec; ++it, v += stride) {
    stage_vector<L>(bufs + ((it + 1) & 1) * 2 * L, a, v + stride, lane);
    asm volatile("cp.async.wait_group 1;" ::: "memory");
    __syncwarp();
    const uint32_t* P = reinterpret_cast<const uint32_t*>(bufs + (it & 1) * 2 * L);
    const long r = v >> a.logu, u = v & ((1L << a.logu) - 1);

#pragma unroll 1
    for (int mh = 0; mh < SWEEPS; ++mh) {
      int32_t acc[MT][8][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0;

#pragma unroll 4
      for (int j = 0; j < L; ++j) {
        // B[(j, kappa), (v, c)] = x8[j, c - pi(kappa)], kappa = 4 tq + q + 16 h,
        // pi(kappa) = 4 (tq + 4 h) + 3 - q; column n = g of n-tile (w, b) is
        // c = 4 (4 w + g / 2) + 2 b + (g & 1): bytes 2 b + (g & 1) + 1 .. of
        // words i - 1, i of the point, i = g / 2 - tq + 4 (w - h). The lane's
        // words: g / 2 - tq + {-1, 0, 3, 4, 7, 8}, zero outside 0 .. 7.
        const int base = (g >> 1) - tq;
        uint32_t wd[10];
#pragma unroll
        for (int t = 0; t < 10; ++t) {
          const int idx = base + t - 1;
          wd[t] = ((t & 3) == 0 || (t & 3) == 1) && idx >= 0 && idx < 8 ? P[j * 8 + idx] : 0u;
        }
        const uint32_t sg = 8 * ((g & 1) + 1);
        uint32_t b[8][2];
#pragma unroll
        for (int w = 0; w < 4; ++w)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int o = 4 * (w - h) + 1;           // wd index of word i
            if (o < 1 || o > 9) continue;            // the tile's zero half
#pragma unroll
            for (int bb = 0; bb < 2; ++bb)
              b[2 * w + bb][h] = __funnelshift_rc(wd[o - 1], wd[o], sg + 16 * bb);
          }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const uint4 af = fragS[(j * MT_ALL + mh * MT + mt) * 32 + lane];
          const uint32_t av[4] = {af.x, af.y, af.z, af.w};
#pragma unroll
          for (int bb = 0; bb < 2; ++bb) {
            // columns 0 .. 15 take only bytes i1 < 16 of W, columns 48 .. 63
            // only i1 >= 16: half-depth products
            mma_u8_k16(acc[mt][bb], av[0], av[1], b[bb][0]);
            mma_u8(acc[mt][2 + bb], av, b[2 + bb][0], b[2 + bb][1]);
            mma_u8(acc[mt][4 + bb], av, b[4 + bb][0], b[4 + bb][1]);
            mma_u8_k16(acc[mt][6 + bb], av[2], av[3], b[6 + bb][1]);
          }
        }
      }

      // rows 16 mt + g (+ 8): word 4 w + tq of the sum is
      // sum_(b, e) col(w, b) 2^(8 (2 b + e)) from regs e (row g) and 2 + e
      // (row g + 8)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            unsigned long long s = 0;
#pragma unroll
            for (int bb = 0; bb < 2; ++bb)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                s += (unsigned long long)(uint32_t)acc[mt][2 * w + bb][2 * hh + e]
                     << (8 * (2 * bb + e));
            E[(16 * mt + g + 8 * hh) * kEStride + 4 * w + tq] = s;
          }
      __syncwarp();
      const int k = mh * MT * 16 + lane;
      if (lane < MT * 16 && k < L) {
        unsigned long long s[16];
        const ulonglong2* row = reinterpret_cast<const ulonglong2*>(E + lane * kEStride);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const ulonglong2 two = row[q];
          s[2 * q] = two.x;
          s[2 * q + 1] = two.y;
        }
        spt::Fe y = redc272(s);
        if (a.tw != nullptr) y = spt::mont_mul<spt::FR>(y, load16(a.tw + 8 * ((u << LOGL) + k)));
        store16(a.out + 8 * ((r << a.logn) + u * a.bu_out + (long)k * a.s_out), y);
      }
      __syncwarp();
    }
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

template <int LOGL>
constexpr int smem_bytes() {
  constexpr int L = 1 << LOGL;
  return (L * ((L + 15) / 16) * 32 + kWarpsOf<LOGL> * (4 * L + kE4)) * 16;
}

template <int LOGL>
int launch(const PassArgs& a, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<LOGL>();
  static int blocks_per_sm = 0, sms = 0;   // read once a length
  if (blocks_per_sm == 0) {
    cudaFuncSetAttribute(dft_pass_kernel<LOGL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         bytes);
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm, dft_pass_kernel<LOGL>,
                                                  32 * kWarpsOf<LOGL>, bytes);
    if (blocks_per_sm < 1) blocks_per_sm = 1;
  }
  const long want = (a.nvec + kWarpsOf<LOGL> - 1) / kWarpsOf<LOGL>;
  const long cap = (long)sms * blocks_per_sm;
  const unsigned blocks = (unsigned)(want < cap ? want : cap);
  dft_pass_kernel<LOGL><<<blocks, 32 * kWarpsOf<LOGL>, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// One pass of K8 over `rows` rows of 2^logn points: the 2^logl-point DFTs of
// the rows' 2^(logn - logl) vectors (strides above), the matrix `frag` of
// ops/ntt.py `dft_fragments`, times `tw` when it is not null.
extern "C" int spt_ntt_dft_pass(const void* x, void* out, const void* frag, const void* tw,
                                long rows, int logn, int logl, long bu_in, long s_in,
                                long bu_out, long s_out, void* stream) {
  PassArgs a;
  a.x = (const uint8_t*)x;
  a.out = (uint32_t*)out;
  a.frag = (const uint4*)frag;
  a.tw = (const uint32_t*)tw;
  a.logn = logn;
  a.logu = logn - logl;
  a.nvec = rows << a.logu;
  a.bu_in = bu_in;
  a.s_in = s_in;
  a.bu_out = bu_out;
  a.s_out = s_out;
  if (a.nvec == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  switch (logl) {
    case 1: return launch<1>(a, s);
    case 2: return launch<2>(a, s);
    case 3: return launch<3>(a, s);
    case 4: return launch<4>(a, s);
    case 5: return launch<5>(a, s);
    case 6: return launch<6>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
