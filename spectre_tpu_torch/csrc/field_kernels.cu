// K3 (elementwise Montgomery product over Fr or Fq) and K4 (the radix-2 NTT
// over Fr, in passes held in shared memory): the two kernels the port adds
// for the prover's field and NTT work, which the JAX package leaves to XLA
// (spectre_tpu/ops/field_ops.py `_mont_mul_cios`, spectre_tpu/ops/ntt.py
// `_ntt_stages`).
//
// K3: one thread per element, CIOS over 8 x 32-bit limbs (bn254.cuh: rows
// of independent wide products, PTX carry chains on the card); the second
// operand is read at i % nb,
// so one launch also scales by a constant or multiplies a batch by one
// table. Bound: memory (96 bytes per product against ~257 multiply-adds),
// near the card's balance point.
//
// K4: one launch per pass of up to t stages (ntt.cuh): a block loads a tile
// of C columns x 2^t rows into shared memory with 16-byte coalesced loads,
// runs the pass's stages there with a barrier between stages, and stores
// the tile back. The first pass reads the input in natural order and puts
// it in bit-reversed rows as it loads, so no permutation runs apart. A 2^23
// transform is three passes over memory where the stage-per-launch design
// made 23 and a gather. Bound: integer multiply throughput (one Montgomery
// product per butterfly, 257 multiply-adds, against 2 x 32 bytes per
// element per pass).
//
// Plain C interface, loaded with ctypes by spectre_tpu_torch/ops/kernel_lib.py;
// the wrappers and plain PyTorch versions are in ops/field_ops.py and
// ops/ntt.py. Each launcher enqueues on the stream it is given and returns
// cudaGetLastError().
#include <cuda_runtime.h>

#include "bn254.cuh"
#include "ntt.cuh"

namespace {

constexpr int kThreads = 256;

template <int F>
__global__ void mont_mul_kernel(const uint32_t* __restrict__ a,
                                const uint32_t* __restrict__ b, long nb,
                                uint32_t* __restrict__ out, long n) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) spt::mont_mul_one<F>(i, a, b, nb, out);
}

// One Fq product per thread, nothing else: never launched, it is there to
// be read. chip_smoke.py counts its SASS instructions (cuobjdump -sass) as
// the instruction count of one Montgomery product.
__global__ void mont_mul_probe_kernel(const uint32_t* __restrict__ a,
                                      const uint32_t* __restrict__ b,
                                      uint32_t* __restrict__ out) {
  const int i = threadIdx.x;
  spt::store_fe(out + 8 * i, spt::mont_mul<spt::FQ>(spt::load_fe(a + 8 * i),
                                                   spt::load_fe(b + 8 * i)));
}

// grid (blocks of a transform, batch); src == dst after the first pass
__global__ void __launch_bounds__(kThreads)
    ntt_pass_kernel(const uint32_t* src, uint32_t* dst,
                    const uint32_t* __restrict__ tw, spt::NttPass g) {
  extern __shared__ uint4 smem4[];
  uint32_t* sm = reinterpret_cast<uint32_t*>(smem4);
  const long blk = blockIdx.x, b = blockIdx.y;
  spt::ntt_pass_load(g, blk, b, threadIdx.x, blockDim.x, src, sm);
  for (int ls = 0; ls < g.t; ++ls) {
    __syncthreads();
    spt::ntt_pass_stage(g, blk, ls, threadIdx.x, blockDim.x, tw, sm);
  }
  __syncthreads();
  spt::ntt_pass_store(g, blk, b, threadIdx.x, blockDim.x, sm, dst);
}

unsigned blocks_for(long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int spt_mont_mul(const void* a, const void* b, long nb, void* out,
                            long n, int field, void* stream) {
  if (n > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (field == spt::FQ)
      mont_mul_kernel<spt::FQ><<<blocks_for(n), kThreads, 0, s>>>(
          (const uint32_t*)a, (const uint32_t*)b, nb, (uint32_t*)out, n);
    else
      mont_mul_kernel<spt::FR><<<blocks_for(n), kThreads, 0, s>>>(
          (const uint32_t*)a, (const uint32_t*)b, nb, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int spt_ntt_pass(const void* src, void* dst, const void* tw,
                            long batch, int logn, int s0, int t, int logc,
                            void* stream) {
  const spt::NttPass g{1L << logn, logn, s0, t, logc};
  const size_t smem = (size_t)spt::ntt_tile_elems(g) * 32;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        ntt_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  ntt_pass_kernel<<<dim3((unsigned)spt::ntt_blocks(g), (unsigned)batch),
                    kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)src, (uint32_t*)dst, (const uint32_t*)tw, g);
  return (int)cudaGetLastError();
}
