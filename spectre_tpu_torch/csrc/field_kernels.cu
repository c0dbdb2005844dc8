// K3 (elementwise Montgomery product over Fr or Fq) and K4 (one radix-2 NTT
// stage over Fr): the two kernels the port adds for the prover's field and
// NTT work, which the JAX package leaves to XLA (spectre_tpu/ops/field_ops.py
// `_mont_mul_cios`, spectre_tpu/ops/ntt.py `_ntt_stages`).
//
// K3: one thread per element, CIOS over 8 x 32-bit limbs with 64-bit
// products; the second operand is read at i % nb, so one launch also scales
// by a constant or multiplies a batch by one table. Bound: memory (96 bytes
// per product against ~257 multiply-adds), near the card's balance point.
// K4: one thread per butterfly of one decimation-in-time stage, in place; a
// stage reads and writes every element once. Bound: memory.
//
// Plain C interface, loaded with ctypes by spectre_tpu_torch/ops/kernel_lib.py;
// the wrappers and plain PyTorch versions are in ops/field_ops.py and
// ops/ntt.py. Each launcher enqueues on the stream it is given and returns
// cudaGetLastError().
#include <cuda_runtime.h>

#include "bn254.cuh"

namespace {

constexpr int kThreads = 256;

template <int F>
__global__ void mont_mul_kernel(const uint32_t* __restrict__ a,
                                const uint32_t* __restrict__ b, long nb,
                                uint32_t* __restrict__ out, long n) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) spt::mont_mul_one<F>(i, a, b, nb, out);
}

__global__ void ntt_stage_kernel(uint32_t* __restrict__ a,
                                 const uint32_t* __restrict__ tw, long n,
                                 long half, long tw_stride, long total) {
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < total) spt::ntt_butterfly_one(t, a, tw, n, half, tw_stride);
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

extern "C" int spt_ntt_stage(void* a, const void* tw, long batch, long n,
                             long half, long tw_stride, void* stream) {
  const long total = batch * (n >> 1);
  if (total > 0)
    ntt_stage_kernel<<<blocks_for(total), kThreads, 0, (cudaStream_t)stream>>>(
        (uint32_t*)a, (const uint32_t*)tw, n, half, tw_stride, total);
  return (int)cudaGetLastError();
}
