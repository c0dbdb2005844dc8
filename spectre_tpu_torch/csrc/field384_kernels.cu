// K6: batched BLS12-381 G1 decompression's square root, y = sqrt(x^3 + 4)
// in Fq with a flag for whether the root exists, one CUDA thread per key.
//
// It replaces no Pallas kernel: the JAX package runs it as XLA code
// (spectre_tpu/ops/field384.py:152 `_decompress_fn`, through `:105 mont_mul`
// and `:135 mont_pow`, 24 x 16-bit limbs, a scan per product), called for the
// committee's 512 pubkeys from the preprocessor and the spec-test loader.
// The port had only the host's one-key-at-a-time decompression; in torch ops
// the pow would take ~10^5 launches, so the device form is this kernel.
//
// Design: a thread takes one key's x (Montgomery, 12 x 32-bit limbs), forms
// x^3 + 4, raises it to (p + 1) / 4 (609 Montgomery products, one dependent
// chain) and checks y^2 against it (csrc/field384.cuh). Bound: 512 keys hold
// 512 threads on a card of 132 SMs, so the run is the latency of that chain,
// far above both the bytes (100 a key) and the multiply-adds of a short
// addition chain for the pow (counted in chip_smoke.py) over the card's peak
// rates. Blocks of 64 threads spread the keys over 8
// SMs for 512 keys.
//
// Plain C interface, loaded with ctypes by spectre_tpu_torch/ops/kernel_lib.py;
// the wrapper and the plain PyTorch version are in ops/field384.py. The
// launcher enqueues on the stream it is given and returns cudaGetLastError().
#include <cuda_runtime.h>

#include "field384.cuh"

namespace {

constexpr int kThreads = 64;

__global__ void __launch_bounds__(kThreads)
    g1_sqrt_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                   int32_t* __restrict__ ok, long n) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) ok[i] = spt384::decompress_one(i, x, y);
}

}  // namespace

extern "C" int spt_g1_sqrt(const void* x, void* y, void* ok, long n, void* stream) {
  if (n > 0)
    g1_sqrt_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                     (cudaStream_t)stream>>>((const uint32_t*)x, (uint32_t*)y,
                                             (int32_t*)ok, n);
  return (int)cudaGetLastError();
}
