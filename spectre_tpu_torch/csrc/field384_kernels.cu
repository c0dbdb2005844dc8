// K6: batched BLS12-381 G1 decompression's square root, y = sqrt(x^3 + 4)
// in Fq with a flag for whether the root exists, a group of 8 lanes of a
// warp per key.
//
// It replaces no Pallas kernel: the JAX package runs it as XLA code
// (spectre_tpu/ops/field384.py:152 `_decompress_fn`, through `:105 mont_mul`
// and `:135 mont_pow`, 24 x 16-bit limbs, a scan per product), called for the
// committee's 512 pubkeys from the preprocessor and the spec-test loader.
// The port had only the host's one-key-at-a-time decompression; in torch ops
// the pow would take ~10^5 launches, so the device form is this kernel.
//
// Bound: each key is one dependent chain of 460 Montgomery products (x^3,
// the table of odd powers, the 5-bit window chain for (p + 1) / 4, the
// check), so 512 keys take the latency of one chain, far above both the
// bytes (100 a key) and the multiply-adds of the chain over the card's peak
// rates (counted in chip_smoke.py). Design (csrc/field384.cuh): a key's six
// 64-bit digits lie in six lanes of a group of 8, so a product is 6 rounds
// in which each lane does its own 8 limb products and keeps its columns'
// carries lazily, and lanes exchange only the broadcast digit, the
// broadcast quotient and the shift (shuffles); carries are resolved once a
// product by a ballot. The window chain is baked in as constants, the same
// for every key. Blocks of one warp (4 keys) spread 512 keys over 128 SMs.
// Groups past n run on x = 0 with the rest of their warp and store nothing.
//
// Plain C interface, loaded with ctypes by spectre_tpu_torch/ops/kernel_lib.py;
// the wrapper and the plain PyTorch version are in ops/field384.py. The
// launcher enqueues on the stream it is given and returns cudaGetLastError().
#include <cuda_runtime.h>

#include "field384.cuh"

namespace {

constexpr int kThreads = 32;

__global__ void __launch_bounds__(kThreads)
    g1_sqrt_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ y,
                   int32_t* __restrict__ ok, long n) {
  using namespace spt384;
  using G = Group<WarpLanes>;
  const G g;
  const long key = ((long)blockIdx.x * kThreads + threadIdx.x) / kGroup;
  const bool live = key < n;  // the same for the whole group
  const bool mine = live && g.lane < kLanes;
  const long at = 6 * key + (long)g.lane;
  uint64_t yd;
  const int on = g.decompress(mine ? x[at] : 0, yd);
  if (mine) y[at] = yd;
  if (live && g.lane == 0) ok[key] = on;
}

}  // namespace

extern "C" int spt_g1_sqrt(const void* x, void* y, void* ok, long n, void* stream) {
  if (n > 0)
    g1_sqrt_kernel<<<(unsigned)((n * spt384::kGroup + kThreads - 1) / kThreads), kThreads, 0,
                     (cudaStream_t)stream>>>((const uint64_t*)x, (uint64_t*)y,
                                             (int32_t*)ok, n);
  return (int)cudaGetLastError();
}
