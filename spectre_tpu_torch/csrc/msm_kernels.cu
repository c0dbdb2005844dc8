// K1 (bucket accumulation) and K2 (complete projective addition): the CUDA
// counterparts of the two Pallas kernels of spectre_tpu/ops/msm_pallas.py.
//
// K2 replaces `_padd_soa_call` (msm_pallas.py:222, body `_k_padd`): one
// thread per point pair, the RCB formula of bn254.cuh in registers. Bound on
// the H100: integer multiply issue (12 Montgomery products, ~3100 32-bit
// multiply-adds, per 288 bytes moved); the design moves nothing but one
// 96-byte point per operand and the result.
//
// K1 replaces `_bucket_sums` (msm_pallas.py:399, body `_k_bucket_accumulate`).
// The Pallas design keeps every bucket resident in VMEM and adds each point
// into all 2^(c-1) bucket columns; neither carries over to a 227 KB block.
// Here the (window, point) pairs arrive sorted by bucket (prep in torch), one
// thread walks a chunk of at most 32 entries of one bucket, conditionally
// negating each point and complete-adding it into a partial sum written to
// device memory, and K2 folds the partials of a bucket pairwise. Chunks keep
// a bucket holding every point (all scalars equal) from running on one
// thread. Bound: integer multiply issue, one complete add per nonzero digit;
// the bucket-ordered gathers of 96-byte points are the memory side.
//
// Plain C interface, loaded with ctypes by spectre_tpu_torch/ops/kernel_lib.py;
// the wrappers and plain PyTorch versions are in ops/msm_kernels.py. Each
// launcher enqueues on the stream it is given and returns cudaGetLastError(),
// so the wrapper raises on a refused launch.
#include <cuda_runtime.h>

#include "bn254.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void padd_kernel(const uint32_t* __restrict__ p,
                            const uint32_t* __restrict__ q,
                            uint32_t* __restrict__ out, long n) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) spt::padd_one(i, p, q, out);
}

__global__ void bucket_chunk_kernel(const uint32_t* __restrict__ pts,
                                    const int32_t* __restrict__ entries,
                                    const int64_t* __restrict__ chunk_start,
                                    const int32_t* __restrict__ chunk_len,
                                    uint32_t* __restrict__ partials,
                                    long nchunks) {
  const long c = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c < nchunks)
    spt::bucket_chunk_one(c, pts, entries, chunk_start, chunk_len, partials);
}

unsigned blocks_for(long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int spt_padd(const void* p, const void* q, void* out, long n,
                        void* stream) {
  if (n > 0)
    padd_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)p, (const uint32_t*)q, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int spt_bucket_chunks(const void* pts, const void* entries,
                                 const void* chunk_start,
                                 const void* chunk_len, void* partials,
                                 long nchunks, void* stream) {
  if (nchunks > 0)
    bucket_chunk_kernel<<<blocks_for(nchunks), kThreads, 0,
                          (cudaStream_t)stream>>>(
        (const uint32_t*)pts, (const int32_t*)entries,
        (const int64_t*)chunk_start, (const int32_t*)chunk_len,
        (uint32_t*)partials, nchunks);
  return (int)cudaGetLastError();
}
