// K1 (bucket accumulation) and K2 (complete projective addition): the CUDA
// counterparts of the two Pallas kernels of spectre_tpu/ops/msm_pallas.py;
// K2b (weighted bucket aggregation), the counterpart of the XLA loop over K2
// that follows them there.
//
// K2 replaces `_padd_soa_call` (msm_pallas.py:222, body `_k_padd`): one
// thread per point pair, the RCB formula of bn254.cuh in registers. Bound on
// the H100: integer multiply throughput (12 Montgomery products, ~3100 32-bit
// multiply-adds, per 288 bytes moved); the design moves nothing but one
// 96-byte point per operand and the result, in 16-byte accesses.
//
// K2b replaces `_aggregate_buckets_soa` (msm_pallas.py:356): one block a
// window, runs of buckets per thread and a weighted tree in shared memory
// (aggregate.cuh). Bound: integer multiply throughput for the ~3 K adds a
// window; held far from it by its chain of dependent adds, one block a
// window being all the parallelism 24 windows offer.
//
// K1 replaces `_bucket_sums` (msm_pallas.py:399, body `_k_bucket_accumulate`)
// in both its forms: a base shared by every window (`_bucket_windows_jit`
// :439) and the fixed-base window tables (`_bucket_fixed_jit` :460), where
// window w reads its own points T[w] = 2^(c w) [P ; phi(P)]. The forms
// differ only in K1b's entries (k1_scatter_kernel, k1_scatter_fixed_kernel).
// The Pallas design keeps every bucket resident in VMEM and adds each point
// into all 2^(c-1) bucket columns; neither carries over to a 227 KB block.
// Here four kernels (bodies and design in bucket.cuh) sort the (window,
// point) pairs by bucket with a counting sort on the card (K1a count, a
// torch.cumsum, K1b scatter), walk the sorted entries in equal segments with
// the next point staged in shared memory by cp.async and a segmented tree
// reduction in shared memory (K1c walk), and add the pieces
// of the buckets that cross blocks (K1d pieces): no host round trip, no sort
// from a library, and the work per thread is the same for any digit
// distribution, all-equal scalars included. Bound: integer multiply
// throughput, one complete add per nonzero digit less one per bucket; the
// gathers of 96-byte points in bucket order are the memory side.
//
// Plain C interface, loaded with ctypes by spectre_tpu_torch/ops/kernel_lib.py;
// the wrappers and plain PyTorch versions are in ops/msm_kernels.py. Each
// launcher enqueues on the stream it is given and returns cudaGetLastError(),
// so the wrapper raises on a refused launch.
#include <cuda_runtime.h>

#include "aggregate.cuh"
#include "bn254.cuh"
#include "bucket.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kPlanThreads = 256;
// K2 at 128 registers a thread: 256-thread blocks measured faster than 128
// (scripts/torch_kernel_variants.py)
constexpr int kPaddThreads = 256;

__global__ void padd_kernel(const uint32_t* __restrict__ p,
                            const uint32_t* __restrict__ q,
                            uint32_t* __restrict__ out, long n) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) spt::padd_one(i, p, q, out);
}

// K1a: grid (blocks of P points, windows); shared histogram of nb keys.
__global__ void k1_count_kernel(const int32_t* __restrict__ digits, long n,
                                int nb, long P, long nblk,
                                int32_t* __restrict__ counts) {
  extern __shared__ int32_t hist[];
  const int w = blockIdx.y;
  const long pb = blockIdx.x;
  for (int b = threadIdx.x; b < nb; b += blockDim.x) hist[b] = 0;
  __syncthreads();
  const long i0 = pb * P, i1 = i0 + P < n ? i0 + P : n;
  spt::k1_count_points(w, i0, i1, threadIdx.x, blockDim.x, digits, n, hist);
  __syncthreads();
  for (int b = threadIdx.x; b < nb; b += blockDim.x)
    counts[((long)w * nb + b) * nblk + pb] = hist[b];
}

// K1b: the same grid; each block's cursors start at its scanned offsets.
__device__ void k1_scatter_block(const int32_t* __restrict__ digits,
                                 const int32_t* __restrict__ negs, long n,
                                 int nb, long P, long nblk, long stride,
                                 const int32_t* __restrict__ offs,
                                 int32_t* __restrict__ entries) {
  extern __shared__ int32_t cursor[];
  const int w = blockIdx.y;
  const long pb = blockIdx.x;
  for (int b = threadIdx.x; b < nb; b += blockDim.x)
    cursor[b] = offs[((long)w * nb + b) * nblk + pb];
  __syncthreads();
  const long i0 = pb * P, i1 = i0 + P < n ? i0 + P : n;
  spt::k1_scatter_points(w, i0, i1, threadIdx.x, blockDim.x, digits, negs, n,
                         stride, cursor, entries);
}

// shared base: every window's entries name rows of the one base
__global__ void k1_scatter_kernel(const int32_t* __restrict__ digits,
                                  const int32_t* __restrict__ negs, long n,
                                  int nb, long P, long nblk,
                                  const int32_t* __restrict__ offs,
                                  int32_t* __restrict__ entries) {
  k1_scatter_block(digits, negs, n, nb, P, nblk, 0, offs, entries);
}

// fixed base (msm_pallas.py:460 `_bucket_fixed_jit`): window w's entries
// name rows w * n + i of the [nwin * n, 24] window table. A kernel of its
// own so that a profile and the launch counts tell the two forms apart.
__global__ void k1_scatter_fixed_kernel(const int32_t* __restrict__ digits,
                                        const int32_t* __restrict__ negs,
                                        long n, int nb, long P, long nblk,
                                        const int32_t* __restrict__ offs,
                                        int32_t* __restrict__ entries) {
  k1_scatter_block(digits, negs, n, nb, P, nblk, n, offs, entries);
}

__device__ spt::Point shfl_down_point(const spt::Point& p, int off) {
  spt::Point r;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    r.x.v[i] = __shfl_down_sync(0xffffffffu, p.x.v[i], off);
    r.y.v[i] = __shfl_down_sync(0xffffffffu, p.y.v[i], off);
    r.z.v[i] = __shfl_down_sync(0xffffffffu, p.z.v[i], off);
  }
  return r;
}

// K1c: one block per K1_BLOCK_ENTRIES sorted entries; blocks past the
// entry count E (read on the card: the grid is sized for every digit
// nonzero) leave at once. Dynamic shared memory: the block's nodes, then
// each thread's staging slots. Three blocks an SM leave ptxas ~170
// registers a thread, enough for the complete add without spills (at four,
// 128, the walk spilled and ran slower; kernel_variants.py).
constexpr size_t kWalkSmem =
    spt::K1_THREADS * (sizeof(spt::K1Node) + 4 * spt::K1_STAGE_WORDS);

__global__ void __launch_bounds__(spt::K1_THREADS, 3)
    k1_walk_kernel(const uint32_t* __restrict__ pts,
                   const int32_t* __restrict__ entries,
                   const int32_t* __restrict__ bstart, int nkeys,
                   uint32_t* __restrict__ out, uint32_t* __restrict__ pieces) {
  extern __shared__ uint4 walk_smem[];
  spt::K1Node* nodes = reinterpret_cast<spt::K1Node*>(walk_smem);
  uint32_t* stage = reinterpret_cast<uint32_t*>(nodes + spt::K1_THREADS);
  const long blk = blockIdx.x;
  if (blk * spt::K1_BLOCK_ENTRIES >= bstart[nkeys]) return;
  const int t = threadIdx.x;
  spt::k1_walk_thread(blk, t, pts, entries, bstart, nkeys, out, &nodes[t],
                      stage + spt::K1_STAGE_WORDS * t);
  for (int d = 1; d < spt::K1_THREADS; d <<= 1) {
    __syncthreads();
    if ((t & (2 * d - 1)) == 0) spt::k1_merge(&nodes[t], &nodes[t + d], out);
  }
  if (t == 0) spt::k1_root(blk, &nodes[0], bstart, out, pieces);
}

// K2b: one block per window (bodies and design in aggregate.cuh); the
// block's W and D points in dynamic shared memory, 24 KB at 128 threads.
__global__ void __launch_bounds__(spt::K2B_THREADS, 1)
    k2b_aggregate_kernel(const uint32_t* __restrict__ sums, int nb,
                         uint32_t* __restrict__ out) {
  extern __shared__ uint4 agg_smem[];
  spt::Point* W = reinterpret_cast<spt::Point*>(agg_smem);
  spt::Point* D = W + blockDim.x;
  const int T = blockDim.x, t = threadIdx.x;
  spt::k2b_leaf(blockIdx.x, t, nb, nb / T, sums, W, D);
  for (int d = 1; d < T; d <<= 1) {
    __syncthreads();
    spt::k2b_merge(t, d, 2 * d == T, W, D);
  }
  if (t == 0) spt::store_point(out + 24 * (long)blockIdx.x, W[0]);
}

// K1d: one warp per key.
__global__ void k1_pieces_kernel(const int32_t* __restrict__ bstart,
                                 int nkeys,
                                 const uint32_t* __restrict__ pieces,
                                 uint32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int key = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (key >= nkeys) return;
  long first, last;
  spt::k1_bucket_blocks(key, bstart, &first, &last);
  if (last == first) return;               // written by the walk
  if (last < first) {                      // empty bucket
    if (lane == 0) spt::store_point(out + 24 * (long)key, spt::infinity());
    return;
  }
  const long np = last - first + 1;
  const int active = np < 32 ? (int)np : 32;
  spt::Point acc = spt::infinity();
  if (lane < active)
    acc = spt::k1_pieces_lane(key, first, last, lane, 32, bstart, pieces);
  for (int off = 1; off < active; off <<= 1) {
    const spt::Point other = shfl_down_point(acc, off);
    if ((lane & (2 * off - 1)) == 0 && lane + off < active)
      acc = spt::padd(acc, other);
  }
  if (lane == 0) spt::store_point(out + 24 * (long)key, acc);
}

unsigned blocks_for(long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

// dynamic shared memory beyond 48 KB needs the kernel's opt-in
template <typename K>
int allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" int spt_padd(const void* p, const void* q, void* out, long n,
                        void* stream) {
  if (n > 0)
    padd_kernel<<<blocks_for(n, kPaddThreads), kPaddThreads, 0,
                  (cudaStream_t)stream>>>(
        (const uint32_t*)p, (const uint32_t*)q, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int spt_k2b_aggregate(const void* sums, long nwin, int nb,
                                 void* out, void* stream) {
  const int T = spt::k2b_threads(nb);
  const size_t smem = 2 * (size_t)T * sizeof(spt::Point);
  if (int rc = allow_smem(k2b_aggregate_kernel, smem)) return rc;
  if (nwin > 0)
    k2b_aggregate_kernel<<<(unsigned)nwin, T, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)sums, nb, (uint32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int spt_k1_count(const void* digits, long nwin, long n, int nb,
                            long P, long nblk, void* counts, void* stream) {
  const size_t smem = (size_t)nb * sizeof(int32_t);
  if (int rc = allow_smem(k1_count_kernel, smem)) return rc;
  k1_count_kernel<<<dim3((unsigned)nblk, (unsigned)nwin), kPlanThreads, smem,
                    (cudaStream_t)stream>>>((const int32_t*)digits, n, nb, P,
                                            nblk, (int32_t*)counts);
  return (int)cudaGetLastError();
}

// fixed != 0: the fixed-base form's scatter (entries w * n + i)
extern "C" int spt_k1_scatter(const void* digits, const void* negs, long nwin,
                              long n, int nb, long P, long nblk,
                              const void* offs, void* entries, int fixed,
                              void* stream) {
  const size_t smem = (size_t)nb * sizeof(int32_t);
  const auto kernel = fixed ? k1_scatter_fixed_kernel : k1_scatter_kernel;
  if (int rc = allow_smem(kernel, smem)) return rc;
  kernel<<<dim3((unsigned)nblk, (unsigned)nwin), kPlanThreads, smem,
           (cudaStream_t)stream>>>(
      (const int32_t*)digits, (const int32_t*)negs, n, nb, P, nblk,
      (const int32_t*)offs, (int32_t*)entries);
  return (int)cudaGetLastError();
}

extern "C" int spt_k1_walk(const void* pts, const void* entries,
                           const void* bstart, int nkeys, long max_entries,
                           void* out, void* pieces, void* stream) {
  const long nblocks =
      (max_entries + spt::K1_BLOCK_ENTRIES - 1) / spt::K1_BLOCK_ENTRIES;
  if (int rc = allow_smem(k1_walk_kernel, kWalkSmem)) return rc;
  if (nblocks > 0)
    k1_walk_kernel<<<(unsigned)nblocks, spt::K1_THREADS, kWalkSmem,
                     (cudaStream_t)stream>>>(
        (const uint32_t*)pts, (const int32_t*)entries, (const int32_t*)bstart,
        nkeys, (uint32_t*)out, (uint32_t*)pieces);
  return (int)cudaGetLastError();
}

extern "C" int spt_k1_pieces(const void* bstart, int nkeys, const void* pieces,
                             void* out, void* stream) {
  const int keys_per_block = kThreads / 32;
  if (nkeys > 0)
    k1_pieces_kernel<<<blocks_for(nkeys, keys_per_block), kThreads, 0,
                       (cudaStream_t)stream>>>(
        (const int32_t*)bstart, nkeys, (const uint32_t*)pieces,
        (uint32_t*)out);
  return (int)cudaGetLastError();
}
