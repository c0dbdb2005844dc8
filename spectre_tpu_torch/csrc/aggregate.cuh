// K2b: the weighted bucket aggregation sum_{b=1}^{nb} b * B_b of each
// window, a window spread over G blocks (msm_kernels.cu). `__host__
// __device__`, so that a host compiler can run the blocks' threads one after
// another: tests/test_torch_csrc_host.py drives these bodies and holds them
// against aggregate_buckets_plain in ops/msm_kernels.py, which follows the
// same order of adds, limb for limb.
//
// Geometry (k2b_geometry): G, a power of two, is doubled until nwin * G
// blocks fill the card (K2B_FILL) or G^2 would pass nb; block g of a window
// takes its slice of S = nb / G consecutive buckets with T = min(K2B_THREADS,
// S) threads, L = S / T buckets a thread (1 at the vanilla and fixed
// modes' 24 x 1024 and 1 x 4096, 2 at the glv modes' 10 x 4096).
//
//   leaf   thread t walks its buckets from the top, keeping R += B and
//          W += R: W = sum_j (j + 1) B_j over its run, weighted from 1, and
//          D = L * R (log2 L doublings), in shared memory.
//   tree   log2 T levels; at level d, the groups of threads t and t + d (t
//          a multiple of 2d, each of n buckets) merge:
//            W_t = (W_t + W_{t+d}) + D_{t+d}    (the right group's weights
//                                                 move up by n)
//            D_t = 2 (D_t + D_{t+d})             (the merged group's size
//                                                 times its sum)
//          merge k's W by thread k, its D by thread T/2 + k (two warps, not
//          two paths of one); no slot is read and written at one level by
//          two threads. The block leaves its slice's (W, D) in global
//          scratch.
//   merge  the block that finishes its window last (a ticket: atomicAdd on
//          the window's counter after a __threadfence; it sets the counter
//          back to 0 for the next launch) loads the window's G pairs and
//          runs the same tree over them (G <= T). The last level
//          of the window's tree computes no D.
//
// At nb = 1024 and 24 windows (G = 8, T = 128) the chain is 2 log2 nb = 20
// dependent adds, at one window of 4096 (G = 64, T = 64) 24, where one block
// a window made 31 and 81. A fill of 128 blocks measured faster than 64,
// 256 and 512; issuing each add's independent products as one group did not
// shorten an add on the card (scripts/torch_kernel_variants.py, PERF.md),
// so the adds are padd's.
#pragma once

#include "bn254.cuh"

namespace spt {

constexpr int K2B_THREADS = 128;     // threads of a block, at most
constexpr int K2B_FILL = 128;        // blocks that fill the card

struct K2bGeometry {
  int G, T, L;                       // blocks a window, threads, buckets a thread
};

// The geometry of nwin windows of nb buckets (nb a power of two). G^2 <= nb
// keeps G <= T, so the merge's tree has a thread per pair.
SPT_HD K2bGeometry k2b_geometry(long nwin, int nb) {
  int G = 1;
  while ((long)(2 * G) * (2 * G) <= nb && nwin * G < K2B_FILL) G *= 2;
  const int S = nb / G;
  const int T = S < K2B_THREADS ? S : K2B_THREADS;
  return {G, T, S / T};
}

// Thread t of block g of window `win`: its run of L buckets (rows
// win * nb + g * S + t * L ...), leaving W[t] and D[t].
SPT_HD void k2b_leaf(int win, int g, int t, int nb, int S, int L,
                     const uint32_t* sums, Point* W, Point* D) {
  const uint32_t* run = sums + 24 * ((long)win * nb + (long)g * S + (long)t * L);
  Point r = load_point(run + 24 * (L - 1));
  Point w = r;
  for (int j = L - 2; j >= 0; --j) {
    r = padd(r, load_point(run + 24 * j));
    w = padd(w, r);
  }
  for (int s = L; s > 1; s >>= 1) r = padd(r, r);
  W[t] = w;
  D[t] = r;
}

// Thread t's part of tree level d (1, 2, 4, ... < n) over n nodes by a
// block of 2 * half >= n threads: merge k (of node i = 2 d k and i + d)
// has its W computed by thread k and its D by thread half + k, so the two
// paths run in different warps (from 64 threads on) and not one after the
// other in one. `last` on the window's last level, whose D is not needed.
SPT_HD void k2b_merge(int t, int d, int n, int half, bool last, Point* W, Point* D) {
  const int merges = n / (2 * d);
  if (t < merges) {
    const int i = 2 * d * t;
    W[i] = padd(padd(W[i], W[i + d]), D[i + d]);
  } else if (!last && t >= half && t - half < merges) {
    const int i = 2 * d * (t - half);
    const Point s = padd(D[i], D[i + d]);
    D[i] = padd(s, s);
  }
}

// Thread 0 of block g of window `win`, its tree done: store the slice's
// (W, D) at pairs[(win * G + g) * 2 ...], then take a ticket. True for the
// window's last block, which also sets the counter back to 0.
SPT_HD bool k2b_publish(int win, int g, int G, const Point* W, const Point* D,
                        uint32_t* pairs, int32_t* tickets) {
  uint32_t* at = pairs + 48 * ((long)win * G + g);
  store_point(at, W[0]);
  store_point(at + 24, D[0]);
#if defined(__CUDA_ARCH__)
  __threadfence();
#endif
  const int ticket = SPT_ATOMIC_ADD(&tickets[win], 1);
  if (ticket != G - 1) return false;
  tickets[win] = 0;
  return true;
}

// Thread t < G of the window's last block: pair t into W[t], D[t]. On the
// card the loads bypass L1 (other SMs wrote the pairs).
SPT_HD void k2b_gather(int win, int t, int G, const uint32_t* pairs, Point* W,
                       Point* D) {
  const uint32_t* at = pairs + 48 * ((long)win * G + t);
#if defined(__CUDA_ARCH__)
  uint32_t buf[48];
  const uint4* q = reinterpret_cast<const uint4*>(at);
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    const uint4 v = __ldcg(q + i);
    buf[4 * i] = v.x;
    buf[4 * i + 1] = v.y;
    buf[4 * i + 2] = v.z;
    buf[4 * i + 3] = v.w;
  }
  W[t] = load_point(buf);
  D[t] = load_point(buf + 24);
#else
  W[t] = load_point(at);
  D[t] = load_point(at + 24);
#endif
}

}  // namespace spt
