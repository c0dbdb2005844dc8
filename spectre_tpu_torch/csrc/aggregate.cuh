// K2b: the weighted bucket aggregation sum_{b=1}^{nb} b * B_b of one
// window, by one block (msm_kernels.cu). `__host__ __device__`, so that a
// host compiler can run a block's threads one after another:
// tests/test_torch_csrc_host.py drives these bodies and holds them against
// aggregate_buckets_plain in ops/msm_kernels.py, which follows the same
// order of adds, limb for limb.
//
// A block of T = min(K2B_THREADS, nb) threads takes the window's nb bucket
// sums (nb a power of two), L = nb / T consecutive buckets a thread:
//
//   leaf   thread t walks its buckets [tL, tL + L) from the top, keeping
//          R += B and W += R: W = sum_j (j + 1) B_{tL+j}, the run weighted
//          from 1, and D = L * R (log2 L doublings), in shared memory.
//   tree   log2 T levels; at level d, the groups of buckets of threads t
//          and t + d (t a multiple of 2d, each of size n = dL) merge:
//            W_t = (W_t + W_{t+d}) + D_{t+d}    (the right group's weights
//                                                 move up by n)
//            D_t = 2 (D_t + D_{t+d})             (the merged group's size
//                                                 times its sum)
//          thread t computes W, thread t + d computes D (not on the last
//          level, where D is not needed); no slot is read and written at
//          one level by two threads.
//
// At c = 11 (nb = 1024, T = 128, L = 8) that is 2(L - 1) + log2 L + 2 log2 T
// = 31 dependent adds a window, against the 10-level tree and 22-step
// double-and-add chain of the reference's bit decomposition. 128 threads
// ran faster than 256 (a shorter chain, but twice the warps on each
// scheduler) and than 64 (scripts/torch_kernel_variants.py).
#pragma once

#include "bn254.cuh"

namespace spt {

constexpr int K2B_THREADS = 128;

// Threads of the block that aggregates nb buckets.
SPT_HD int k2b_threads(int nb) { return nb < K2B_THREADS ? nb : K2B_THREADS; }

// Thread t of window `win`: its run of L buckets (rows win * nb + tL ...),
// leaving W[t] and D[t].
SPT_HD void k2b_leaf(int win, int t, int nb, int L, const uint32_t* sums,
                     Point* W, Point* D) {
  const uint32_t* run = sums + 24 * ((long)win * nb + (long)t * L);
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

// Thread t's part of tree level d (1, 2, 4, ... < T); `last` when 2d == T.
SPT_HD void k2b_merge(int t, int d, bool last, Point* W, Point* D) {
  const int lane = t & (2 * d - 1);
  if (lane == 0) {
    W[t] = padd(padd(W[t], W[t + d]), D[t + d]);
  } else if (lane == d && !last) {
    const Point s = padd(D[t - d], D[t]);
    D[t - d] = padd(s, s);
  }
}

}  // namespace spt
