#!/usr/bin/env python3
"""Time variants of the port's CUDA kernels against the sources as they are.

    python3 scripts/torch_kernel_variants.py             # every variant
    python3 scripts/torch_kernel_variants.py product K2  # names holding one of these

Each variant is a copy of spectre_tpu_torch/csrc with a few lines or one
function edited (a launch bound, a block size, the walk's segment length or
staging depth, the fixed walk's blocks an SM and running sums a thread,
K2b's blocks a window, the point loads, the Montgomery product of the
parent revision, the unrolling and grouping of the adds' products, the
portable add and sub in place of the PTX carry chains)
or a Python-side constant changed (the NTT's pass plan, the K1 plan's
points per block, K2b's threads and blocks). All copies are built at once
with the flags of ops/kernel_lib.py into build/kernel_variants/, and each
variant runs in this one process on the same inputs: K1 at n = 2^21
(random and all-equal scalars, checked against the sources' own result
after normalization), K1's fixed form at the step's geometry (2^22 GLV
rows of a normalised table, c = 13, 10 windows: the walk alone and the
wrapper, checked after normalization), K4 at 2^23 (checked exactly) and
[16, 2^21], K2 at 2^21 pairs, K2b on 24 windows of 1024 and on one window
of 4096 projective bucket sums (checked after normalization: another
geometry adds in another order), K3 at 2^23 and K6 (its squaring form,
shuffles and block size; probes that drop a part to show its cost give
wrong results) on the committee's 512 keys, checked limb for limb against
the plain version, and K7 at 2^23 (checked against K3) and K8 on the
committee's [1024, 2^10] legs (checked against K4, each pass also timed
alone). A variant rebuilds only the libraries whose
sources it edits, and its row times only their kernels (the BN254 ones
also under a Python constant). Prints the card's name and power limit,
then one JSON line per variant with CUDA-event milliseconds, the SASS
instruction count of the product's probe kernel and of K6, and the
registers and spill bytes a thread of K1c, K1c_fixed, K2, K2b, K6, K7
and K8.
Exits non-zero without CUDA.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The Montgomery product of the parent revision (PR 2): CIOS with one
# mad.lo.cc / madc.hi.cc carry chain per half-row, its host path the
# portable 64-bit CIOS; straight-line code whatever STEP asks.
PR2_PRODUCT_DEV = r'''// CIOS, 8 rounds: t += a * b[i] (low halves into t[0..7], high halves into
// t[1..8], carries into t[8], t[9]), m = t[0] * n0, t += m * p the same
// way (t[0] becomes 0), shift down one limb.
template <int F> __device__ __forceinline__ Fe mont_mul_dev(const Fe& a, const Fe& b) {
  uint32_t t0 = 0, t1 = 0, t2 = 0, t3 = 0, t4 = 0, t5 = 0, t6 = 0, t7 = 0, t8 = 0,
           t9 = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t bi = b.v[i];
    asm("mad.lo.cc.u32 %0, %10, %18, %0;\n\t"
        "madc.lo.cc.u32 %1, %11, %18, %1;\n\t"
        "madc.lo.cc.u32 %2, %12, %18, %2;\n\t"
        "madc.lo.cc.u32 %3, %13, %18, %3;\n\t"
        "madc.lo.cc.u32 %4, %14, %18, %4;\n\t"
        "madc.lo.cc.u32 %5, %15, %18, %5;\n\t"
        "madc.lo.cc.u32 %6, %16, %18, %6;\n\t"
        "madc.lo.cc.u32 %7, %17, %18, %7;\n\t"
        "addc.cc.u32 %8, %8, 0;\n\t"
        "addc.u32 %9, %9, 0;\n\t"
        "mad.hi.cc.u32 %1, %10, %18, %1;\n\t"
        "madc.hi.cc.u32 %2, %11, %18, %2;\n\t"
        "madc.hi.cc.u32 %3, %12, %18, %3;\n\t"
        "madc.hi.cc.u32 %4, %13, %18, %4;\n\t"
        "madc.hi.cc.u32 %5, %14, %18, %5;\n\t"
        "madc.hi.cc.u32 %6, %15, %18, %6;\n\t"
        "madc.hi.cc.u32 %7, %16, %18, %7;\n\t"
        "madc.hi.cc.u32 %8, %17, %18, %8;\n\t"
        "addc.u32 %9, %9, 0;"
        : "+r"(t0), "+r"(t1), "+r"(t2), "+r"(t3), "+r"(t4), "+r"(t5), "+r"(t6), "+r"(t7), "+r"(t8), "+r"(t9)
        : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]), "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]), "r"(bi));
    const uint32_t m = t0 * Consts<F>::n0;
    asm("mad.lo.cc.u32 %0, %10, %18, %0;\n\t"
        "madc.lo.cc.u32 %1, %11, %18, %1;\n\t"
        "madc.lo.cc.u32 %2, %12, %18, %2;\n\t"
        "madc.lo.cc.u32 %3, %13, %18, %3;\n\t"
        "madc.lo.cc.u32 %4, %14, %18, %4;\n\t"
        "madc.lo.cc.u32 %5, %15, %18, %5;\n\t"
        "madc.lo.cc.u32 %6, %16, %18, %6;\n\t"
        "madc.lo.cc.u32 %7, %17, %18, %7;\n\t"
        "addc.cc.u32 %8, %8, 0;\n\t"
        "addc.u32 %9, %9, 0;\n\t"
        "mad.hi.cc.u32 %1, %10, %18, %1;\n\t"
        "madc.hi.cc.u32 %2, %11, %18, %2;\n\t"
        "madc.hi.cc.u32 %3, %12, %18, %3;\n\t"
        "madc.hi.cc.u32 %4, %13, %18, %4;\n\t"
        "madc.hi.cc.u32 %5, %14, %18, %5;\n\t"
        "madc.hi.cc.u32 %6, %15, %18, %6;\n\t"
        "madc.hi.cc.u32 %7, %16, %18, %7;\n\t"
        "madc.hi.cc.u32 %8, %17, %18, %8;\n\t"
        "addc.u32 %9, %9, 0;"
        : "+r"(t0), "+r"(t1), "+r"(t2), "+r"(t3), "+r"(t4), "+r"(t5), "+r"(t6), "+r"(t7), "+r"(t8), "+r"(t9)
        : "r"(Consts<F>::p(0)), "r"(Consts<F>::p(1)), "r"(Consts<F>::p(2)), "r"(Consts<F>::p(3)), "r"(Consts<F>::p(4)), "r"(Consts<F>::p(5)), "r"(Consts<F>::p(6)), "r"(Consts<F>::p(7)), "r"(m));
    t0 = t1; t1 = t2; t2 = t3; t3 = t4; t4 = t5; t5 = t6; t6 = t7; t7 = t8; t8 = t9;
    t9 = 0;
  }
  Fe r;
  r.v[0] = t0; r.v[1] = t1; r.v[2] = t2; r.v[3] = t3;
  r.v[4] = t4; r.v[5] = t5; r.v[6] = t6; r.v[7] = t7;
  return cond_sub_p<F>(r);  // p < R/4: the result is < 2p, t8 == 0
}
'''
PR2_PRODUCT = r'''// CIOS Montgomery product a * b * 2^-256 mod p: 8 rounds, each one row of
// 32x32->64 products of a by b[i] and one row of m*p.
template <int F, int STEP = 8> SPT_HD Fe mont_mul(const Fe& a, const Fe& b) {
#if defined(__CUDA_ARCH__)
  return mont_mul_dev<F>(a, b);
#else
  uint32_t t[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint64_t cur = (uint64_t)a.v[j] * b.v[i] + t[j] + c;
      t[j] = (uint32_t)cur;
      c = cur >> 32;
    }
    uint64_t cur = (uint64_t)t[8] + c;
    t[8] = (uint32_t)cur;
    t[9] = (uint32_t)(cur >> 32);
    uint32_t m = t[0] * Consts<F>::n0;
    cur = (uint64_t)m * Consts<F>::p(0) + t[0];
    c = cur >> 32;
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      cur = (uint64_t)m * Consts<F>::p(j) + t[j] + c;
      t[j - 1] = (uint32_t)cur;
      c = cur >> 32;
    }
    cur = (uint64_t)t[8] + c;
    t[7] = (uint32_t)cur;
    t[8] = t[9] + (uint32_t)(cur >> 32);
  }
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = t[i];
  return cond_sub_p<F>(r);  // p < R/4: the result is < 2p, t[8] == 0
#endif
}

'''

# The grouped products under the PR 2 product: one after another.
PR2_GROUP = r'''template <int F, int N, int STEP = 2>
SPT_HD void mont_mul_group(Fe* r, const Fe* a, const Fe* b) {
#pragma unroll
  for (int j = 0; j < N; ++j) r[j] = mont_mul<F>(a[j], b[j]);
}

'''

# K1's walk with K1_STAGE_AHEAD points in flight ahead of the one it adds:
# its slots used as a ring, the wait_group immediate chosen by a switch.
# Replaces bucket.cuh from k1_staged_point up to the walk's first use of p.
K1_RING_WALK = r'''SPT_HD Point k1_staged_point(const uint32_t* slot, int32_t e, int pending) {
  Point p;
#if defined(__CUDA_ARCH__)
  static_assert(K1_STAGE_AHEAD <= 3, "wait_group takes an immediate");
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;" ::: "memory"); break;
  }
#else
  (void)pending;
#endif
  p = load_point(slot);
  return e < 0 ? neg(p) : p;
}

// Thread t of walk block blk: walk entries [s, min(s + SEG, E)). `stage` is
// the thread's K1_STAGE_AHEAD + 1 point slots, used as a ring: while the
// point of entry pos is added, those of pos + 1 .. pos + K1_STAGE_AHEAD are
// on their way into the others, and the entry after them is being read.
SPT_HD void k1_walk_thread(long blk, long t, const uint32_t* pts,
                           const int32_t* entries, const int32_t* bstart,
                           int nkeys, uint32_t* out, K1Node* node,
                           uint32_t* stage) {
  constexpr int NS = K1_STAGE_AHEAD + 1;
  const long E = bstart[nkeys];
  const long s = blk * K1_BLOCK_ENTRIES + t * K1_SEG;
  const long e_end = s + K1_SEG < E ? s + K1_SEG : E;
  node->valid = s < E;
  if (!node->valid) return;
  int32_t ahead[NS];                   // entries pos .. pos + K1_STAGE_AHEAD
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    ahead[k] = s + k < e_end ? entries[s + k] : 0;
    if (s + k < e_end) k1_stage(stage + 24 * k, pts, ahead[k]);
  }
  int32_t upcoming = s + NS < e_end ? entries[s + NS] : 0;
  int key = k1_find_key(bstart, 0, nkeys - 1, s);
  long bend = bstart[key + 1];
  const long last = e_end - 1;
  Point acc = k1_staged_point(stage, ahead[0],
                              (int)(last - s < K1_STAGE_AHEAD ? last - s : K1_STAGE_AHEAD));
  int runs = 0;
  for (long pos = s + 1; pos < e_end; ++pos) {
#pragma unroll
    for (int k = 0; k < K1_STAGE_AHEAD; ++k) ahead[k] = ahead[k + 1];
    const long q = pos + K1_STAGE_AHEAD;
    if (q < e_end) {   // into the slot of the point just added
      ahead[K1_STAGE_AHEAD] = upcoming;
      k1_stage(stage + 24 * ((q - s) % NS), pts, upcoming);
      upcoming = q + 1 < e_end ? entries[q + 1] : 0;
    }
    const Point p = k1_staged_point(
        stage + 24 * ((pos - s) % NS), ahead[0],
        (int)(last - pos < K1_STAGE_AHEAD ? last - pos : K1_STAGE_AHEAD));
'''


def _k1_stage_ahead(d: int) -> list:
    """The edits of bucket.cuh for a K1 walk with d points in flight."""
    return [("bucket.cuh", "constexpr int K1_STAGE_WORDS = 52;",
             f"constexpr int K1_STAGE_AHEAD = {d};\n"
             "constexpr int K1_STAGE_WORDS = 24 * (K1_STAGE_AHEAD + 1) + 4;"),
            ("bucket.cuh", ("SPT_HD Point k1_staged_point(", "    if (pos < bend) {"),
             K1_RING_WALK)]


# K2b's leaf and merge with the complete add of K1c (straight-line products,
# one at a time): what the compiler makes of an add left to itself.
K2B_BODIES_PADD8 = r'''// Thread t of block g of window `win`: its run of L buckets.
SPT_HD void k2b_leaf(int win, int g, int t, int nb, int S, int L,
                     const uint32_t* sums, Point* W, Point* D) {
  const uint32_t* run = sums + 24 * ((long)win * nb + (long)g * S + (long)t * L);
  Point r = load_point(run + 24 * (L - 1));
  Point w = r;
  for (int j = L - 2; j >= 0; --j) {
    r = padd<8>(r, load_point(run + 24 * j));
    w = padd<8>(w, r);
  }
  for (int s = L; s > 1; s >>= 1) r = padd<8>(r, r);
  W[t] = w;
  D[t] = r;
}

SPT_HD void k2b_merge(int t, int d, int n, int half, bool last, Point* W, Point* D) {
  const int merges = n / (2 * d);
  if (t < merges) {
    const int i = 2 * d * t;
    W[i] = padd<8>(padd<8>(W[i], W[i + d]), D[i + d]);
  } else if (!last && t >= half && t - half < merges) {
    const int i = 2 * d * (t - half);
    const Point s = padd<8>(D[i], D[i + d]);
    D[i] = padd<8>(s, s);
  }
}

'''

# K2b's merge as PR 3 mapped it: W on thread i, D on thread i + d of the
# same warp (two divergent paths a level).
K2B_LANE_MERGE = r'''SPT_HD void k2b_merge(int t, int d, int n, int half, bool last, Point* W, Point* D) {
  (void)half;
  const int lane = t & (2 * d - 1);
  if (t >= n) return;
  if (lane == 0) {
    W[t] = padd(padd(W[t], W[t + d]), D[t + d]);
  } else if (lane == d && !last) {
    const Point s = padd(D[t - d], D[t]);
    D[t - d] = padd(s, s);
  }
}

'''

# The adds with each layer of independent products issued as one group, a
# round of every product a step (mont_mul_group), and K2b's bodies over
# them: the design this PR measured first.
GROUPED_ADDS = r'''template <int F, int N, int STEP = 2>
SPT_HD void mont_mul_group(Fe* r, const Fe* a, const Fe* b) {
  uint32_t t[N][8];
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i) t[j][i] = 0;
#pragma unroll 1
  for (int i0 = 0; i0 < 8; i0 += STEP)
#pragma unroll
  for (int k = 0; k < STEP; ++k)
#pragma unroll
    for (int j = 0; j < N; ++j) mont_round<F>(t[j], a[j], b[j].v[i0 + k]);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    Fe x;
#pragma unroll
    for (int i = 0; i < 8; ++i) x.v[i] = t[j][i];
    r[j] = cond_sub_p<F>(x);
  }
}

SPT_HD Point padd_grouped(const Point& p, const Point& q) {
  const Fe a1[6] = {p.x, p.y, p.z, add<FQ>(p.x, p.y), add<FQ>(p.y, p.z), add<FQ>(p.x, p.z)};
  const Fe b1[6] = {q.x, q.y, q.z, add<FQ>(q.x, q.y), add<FQ>(q.y, q.z), add<FQ>(q.x, q.z)};
  Fe m[6];
  mont_mul_group<FQ, 6>(m, a1, b1);
  const Fe t0 = m[0], t1 = m[1], t2 = m[2];
  Fe t3 = sub<FQ>(sub<FQ>(m[3], t0), t1);
  Fe t4 = sub<FQ>(sub<FQ>(m[4], t1), t2);
  Fe yc = sub<FQ>(sub<FQ>(m[5], t0), t2);
  Fe t0_3 = add<FQ>(add<FQ>(t0, t0), t0);
  Fe t2_2 = add<FQ>(t2, t2);
  Fe t2_4 = add<FQ>(t2_2, t2_2);
  Fe b3t2 = add<FQ>(add<FQ>(t2_4, t2_4), t2);
  Fe y_2 = add<FQ>(yc, yc);
  Fe y_4 = add<FQ>(y_2, y_2);
  Fe b3y = add<FQ>(add<FQ>(y_4, y_4), yc);
  Fe z3p = add<FQ>(t1, b3t2);
  Fe t1m = sub<FQ>(t1, b3t2);
  const Fe a2[6] = {t3, t4, t1m, b3y, z3p, t0_3};
  const Fe b2[6] = {t1m, b3y, z3p, t0_3, t4, t3};
  mont_mul_group<FQ, 6>(m, a2, b2);
  Point r;
  r.x = sub<FQ>(m[0], m[1]);
  r.y = add<FQ>(m[2], m[3]);
  r.z = add<FQ>(m[4], m[5]);
  return r;
}

SPT_HD Fe times_b3(const Fe& a) {
  const Fe a2 = add<FQ>(a, a);
  const Fe a4 = add<FQ>(a2, a2);
  return add<FQ>(add<FQ>(a4, a4), a);
}

template <int STEP = 2>
SPT_HD Point madd(const Point& p, const Fe& x2, const Fe& y2) {
  const Fe a1[5] = {p.x, p.y, add<FQ>(x2, y2), y2, x2};
  const Fe b1[5] = {x2, y2, add<FQ>(p.x, p.y), p.z, p.z};
  Fe m[6];
  mont_mul_group<FQ, 5>(m, a1, b1);
  const Fe t0 = m[0], t1 = m[1];
  const Fe t3 = sub<FQ>(m[2], add<FQ>(t0, t1));
  const Fe t4 = add<FQ>(m[3], p.y);
  const Fe y3 = times_b3(add<FQ>(m[4], p.x));
  const Fe t0_3 = add<FQ>(add<FQ>(t0, t0), t0);
  const Fe t2 = times_b3(p.z);
  const Fe z3 = add<FQ>(t1, t2);
  const Fe t1m = sub<FQ>(t1, t2);
  const Fe a2[6] = {t4, t3, y3, t1m, t0_3, z3};
  const Fe b2[6] = {y3, t1m, t0_3, z3, t3, t4};
  mont_mul_group<FQ, 6>(m, a2, b2);
  Point r;
  r.x = sub<FQ>(m[1], m[0]);
  r.y = add<FQ>(m[3], m[2]);
  r.z = add<FQ>(m[5], m[4]);
  return r;
}

'''
K2B_BODIES_GROUPED = r'''SPT_HD void k2b_leaf(int win, int g, int t, int nb, int S, int L,
                     const uint32_t* sums, Point* W, Point* D) {
  const uint32_t* run = sums + 24 * ((long)win * nb + (long)g * S + (long)t * L);
  Point r = load_point(run + 24 * (L - 1));
  Point w = r;
  for (int j = L - 2; j >= 0; --j) {
    r = padd_grouped(r, load_point(run + 24 * j));
    w = padd_grouped(w, r);
  }
  for (int s = L; s > 1; s >>= 1) r = padd_grouped(r, r);
  W[t] = w;
  D[t] = r;
}

SPT_HD void k2b_merge(int t, int d, int n, int half, bool last, Point* W, Point* D) {
  const int merges = n / (2 * d);
  if (t < merges) {
    const int i = 2 * d * t;
    W[i] = padd_grouped(padd_grouped(W[i], W[i + d]), D[i + d]);
  } else if (!last && t >= half && t - half < merges) {
    const int i = 2 * d * (t - half);
    const Point s = padd_grouped(D[i], D[i + d]);
    D[i] = padd_grouped(s, s);
  }
}

'''

# The mixed add calling one product function that is not inlined: the
# walk's loop body a few hundred instructions instead of thousands.
MUL_NOINLINE = r'''// 9 a (b3 = 3b = 9), by additions.
SPT_HD Fe times_b3(const Fe& a) {
  const Fe a2 = add<FQ>(a, a);
  const Fe a4 = add<FQ>(a2, a2);
  return add<FQ>(add<FQ>(a4, a4), a);
}

#if defined(__CUDA_ARCH__)
static __device__ __noinline__ Fe mul_call(const Fe& a, const Fe& b) { return mont_mul<FQ, 2>(a, b); }
#else
static inline Fe mul_call(const Fe& a, const Fe& b) { return mont_mul<FQ, 2>(a, b); }
#endif

'''
MADD_NOINLINE = r'''template <int STEP = 2>
SPT_HD Point madd(const Point& p, const Fe& x2, const Fe& y2) {
  const Fe t0 = mul_call(p.x, x2);
  const Fe t1 = mul_call(p.y, y2);
  const Fe m3 = mul_call(add<FQ>(x2, y2), add<FQ>(p.x, p.y));
  const Fe m4 = mul_call(y2, p.z);
  const Fe m5 = mul_call(x2, p.z);
  const Fe t3 = sub<FQ>(m3, add<FQ>(t0, t1));
  const Fe t4 = add<FQ>(m4, p.y);
  const Fe y3 = times_b3(add<FQ>(m5, p.x));
  const Fe t0_3 = add<FQ>(add<FQ>(t0, t0), t0);
  const Fe t2 = times_b3(p.z);
  const Fe z3 = add<FQ>(t1, t2);
  const Fe t1m = sub<FQ>(t1, t2);
  Point r;
  r.x = sub<FQ>(mul_call(t3, t1m), mul_call(t4, y3));
  r.y = add<FQ>(mul_call(t1m, z3), mul_call(y3, t0_3));
  r.z = add<FQ>(mul_call(z3, t4), mul_call(t0_3, t3));
  return r;
}

'''

# K6's round of the product (field384.cuh Group::mul), from the first
# product of the round to the shift
K6_ROUND = ("      U64 r[4], q[4], t;\n", "    }\n    return normalize(c);")
# ... with the shift's shuffles issued before the quotient is broadcast:
# the lane above's columns of a b_i, and its digit of p for m
K6_ROUND_SHIFT_EARLY = """      U64 r[4], q[4], qn[4], t;
      columns(a, W::shfl(b, i), r);
      c[0] += r[0];
      c[1] += r[1];
      const U64 above0 = W::down(c[0]), above1 = W::down(c[1]);
      resolve(c, t);
      const U64 m = W::shfl(t * U64(kNp0), 0);
      columns(m, pd, q);
      columns(m, W::down(pd), qn);
      c[0] += q[0];
      c[1] += q[1];
      const U64 out = resolve(c, t);
      c[0] = above0 + qn[0] + r[2] + q[2] + W::sel(lane == U64(0), out, U64(0));
      c[1] = above1 + qn[1] + r[3] + q[3];
"""
# A squaring that multiplies each cross product of digits once, doubled:
# in round i, 0 at lanes j < i, a_i at lane i, 2 a_j at lanes j > i, the
# operand chosen before the products (2 a_j is a_j << 1 and its top bit,
# which adds a_i one digit up) ...
K6_SQUARE_OPERAND = """      if (kSquare) {
        const U64 bi = W::shfl(b, i);
        const B above = U64(i) < lane, at = lane == U64(i);
        columns(W::sel(above, a << 1, W::sel(at, a, U64(0))), bi, r);
        const U64 top = W::sel(above, U64(0) - (a >> 63), U64(0));
        r[2] += top & (bi & kLo32);
        r[3] += top & (bi >> 32);
      } else {
        columns(a, W::shfl(b, i), r);
      }
"""
# ... or the row's products kept, doubled or dropped after they are formed.
K6_SQUARE_PRODUCTS = """      columns(a, W::shfl(b, i), r);
      if (kSquare) {
        const B above = U64(i) < lane, keep = above | (lane == U64(i));
        const U64 sh = W::sel(above, U64(1), U64(0));
#pragma unroll
        for (int k = 0; k < 4; ++k) r[k] = W::sel(keep, r[k] << sh, U64(0));
      }
"""


# The round's quotient m = t * -p^-1 mod 2^64 from the three 32-bit limb
# products it needs, in place of one 64-bit multiply
K6_QUOTIENT_LIMBS = [
    ("field384.cuh", "  // Exact digits of t = sum over lanes",
     """  static SPT384_FN U64 quotient(U64 t) {
    const U64 s = W::wide(t, U64(kNp0));
    U64 c[2] = {s & kLo32, (s >> 32) + (W::wide(t, U64(kNp0 >> 32)) & kLo32) +
                               (W::wide(t >> 32, U64(kNp0)) & kLo32)};
    U64 m;
    resolve(c, m);
    return m;
  }

  // Exact digits of t = sum over lanes"""),
    ("field384.cuh", "W::shfl(t * U64(kNp0), 0)", "W::shfl(quotient(t), 0)")]
# p and 4 R mod p read as kGroup words (the lanes above the value read the
# arrays' zeros) in place of a select
K6_CONSTANTS_PADDED = [
    ("field384.cuh", "uint64_t kP[kLanes] = {", "uint64_t kP[kGroup] = {"),
    ("field384.cuh", "uint64_t kFour[kLanes] = {", "uint64_t kFour[kGroup] = {"),
    ("field384.cuh", "    return lane() < kLanes ? digits[lane()] : 0;", "    return digits[lane()];")]


def _k6_square(body: str) -> list:
    """The edits of field384.cuh for a dedicated squaring with `body` as
    its round's first product."""
    return [("field384.cuh", "  SPT384_FN U64 mul(U64 a, U64 b) const {",
             "  template <bool kSquare = false>\n  SPT384_FN U64 mul(U64 a, U64 b) const {"),
            ("field384.cuh", "      columns(a, W::shfl(b, i), r);\n", body),
            ("field384.cuh", "SPT384_FN U64 sqr(U64 a) const { return mul(a, a); }",
             "SPT384_FN U64 sqr(U64 a) const { return mul<true>(a, a); }")]


# (name, [(file, old text, new text) | (file, (first, last), new text)],
#  {python constant: value}); a (first, last) pair replaces the text from
# `first` up to, not including, `last`.
VARIANTS = [
    ("as built", [], {}),
    ("PR 2 product (PTX CIOS, mad.lo.cc / madc.hi.cc chains)", [
        ("bn254.cuh", ("// One round of the product on the card", "#endif\n\ntemplate <int F> SPT_HD Fe add("),
         PR2_PRODUCT_DEV),
        ("bn254.cuh", ("// One round of the product (see mont_mul)", "template <int F> SPT_HD Fe zero() {"),
         PR2_PRODUCT + PR2_GROUP)], {}),
    ("complete add's products in straight-line code (STEP 8)", [
        ("bn254.cuh", "template <int STEP = 2> SPT_HD Point padd(",
         "template <int STEP = 8> SPT_HD Point padd(")], {}),
    ("complete add's products one round a loop pass (STEP 1)", [
        ("bn254.cuh", "template <int STEP = 2> SPT_HD Point padd(",
         "template <int STEP = 1> SPT_HD Point padd(")], {}),
    ("every product two rounds a loop pass (K3 and K4 too)", [
        ("bn254.cuh", "template <int F, int STEP = 8> SPT_HD Fe mont_mul(",
         "template <int F, int STEP = 2> SPT_HD Fe mont_mul(")], {}),
    ("complete add not inlined", [
        ("bn254.cuh", "template <int STEP = 2> SPT_HD Point padd(",
         "template <int STEP = 2> __host__ __device__ __noinline__ Point padd(")], {}),
    ("no PTX carry chains in add and sub", [
        ("bn254.cuh", "#if defined(__CUDA_ARCH__)\n  return add_dev", "#if 0\n  return add_dev"),
        ("bn254.cuh", "#if defined(__CUDA_ARCH__)\n  return sub_dev", "#if 0\n  return sub_dev")], {}),
    ("4-byte point loads and stores", [
        ("bn254.cuh", "#if defined(__CUDA_ARCH__)\n  const uint4* q = reinterpret_cast<const uint4*>(src);",
         "#if 0\n  const uint4* q = reinterpret_cast<const uint4*>(src);"),
        ("bn254.cuh", "#if defined(__CUDA_ARCH__)\n  uint4* q = reinterpret_cast<uint4*>(dst);",
         "#if 0\n  uint4* q = reinterpret_cast<uint4*>(dst);")], {}),
    ("K2 at 128 threads a block", [
        ("msm_kernels.cu", "constexpr int kPaddThreads = 256;", "constexpr int kPaddThreads = 128;")], {}),
    ("K2 launch bound of one block an SM (up to 255 registers)", [
        ("msm_kernels.cu", "__global__ void padd_kernel(",
         "__global__ void __launch_bounds__(256, 1) padd_kernel(")], {}),
    ("K2b blocks of up to 256 threads", [
        ("aggregate.cuh", "K2B_THREADS = 128", "K2B_THREADS = 256")], {"K2B_THREADS": 256}),
    ("K2b filling 256 blocks", [
        ("aggregate.cuh", "K2B_FILL = 128", "K2B_FILL = 256")], {"K2B_FILL": 256}),
    ("K2b filling 512 blocks", [
        ("aggregate.cuh", "K2B_FILL = 128", "K2B_FILL = 512")], {"K2B_FILL": 512}),
    ("K2b one block a window (the PR 8 geometry)", [
        ("aggregate.cuh", "K2B_FILL = 128", "K2B_FILL = 1")], {"K2B_FILL": 1}),
    ("K2b complete add in straight-line code, products one at a time (padd<8>)", [
        ("aggregate.cuh", ("// Thread t of block g of window `win`: its run", "// Thread 0 of block g"),
         K2B_BODIES_PADD8)], {}),
    ("products of each add's layers issued as one group (mont_mul_group)", [
        ("bn254.cuh", ("// 9 a (b3 = 3b = 9), by additions.", "// ---------------------------------------------------------------------------\n// memory layouts"),
         GROUPED_ADDS),
        ("aggregate.cuh", ("// Thread t of block g of window `win`: its run", "// Thread 0 of block g"),
         K2B_BODIES_GROUPED)], {}),
    ("mixed add's products in straight-line code (STEP 8)", [
        ("bn254.cuh", "template <int STEP = 2>\nSPT_HD Point madd(",
         "template <int STEP = 8>\nSPT_HD Point madd(")], {}),
    ("mixed add's products one round a loop pass (STEP 1)", [
        ("bn254.cuh", "template <int STEP = 2>\nSPT_HD Point madd(",
         "template <int STEP = 1>\nSPT_HD Point madd(")], {}),
    ("mixed add's products not inlined", [
        ("bn254.cuh", ("// 9 a (b3 = 3b = 9), by additions.", "template <int STEP = 2>\nSPT_HD Point madd("),
         MUL_NOINLINE),
        ("bn254.cuh", ("template <int STEP = 2>\nSPT_HD Point madd(", "// ---------------------------------------------------------------------------\n// memory layouts"),
         MADD_NOINLINE)], {}),
    ("K2b filling 64 blocks", [
        ("aggregate.cuh", "K2B_FILL = 128", "K2B_FILL = 64")], {"K2B_FILL": 64}),
    ("K2b W and D merges on alternate lanes of one warp (the PR 3 mapping)", [
        ("aggregate.cuh", ("SPT_HD void k2b_merge(", "// Thread 0 of block g"), K2B_LANE_MERGE)], {}),
    ("K1 fixed walk at 4 blocks an SM", [
        ("msm_kernels.cu", "constexpr int K1F_MIN_BLOCKS = 3;",
         "constexpr int K1F_MIN_BLOCKS = 4;")], {}),
    ("K1 fixed walk at 2 blocks an SM", [
        ("msm_kernels.cu", "constexpr int K1F_MIN_BLOCKS = 3;",
         "constexpr int K1F_MIN_BLOCKS = 2;")], {}),
    ("K1 fixed walk, two running sums a thread, 6 blocks of 64 an SM", [
        ("bucket.cuh", "constexpr int K1F_LANES = 1;", "constexpr int K1F_LANES = 2;"),
        ("msm_kernels.cu", "constexpr int K1F_MIN_BLOCKS = 3;",
         "constexpr int K1F_MIN_BLOCKS = 6;")], {}),
    ("K1 fixed walk, two running sums a thread, 8 blocks of 64 an SM", [
        ("bucket.cuh", "constexpr int K1F_LANES = 1;", "constexpr int K1F_LANES = 2;"),
        ("msm_kernels.cu", "constexpr int K1F_MIN_BLOCKS = 3;",
         "constexpr int K1F_MIN_BLOCKS = 8;")], {}),
    ("K1 fixed walk, two running sums a thread, 4 blocks of 64 an SM", [
        ("bucket.cuh", "constexpr int K1F_LANES = 1;", "constexpr int K1F_LANES = 2;"),
        ("msm_kernels.cu", "constexpr int K1F_MIN_BLOCKS = 3;",
         "constexpr int K1F_MIN_BLOCKS = 4;")], {}),
    ("K1 walk at 4 blocks an SM", [(
        "msm_kernels.cu", "__launch_bounds__(spt::K1_THREADS, 3)",
        "__launch_bounds__(spt::K1_THREADS, 4)")], {}),
    ("K1 walk slots filled by plain loads", [
        ("bucket.cuh", "#if defined(__CUDA_ARCH__)\n  const uint32_t dst", "#if 0\n  const uint32_t dst"),
        ("bucket.cuh", "#if defined(__CUDA_ARCH__)\n  if (pending)", "#if 0\n  if (pending)")], {}),
    ("K1 walk with two points in flight ahead", _k1_stage_ahead(2), {}),
    ("K1 walk with three points in flight ahead", _k1_stage_ahead(3), {}),
    ("K1 walk without its tree (timing only: its sums are wrong)", [(
        "msm_kernels.cu",
        "    if ((t & (2 * d - 1)) == 0) spt::k1_merge(&nodes[t], &nodes[t + d], out);\n",
        "")], {}),
    ("K1 segments of 16", [("bucket.cuh", "K1_SEG = 32", "K1_SEG = 16")], {}),
    ("K1 segments of 64", [("bucket.cuh", "K1_SEG = 32", "K1_SEG = 64")], {}),
    ("K1 plan blocks of 2^16 points", [], {"PLAN_POINTS": 1 << 16}),
    ("K4 plan tmax 11, tiles 2^11", [], {"TMAX": 11, "TILE_LOG": 11}),
    ("K4 plan tmax 11, tiles 2^10", [], {"TMAX": 11, "TILE_LOG": 10}),
    ("K4 plan tmax 12, tiles 2^12", [], {"TMAX": 12, "TILE_LOG": 12}),
    ("K4 512 threads", [("field_kernels.cu", "constexpr int kThreads = 256;",
                         "constexpr int kThreads = 512;")], {}),
    ("K6 shift shuffles before the quotient's broadcast", [
        ("field384.cuh", K6_ROUND, K6_ROUND_SHIFT_EARLY)], {}),
    ("K6 dedicated squaring, operand chosen", _k6_square(K6_SQUARE_OPERAND), {}),
    ("K6 dedicated squaring, products chosen", _k6_square(K6_SQUARE_PRODUCTS), {}),
    ("K6 quotient by limb products", K6_QUOTIENT_LIMBS, {}),
    ("K6 constants padded to the group", K6_CONSTANTS_PADDED, {}),
    ("K6 quotient by limb products, constants padded to the group",
     K6_QUOTIENT_LIMBS + K6_CONSTANTS_PADDED, {}),
    ("K6 blocks of 64 threads", [
        ("field384_kernels.cu", "constexpr int kThreads = 32;", "constexpr int kThreads = 64;")],
     {}),
    ("K6 probe: no shift shuffle (timing only: wrong results)", [
        ("field384.cuh", "c[0] = W::down(c[0])", "c[0] = c[0]"),
        ("field384.cuh", "c[1] = W::down(c[1])", "c[1] = c[1]")], {}),
    ("K6 probe: no quotient broadcast (timing only: wrong results)", [
        ("field384.cuh", "W::shfl(t * U64(kNp0), 0)", "t * U64(kNp0)")], {}),
    ("K6 probe: no carry look-ahead (timing only: wrong results)", [
        ("field384.cuh", "    return (p + (g << 1)) ^ p;", "    return g << 1;")], {}),
    ("K7 blocks of 4 warps", [
        ("field_mxu_kernels.cu", "constexpr int kWarps = 8;", "constexpr int kWarps = 4;")], {}),
    ("K8 blocks of 8 warps at every length", [
        ("ntt_matmul_kernels.cu", "kWarpsOf = LOGL >= 6 ? 8 : 16;", "kWarpsOf = 8;")], {}),
    ("K8 one m-tile a sweep", [
        ("ntt_matmul_kernels.cu", "constexpr int MT = MT_ALL < 2 ? MT_ALL : 2;",
         "constexpr int MT = 1;")], {}),
    ("K8 k-steps not unrolled", [
        ("ntt_matmul_kernels.cu", "#pragma unroll 4\n      for (int j = 0; j < L; ++j) {",
         "#pragma unroll 1\n      for (int j = 0; j < L; ++j) {")], {}),
    ("K8 k-steps unrolled by 2", [
        ("ntt_matmul_kernels.cu", "#pragma unroll 4\n      for (int j = 0; j < L; ++j) {",
         "#pragma unroll 2\n      for (int j = 0; j < L; ++j) {")], {}),
    ("K8 4-byte loads and stores of points", [
        ("ntt_matmul_kernels.cu", "load16(a.tw", "spt::load_fe(a.tw"),
        ("ntt_matmul_kernels.cu", "        store16(a.out", "        spt::store_fe(a.out")], {}),
    ("K8 probe: no twiddle product (timing only: wrong results)", [
        ("ntt_matmul_kernels.cu",
         "        if (a.tw != nullptr) y = spt::mont_mul<spt::FR>(y, load16(a.tw + 8 * ((u << LOGL) + k)));\n",
         "")], {}),
    ("K8 probe: no REDC (timing only: wrong results)", [
        ("ntt_matmul_kernels.cu", "        spt::Fe y = redc272(s);",
         "        spt::Fe y;\n#pragma unroll\n        for (int q = 0; q < 8; ++q)"
         " y.v[q] = (uint32_t)s[q] ^ (uint32_t)s[q + 8];")], {}),
    ("K8 probe: the products alone, no epilogue (timing only: wrong results)", [
        ("ntt_matmul_kernels.cu", ("      // rows 16 mt + g (+ 8): word", "  asm volatile(\"cp.async.wait_group 0;\""),
         "      uint32_t xs = 0;\n"
         "#pragma unroll\n      for (int mt = 0; mt < MT; ++mt)\n"
         "#pragma unroll\n        for (int nt = 0; nt < 8; ++nt)\n"
         "          xs ^= acc[mt][nt][0] ^ acc[mt][nt][1] ^ acc[mt][nt][2] ^ acc[mt][nt][3];\n"
         "      if (xs == 0x9e3779b9u) a.out[lane] = xs;\n"
         "    }\n  }\n")], {}),
]

# the libraries of the tensor-core kernels (K7, K8), timed apart from the rest
MXU_LIBS = ("field_mxu_kernels", "ntt_matmul_kernels")


def _edit(text: str, old, new: str, where: str) -> str:
    if isinstance(old, tuple):
        first, last = old
        a = text.find(first)
        b = text.find(last, a)
        if a < 0 or b < 0:
            raise RuntimeError(f"{where}: {first!r} .. {last!r} not found")
        return text[:a] + new + text[b:]
    if old not in text:
        raise RuntimeError(f"{where}: {old!r} not found")
    return text.replace(old, new)


def _touched(KL, d: str, files) -> list:
    """The libraries whose .cu file, or a header it includes (directly or
    through another header), is among `files`."""
    out = []
    for lib, (src, _) in KL.LIBRARIES.items():
        seen, todo = set(), [src]
        while todo:
            f = todo.pop()
            if f not in seen:
                seen.add(f)
                with open(os.path.join(d, f)) as fh:
                    todo += re.findall(r'#include "(\w+\.cuh)"', fh.read())
        if seen & set(files):
            out.append(lib)
    return out


def _build(KL, root: str, chosen) -> dict:
    """Builds each chosen variant's copy of the sources (the sources' own,
    variant 0, every library); returns {variant: the libraries built}."""
    procs, built = [], {}
    for i in chosen:
        _, edits, _ = VARIANTS[i]
        d = os.path.join(root, str(i))
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(KL.CSRC, d)
        for f, old, new in edits:
            path = os.path.join(d, f)
            text = _edit(open(path).read(), old, new, f"variant {i}, {f}")
            with open(path, "w") as fh:
                fh.write(text)
        built[i] = list(KL.LIBRARIES) if i == 0 else _touched(KL, d, {f for f, _, _ in edits})
        for lib in built[i]:
            cmd = [KL._nvcc(), *KL.NVCC_FLAGS, "-I", d, "-o",
                   os.path.join(d, f"{lib}.so"), os.path.join(d, f"{lib}.cu")]
            log = open(os.path.join(d, f"{lib}.log"), "w")
            procs.append((subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), log, cmd))
    for proc, log, cmd in procs:
        rc = proc.wait()
        log.close()
        if rc:
            with open(log.name) as fh:
                tail = fh.read()[-3000:]
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{tail}")
    return built


def _dirs(KL, root: str, i: int, built: dict) -> dict:
    """{library: the directory of the build variant i runs}: its own for the
    libraries it rebuilt, the sources' for the others."""
    return {lib: os.path.join(root, str(i if lib in built[i] else 0)) for lib in KL.LIBRARIES}


def _use(KL, dirs: dict) -> None:
    for lib, (_, fns) in KL.LIBRARIES.items():
        h = ctypes.CDLL(os.path.join(dirs[lib], f"{lib}.so"))
        for fn, argtypes in fns.items():
            getattr(h, fn).argtypes = argtypes
            getattr(h, fn).restype = ctypes.c_int
        KL._loaded[lib] = h


def _spills(log_path: str) -> dict:
    """{mangled kernel name: spill store bytes} from a build log."""
    out, entry = {}, None
    with open(log_path) as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = m.group(1)
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and entry:
                out[entry] = int(m.group(1))
    return out


def _static(KL, dirs: dict) -> dict:
    """The probe kernel's SASS instruction count and the registers (and
    spill stores) of the K1c, K1c_fixed, K2 and K2b kernels of one build."""
    sass = KL.sass_opcodes(os.path.join(dirs["field_kernels"], "field_kernels.so"))
    probe = next(v for k, v in sass.items() if "mont_mul_probe_kernel" in k)
    log = os.path.join(dirs["msm_kernels"], "msm_kernels.log")
    regs, spills = KL.ptxas_registers(log), _spills(log)
    out = {"product SASS": sum(probe.values())}
    for rec, sym in (("K1c", "k1_walk_kernel"), ("K1c_fixed", "k1_fixed_walk_kernel"),
                     ("K2", "padd_kernel"), ("K2b", "k2b_aggregate_kernel")):
        name = next(k for k in regs if sym in k)
        out[f"{rec} registers"] = regs[name]
        out[f"{rec} spill bytes"] = spills.get(name, 0)
    return out


def _static_k6(KL, dirs: dict) -> dict:
    """K6's SASS instruction count, registers, stack frame and spill stores
    a thread."""
    d = dirs["field384_kernels"]
    sass = KL.sass_opcodes(os.path.join(d, "field384_kernels.so"))
    log = os.path.join(d, "field384_kernels.log")
    regs, spills = KL.ptxas_registers(log), _spills(log)
    with open(log) as fh:
        stack = re.search(r"(\d+) bytes stack frame", fh.read())
    name = next(k for k in regs if "g1_sqrt_kernel" in k)
    return {"K6 SASS": sum(next(v for k, v in sass.items() if "g1_sqrt_kernel" in k).values()),
            "K6 registers": regs[name], "K6 stack bytes": int(stack.group(1)) if stack else None,
            "K6 spill bytes": spills.get(name, 0)}


def _static_mxu(KL, dirs: dict) -> dict:
    """The registers, stack frame and spill stores a thread of K7 and of
    K8's pass at 2^5 points."""
    out = {}
    for lib, rec, sym in (("field_mxu_kernels", "K7", "mont_mul_mxu_kernelILi1E"),
                          ("ntt_matmul_kernels", "K8", "dft_pass_kernelILi5E")):
        log = os.path.join(dirs[lib], f"{lib}.log")
        regs, spills = KL.ptxas_registers(log), _spills(log)
        name = next(k for k in regs if sym in k)
        out[f"{rec} registers"] = regs[name]
        out[f"{rec} spill bytes"] = spills.get(name, 0)
    return out


def _k6_input(F384, dev):
    """The committee's 512 keys' x: seeded points and their negations."""
    import random

    from chip_smoke import COMMITTEE_KEYS
    from spectre_tpu_torch.fields import bls12_381 as bls

    g1 = bls.g1_curve
    q = g1.mul(bls.G1_GEN, random.Random(1).randrange(1, bls.R))
    keys, pt = [], q
    while len(keys) < COMMITTEE_KEYS:
        keys += [bls.g1_compress(pt), bls.g1_compress(g1.neg(pt))]
        pt = g1.add(pt, q)
    return F384.bls_fq_ctx().to_tensor(
        [int.from_bytes(bytes([k[0] & 0x1F]) + k[1:], "big") for k in keys], dev)


def main(argv=None) -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from spectre_tpu_torch.fields import bn254
    from spectre_tpu_torch.ops import (ec, field384 as F384, field_mxu as MX, field_ops as F,
                                       kernel_lib as KL, msm as M, msm_kernels as MK, ntt as N)
    from spectre_tpu_torch.plonk.srs import g1_powers_device

    want = sys.argv[1:] if argv is None else argv
    chosen = [i for i, (name, _, _) in enumerate(VARIANTS)
              if i == 0 or not want or any(w in name for w in want)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"gpu: {smi}", flush=True)
    root = os.path.join(os.path.dirname(KL.BUILD_DIR), "kernel_variants")
    built = _build(KL, root, chosen)
    dev = torch.device("cuda")
    fr = F.fr_ctx()
    gen = torch.Generator(device=dev).manual_seed(1)

    def rnd(n):
        x = torch.randint(-(1 << 63), (1 << 63) - 1, (n, 4), generator=gen,
                          dtype=torch.int64, device=dev)
        x[:, 3] &= (1 << 61) - 1
        return x

    def ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    def touches_bn254(i):
        return i == 0 or bool(VARIANTS[i][2]) or any(
            lib not in ("field384_kernels", *MXU_LIBS) for lib in built[i])

    tables = N.Twiddles(dev)
    # K7 and K8 at their main path's shapes, K3's and K4's results the
    # references
    a23, b23 = F.to_mont(fr, rnd(1 << 23)), F.to_mont(fr, rnd(1 << 23))
    x10 = F.to_mont(fr, rnd(1 << 20)).reshape(1024, 1024, 4)
    w10 = bn254.fr_root_of_unity(10)
    _use(KL, _dirs(KL, root, 0, built))
    ref_k7 = F.mont_mul_cios(fr, a23, b23)
    ref_k8 = N.ntt_passes(x10, tables.twiddles(w10, 1024))
    if any(touches_bn254(i) for i in chosen):
        n = 1 << 21
        pts = g1_powers_device(12345, n, dev)
        c = M.default_window_pallas(n)
        nwin, nb = M.num_windows(c), 1 << (c - 1)
        negs = torch.zeros((1, n), dtype=torch.int32, device=dev)
        digits = {k: M.signed_digit_stream(sc, c, nwin)
                  for k, sc in (("random", rnd(n)), ("all-equal", rnd(1).repeat(n, 1)))}
        x23 = F.to_mont(fr, rnd(1 << 23)).reshape(1, 1 << 23, 4)
        tw23 = tables.twiddles(bn254.fr_root_of_unity(23), 1 << 23)
        xb = F.to_mont(fr, rnd(16 << 21)).reshape(16, 1 << 21, 4)
        twb = tables.twiddles(bn254.fr_root_of_unity(21), 1 << 21)
        a2, b2 = pts, torch.roll(pts, 1, 0)
        ref_k1 = {k: ec.normalize_std(MK.bucket_sums_aos32(pts, d, negs, c))
                  for k, d in digits.items()}
        ref_k4 = N.ntt_passes(x23, tw23)
        sums = MK.padd_aos32(pts[:nwin * nb], pts[nwin * nb:2 * nwin * nb])
        ref_k2b = ec.normalize_std(MK.aggregate_buckets_aos32(sums, nwin, nb))
        sums1 = MK.padd_aos32(pts[:4096], pts[4096:8192])
        ref_k2b1 = ec.normalize_std(MK.aggregate_buckets_aos32(sums1, 1, 4096))
        # the fixed form at the step's geometry: the normalised table of the
        # 2^21 points (2^22 GLV rows, c = 13, 10 windows), GLV digits of random
        # scalars, the plan made once
        cf = M.default_window_pallas(2 * n, signed=True)
        nwf = M.num_windows(cf, 126)
        table = M.build_window_table(pts, cf, nwf)
        mags, fnegs = M.glv_scalars(rnd(n))
        fdig = M.signed_digits(mags, cf, nwf)
        del mags
        rows = table.reshape(-1, 24)
        _, fbstart, fentries = MK.bucket_plan(fdig, fnegs, cf, fixed=True)
        ref_fixed = ec.normalize_std(MK.bucket_walk_fixed(rows, fentries, fbstart))
    xk6 = _k6_input(F384, dev)
    ref_k6 = F384.decompress_y_plain(xk6)
    consts = {"PLAN_POINTS": MK, "TMAX": N, "TILE_LOG": N, "K2B_THREADS": MK,
              "K2B_FILL": MK}
    for i in chosen:
        name, _, pyconst = VARIANTS[i]
        dirs = _dirs(KL, root, i, built)
        _use(KL, dirs)
        bn254_kernels = touches_bn254(i)
        k6 = i == 0 or "field384_kernels" in built[i]
        mxu = i == 0 or any(lib in MXU_LIBS for lib in built[i])
        saved = {k: getattr(consts[k], k) for k in pyconst}
        for k, v in pyconst.items():
            setattr(consts[k], k, v)
        plan = N.ntt_plan
        N.ntt_plan = lambda logn, f=plan: f(logn, N.TMAX, N.TILE_LOG)
        try:
            row = {"variant": name}
            if k6:
                row.update(_static_k6(KL, dirs))
                y, ok = F384.decompress_y(xk6)
                row["K6 equal"] = bool(torch.equal(y, ref_k6[0]) and torch.equal(ok, ref_k6[1]))
                row["K6 512 keys ms"] = ms(lambda: F384.decompress_y(xk6), 50)
            if mxu:
                row.update(_static_mxu(KL, dirs))
                row["K7 2^23 equal"] = bool(torch.equal(MX.mont_mul(fr, a23, b23),
                                                        ref_k7))
                row["K7 2^23 ms"] = ms(lambda: MX.mont_mul(fr, a23, b23), 10)
                row["K8 [1024, 2^10] equal"] = bool(torch.equal(N.dft_matmul(x10, tables, w10),
                                                                ref_k8))
                row["K8 [1024, 2^10] ms"] = ms(lambda: N.dft_matmul(x10, tables, w10), 10)
                lib8, src, out8 = KL.library("ntt_matmul_kernels"), x10, torch.empty_like(x10)
                for j, ps in enumerate(N.dft_plan(10)):
                    frag = tables.dft_fragments(ps.logl, pow(w10, 1024 >> ps.logl, N.R))
                    tw = tables.twiddle_matrix(10 - ps.logl, ps.logl, w10) if ps.twiddled else None
                    row[f"K8 pass {j} ms"] = ms(lambda: lib8.spt_ntt_dft_pass(
                        src.data_ptr(), out8.data_ptr(), frag.data_ptr(),
                        None if tw is None else tw.data_ptr(), 1024, 10, ps.logl, ps.bu_in,
                        ps.s_in, ps.bu_out, ps.s_out, KL.stream_of(src)), 10)
            if bn254_kernels:
                row.update(_static(KL, dirs))
                for k, d in digits.items():
                    same = torch.equal(ec.normalize_std(MK.bucket_sums_aos32(pts, d, negs, c)), ref_k1[k])
                    row[f"K1 {k} ms"] = ms(lambda: MK.bucket_sums_aos32(pts, d, negs, c), 3)
                    row[f"K1 {k} equal"] = bool(same)
                row["K4 2^23 equal"] = bool(torch.equal(N.ntt_passes(x23, tw23), ref_k4))
                row["K4 2^23 ms"] = ms(lambda: N.ntt_passes(x23, tw23), 5)
                row["K4 16x2^21 ms"] = ms(lambda: N.ntt_passes(xb, twb), 3)
                row["K4 passes 2^23"] = N.ntt_plan(23)
                row["K2 2^21 ms"] = ms(lambda: MK.padd_aos32(a2, b2), 5)
                row["K2b equal"] = bool(torch.equal(
                    ec.normalize_std(MK.aggregate_buckets_aos32(sums, nwin, nb)), ref_k2b))
                row["K2b 24x1024 ms"] = ms(lambda: MK.aggregate_buckets_aos32(sums, nwin, nb), 10)
                row["K2b 1x4096 equal"] = bool(torch.equal(
                    ec.normalize_std(MK.aggregate_buckets_aos32(sums1, 1, 4096)), ref_k2b1))
                row["K2b 1x4096 ms"] = ms(lambda: MK.aggregate_buckets_aos32(sums1, 1, 4096), 10)
                row["K1c_fixed equal"] = bool(torch.equal(
                    ec.normalize_std(MK.bucket_walk_fixed(rows, fentries, fbstart)), ref_fixed))
                row["K1c_fixed walk ms"] = ms(lambda: MK.bucket_walk_fixed(rows, fentries, fbstart), 3)
                row["K1-fixed wrapper ms"] = ms(
                    lambda: MK.bucket_sums_fixed_aos32(table, fdig, fnegs, cf), 3)
                row["K3 2^23 ms"] = ms(lambda: F.mont_mul(fr, x23.reshape(-1, 4), ref_k4.reshape(-1, 4)), 10)
        finally:
            N.ntt_plan = plan
            for k, v in saved.items():
                setattr(consts[k], k, v)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
