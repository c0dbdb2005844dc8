// K1: Pippenger signed-digit bucket sums, as four kernels (msm_kernels.cu)
// over the per-block bodies here. `__host__ __device__`, so that a host
// compiler can run a block's threads one after another:
// tests/test_torch_csrc_host.py drives these bodies over every block and
// segment and holds them against the plain versions in ops/msm_kernels.py.
//
// A (window w, point i) pair with digit d != 0 goes to bucket key
// K = w * nb + |d| - 1 as the entry i | sign << 31, sign = (d < 0) xor
// negs[i] (in the fixed-base form, where each window reads its own table,
// the entry (w * n + i) | sign << 31; nothing after the scatter tells the
// two forms apart). The four steps:
//
//   K1a count    per (window, block of P points) histogram of the keys in
//                shared memory, written to counts[K * nblk + block]; an
//                exclusive scan of that array (torch.cumsum) gives each
//                block's first slot per key and, at block 0, the bucket
//                boundaries bstart[K] (bstart[nkeys] = E, the entry count).
//   K1b scatter  the same blocks place their entries at those slots (a
//                counting sort by key; the order inside a bucket is the
//                order of shared-memory atomics and does not matter).
//   K1c walk     the E sorted entries cut into equal segments of SEG, one
//                per thread of a block of THREADS. A thread adds its
//                points into a partial sum (the next entry's point copied
//                into shared memory by cp.async meanwhile, so the random
//                96-byte gathers hide behind the adds) and starts a new one
//                where the key changes; a run bounded on both sides inside the
//                segment is a whole bucket and is written out at once. The
//                first and last run of every thread go to a node in shared
//                memory, and a tree over the block's nodes adds runs of one
//                key that meet at a node boundary (one complete add per
//                merge, at most). At the root, a run whose bucket lies
//                inside the block is written out; the first or last run of
//                a bucket that crosses the block's ends is a piece, stored
//                at slot 2 * block (first run) or 2 * block + 1 (last run).
//   K1d pieces   one warp per key: a bucket that touches several blocks
//                sums its pieces (a strided sum per lane, then a shuffle
//                tree); an empty bucket is set to infinity.
//
// Every bucket is written exactly once: by K1c if it lies inside one block,
// by K1d otherwise.
#pragma once

#include "bn254.cuh"

namespace spt {

constexpr int K1_SEG = 32;          // sorted entries per walk thread
constexpr int K1_THREADS = 128;     // walk threads per block
// a thread's two staging slots of 24 words, padded to 52 so that 16-byte
// shared loads of 8 neighbouring threads fall on distinct banks
constexpr int K1_STAGE_WORDS = 52;
constexpr long K1_BLOCK_ENTRIES = (long)K1_SEG * K1_THREADS;

SPT_HD int iabs(int d) { return d < 0 ? -d : d; }

// --- K1a / K1b: the plan ---------------------------------------------------

// Count the digits of window w, points [i0, i1), into hist[nb].
SPT_HD void k1_count_points(int w, long i0, long i1, long tid, long nthr,
                            const int32_t* digits, long n, int32_t* hist) {
  for (long i = i0 + tid; i < i1; i += nthr) {
    const int d = digits[w * n + i];
    if (d != 0) SPT_ATOMIC_ADD(&hist[iabs(d) - 1], 1);
  }
}

// Place the entries of window w, points [i0, i1), at cursor[|d| - 1]++.
// The entry names point row w * stride + i: stride 0 for a base shared by
// every window, n for the fixed-base form, whose [nwin * n, 24] table holds
// window w's own points T[w] at rows [w * n, (w + 1) * n). The wrapper
// keeps nwin * n below 2^31, so the row fits beside the sign bit.
SPT_HD void k1_scatter_points(int w, long i0, long i1, long tid, long nthr,
                              const int32_t* digits, const int32_t* negs,
                              long n, long stride, int32_t* cursor,
                              int32_t* entries) {
  const uint32_t row0 = (uint32_t)(w * stride);
  for (long i = i0 + tid; i < i1; i += nthr) {
    const int d = digits[w * n + i];
    if (d == 0) continue;
    const uint32_t sign = (uint32_t)((d < 0) != (negs[i] != 0));
    const int pos = SPT_ATOMIC_ADD(&cursor[iabs(d) - 1], 1);
    entries[pos] = (int32_t)((row0 + (uint32_t)i) | (sign << 31));
  }
}

// --- K1c: the walk ------------------------------------------------------------

// A thread's (and, up the tree, a group of threads') first and last run.
struct K1Node {
  int32_t fk, lk;    // keys of the first and last run
  int32_t single;    // one run only: f is it, l is unused
  int32_t valid;     // holds any entry
  Point f, l;
};

// The key whose bucket holds entry position pos: the largest k in [lo, hi]
// with bstart[k] <= pos (buckets may be empty, bstart non-decreasing).
SPT_HD int k1_find_key(const int32_t* bstart, int lo, int hi, long pos) {
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (bstart[mid] <= pos) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Start copying the point of entry e into a 96-byte slot in shared memory:
// cp.async on the card, which holds no registers while the copy is in
// flight; a plain copy on the host.
SPT_HD void k1_stage(uint32_t* slot, const uint32_t* pts, int32_t e) {
  const uint32_t* src = pts + 24 * (long)(e & 0x7fffffff);
#if defined(__CUDA_ARCH__)
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(slot);
#pragma unroll
  for (int i = 0; i < 6; ++i)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst + 16 * i),
                 "l"(src + 4 * i));
  asm volatile("cp.async.commit_group;");
#else
  for (int i = 0; i < 24; ++i) slot[i] = src[i];
#endif
}

// The point of entry e from its slot once its copy (and every earlier one
// but the last `pending`) has landed, negated where the entry says so.
SPT_HD Point k1_staged_point(const uint32_t* slot, int32_t e, bool pending) {
#if defined(__CUDA_ARCH__)
  if (pending)
    asm volatile("cp.async.wait_group 1;" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;" ::: "memory");
#else
  (void)pending;
#endif
  const Point p = load_point(slot);
  return e < 0 ? neg(p) : p;
}

// Thread t of walk block blk: walk entries [s, min(s + SEG, E)). `stage` is
// the thread's two 24-word point slots: the point of the next entry is
// copied into one while the point in the other is added.
SPT_HD void k1_walk_thread(long blk, long t, const uint32_t* pts,
                           const int32_t* entries, const int32_t* bstart,
                           int nkeys, uint32_t* out, K1Node* node,
                           uint32_t* stage) {
  const long E = bstart[nkeys];
  const long s = blk * K1_BLOCK_ENTRIES + t * K1_SEG;
  const long e_end = s + K1_SEG < E ? s + K1_SEG : E;
  node->valid = s < E;
  if (!node->valid) return;
  int32_t cur = entries[s];
  k1_stage(stage, pts, cur);
  int32_t next = s + 1 < e_end ? entries[s + 1] : 0;
  if (s + 1 < e_end) k1_stage(stage + 24, pts, next);
  int key = k1_find_key(bstart, 0, nkeys - 1, s);
  long bend = bstart[key + 1];
  Point acc = k1_staged_point(stage, cur, s + 1 < e_end);
  int runs = 0;
  for (long pos = s + 1; pos < e_end; ++pos) {
    const int slot = (int)((pos - s) & 1);
    cur = next;
    const bool more = pos + 1 < e_end;
    if (more) {   // the other slot held the point just added
      next = entries[pos + 1];
      k1_stage(stage + 24 * (slot ^ 1), pts, next);
    }
    const Point p = k1_staged_point(stage + 24 * slot, cur, more);
    if (pos < bend) {
      acc = padd(acc, p);
      continue;
    }
    if (runs == 0) {       // the first run: resolved up the tree
      node->fk = key;
      node->f = acc;
    } else {               // bounded on both sides: a whole bucket
      store_point(out + 24 * (long)key, acc);
    }
    ++runs;
    key = k1_find_key(bstart, key + 1, nkeys - 1, pos);
    bend = bstart[key + 1];
    acc = p;
  }
  if (runs == 0) {
    node->fk = node->lk = key;
    node->single = 1;
    node->f = acc;
  } else {
    node->lk = key;
    node->single = 0;
    node->l = acc;
  }
}

// Merge node R (the next group) into node L. The runs that meet at the
// boundary are added if they share a key; a run bounded on both sides by
// other runs of the merged group is a whole bucket and is written out.
SPT_HD void k1_merge(K1Node* L, const K1Node* R, uint32_t* out) {
  if (!R->valid) return;
  if (L->lk == R->fk) {
    const Point mid = padd(L->single ? L->f : L->l, R->f);
    if (L->single && R->single) {
      L->f = mid;
    } else if (L->single) {
      L->f = mid;
      L->lk = R->lk;
      L->l = R->l;
      L->single = 0;
    } else if (R->single) {
      L->l = mid;
    } else {
      store_point(out + 24 * (long)L->lk, mid);
      L->lk = R->lk;
      L->l = R->l;
    }
    return;
  }
  if (!L->single) store_point(out + 24 * (long)L->lk, L->l);
  if (!R->single) store_point(out + 24 * (long)R->fk, R->f);
  L->lk = R->lk;
  L->l = R->single ? R->f : R->l;
  L->single = 0;
}

// The block's root node: runs whose bucket lies inside the block's entries
// [B0, B0 + BLOCK) are written out, the others become pieces.
SPT_HD void k1_root(long blk, const K1Node* root, const int32_t* bstart,
                    uint32_t* out, uint32_t* pieces) {
  if (!root->valid) return;
  const long b0 = blk * K1_BLOCK_ENTRIES, b1 = b0 + K1_BLOCK_ENTRIES;
  const bool head_in = bstart[root->fk] >= b0;
  if (root->single) {
    if (head_in && bstart[root->fk + 1] <= b1)
      store_point(out + 24 * (long)root->fk, root->f);
    else
      store_point(pieces + 24 * (2 * blk), root->f);
    return;
  }
  store_point(head_in ? out + 24 * (long)root->fk : pieces + 24 * (2 * blk),
              root->f);
  store_point(bstart[root->lk + 1] <= b1 ? out + 24 * (long)root->lk
                                         : pieces + 24 * (2 * blk + 1),
              root->l);
}

// --- K1d: pieces ------------------------------------------------------------

// Blocks [first, last] that bucket `key` touches; last < first if empty.
SPT_HD void k1_bucket_blocks(int key, const int32_t* bstart, long* first,
                             long* last) {
  const long bs = bstart[key], be = bstart[key + 1];
  *first = bs / K1_BLOCK_ENTRIES;
  *last = be > bs ? (be - 1) / K1_BLOCK_ENTRIES : *first - 1;
}

// The piece of `key` held by block b of its blocks [first, last]: the first
// block holds the bucket as its last run (slot 1) unless the bucket starts
// exactly at the block's start; every later block as its first run.
SPT_HD Point k1_piece(int key, long b, long first, const int32_t* bstart,
                      const uint32_t* pieces) {
  const long slot = (b == first && bstart[key] > b * K1_BLOCK_ENTRIES) ? 1 : 0;
  return load_point(pieces + 24 * (2 * b + slot));
}

// Lane `lane` of `nlanes` (lane < number of pieces): the sum of pieces
// first + lane, first + lane + nlanes, ... of a bucket spanning first < last.
SPT_HD Point k1_pieces_lane(int key, long first, long last, int lane,
                            int nlanes, const int32_t* bstart,
                            const uint32_t* pieces) {
  Point acc = k1_piece(key, first + lane, first, bstart, pieces);
  for (long b = first + lane + nlanes; b <= last; b += nlanes)
    acc = padd(acc, k1_piece(key, b, first, bstart, pieces));
  return acc;
}

}  // namespace spt
