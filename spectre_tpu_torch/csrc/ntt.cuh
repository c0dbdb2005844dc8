// K4: the radix-2 NTT over Fr as passes of up to t stages, each pass held in
// shared memory. The per-block bodies, `__host__ __device__` so that a host
// compiler can run a block's threads one after another (the kernel is in
// field_kernels.cu; tests/test_torch_csrc_host.py drives these bodies over
// every tile and holds them against the plain versions in ops/ntt.py).
//
// The transform is decimation in time on the bit-reversed input: stage s
// pairs rows i and i + 2^s inside each block of 2^(s+1) rows, twisting the
// upper one by omega_n^(j n / 2^(s+1)), j = i mod 2^s. Stages s0 .. s0+t-1
// only mix the row bits s0 .. s0+t-1, so a pass holds tiles of T = 2^t rows
// at stride 2^s0 (fixed high bits `hi` and low bits `lo`), and a block takes
// C = 2^logc adjacent `lo` columns at once so that every row of its tile is
// C x 32 contiguous bytes in memory. The first pass (s0 = 0) reads the input
// in natural order: tile g of the bit-reversed array is the input column
// o = bitrev(g) at stride n / T, element m' landing at tile row bitrev(m'),
// so no separate permutation runs. Input and output are natural order.
//
// Shared memory holds C columns of T + 1 elements (the padding element
// spreads the columns over the banks), 8 words each.
#pragma once

#include "bn254.cuh"

namespace spt {

struct NttPass {
  long n;      // transform size 2^logn
  int logn;
  int s0;      // first stage of the pass; 0 = the first pass
  int t;       // stages in the pass: tiles of T = 2^t rows
  int logc;    // columns per block: C = 2^logc
};

SPT_HD long ntt_tile_elems(const NttPass& g) {
  return (1L << g.logc) * ((1L << g.t) + 1);
}

// blocks per transform (a batch row)
SPT_HD long ntt_blocks(const NttPass& g) { return g.n >> (g.t + g.logc); }

SPT_HD long ntt_smem_pos(const NttPass& g, long c, long m) {
  return c * ((1L << g.t) + 1) + m;
}

// Row (in the transform) of tile element (c, m) of block blk, for a pass
// with s0 > 0: rows hi * 2^(s0+t) + m * 2^s0 + lo, lo = lg * C + c.
SPT_HD long ntt_row(const NttPass& g, long blk, long c, long m) {
  const int lgbits = g.s0 - g.logc;
  const long hi = blk >> lgbits, lg = blk & ((1L << lgbits) - 1);
  return (hi << (g.s0 + g.t)) + (m << g.s0) + (lg << g.logc) + c;
}

// Load phase: every element of the tile, two 16-byte halves each;
// consecutive idx read consecutive memory.
SPT_HD void ntt_pass_load(const NttPass& g, long blk, long b, long tid,
                          long nthr, const uint32_t* src, uint32_t* sm) {
  const long E = 1L << (g.t + g.logc);
  const long C = 1L << g.logc;
  const uint32_t* row0 = src + 8 * b * g.n;
  for (long idx = tid; idx < 2 * E; idx += nthr) {
    const long e = idx >> 1, part = idx & 1;
    const long c = e & (C - 1), m = e >> g.logc;
    long gi, pos;
    if (g.s0 == 0) {   // input column o at stride n / T, into bit-reversed rows
      gi = (blk << g.logc) + c + (m << (g.logn - g.t));
      pos = ntt_smem_pos(g, c, bitrev((uint32_t)m, g.t));
    } else {
      gi = ntt_row(g, blk, c, m);
      pos = ntt_smem_pos(g, c, m);
    }
    copy16(sm + 8 * pos + 4 * part, row0 + 8 * gi + 4 * part);
  }
}

// One stage (local stage ls, global stage s0 + ls) over the whole tile: the
// E/2 butterflies of the block, q -> column c, pair (m0, m0 + 2^ls).
SPT_HD void ntt_pass_stage(const NttPass& g, long blk, int ls, long tid,
                           long nthr, const uint32_t* tw, uint32_t* sm) {
  const long half_e = 1L << (g.t + g.logc - 1);
  const long half = 1L << ls;
  const long tw_stride = g.n >> (g.s0 + ls + 1);
  long lo0 = 0;
  if (g.s0 > 0) lo0 = (blk & ((1L << (g.s0 - g.logc)) - 1)) << g.logc;
  for (long q = tid; q < half_e; q += nthr) {
    const long c = q >> (g.t - 1);
    const long r = q & ((1L << (g.t - 1)) - 1);
    const long jl = r & (half - 1);
    const long m0 = ((r >> ls) << (ls + 1)) | jl;
    const long j = (jl << g.s0) + (g.s0 > 0 ? lo0 + c : 0);
    uint32_t* p0 = sm + 8 * ntt_smem_pos(g, c, m0);
    uint32_t* p1 = sm + 8 * ntt_smem_pos(g, c, m0 + half);
    const Fe u = load_fe(p0);
    // stage 0 twists by omega^0: the Montgomery one, a product that is the
    // identity on canonical values
    const Fe v = g.s0 + ls == 0
                     ? load_fe(p1)
                     : mont_mul<FR>(load_fe(p1), load_fe(tw + 8 * (j * tw_stride)));
    store_fe(p0, add<FR>(u, v));
    store_fe(p1, sub<FR>(u, v));
  }
}

// Store phase. A later pass writes back where it read; the first pass writes
// tile g = bitrev(o) as T contiguous rows g * T + l.
SPT_HD void ntt_pass_store(const NttPass& g, long blk, long b, long tid,
                           long nthr, const uint32_t* sm, uint32_t* dst) {
  const long E = 1L << (g.t + g.logc);
  const long C = 1L << g.logc, T = 1L << g.t;
  uint32_t* row0 = dst + 8 * b * g.n;
  for (long idx = tid; idx < 2 * E; idx += nthr) {
    const long e = idx >> 1, part = idx & 1;
    long c, m, gi;
    if (g.s0 == 0) {
      c = e >> g.t;
      m = e & (T - 1);
      const long o = (blk << g.logc) + c;
      gi = ((long)bitrev((uint32_t)o, g.logn - g.t) << g.t) + m;
    } else {
      c = e & (C - 1);
      m = e >> g.logc;
      gi = ntt_row(g, blk, c, m);
    }
    copy16(row0 + 8 * gi + 4 * part, sm + 8 * ntt_smem_pos(g, c, m) + 4 * part);
  }
}

}  // namespace spt
