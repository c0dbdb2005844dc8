"""The CUDA kernels' arithmetic, compiled for the host.

`spectre_tpu_torch/csrc/bn254.cuh`, `bucket.cuh`, `aggregate.cuh` and
`ntt.cuh` are `__host__ __device__`: the per-thread and per-block bodies (the code every
K1-K4 thread runs) build with g++ into a small ctypes library here, where
each block's threads run one after another between its barriers, and must
agree with the plain PyTorch versions and the Python oracle exactly — the
32-bit Montgomery constants on 0, 1, p-1 and R mod p included. The launches
themselves run only on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import ctypes
import os
import random
import re
import shutil
import subprocess

import pytest
import torch

from spectre_tpu_torch.fields import bn254
from spectre_tpu_torch.ops import ec, field_ops as F, kernel_lib as KL, limbs as L
from spectre_tpu_torch.ops import msm as M, msm_kernels as MK, ntt as N


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads per test process: the tier-1 run has six workers
    on one machine, and timing-sensitive tests elsewhere share its cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


HARNESS = r"""
#include <vector>
#include "aggregate.cuh"
#include "bn254.cuh"
#include "bucket.cuh"
#include "ntt.cuh"
using namespace spt;
extern "C" {
void h_mont_mul(const void* a, const void* b, long nb, void* out, long n, int f) {
  for (long i = 0; i < n; ++i) {
    if (f == FQ) mont_mul_one<FQ>(i, (const uint32_t*)a, (const uint32_t*)b, nb, (uint32_t*)out);
    else mont_mul_one<FR>(i, (const uint32_t*)a, (const uint32_t*)b, nb, (uint32_t*)out);
  }
}
void h_padd(const void* p, const void* q, void* out, long n) {
  for (long i = 0; i < n; ++i) padd_one(i, (const uint32_t*)p, (const uint32_t*)q, (uint32_t*)out);
}
// K1a and K1b: every (window, plan block), its threads one after another
void h_k1_count(const int32_t* digits, long nwin, long n, int nb, long P, long nblk,
                int32_t* counts) {
  std::vector<int32_t> hist(nb);
  for (int w = 0; w < nwin; ++w)
    for (long pb = 0; pb < nblk; ++pb) {
      for (int b = 0; b < nb; ++b) hist[b] = 0;
      long i1 = pb * P + P < n ? pb * P + P : n;
      k1_count_points(w, pb * P, i1, 0, 1, digits, n, hist.data());
      for (int b = 0; b < nb; ++b) counts[((long)w * nb + b) * nblk + pb] = hist[b];
    }
}
void h_k1_scatter(const int32_t* digits, const int32_t* negs, long nwin, long n, int nb,
                  long P, long nblk, long stride, const int32_t* offs, int32_t* entries) {
  std::vector<int32_t> cur(nb);
  for (int w = 0; w < nwin; ++w)
    for (long pb = 0; pb < nblk; ++pb) {
      for (int b = 0; b < nb; ++b) cur[b] = offs[((long)w * nb + b) * nblk + pb];
      long i1 = pb * P + P < n ? pb * P + P : n;
      k1_scatter_points(w, pb * P, i1, 0, 1, digits, negs, n, stride, cur.data(), entries);
    }
}
// K1c: every walk block: the threads' walks, the tree (the kernel's shuffle
// tree in the same order), the root
void h_k1_walk(const uint32_t* pts, const int32_t* entries, const int32_t* bstart, int nkeys,
               long max_entries, uint32_t* out, uint32_t* pieces) {
  std::vector<K1Node> nodes(K1_THREADS);
  uint32_t stage[K1_STAGE_WORDS];
  const long nblocks = (max_entries + K1_BLOCK_ENTRIES - 1) / K1_BLOCK_ENTRIES;
  for (long blk = 0; blk < nblocks; ++blk) {
    if (blk * K1_BLOCK_ENTRIES >= bstart[nkeys]) continue;
    for (int t = 0; t < K1_THREADS; ++t)
      k1_walk_thread(blk, t, pts, entries, bstart, nkeys, out, &nodes[t], stage);
    for (int d = 1; d < K1_THREADS; d <<= 1)
      for (int t = 0; t < K1_THREADS; t += 2 * d) k1_merge(&nodes[t], &nodes[t + d], out);
    k1_root(blk, &nodes[0], bstart, out, pieces);
  }
}
// K1d: every key, its 32 lanes and the kernel's shuffle tree in order
void h_k1_pieces(const int32_t* bstart, int nkeys, const uint32_t* pieces, uint32_t* out) {
  for (int key = 0; key < nkeys; ++key) {
    long first, last;
    k1_bucket_blocks(key, bstart, &first, &last);
    if (last == first) continue;
    if (last < first) { store_point(out + 24 * (long)key, infinity()); continue; }
    const long np = last - first + 1;
    const int active = np < 32 ? (int)np : 32;
    Point acc[32];
    for (int l = 0; l < active; ++l) acc[l] = k1_pieces_lane(key, first, last, l, 32, bstart, pieces);
    for (int off = 1; off < active; off <<= 1)
      for (int l = 0; l + off < active; l += 2 * off) acc[l] = padd(acc[l], acc[l + off]);
    store_point(out + 24 * (long)key, acc[0]);
  }
}
// the mixed add: P + (x2 : y2 : 1), q's X and Y read, its Z not
void h_madd(const void* p, const void* q, void* out, long n) {
  for (long i = 0; i < n; ++i) {
    const uint32_t* qi = (const uint32_t*)q + 24 * i;
    store_point((uint32_t*)out + 24 * i,
                madd(load_point((const uint32_t*)p + 24 * i), load_fe(qi), load_fe(qi + 8)));
  }
}
// K1c_fixed: every walk block: its threads' lanes, the tree by its threads, the root
void h_k1_fixed_walk(const uint32_t* pts, const int32_t* entries, const int32_t* bstart,
                     int nkeys, long max_entries, uint32_t* out, uint32_t* pieces) {
  std::vector<K1Node> nodes(K1_THREADS);
  std::vector<uint32_t> stage(K1F_STAGE_WORDS);
  const long nblocks = (max_entries + K1_BLOCK_ENTRIES - 1) / K1_BLOCK_ENTRIES;
  for (long blk = 0; blk < nblocks; ++blk) {
    if (blk * K1_BLOCK_ENTRIES >= bstart[nkeys]) continue;
    for (int t = 0; t < K1F_THREADS; ++t)
      k1f_walk_thread(blk, t, pts, entries, bstart, nkeys, out, &nodes[K1F_LANES * t],
                      stage.data());
    for (int d = 1; d < K1_THREADS; d <<= 1)
      for (int t = 0; t < K1F_THREADS; ++t) k1f_tree_level(d, t, K1F_THREADS, nodes.data(), out);
    k1_root(blk, &nodes[0], bstart, out, pieces);
  }
}
void h_k2b_geometry(long nwin, int nb, int* g) {
  const K2bGeometry geo = k2b_geometry(nwin, nb);
  g[0] = geo.G; g[1] = geo.T; g[2] = geo.L;
}
// K2b: every window's blocks in order, each its leaves, tree levels and
// ticket; the window's last block gathers the pairs and runs the merge
void h_k2b(const uint32_t* sums, long nwin, int nb, uint32_t* pairs, int32_t* tickets,
           uint32_t* out) {
  const K2bGeometry geo = k2b_geometry(nwin, nb);
  const int G = geo.G, T = geo.T, S = nb / G;
  std::vector<Point> W(T), D(T);
  for (long w = 0; w < nwin; ++w)
    for (int g = 0; g < G; ++g) {
      for (int t = 0; t < T; ++t) k2b_leaf(w, g, t, nb, S, geo.L, sums, W.data(), D.data());
      for (int d = 1; d < T; d <<= 1)
        for (int t = 0; t < T; ++t)
          k2b_merge(t, d, T, T / 2, G == 1 && 2 * d == T, W.data(), D.data());
      if (G == 1) { store_point(out + 24 * w, W[0]); continue; }
      if (!k2b_publish(w, g, G, W.data(), D.data(), pairs, tickets)) continue;
      for (int t = 0; t < G; ++t) k2b_gather(w, t, G, pairs, W.data(), D.data());
      for (int d = 1; d < G; d <<= 1)
        for (int t = 0; t < T; ++t) k2b_merge(t, d, G, T / 2, 2 * d == G, W.data(), D.data());
      store_point(out + 24 * w, W[0]);
    }
}
// K4: one pass over every (batch row, block), the block's threads in order
void h_ntt_pass(const uint32_t* src, uint32_t* dst, const uint32_t* tw, long batch,
                int logn, int s0, int t, int logc) {
  const NttPass g{1L << logn, logn, s0, t, logc};
  std::vector<uint32_t> sm(8 * ntt_tile_elems(g));
  for (long b = 0; b < batch; ++b)
    for (long blk = 0; blk < ntt_blocks(g); ++blk) {
      ntt_pass_load(g, blk, b, 0, 1, src, sm.data());
      for (int ls = 0; ls < t; ++ls) ntt_pass_stage(g, blk, ls, 0, 1, tw, sm.data());
      ntt_pass_store(g, blk, b, 0, 1, sm.data(), dst);
    }
}
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build the header for the host")
    d = tmp_path_factory.mktemp("csrc_host")
    src = d / "harness.cc"
    src.write_text(HARNESS)
    so = d / "harness.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-I", KL.CSRC,
                    "-o", str(so), str(src)], check=True, timeout=300)
    h = ctypes.CDLL(str(so))
    vp, lg, it = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
    h.h_mont_mul.argtypes = [vp, vp, lg, vp, lg, it]
    h.h_padd.argtypes = [vp, vp, vp, lg]
    h.h_k1_count.argtypes = [vp, lg, lg, it, lg, lg, vp]
    h.h_k1_scatter.argtypes = [vp, vp, lg, lg, it, lg, lg, lg, vp, vp]
    h.h_k1_walk.argtypes = [vp, vp, vp, it, lg, vp, vp]
    h.h_k1_pieces.argtypes = [vp, it, vp, vp]
    h.h_ntt_pass.argtypes = [vp, vp, vp, lg, it, it, it, it]
    h.h_k2b.argtypes = [vp, lg, it, vp, vp, vp]
    h.h_k2b_geometry.argtypes = [lg, it, vp]
    h.h_madd.argtypes = [vp, vp, vp, lg]
    h.h_k1_fixed_walk.argtypes = [vp, vp, vp, it, lg, vp, vp]
    return h


def test_header_constants_are_derived():
    text = open(os.path.join(KL.CSRC, "bn254.cuh")).read()
    for name, ctx in (("FQ", F.fq_ctx()), ("FR", F.fr_ctx())):
        body = text[text.index(f"struct Consts<{name}>"):]
        body = body[:body.index("\n};\n")]
        n0 = int(re.search(r"n0 = (0x[0-9a-f]+)u", body).group(1), 16)
        arrays = [[int(x, 16) for x in re.findall(r"(0x[0-9a-f]+)u", m)]
                  for m in re.findall(r"v\[8\] = \{([^}]*)\}", body)]
        assert n0 == ctx.n0inv32 and n0 != ctx.n0inv16
        assert sum(v << (32 * i) for i, v in enumerate(arrays[0])) == ctx.p
        assert sum(v << (32 * i) for i, v in enumerate(arrays[1])) == ctx.r_mod_p


def test_k1_geometry_matches_header():
    """The wrapper sizes K1's buffers and the tests their cases from the
    walk's segment and block; they must be the header's."""
    text = open(os.path.join(KL.CSRC, "bucket.cuh")).read()
    seg = int(re.search(r"K1_SEG = (\d+);", text).group(1))
    threads = int(re.search(r"K1_THREADS = (\d+);", text).group(1))
    assert (MK.K1_SEG, MK.K1_THREADS) == (seg, threads)
    assert MK.K1_BLOCK_ENTRIES == seg * threads


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_mont_mul_body(lib, field):
    """The product's rows and carry chains (the card runs the same chains in
    PTX) on every pair of the edge values 0, 1, p - 1, R mod p, p - R mod p
    and on random values, against the plain version and the integer oracle
    a * b / 2^256 mod p."""
    ctx = F.fr_ctx() if field == "fr" else F.fq_ctx()
    r = random.Random(1)
    edge = [0, 1, ctx.p - 1, ctx.r_mod_p, ctx.p - ctx.r_mod_p]
    va = [x for x in edge for _ in edge] + [r.randrange(ctx.p) for _ in range(200)]
    vb = edge * len(edge) + [r.randrange(ctx.p) for _ in range(200)]
    raw = lambda v: F.tensor_from_u64(L.ints_to_limbs(v), "cpu")  # noqa: E731
    a, b = raw(va), raw(vb)
    rinv = pow(1 << 256, -1, ctx.p)
    for bb, wb in ((b, vb), (b[:1], vb[:1] * len(va))):
        out = torch.empty_like(a)
        lib.h_mont_mul(a.data_ptr(), bb.data_ptr(), bb.shape[0], out.data_ptr(),
                       a.shape[0], ctx.field_id)
        assert torch.equal(out, F.mont_mul_plain(ctx, a, bb))
        got = L.limbs_to_ints(F.tensor_to_u64(out))
        assert got == [x * y * rinv % ctx.p for x, y in zip(va, wb)]


def _points(n, seed):
    r = random.Random(seed)
    return ec.encode_points([bn254.g1_curve.mul(bn254.G1_GEN, r.randrange(1, bn254.R))
                             for _ in range(n)], "cpu")


def test_padd_body_limb_for_limb(lib):
    p = _points(16, 2)
    x, y, z = ec.aos32_coords(p)
    neg = ec.coords_to_aos32(x, F.neg(F.fq_ctx(), y), z)
    inf = ec.inf_aos32(16, "cpu")
    lhs = torch.cat([p, p, p, inf, inf])
    rhs = torch.cat([torch.roll(p, 1, 0), p, neg, p, inf])
    for a, b in ((lhs, rhs), (MK.padd_aos32(lhs, rhs), lhs)):    # affine, projective
        out = torch.empty_like(a)
        lib.h_padd(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0])
        assert torch.equal(out, MK.padd_aos32(a, b))


def test_madd_body_matches_plain(lib):
    """The mixed add (the fixed walk's) limb for limb against its plain
    version `ec.madd16`, and against the host curve: projective P (Z != 1)
    plus random affine Q, P = Q, P = -Q, and P at infinity (the run sum
    before its first row)."""
    q = _points(16, 40)
    x, y, z = ec.aos32_coords(q)
    neg = ec.coords_to_aos32(x, F.neg(F.fq_ctx(), y), z)
    proj = MK.padd_aos32(_points(16, 41), _points(16, 42))
    lhs = torch.cat([proj, q, q, ec.inf_aos32(16, "cpu"), MK.padd_aos32(q, q)])
    rhs = torch.cat([q, q, neg, q, q])
    out = torch.empty_like(lhs)
    lib.h_madd(lhs.data_ptr(), rhs.data_ptr(), out.data_ptr(), lhs.shape[0])
    plain = ec.rows16_to_aos32(ec.madd16(ec.aos32_to_rows16(lhs).t(),
                                         ec.aos32_to_rows16(rhs).t()[:32]).t())
    assert torch.equal(out, plain)
    g1 = bn254.g1_curve
    want = [g1.add(a, b) for a, b in zip(ec.decode_points(lhs), ec.decode_points(rhs))]
    assert ec.decode_points(out) == want
    assert want[32:48] == [None] * 16


def _host_k1(lib, pts, digits, negs, c, fixed=False):
    """K1 through the host-compiled bodies: (counts, entries, bucket sums);
    `fixed`: the fixed-base form, pts the [nwin * n, 24] window table."""
    nwin, n = digits.shape
    nb = 1 << (c - 1)
    nkeys = nwin * nb
    P, nblk = MK.plan_blocks(n)
    counts = torch.empty(nkeys * nblk, dtype=torch.int32)
    lib.h_k1_count(digits.data_ptr(), nwin, n, nb, P, nblk, counts.data_ptr())
    offs, bstart = MK.bucket_offsets(counts, nkeys, nblk)
    entries = torch.zeros(nwin * n, dtype=torch.int32)
    lib.h_k1_scatter(digits.data_ptr(), negs.data_ptr(), nwin, n, nb, P, nblk,
                     n if fixed else 0, offs.data_ptr(), entries.data_ptr())
    nwalk = -(-nwin * n // MK.K1_BLOCK_ENTRIES)
    out = torch.full((nkeys, 24), -1, dtype=torch.int32)      # every row must be written
    pieces = torch.zeros((max(2 * nwalk, 1), 24), dtype=torch.int32)
    lib.h_k1_walk(pts.data_ptr(), entries.data_ptr(), bstart.data_ptr(), nkeys,
                  nwin * n, out.data_ptr(), pieces.data_ptr())
    lib.h_k1_pieces(bstart.data_ptr(), nkeys, pieces.data_ptr(), out.data_ptr())
    return counts, entries, bstart, out


def _affine(aos):
    return ec.normalize_std(aos)


def _digits(case, nwin, n, c, seed):
    g = torch.Generator().manual_seed(seed)
    half = 1 << (c - 1)
    if case == "random":
        return torch.randint(-half + 1, half + 1, (nwin, n), generator=g, dtype=torch.int32)
    if case == "all-equal":
        return torch.randint(-half + 1, half + 1, (nwin, 1), generator=g,
                             dtype=torch.int32).clamp(min=1).repeat(1, n)
    return torch.zeros((nwin, n), dtype=torch.int32)


def _tiled_points(n, seed):
    """n points cycling through 64 distinct ones (sums only need points)."""
    base = _points(64, seed)
    return base[torch.arange(n) % 64].contiguous()


def _check_host_k1(lib, pts, digits, negs, c):
    nb = 1 << (c - 1)
    P, _ = MK.plan_blocks(digits.shape[1])
    counts, entries, bstart, out = _host_k1(lib, pts, digits, negs, c)
    assert torch.equal(counts, MK.bucket_counts_plain(digits, nb, P))
    # one thread per block in order: the host scatter is the stable sort
    assert torch.equal(entries, MK.bucket_scatter_plain(digits, negs, nb))
    assert not (out == -1).all(dim=1).any()
    assert torch.equal(_affine(out), _affine(MK.bucket_walk_plain(pts, entries, bstart)))
    return bstart


def test_bucket_body_matches_plain_k1(lib):
    """The K1 bodies (count, scatter, walk with its tree, pieces) on random
    scalars' digits through the MSM's recode, against the plain K1."""
    n, c = 48, 4
    soa = ec.aos32_to_soa16(_points(n, 3))
    r = random.Random(4)
    sc = F.from_mont(F.fr_ctx(), F.from_ints(F.fr_ctx(), [r.randrange(bn254.R) for _ in range(n)], "cpu"))
    digits = M.signed_digit_stream(sc, c, M.num_windows(c))
    negs = (torch.arange(n) % 3 == 0).to(torch.int32)[None]
    _, _, _, out = _host_k1(lib, ec.soa16_to_aos32(soa), digits, negs, c)
    got = MK.buckets_soa(out, digits.shape[0], 1 << (c - 1))
    flat = lambda t: _affine(ec.soa16_to_aos32(t.permute(1, 0, 2).reshape(48, -1)))  # noqa: E731
    assert torch.equal(flat(got), flat(MK.bucket_sums_plain(soa, digits, negs, c)))


@pytest.mark.parametrize("case", ["random", "all-equal", "all-zero"])
def test_k1_bodies_across_blocks(lib, case):
    """9000 points, 2 windows, c = 3: buckets of ~1000 (random) or 9000
    (all-equal: three 4096-entry walk blocks, the middle one a single run)
    entries span many 32-entry segments and cross block boundaries."""
    n, c, nwin = 9000, 3, 2
    digits = _digits(case, nwin, n, c, 7)
    negs = (torch.arange(n) % 5 == 0).to(torch.int32)[None]
    bstart = _check_host_k1(lib, _tiled_points(n, 8), digits, negs, c)
    sizes = bstart[1:] - bstart[:-1]
    if case == "all-equal":
        assert int(sizes.max()) == n > 2 * MK.K1_BLOCK_ENTRIES
    if case == "all-zero":
        assert int(bstart[-1]) == 0


@pytest.mark.parametrize("case", ["random", "all-equal"])
def test_k1_fixed_form_bodies(lib, case):
    """The fixed-base form: the scatter's strided entries (window w names
    row w * n + i of the window table) and the walk gathering from the
    [nwin * n, 24] table, against the plain fixed form; 3 windows of 5000
    points, each window's table distinct, buckets crossing walk blocks."""
    n, c, nwin = 5000, 4, 3
    digits = _digits(case, nwin, n, c, 12)
    negs = (torch.arange(n) % 3 == 0).to(torch.int32)[None]
    table = torch.stack([_tiled_points(n, 20 + w) for w in range(nwin)])
    nb = 1 << (c - 1)
    P, _ = MK.plan_blocks(n)
    counts, entries, bstart, out = _host_k1(lib, table.reshape(-1, 24), digits, negs, c,
                                            fixed=True)
    assert torch.equal(counts, MK.bucket_counts_plain(digits, nb, P))
    assert torch.equal(entries, MK.bucket_scatter_plain(digits, negs, nb, n))
    rows = entries[:int(bstart[-1])].long() & 0x7FFFFFFF
    assert int(rows.max()) >= (nwin - 1) * n                # window 2's rows are read
    assert not (out == -1).all(dim=1).any()
    want = MK.bucket_sums_fixed_aos32(table, digits, negs, c)
    assert torch.equal(_affine(out), _affine(want))
    soa = MK.to_soa_windows(table)
    flat = lambda t: _affine(ec.soa16_to_aos32(t.permute(1, 0, 2).reshape(48, -1)))  # noqa: E731
    assert torch.equal(flat(MK.bucket_sums_fixed_plain(soa, digits, negs, c)), _affine(out))


def _host_fixed_walk(lib, table, entries, bstart):
    nkeys = bstart.shape[0] - 1
    nwalk = -(-entries.shape[0] // MK.K1_BLOCK_ENTRIES)
    out = torch.full((nkeys, 24), -1, dtype=torch.int32)     # every row must be written
    pieces = torch.zeros((max(2 * nwalk, 1), 24), dtype=torch.int32)
    lib.h_k1_fixed_walk(table.data_ptr(), entries.data_ptr(), bstart.data_ptr(), nkeys,
                        entries.shape[0], out.data_ptr(), pieces.data_ptr())
    lib.h_k1_pieces(bstart.data_ptr(), nkeys, pieces.data_ptr(), out.data_ptr())
    assert not (out == -1).all(dim=1).any()
    return out


def _normalised_table(nwin, n, seed, inf_rows=()):
    """nwin windows of n points cycling through 64 distinct ones each (sums
    of two of 64 random points, distinct between windows), normalised as
    `build_window_table` leaves a table (Z = 1), with the rows `inf_rows` of
    every window at infinity (Z = 0)."""
    r = random.Random(seed)
    p0 = bn254.g1_curve.mul(bn254.G1_GEN, r.randrange(1, bn254.R))
    mult = [p0]
    for _ in range(63):             # k P0: cheap host adds, distinct points
        mult.append(bn254.g1_curve.add(mult[-1], p0))
    base = ec.encode_points(mult, "cpu")[torch.randperm(64, generator=torch.Generator().manual_seed(seed))]
    idx = torch.arange(n) % 64
    proj = torch.cat([MK.padd_aos32(base, torch.roll(base, w + 1, 0))[idx]
                      for w in range(nwin)])
    table = ec.normalize_mont(proj).reshape(nwin, n, 24)
    for i in inf_rows:
        table[:, i] = ec.inf_aos32(1, "cpu")
    MK.check_normalised(table)
    return table


@pytest.mark.parametrize("case", ["random", "all-equal"])
def test_k1_fixed_walk_body(lib, case):
    """The fixed walk's bodies (its lanes' mixed adds, the tree by its
    threads, the root) and K1d over a normalised table with rows at
    infinity, against the plain fixed walk and the shared form's plain walk
    over the same entries, after normalization; 3 windows of 5000 points,
    so buckets cross walk blocks (all-equal: each window's one bucket spans
    4 of them)."""
    n, c, nwin = 5000, 4, 3
    digits = _digits(case, nwin, n, c, 13)
    negs = (torch.arange(n) % 3 == 0).to(torch.int32)[None]
    table = _normalised_table(nwin, n, 60, inf_rows=(0, 7, 4099))
    rows = table.reshape(-1, 24)
    _, bstart, entries = MK.bucket_plan_plain(digits, negs, c, fixed=True)
    out = _host_fixed_walk(lib, rows, entries, bstart)
    plain = MK.bucket_walk_fixed_plain(rows, entries, bstart)
    assert torch.equal(_affine(out), _affine(plain))
    assert torch.equal(_affine(out), _affine(MK.bucket_walk_plain(rows, entries, bstart)))
    if case == "all-equal":
        sizes = bstart[1:] - bstart[:-1]
        assert int(sizes.max()) == n > MK.K1_BLOCK_ENTRIES


def test_k1_fixed_walk_body_runs_of_one_row(lib):
    """Many short runs: 2^13 points at c = 12 (2048 buckets a window), so
    segments hold several whole buckets and runs that start on a row at
    infinity (every 5th point), against the plain fixed walk."""
    n, c, nwin = 1 << 13, 12, 2
    digits = _digits("random", nwin, n, c, 14)
    negs = (torch.arange(n) % 2 == 0).to(torch.int32)[None]
    table = _normalised_table(nwin, n, 70, inf_rows=range(0, n, 5))
    rows = table.reshape(-1, 24)
    _, bstart, entries = MK.bucket_plan_plain(digits, negs, c, fixed=True)
    out = _host_fixed_walk(lib, rows, entries, bstart)
    assert torch.equal(_affine(out), _affine(MK.bucket_walk_fixed_plain(rows, entries, bstart)))


def test_k1_bodies_bucket_over_many_blocks(lib):
    """One bucket of ~140000 entries: 35 walk blocks, so K1d's lanes each
    sum more than one piece before the shuffle tree; a second bucket of 7
    negated entries follows it in the sort. Held against the host curve
    (the points repeat with period 64, so each sum is 64 multiples)."""
    n, c = 140000, 2
    digits = torch.ones((1, n), dtype=torch.int32)
    digits[0, 70000:70007] = -2
    negs = torch.zeros((1, n), dtype=torch.int32)
    base = _points(64, 9)
    counts, entries, bstart, out = _host_k1(lib, base[torch.arange(n) % 64].contiguous(),
                                            digits, negs, c)
    P, _ = MK.plan_blocks(n)
    assert torch.equal(counts, MK.bucket_counts_plain(digits, 2, P))
    assert torch.equal(entries, MK.bucket_scatter_plain(digits, negs, 2))
    assert (int(bstart[1]) - 1) // MK.K1_BLOCK_ENTRIES + 1 > 32
    g1, host = bn254.g1_curve, ec.decode_points(base)
    idx = torch.arange(n) % 64
    want = []
    for key, sign in ((1, 1), (-2, -1)):
        mult = torch.bincount(idx[digits[0] == key], minlength=64).tolist()
        acc = None
        for k, m in enumerate(mult):
            acc = g1.add(acc, g1.mul(host[k], m))
        want.append(acc if sign > 0 else g1.neg(acc))
    assert ec.decode_points(out) == want


def _host_k2b(lib, sums, nwin, nb):
    """K2b through the host-compiled bodies, every window's blocks in order
    with their tickets; the ticket counters must be back at 0."""
    G, _, _ = MK.aggregate_geometry(nwin, nb)
    out = torch.full((nwin, 24), -1, dtype=torch.int32)
    pairs = torch.zeros((nwin * G, 48), dtype=torch.int32)
    tickets = torch.zeros(nwin, dtype=torch.int32)
    lib.h_k2b(sums.data_ptr(), nwin, nb, pairs.data_ptr(), tickets.data_ptr(), out.data_ptr())
    assert not tickets.any()
    return out


@pytest.mark.parametrize("nwin,nb", [(3, 1), (2, 2), (2, 8), (1, 256), (2, 512), (1, 2048),
                                     (1, 4096)])
def test_k2b_body_matches_plain(lib, nwin, nb):
    """K2b's leaf, tree and merge bodies, every window's blocks thread by
    thread with the ticket merge, against its plain version limb for limb
    (projective): one bucket a window, one block a window, and windows over
    2 to 64 blocks (1 x 4096, the fixed mode's window); projective bucket
    sums (Z != 1) with empty ones."""
    base = _points(16, 10)
    pts = base[torch.arange(nwin * nb) % 16]
    sums = MK.padd_aos32(pts, torch.roll(pts, 3, 0))
    sums[::5] = ec.inf_aos32(1, "cpu")
    out = _host_k2b(lib, sums, nwin, nb)
    want = MK.aggregate_buckets_plain(sums, nwin, nb)
    assert torch.equal(out, want)
    g1, host = bn254.g1_curve, ec.decode_points(sums)
    for w in range(nwin):
        acc = None
        for j in range(nb):
            acc = g1.add(acc, g1.mul(host[w * nb + j], j + 1) if host[w * nb + j] else None)
        assert ec.decode_points(out[w:w + 1]) == [acc]


def test_k2b_geometry_matches_header():
    text = open(os.path.join(KL.CSRC, "aggregate.cuh")).read()
    assert int(re.search(r"K2B_THREADS = (\d+);", text).group(1)) == MK.K2B_THREADS
    assert int(re.search(r"K2B_FILL = (\d+);", text).group(1)) == MK.K2B_FILL
    # (nwin, nb) -> (blocks a window, threads, buckets a thread): the MSM's
    # 24 x 1024 windows, the fixed mode's 1 x 4096, the glv modes' 10 x 4096
    assert [MK.aggregate_geometry(nwin, nb) for nwin, nb in
            ((1, 1), (2, 8), (24, 1024), (1, 4096), (10, 4096), (256, 256))] == \
        [(1, 1, 1), (2, 4, 1), (8, 128, 1), (64, 64, 1), (16, 128, 2), (1, 128, 2)]


def test_k2b_geometry_equals_the_headers_function(lib):
    """The wrapper sizes K2b's scratch from the Python geometry; the launch
    takes the header's: the two agree at every (nwin, nb) the MSM can give,
    and G <= T (the merge's tree has a thread a pair)."""
    g = (ctypes.c_int * 3)()
    for nwin in (1, 2, 3, 10, 20, 24, 29, 43, 64, 128, 255, 300):
        for c in range(1, 17):
            nb = 1 << (c - 1)
            lib.h_k2b_geometry(nwin, nb, g)
            assert tuple(g) == MK.aggregate_geometry(nwin, nb)
            assert g[0] <= g[1] and g[0] * g[1] * g[2] == nb


def test_k2b_body_runs_of_two(lib):
    """256 windows of 256 buckets: one block a window of 128 threads with
    runs of L = 2 buckets (the leaf's walk and doubling, as the glv modes'
    10 x 4096 has them), against the plain version limb for limb."""
    nwin, nb = 256, 256
    assert MK.aggregate_geometry(nwin, nb) == (1, 128, 2)
    sums = _points(16, 31)[torch.arange(nwin * nb) % 16]
    sums[::11] = ec.inf_aos32(1, "cpu")
    assert torch.equal(_host_k2b(lib, sums, nwin, nb), MK.aggregate_buckets_plain(sums, nwin, nb))


def test_ntt_butterfly_body(lib):
    """A one-pass transform (every stage in one tile: the butterfly body
    over all its stages) against the plain stage loop, batch of 2."""
    ctx = F.fr_ctx()
    r = random.Random(5)
    n = 64
    x = F.from_ints(ctx, [r.randrange(ctx.p) for _ in range(2 * n)], "cpu").reshape(2, n, 4)
    tables = N.Twiddles("cpu")
    tw = tables.twiddles(bn254.fr_root_of_unity(6), n)
    assert N.ntt_plan(6) == [(0, 6, 0)]
    got = torch.empty_like(x)
    lib.h_ntt_pass(x.data_ptr(), got.data_ptr(), tw.data_ptr(), 2, 6, 0, 6, 0)
    assert torch.equal(got, N.ntt_stages_plain(x, tw, tables))


@pytest.mark.parametrize("logn,tmax,tile_log,npass", [
    (5, 5, 5, 1), (7, 4, 5, 2), (9, 3, 4, 3), (10, 4, 6, 3)])
def test_ntt_pass_bodies(lib, logn, tmax, tile_log, npass):
    """The K4 tile bodies pass by pass at small tile widths (1, 2 and 3
    passes, several columns per block) against the pass-structured plain
    version and the plain stage loop, batch of 3."""
    ctx = F.fr_ctx()
    n = 1 << logn
    r = random.Random(logn)
    x = F.from_ints(ctx, [r.randrange(ctx.p) for _ in range(3 * n)], "cpu").reshape(3, n, 4)
    tables = N.Twiddles("cpu")
    tw = tables.twiddles(bn254.fr_root_of_unity(logn), n)
    plan = N.ntt_plan(logn, tmax, tile_log)
    assert len(plan) == npass and any(logc > 0 for _, _, logc in plan) == (npass > 1)
    got = torch.empty_like(x)
    for i, (s0, t, logc) in enumerate(plan):
        lib.h_ntt_pass((x if i == 0 else got).data_ptr(), got.data_ptr(), tw.data_ptr(),
                       3, logn, s0, t, logc)
    assert torch.equal(got, N.ntt_passes_plain(x, tw, plan))
    assert torch.equal(got, N.ntt_stages_plain(x, tw, tables))
