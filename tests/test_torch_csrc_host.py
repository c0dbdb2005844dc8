"""The CUDA kernels' arithmetic, compiled for the host.

`spectre_tpu_torch/csrc/bn254.cuh` is `__host__ __device__`: its per-thread
bodies (the code every K1-K4 thread runs) build with g++ into a small
ctypes library here, and must agree with the plain PyTorch versions and the
Python oracle exactly — the 32-bit Montgomery constants on 0, 1, p-1 and
R mod p included. The launch geometry runs only on the card
(tests/test_torch_cuda.py, chip_smoke.py).
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
from spectre_tpu_torch.ops import ec, field_ops as F, kernel_lib as KL
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
#include "bn254.cuh"
extern "C" {
void h_mont_mul(const void* a, const void* b, long nb, void* out, long n, int f) {
  for (long i = 0; i < n; ++i) {
    if (f == spt::FQ) spt::mont_mul_one<spt::FQ>(i, (const uint32_t*)a, (const uint32_t*)b, nb, (uint32_t*)out);
    else spt::mont_mul_one<spt::FR>(i, (const uint32_t*)a, (const uint32_t*)b, nb, (uint32_t*)out);
  }
}
void h_padd(const void* p, const void* q, void* out, long n) {
  for (long i = 0; i < n; ++i) spt::padd_one(i, (const uint32_t*)p, (const uint32_t*)q, (uint32_t*)out);
}
void h_bucket(const void* pts, const void* e, const void* cs, const void* cl, void* part, long nc) {
  for (long c = 0; c < nc; ++c)
    spt::bucket_chunk_one(c, (const uint32_t*)pts, (const int32_t*)e, (const int64_t*)cs,
                          (const int32_t*)cl, (uint32_t*)part);
}
void h_ntt_stage(void* a, const void* tw, long batch, long n, long half, long stride) {
  for (long t = 0; t < batch * (n / 2); ++t)
    spt::ntt_butterfly_one(t, (uint32_t*)a, (const uint32_t*)tw, n, half, stride);
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
    h.h_bucket.argtypes = [vp, vp, vp, vp, vp, lg]
    h.h_ntt_stage.argtypes = [vp, vp, lg, lg, lg, lg]
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


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_mont_mul_body(lib, field):
    ctx = F.fr_ctx() if field == "fr" else F.fq_ctx()
    r = random.Random(1)
    va = [0, 1, ctx.p - 1, ctx.r_mod_p] + [r.randrange(ctx.p) for _ in range(60)]
    vb = [ctx.p - 1, ctx.r_mod_p, 0, 1] + [r.randrange(ctx.p) for _ in range(60)]
    a, b = F.from_ints(ctx, va, "cpu"), F.from_ints(ctx, vb, "cpu")
    for bb in (b, b[:1]):
        out = torch.empty_like(a)
        lib.h_mont_mul(a.data_ptr(), bb.data_ptr(), bb.shape[0], out.data_ptr(),
                       a.shape[0], ctx.field_id)
        assert torch.equal(out, F.mont_mul_plain(ctx, a, bb))


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


def test_bucket_body_matches_plain_k1(lib):
    n, c = 48, 4
    soa = ec.aos32_to_soa16(_points(n, 3))
    r = random.Random(4)
    sc = F.from_mont(F.fr_ctx(), F.from_ints(F.fr_ctx(), [r.randrange(bn254.R) for _ in range(n)], "cpu"))
    digits = M.signed_digit_stream(sc, c, M.num_windows(c))
    negs = (torch.arange(n) % 3 == 0).to(torch.int32)[None]
    nwin, nb = digits.shape[0], 1 << (c - 1)
    entries, cstart, clen, ckey = MK._bucket_plan(digits, negs, nb)
    pts = ec.soa16_to_aos32(soa)
    partials = torch.empty((ckey.shape[0], 24), dtype=torch.int32)
    lib.h_bucket(pts.data_ptr(), entries.data_ptr(), cstart.data_ptr(), clen.data_ptr(),
                 partials.data_ptr(), ckey.shape[0])
    sums, keys = MK._fold(partials, ckey, MK.padd_aos32)
    got = MK._scatter_buckets(sums, keys, nwin, nb)
    assert torch.equal(got, MK.bucket_sums_plain(soa, digits, negs, c))


def test_ntt_butterfly_body(lib):
    ctx = F.fr_ctx()
    r = random.Random(5)
    n = 64
    x = F.from_ints(ctx, [r.randrange(ctx.p) for _ in range(2 * n)], "cpu").reshape(2, n, 4)
    tw = N.Twiddles("cpu").twiddles(bn254.fr_root_of_unity(6), n)
    for half in (1, 4, 32):
        got, want = x.clone(), x.clone()
        lib.h_ntt_stage(got.data_ptr(), tw.data_ptr(), 2, n, half, n // (2 * half))
        N.ntt_stage_plain(want, tw, half, n // (2 * half))
        assert torch.equal(got, want)
