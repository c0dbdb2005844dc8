"""The four CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA GPU and nvcc: it is marked `cuda` and skips
elsewhere. On the GPU machine, which has no jax for `tests/conftest.py`, run
`python -m pytest tests/test_torch_cuda.py -m cuda --noconftest`;
`python3 chip_smoke.py` checks the same at the main path's shapes.
"""

import random

import pytest
import torch

from spectre_tpu_torch.fields import bn254
from spectre_tpu_torch.ops import ec, field_ops as F, kernel_lib as KL
from spectre_tpu_torch.ops import msm as M, msm_kernels as MK, ntt as N

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


def _fe(ctx, n, dev, seed):
    r = random.Random(seed)
    return F.from_ints(ctx, [r.randrange(ctx.p) for _ in range(n)], dev)


def _points(n, dev, seed):
    r = random.Random(seed)
    pts = [bn254.g1_curve.mul(bn254.G1_GEN, r.randrange(1, bn254.R)) for _ in range(n)]
    return ec.encode_points(pts, dev)


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_k3_mont_mul(dev, field):
    ctx = F.fr_ctx() if field == "fr" else F.fq_ctx()
    a, b = _fe(ctx, 1000, dev, 1), _fe(ctx, 1000, dev, 2)
    before = KL.KERNELS["K3_mont_mul"].launches
    assert torch.equal(F.mont_mul(ctx, a, b), F.mont_mul_plain(ctx, a, b))
    assert torch.equal(F.mont_mul(ctx, a, b[:1]), F.mont_mul_plain(ctx, a, b[:1]))
    assert KL.KERNELS["K3_mont_mul"].launches == before + 2


def test_k4_ntt_stage(dev):
    ctx = F.fr_ctx()
    x = _fe(ctx, 1 << 10, dev, 3).reshape(1, -1, 4)
    tw = N.Twiddles(dev).twiddles(bn254.fr_root_of_unity(10), 1 << 10)
    for half in (1, 16, 512):
        y_k, y_p = x.clone(), x.clone()
        N.ntt_stage(y_k, tw, half, (1 << 10) // (2 * half))
        N.ntt_stage_plain(y_p, tw, half, (1 << 10) // (2 * half))
        assert torch.equal(y_k, y_p)


def test_k2_padd_edge_cases(dev):
    p = _points(64, dev, 4)
    x, y, z = ec.aos32_coords(p)
    neg = ec.coords_to_aos32(x, F.neg(F.fq_ctx(), y), z)
    inf = ec.inf_aos32(64, dev)
    lhs = ec.aos32_to_soa16(torch.cat([p, p, p, inf, inf]))
    rhs = ec.aos32_to_soa16(torch.cat([torch.roll(p, 1, 0), p, neg, p, inf]))
    assert torch.equal(MK.padd_soa(lhs, rhs), MK.padd_soa_plain(lhs, rhs))


@pytest.mark.parametrize("case", ["random", "all-equal", "all-zero"])
def test_k1_bucket_sums(dev, case):
    n, c = 256, 5
    soa = ec.aos32_to_soa16(_points(n, dev, 5))
    r = random.Random(6)
    if case == "random":
        vals = [r.randrange(bn254.R) for _ in range(n)]
    elif case == "all-equal":
        vals = [r.randrange(bn254.R)] * n
    else:
        vals = [0] * n
    sc = F.from_mont(F.fr_ctx(), F.from_ints(F.fr_ctx(), vals, dev))
    digits = M.signed_digit_stream(sc, c, M.num_windows(c))
    negs = (torch.arange(n, device=dev) % 2).to(torch.int32)[None]
    got = MK.bucket_sums(soa, digits, negs, c)
    want = MK.bucket_sums_plain(soa, digits, negs, c)
    flat = lambda t: ec.normalize_std(ec.soa16_to_aos32(t.permute(1, 0, 2).reshape(48, -1)))  # noqa: E731
    assert torch.equal(flat(got), flat(want))


def test_msm_matches_host(dev):
    n = 300
    r = random.Random(7)
    pts = [bn254.g1_curve.mul(bn254.G1_GEN, r.randrange(1, bn254.R)) for _ in range(n)]
    sc = [r.randrange(bn254.R) for _ in range(n)]
    base = ec.aos32_to_soa16(ec.encode_points(pts, dev))
    assert M.msm(base, F.from_ints(F.fr_ctx(), sc, dev)) == bn254.g1_curve.msm(pts, sc)
