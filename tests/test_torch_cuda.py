"""The CUDA kernels against their plain PyTorch versions, on the card.

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
    edge = F.from_ints(ctx, [0, 1, ctx.p - 1, ctx.r_mod_p, ctx.p - ctx.r_mod_p], dev)
    a = torch.cat([edge.repeat_interleave(5, 0), _fe(ctx, 975, dev, 1)])
    b = torch.cat([edge.repeat(5, 1), _fe(ctx, 975, dev, 2)])
    before = KL.KERNELS["K3_mont_mul"].launches
    assert torch.equal(F.mont_mul(ctx, a, b), F.mont_mul_plain(ctx, a, b))
    assert torch.equal(F.mont_mul(ctx, a, b[:1]), F.mont_mul_plain(ctx, a, b[:1]))
    assert KL.KERNELS["K3_mont_mul"].launches == before + 2


@pytest.mark.parametrize("logn,batch", [(6, 1), (7, 3), (10, 1), (12, 2), (16, 3)])
def test_k4_ntt(dev, logn, batch):
    """The pass kernel against the plain stage loop and the pass-structured
    plain version, one launch per pass."""
    ctx = F.fr_ctx()
    n = 1 << logn
    x = _fe(ctx, batch * n, dev, 3 + logn).reshape(batch, n, 4)
    tables = N.Twiddles(dev)
    tw = tables.twiddles(bn254.fr_root_of_unity(logn), n)
    before = KL.KERNELS["K4_ntt"].launches
    got = N.ntt_passes(x, tw)
    assert KL.KERNELS["K4_ntt"].launches == before + len(N.ntt_plan(logn))
    assert torch.equal(got, N.ntt_stages_plain(x, tw, tables))
    assert torch.equal(got, N.ntt_passes_plain(x, tw))


def test_k2_padd_edge_cases(dev):
    p = _points(64, dev, 4)
    x, y, z = ec.aos32_coords(p)
    neg = ec.coords_to_aos32(x, F.neg(F.fq_ctx(), y), z)
    inf = ec.inf_aos32(64, dev)
    lhs = ec.aos32_to_soa16(torch.cat([p, p, p, inf, inf]))
    rhs = ec.aos32_to_soa16(torch.cat([torch.roll(p, 1, 0), p, neg, p, inf]))
    assert torch.equal(MK.padd_soa(lhs, rhs), MK.padd_soa_plain(lhs, rhs))


@pytest.mark.parametrize("nwin,nb", [(3, 1), (2, 8), (2, 512), (24, 1024), (1, 4096)])
def test_k2b_aggregate(dev, nwin, nb):
    """K2b, one launch, against its plain version limb for limb: one bucket
    a window, fewer buckets than threads, and runs of 4, 8 and 32 buckets a
    thread, on projective sums with empty buckets."""
    base = _points(64, dev, 8)
    pts = base[torch.arange(nwin * nb, device=dev) % 64]
    sums = MK.padd_aos32(pts, torch.roll(pts, 5, 0))
    sums[::7] = ec.inf_aos32(1, dev)
    before = KL.KERNELS["K2b_bucket_aggregate"].launches
    got = MK.aggregate_buckets_aos32(sums, nwin, nb)
    assert KL.KERNELS["K2b_bucket_aggregate"].launches == before + 1
    assert torch.equal(got, MK.aggregate_buckets_plain(sums, nwin, nb))


@pytest.mark.parametrize("n", [256, 1000, 5003])
@pytest.mark.parametrize("case", ["random", "all-equal", "all-zero"])
def test_k1_bucket_sums(dev, case, n):
    """K1's four kernels against the plain version after normalization, at
    n not a multiple of the walk's segment or block (5003 points: all-equal
    buckets span several walk blocks)."""
    c = 5
    soa = ec.aos32_to_soa16(_points(64, dev, 5)[torch.arange(n, device=dev) % 64])
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
    shared = ("K1a_bucket_count", "K1b_bucket_scatter", "K1c_bucket_walk", "K1d_bucket_pieces")
    before = {k: KL.KERNELS[k].launches for k in (*shared, "K1_fixed")}
    got = MK.bucket_sums(soa, digits, negs, c)
    assert {k: KL.KERNELS[k].launches - v for k, v in before.items()} == \
        {**{k: 1 for k in shared}, "K1_fixed": 0}
    want = MK.bucket_sums_plain(soa, digits, negs, c)
    flat = lambda t: ec.normalize_std(ec.soa16_to_aos32(t.permute(1, 0, 2).reshape(48, -1)))  # noqa: E731
    assert torch.equal(flat(got), flat(want))


def test_k1_plan_kernels(dev):
    """K1a equals the plain counts exactly; K1b places the same entries in
    each bucket as the plain stable sort (the order inside a bucket is the
    kernel's atomics')."""
    n, c = 40000, 6           # three plan blocks per window
    nb = 1 << (c - 1)
    g = torch.Generator(device=dev).manual_seed(11)
    digits = torch.randint(-nb + 1, nb + 1, (3, n), generator=g, dtype=torch.int32, device=dev)
    negs = (torch.arange(n, device=dev) % 7 == 0).to(torch.int32)[None]
    P, _ = MK.plan_blocks(n)
    counts, bstart, entries = MK.bucket_plan(digits, negs, c)
    assert torch.equal(counts, MK.bucket_counts_plain(digits, nb, P))
    want = MK.bucket_scatter_plain(digits, negs, nb)
    E = int(bstart[-1])      # the slots past E are not written
    key = torch.bucketize(torch.arange(E, device=dev), bstart[1:].long(), right=True)
    order = lambda e: torch.sort(key.long() * (1 << 32) + (e[:E].long() & 0xFFFFFFFF)).values  # noqa: E731
    assert torch.equal(order(entries), order(want))


def test_msm_matches_host(dev):
    n = 300
    r = random.Random(7)
    pts = [bn254.g1_curve.mul(bn254.G1_GEN, r.randrange(1, bn254.R)) for _ in range(n)]
    sc = [r.randrange(bn254.R) for _ in range(n)]
    base = ec.encode_points(pts, dev)
    want = bn254.g1_curve.msm(pts, sc)
    assert M.msm_base(base, F.from_ints(F.fr_ctx(), sc, dev)) == want


@pytest.mark.parametrize("case", ["random", "all-equal"])
def test_k1_fixed_form(dev, case):
    """K1's fixed-base form (window w reads its own table rows w * N + i)
    against its plain version after normalization, one launch of each of
    K1a, the fixed-form scatter, K1c and K1d; the shared form's scatter
    not launched."""
    n, c, nwin = 3000, 5, 4
    tables = torch.stack([_points(64, dev, 30 + w)[torch.arange(n, device=dev) % 64]
                          for w in range(nwin)])
    g = torch.Generator(device=dev).manual_seed(12)
    half = 1 << (c - 1)
    digits = torch.randint(-half + 1, half + 1, (nwin, 1 if case == "all-equal" else n),
                           generator=g, dtype=torch.int32, device=dev).expand(nwin, n)
    digits = digits.contiguous()
    negs = (torch.arange(n, device=dev) % 3 == 0).to(torch.int32)[None]
    soa = MK.to_soa_windows(tables)
    names = ("K1a_bucket_count", "K1_fixed", "K1c_bucket_walk", "K1d_bucket_pieces",
             "K1b_bucket_scatter")
    before = {k: KL.KERNELS[k].launches for k in names}
    got = MK.bucket_sums_fixed(soa, digits, negs, c)
    after = {k: KL.KERNELS[k].launches - before[k] for k in names}
    assert after == {**{k: 1 for k in names[:4]}, "K1b_bucket_scatter": 0}
    want = MK.bucket_sums_fixed_plain(soa, digits, negs, c)
    flat = lambda t: ec.normalize_std(ec.soa16_to_aos32(t.permute(1, 0, 2).reshape(48, -1)))  # noqa: E731
    assert torch.equal(flat(got), flat(want))


@pytest.mark.parametrize("mode", ["vanilla", "glv", "glv+signed", "fixed"])
def test_msm_modes_match_host(dev, mode):
    """One MSM per mode on the card equals the host sum; the GLV split runs
    on the card, and the fixed mode launches its K1 form and K2."""
    n = 300
    r = random.Random(17)
    pts = [bn254.g1_curve.mul(bn254.G1_GEN, r.randrange(1, bn254.R)) for _ in range(n)]
    sc = [r.randrange(bn254.R) for _ in range(n)]
    sc[:3] = [0, 1, bn254.R - 1]
    base = ec.encode_points(pts, dev)
    before = KL.launch_counts()
    got = M.msm_base(base, F.from_ints(F.fr_ctx(), sc, dev), mode=mode, base_key=f"test-{n}")
    launched = {k: v - before[k] for k, v in KL.launch_counts().items()}
    assert got == bn254.g1_curve.msm(pts, sc)
    assert launched["K1_fixed"] == (mode == "fixed")
    assert launched["K1b_bucket_scatter"] == (mode != "fixed")
    assert (launched["K2_padd"] > 0) == (mode == "fixed")


def test_outer_prove_k17_equals_reference_record(dev):
    """The AggregationCircuit over the k=10 inner proof, keyed and proved at
    k=17 under Keccak on the card (tests/_torch_agg_k17.py): the reference's
    vk digest, statement and proof bytes, as tests/data/torch_agg_k17_keccak
    .json records them; AggregationCircuit.verify accepts the proof and
    rejects a flipped accumulator limb."""
    import _torch_agg_k17 as K17
    from spectre_tpu_torch.plonk.transcript import KeccakTranscript

    record = K17.read_record()
    circuit, pk, srs, stmt, proof = K17.port_outer(dev)
    assert pk.vk.config.k == record["k"]
    assert pk.vk.digest().hex() == record["vk_digest"]
    assert [hex(v) for v in stmt] == record["instances"]
    assert proof.hex() == record["proof"]
    assert circuit.verify(pk.vk, srs, stmt, proof, device=dev, transcript_cls=KeccakTranscript)
    bad = list(stmt)
    bad[0] = (bad[0] + 1) % bn254.R
    assert not circuit.verify(pk.vk, srs, bad, proof, device=dev,
                              transcript_cls=KeccakTranscript)
