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
from spectre_tpu_torch.ops import ec, field_mxu as MX, field_ops as F, kernel_lib as KL
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


def test_k4_splits_a_batch_above_its_grid(dev):
    """A batch of more than MAX_BATCH polynomials (the four-step's rows at
    2^24 from 16 columns on) runs in launches of at most MAX_BATCH."""
    logn, batch = 2, N.MAX_BATCH + 3
    x = torch.randint(0, 1 << 62, (batch, 1 << logn, 4), dtype=torch.int64, device=dev)
    x[..., 3] &= (1 << 61) - 1                                  # below 2^253 < r
    tables = N.Twiddles(dev)
    tw = tables.twiddles(bn254.fr_root_of_unity(logn), 1 << logn)
    before = KL.KERNELS["K4_ntt"].launches
    got = N.ntt_passes(x, tw)
    assert KL.KERNELS["K4_ntt"].launches == before + 2 * len(N.ntt_plan(logn))
    assert torch.equal(got, N.ntt_passes_plain(x, tw))


@pytest.mark.parametrize("field", ["fr", "fq"])
@pytest.mark.parametrize("n", [1, 63, 513, (1 << 20) + 3])
def test_k7_mont_mul_mxu(dev, field, n):
    """The tensor-core product against its plain version and K3, at odd
    element counts (part-filled warps and m-tiles; past one wave of the
    persistent grid at 2^20 + 3), b whole and of one row."""
    ctx = F.fr_ctx() if field == "fr" else F.fq_ctx()
    a, b = _fe(ctx, n, dev, 11 + n), _fe(ctx, n, dev, 12 + n)
    before = KL.KERNELS["K7_mont_mul_mxu"].launches
    got = MX.mont_mul(ctx, a, b)
    assert KL.KERNELS["K7_mont_mul_mxu"].launches == before + 1
    assert torch.equal(got, MX.mont_mul_mxu_plain(ctx, a, b))
    assert torch.equal(got, F.mont_mul_cios(ctx, a, b))
    assert torch.equal(MX.mont_mul(ctx, a, b[:1]), MX.mont_mul_mxu_plain(ctx, a, b[:1]))


@pytest.mark.parametrize("logn,rows", [(1, 63), (4, 513), (6, 63), (9, 512), (10, 3), (11, 64),
                                       (12, 2)])
def test_k8_dft_matmul(dev, logn, rows):
    """The tensor-core DFT against its plain version, its factored replica
    and K4 on the same rows, one launch a pass of its plan, at odd row
    counts, lengths below one m-tile, one direct pass (up to 2^6) and two
    (odd log n included)."""
    n = 1 << logn
    x = _fe(F.fr_ctx(), rows * n, dev, 13 + logn).reshape(rows, n, 4)
    tables = N.Twiddles(dev)
    w = bn254.fr_root_of_unity(logn)
    before = KL.KERNELS["K8_ntt_dft_matmul"].launches
    got = N.dft_matmul(x, tables, w)
    assert KL.KERNELS["K8_ntt_dft_matmul"].launches == before + len(N.dft_plan(logn))
    assert torch.equal(got, N.dft_matmul_plain(x, tables.dft_matrix8(logn, w)))
    assert torch.equal(got, N.dft_factored_plain(x, tables, w))
    assert torch.equal(got, N.ntt_passes(x, tables.twiddles(w, n)))


@pytest.mark.parametrize("mxu", [False, True])
def test_fourstep_modes_equal_radix2(dev, mxu):
    """The four-step transform, its twiddle product K3 or K7, under both
    short-transform bodies, equals K4's radix-2 transform on a [3, 2^16]
    batch, forward, inverse and as a coset LDE."""
    logn = 16
    x = _fe(F.fr_ctx(), 3 << logn, dev, 17).reshape(3, 1 << logn, 4)
    w = bn254.fr_root_of_unity(logn)
    want = [N.ntt(x, w, mode="radix2"), N.intt(x, w, mode="radix2"),
            N.coset_lde(x[:, :1 << 14], w, 7, 1 << logn, mode="radix2")]
    before = F.mxu_enabled()
    try:
        F.enable_mxu(mxu)
        for kernel in N.NTT_KERNELS:
            got = [N.ntt(x, w, mode="fourstep", kernel=kernel),
                   N.intt(x, w, mode="fourstep", kernel=kernel),
                   N.coset_lde(x[:, :1 << 14], w, 7, 1 << logn, mode="fourstep",
                               kernel=kernel)]
            assert all(torch.equal(g, v) for g, v in zip(got, want)), kernel
    finally:
        F.enable_mxu(before)


def test_k2_padd_edge_cases(dev):
    p = _points(64, dev, 4)
    x, y, z = ec.aos32_coords(p)
    neg = ec.coords_to_aos32(x, F.neg(F.fq_ctx(), y), z)
    inf = ec.inf_aos32(64, dev)
    lhs = ec.aos32_to_soa16(torch.cat([p, p, p, inf, inf]))
    rhs = ec.aos32_to_soa16(torch.cat([torch.roll(p, 1, 0), p, neg, p, inf]))
    assert torch.equal(MK.padd_soa(lhs, rhs), MK.padd_soa_plain(lhs, rhs))


@pytest.mark.parametrize("nwin,nb", [(3, 1), (2, 8), (2, 512), (24, 1024), (1, 4096),
                                     (10, 4096), (256, 256)])
def test_k2b_aggregate(dev, nwin, nb):
    """K2b, one launch, against its plain version limb for limb: one bucket
    a window, one block a window, windows over 2 to 64 blocks (the MSM's
    24 x 1024, the fixed mode's 1 x 4096, the glv modes' 10 x 4096) with the
    ticket merge, and runs of 2 buckets a thread, on projective sums with
    empty buckets; twice, as the ticket counters must be back at 0."""
    base = _points(64, dev, 8)
    pts = base[torch.arange(nwin * nb, device=dev) % 64]
    sums = MK.padd_aos32(pts, torch.roll(pts, 5, 0))
    sums[::7] = ec.inf_aos32(1, dev)
    before = KL.KERNELS["K2b_bucket_aggregate"].launches
    got = MK.aggregate_buckets_aos32(sums, nwin, nb)
    assert KL.KERNELS["K2b_bucket_aggregate"].launches == before + 1
    want = MK.aggregate_buckets_plain(sums, nwin, nb)
    assert torch.equal(got, want)
    assert torch.equal(MK.aggregate_buckets_aos32(sums, nwin, nb), want)


@pytest.mark.parametrize("nwin,nb", [(24, 1024), (1, 4096), (10, 4096)])
def test_k2b_repeated_launches_agree(dev, nwin, nb):
    """K2b launched 300 times on one input, with K2 launches between some
    of them, gives the same limbs every time and leaves its ticket counters
    at 0: the window's last block reads every block's pair only after it is
    written, whichever block finishes last."""
    base = _points(64, dev, 9)
    pts = base[torch.arange(nwin * nb, device=dev) % 64]
    sums = MK.padd_aos32(pts, torch.roll(pts, 3, 0))
    sums[::5] = ec.inf_aos32(1, dev)
    want = MK.aggregate_buckets_plain(sums, nwin, nb)
    differ = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(300):
        got = MK.aggregate_buckets_aos32(sums, nwin, nb)
        differ += (got != want).any()
        if i % 7 == 0:
            MK.padd_aos32(pts, pts)
    assert int(differ) == 0
    assert int(MK._K2B_TICKETS[sums.device].abs().sum()) == 0


def test_k1_fixed_walk_repeated_launches_agree(dev):
    """The fixed walk launched 40 times over one plan of a built table (the
    entries' order inside a bucket fixed) gives the same limbs every time,
    and equals its plain version after normalization."""
    from spectre_tpu_torch.ops import glv
    n, c = 1 << 14, 13
    nwin = M.num_windows(c, glv.glv_bits())
    table = M.build_window_table(_points(64, dev, 35)[torch.arange(n, device=dev) % 64],
                                 c, nwin)
    g = torch.Generator(device=dev).manual_seed(36)
    half = 1 << (c - 1)
    digits = torch.randint(-half + 1, half + 1, (nwin, 2 * n), generator=g,
                           dtype=torch.int32, device=dev)
    negs = (torch.arange(2 * n, device=dev) % 3 == 0).to(torch.int32)[None]
    rows = table.reshape(-1, 24)
    _, bstart, entries = MK.bucket_plan(digits, negs, c, fixed=True)
    first = MK.bucket_walk_fixed(rows, entries, bstart)
    differ = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(40):
        differ += (MK.bucket_walk_fixed(rows, entries, bstart) != first).any()
    assert int(differ) == 0
    want = MK.bucket_walk_fixed_plain(rows, entries, bstart)
    assert torch.equal(ec.normalize_std(first), ec.normalize_std(want))


def test_k1_repeated_launches_agree(dev):
    """K1's plan and walk (shared base) launched 40 times on one input: the
    counts are the same every time, and so are the bucket sums after
    normalization (the order inside a bucket is free); the walk over one
    fixed plan gives the same limbs every time."""
    n, c, nwin = 1 << 16, 11, 24
    pts = _points(64, dev, 37)[torch.arange(n, device=dev) % 64]
    g = torch.Generator(device=dev).manual_seed(38)
    half = 1 << (c - 1)
    digits = torch.randint(-half + 1, half + 1, (nwin, n), generator=g,
                           dtype=torch.int32, device=dev)
    negs = torch.zeros((1, n), dtype=torch.int32, device=dev)
    counts, bstart, entries = MK.bucket_plan(digits, negs, c)
    first = MK.bucket_walk(pts, entries, bstart)
    norm = ec.normalize_std(first)
    differ = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(40):
        differ += (MK.bucket_walk(pts, entries, bstart) != first).any()
        c2, b2, e2 = MK.bucket_plan(digits, negs, c)
        differ += (c2 != counts).any() + (b2 != bstart).any()
        differ += (ec.normalize_std(MK.bucket_walk(pts, e2, b2)) != norm).any()
    assert int(differ) == 0


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
    K1a, the fixed-form scatter, the fixed walk and K1d; the shared form's
    scatter and walk not launched."""
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
    names = ("K1a_bucket_count", "K1_fixed", "K1c_fixed_walk", "K1d_bucket_pieces",
             "K1b_bucket_scatter", "K1c_bucket_walk")
    before = {k: KL.KERNELS[k].launches for k in names}
    got = MK.bucket_sums_fixed(soa, digits, negs, c)
    after = {k: KL.KERNELS[k].launches - before[k] for k in names}
    assert after == {**{k: 1 for k in names[:4]}, "K1b_bucket_scatter": 0,
                     "K1c_bucket_walk": 0}
    want = MK.bucket_sums_fixed_plain(soa, digits, negs, c)
    flat = lambda t: ec.normalize_std(ec.soa16_to_aos32(t.permute(1, 0, 2).reshape(48, -1)))  # noqa: E731
    assert torch.equal(flat(got), flat(want))


@pytest.mark.parametrize("case", ["random", "all-equal"])
def test_k1_fixed_walk_on_a_built_table(dev, case):
    """The fixed walk over a table `build_window_table` made (normalised on
    the card, one base point at infinity) at the step's window, c = 13 and
    10 windows, against its plain version after normalization; one launch
    of the walk and of K1d."""
    from spectre_tpu_torch.ops import glv
    n, c = 1500, 13
    nwin = M.num_windows(c, glv.glv_bits())
    base = _points(64, dev, 33)[torch.arange(n, device=dev) % 64]
    base[5] = ec.inf_aos32(1, dev)[0]
    table = M.build_window_table(base, c, nwin)
    MK.check_normalised(table)
    assert int((table[:, 5, 16:] != 0).sum()) == 0 and int((table[:, n + 5, 16:] != 0).sum()) == 0
    g = torch.Generator(device=dev).manual_seed(34)
    half = 1 << (c - 1)
    digits = torch.randint(-half + 1, half + 1, (nwin, 1 if case == "all-equal" else 2 * n),
                           generator=g, dtype=torch.int32, device=dev).expand(nwin, 2 * n)
    digits = digits.contiguous()
    negs = (torch.arange(2 * n, device=dev) % 3 == 0).to(torch.int32)[None]
    rows = table.reshape(-1, 24)
    _, bstart, entries = MK.bucket_plan(digits, negs, c, fixed=True)
    before = {k: KL.KERNELS[k].launches for k in ("K1c_fixed_walk", "K1d_bucket_pieces")}
    got = MK.bucket_walk_fixed(rows, entries, bstart)
    assert {k: KL.KERNELS[k].launches - v for k, v in before.items()} == \
        {"K1c_fixed_walk": 1, "K1d_bucket_pieces": 1}
    want = MK.bucket_walk_fixed_plain(rows, entries, bstart)
    assert torch.equal(ec.normalize_std(got), ec.normalize_std(want))


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
    assert launched["K1_fixed"] == launched["K1c_fixed_walk"] == (mode == "fixed")
    assert launched["K1b_bucket_scatter"] == launched["K1c_bucket_walk"] == (mode != "fixed")
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


def test_step_shaped_outer_prove_verifies(dev):
    """AggregationCircuit.variant("sync_step") over the step-shaped inner
    proof (tests/_torch_step_inner.py: its lookup columns over the nibble,
    nibble_op and range tables, as the sync step's), the inner and the outer
    circuit keyed and proved on the card, the outer at k=17 under Keccak:
    the statement is the exposed cells, AggregationCircuit.verify accepts
    the proof and rejects a flipped accumulator limb."""
    import _torch_step_inner as S
    from spectre_tpu_torch.models.aggregation import (NUM_ACC_LIMBS, AggregationArgs,
                                                      AggregationCircuit)
    from spectre_tpu_torch.plonk.srs import SRS
    from spectre_tpu_torch.plonk.transcript import KeccakTranscript

    pk_in, srs_in, inst, proof_in = S.port_inner(dev)
    assert pk_in.vk.config.lookup_tables == S.TABLES
    args = AggregationArgs(inner_vk=pk_in.vk, srs=srs_in, inner_instances=inst, proof=proof_in)
    circuit = AggregationCircuit.variant("sync_step")
    ctx = circuit.build_context(args, S.OuterSpec, device=dev)
    srs = SRS.unsafe_setup(S.OUTER_K, device=dev)
    pk = circuit.create_pk(srs, S.OuterSpec, S.OUTER_K, args, device=dev, ctx=ctx)
    proof = circuit.prove(pk, srs, args, S.OuterSpec, device=dev, ctx=ctx,
                          transcript=KeccakTranscript(), blinding_rng=S.seeded(S.OUTER_SEED))
    stmt = circuit.get_instances(args, S.OuterSpec)
    assert stmt == [av.value for av in ctx.instance_cells]
    assert stmt[NUM_ACC_LIMBS:] == inst[0] and len(inst[0]) == 2
    assert circuit.verify(pk.vk, srs, stmt, proof, device=dev, transcript_cls=KeccakTranscript)
    bad = list(stmt)
    bad[0] = (bad[0] + 1) % bn254.R
    assert not circuit.verify(pk.vk, srs, bad, proof, device=dev,
                              transcript_cls=KeccakTranscript)


@pytest.mark.parametrize("n", [1, 63, 512, 513])
def test_k6_g1_decompress(dev, n):
    """K6 on n x: n - 1 keys (x = 0 with either sign, seeded points and
    their negations) and x = 1, off the curve, last, so that 1, 63 and 513
    fill a lane group's warp in part. y and the flag equal the plain
    version limb for limb, the keys the host's per-key decompression; an x
    off the curve is flagged and raises; one launch a batch."""
    from spectre_tpu_torch.fields import bls12_381 as bls
    from spectre_tpu_torch.ops import field384 as F384

    g1 = bls.g1_curve
    q = g1.mul(bls.G1_GEN, random.Random(6).randrange(1, 1 << 64))
    keys = [bytes([0x80]) + bytes(47), bytes([0xA0]) + bytes(47)]
    pt = q
    while len(keys) < n - 1:
        keys += [bls.g1_compress(pt), bls.g1_compress(g1.neg(pt))]
        pt = g1.add(pt, q)
    keys = keys[:n - 1]
    ctx = F384.bls_fq_ctx()
    xs = [int.from_bytes(bytes([k[0] & 0x1F]) + k[1:], "big") for k in keys] + [1]
    xm = ctx.to_tensor(xs, dev)
    before = KL.KERNELS["K6_g1_decompress"].launches
    y, ok = F384.decompress_y(xm)
    y_plain, ok_plain = F384.decompress_y_plain(xm)
    assert torch.equal(y, y_plain) and torch.equal(ok, ok_plain)
    assert ok.tolist() == [1] * len(keys) + [0]
    assert KL.KERNELS["K6_g1_decompress"].launches == before + 1
    got = F384.g1_decompress_batch(keys, device=dev)
    assert got == [(int(x), int(y)) for x, y in map(bls.g1_decompress, keys)]
    with pytest.raises(ValueError, match="not on curve"):
        F384.g1_decompress_batch([bytes([0x80]) + (1).to_bytes(47, "big")], device=dev)


def test_step_mock_tiny(dev):
    """The TINY step (24.6 M cells) through AppCircuit.mock on the card at
    k=19, the least k whose rows hold its 2^18-entry range table (the
    reference's own step mock asks for k=17, where that table does not
    fit): satisfied; with one copied advice cell changed, the copy check
    names it in the reference's words."""
    import numpy as np

    from spectre_tpu_torch import spec as SPEC
    from spectre_tpu_torch.models import StepCircuit
    from spectre_tpu_torch.ops import limbs as L
    from spectre_tpu_torch.plonk.constraint_system import column_std
    from spectre_tpu_torch.plonk.mock import mock_prove
    from spectre_tpu_torch.witness import default_sync_step_args

    args = default_sync_step_args(SPEC.TINY)
    assert StepCircuit.mock(args, SPEC.TINY, k=19, device=dev) is True
    ctx = StepCircuit.build_context(args, SPEC.TINY, device=dev)
    cfg = ctx.auto_config(k=19, lookup_bits=StepCircuit.default_lookup_bits)
    asg = ctx.assignment(cfg)
    advice = {cfg.col_gate_advice(j): j for j in range(cfg.num_advice)}
    ca, ra = next((int(c), int(r)) for c, r, _, _ in np.asarray(asg.copies).reshape(-1, 4)
                  if int(c) in advice)
    j = advice[ca]
    col = column_std(asg.advice[j], cfg.n).copy()     # [n, 4] limbs
    old = L.limbs_to_ints(col[ra:ra + 1])[0]
    col[ra] = L.ints_to_limbs([old + 1])[0]
    asg.advice[j] = col
    with pytest.raises(ValueError,
                       match=rf"^copy constraint violated: .*col{ca}\[{ra}\]={old + 1}\b"):
        mock_prove(cfg, asg, device=dev)


@pytest.fixture(scope="module")
def cards(dev):
    """Up to four distinct cards, for a mesh across cards."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA GPUs (a mesh across distinct cards)")
    return [torch.device("cuda", i) for i in range(min(n, 4))]


@pytest.mark.parametrize("env", [
    {"SPECTRE_MSM_MODE": "vanilla"},
    {"SPECTRE_MSM_MODE": "glv+signed"},
    {"SPECTRE_MSM_MODE": "fixed"},
    {"SPECTRE_NTT_MODE": "fourstep", "SPECTRE_NTT_KERNEL": "matmul", "SPECTRE_FIELD_IMPL": "mxu"},
], ids=["vanilla", "glv+signed", "fixed", "fourstep+matmul+mxu"])
def test_mesh_prove_across_cards(cards, env, monkeypatch):
    """The K=6 readiness circuit with the mesh gates at 2^5, proved on a
    plan of distinct cards (2x2 over four, 2x1 over two) while cuda:0
    stays the current device: every card's shards launch their kernels,
    and the proof equals the one-card proof and verifies."""
    from spectre_tpu_torch.parallel import make_mesh, plan_for_mesh
    from spectre_tpu_torch.plonk.backend import TorchBackend
    from spectre_tpu_torch.plonk.prover import prove
    from spectre_tpu_torch.plonk.verifier import verify
    from spectre_tpu_torch.prover_service.selfverify import _tiny_setup

    for gate in ("SPECTRE_SHARD_MSM_MIN_LOGN", "SPECTRE_SHARD_NTT_MIN_LOGN",
                 "SPECTRE_SHARD_QUOTIENT_MIN_LOGN"):
        monkeypatch.setenv(gate, "5")
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    monkeypatch.delenv("SPECTRE_MESH_SHAPE", raising=False)
    torch.cuda.set_device(cards[0])
    pk, srs, asg, out = _tiny_setup(str(cards[0]))
    plan = plan_for_mesh(make_mesh(devices=cards, data_axis=2))
    mxu = F.mxu_enabled()
    F.enable_mxu(env.get("SPECTRE_FIELD_IMPL") == "mxu")
    try:
        r = random.Random(7)
        one = prove(pk, srs, asg, device=cards[0], blinding_rng=lambda: r.randrange(bn254.R))
        for card in cards:
            torch.cuda.reset_peak_memory_stats(card)
        plan.reset_stats()
        r = random.Random(7)
        got = prove(pk, srs, asg, TorchBackend(cards[0], plan=plan),
                    blinding_rng=lambda: r.randrange(bn254.R))
        for card in cards:
            torch.cuda.synchronize(card)
    finally:
        F.enable_mxu(mxu)
        plan.clear()
        M.clear_tables()
    stats = plan.stats()
    assert torch.cuda.current_device() == cards[0].index
    assert stats["sharded_msm"] > 0 and stats["sharded_ntt"] > 0 and stats["quotient"] > 0
    assert all(torch.cuda.max_memory_allocated(card) > 0 for card in cards)
    assert stats["bytes_exchanged"] > 0
    assert got == one
    assert verify(pk.vk, srs, [[out]], got)
