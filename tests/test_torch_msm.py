"""The port's EC and MSM ops on the CPU (plain versions of K1 and K2)
against the JAX reference and the host curve.

K2 plain is compared limb for limb with the reference's real `pallas_call`
(`msm_pallas.padd_soa`, interpret mode off-TPU); K1 plain with a host
bucket oracle after affine normalization; the MSM with the host curve and
the reference's CpuBackend. Exact comparisons throughout.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from spectre_tpu.fields import bn254 as rbn
from spectre_tpu.ops import ec as REC, msm_pallas as MP
from spectre_tpu.plonk.backend import CpuBackend
from spectre_tpu_torch.fields import bn254
from spectre_tpu_torch.ops import ec, field_ops as F, limbs as L
from spectre_tpu_torch.ops import msm as M, msm_kernels as MK


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads per test process: the tier-1 run has six workers
    on one machine, and timing-sensitive tests elsewhere share its cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


g1 = bn254.g1_curve


def _scalars(n: int, seed: int) -> list[int]:
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2 ** 63, size=(n, 4), dtype=np.uint64)
    return [int.from_bytes(w.astype("<u8").tobytes(), "little") % bn254.R for w in words]


def _points(n: int, seed: int) -> list:
    return [g1.mul(bn254.G1_GEN, s or 1) for s in _scalars(n, seed)]


def _ref_points(pts):
    return [None if p is None else (rbn.Fq(int(p[0])), rbn.Fq(int(p[1]))) for p in pts]


@pytest.fixture(scope="module")
def pair_batch():
    """8 generic pairs, then P+P, P+(-P), inf+P, inf+inf, as host points."""
    a = _points(8, 1)
    b = _points(8, 2)
    p = a[0]
    a += [p, p, None, None]
    b += [p, g1.neg(p), p, None]
    return a, b


class TestK2Plain:
    def test_soa_layout_is_the_reference_layout(self, pair_batch):
        a, _ = pair_batch
        ours = ec.aos32_to_soa16(ec.encode_points(a, "cpu"))
        ref = MP.to_soa(REC.encode_points(_ref_points(a)))
        assert np.array_equal(ours.numpy(), np.asarray(ref).astype(np.int32))
        assert torch.equal(MK.to_soa(MK.from_soa(ours)), ours)

    def test_matches_pallas_padd_soa_limb_for_limb(self, pair_batch):
        a, b = pair_batch
        pa = ec.aos32_to_soa16(ec.encode_points(a, "cpu"))
        pb = ec.aos32_to_soa16(ec.encode_points(b, "cpu"))
        got = MK.padd_soa(pa, pb)
        want = MP.padd_soa(jnp.asarray(pa.numpy().astype(np.uint32)),
                           jnp.asarray(pb.numpy().astype(np.uint32)))
        assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int32))
        # and a second round on projective (Z != 1) inputs
        got2 = MK.padd_soa(got, pa)
        want2 = MP.padd_soa(want, jnp.asarray(pa.numpy().astype(np.uint32)))
        assert np.array_equal(got2.numpy(), np.asarray(want2).astype(np.int32))

    def test_group_law(self, pair_batch):
        a, b = pair_batch
        out = ec.decode_points(MK.padd_aos32(ec.encode_points(a, "cpu"),
                                             ec.encode_points(b, "cpu")))
        assert out == [g1.add(x, y) for x, y in zip(a, b)]

    def test_layout_roundtrips_and_normalize(self, pair_batch):
        a, _ = pair_batch
        aos = ec.encode_points(a, "cpu")
        assert torch.equal(ec.soa16_to_aos32(ec.aos32_to_soa16(aos)), aos)
        assert torch.equal(ec.rows16_to_aos32(ec.aos32_to_rows16(aos)), aos)
        xy = F.tensor_to_u64(ec.normalize_std(MK.padd_aos32(aos, aos)))
        want = [g1.double(p) for p in a]
        got = L.limbs_to_ints(xy.reshape(-1, 4))
        assert got[0::2] == [0 if p is None else int(p[0]) for p in want]
        assert got[1::2] == [0 if p is None else int(p[1]) for p in want]

    def test_rejects_bad_inputs(self):
        with pytest.raises(TypeError):
            MK.padd_soa(torch.zeros((48, 4), dtype=torch.int64),
                        torch.zeros((48, 4), dtype=torch.int64))
        with pytest.raises(ValueError):
            MK.padd_soa(torch.zeros((47, 4), dtype=torch.int32),
                        torch.zeros((47, 4), dtype=torch.int32))


def _host_buckets(pts, digits, negs, nb):
    """Per (window, bucket) host sums of the conditionally negated points."""
    out = []
    for w in range(digits.shape[0]):
        row = [None] * nb
        for i, p in enumerate(pts):
            d = int(digits[w, i])
            if d == 0:
                continue
            q = g1.neg(p) if (d < 0) != bool(negs[0, i]) else p
            row[abs(d) - 1] = g1.add(row[abs(d) - 1], q)
        out.append(row)
    return out


class TestK1Plain:
    @pytest.mark.parametrize("case", ["random", "all-equal", "all-zero", "skew-chunks"])
    def test_bucket_sums_match_host_oracle(self, case):
        n, c = 40, 3
        pts = _points(n, 5)
        if case == "random":
            sc = _scalars(n, 6)
        elif case == "all-equal":
            sc = [_scalars(1, 7)[0]] * n
        elif case == "all-zero":
            sc = [0] * n
        else:   # one digit everywhere: buckets longer than one chunk
            sc = [5] * n
        soa = ec.aos32_to_soa16(ec.encode_points(pts, "cpu"))
        std = torch.from_numpy(L.ints_to_limbs(sc).view(np.int64))
        nwin = M.num_windows(c)
        digits = M.signed_digit_stream(std, c, nwin)
        negs = torch.from_numpy(np.arange(n, dtype=np.int32) % 3 == 0).to(torch.int32)[None]
        got = MK.bucket_sums(soa, digits, negs, c)
        assert got.shape == (nwin, 48, 1 << (c - 1))
        flat = ec.decode_points(ec.soa16_to_aos32(got.permute(1, 0, 2).reshape(48, -1)))
        want = _host_buckets(pts, digits.numpy(), negs.numpy(), 1 << (c - 1))
        assert flat == [p for row in want for p in row]

    def test_signed_digits_recombine(self):
        sc = _scalars(16, 8) + [0, bn254.R - 1]
        std = torch.from_numpy(L.ints_to_limbs(sc).view(np.int64))
        for c in (3, 4, 11):
            d = M.signed_digit_stream(std, c, M.num_windows(c)).numpy()
            assert np.abs(d).max() <= 1 << (c - 1)
            back = [sum(int(d[w, i]) << (c * w) for w in range(d.shape[0]))
                    for i in range(len(sc))]
            assert back == sc

    def test_window_table_matches_reference(self):
        from spectre_tpu.ops import msm as RM
        for logn in (5, 7, 12, 16, 18, 21):
            assert M.default_window_pallas(1 << logn) == RM.default_window_pallas(1 << logn)


class TestMsm:
    @pytest.mark.parametrize("case", ["ragged", "all-equal"])
    def test_against_host_and_cpu_backend(self, case):
        n = 33
        pts = _points(n, 9)
        pts[4] = pts[7]                                   # repeated point
        sc = _scalars(n, 10) if case == "ragged" else [_scalars(1, 11)[0]] * n
        sc[0], sc[1] = 0, bn254.R - 1
        base = ec.aos32_to_soa16(ec.encode_points(pts, "cpu"))
        got = M.msm(base, F.from_ints(F.fr_ctx(), sc, "cpu"))
        assert got == g1.msm(pts, sc)
        lim = np.array([[int(p[0]) >> (64 * j) & (2 ** 64 - 1) for j in range(4)]
                        + [int(p[1]) >> (64 * j) & (2 ** 64 - 1) for j in range(4)]
                        for p in pts], dtype=np.uint64)
        ref = CpuBackend().msm(lim, L.ints_to_limbs(sc))
        assert (int(got[0]), int(got[1])) == (int(ref[0]), int(ref[1]))

    def test_zero_msm_is_infinity(self):
        pts = _points(5, 12)
        base = ec.aos32_to_soa16(ec.encode_points(pts, "cpu"))
        assert M.msm(base, F.from_ints(F.fr_ctx(), [0] * 5, "cpu")) is None


@pytest.mark.slow
def test_plain_k1_matches_jitted_pallas_body():
    """The reference's kernel body itself (`_k_bucket_accumulate`, ~40 s of
    XLA compile, hence slow as the reference marks it) and K1's plain
    version agree after normalization."""
    n, nb = 8, 4
    pts = _points(n, 13)
    soa = ec.aos32_to_soa16(ec.encode_points(pts, "cpu"))
    digs = np.array([[1, -2, 0, 2, 4, -1, 2, 3]], np.int32)
    negs = np.array([[0, 1, 0, 0, 1, 0, 0, 1]], np.int32)
    got = MK.bucket_sums(soa, torch.from_numpy(digs), torch.from_numpy(negs), 3)
    buckets = jnp.broadcast_to(MP.inf_soa(1)[:, :1][None], (1, MP.ROWS, nb))
    want = jax.jit(MP._k_bucket_accumulate)(
        jnp.asarray(soa.numpy().astype(np.uint32))[None], jnp.asarray(digs),
        jnp.asarray(negs.astype(np.uint32)), buckets)
    want_pts = REC.decode_points(MP.from_soa(jnp.asarray(want[0])))
    got_pts = ec.decode_points(ec.soa16_to_aos32(got[0]))
    assert [None if p is None else (int(p[0]), int(p[1])) for p in got_pts] == \
        [None if p is None else (int(p[0]), int(p[1])) for p in want_pts]
