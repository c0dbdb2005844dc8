"""The port's GLV split, endomorphism and fixed-base window table on the CPU,
against the JAX reference and the host curve.

The host decomposition and the torch device split (`glv.decompose_device`)
equal the reference's `decompose_batch` and `decompose_device` limb for limb
on seeded scalars, the reference's boundary scalars and scalars at the
Babai rounding's edges; `ec.endo`, `fixed_base_table` and K1's fixed-base
form (plain version) equal the reference's after affine normalization and a
host oracle; each MSM mode equals the host sum, and the fixed mode the
reference's `MSM.msm(mode="fixed")`. Exact comparisons throughout.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from spectre_tpu.fields import bn254 as rbn
from spectre_tpu.ops import ec as REC, glv as RG, limbs as RL, msm as RM
from spectre_tpu_torch.fields import bn254
from spectre_tpu_torch.ops import ec, field_ops as F, glv as G
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
    words[:, 3] |= rng.integers(0, 2, size=n, dtype=np.uint64) << np.uint64(63)
    return [int.from_bytes(w.astype("<u8").tobytes(), "little") % bn254.R for w in words]


def _edge_scalars() -> list[int]:
    """The reference's boundary scalars (tests/test_msm_modes.py)."""
    lam = G.lam()
    return [0, 1, 2, bn254.R - 1, bn254.R - 2, lam, bn254.R - lam, lam - 1,
            (bn254.R - 1) // 2, 1 << 128, (1 << 253) - 1]


def _babai_edges() -> list[int]:
    """Scalars that put 2 k b + r within a few units of a multiple of 2r,
    where an inexact floor division would be off by one."""
    (_, b1), (_, b2) = G._constants()[2]
    out = []
    for bb in (b2, -b1):
        for q in (1, 2, (1 << 125) // 7, (1 << 126) // 3):
            k0 = ((2 * q - 1) * bn254.R) // (2 * bb)
            out += [(k0 + d) % bn254.R for d in (-2, -1, 0, 1, 2)]
    return out


def _points(n: int, seed: int) -> list:
    return [g1.mul(bn254.G1_GEN, s or 1) for s in _scalars(n, seed)]


def _ints(pts) -> list:
    return [None if p is None else (int(p[0]), int(p[1])) for p in pts]


KS = _scalars(256, 1) + _edge_scalars() + _babai_edges()


def test_constants_equal_reference():
    assert G._constants() == RG._constants()
    assert (G.beta(), G.lam()) == (RG.beta(), RG.lam())
    assert G.glv_bits() == RG.glv_bits() == 126
    assert G._device_consts() == {k: [int(x) for x in v]
                                  for k, v in RG._device_consts().items()}


def test_host_decomposition_equals_reference():
    got, want = G.decompose_batch(KS), RG.decompose_batch(KS)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    sc16 = RL.ints_to_limbs16(KS)
    assert all(np.array_equal(g, w) for g, w in zip(G.decompose_limbs16(sc16), want))
    lam = G.lam()
    for k in KS[:32] + _edge_scalars():
        k1, k2 = G.decompose(k)
        assert (k1 + k2 * lam) % bn254.R == k % bn254.R


def test_sign_patterns_cover_all_four():
    """Full-size scalars reach every sign pattern of (k1, k2)."""
    _, _, n1, n2 = G.decompose_batch(KS)
    assert {(bool(a), bool(b)) for a, b in zip(n1, n2)} == \
        {(False, False), (False, True), (True, False), (True, True)}


def test_device_split_equals_reference_limb_for_limb():
    """The torch split and the reference's traced split on the same 16-bit
    limb scalars: magnitudes and signs equal, and equal to the host
    oracle."""
    sc16 = RL.ints_to_limbs16(KS)
    got = G.decompose_device(torch.from_numpy(sc16.astype(np.int64)))
    want = [np.asarray(v) for v in RG.decompose_device(jnp.asarray(sc16))]
    host = G.decompose_batch(KS)
    for g, w, h in zip(got, want, host):
        g = g.numpy()
        assert np.array_equal(g.astype(w.dtype), w)
        assert np.array_equal(g.astype(h.dtype), h)


def test_glv_scalars_recompose():
    """The MSM's split ([8, 2n] magnitudes, [1, 2n] signs) recomposes to k
    through lambda."""
    ks = KS[:40]
    std = F.from_mont(F.fr_ctx(), F.from_ints(F.fr_ctx(), ks, "cpu"))
    mags, negs = M.glv_scalars(std)
    n, lam = len(ks), G.lam()
    val = lambda col: sum(int(mags[j, col]) << (16 * j) for j in range(8))  # noqa: E731
    for i, k in enumerate(ks):
        k1 = -val(i) if negs[0, i] else val(i)
        k2 = -val(n + i) if negs[0, n + i] else val(n + i)
        assert (k1 + k2 * lam) % bn254.R == k


@pytest.mark.parametrize("c", [4, 8, 13])
def test_signed_digits_of_half_scalars(c):
    """Digits of 126-bit magnitudes stay in range and sum back."""
    vals = [0, 1, (1 << 126) - 1, 1 << (c - 1), (1 << c) - 1] + \
        [k >> 128 for k in _scalars(16, 2)]
    limbs = torch.tensor([[(v >> (16 * j)) & 0xFFFF for v in vals] for j in range(8)])
    nwin = M.num_windows(c, 126)
    digs = M.signed_digits(limbs, c, nwin)
    half = 1 << (c - 1)
    assert int(digs.min()) >= -half + 1 and int(digs.max()) <= half
    assert [sum(int(digs[w, i]) << (c * w) for w in range(nwin))
            for i in range(len(vals))] == vals


def test_endo_equals_reference():
    pts = _points(6, 3) + [None]
    got = ec.decode_points(ec.endo(ec.encode_points(pts, "cpu")))
    want = REC.decode_points(REC.endo(REC.encode_points(
        [None if p is None else (rbn.Fq(int(p[0])), rbn.Fq(int(p[1]))) for p in pts])))
    assert _ints(got) == _ints(want)
    lam = G.lam()
    assert got == [None if p is None else g1.mul(p, lam) for p in pts]


def test_k1_fixed_plain_equals_host_oracle():
    """Per-window bucket sums over each window's own points: bucket j of
    window w is sum over i with |d_wi| = j of (-1)^(d_wi < 0 xor neg_i)
    T[w][i]."""
    nwin, n, c = 3, 10, 3
    host = [_points(n, 10 + w) for w in range(nwin)]
    host[1][4] = None
    table = torch.stack([ec.encode_points(h, "cpu") for h in host])
    rng = np.random.default_rng(5)
    digits = torch.from_numpy(rng.integers(-3, 5, size=(nwin, n)).astype(np.int32))
    negs = torch.from_numpy((rng.integers(0, 2, size=(1, n))).astype(np.int32))
    soa = MK.to_soa_windows(table)
    got = MK.bucket_sums_fixed_plain(soa, digits, negs, c)
    nb = 1 << (c - 1)
    for w in range(nwin):
        want = [None] * nb
        for i in range(n):
            d = int(digits[w, i])
            if d == 0 or host[w][i] is None:
                continue
            p = g1.neg(host[w][i]) if (d < 0) != bool(negs[0, i]) else host[w][i]
            want[abs(d) - 1] = g1.add(want[abs(d) - 1], p)
        assert ec.decode_points(ec.soa16_to_aos32(got[w])) == want
    assert torch.equal(MK.bucket_sums_fixed(soa, digits, negs, c), got)
    with pytest.raises(ValueError):
        MK.bucket_sums_fixed(soa[:2], digits, negs, c)


@pytest.fixture(scope="module")
def msm_case():
    """40 points (one at infinity) and scalars with 0, 1 and r - 1, their
    host sum, the reference's fixed-mode MSM at c = 3 (one XLA compile,
    ~40 s) and the reference's encoding of the points."""
    n = 40
    pts = _points(n, 6)
    pts[3] = None
    sc = _scalars(n, 7)
    sc[:3] = [0, 1, bn254.R - 1]
    rpts = REC.encode_points([None if p is None else (rbn.Fq(int(p[0])), rbn.Fq(int(p[1])))
                              for p in pts])
    ref = REC.decode_points(RM.msm(rpts, jnp.asarray(RL.ints_to_limbs16(sc)), c=3,
                                   mode="fixed", base_key="glv-msm")[None])[0]
    return pts, sc, g1.msm(pts, sc), ref, rpts


def test_fixed_base_table_equals_reference(msm_case):
    """The 40 points' table at c = 3: 43 windows of [P ; phi(P)] times
    2^(3 w), against the reference's (cached by the fixture's MSM)."""
    pts, _, _, _, rpts = msm_case
    n, c = len(pts), 3
    nwin = M.num_windows(c, 126)
    got = M.fixed_base_table(ec.encode_points(pts, "cpu"), c, nwin, base_key="glv-msm")
    assert got.shape == (nwin, 2 * n, 24)
    want = RM.fixed_base_table(rpts, c, nwin, base_key="glv-msm")
    assert _ints(ec.decode_points(got.reshape(-1, 24))) == _ints(REC.decode_points(want))
    assert M.fixed_table_bytes(n, c, 126) == RM._fixed_table_bytes(n, c, 126)
    assert M.fixed_table_device_bytes(n, c, 126) == got.numel() * 4
    M.clear_tables()


@pytest.mark.parametrize("mode", ["vanilla", "glv", "glv+signed", "fixed"])
def test_msm_modes_equal_host_sum(msm_case, mode):
    pts, sc, want, ref, _ = msm_case
    base = ec.encode_points(pts, "cpu")
    got = M.msm_base(base, F.from_ints(F.fr_ctx(), sc, "cpu"), mode=mode)
    assert got == want
    if mode == "fixed":
        assert _ints([ref]) == _ints([want])
        again = M.msm_base(base, F.from_ints(F.fr_ctx(), sc, "cpu"), c=3, mode="fixed")
        assert _ints([again]) == _ints([ref])
    M.clear_tables()
