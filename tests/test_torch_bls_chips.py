"""The port's non-native BLS12-381 chips (builder/bigint.py, fp_chip.py,
fp2_chip.py, fp12_chip.py, pairing_chip.py, hash_to_curve_chip.py) on the CPU
against the JAX package's. Each case runs the same operations on a fresh
Context in both packages, from inputs made with numpy from a seed: the
results equal the host field's values, and the two contexts equal each other
stream for stream (advice values, lookup streams, copies, constants, gated
blocks). The sizes are those of the reference's default-tier chip tests; the
soundness cases raise in both packages.
"""

from types import SimpleNamespace

import numpy as np
import pytest

import spectre_tpu.builder as r_builder
import spectre_tpu.builder.fp12_chip as r_fp12
import spectre_tpu.builder.fp2_chip as r_fp2
import spectre_tpu.builder.fp_chip as r_fp
import spectre_tpu.builder.hash_to_curve_chip as r_h2c
import spectre_tpu.builder.pairing_chip as r_pairing
import spectre_tpu.builder.sha256_chip as r_sha
import spectre_tpu.builder.sha256_wide_chip as r_shaw
import spectre_tpu.gadgets.ssz_merkle as r_ssz
import spectre_tpu_torch.builder as t_builder
import spectre_tpu_torch.builder.fp12_chip as t_fp12
import spectre_tpu_torch.builder.fp2_chip as t_fp2
import spectre_tpu_torch.builder.fp_chip as t_fp
import spectre_tpu_torch.builder.hash_to_curve_chip as t_h2c
import spectre_tpu_torch.builder.pairing_chip as t_pairing
import spectre_tpu_torch.builder.sha256_chip as t_sha
import spectre_tpu_torch.builder.sha256_wide_chip as t_shaw
import spectre_tpu_torch.gadgets.ssz_merkle as t_ssz
from spectre_tpu.fields import bls12_381 as r_bls, bn254 as r_bn
from spectre_tpu_torch.fields import bls12_381 as t_bls, bn254 as t_bn
from spectre_tpu_torch.spec import DST

from _torch_ctx_compare import assert_contexts_equal


def _pkg(builder, fp, fp2, fp12, pairing, h2c, sha, shaw, ssz, bls, bn, error):
    return SimpleNamespace(
        Context=builder.Context, RangeChip=builder.RangeChip, GateChip=builder.GateChip,
        FpChip=fp.FpChip, EccChip=fp.EccChip, Fp2Chip=fp2.Fp2Chip, G2Chip=fp2.G2Chip,
        Fp12Chip=fp12.Fp12Chip, tower_to_fq12=fp12.tower_to_fq12,
        fq12_to_tower=fp12.fq12_to_tower, PairingChip=pairing.PairingChip,
        HashToCurveChip=h2c.HashToCurveChip, Sha256Chip=sha.Sha256Chip,
        Sha256WideChip=shaw.Sha256WideChip, load_bytes_checked=ssz.load_bytes_checked,
        bls=bls, bn=bn, error=error)


PORT = _pkg(t_builder, t_fp, t_fp2, t_fp12, t_pairing, t_h2c, t_sha, t_shaw, t_ssz,
            t_bls, t_bn, ValueError)
REF = _pkg(r_builder, r_fp, r_fp2, r_fp12, r_pairing, r_h2c, r_sha, r_shaw, r_ssz,
           r_bls, r_bn, AssertionError)
P = t_bls.P


def _fq(rng) -> int:
    return int.from_bytes(rng.bytes(48), "big") % P


def _fq12_ints(seed: int) -> list[int]:
    rng = np.random.default_rng(seed)
    return [_fq(rng) for _ in range(12)]


def _cyclotomic(m, c: list[int]):
    return m.bls.Fq12(c) ** ((P ** 6 - 1) * (P ** 2 + 1))


def _ints(x):
    """Host values (field elements, points, cells, lists) as ints."""
    if isinstance(x, (list, tuple)):
        return [_ints(v) for v in x]
    if hasattr(x, "c"):
        return [int(v) for v in x.c]
    if hasattr(x, "value"):
        return int(x.value)
    return int(x)


def _fp(m):
    return m.FpChip(m.RangeChip(lookup_bits=8))


def _fp2(m):
    return m.Fp2Chip(_fp(m))


def _fp12(m):
    return m.Fp12Chip(_fp2(m))


def _h2c(m):
    return m.HashToCurveChip(m.PairingChip(_fp12(m)), m.Sha256Chip())


# --- cases: f(m, ctx, seed) -> host values ----------------------------------

def fp_mul_add_sub(m, ctx, seed):
    rng = np.random.default_rng(seed)
    a_v, b_v = _fq(rng), _fq(rng)
    fp = _fp(m)
    a, b = fp.load(ctx, a_v), fp.load(ctx, b_v)
    out = [fp.mul(ctx, a, b).value, fp.add(ctx, a, b).value, fp.sub(ctx, a, b).value]
    assert out == [a_v * b_v % P, (a_v + b_v) % P, (a_v - b_v) % P]
    return out


def fp_edge_values(m, ctx, seed):
    fp = _fp(m)
    z, mx = fp.load(ctx, 0), fp.load(ctx, P - 1)
    out = [fp.mul(ctx, mx, mx).value, fp.add(ctx, mx, fp.load(ctx, 1)).value,
           fp.mul(ctx, z, mx).value]
    assert out == [(P - 1) ** 2 % P, 0, 0]
    return out


def ec_add_double(m, ctx, seed):
    ecc = m.EccChip(_fp(m))
    p1, p2 = m.bls.sk_to_pk(3), m.bls.sk_to_pk(5)
    c1, c2 = ecc.load_point(ctx, p1), ecc.load_point(ctx, p2)
    s, d = ecc.add_unequal(ctx, c1, c2), ecc.double(ctx, c1)
    assert _ints(s) == _ints(m.bls.g1_curve.add(p1, p2))
    assert _ints(d) == _ints(m.bls.g1_curve.double(p1))
    return _ints([s, d])


def ec_add_unequal_lazy_and_select(m, ctx, seed):
    ecc = m.EccChip(_fp(m))
    p1, p2 = m.bls.sk_to_pk(7), m.bls.sk_to_pk(11)
    c1, c2 = ecc.load_point(ctx, p1), ecc.load_point(ctx, p2)
    s = ecc.add_unequal_lazy(ctx, c1, c2)
    assert _ints(s) == _ints(m.bls.g1_curve.add(p1, p2))
    bit = ctx.load_witness(1)
    pick = ecc.select(ctx, bit, s, c1)
    k = ecc.fp.load_constant_point(ctx, m.bls.G1_GEN)
    return _ints([s, pick, k])


def assert_nonzero_honest(m, ctx, seed):
    fp = _fp(m)
    fp.assert_nonzero(ctx, fp.load(ctx, 123456789))
    fp.assert_nonzero(ctx, fp.load(ctx, P - 1))
    return []


def canonicalize(m, ctx, seed):
    fp = _fp(m)
    return [fp.canonicalize(ctx, fp.load(ctx, P - 1)).value]


def fp2_arithmetic(m, ctx, seed):
    fp2 = _fp2(m)
    a_v, b_v = m.bls.Fq2([3, 7]), m.bls.Fq2([11, 13])
    a, b = fp2.load(ctx, a_v), fp2.load(ctx, b_v)
    out = [fp2.value(fp2.mul(ctx, a, b)), fp2.value(fp2.square(ctx, a)),
           fp2.value(fp2.div_unsafe(ctx, a, b)), fp2.value(fp2.conjugate(ctx, a))]
    assert out == [a_v * b_v, a_v * a_v, a_v / b_v, m.bls.Fq2([3, (-7) % P])]
    return _ints(out)


def g2_group_law(m, ctx, seed):
    fp2 = _fp2(m)
    g2 = m.G2Chip(fp2)
    p1, p2 = m.bls.g2_curve.mul(m.bls.G2_GEN, 5), m.bls.g2_curve.mul(m.bls.G2_GEN, 9)
    c1, c2 = g2.load_point(ctx, p1), g2.load_point(ctx, p2)
    s, d = g2.add_unequal(ctx, c1, c2), g2.double(ctx, c1)
    assert (fp2.value(s[0]), fp2.value(s[1])) == m.bls.g2_curve.add(p1, p2)
    assert (fp2.value(d[0]), fp2.value(d[1])) == m.bls.g2_curve.double(p1)
    return _ints([fp2.value(s[0]), fp2.value(s[1]), fp2.value(d[0]), fp2.value(d[1])])


def fp12_mul_square(m, ctx, seed):
    fp12 = _fp12(m)
    x, y = m.bls.Fq12(_fq12_ints(seed)), m.bls.Fq12(_fq12_ints(seed + 1))
    a, b = fp12.load(ctx, x), fp12.load(ctx, y)
    out = [fp12.value(fp12.mul(ctx, a, b)), fp12.value(fp12.square(ctx, a))]
    assert out == [x * y, x * x]
    return _ints(out)


def fp12_cyclotomic_square(m, ctx, seed):
    fp12 = _fp12(m)
    t = _cyclotomic(m, _fq12_ints(seed))
    got = fp12.value(fp12.cyclotomic_square(ctx, fp12.load(ctx, t)))
    assert got == t * t
    return _ints(got)


def fp12_compressed_pow_abs_x(m, ctx, seed):
    fp12 = _fp12(m)
    t = _cyclotomic(m, _fq12_ints(seed))
    got = fp12.value(fp12.pow_abs_x(ctx, fp12.load(ctx, t), cyclotomic=True))
    assert got == t ** (-m.bls.BLS_X)
    return _ints(got)


def fp12_frobenius_conjugate_inverse(m, ctx, seed):
    fp12 = _fp12(m)
    x = m.bls.Fq12(_fq12_ints(seed))
    a = fp12.load(ctx, x)
    out = [fp12.value(fp12.frobenius(ctx, a, 1)), fp12.value(fp12.frobenius(ctx, a, 2)),
           fp12.value(fp12.conjugate(ctx, a)), fp12.value(fp12.inverse(ctx, a))]
    assert out == [x ** P, x ** (P ** 2), x ** (P ** 6), x.inv()]
    return _ints(out)


def fp12_sparse_mul(m, ctx, seed):
    fp12 = _fp12(m)
    fp2 = fp12.fp2
    Fq2 = m.bls.Fq2
    a = fp12.load(ctx, m.bls.Fq12(_fq12_ints(seed)))
    c0, c3, c5 = (fp2.load(ctx, Fq2(v)) for v in ([3, 5], [7, 11], [13, 17]))
    sparse = fp12.mul_sparse_035(ctx, a, c0, c3, c5)
    line = fp12.load_constant(ctx, [Fq2([3, 5]), Fq2([0, 0]), Fq2([0, 0]),
                                    Fq2([7, 11]), Fq2([0, 0]), Fq2([13, 17])])
    full = fp12.mul(ctx, a, line)
    assert fp12.value(sparse) == fp12.value(full)
    return _ints(fp12.value(sparse))


def pairing_double_add_steps(m, ctx, seed):
    fp12 = _fp12(m)
    fp2 = fp12.fp2
    chip, g2 = m.PairingChip(fp12), m.G2Chip(fp2)
    q1, q2 = m.bls.g2_curve.mul(m.bls.G2_GEN, 5), m.bls.g2_curve.mul(m.bls.G2_GEN, 9)
    c1, c2 = g2.load_point(ctx, q1), g2.load_point(ctx, q2)
    d, lam_d = chip._double_step(ctx, c1)
    s, lam_s = chip._add_step(ctx, c1, c2)
    assert (fp2.value(d[0]), fp2.value(d[1])) == m.bls.g2_curve.double(q1)
    assert (fp2.value(s[0]), fp2.value(s[1])) == m.bls.g2_curve.add(q1, q2)
    return _ints([fp2.value(v) for v in (*d, lam_d, *s, lam_s)])


def pairing_psi(m, ctx, seed):
    fp12 = _fp12(m)
    fp2 = fp12.fp2
    chip, g2 = m.PairingChip(fp12), m.G2Chip(fp2)
    q = m.bls.g2_curve.mul(m.bls.G2_GEN, 31337)
    p = chip.g2_psi(ctx, g2.load_point(ctx, q))
    assert (fp2.value(p[0]), fp2.value(p[1])) == m.bls.g2_psi(q)
    return _ints([fp2.value(p[0]), fp2.value(p[1])])


def expand_message_xmd(m, ctx, seed):
    msg = np.random.default_rng(seed).bytes(32)
    chip = _h2c(m)
    digs = chip.expand_message_xmd(ctx, m.load_bytes_checked(ctx, chip.sha, msg), DST, 256)
    got = b"".join(b"".join(int(w.value).to_bytes(4, "big") for w in d) for d in digs)
    assert got == m.bls.expand_message_xmd(msg, DST, 256)
    return list(got)


def hash_to_field(m, ctx, seed):
    msg = np.random.default_rng(seed).bytes(32)
    chip = _h2c(m)
    us = chip.hash_to_field_fq2(ctx, m.load_bytes_checked(ctx, chip.sha, msg), DST)
    got = [[c0.value % P, c1.value % P] for c0, c1 in us]
    assert got == _ints(m.bls.hash_to_field_fq2(msg, DST))
    return got


def expand_message_xmd_wide(m, ctx, seed):
    msg = np.random.default_rng(seed).bytes(32)
    gate = m.GateChip()
    fp2 = m.Fp2Chip(m.FpChip(m.RangeChip(lookup_bits=8, gate=gate)))
    shaw = m.Sha256WideChip(gate)
    chip = m.HashToCurveChip(m.PairingChip(m.Fp12Chip(fp2)), m.Sha256Chip(gate),
                             sha_wide=shaw)
    digs = chip.expand_message_xmd_wide(ctx, m.load_bytes_checked(ctx, shaw, msg), DST, 256)
    got = b"".join(b"".join(int(w.value).to_bytes(4, "big") for w in d) for d in digs)
    assert got == m.bls.expand_message_xmd(msg, DST, 256)
    return list(got)


def sgn0_gadget(m, ctx, seed):
    chip = _h2c(m)
    fp2 = chip.fp2
    out = []
    for v, want in (((2, 0), 0), ((3, 0), 1), ((0, 3), 1), ((0, 2), 0),
                    ((4, 7), 0), ((5, 2), 1)):
        a = chip._canonical_fq2(ctx, fp2.load(ctx, m.bls.Fq2(list(v))))
        out.append(chip.sgn0(ctx, a).value)
        assert out[-1] == want, v
    return out


CASES = [fp_mul_add_sub, fp_edge_values, ec_add_double, ec_add_unequal_lazy_and_select,
         assert_nonzero_honest, canonicalize, fp2_arithmetic, g2_group_law,
         fp12_mul_square, fp12_cyclotomic_square, fp12_compressed_pow_abs_x,
         fp12_frobenius_conjugate_inverse, fp12_sparse_mul, pairing_double_add_steps,
         pairing_psi, expand_message_xmd, hash_to_field, expand_message_xmd_wide,
         sgn0_gadget]


@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__)
def test_chip_equals_host_and_reference_context(case):
    ctx, rctx = PORT.Context(), REF.Context()
    got = case(PORT, ctx, 11)
    assert got == case(REF, rctx, 11)
    assert_contexts_equal(ctx, rctx)


# --- soundness: the forgeries raise in both packages -------------------------

def off_curve_point(m, ctx):
    m.EccChip(_fp(m)).load_point(ctx, (m.bls.Fq(123), m.bls.Fq(456)))


def strict_add_of_equal_points(m, ctx):
    ecc = m.EccChip(_fp(m))
    p1 = m.bls.sk_to_pk(3)
    ecc.add_unequal(ctx, ecc.load_point(ctx, p1), ecc.load_point(ctx, p1))


def strict_lazy_add_of_equal_points(m, ctx):
    ecc = m.EccChip(_fp(m))
    p1 = m.bls.sk_to_pk(3)
    ecc.add_unequal_lazy(ctx, ecc.load_point(ctx, p1), ecc.load_point(ctx, p1))


def strict_g2_add_of_equal_points(m, ctx):
    g2 = m.G2Chip(_fp2(m))
    p1 = m.bls.g2_curve.mul(m.bls.G2_GEN, 7)
    g2.add_unequal(ctx, g2.load_point(ctx, p1), g2.load_point(ctx, p1))


def forged_slope(m, ctx):
    """dx = dy = 0 lets any witnessed slope satisfy q*0 = 0; the strict
    path's dx*inv == 1 has no witness for dx == 0: the forger's arbitrary
    'inverse' fails the carry-to-zero divisibility."""
    fp = _fp(m)
    prod = fp.big.mul_no_carry(ctx, fp.load(ctx, 0), fp.load(ctx, 99))
    prod0 = fp.gate.add(ctx, prod[0], m.bn.R - 1)
    fp.big.check_carry_to_zero(ctx, [prod0] + prod[1:], -1, P)


def p_as_canonical_value(m, ctx):
    """r = p (an alias of 0) fits the 381-bit limb checks but fails
    enforce_lt."""
    fp = _fp(m)
    fp.big.enforce_lt(ctx, fp.big.load(ctx, P, max_bits=P.bit_length() + 1), P)


def g2_off_curve_point(m, ctx):
    m.G2Chip(_fp2(m)).load_point(ctx, (m.bls.Fq2([1, 2]), m.bls.Fq2([3, 4])))


@pytest.mark.parametrize("case, match", [
    (off_curve_point, "divisible"), (strict_add_of_equal_points, "zero"),
    (strict_lazy_add_of_equal_points, "P == ±Q"), (strict_g2_add_of_equal_points, "zero"),
    (forged_slope, "divisible"), (p_as_canonical_value, "out of range"),
    (g2_off_curve_point, "divisible")], ids=lambda v: getattr(v, "__name__", None))
def test_forgery_raises_in_both_packages(case, match):
    for m in (PORT, REF):
        with pytest.raises(m.error, match=match):
            case(m, m.Context())


def test_fp12_tower_conversion_equals_reference():
    c = _fq12_ints(5)
    t = PORT.fq12_to_tower(t_bls.Fq12(c))
    assert _ints(t) == _ints(REF.fq12_to_tower(r_bls.Fq12(c)))
    assert PORT.tower_to_fq12(t) == t_bls.Fq12(c)
    g1, g2 = t_fp12.frobenius_constants()
    rg1, rg2 = r_fp12.frobenius_constants()
    assert _ints(g1 + g2) == _ints(rg1 + rg2)


def test_final_exp_chain_host_identity():
    """The 3x hard-part chain the pairing chip implements, on the port's
    host field."""
    X, R = t_bls.BLS_X, t_bls.R
    f = t_bls.Fq12(_fq12_ints(6))
    t = (f ** (P ** 6 - 1)) ** (P ** 2 + 1)

    def conj(u):
        return u ** (P ** 6)

    def pax(u):
        return u ** (-X)

    def pxm1(u):
        return conj(pax(u) * u)

    a = pxm1(pxm1(t))
    b = conj(pax(a)) * (a ** P)
    res = pax(pax(b)) * (b ** (P ** 2)) * conj(b) * t * t * t
    assert res == t ** (3 * ((P ** 4 - P ** 2 + 1) // R))
    assert conj(t) == t.inv()
