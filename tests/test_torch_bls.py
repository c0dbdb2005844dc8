"""The port's host BLS12-381 (fields/bls12_381.py) on the CPU against the JAX
package's: hashing to G2, the psi endomorphism, the point encodings, BLS
signatures and the pairing. Inputs are made from a seed with numpy; every
comparison is exact (bytes, or field elements as ints).
"""

import numpy as np
import pytest

from spectre_tpu.fields import bls12_381 as rbls
from spectre_tpu_torch import spec as SPEC
from spectre_tpu_torch.fields import bls12_381 as bls

DST = SPEC.DST


def _msgs(seed: int, count: int = 3) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, int(rng.integers(0, 80)), dtype=np.uint8).tobytes()
            for _ in range(count)]


def _sks(seed: int, count: int) -> list[int]:
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.integers(0, 256, 32, dtype=np.uint8).tobytes(), "big") % bls.R
            for _ in range(count)]


def _ints(x) -> list[int]:
    """An Fq, Fq2 or Fq12 element, or a point of them, as ints."""
    if x is None:
        return None
    if isinstance(x, tuple):
        return [_ints(c) for c in x]
    return [int(c) for c in x.c] if hasattr(x, "c") else [int(x)]


def test_reference_dst_is_the_port_dst():
    assert DST == rbls.DST_G2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_expand_message_and_hash_to_field_equal_reference(seed):
    for msg in _msgs(seed):
        for n in (32, 256):
            assert bls.expand_message_xmd(msg, DST, n) == rbls.expand_message_xmd(msg, DST, n)
        u, ru = bls.hash_to_field_fq2(msg, DST), rbls.hash_to_field_fq2(msg, DST)
        assert [_ints(x) for x in u] == [_ints(x) for x in ru]


def test_sswu_iso3_and_hash_to_g2_equal_reference():
    for msg in _msgs(3):
        u, ru = bls.hash_to_field_fq2(msg, DST), rbls.hash_to_field_fq2(msg, DST)
        for a, ra in zip(u, ru):
            q, rq = bls.map_to_curve_sswu_g2prime(a), rbls.map_to_curve_sswu_g2prime(ra)
            assert _ints(q) == _ints(rq)
            assert _ints(bls.iso3_map(q)) == _ints(rbls.iso3_map(rq))
            assert bls.g2_curve.is_on_curve(bls.iso3_map(q))
        h = bls.hash_to_g2(msg, DST)
        assert _ints(h) == _ints(rbls.hash_to_g2(msg, DST))
        assert bls.g2_curve.is_on_curve(h)
    assert _ints(bls.map_to_curve_svdw_g2(u[0])) == _ints(rbls.map_to_curve_svdw_g2(ru[0]))


def test_psi_and_subgroup_check_equal_reference():
    for sk in _sks(4, 2):
        q, rq = bls.g2_curve.mul(bls.G2_GEN, sk), rbls.g2_curve.mul(rbls.G2_GEN, sk)
        assert _ints(bls.g2_psi(q)) == _ints(rbls.g2_psi(rq))
        assert bls.g2_in_subgroup_psi(q) and rbls.g2_in_subgroup_psi(rq)
    # a point of the twist outside G2: the first x = k + u on the curve
    pt = bls._deterministic_twist_points(1)[0]
    rpt = rbls._deterministic_twist_points(1)[0]
    assert _ints(pt) == _ints(rpt)
    assert not bls.g2_in_subgroup_psi(pt) and not rbls.g2_in_subgroup_psi(rpt)
    assert _ints(bls.clear_cofactor_g2_bp(pt)) == _ints(rbls.clear_cofactor_g2_bp(rpt))
    assert bls.psi_constants()[0].c == rbls.psi_constants()[0].c
    assert bls.H_EFF_G2 == rbls.H_EFF_G2 and bls.ATE_LOOP_COUNT == rbls.ATE_LOOP_COUNT


def test_g2_compress_decompress_equal_reference():
    for sk in _sks(5, 3):
        q, rq = bls.g2_curve.mul(bls.G2_GEN, sk), rbls.g2_curve.mul(rbls.G2_GEN, sk)
        b = bls.g2_compress(q)
        assert b == rbls.g2_compress(rq)
        assert _ints(bls.g2_decompress(b)) == _ints(rbls.g2_decompress(b))
        assert bls.g2_decompress(b) == q
    inf = bls.g2_compress(None)
    assert inf == rbls.g2_compress(None) and bls.g2_decompress(inf) is None
    with pytest.raises(ValueError, match="uncompressed"):
        bls.g2_decompress(b"\x00" * 96)
    with pytest.raises(ValueError, match="canonical"):
        bls.g2_decompress(bytes([0x9F]) + b"\xff" * 95)


def test_keys_signatures_and_aggregate_verify_equal_reference():
    sks = _sks(6, 3)
    msg = _msgs(7, 1)[0]
    pks = [bls.sk_to_pk(sk) for sk in sks]
    assert [_ints(p) for p in pks] == [_ints(rbls.sk_to_pk(sk)) for sk in sks]
    sigs = [bls.sign(sk, msg, DST) for sk in sks]
    rsigs = [rbls.sign(sk, msg, DST) for sk in sks]
    assert [_ints(s) for s in sigs] == [_ints(s) for s in rsigs]
    agg, ragg = bls.aggregate_signatures(sigs), rbls.aggregate_signatures(rsigs)
    assert bls.g2_compress(agg) == rbls.g2_compress(ragg)
    rpks = [rbls.sk_to_pk(sk) for sk in sks]
    assert bls.fast_aggregate_verify(pks, msg, agg, DST)
    assert rbls.fast_aggregate_verify(rpks, msg, ragg, DST)
    # forged: one signer's share left out of the aggregate
    forged, rforged = bls.aggregate_signatures(sigs[:2]), rbls.aggregate_signatures(rsigs[:2])
    assert not bls.fast_aggregate_verify(pks, msg, forged, DST)
    assert not rbls.fast_aggregate_verify(rpks, msg, rforged, DST)
    assert not bls.fast_aggregate_verify([], msg, agg, DST)


def test_pairing_equals_reference():
    a, b = _sks(8, 2)
    p, q = bls.sk_to_pk(a), bls.g2_curve.mul(bls.G2_GEN, b)
    e = bls.pairing(q, p)
    re = rbls.pairing(rbls.g2_curve.mul(rbls.G2_GEN, b), rbls.sk_to_pk(a))
    assert _ints(e) == _ints(re)
    assert e != bls.Fq12.one() and e ** bls.R == bls.Fq12.one()
