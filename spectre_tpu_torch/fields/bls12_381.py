"""BLS12-381 G1 on the host: the base field, the curve, key derivation and
the 48-byte ZCash/eth2 point encoding (the port's copy of that part of
`spectre_tpu/fields/bls12_381.py`). Sync-committee pubkeys are G1 points;
the committee-update circuit reads them compressed. G2, hash-to-curve and
the pairing belong to the step circuit and are not here.
"""

from __future__ import annotations

from .common import CurveGroup, make_prime_field

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

Fq = make_prime_field(P, "FqBLS")

B1 = Fq(4)

g1_curve = CurveGroup(Fq, Fq(0), B1, order=R)

G1_GEN = (
    Fq(0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB),
    Fq(0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1),
)


def sk_to_pk(sk: int):
    return g1_curve.mul(G1_GEN, sk % R)


_COMP_FLAG = 1 << 7
_INF_FLAG = 1 << 6
_SIGN_FLAG = 1 << 5


def fq_sign(y) -> bool:
    """The encoding's sign of y: y > (p - 1) / 2."""
    return y.n > (P - 1) // 2


def g1_compress(pt) -> bytes:
    """48-byte compressed G1: big-endian x with the compression, infinity
    and sign flags in the top three bits."""
    if pt is None:
        return bytes([_COMP_FLAG | _INF_FLAG]) + b"\x00" * 47
    x, y = pt
    b = bytearray(int(x).to_bytes(48, "big"))
    b[0] |= _COMP_FLAG
    if fq_sign(y):
        b[0] |= _SIGN_FLAG
    return bytes(b)


def g1_decompress(b: bytes, subgroup_check: bool = False):
    """The inverse of g1_compress; raises ValueError on a malformed or
    non-canonical encoding or an x off the curve."""
    if len(b) != 48:
        raise ValueError("compressed G1 is 48 bytes")
    flags = b[0]
    if not flags & _COMP_FLAG:
        raise ValueError("uncompressed flag")
    if flags & _INF_FLAG:
        if flags != (_COMP_FLAG | _INF_FLAG) or b[1:] != b"\x00" * 47:
            raise ValueError("non-canonical infinity encoding")
        return None
    xi = int.from_bytes(bytes([flags & 0x1F]) + b[1:], "big")
    if xi >= P:
        raise ValueError("x not canonical")
    x = Fq(xi)
    y = (x * x * x + B1).sqrt()
    if y is None:
        raise ValueError("x not on curve")
    if fq_sign(y) != bool(flags & _SIGN_FLAG):
        y = -y
    pt = (x, y)
    if subgroup_check and not g1_curve.in_subgroup(pt):
        raise ValueError("point not in G1 subgroup")
    return pt
