"""BN254 (alt_bn128): fields, groups, optimal-ate pairing, Fr FFT constants.

This curve hosts the proving system (KZG commitments live in G1, the verifier
pairs against G2). Plays the role of the reference's `halo2curves-axiom` BN254
host arithmetic (SURVEY.md §2b N1); the throughput path is ops.field_ops /
ops.msm on the GPU — this module is the exact oracle and the verifier math.

Pairing construction follows the standard optimal-ate recipe over the tower
Fq12 = Fq[w]/(w^12 - 18 w^6 + 82)  (so u = w^6 - 9 with Fq2 = Fq[u]/(u^2+1)),
with G2 points embedded via the sextic twist x -> x*w^2, y -> y*w^3.
"""

from __future__ import annotations

from .common import CurveGroup, make_ext_field, make_prime_field

# field moduli
P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

Fq = make_prime_field(P, "FqBN254")
Fr = make_prime_field(R, "FrBN254")

Fq2 = make_ext_field(P, [1, 0], "Fq2BN254")           # u^2 = -1
Fq12 = make_ext_field(P, [82, 0, 0, 0, 0, 0, -18 % P, 0, 0, 0, 0, 0], "Fq12BN254")

# curves
g1_curve = CurveGroup(Fq, Fq(0), Fq(3), order=R, cofactor=1)
g2_curve = CurveGroup(Fq2, Fq2.zero(), Fq2([3, 0]) / Fq2([9, 1]), order=R)
g12_curve = CurveGroup(Fq12, Fq12.zero(), Fq12.from_base(3), order=R)

G1_GEN = (Fq(1), Fq(2))
G2_GEN = (
    Fq2([
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    ]),
    Fq2([
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    ]),
)

# BN parameter t: p(t), r(t) are the standard BN polynomials; ate loop is 6t+2.
BN_T = 4965661367192848881
ATE_LOOP_COUNT = 6 * BN_T + 2  # 29793968203157093288


# ---------------------------------------------------------------------------
# twist embedding  E'(Fq2) -> E(Fq12)
# ---------------------------------------------------------------------------

_W2 = Fq12([0, 0, 1] + [0] * 9)   # w^2
_W3 = Fq12([0, 0, 0, 1] + [0] * 8)  # w^3


def _fq2_to_fq12(x: "Fq2") -> "Fq12":
    """a0 + a1*u  ->  (a0 - 9 a1) + a1 w^6   (since u = w^6 - 9)."""
    a0, a1 = x.c
    return Fq12([(a0 - 9 * a1) % P, 0, 0, 0, 0, 0, a1, 0, 0, 0, 0, 0])


def twist(pt):
    """Embed a G2 (twist-curve) point into E(Fq12)."""
    if pt is None:
        return None
    x, y = pt
    return (_fq2_to_fq12(x) * _W2, _fq2_to_fq12(y) * _W3)


def cast_g1(pt):
    if pt is None:
        return None
    x, y = pt
    return (Fq12.from_base(x.n), Fq12.from_base(y.n))


# ---------------------------------------------------------------------------
# optimal ate pairing (shared engine + BN frobenius corrections)
# ---------------------------------------------------------------------------

from .pairing import PairingEngine, linefunc  # noqa: E402


def _bn_corrections(f, r_pt, q, pt):
    """The two extra frobenius-twisted line evaluations BN curves require."""
    q1 = (q[0] ** P, q[1] ** P)
    nq2 = (q1[0] ** P, -(q1[1] ** P))
    f = f * linefunc(r_pt, q1, pt)
    r_pt = g12_curve.add(r_pt, q1)
    return f * linefunc(r_pt, nq2, pt)


ENGINE = PairingEngine(
    p=P, r=R, fq12=Fq12, g12_curve=g12_curve, twist=twist, cast_g1=cast_g1,
    loop_count=ATE_LOOP_COUNT, corrections=_bn_corrections,
)


def miller_loop(q, p, final_exp: bool = True):
    return ENGINE.miller_loop(q, p, final_exp)


def final_exponentiation(f: "Fq12") -> "Fq12":
    return ENGINE.final_exponentiation(f)


def pairing(q, p):
    """e(p, q): p in G1 (Fq coords), q in G2 (Fq2 coords)."""
    assert g2_curve.is_on_curve(q), "q not on twist curve"
    assert g1_curve.is_on_curve(p), "p not on curve"
    return ENGINE.pairing(q, p)


def pairing_check(pairs) -> bool:
    """prod e(p_i, q_i) == 1, with a single shared final exponentiation.

    This is the verifier's KZG check  e(W, [tau]_2) * e(Z, -[1]_2) * ... == 1.
    (A None entry is the zero commitment: e(O, Q) = 1, legitimately skipped.)
    """
    return ENGINE.pairing_check(pairs)


# ---------------------------------------------------------------------------
# Fr FFT/NTT constants (used by plonk.domain and ops.ntt)
# ---------------------------------------------------------------------------

# 2-adicity of r-1 and a multiplicative generator of Fr^*.
FR_S = 28
FR_GENERATOR = 7
_t = (R - 1) >> FR_S
FR_ROOT_OF_UNITY = pow(FR_GENERATOR, _t, R)  # order 2^28
assert pow(FR_ROOT_OF_UNITY, 1 << 27, R) == R - 1, "root of unity sanity"


def fr_root_of_unity(k: int) -> int:
    """Primitive 2^k-th root of unity in Fr."""
    assert 0 <= k <= FR_S
    return pow(FR_ROOT_OF_UNITY, 1 << (FR_S - k), R)


# ---------------------------------------------------------------------------
# serialization (uncompressed + compressed, for transcripts/SRS files)
# ---------------------------------------------------------------------------

def g1_to_bytes(pt) -> bytes:
    """64-byte uncompressed BE (x||y); all-zero for infinity."""
    if pt is None:
        return b"\x00" * 64
    return int(pt[0]).to_bytes(32, "big") + int(pt[1]).to_bytes(32, "big")


def g1_from_bytes(b: bytes):
    # explicit raises: deserializes untrusted proof/SRS bytes and must
    # reject under `python -O` (asserts stripped) as well
    if len(b) != 64:
        raise ValueError("g1 point must be 64 bytes")
    if b == b"\x00" * 64:
        return None
    x, y = int.from_bytes(b[:32], "big"), int.from_bytes(b[32:], "big")
    if x >= P or y >= P:
        raise ValueError("non-canonical g1 coordinate")
    pt = (Fq(x), Fq(y))
    if not g1_curve.is_on_curve(pt):
        raise ValueError("g1 point not on curve")
    return pt


def g2_to_bytes(pt) -> bytes:
    """128-byte uncompressed BE (x.c1||x.c0||y.c1||y.c0); zeros for infinity."""
    if pt is None:
        return b"\x00" * 128
    x, y = pt
    return (x.c[1].to_bytes(32, "big") + x.c[0].to_bytes(32, "big")
            + y.c[1].to_bytes(32, "big") + y.c[0].to_bytes(32, "big"))


def g2_from_bytes(b: bytes):
    if len(b) != 128:
        raise ValueError("g2 point must be 128 bytes")
    if b == b"\x00" * 128:
        return None
    ws = [int.from_bytes(b[i:i + 32], "big") for i in range(0, 128, 32)]
    if any(w >= P for w in ws):
        raise ValueError("non-canonical g2 coordinate")
    x = Fq2([ws[1], ws[0]])
    y = Fq2([ws[3], ws[2]])
    pt = (x, y)
    if not g2_curve.is_on_curve(pt):
        raise ValueError("g2 point not on curve")
    return pt
