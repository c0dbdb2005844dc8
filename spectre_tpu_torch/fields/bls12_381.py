"""BLS12-381 on the host: fields, groups, pairing, hash-to-curve, BLS
signatures and the ZCash/eth2 point encoding (the port's copy of
`spectre_tpu/fields/bls12_381.py`).

Sync-committee pubkeys are G1 points (48-byte compressed), aggregate
signatures G2 points (96-byte compressed). The step circuit's witness signs,
aggregates and verifies here; its constraints run over BN254 Fr in
builder/fp_chip.py and the chips above it.

Tower: Fq2 = Fq[u]/(u^2+1), Fq12 = Fq[w]/(w^12 - 2 w^6 + 2) (so u = w^6 - 1);
G2 embeds into E(Fq12) via the M-twist x -> x/w^2, y -> y/w^3.

Hash-to-curve: BLS12381G2_XMD:SHA-256_SSWU_RO (RFC 9380), expand_message_xmd
with SHA-256, hash_to_field, simplified SWU on the 3-isogenous curve and a
3-isogeny derived with Velu's formulas (its kernel pinned by the j = 0
codomain, its isomorphism normalization pinned by value). The SvdW map stays
as `hash_to_g2_svdw` (uniform, derived from the RFC, not interoperable).
"""

from __future__ import annotations

import functools
import hashlib
import math

from ..spec import DST
from .common import CurveGroup, make_ext_field, make_prime_field
from .pairing import PairingEngine

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
BLS_X = -0xD201000000010000  # BLS parameter (negative)

Fq = make_prime_field(P, "FqBLS")
Fr = make_prime_field(R, "FrBLS")
Fq2 = make_ext_field(P, [1, 0], "Fq2BLS")
Fq12 = make_ext_field(P, [2, 0, 0, 0, 0, 0, -2 % P, 0, 0, 0, 0, 0], "Fq12BLS")

B1 = Fq(4)
B2 = Fq2([4, 4])

g1_curve = CurveGroup(Fq, Fq(0), B1, order=R)
g2_curve = CurveGroup(Fq2, Fq2.zero(), B2, order=R)
g12_curve = CurveGroup(Fq12, Fq12.zero(), Fq12.from_base(4), order=R)

G1_GEN = (
    Fq(0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB),
    Fq(0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1),
)
G2_GEN = (
    Fq2([
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ]),
    Fq2([
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ]),
)

assert g1_curve.is_on_curve(G1_GEN)
assert g2_curve.is_on_curve(G2_GEN)

# ---------------------------------------------------------------------------
# group orders & cofactors (lazily derived, deterministic, then sanity-checked)
# ---------------------------------------------------------------------------

_t1 = BLS_X + 1                    # trace of Frobenius over Fq
N1 = P + 1 - _t1                   # |E(Fq)|
H1 = N1 // R                       # G1 cofactor
assert N1 % R == 0


def _deterministic_twist_points(count: int):
    """First `count` points on E'(Fq2) with x = k + u, k = 0,1,2,..."""
    pts = []
    k = 0
    while len(pts) < count:
        x = Fq2([k, 1])
        y = (x * x * x + B2).sqrt()
        if y is not None:
            pts.append((x, y))
        k += 1
    return pts


@functools.cache
def twist_order() -> int:
    """|E'(Fq2)| for the M-twist, found among the six sextic-twist candidate
    orders p^2 + 1 - t' (checked against on-curve points). Avoids hardcoding."""
    t2 = _t1 * _t1 - 2 * P         # trace over Fq2
    # 4p^2 = t2^2 + 3 f2^2
    f2_sq, rem = divmod(4 * P * P - t2 * t2, 3)
    assert rem == 0
    f2 = math.isqrt(f2_sq)
    assert f2 * f2 == f2_sq
    candidates = [
        P * P + 1 - t2, P * P + 1 + t2,
        P * P + 1 - (t2 + 3 * f2) // 2, P * P + 1 + (t2 + 3 * f2) // 2,
        P * P + 1 - (t2 - 3 * f2) // 2, P * P + 1 + (t2 - 3 * f2) // 2,
    ]
    pts = _deterministic_twist_points(2)
    for n in candidates:
        if n % R == 0 and all(g2_curve.mul_unsafe(pt, n) is None for pt in pts):
            return n
    raise AssertionError("no twist order candidate matched")


@functools.cache
def g2_cofactor() -> int:
    return twist_order() // R


def clear_cofactor_g2(pt):
    return g2_curve.mul_unsafe(pt, g2_cofactor())


def clear_cofactor_g1(pt):
    return g1_curve.mul_unsafe(pt, H1)


# ---------------------------------------------------------------------------
# pairing (shared engine; BLS has no post-loop corrections)
# ---------------------------------------------------------------------------

ATE_LOOP_COUNT = -BLS_X  # 15132376222941642752

_W2_INV = Fq12([0, 0, 1] + [0] * 9).inv()
_W3_INV = Fq12([0, 0, 0, 1] + [0] * 8).inv()


def _fq2_to_fq12(x):
    """a0 + a1*u -> (a0 - a1) + a1 w^6   (u = w^6 - 1)."""
    a0, a1 = x.c
    return Fq12([(a0 - a1) % P, 0, 0, 0, 0, 0, a1, 0, 0, 0, 0, 0])


def twist(pt):
    if pt is None:
        return None
    x, y = pt
    return (_fq2_to_fq12(x) * _W2_INV, _fq2_to_fq12(y) * _W3_INV)


def cast_g1(pt):
    if pt is None:
        return None
    return (Fq12.from_base(pt[0].n), Fq12.from_base(pt[1].n))


ENGINE = PairingEngine(
    p=P, r=R, fq12=Fq12, g12_curve=g12_curve, twist=twist, cast_g1=cast_g1,
    loop_count=ATE_LOOP_COUNT, corrections=None,
)


def miller_loop(q, p, final_exp: bool = True):
    return ENGINE.miller_loop(q, p, final_exp)


def final_exponentiation(f):
    return ENGINE.final_exponentiation(f)


def pairing(q, p):
    """e(p, q): p in G1, q in G2 (twist coords)."""
    if not (g2_curve.is_on_curve(q) and g1_curve.is_on_curve(p)):
        raise ValueError("pairing of a point off its curve")
    return ENGINE.pairing(q, p)


def pairing_check(pairs) -> bool:
    return ENGINE.pairing_check(pairs)


# ---------------------------------------------------------------------------
# RFC 9380 hashing: expand_message_xmd + hash_to_field
# ---------------------------------------------------------------------------

def expand_message_xmd(msg: bytes, dst: bytes, len_in_bytes: int) -> bytes:
    """expand_message_xmd with SHA-256 (RFC 9380 §5.3.1)."""
    if len(dst) > 255:
        raise ValueError("a DST is at most 255 bytes")
    b_in_bytes, r_in_bytes = 32, 64
    ell = (len_in_bytes + b_in_bytes - 1) // b_in_bytes
    if ell > 255:
        raise ValueError("expand_message_xmd: len_in_bytes too large")
    dst_prime = dst + bytes([len(dst)])
    z_pad = b"\x00" * r_in_bytes
    l_i_b_str = len_in_bytes.to_bytes(2, "big")
    b0 = hashlib.sha256(z_pad + msg + l_i_b_str + b"\x00" + dst_prime).digest()
    b1 = hashlib.sha256(b0 + b"\x01" + dst_prime).digest()
    out = [b1]
    for i in range(2, ell + 1):
        prev = out[-1]
        tmp = bytes(a ^ c for a, c in zip(b0, prev))
        out.append(hashlib.sha256(tmp + bytes([i]) + dst_prime).digest())
    return b"".join(out)[:len_in_bytes]


L_FIELD = 64  # ceil((ceil(log2(p)) + k) / 8) with k=128 for BLS12-381


def hash_to_field_fq2(msg: bytes, dst: bytes, count: int = 2):
    """hash_to_field into Fq2 (m=2, L=64)."""
    len_in_bytes = count * 2 * L_FIELD
    pseudo = expand_message_xmd(msg, dst, len_in_bytes)
    out = []
    for i in range(count):
        coeffs = []
        for j in range(2):
            off = L_FIELD * (j + i * 2)
            coeffs.append(int.from_bytes(pseudo[off:off + L_FIELD], "big") % P)
        out.append(Fq2(coeffs))
    return out


# ---------------------------------------------------------------------------
# Shallue–van de Woestijne map to G2 (constants derived per RFC 9380 §H.1)
# ---------------------------------------------------------------------------

def _g2_rhs(x):
    return x * x * x + B2


@functools.cache
def _svdw_constants():
    """(Z, c1, c2, c3, c4) for the SvdW map on E': y^2 = x^3 + 4(1+u), derived
    from the RFC 9380 H.1 criteria over a fixed deterministic candidate order."""
    def candidates():
        for k in range(1, 20):
            yield Fq2([k, 0]); yield Fq2([-k % P, 0])
            yield Fq2([0, k]); yield Fq2([0, -k % P])
            yield Fq2([k, k]); yield Fq2([-k % P, -k % P])
    z = None
    for cand in candidates():
        gz = _g2_rhs(cand)
        if gz.is_zero():
            continue
        h = -(cand * cand * 3) / (gz * 4)      # A = 0
        if h.is_zero() or h.sqrt() is None:
            continue
        g_half = _g2_rhs(-cand / Fq2([2, 0]))
        if gz.sqrt() is not None or g_half.sqrt() is not None:
            z = cand
            break
    assert z is not None, "no SvdW Z found"
    c1 = _g2_rhs(z)
    c2 = -z / Fq2([2, 0])
    c3 = (-c1 * (z * z * 3)).sqrt()
    assert c3 is not None
    if c3.sgn0() != 0:
        c3 = -c3
    c4 = (-c1 * 4) / (z * z * 3)
    return z, c1, c2, c3, c4


def map_to_curve_svdw_g2(u: "Fq2"):
    """RFC 9380 §6.6.1 straight-line SvdW (constant set derived above)."""
    z, c1, c2, c3, c4 = _svdw_constants()
    one = Fq2.one()
    tv1 = u * u * c1
    tv2 = one + tv1
    tv1 = one - tv1
    tv3 = tv1 * tv2
    tv3 = tv3.inv() if not tv3.is_zero() else Fq2.zero()
    tv4 = u * tv1 * tv3 * c3
    x1 = c2 - tv4
    gx1 = _g2_rhs(x1)
    e1 = gx1.sqrt() is not None
    x2 = c2 + tv4
    gx2 = _g2_rhs(x2)
    e2 = (gx2.sqrt() is not None) and not e1
    x3 = (tv2 * tv2 * tv3) ** 2 * c4 + z
    x = x1 if e1 else (x2 if e2 else x3)
    gx = _g2_rhs(x)
    y = gx.sqrt()
    assert y is not None
    if u.sgn0() != y.sgn0():
        y = -y
    return (x, y)


def hash_to_g2_svdw(msg: bytes, dst: bytes = DST):
    """The SvdW variant (uniform, NOT eth2-interoperable)."""
    u0, u1 = hash_to_field_fq2(msg, dst)
    q0 = map_to_curve_svdw_g2(u0)
    q1 = map_to_curve_svdw_g2(u1)
    return clear_cofactor_g2(g2_curve.add(q0, q1))


# ---------------------------------------------------------------------------
# RFC 9380 BLS12381G2_XMD:SHA-256_SSWU_RO (the eth2 ciphersuite)
#
# Simplified SWU on the 3-isogenous curve E2': y^2 = x^3 + A'x + B', followed
# by the 3-isogeny to E2. The isogeny is DERIVED here via Velu's formulas
# (the kernel x-coordinate is rationally determined by the j=0 codomain
# condition), then the one isomorphism normalization matching the standard
# suite is pinned as a constant validated against blst-signed signatures —
# no opaque hardcoded coefficient tables. The halo2-lib fork's
# `HashToCurveChip` implements exactly this suite.
# ---------------------------------------------------------------------------

SSWU_A = Fq2([0, 240])            # A' = 240 u       (RFC 9380 §8.8.2)
SSWU_B = Fq2([1012, 1012])        # B' = 1012 (1+u)
SSWU_Z = Fq2([-2 % P, -1 % P])    # Z  = -(2+u)


def map_to_curve_sswu_g2prime(u: "Fq2"):
    """Simplified SWU (RFC 9380 §6.6.2) onto E2'."""
    A, B, Z = SSWU_A, SSWU_B, SSWU_Z
    one = Fq2.one()
    zu2 = Z * u * u
    tv1 = zu2 * zu2 + zu2            # Z^2 u^4 + Z u^2
    if tv1.is_zero():
        x1 = B / (Z * A)
    else:
        x1 = (-B / A) * (one + tv1.inv())
    gx1 = x1 * x1 * x1 + A * x1 + B
    y1 = gx1.sqrt()
    if y1 is not None:
        x, y = x1, y1
    else:
        x2 = zu2 * x1
        gx2 = x2 * x2 * x2 + A * x2 + B
        y2 = gx2.sqrt()
        assert y2 is not None, "SSWU: neither gx1 nor gx2 square"
        x, y = x2, y2
    if u.sgn0() != y.sgn0():
        y = -y
    return (x, y)


def _fq2_cbrt(a: "Fq2"):
    """Cube root in Fq2 (Adleman–Manders–Miller for r=3); None if non-residue."""
    q = P * P
    one = Fq2.one()
    if a.is_zero():
        return a
    if a ** ((q - 1) // 3) != one:
        return None
    s, t = 0, q - 1
    while t % 3 == 0:
        s, t = s + 1, t // 3
    alpha = pow(3, -1, t)
    x = a ** alpha                    # x^3 = a * b,  b in the 3-Sylow subgroup
    b = a ** (3 * alpha - 1)
    g = None
    for cand in Fq2._nonresidue_candidates():
        if not cand.is_zero() and cand ** ((q - 1) // 3) != one:
            g = cand ** t             # generator of the 3-Sylow (order 3^s)
            break
    assert g is not None
    order = 3 ** s
    # brute-force dlog of b^-1 in <g> (3-Sylow is tiny for BLS12-381)
    binv = b.inv()
    acc, j = one, None
    for i in range(order):
        if acc == binv:
            j = i
            break
        acc = acc * g
    assert j is not None and j % 3 == 0, "cbrt: dlog failed"
    return x * g ** (j // 3)


@functools.cache
def _iso3_constants():
    """Velu 3-isogeny E2' -> E2: kernel x, map coefficients, isomorphism
    scalings. The kernel is the unique order-3 subgroup whose quotient has
    j = 0; (c2, c3) = (c^2, c^3) for the c with c^6 = B2/b'' matching the
    standard suite (pinned by _ISO3_C_INDEX, fixture-validated)."""
    A, B = SSWU_A, SSWU_B
    # j(E2'/K) = 0  <=>  A - 5t = 0, t = 6 xQ^2 + 2A  =>  xQ^2 = -3A/10
    s_val = -A * Fq2([3, 0]) / Fq2([10, 0])
    # psi3(xQ) = 3 xQ^4 + 6 A xQ^2 + 12 B xQ - A^2 = 0 pins xQ rationally
    xq = (A * A - Fq2([3, 0]) * s_val * s_val - Fq2([6, 0]) * A * s_val) \
        / (Fq2([12, 0]) * B)
    assert xq * xq == s_val, "Velu: kernel x inconsistent"
    gq = xq * xq * xq + A * xq + B
    t = Fq2([6, 0]) * s_val + Fq2([2, 0]) * A
    uq = Fq2([4, 0]) * gq
    w = uq + xq * t
    assert (A - Fq2([5, 0]) * t).is_zero(), "Velu: codomain j != 0"
    b2 = B - Fq2([7, 0]) * w          # codomain: y^2 = x^3 + b2
    v = B2 / b2
    # the 6 isomorphism scalings c with c^6 = v
    d0 = _fq2_cbrt(v)
    assert d0 is not None, "B2/b'' not a cube — isogeny derivation wrong"
    omega = None
    for cand in Fq2._nonresidue_candidates():
        h = cand ** ((P * P - 1) // 3)
        if h != Fq2.one():
            omega = h
            break
    cs = []
    for i in range(3):
        d = d0 * omega ** i
        c = d.sqrt()
        if c is not None:
            cs.append(c)
            cs.append(-c)
    assert cs, "no isomorphism E2'/K -> E2 over Fq2"
    assert _ISO3_C in cs, "pinned isomorphism constant not among derived roots"
    return xq, t, uq, cs


# Which of the 6 isomorphism normalizations equals the standard ciphersuite
# map: selected once against blst-signed signatures of 512 validators and
# pinned BY VALUE; _iso3_constants asserts it is
# one of the derived c^6 = B2/b'' roots, so a derivation drift is caught.
_ISO3_C = None  # set below (needs Fq2 defined)


def iso3_map(pt):
    """The derived 3-isogeny E2' -> E2 (Velu rational map + isomorphism)."""
    xq, t, uq, _cs = _iso3_constants()
    c = _ISO3_C
    c2, c3 = c * c, c * c * c
    x, y = pt
    dx = x - xq
    if dx.is_zero():
        return None  # kernel point: iso_map sends it to the identity (RFC 9380)
    dxi = dx.inv()
    dxi2 = dxi * dxi
    xx = x + t * dxi + uq * dxi2
    yy = y * (Fq2.one() - t * dxi2 - Fq2([2, 0]) * uq * dxi2 * dxi)
    return (c2 * xx, c3 * yy)


_ISO3_C = Fq2([0x8AB05F8BDD54CDE190937E76BC3E447CC27C3D6FBD7063FCD104635A790520C0A395554E5C6AAAA9354FFFFFFFFE38E, 0])


# ---------------------------------------------------------------------------
# psi endomorphism on E'(Fq2): untwist -> p-Frobenius -> twist, in constant
# form psi(x, y) = (cx * conj(x), cy * conj(y)). Used for fast cofactor
# clearing (Budroni–Pintore) and G2 subgroup checks (psi(Q) == [x]Q), both
# host-side and as the oracle for the in-circuit pairing chips.
# ---------------------------------------------------------------------------

def _fq2_conj(a: "Fq2") -> "Fq2":
    return Fq2([a.c[0], (-a.c[1]) % P])


@functools.cache
def psi_constants():
    """(cx, cy) with psi(x,y) = (cx*conj(x), cy*conj(y)); derived by pushing
    a sample point through twist -> Frobenius -> untwist and verified on an
    independent point."""
    W2 = Fq12([0, 0, 1] + [0] * 9)
    W3 = Fq12([0, 0, 0, 1] + [0] * 8)

    def raw_psi(pt):
        x, y = twist(pt)
        fx, fy = x ** P, y ** P

        def to_fq2(v):
            c = v.c
            assert all(ci == 0 for i, ci in enumerate(c) if i not in (0, 6))
            return Fq2([(c[0] + c[6]) % P, c[6]])

        return (to_fq2(fx * W2), to_fq2(fy * W3))

    q1 = g2_curve.mul(G2_GEN, 123)
    px, py = raw_psi(q1)
    cx = px / _fq2_conj(q1[0])
    cy = py / _fq2_conj(q1[1])
    q2 = g2_curve.mul(G2_GEN, 987654321987654321)
    assert raw_psi(q2) == (cx * _fq2_conj(q2[0]), cy * _fq2_conj(q2[1]))
    return cx, cy


def g2_psi(pt):
    if pt is None:
        return None
    cx, cy = psi_constants()
    return (cx * _fq2_conj(pt[0]), cy * _fq2_conj(pt[1]))


def g2_smul(pt, k: int):
    """Scalar mul with signed k (no subgroup assumption)."""
    if k < 0:
        r = g2_curve.mul_unsafe(pt, -k)
        return None if r is None else g2_curve.neg(r)
    return g2_curve.mul_unsafe(pt, k)


def g2_in_subgroup_psi(pt) -> bool:
    """Q in G2 iff psi(Q) == [x]Q (endomorphism eigenvalue check)."""
    if pt is None:
        return True
    return g2_psi(pt) == g2_smul(pt, BLS_X)


def clear_cofactor_g2_bp(pt):
    """Budroni–Pintore: [x^2-x-1]Q + [x-1]psi(Q) + psi^2(2Q). Equal to
    H_EFF_G2 * Q for every curve point."""
    a = g2_smul(pt, BLS_X * BLS_X - BLS_X - 1)
    b = g2_smul(g2_psi(pt), BLS_X - 1)
    c = g2_psi(g2_psi(g2_smul(pt, 2)))
    return g2_curve.add(g2_curve.add(a, b), c)


# h_eff for the G2 suite (RFC 9380 §8.8.2): the scalar equivalent of the
# Budroni–Pintore endomorphism-accelerated clearing. NOT equal to the plain
# cofactor H2 — outputs differ by a unit mod r, so interop REQUIRES h_eff.
# (h_eff kills the cofactor part: h_eff = m*H2 mod N2 with m a unit mod r.)
H_EFF_G2 = 0xBC69F08F2EE75B3584C6A0EA91B352888E2A8E9145AD7689986FF031508FFE1329C2F178731DB956D82BF015D1212B02EC0EC69D7477C1AE954CBC06689F6A359894C0ADEBBF6B4E8020005AAA95551


def hash_to_g2(msg: bytes, dst: bytes = DST):
    """hash_to_curve per BLS12381G2_XMD:SHA-256_SSWU_RO (eth2 interop).

    The halo2-lib fork's `HashToCurveChip` (SSWU + ExpandMsgXmd) computes
    the same map in circuit (`sync_step_circuit.rs:165-169`)."""
    u0, u1 = hash_to_field_fq2(msg, dst)
    q0 = iso3_map(map_to_curve_sswu_g2prime(u0))
    q1 = iso3_map(map_to_curve_sswu_g2prime(u1))
    return g2_curve.mul_unsafe(g2_curve.add(q0, q1), H_EFF_G2)


# ---------------------------------------------------------------------------
# BLS signatures (eth2 flavor: pubkeys in G1, signatures in G2)
# ---------------------------------------------------------------------------

def sk_to_pk(sk: int):
    return g1_curve.mul(G1_GEN, sk % R)


def sign(sk: int, msg: bytes, dst: bytes = DST):
    return g2_curve.mul(hash_to_g2(msg, dst), sk % R)


def aggregate_signatures(sigs):
    acc = None
    for s in sigs:
        acc = g2_curve.add(acc, s)
    return acc


def aggregate_pubkeys(pks):
    acc = None
    for pk in pks:
        acc = g1_curve.add(acc, pk)
    return acc


def verify(pk, msg: bytes, sig, dst: bytes = DST) -> bool:
    """e(pk, H(m)) == e(g1, sig)  <=>  e(pk, H(m)) * e(-g1, sig) == 1.

    Rejects identity pubkey/signature up front (eth2 KeyValidate: accepting the
    point at infinity enables the classic zero-key forgery)."""
    if pk is None or sig is None:
        return False
    h = hash_to_g2(msg, dst)
    return pairing_check([(pk, h), (g1_curve.neg(G1_GEN), sig)])


def fast_aggregate_verify(pks, msg: bytes, sig, dst: bytes = DST) -> bool:
    if not pks or any(pk is None for pk in pks):
        return False
    return verify(aggregate_pubkeys(pks), msg, sig, dst)


# ---------------------------------------------------------------------------
# ZCash/eth2 point serialization (compressed, with flag bits)
# ---------------------------------------------------------------------------

_COMP_FLAG = 1 << 7
_INF_FLAG = 1 << 6
_SIGN_FLAG = 1 << 5


def fq_sign(y: "Fq") -> bool:
    """The encoding's sign of y: y > (p - 1) / 2."""
    return y.n > (P - 1) // 2


_fq_sign = fq_sign


def _fq2_sign(y: "Fq2") -> bool:
    """Lexicographic: c1 dominates; tie-break on c0."""
    if y.c[1] != 0:
        return y.c[1] > (P - 1) // 2
    return y.c[0] > (P - 1) // 2


def g1_compress(pt) -> bytes:
    """48-byte compressed G1 (reference handles these in
    `committee_update_circuit.rs:129` / preprocessor pubkey decompress)."""
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


def g2_compress(pt) -> bytes:
    if pt is None:
        return bytes([_COMP_FLAG | _INF_FLAG]) + b"\x00" * 95
    x, y = pt
    b = bytearray(x.c[1].to_bytes(48, "big") + x.c[0].to_bytes(48, "big"))
    b[0] |= _COMP_FLAG
    if _fq2_sign(y):
        b[0] |= _SIGN_FLAG
    return bytes(b)


def g2_decompress(b: bytes, subgroup_check: bool = False):
    """The inverse of g2_compress; raises ValueError as g1_decompress does."""
    if len(b) != 96:
        raise ValueError("compressed G2 is 96 bytes")
    flags = b[0]
    if not flags & _COMP_FLAG:
        raise ValueError("uncompressed flag")
    if flags & _INF_FLAG:
        if flags != (_COMP_FLAG | _INF_FLAG) or b[1:] != b"\x00" * 95:
            raise ValueError("non-canonical infinity encoding")
        return None
    c1 = int.from_bytes(bytes([flags & 0x1F]) + b[1:48], "big")
    c0 = int.from_bytes(b[48:], "big")
    if c0 >= P or c1 >= P:
        raise ValueError("x not canonical")
    x = Fq2([c0, c1])
    y = (x * x * x + B2).sqrt()
    if y is None:
        raise ValueError("x not on curve")
    if _fq2_sign(y) != bool(flags & _SIGN_FLAG):
        y = -y
    pt = (x, y)
    if subgroup_check and not g2_curve.in_subgroup(pt):
        raise ValueError("point not in G2 subgroup")
    return pt


def __getattr__(name):
    # lazily-derived constants kept available under their public names
    if name == "N2":
        return twist_order()
    if name == "H2":
        return g2_cofactor()
    if name == "Z_SVDW":
        return _svdw_constants()[0]
    if name == "DST_G2":  # legacy alias
        return DST
    raise AttributeError(name)
