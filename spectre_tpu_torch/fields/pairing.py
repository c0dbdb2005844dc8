"""Shared Miller-loop / final-exponentiation machinery for BN and BLS pairings.

One parameterized engine instead of two near-identical copies: a curve module
supplies its Fq12, the E(Fq12) group, the twist embedding, the ate loop count,
and an optional post-loop correction hook (BN curves add two frobenius lines;
BLS curves add nothing).
"""

from __future__ import annotations


def linefunc(p1, p2, t):
    """Evaluate the line through p1,p2 (tangent if equal) at t; affine Fq12 coords."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 != x2:
        m = (y2 - y1) / (x2 - x1)
        return m * (xt - x1) - (yt - y1)
    elif y1 == y2:
        m = (x1 * x1 * 3) / (y1 * 2)
        return m * (xt - x1) - (yt - y1)
    else:
        return xt - x1


class PairingEngine:
    """Optimal-ate pairing over a sextic-twist embedding into Fq12."""

    def __init__(self, *, p, r, fq12, g12_curve, twist, cast_g1, loop_count,
                 corrections=None):
        self.p = p
        self.r = r
        self.fq12 = fq12
        self.g12 = g12_curve
        self.twist = twist
        self.cast_g1 = cast_g1
        self.loop_count = loop_count
        self.corrections = corrections  # fn(f, r_pt, q, p_cast) -> f

    def miller_loop(self, q, pt, final_exp: bool = True):
        """q: twisted G2 point in E(Fq12); pt: G1 point cast into E(Fq12)."""
        if q is None or pt is None:
            return self.fq12.one()
        r_pt, f = q, self.fq12.one()
        for i in range(self.loop_count.bit_length() - 2, -1, -1):
            f = f * f * linefunc(r_pt, r_pt, pt)
            r_pt = self.g12.double(r_pt)
            if self.loop_count & (1 << i):
                f = f * linefunc(r_pt, q, pt)
                r_pt = self.g12.add(r_pt, q)
        if self.corrections is not None:
            f = self.corrections(f, r_pt, q, pt)
        if final_exp:
            return self.final_exponentiation(f)
        return f

    def final_exponentiation(self, f):
        return f ** ((self.p ** 12 - 1) // self.r)

    def pairing(self, q, pt, final_exp: bool = True):
        """e(pt, q) with q in G2 (twist coords), pt in G1 (base-field coords)."""
        return self.miller_loop(self.twist(q), self.cast_g1(pt), final_exp)

    def pairing_check(self, pairs) -> bool:
        """prod e(p_i, q_i) == 1 with one shared final exponentiation.

        NOTE: a None (infinity) entry contributes the trivial factor 1 — that is
        the correct group-theoretic behavior for e(O, Q). Protocol-level rules
        (e.g. BLS KeyValidate rejecting identity pubkeys) belong to the caller.
        """
        f = self.fq12.one()
        for pt, q in pairs:
            if pt is None or q is None:
                continue
            f = f * self.miller_loop(self.twist(q), self.cast_g1(pt), final_exp=False)
        return self.final_exponentiation(f) == self.fq12.one()
