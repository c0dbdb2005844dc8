"""Fp12 tower chip: BLS12-381 Fq12 arithmetic over BN254 Fr cells (the
port's copy of `spectre_tpu/builder/fp12_chip.py`).

halo2-ecc's `Fp12Chip` (the pairing layer of `sync_step_circuit.rs:171`
`assert_valid_signature`). Tower: Fq12 =
Fq2[w]/(w^6 - xi), xi = 1 + u — consistent with the host poly basis
(fields/bls12_381.py: u = w^6 - 1), so host<->tower conversion is linear.

Elements are 6-tuples of reduced Fq2 pairs ((CrtUint, CrtUint) each).
Multiplication runs in the LAZY domain (Fp2Lazy): 36 coefficient products
accumulated without carries, ONE carry_mod per output coefficient limb pair
(12 total) — the constraint-count backbone of the in-circuit pairing.

Frobenius constants gamma1/gamma2 and the p^6 conjugation sign are derived
from xi once per process (no opaque tables); the chip's arithmetic equals
the host Fq12 through the tower<->poly conversion.
"""

from __future__ import annotations

import functools

from ..fields import bls12_381 as bls
from .context import Context
from .fp2_chip import Fp2Chip, Fp2Lazy

P = bls.P
XI = bls.Fq2([1, 1])


# ---------------------------------------------------------------------------
# host-side tower <-> poly-basis conversion (for witnesses and test oracles)
# ---------------------------------------------------------------------------

def tower_to_fq12(coeffs) -> "bls.Fq12":
    """[6 x Fq2] tower coords -> host poly-basis Fq12 (u = w^6 - 1)."""
    c = [0] * 12
    for i, a in enumerate(coeffs):
        a0, a1 = int(a.c[0]), int(a.c[1])
        c[i] = (c[i] + a0 - a1) % P
        c[i + 6] = (c[i + 6] + a1) % P
    return bls.Fq12(c)


def fq12_to_tower(x: "bls.Fq12"):
    """Host poly-basis Fq12 -> [6 x Fq2] tower coords."""
    c = x.c
    return [bls.Fq2([(c[i] + c[i + 6]) % P, c[i + 6]]) for i in range(6)]


@functools.cache
def frobenius_constants():
    """(gamma1[i], gamma2[i], i=0..5): xi^(i(p-1)/6) and xi^(i(p^2-1)/6).
    Conjugation sign for p^6 is -1 (asserted — xi^((p^6-1)/6) = -1)."""
    g1 = [XI ** ((i * (P - 1)) // 6) for i in range(6)]
    g2 = [XI ** ((i * (P * P - 1)) // 6) for i in range(6)]
    assert XI ** ((P ** 6 - 1) // 6) == bls.Fq2([P - 1, 0])
    return g1, g2


class Fp12Chip:
    def __init__(self, fp2: Fp2Chip):
        self.fp2 = fp2
        self.lazy = fp2.lz   # the one shared lazy engine (fp2_chip.py)

    # -- loading --------------------------------------------------------
    def load(self, ctx: Context, coeffs) -> tuple:
        """coeffs: [6 x Fq2] tower coordinates (or host Fq12)."""
        if isinstance(coeffs, bls.Fq12):
            coeffs = fq12_to_tower(coeffs)
        return tuple(self.fp2.load(ctx, a) for a in coeffs)

    def load_constant(self, ctx: Context, coeffs) -> tuple:
        if isinstance(coeffs, bls.Fq12):
            coeffs = fq12_to_tower(coeffs)
        return tuple(self.fp2.load_constant(ctx, a) for a in coeffs)

    def one(self, ctx: Context) -> tuple:
        return self.load_constant(ctx, [bls.Fq2([1, 0])] + [bls.Fq2([0, 0])] * 5)

    def value(self, a) -> "bls.Fq12":
        return tower_to_fq12([self.fp2.value(c) for c in a])

    # -- arithmetic ------------------------------------------------------
    def mul(self, ctx: Context, a, b) -> tuple:
        """Schoolbook over w-slots, lazy: S_k = sum_{i+j=k} a_i b_j;
        c_k = S_k + xi * S_{k+6}; 12 reductions total. Karatsuba operand
        sums are hoisted per coefficient (each is reused 6 times)."""
        lz = self.lazy
        sums_a = [lz.coeff_sum(ctx, a[i]) for i in range(6)]
        sums_b = [lz.coeff_sum(ctx, b[j]) for j in range(6)]
        s = [None] * 11
        for i in range(6):
            for j in range(6):
                t = lz.mul(ctx, a[i], b[j], sa=sums_a[i], sb=sums_b[j])
                k = i + j
                s[k] = t if s[k] is None else lz.add(ctx, s[k], t)
        return self._fold_and_reduce(ctx, s)

    def _fold_and_reduce(self, ctx: Context, s: list) -> tuple:
        """Slot sums s[0..10] -> 6 reduced tower coefficients:
        c_k = reduce(s_k + xi * s_{k+6})."""
        lz = self.lazy
        out = []
        for k in range(6):
            acc = s[k]
            if k + 6 <= 10 and s[k + 6] is not None:
                acc = lz.add(ctx, acc, lz.mul_by_xi(ctx, s[k + 6]))
            out.append(lz.reduce(ctx, acc))
        return tuple(out)

    def square(self, ctx: Context, a) -> tuple:
        """Symmetric schoolbook: 21 Fq2 products (6 diagonal + 15 doubled
        cross terms) instead of 36."""
        lz = self.lazy
        big = lz.big
        sums = [lz.coeff_sum(ctx, a[i]) for i in range(6)]
        s = [None] * 11
        for i in range(6):
            for j in range(i, 6):
                t = lz.mul(ctx, a[i], a[j], sa=sums[i], sb=sums[j])
                if j > i:
                    t = (big.scale_ovf(ctx, t[0], 2), big.scale_ovf(ctx, t[1], 2))
                k = i + j
                s[k] = t if s[k] is None else lz.add(ctx, s[k], t)
        return self._fold_and_reduce(ctx, s)

    def _sq4(self, ctx: Context, za, zb):
        """Fp4 squaring (za + zb V)^2 = (za^2 + xi zb^2) + (2 za zb) V for
        V = w^3, V^2 = xi — shared by the full Granger–Scott square and the
        compressed-coordinate square."""
        lz = self.lazy
        ta = lz.mul(ctx, za, za)
        tb = lz.mul(ctx, zb, zb)
        zs = lz.add(ctx, lz.lift(ctx, za), lz.lift(ctx, zb))
        ts = lz.mul(ctx, zs, zs)
        tab = lz.sub(ctx, lz.sub(ctx, ts, ta), tb)
        return lz.add(ctx, ta, lz.mul_by_xi(ctx, tb)), tab

    def _two(self, ctx: Context, p):
        """2x a reduced Fq2 pair, lazily."""
        lz = self.lazy
        return lz.scale(ctx, lz.lift(ctx, p), 2)

    def cyclotomic_square(self, ctx: Context, a) -> tuple:
        """Granger–Scott squaring, valid ONLY for elements of the cyclotomic
        subgroup (as everything after the final exponentiation's easy part
        is): with g0=(z0,z3), g1=(z1,z4), g2=(z2,z5) in Fp4 = Fp2[V],
        V = w^3, V^2 = xi, and A=g0^2, C=g1^2, B=g2^2:
            h0 = 3A - 2*conj(g0)   h1 = 3*V*B + 2*conj(g1)
            h2 = 3C - 2*conj(g2)
        Cost: 3 Fp4 squarings (27 limb convolutions) vs the generic
        symmetric square's 21 Fq2 products (63 convolutions) — the final
        exp's ~315 chain squarings are the dominant convolution count in
        the pairing. Formula numerically validated against the host tower
        (a non-cyclotomic input does NOT satisfy it; inputs here are
        constraint-forced into the subgroup by the easy part)."""
        lz = self.lazy
        sq4 = lambda za, zb: self._sq4(ctx, za, zb)
        two = lambda p: self._two(ctx, p)
        scale3 = lambda p: lz.scale(ctx, p, 3)

        z = a
        A0, A1 = sq4(z[0], z[3])
        B0, B1 = sq4(z[2], z[5])
        C0, C1 = sq4(z[1], z[4])
        y0 = lz.sub(ctx, scale3(A0), two(z[0]))
        y3 = lz.add(ctx, scale3(A1), two(z[3]))
        y1 = lz.add(ctx, scale3(lz.mul_by_xi(ctx, B1)), two(z[1]))
        y4 = lz.sub(ctx, scale3(B0), two(z[4]))
        y2 = lz.sub(ctx, scale3(C0), two(z[2]))
        y5 = lz.add(ctx, scale3(C1), two(z[5]))
        return tuple(lz.reduce(ctx, y) for y in (y0, y1, y2, y3, y4, y5))

    # -- Karabina-style compressed cyclotomic squaring ------------------
    # In this tower the coordinate set {c1, c2, c4, c5} is CLOSED under the
    # Granger–Scott square map (y1,y2,y4,y5 depend only on z1,z2,z4,z5 —
    # read off cyclotomic_square above), so long square runs in pow_abs_x
    # carry 4 coefficients instead of 6: 6 Fq2 products + 8 reductions per
    # square vs the full GS 9 + 12. Decompression recovers (c0, c3) from
    # the unit-norm identity g·conj(g) = 1, which in v-coordinates
    # (v = w², E = c0 + c2 v + c4 v², O = c1 + c3 v + c5 v²; E² − vO² = 1)
    # yields the LINEAR system
    #     2 c2·c0 − 2ξ c5·c3 = c1² − ξ c4²
    #     2 c4·c0 − 2 c1·c3 = ξ c5² − c2²
    # — witnessed (c0, c3), both equations constrained, and the system's
    # determinant 4(ξ c4 c5 − c1 c2) constrained nonzero so the solution is
    # pinned uniquely. Host-validated against the full tower square.

    def _compressed_square(self, ctx: Context, comp) -> tuple:
        """One squaring step on (c1, c2, c4, c5) of a cyclotomic element."""
        lz = self.lazy
        z1, z2, z4, z5 = comp
        two = lambda p: self._two(ctx, p)
        B0, B1 = self._sq4(ctx, z2, z5)
        C0, C1 = self._sq4(ctx, z1, z4)
        y1 = lz.add(ctx, lz.scale(ctx, lz.mul_by_xi(ctx, B1), 3), two(z1))
        y4 = lz.sub(ctx, lz.scale(ctx, B0, 3), two(z4))
        y2 = lz.sub(ctx, lz.scale(ctx, C0, 3), two(z2))
        y5 = lz.add(ctx, lz.scale(ctx, C1, 3), two(z5))
        return tuple(lz.reduce(ctx, y) for y in (y1, y2, y4, y5))

    def _decompress(self, ctx: Context, comp) -> tuple:
        """(c1, c2, c4, c5) -> full 6-tuple, recovering (c0, c3)."""
        fp2, lz = self.fp2, self.lazy
        z1, z2, z4, z5 = comp
        XI_h = bls.Fq2([1, 1])
        two_h = bls.Fq2([2, 0])
        v1, v2, v4, v5 = (fp2.value(z) for z in comp)
        a11, a12 = v2 * two_h, bls.Fq2([0, 0]) - XI_h * v5 * two_h
        a21, a22 = v4 * two_h, bls.Fq2([0, 0]) - v1 * two_h
        b1 = v1 * v1 - XI_h * v4 * v4
        b2 = XI_h * v5 * v5 - v2 * v2
        det = a11 * a22 - a12 * a21
        # det == 0 (xi c4 c5 == c1 c2) happens with probability ~2^-381 for
        # the final-exp chain values of an honest witness, and a witness
        # engineered to hit it only aborts ITS OWN proving (witness-time
        # assert; constraint shape must stay witness-independent, so a
        # dynamic fallback to full squares is not an option)
        if det == bls.Fq2([0, 0]):
            raise ValueError("compressed element not decompressible")
        c0 = fp2.load(ctx, (b1 * a22 - b2 * a12) / det)
        c3 = fp2.load(ctx, (a11 * b2 - a21 * b1) / det)
        # det != 0 pins (c0, c3) as the unique solution (reduce before the
        # inverse product so the quotient stays within limb width)
        det_cell = lz.reduce(
            ctx, lz.sub(ctx, lz.mul_by_xi(ctx, lz.mul(ctx, z4, z5)),
                        lz.mul(ctx, z1, z2)))
        fp2.assert_nonzero(ctx, det_cell)
        eq1 = lz.sub(
            ctx,
            lz.sub(ctx, lz.scale(ctx, lz.mul(ctx, z2, c0), 2),
                   lz.scale(ctx, lz.mul_by_xi(ctx, lz.mul(ctx, z5, c3)), 2)),
            lz.sub(ctx, lz.mul(ctx, z1, z1),
                   lz.mul_by_xi(ctx, lz.mul(ctx, z4, z4))))
        lz.assert_zero(ctx, eq1)
        eq2 = lz.sub(
            ctx,
            lz.sub(ctx, lz.scale(ctx, lz.mul(ctx, z4, c0), 2),
                   lz.scale(ctx, lz.mul(ctx, z1, c3), 2)),
            lz.sub(ctx, lz.mul_by_xi(ctx, lz.mul(ctx, z5, z5)),
                   lz.mul(ctx, z2, z2)))
        lz.assert_zero(ctx, eq2)
        return (c0, z1, z2, c3, z4, z5)

    def conjugate(self, ctx: Context, a) -> tuple:
        """f^(p^6): w -> -w (gamma6 = -1): negate odd slots."""
        fp2 = self.fp2
        out = []
        for i, c in enumerate(a):
            out.append(fp2.neg(ctx, c) if i % 2 else c)
        return tuple(out)

    def frobenius(self, ctx: Context, a, power: int = 1) -> tuple:
        """f^(p^power) for power in {1, 2}: coefficient-wise Fq2 frobenius
        (conjugation for odd power) then gamma constant mul. (The final
        exponentiation needs only these two powers.)"""
        if power not in (1, 2):
            raise ValueError("power is 1 or 2")
        g1, g2 = frobenius_constants()
        fp2, lz = self.fp2, self.lazy
        out = []
        for i, c in enumerate(a):
            if power == 1:
                cc, k = fp2.conjugate(ctx, c), g1[i]
            else:
                cc, k = c, g2[i]
            out.append(lz.reduce(ctx, lz.mul_const(ctx, cc, k)))
        return tuple(out)

    def mul_sparse_035(self, ctx: Context, f, c0, c3, c5) -> tuple:
        """f * (c0 + c3 w^3 + c5 w^5) where c0/c3/c5 are REDUCED Fq2 pairs
        (the Miller line shape for the M-twist with 1/w folding; see
        pairing_chip). 18 Fq2 products, 12 reductions."""
        lz = self.lazy
        s = [None] * 11
        sums_f = [lz.coeff_sum(ctx, f[i]) for i in range(6)]
        sum_c0 = lz.coeff_sum(ctx, c0)
        sum_c3 = lz.coeff_sum(ctx, c3)
        sum_c5 = lz.coeff_sum(ctx, c5)

        def acc(k, t):
            s[k] = t if s[k] is None else lz.add(ctx, s[k], t)

        for i in range(6):
            fi, sfi = f[i], sums_f[i]
            acc(i, lz.mul(ctx, fi, c0, sa=sfi, sb=sum_c0))
            acc(i + 3, lz.mul(ctx, fi, c3, sa=sfi, sb=sum_c3))
            acc(i + 5, lz.mul(ctx, fi, c5, sa=sfi, sb=sum_c5))
        return self._fold_and_reduce(ctx, s)

    def assert_equal(self, ctx: Context, a, b):
        for x, y in zip(a, b):
            self.fp2.assert_equal(ctx, x, y)

    def assert_one(self, ctx: Context, a):
        one = self.one(ctx)
        self.assert_equal(ctx, a, one)

    def inverse(self, ctx: Context, a) -> tuple:
        """Witnessed inverse: load inv(a) and constrain a * inv == 1."""
        av = self.value(a)
        inv = self.load(ctx, av.inv())
        prod = self.mul(ctx, a, inv)
        self.assert_one(ctx, prod)
        return inv

    # -- exponentiation by |x| (BLS parameter), for the final exp -------
    def pow_abs_x(self, ctx: Context, a, cyclotomic: bool = False) -> tuple:
        """a^|x|, |x| = 0xd201000000010000 (square-and-multiply over the
        fixed bit pattern; bits 63,62,60,57,48,16). cyclotomic=True uses
        Granger–Scott squaring, with square runs >= 3 carried in the
        compressed (c1,c2,c4,c5) coordinates (see _compressed_square) —
        only valid for subgroup elements."""
        absx = -bls.BLS_X
        bits = bin(absx)[2:]
        if not cyclotomic:
            acc = a
            for bit in bits[1:]:
                acc = self.square(ctx, acc)
                if bit == "1":
                    acc = self.mul(ctx, acc, a)
            return acc
        # runs of squares between multiplies: [(k squares, mul after?)]
        runs = []
        cnt = 0
        for bit in bits[1:]:
            cnt += 1
            if bit == "1":
                runs.append((cnt, True))
                cnt = 0
        if cnt:
            runs.append((cnt, False))
        acc = a
        for k, mul_after in runs:
            if k >= 3:   # decompression overhead (~2 squares) amortized
                comp = (acc[1], acc[2], acc[4], acc[5])
                for _ in range(k):
                    comp = self._compressed_square(ctx, comp)
                acc = self._decompress(ctx, comp)
            else:
                for _ in range(k):
                    acc = self.cyclotomic_square(ctx, acc)
            if mul_after:
                acc = self.mul(ctx, acc, a)
        return acc
