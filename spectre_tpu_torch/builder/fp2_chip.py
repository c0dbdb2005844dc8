"""Fp2 chip: BLS12-381 quadratic-extension arithmetic over FpChip (the
port's copy of `spectre_tpu/builder/fp2_chip.py`).

halo2-ecc's `Fp2Chip`: the coordinate field of G2 points (signatures live in
G2), and with it the G2 EccChip, the layer under the in-circuit pairing.

Elements are (c0, c1) CrtUint pairs representing c0 + c1*u with u^2 = -1.
"""

from __future__ import annotations

from ..fields import bls12_381 as bls
from .context import Context
from .fp_chip import FpChip

P = bls.P


class Fp2Chip:
    def __init__(self, fp: FpChip):
        self.fp = fp
        self._lz = None

    @property
    def lz(self) -> "Fp2Lazy":
        # internal lazy engine (created on first use; Fp2Lazy(self) is just
        # two attribute grabs, the cycle is benign)
        if self._lz is None:
            self._lz = Fp2Lazy(self)
        return self._lz

    def load(self, ctx: Context, v) -> tuple:
        """v: fields.bls12_381.Fq2 or (c0, c1) ints."""
        c0, c1 = (v.c if hasattr(v, "c") else v)
        return (self.fp.load(ctx, int(c0)), self.fp.load(ctx, int(c1)))

    def load_constant(self, ctx: Context, v) -> tuple:
        c0, c1 = (v.c if hasattr(v, "c") else v)
        return (self.fp.load_constant(ctx, int(c0)),
                self.fp.load_constant(ctx, int(c1)))

    def value(self, a) -> "bls.Fq2":
        return bls.Fq2([a[0].value % P, a[1].value % P])

    def add(self, ctx: Context, a, b) -> tuple:
        return (self.fp.add(ctx, a[0], b[0]), self.fp.add(ctx, a[1], b[1]))

    def sub(self, ctx: Context, a, b) -> tuple:
        return (self.fp.sub(ctx, a[0], b[0]), self.fp.sub(ctx, a[1], b[1]))

    def mul(self, ctx: Context, a, b) -> tuple:
        """(a0 + a1 u)(b0 + b1 u) = (a0b0 - a1b1) + (a0b1 + a1b0) u.
        Runs on the lazy engine (Karatsuba: 3 limb convolutions) with one
        reduction per output coefficient."""
        lz = self.lz
        return lz.reduce(ctx, lz.mul(ctx, a, b))

    def square(self, ctx: Context, a) -> tuple:
        """(a0^2 - a1^2) + 2 a0 a1 u (complex squaring, lazy: 2 limb
        convolutions + 2 reductions)."""
        lz = self.lz
        return lz.reduce(ctx, lz.square(ctx, a))

    def mul_scalar(self, ctx: Context, a, k: int) -> tuple:
        return (self.fp.mul_scalar(ctx, a[0], k), self.fp.mul_scalar(ctx, a[1], k))

    def neg(self, ctx: Context, a) -> tuple:
        zero = self.fp.load_constant(ctx, 0)
        return (self.fp.sub(ctx, zero, a[0]), self.fp.sub(ctx, zero, a[1]))

    def conjugate(self, ctx: Context, a) -> tuple:
        zero = self.fp.load_constant(ctx, 0)
        return (a[0], self.fp.sub(ctx, zero, a[1]))

    def div_unsafe(self, ctx: Context, a, b) -> tuple:
        """q with q*b == a; witness the quotient, constrain q*b - a ≡ 0 via
        the lazy engine (3 convolutions + 2 quotient-only reductions — no
        eager product or remainder witnesses)."""
        lz = self.lz
        av, bv = self.value(a), self.value(b)
        qv = av / bv
        q = self.load(ctx, qv)
        lz.assert_zero(ctx, lz.sub(ctx, lz.mul(ctx, q, b), lz.lift(ctx, a)))
        return q

    def assert_equal(self, ctx: Context, a, b):
        self.fp.assert_equal(ctx, self.fp._reduced(ctx, a[0]),
                             self.fp._reduced(ctx, b[0]))
        self.fp.assert_equal(ctx, self.fp._reduced(ctx, a[1]),
                             self.fp._reduced(ctx, b[1]))

    def select(self, ctx: Context, bit, a, b) -> tuple:
        return (self.fp.select(ctx, bit, a[0], b[0]),
                self.fp.select(ctx, bit, a[1], b[1]))

    def assert_nonzero(self, ctx: Context, a):
        """Constrain a != 0 in Fp2 via witnessed inverse a*inv - 1 ≡ 0 (same
        soundness argument as FpChip.assert_nonzero), on the lazy engine."""
        self.lz.assert_nonzero(ctx, a)


class Fp2Lazy:
    """Lazily-reduced Fq2 arithmetic: elements are (OverflowInt, OverflowInt)
    pairs accumulated with no-carry limb ops and reduced once per output
    coefficient (halo2-ecc's FieldExtPoint-over-CRTInteger pattern — this is
    what makes the in-circuit pairing affordable: an Fp12 mul costs 12
    reductions instead of 144)."""

    FQ_BITS = 381  # reduced CrtUint elements are < 2^381

    def __init__(self, fp2: Fp2Chip):
        self.fp2 = fp2
        self.big = fp2.fp.big

    # -- entering the lazy domain --------------------------------------
    def lift(self, ctx: Context, a) -> tuple:
        """(CrtUint, CrtUint) -> (OverflowInt, OverflowInt)."""
        return (self.big.to_overflow(a[0], self.FQ_BITS),
                self.big.to_overflow(a[1], self.FQ_BITS))

    def coeff_sum(self, ctx: Context, a):
        """a0 + a1 as an OverflowInt (the Karatsuba operand sum) — hoist and
        reuse when the same element multiplies many others (Fp12 mul)."""
        big = self.big
        return big.add_ovf(ctx, big.to_overflow(a[0], self.FQ_BITS),
                           big.to_overflow(a[1], self.FQ_BITS))

    def mul(self, ctx: Context, a, b, sa=None, sb=None) -> tuple:
        """Reduced pairs -> lazy product (a0b0 - a1b1, a0b1 + a1b0),
        Karatsuba: 3 limb convolutions instead of 4. sa/sb: optional
        precomputed coeff_sum(a)/coeff_sum(b)."""
        big = self.big
        t0 = big.mul_ovf(ctx, a[0], b[0], self.FQ_BITS)
        t1 = big.mul_ovf(ctx, a[1], b[1], self.FQ_BITS)
        sa = sa if sa is not None else self.coeff_sum(ctx, a)
        sb = sb if sb is not None else self.coeff_sum(ctx, b)
        t01 = big.mul_ovf(ctx, sa, sb)
        cross = big.sub_ovf(ctx, big.sub_ovf(ctx, t01, t0), t1)
        return (big.sub_ovf(ctx, t0, t1), cross)

    def square(self, ctx: Context, a) -> tuple:
        """Complex squaring, lazy: ((a0+a1)(a0-a1), 2 a0 a1) — 2 limb
        convolutions. a: reduced pair or OverflowInt pair."""
        big = self.big
        oa0 = big.to_overflow(a[0], self.FQ_BITS)
        oa1 = big.to_overflow(a[1], self.FQ_BITS)
        s = big.add_ovf(ctx, oa0, oa1)
        d = big.sub_ovf(ctx, oa0, oa1)
        c0 = big.mul_ovf(ctx, s, d)
        a0a1 = big.mul_ovf(ctx, oa0, oa1)
        return (c0, big.scale_ovf(ctx, a0a1, 2))

    def scale(self, ctx: Context, x, k: int) -> tuple:
        """Lazy pair times a small non-negative host constant."""
        big = self.big
        return (big.scale_ovf(ctx, x[0], k), big.scale_ovf(ctx, x[1], k))

    def assert_zero(self, ctx: Context, x) -> None:
        """Constrain a lazy pair ≡ (0, 0) mod p (quotient-only reductions)."""
        big = self.big
        big.assert_zero_mod(ctx, x[0], P)
        big.assert_zero_mod(ctx, x[1], P)

    def value(self, x) -> "bls.Fq2":
        """Host value of a lazy (or reduced) pair."""
        return bls.Fq2([x[0].value % P, x[1].value % P])

    def assert_nonzero(self, ctx: Context, x) -> None:
        """Constrain a lazy pair != 0 via witnessed inverse: x*inv - 1 ≡ 0."""
        big = self.big
        v = self.value(x)
        if v == bls.Fq2([0, 0]):
            raise ValueError("assert_nonzero: witness is zero")
        inv = self.fp2.load(ctx, bls.Fq2([1, 0]) / v)
        prod = self.mul(ctx, x, inv)
        one = big.const_ovf(ctx, 1)
        self.assert_zero(ctx, (big.sub_ovf(ctx, prod[0], one), prod[1]))

    def mul_by_fq_cell(self, ctx: Context, a, x: "CrtUint") -> tuple:
        """Fq2 pair times a base-field CrtUint cell."""
        big = self.big
        return (big.mul_ovf(ctx, a[0], x, self.FQ_BITS),
                big.mul_ovf(ctx, a[1], x, self.FQ_BITS))

    # -- lazy-domain ops ------------------------------------------------
    def add(self, ctx: Context, x, y) -> tuple:
        big = self.big
        return (big.add_ovf(ctx, x[0], y[0]), big.add_ovf(ctx, x[1], y[1]))

    def sub(self, ctx: Context, x, y) -> tuple:
        big = self.big
        return (big.sub_ovf(ctx, x[0], y[0]), big.sub_ovf(ctx, x[1], y[1]))

    def mul_const(self, ctx: Context, a, k: "bls.Fq2") -> tuple:
        """REDUCED pair times an Fq2 host constant (k0 + k1 u), via
        constant-limb convolutions: (a0k0 - a1k1, a0k1 + a1k0) lazy."""
        big = self.big
        k0, k1 = int(k.c[0]) % P, int(k.c[1]) % P
        a0k0 = big.mul_ovf_const(ctx, a[0], k0, self.FQ_BITS)
        a1k1 = big.mul_ovf_const(ctx, a[1], k1, self.FQ_BITS)
        a0k1 = big.mul_ovf_const(ctx, a[0], k1, self.FQ_BITS)
        a1k0 = big.mul_ovf_const(ctx, a[1], k0, self.FQ_BITS)
        return (big.sub_ovf(ctx, a0k0, a1k1), big.add_ovf(ctx, a0k1, a1k0))

    def mul_by_xi(self, ctx: Context, x) -> tuple:
        """Times xi = 1 + u: (c0 - c1, c0 + c1)."""
        big = self.big
        return (big.sub_ovf(ctx, x[0], x[1]), big.add_ovf(ctx, x[0], x[1]))

    def neg(self, ctx: Context, x) -> tuple:
        from .bigint import OverflowInt
        gate = self.fp2.fp.gate

        def n(v):
            return OverflowInt([gate.neg(ctx, l) for l in v.limbs],
                               -v.value, v.limb_abs, v.val_abs)

        return (n(x[0]), n(x[1]))

    def reduce(self, ctx: Context, x) -> tuple:
        """Lazy pair -> reduced (CrtUint, CrtUint) mod p."""
        big = self.big
        return (big.carry_mod_ovf(ctx, x[0], P),
                big.carry_mod_ovf(ctx, x[1], P))


class G2Chip:
    """Non-native G2 affine arithmetic over Fp2Chip (halo2-ecc's
    `EccChip<Fp2>`, the signature-side group of `assign_signature:279`).

    All point formulas run on the lazy engine: the chord/tangent identities
    are constrained directly on unreduced accumulations (λ·dx - dy ≡ 0 etc.),
    so an add costs 2 quotient-only checks + 4 reductions instead of ~10
    eager Fq2 operations."""

    def __init__(self, fp2: Fp2Chip):
        self.fp2 = fp2

    def load_point(self, ctx: Context, pt) -> tuple:
        """On-curve check y^2 - x^3 - 4(1+u) ≡ 0, lazy (2 squares + 1 mul
        as convolutions, one intermediate reduction, 2 zero checks)."""
        fp2 = self.fp2
        lz = fp2.lz
        x = fp2.load(ctx, pt[0])
        y = fp2.load(ctx, pt[1])
        y2 = lz.square(ctx, y)
        x2r = lz.reduce(ctx, lz.square(ctx, x))
        x3 = lz.mul(ctx, x2r, x)
        t = lz.sub(ctx, y2, x3)
        b0, b1 = int(bls.B2.c[0]), int(bls.B2.c[1])
        big = lz.big
        t = (big.sub_ovf(ctx, t[0], big.const_ovf(ctx, b0)),
             big.sub_ovf(ctx, t[1], big.const_ovf(ctx, b1)))
        lz.assert_zero(ctx, t)
        return (x, y)

    # -- lazy chord/tangent cores (shared with PairingChip's Miller steps) --
    def add_core(self, ctx: Context, t_pt, q_pt, strict: bool = True) -> tuple:
        """((T+Q), chord slope λ). strict constrains x_T != x_Q — without it
        T == ±Q lets any witnessed slope satisfy 0·λ = 0 (see
        EccChip.add_unequal). Operands are reduced Fq2 pairs."""
        fp2 = self.fp2
        lz = fp2.lz
        xt, yt = t_pt
        xq, yq = q_pt
        dx = lz.sub(ctx, lz.lift(ctx, xt), lz.lift(ctx, xq))
        dy = lz.sub(ctx, lz.lift(ctx, yt), lz.lift(ctx, yq))
        if strict:
            lz.assert_nonzero(ctx, dx)
        lam = fp2.load(ctx, lz.value(dy) / lz.value(dx))
        # λ·dx - dy ≡ 0
        lz.assert_zero(ctx, lz.sub(ctx, lz.mul(ctx, lam, dx), dy))
        lam2 = lz.mul(ctx, lam, lam)
        oxt = lz.lift(ctx, xt)
        x3 = lz.reduce(ctx, lz.sub(ctx, lz.sub(ctx, lam2, oxt),
                                   lz.lift(ctx, xq)))
        d13 = lz.sub(ctx, oxt, lz.lift(ctx, x3))
        y3 = lz.reduce(ctx, lz.sub(ctx, lz.mul(ctx, lam, d13),
                                   lz.lift(ctx, yt)))
        return (x3, y3), lam

    def double_core(self, ctx: Context, t_pt) -> tuple:
        """((2T), tangent slope λ): constrain 2·(λ·y) - 3·x² ≡ 0 directly
        (no reduced intermediates for the slope identity). y != 0 always
        holds on-curve: no order-2 points with b != 0 twists here."""
        fp2 = self.fp2
        lz = fp2.lz
        x, y = t_pt
        xv, yv = fp2.value(x), fp2.value(y)
        lam = fp2.load(ctx, xv * xv * bls.Fq2([3, 0]) / (yv * bls.Fq2([2, 0])))
        lamy = lz.mul(ctx, lam, y)
        x2 = lz.square(ctx, x)
        lz.assert_zero(ctx, lz.sub(ctx, lz.scale(ctx, lamy, 2),
                                   lz.scale(ctx, x2, 3)))
        lam2 = lz.mul(ctx, lam, lam)
        ox = lz.lift(ctx, x)
        x3 = lz.reduce(ctx, lz.sub(ctx, lz.sub(ctx, lam2, ox), ox))
        d13 = lz.sub(ctx, ox, lz.lift(ctx, x3))
        y3 = lz.reduce(ctx, lz.sub(ctx, lz.mul(ctx, lam, d13),
                                   lz.lift(ctx, y)))
        return (x3, y3), lam

    def add_unequal(self, ctx: Context, p, q, strict: bool = True) -> tuple:
        pt, _lam = self.add_core(ctx, p, q, strict=strict)
        return pt

    def double(self, ctx: Context, p) -> tuple:
        pt, _lam = self.double_core(ctx, p)
        return pt
