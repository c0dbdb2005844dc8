"""Non-native field chip: BLS12-381 Fq arithmetic over BN254 Fr cells (the
port's copy of `spectre_tpu/builder/fp_chip.py`).

halo2-ecc's `FpChip`: the foundation of the in-circuit BLS machinery (G1/G2
point ops and the pairing). Built on BigUintChip's CRT reduction.
"""

from __future__ import annotations

from ..fields import bls12_381 as bls
from .bigint import BigUintChip, CrtUint, OverflowInt
from .context import Context
from .range_chip import RangeChip

P = bls.P


class FpChip:
    """Non-native Fp chip over a run-time modulus. Defaults to BLS12-381 Fq
    with the spec limb shape; the aggregation layer instantiates it for
    BN254 Fq with 3 x 88-bit limbs (snark-verifier's accumulator encoding)."""

    def __init__(self, rng: RangeChip, modulus: int = P,
                 num_limbs: int | None = None, limb_bits: int | None = None):
        kw = {}
        if num_limbs is not None:
            kw["num_limbs"] = num_limbs
        if limb_bits is not None:
            kw["limb_bits"] = limb_bits
        self.big = BigUintChip(rng, **kw)
        self.gate = rng.gate
        self.p = int(modulus)

    def load(self, ctx: Context, v: int) -> CrtUint:
        v = int(v) % self.p
        return self.big.load(ctx, v, max_bits=self.p.bit_length())

    def load_constant(self, ctx: Context, v: int) -> CrtUint:
        return self.big.load_constant(ctx, int(v) % self.p)

    def add(self, ctx: Context, a: CrtUint, b: CrtUint) -> CrtUint:
        s = self.big.add_no_carry(ctx, a, b)
        # reduce via carry_mod on the (L-limb) sum: reuse the product path by
        # padding to 2L-1 limbs with zeros
        zero = ctx.load_constant(0)
        limbs = s.limbs + [zero] * (2 * len(a.limbs) - 1 - len(s.limbs))
        return self.big.carry_mod(ctx, limbs, s.value, self.p)

    def mul(self, ctx: Context, a: CrtUint, b: CrtUint) -> CrtUint:
        prod = self.big.mul_no_carry(ctx, a, b)
        return self.big.carry_mod(ctx, prod, a.value * b.value, self.p)

    def sub(self, ctx: Context, a: CrtUint, b: CrtUint) -> CrtUint:
        """a - b mod p: compute via a + (p*k - b) with k s.t. values stay
        non-negative (k=1 suffices since b < p)."""
        pk = self.big.load_constant(ctx, self.p)
        t = self.big.add_no_carry(ctx, a, pk)
        limbs = [self.gate.sub(ctx, x, y) if y is not None else x
                 for x, y in zip(t.limbs, b.limbs + [None] * (len(t.limbs) - len(b.limbs)))]
        value = a.value + self.p - b.value
        zero = ctx.load_constant(0)
        padded = limbs + [zero] * (2 * len(a.limbs) - 1 - len(limbs))
        native = None
        # rebuild native for the carry path consistency: carry_mod recomputes
        # natives from the limbs, so only limbs + value matter here
        return self.big.carry_mod(ctx, padded, value, self.p)

    def assert_equal(self, ctx: Context, a: CrtUint, b: CrtUint):
        for x, y in zip(a.limbs, b.limbs):
            ctx.constrain_equal(x, y)

    def mul_scalar(self, ctx: Context, a: CrtUint, k: int) -> CrtUint:
        limbs = [self.gate.mul(ctx, x, k) for x in a.limbs]
        zero = ctx.load_constant(0)
        padded = limbs + [zero] * (2 * len(a.limbs) - 1 - len(limbs))
        return self.big.carry_mod(ctx, padded, a.value * k, self.p)

    def div_unsafe(self, ctx: Context, a: CrtUint, b: CrtUint) -> CrtUint:
        """q with q*b = a (mod p); only the product relation is constrained."""
        p = self.p
        q_val = a.value % p * pow(b.value % p, -1, p) % p
        q = self.load(ctx, q_val)
        prod = self.big.mul_no_carry(ctx, q, b)
        r = self.big.carry_mod(ctx, prod, q_val * b.value, self.p)
        # r must equal a mod p — a is already reduced (< p), so limb equality
        self.assert_equal(ctx, r, self._reduced(ctx, a))
        return q

    def _reduced(self, ctx: Context, a: CrtUint) -> CrtUint:
        if a.value < self.p:
            return a
        zero = ctx.load_constant(0)
        padded = a.limbs + [zero] * (2 * len(a.limbs) - 1 - len(a.limbs))
        return self.big.carry_mod(ctx, padded, a.value, self.p)

    def from_limbs(self, ctx: Context, limbs: list, value: int) -> CrtUint:
        """CrtUint from existing (range-checked) limb cells."""
        native = self.gate.inner_product_const(
            ctx, limbs, self.big._pow_native[:len(limbs)])
        return CrtUint(limbs, native, value)

    def select(self, ctx: Context, bit, a: CrtUint, b: CrtUint) -> CrtUint:
        """bit ? a : b — limbs and the already-constrained natives both
        selected directly (no native rebuild)."""
        gate = self.gate
        limbs = [gate.select(ctx, x, y, bit) for x, y in zip(a.limbs, b.limbs)]
        native = gate.select(ctx, a.native, b.native, bit)
        return CrtUint(limbs, native, a.value if bit.value else b.value)

    def load_constant_point(self, ctx: Context, pt) -> tuple:
        """Constant G1 point as CrtUint pair (no on-curve check needed)."""
        return (self.load_constant(ctx, int(pt[0])),
                self.load_constant(ctx, int(pt[1])))

    def assert_nonzero(self, ctx: Context, a: CrtUint):
        """Constrain a != 0 (mod p) via a witnessed inverse: a*inv - 1 == 0
        (mod p). Sound without canonical form — no inverse of 0 exists, so no
        witness satisfies the relation when a = 0 mod p. Closes the P == Q
        forgery hole in witness-slope addition (halo2-ecc's strict
        `ec_add_unequal`)."""
        av = a.value % self.p
        if av == 0:
            raise ValueError("assert_nonzero: witness is zero")
        inv = self.load(ctx, pow(av, -1, self.p))
        prod = self.big.mul_no_carry(ctx, a, inv)
        # subtract 1 from the low product limb, then carry the lot to zero
        from ..fields import bn254
        prod0 = self.gate.add(ctx, prod[0], bn254.R - 1)
        self.big.check_carry_to_zero(ctx, [prod0] + prod[1:],
                                     a.value * inv.value - 1, self.p)

    def canonicalize(self, ctx: Context, a: CrtUint) -> CrtUint:
        """Reduce and enforce the canonical representative r < p (not just
        r < 2^381). Use at circuit boundaries where limbs become public or
        byte-compared."""
        r = self._reduced(ctx, a)
        self.big.enforce_lt(ctx, r, self.p)
        return r


class EccChip:
    """Non-native G1 affine arithmetic (BLS12-381) over FpChip.

    halo2-ecc's `EccChip`: witness-slope addition/doubling
    (the 512-iteration aggregation loop of `aggregate_pubkeys:292` builds on
    exactly these ops)."""

    def __init__(self, fp: FpChip, b: int = 4):
        """b: the short-Weierstrass constant (y^2 = x^3 + b). 4 for
        BLS12-381 G1, 3 for BN254 G1 (the aggregation layer's curve)."""
        self.fp = fp
        self.b = b

    def load_point(self, ctx: Context, pt) -> tuple:
        x, y = int(pt[0]), int(pt[1])
        # on-curve check: y^2 == x^3 + b
        xc = self.fp.load(ctx, x)
        yc = self.fp.load(ctx, y)
        return self.constrain_on_curve(ctx, xc, yc)

    def constrain_on_curve(self, ctx: Context, xc, yc) -> tuple:
        """On-curve check y² - x³ - b ≡ 0 for already-loaded coordinates,
        lazy: 3 limb convolutions, one intermediate reduction (x² — needed to
        keep the cubic's quotient within limb width), one quotient-only
        zero check."""
        fp, big = self.fp, self.fp.big
        p = fp.p
        bits = p.bit_length()
        y2 = big.mul_ovf(ctx, yc, yc, bits)
        x2r = big.carry_mod_ovf(ctx, big.mul_ovf(ctx, xc, xc, bits), p)
        x3 = big.mul_ovf(ctx, x2r, xc, bits)
        t = big.sub_ovf(ctx, y2, x3)
        big.assert_zero_mod(ctx, big.sub_ovf(ctx, t, big.const_ovf(ctx, self.b)), p)
        return (xc, yc)

    def add_unequal(self, ctx: Context, p, q, strict: bool = True) -> tuple:
        """(x1,y1)+(x2,y2), x1 != x2: witness slope; standard chord formulas.

        strict constrains dx != 0 — without it, P == Q makes both div_unsafe
        operands 0 and ANY slope satisfies q*0 = 0, letting a prover forge the
        sum (halo2-ecc strict mode). Pass strict=False only when
        x1 != x2 is already constrained elsewhere."""
        x1, y1 = p
        x2, y2 = q
        dx = self.fp.sub(ctx, x2, x1)
        if strict:
            self.fp.assert_nonzero(ctx, dx)
        dy = self.fp.sub(ctx, y2, y1)
        lam = self.fp.div_unsafe(ctx, dy, dx)
        lam2 = self.fp.mul(ctx, lam, lam)
        x3 = self.fp.sub(ctx, self.fp.sub(ctx, lam2, x1), x2)
        y3 = self.fp.sub(ctx, self.fp.mul(ctx, lam, self.fp.sub(ctx, x1, x3)), y1)
        return (x3, y3)

    def double(self, ctx: Context, p) -> tuple:
        x1, y1 = p
        x2 = self.fp.mul(ctx, x1, x1)
        three_x2 = self.fp.mul_scalar(ctx, x2, 3)
        two_y = self.fp.mul_scalar(ctx, y1, 2)
        lam = self.fp.div_unsafe(ctx, three_x2, two_y)
        lam2 = self.fp.mul(ctx, lam, lam)
        x3 = self.fp.sub(ctx, self.fp.sub(ctx, lam2, x1), x1)
        y3 = self.fp.sub(ctx, self.fp.mul(ctx, lam, self.fp.sub(ctx, x1, x3)), y1)
        return (x3, y3)

    # -- lazy variants: one carry per constrained identity ----------------
    # The chord/tangent equations are enforced directly on OverflowInt
    # accumulations (λ·dx - dy ≡ 0 etc.), so an add costs 4-5 reductions
    # instead of ~10. This is what makes the aggregation circuit's in-circuit
    # MSM (reference: snark-verifier's in-circuit accumulator MSM) tractable.

    def _lam_witness(self, num: int, den: int) -> int:
        p = self.fp.p
        return num % p * pow(den % p, -1, p) % p

    def add_unequal_lazy(self, ctx: Context, pt, q, strict: bool = True) -> tuple:
        fp, big = self.fp, self.fp.big
        p = fp.p
        bits = p.bit_length()
        x1, y1 = pt
        x2, y2 = q
        ox1, oy1 = big.to_overflow(x1, bits), big.to_overflow(y1, bits)
        ox2, oy2 = big.to_overflow(x2, bits), big.to_overflow(y2, bits)
        dx = big.sub_ovf(ctx, ox2, ox1)
        dy = big.sub_ovf(ctx, oy2, oy1)
        if strict:
            # dx != 0 (mod p): witnessed inverse, dx*inv - 1 ≡ 0
            if dx.value % p == 0:
                raise ValueError("add_unequal_lazy: P == ±Q")
            inv = fp.load(ctx, pow(dx.value % p, -1, p))
            t = big.mul_ovf(ctx, dx, inv, bits)
            big.assert_zero_mod(ctx, big.sub_ovf(ctx, t, big.const_ovf(ctx, 1)), p)
        lam = fp.load(ctx, self._lam_witness(dy.value, dx.value))
        # λ·dx - dy ≡ 0
        big.assert_zero_mod(
            ctx, big.sub_ovf(ctx, big.mul_ovf(ctx, lam, dx, bits), dy), p)
        # x3 = λ² - x1 - x2
        lam2 = big.mul_ovf(ctx, lam, lam, bits)
        x3 = big.carry_mod_ovf(
            ctx, big.sub_ovf(ctx, big.sub_ovf(ctx, lam2, ox1), ox2), p)
        # y3 = λ(x1 - x3) - y1
        d13 = big.sub_ovf(ctx, ox1, big.to_overflow(x3, bits))
        y3 = big.carry_mod_ovf(
            ctx, big.sub_ovf(ctx, big.mul_ovf(ctx, lam, d13, bits), oy1), p)
        return (x3, y3)

    def double_lazy(self, ctx: Context, pt) -> tuple:
        fp, big = self.fp, self.fp.big
        p = fp.p
        bits = p.bit_length()
        x1, y1 = pt
        ox1, oy1 = big.to_overflow(x1, bits), big.to_overflow(y1, bits)
        xx = big.mul_ovf(ctx, x1, x1, bits)
        lam = fp.load(ctx, self._lam_witness(3 * xx.value, 2 * oy1.value))
        # λ·2y - 3x² ≡ 0  (y != 0 always holds: no order-2 points in a prime-
        # order G1, and operands are constrained on-curve)
        two_y = big.scale_ovf(ctx, oy1, 2)
        t = big.sub_ovf(ctx, big.mul_ovf(ctx, lam, two_y, bits),
                        big.scale_ovf(ctx, xx, 3))
        big.assert_zero_mod(ctx, t, p)
        lam2 = big.mul_ovf(ctx, lam, lam, bits)
        x3 = big.carry_mod_ovf(
            ctx, big.sub_ovf(ctx, big.sub_ovf(ctx, lam2, ox1), ox1), p)
        d13 = big.sub_ovf(ctx, ox1, big.to_overflow(x3, bits))
        y3 = big.carry_mod_ovf(
            ctx, big.sub_ovf(ctx, big.mul_ovf(ctx, lam, d13, bits), oy1), p)
        return (x3, y3)

    def select(self, ctx: Context, bit, a: tuple, b: tuple) -> tuple:
        """bit ? a : b on affine points."""
        return (self.fp.select(ctx, bit, a[0], b[0]),
                self.fp.select(ctx, bit, a[1], b[1]))
