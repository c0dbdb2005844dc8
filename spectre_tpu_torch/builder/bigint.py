"""CRT big-integer arithmetic over the gate/range chips (the port's copy of
`spectre_tpu/builder/bigint.py`).

halo2-ecc's `ProperCrtUint` machinery:
non-native field elements as NUM_LIMBS x LIMB_BITS limb cells plus a native
(mod r) accumulator, with the classic CRT reduction: an identity is enforced
mod r (one native inner product) AND over the limb radix (carry chain with
signed range-checked carries), which together pin it over the integers.

On this framework: one universal vertical gate, range checks via the
lookup table, carries witnessed with an offset to keep them unsigned.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..fields import bn254
from ..spec import LIMB_BITS, NUM_LIMBS
from .context import AssignedValue, Context
from .range_chip import RangeChip

R = bn254.R
BASE = 1 << LIMB_BITS


@dataclass
class CrtUint:
    """limbs: NUM_LIMBS cells (< 2^LIMB_BITS each); native: value mod r;
    value: the integer (witness bookkeeping)."""

    limbs: list
    native: AssignedValue
    value: int


@dataclass
class OverflowInt:
    """Lazily-reduced big integer: limb cells whose SIGNED values may exceed
    LIMB_BITS (products, sums, differences accumulated without carrying).
    halo2-ecc's CRTInteger-with-overflow role: the pairing tower does many
    no-carry ops per single carry_mod, which is where non-native field
    arithmetic gets its constraint budget back.

    value: exact signed integer; limb_abs: bound on each |limb| (signed
    interpretation); val_abs: bound on |value| (sizes the reduction
    quotient)."""

    limbs: list
    value: int
    limb_abs: int
    val_abs: int


class BigUintChip:
    """num_limbs x limb_bits CRT bigint chip. Defaults match the reference's
    BLS12-381-over-BN254 shape (5 x 104, `eth-types/src/lib.rs:12-16`); the
    aggregation layer instantiates 3 x 88 for BN254 Fq (the reference
    accumulator's limb encoding, snark-verifier `LimbsEncoding<3, 88>`)."""

    def __init__(self, rng: RangeChip, num_limbs: int = NUM_LIMBS,
                 limb_bits: int = LIMB_BITS):
        self.rng = rng
        self.gate = rng.gate
        self.num_limbs = num_limbs
        self.limb_bits = limb_bits
        self.base = 1 << limb_bits
        self._pow_native = [pow(self.base, i, R) for i in range(2 * num_limbs + 2)]

    # -- construction ---------------------------------------------------
    def load(self, ctx: Context, value: int, max_bits: int | None = None) -> CrtUint:
        value = int(value)
        if value < 0:
            raise ValueError("a bigint is non-negative")
        max_bits = max_bits or self.num_limbs * self.limb_bits
        if max_bits > self.num_limbs * self.limb_bits:
            raise ValueError("value exceeds limb capacity — pick a wider num_limbs/limb_bits")
        if value >= 1 << max_bits:
            raise ValueError(f"value exceeds {max_bits} bits")
        limb_vals = [(value >> (self.limb_bits * i)) & (self.base - 1)
                     for i in range(self.num_limbs)]
        start = ctx.bulk_cells(limb_vals)
        limbs = [AssignedValue(start + i, v)
                 for i, v in enumerate(limb_vals)]
        for i, limb in enumerate(limbs):
            bits = min(self.limb_bits, max(max_bits - self.limb_bits * i, 0))
            if bits == 0:
                ctx.constrain_constant(limb, 0)
            else:
                self.rng.range_check(ctx, limb, bits)
        native = self.gate.inner_product_const(
            ctx, limbs, self._pow_native[:self.num_limbs])
        return CrtUint(limbs, native, value)

    def load_constant(self, ctx: Context, value: int) -> CrtUint:
        if not (0 <= value < 1 << self.num_limbs * self.limb_bits):
            raise ValueError("constant exceeds limb capacity — pick a wider num_limbs/limb_bits")
        limbs = [ctx.load_constant((value >> (self.limb_bits * i)) & (self.base - 1))
                 for i in range(self.num_limbs)]
        native = self.gate.inner_product_const(
            ctx, limbs, self._pow_native[:self.num_limbs])
        return CrtUint(limbs, native, int(value))

    # -- arithmetic (lazy: no reduction) --------------------------------
    def add_no_carry(self, ctx: Context, a: CrtUint, b: CrtUint) -> CrtUint:
        limbs = [self.gate.add(ctx, x, y) for x, y in zip(a.limbs, b.limbs)]
        native = self.gate.add(ctx, a.native, b.native)
        return CrtUint(limbs, native, a.value + b.value)

    def mul_no_carry(self, ctx: Context, a: CrtUint, b: CrtUint) -> list:
        """Limb convolution: returns 2*num_limbs-1 product-limb cells (each up
        to ~2^(2*limb_bits + log num_limbs) — still < r)."""
        NUM_LIMBS = self.num_limbs
        out = []
        for k in range(2 * NUM_LIMBS - 1):
            terms_a, terms_b = [], []
            for i in range(max(0, k - NUM_LIMBS + 1), min(NUM_LIMBS, k + 1)):
                terms_a.append(a.limbs[i])
                terms_b.append(b.limbs[k - i])
            out.append(self.gate.inner_product(ctx, terms_a, terms_b))
        return out

    # -- lazy (no-carry) arithmetic on OverflowInt ----------------------
    def to_overflow(self, a, val_bits: int | None = None) -> OverflowInt:
        if isinstance(a, OverflowInt):
            return a
        val_bits = val_bits or self.num_limbs * self.limb_bits
        return OverflowInt(list(a.limbs), a.value, self.base - 1, 1 << val_bits)

    def mul_ovf(self, ctx: Context, a, b,
                val_bits: int | None = None) -> OverflowInt:
        """Product as overflowed limbs (no reduction). a, b: CrtUint or
        OverflowInt. val_bits bounds each CrtUint operand's |value| — pass
        the tight field bound (e.g. 381 for reduced Fq elements): the
        reduction quotient is sized from it, and the 5-limb quotient caps
        honest accumulations at |value| < ~2^515."""
        val_bits = val_bits or self.num_limbs * self.limb_bits
        xa, xb = self.to_overflow(a, val_bits), self.to_overflow(b, val_bits)
        la, lb = len(xa.limbs), len(xb.limbs)
        out = []
        for k in range(la + lb - 1):
            terms_a, terms_b = [], []
            for i in range(max(0, k - lb + 1), min(la, k + 1)):
                terms_a.append(xa.limbs[i])
                terms_b.append(xb.limbs[k - i])
            out.append(self.gate.inner_product(ctx, terms_a, terms_b))
        return OverflowInt(out, xa.value * xb.value,
                           min(la, lb) * xa.limb_abs * xb.limb_abs,
                           xa.val_abs * xb.val_abs)

    def mul_ovf_const(self, ctx: Context, a, k: int,
                      val_bits: int | None = None) -> OverflowInt:
        """Product with a non-negative host constant, as a constant-limb
        convolution (inner_product_const — no witness cells for k)."""
        if k < 0:
            raise ValueError("a non-negative constant")
        BASE, LIMB_BITS = self.base, self.limb_bits
        val_bits = val_bits or self.num_limbs * self.limb_bits
        xa = self.to_overflow(a, val_bits)
        if k == 0:
            zero = ctx.load_constant(0)
            return OverflowInt([zero], 0, 0, 1)
        k_limbs = []
        rem = k
        while rem:
            k_limbs.append(rem & (BASE - 1))
            rem >>= LIMB_BITS
        la, lb = len(xa.limbs), len(k_limbs)
        out = []
        for kk in range(la + lb - 1):
            terms, consts = [], []
            for i in range(max(0, kk - lb + 1), min(la, kk + 1)):
                terms.append(xa.limbs[i])
                consts.append(k_limbs[kk - i])
            out.append(self.gate.inner_product_const(ctx, terms, consts))
        return OverflowInt(out, xa.value * k,
                           min(la, lb) * xa.limb_abs * (BASE - 1),
                           xa.val_abs * k)

    def const_ovf(self, ctx: Context, k: int) -> OverflowInt:
        """A small non-negative host constant as a single-limb OverflowInt
        (centralizes the limb_abs/val_abs bounds)."""
        if not (0 <= k < self.base):
            raise ValueError("a constant below the limb base")
        return OverflowInt([ctx.load_constant(k)], k, k, k + 1)

    def add_ovf(self, ctx: Context, x: OverflowInt, y: OverflowInt) -> OverflowInt:
        gate = self.gate
        nc = min(len(x.limbs), len(y.limbs))
        added = gate.add_pairs(ctx, zip(x.limbs[:nc], y.limbs[:nc]))
        limbs = added + x.limbs[nc:] + y.limbs[nc:]
        return OverflowInt(limbs, x.value + y.value,
                           x.limb_abs + y.limb_abs, x.val_abs + y.val_abs)

    def sub_ovf(self, ctx: Context, x: OverflowInt, y: OverflowInt) -> OverflowInt:
        gate = self.gate
        nc = min(len(x.limbs), len(y.limbs))
        subbed = gate.sub_pairs(ctx, zip(x.limbs[:nc], y.limbs[:nc]))
        tail = (x.limbs[nc:] if len(x.limbs) >= len(y.limbs)
                else gate.sub_pairs(ctx, ((0, l) for l in y.limbs[nc:])))
        return OverflowInt(subbed + tail, x.value - y.value,
                           x.limb_abs + y.limb_abs, x.val_abs + y.val_abs)

    def scale_ovf(self, ctx: Context, x: OverflowInt, c: int) -> OverflowInt:
        """Multiply by a small non-negative host constant."""
        if c < 0:
            raise ValueError("a non-negative scale")
        gate = self.gate
        limbs = [gate.mul(ctx, l, c) for l in x.limbs]
        return OverflowInt(limbs, x.value * c, x.limb_abs * c, x.val_abs * c)

    def carry_mod_ovf(self, ctx: Context, x: OverflowInt, p: int) -> CrtUint:
        """Reduce an OverflowInt to a canonical-width CrtUint mod p. Handles
        negative values by first adding a constant multiple of p (limb-wise
        constant adds), then runs the usual CRT carry chain with carry widths
        sized from the tracked limb bound."""
        return self._reduce_ovf(ctx, x, p, with_remainder=True)

    def assert_zero_mod(self, ctx: Context, x: OverflowInt, p: int):
        """Constrain x ≡ 0 (mod p) for a (possibly negative) OverflowInt with
        a quotient-only identity (x + k·p = q·p) — no remainder witness, no
        remainder range checks. The lazy-EC workhorse (λ·dx - dy ≡ 0, etc.)."""
        if x.value % p != 0:
            raise ValueError("assert_zero_mod: witness not divisible")
        self._reduce_ovf(ctx, x, p, with_remainder=False)

    def _reduce_ovf(self, ctx: Context, x: OverflowInt, p: int,
                    with_remainder: bool):
        gate = self.gate
        NUM_LIMBS, LIMB_BITS, BASE = self.num_limbs, self.limb_bits, self.base
        limbs, value = list(x.limbs), x.value
        limb_abs = x.limb_abs
        if abs(value) > x.val_abs:
            raise ValueError("OverflowInt value bound violated")
        # shift by k*p >= val_abs so the quotient is non-negative for any
        # honest value (constant limb adds; constraints unchanged in kind)
        k = (x.val_abs + p - 1) // p
        shift = k * p
        s_limbs = []
        rem = shift
        nl = max(len(limbs), NUM_LIMBS)
        for i in range(nl - 1):
            s_limbs.append(rem & (BASE - 1))
            rem >>= LIMB_BITS
        s_limbs.append(rem)   # top limb takes the remainder (constant)
        while len(limbs) < len(s_limbs):
            limbs.append(ctx.load_constant(0))
        for i, sv in enumerate(s_limbs):
            if sv:
                limbs[i] = gate.add(ctx, limbs[i], sv % R)
        value = value + shift
        limb_abs = limb_abs + max(s_limbs)
        if value < 0:
            raise ValueError("shifted value is negative")
        q_val, r_val = divmod(value, p)
        # q <= (val_abs + shift)/p < 2*val_abs/p + 1
        q_bits = max((x.val_abs * 2).bit_length() - p.bit_length() + 1, 8)
        if q_bits > NUM_LIMBS * LIMB_BITS:
            raise ValueError("OverflowInt accumulation too large for the "
                             "limb-width quotient — reduce earlier or "
                             "tighten val_bits")
        if q_val >= 1 << q_bits:
            raise ValueError("quotient exceeds its width")
        q = self.load(ctx, q_val, max_bits=q_bits)
        r = (self.load(ctx, r_val, max_bits=p.bit_length())
             if with_remainder else None)
        if not (with_remainder or r_val == 0):
            raise ValueError("value not divisible")

        ntot = max(len(limbs), 2 * NUM_LIMBS - 1)
        qp_limbs = self._qp_identity(ctx, q, p)
        zero = None
        while len(limbs) < ntot:
            zero = zero or ctx.load_constant(0)
            limbs.append(zero)
        while len(qp_limbs) < ntot:
            zero = zero or ctx.load_constant(0)
            qp_limbs.append(zero)
        self._native_zero(ctx, limbs, qp_limbs, r)

        if len(limbs) > 2 * NUM_LIMBS - 1:
            raise ValueError("too many overflow limbs")
        # limb-radix identity with carry widths sized from the limb bound
        qp_abs = NUM_LIMBS * (BASE - 1) ** 2
        max_t = limb_abs + qp_abs + BASE
        carry_bits = max(max_t.bit_length() - LIMB_BITS + 1, 2)
        # no mod-R wraparound in the chain: t + carry + offset*BASE must
        # stay far below R
        if carry_bits + 2 + LIMB_BITS >= 250:
            raise ValueError("overflow limbs too wide")
        t_vals = [_signed(_val_of(limbs[k])) - _signed(_val_of(qp_limbs[k]))
                  for k in range(ntot)]
        t_cells = gate.sub_pairs(ctx, zip(limbs, qp_limbs))
        if r is not None:
            for k in range(NUM_LIMBS):
                t_vals[k] -= r.limbs[k].value
            t_cells[:NUM_LIMBS] = gate.sub_pairs(
                ctx, zip(t_cells[:NUM_LIMBS], r.limbs))
        self._carry_chain_zero(ctx, t_cells, t_vals, carry_bits=carry_bits)
        return r

    # -- the CRT reduction ---------------------------------------------
    def carry_mod(self, ctx: Context, prod_limbs: list, prod_value: int,
                  p: int) -> CrtUint:
        """Given overflowed limbs representing X (an integer < ~L*2^(2*104+3)),
        witness q, r with X = q*p + r, 0 <= r < p; constrain the identity
        (a) mod r via natives and (b) over the limb radix via a carry chain
        with range-checked carries. Returns r as a CrtUint."""
        gate = self.gate
        NUM_LIMBS = self.num_limbs
        q_val, r_val = divmod(prod_value, p)
        q = self.load(ctx, q_val, max_bits=p.bit_length() + 8)
        r = self.load(ctx, r_val, max_bits=p.bit_length())

        # (a) q*p convolution + native identity: X - q*p - r == 0 (mod r)
        qp_limbs = self._qp_identity(ctx, q, p)
        self._native_zero(ctx, prod_limbs, qp_limbs, r)

        # (b) limb-radix identity via carries:
        #     t_k = X_k - (qp)_k - r_k ;  t_k + c_{k-1} = c_k * 2^LIMB_BITS
        # carries are signed; witness c_k + OFFSET to range-check unsigned.
        nlimbs_tot = 2 * NUM_LIMBS - 1
        t_vals = [_signed(_val_of(prod_limbs[k])) - _signed(_val_of(qp_limbs[k]))
                  - (r.limbs[k].value if k < NUM_LIMBS else 0)
                  for k in range(nlimbs_tot)]
        t_cells = gate.sub_pairs(ctx, zip(prod_limbs, qp_limbs))
        t_cells[:NUM_LIMBS] = gate.sub_pairs(
            ctx, zip(t_cells[:NUM_LIMBS], r.limbs))
        self._carry_chain_zero(ctx, t_cells, t_vals)
        return r

    def _qp_identity(self, ctx: Context, q: CrtUint, p: int):
        """The q*p constant-limb convolution (shared by every reduction)."""
        gate = self.gate
        NUM_LIMBS, LIMB_BITS, BASE = self.num_limbs, self.limb_bits, self.base
        p_limbs = [(p >> (LIMB_BITS * i)) & (BASE - 1) for i in range(NUM_LIMBS)]
        qp_limbs = []
        for k in range(2 * NUM_LIMBS - 1):
            terms, consts = [], []
            for i in range(max(0, k - NUM_LIMBS + 1), min(NUM_LIMBS, k + 1)):
                terms.append(q.limbs[i])
                consts.append(p_limbs[k - i])
            qp_limbs.append(gate.inner_product_const(ctx, terms, consts))
        return qp_limbs

    def _native_zero(self, ctx: Context, x_limbs: list, qp_limbs: list,
                     r: CrtUint | None):
        """Constrain sum(x)*B^k - sum(qp)*B^k - r == 0 (mod native r)."""
        gate = self.gate
        x_native = gate.inner_product_const(
            ctx, x_limbs, self._pow_native[:len(x_limbs)])
        qp_native = gate.inner_product_const(
            ctx, qp_limbs, self._pow_native[:len(qp_limbs)])
        lhs = gate.sub(ctx, x_native, qp_native)
        if r is not None:
            lhs = gate.sub(ctx, lhs, r.native)
        ctx.constrain_constant(lhs, 0)

    def _carry_chain_zero(self, ctx: Context, t_cells: list, t_vals: list,
                          carry_bits: int | None = None):
        """Constrain sum_k t_k * BASE^k == 0 over the integers, given limb
        cells t_k with |t_k| < ~2^(LIMB_BITS + carry_bits). Carries are signed;
        each is witnessed as c_k = carry_k + offset so a single unsigned range
        check bounds it, and each chain link is ONE fused gate unit:
          k=0:  t_0 + offset*BASE - c_0*BASE == 0
          k>0:  (t_k + c_{k-1}) + (offset*BASE - offset) - c_k*BASE == 0
        (the k>0 sum takes one extra add unit), with the final carry pinned
        via c_last == offset."""
        BASE = self.base
        if carry_bits is None:
            carry_bits = self.limb_bits + self.num_limbs.bit_length() + 2
        offset = 1 << (carry_bits + 1)
        # witness all carry cells upfront (one splittable record)
        c_vals = []
        carry_prev_val = 0
        for tv in t_vals:
            total = tv + carry_prev_val
            if total % BASE != 0:
                raise ValueError("carry chain misaligned")
            c_val = total // BASE
            if abs(c_val) >= offset:
                raise ValueError("carry exceeds its offset")
            c_vals.append(c_val + offset)
            carry_prev_val = c_val
        cstart = ctx.bulk_cells(c_vals)
        c_cells = [AssignedValue(cstart + i, v)
                   for i, v in enumerate(c_vals)]
        for c in c_cells:
            self.rng.range_check(ctx, c, carry_bits + 2)
        # fused chain links
        copies = ctx.copies
        pin = ctx.pin_const
        pos = len(ctx.adv_values)
        flat = []
        neg_base = (-BASE) % R
        k0_const = (offset * BASE) % R
        kk_const = (offset * BASE - offset) % R
        neg_kk = (offset - offset * BASE) % R
        for k, (t, cv) in enumerate(zip(t_cells, c_vals)):
            if k == 0:
                # [t_0, c_0, -BASE, -(offset*BASE)]: t0 + c0*(-BASE) + oB == 0
                copies += ((t.index) << 3, (pos) << 3)
                copies += ((cstart) << 3, (pos + 1) << 3)
                pin(pos + 2, neg_base)
                pin(pos + 3, (-k0_const) % R)
                flat.append(t.value), flat.append(cv), flat.append(neg_base), \
                    flat.append((-k0_const) % R)
                pos += 4
            else:
                # s = t_k + c_{k-1}
                sv = (t.value + c_vals[k - 1]) % R
                copies += ((t.index) << 3, (pos) << 3)
                copies += ((cstart + k - 1) << 3, (pos + 1) << 3)
                pin(pos + 2, 1)
                flat.append(t.value), flat.append(c_vals[k - 1]), \
                    flat.append(1), flat.append(sv)
                # [s, c_k, -BASE, -(oB - offset)]: s + kk_const - c_k*BASE == 0
                copies += ((pos + 3) << 3, (pos + 4) << 3)
                copies += ((cstart + k) << 3, (pos + 5) << 3)
                pin(pos + 6, neg_base)
                pin(pos + 7, neg_kk)
                flat.append(sv), flat.append(cv), flat.append(neg_base), \
                    flat.append(neg_kk)
                pos += 8
        ctx.bulk_gated(flat)
        # final carry must be zero: c_last == offset
        ctx.constrain_constant(c_cells[-1], offset % R)

    def check_carry_to_zero(self, ctx: Context, prod_limbs: list,
                            prod_value: int, p: int):
        """Constrain X == 0 (mod p) for overflowed limbs X: witness q with
        X = q*p exactly, constrain natively and over the limb radix. The
        mod-p analog of halo2-ecc `check_carry_mod_to_zero`."""
        gate = self.gate
        if prod_value % p != 0:
            raise ValueError("check_carry_to_zero: value not divisible")
        q_val = prod_value // p
        # same static shape as carry_mod's quotient (shape must not depend on
        # the witness): products of reduced operands give q < ~L * 2^(2*104) / p
        q = self.load(ctx, q_val, max_bits=p.bit_length() + 8)
        qp_limbs = self._qp_identity(ctx, q, p)
        self._native_zero(ctx, prod_limbs, qp_limbs, None)
        t_vals = [_signed(_val_of(prod_limbs[k])) - _signed(_val_of(qp_limbs[k]))
                  for k in range(2 * self.num_limbs - 1)]
        t_cells = gate.sub_pairs(ctx, zip(prod_limbs, qp_limbs))
        self._carry_chain_zero(ctx, t_cells, t_vals)

    def enforce_lt(self, ctx: Context, a: CrtUint, bound: int):
        """Constrain a < bound (a compile-time constant) exactly, not just by
        limb width: witness d = bound-1-a, range-check d's limbs, and tie
        a + d == bound-1 over the limb radix (halo2-ecc ProperCrtUint's
        canonicality check)."""
        gate = self.gate
        NUM_LIMBS, LIMB_BITS, BASE = self.num_limbs, self.limb_bits, self.base
        m = bound - 1
        if not (0 <= a.value <= m):
            raise ValueError("enforce_lt: witness out of range")
        d = self.load(ctx, m - a.value, max_bits=bound.bit_length())
        m_limbs = [(m >> (LIMB_BITS * i)) & (BASE - 1) for i in range(NUM_LIMBS)]
        t_cells, t_vals = [], []
        for k in range(NUM_LIMBS):
            t = gate.add(ctx, a.limbs[k], d.limbs[k])
            t_cells.append(gate.sub(ctx, t, m_limbs[k]))
            t_vals.append(a.limbs[k].value + d.limbs[k].value - m_limbs[k])
        # sums of two limbs minus a limb: carries fit in 2 bits
        self._carry_chain_zero(ctx, t_cells, t_vals, carry_bits=2)


def _val_of(cell) -> int:
    return cell.value


def _signed(v: int) -> int:
    """Interpret a mod-r value produced by gate.sub as a (small) signed int."""
    return v if v < R // 2 else v - R
