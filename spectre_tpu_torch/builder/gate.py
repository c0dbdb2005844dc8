"""GateChip: arithmetic over the vertical gate q*(s0 + s1*s2 - s3) = 0 (the
port's copy of `spectre_tpu/builder/gate.py`).

halo2-base's `GateChip` (flex-gate instructions): add, mul, mul_add,
select, is_zero, inner products, bit decomposition. Every op appends one or
more 4-cell gate units; inputs are copy-constrained into the unit.
"""

from __future__ import annotations

from ..fields import bn254
from .context import AssignedValue, Context

R = bn254.R


def _v(x) -> int:
    return x.value if isinstance(x, AssignedValue) else int(x) % R


def _src(x, xv):
    """Copy source for an operand: the cell itself, or its value as a
    constant pin."""
    return x if x.__class__ is AssignedValue else xv


class GateChip:
    # -- basic ops ------------------------------------------------------
    def add(self, ctx: Context, a, b) -> AssignedValue:
        """out = a + b  via  [a, b, 1, out]."""
        av, bv = _v(a), _v(b)
        return ctx.gate_unit_out(av, bv, 1, (av + bv) % R,
                                 _src(a, av), _src(b, bv), 1, None, 3)

    def sub(self, ctx: Context, a, b) -> AssignedValue:
        """out = a - b  via  [out, b, 1, a]."""
        av, bv = _v(a), _v(b)
        return ctx.gate_unit_out((av - bv) % R, bv, 1, av,
                                 None, _src(b, bv), 1, _src(a, av), 0)

    def neg(self, ctx: Context, a) -> AssignedValue:
        return self.sub(ctx, 0, a)

    def mul(self, ctx: Context, a, b) -> AssignedValue:
        """out = a * b  via  [0, a, b, out]."""
        av, bv = _v(a), _v(b)
        return ctx.gate_unit_out(0, av, bv, av * bv % R,
                                 0, _src(a, av), _src(b, bv), None, 3)

    def mul_add(self, ctx: Context, a, b, c) -> AssignedValue:
        """out = a * b + c  via  [c, a, b, out]."""
        av, bv, cv = _v(a), _v(b), _v(c)
        return ctx.gate_unit_out(cv, av, bv, (cv + av * bv) % R,
                                 _src(c, cv), _src(a, av), _src(b, bv), None, 3)

    def div_unsafe(self, ctx: Context, a, b) -> AssignedValue:
        """out = a / b (b must be nonzero; only the product is constrained)."""
        av, bv = _v(a), _v(b)
        q = av * pow(bv, -1, R) % R
        return ctx.gate_unit_out(0, q, bv, av,
                                 0, None, _src(b, bv), _src(a, av), 1)

    # -- boolean -------------------------------------------------------
    def assert_bit(self, ctx: Context, a: AssignedValue):
        """a * a = a  via  [0, a, a, a]."""
        av = _v(a)
        ctx.gate_unit([0, av, av, av], [("const", 0), a, a, a])

    def and_(self, ctx: Context, a, b) -> AssignedValue:
        return self.mul(ctx, a, b)

    def not_(self, ctx: Context, a) -> AssignedValue:
        return self.sub(ctx, 1, a)

    def or_(self, ctx: Context, a, b) -> AssignedValue:
        # a + b - a*b
        ab = self.mul(ctx, a, b)
        s = self.add(ctx, a, b)
        return self.sub(ctx, s, ab)

    def select(self, ctx: Context, a, b, sel) -> AssignedValue:
        """sel ? a : b  =  b + sel*(a-b)."""
        d = self.sub(ctx, a, b)
        return self.mul_add(ctx, sel, d, b)

    def is_zero(self, ctx: Context, a) -> AssignedValue:
        """out = (a == 0), via out*a = 0 and out + a*inv = 1."""
        av = _v(a)
        out_v = 1 if av == 0 else 0
        inv_v = 0 if av == 0 else pow(av, -1, R)
        a_src = a if isinstance(a, AssignedValue) else ("const", av)
        # 0 + out*a = 0
        cells = ctx.gate_unit([0, out_v, av, 0],
                              [("const", 0), None, a_src, ("const", 0)])
        out = cells[1]
        # out + a*inv = 1
        ctx.gate_unit([out_v, av, inv_v, 1],
                      [out, a_src if not isinstance(a, AssignedValue) else a,
                       None, ("const", 1)])
        return out

    def is_equal(self, ctx: Context, a, b) -> AssignedValue:
        return self.is_zero(ctx, self.sub(ctx, a, b))

    # -- aggregates ----------------------------------------------------
    def sum_(self, ctx: Context, vals) -> AssignedValue:
        acc = None
        for v in vals:
            acc = v if acc is None else self.add(ctx, acc, v)
        return acc if acc is not None else ctx.load_zero()

    def inner_product(self, ctx: Context, a_vals, b_vals) -> AssignedValue:
        """sum a_i * b_i as a mul_add chain (bulk-appended: [c, a, b, out]
        units where c chains the previous out; first unit is a bare mul)."""
        if len(a_vals) != len(b_vals) or not a_vals:
            raise ValueError("inner product of equal, non-empty lengths")
        copies = ctx.copies
        pos = len(ctx.adv_values)
        flat = []
        acc = 0
        first = True
        for x, y in zip(a_vals, b_vals):
            if x.__class__ is AssignedValue:
                xv = x.value
                copies += (x.index << 3, (pos + 1) << 3)
            else:
                xv = int(x) % R
                ctx.pin_const(pos + 1, xv)
            if y.__class__ is AssignedValue:
                yv = y.value
                copies += (y.index << 3, (pos + 2) << 3)
            else:
                yv = int(y) % R
                ctx.pin_const(pos + 2, yv)
            if first:
                ctx.pin_const(pos, 0)
                first = False
            else:
                copies += ((pos - 1) << 3, pos << 3)
            out = (acc + xv * yv) % R
            flat.append(acc), flat.append(xv), flat.append(yv), flat.append(out)
            acc = out
            pos += 4
        ctx.bulk_gated(flat)
        return AssignedValue(pos - 1, acc)

    def inner_product_const(self, ctx: Context, vals, consts) -> AssignedValue:
        """sum vals_i * c_i with host constants c_i (bulk-appended chain)."""
        if len(vals) != len(consts) or not vals:
            raise ValueError("inner product of equal, non-empty lengths")
        copies = ctx.copies
        pos = len(ctx.adv_values)
        flat = []
        acc = 0
        first = True
        for x, cst in zip(vals, consts):
            c = int(cst) % R
            if x.__class__ is AssignedValue:
                xv = x.value
                copies += (x.index << 3, (pos + 1) << 3)
            else:
                xv = int(x) % R
                ctx.pin_const(pos + 1, xv)
            ctx.pin_const(pos + 2, c)
            if first:
                ctx.pin_const(pos, 0)
                first = False
            else:
                copies += ((pos - 1) << 3, pos << 3)
            out = (acc + xv * c) % R
            flat.append(acc), flat.append(xv), flat.append(c), flat.append(out)
            acc = out
            pos += 4
        ctx.bulk_gated(flat)
        return AssignedValue(pos - 1, acc)

    def add_pairs(self, ctx: Context, pairs) -> list:
        """Elementwise a+b over (a, b) pairs, bulk-appended [a, b, 1, out]
        units (identical constraints to add())."""
        copies = ctx.copies
        pin = ctx.pin_const
        pos = len(ctx.adv_values)
        flat = []
        outs = []
        for a, b in pairs:
            if a.__class__ is AssignedValue:
                av = a.value
                copies += (a.index << 3, pos << 3)
            else:
                av = int(a) % R
                pin(pos, av)
            if b.__class__ is AssignedValue:
                bv = b.value
                copies += (b.index << 3, (pos + 1) << 3)
            else:
                bv = int(b) % R
                pin(pos + 1, bv)
            pin(pos + 2, 1)
            out = (av + bv) % R
            flat.append(av), flat.append(bv), flat.append(1), flat.append(out)
            outs.append(AssignedValue(pos + 3, out))
            pos += 4
        ctx.bulk_gated(flat)
        return outs

    def sub_pairs(self, ctx: Context, pairs) -> list:
        """Elementwise a-b over (a, b) pairs, bulk-appended [out, b, 1, a]
        units (identical constraints to sub())."""
        copies = ctx.copies
        pin = ctx.pin_const
        pos = len(ctx.adv_values)
        flat = []
        outs = []
        for a, b in pairs:
            av = a.value if a.__class__ is AssignedValue else int(a) % R
            if b.__class__ is AssignedValue:
                bv = b.value
                copies += (b.index << 3, (pos + 1) << 3)
            else:
                bv = int(b) % R
                pin(pos + 1, bv)
            pin(pos + 2, 1)
            if a.__class__ is AssignedValue:
                copies += (a.index << 3, (pos + 3) << 3)
            else:
                pin(pos + 3, av)
            out = (av - bv) % R
            flat.append(out), flat.append(bv), flat.append(1), flat.append(av)
            outs.append(AssignedValue(pos, out))
            pos += 4
        ctx.bulk_gated(flat)
        return outs

    def num_to_bits(self, ctx: Context, a: AssignedValue, nbits: int) -> list:
        """Little-endian bit decomposition, each bit boolean-constrained and
        the recomposition equality-constrained to a."""
        av = _v(a)
        if av >= 1 << nbits:
            raise ValueError("value too large for bit width")
        bits = []
        for i in range(nbits):
            b = ctx.load_witness((av >> i) & 1)
            self.assert_bit(ctx, b)
            bits.append(b)
        acc = self.inner_product_const(ctx, bits, [1 << i for i in range(nbits)])
        ctx.constrain_equal(acc, a)
        return bits

    def bits_to_num(self, ctx: Context, bits) -> AssignedValue:
        return self.inner_product_const(ctx, bits, [1 << i for i in range(len(bits))])

    def pow_const(self, ctx: Context, a: AssignedValue, e: int) -> AssignedValue:
        result = None
        base = a
        while e:
            if e & 1:
                result = base if result is None else self.mul(ctx, result, base)
            e >>= 1
            if e:
                base = self.mul(ctx, base, base)
        return result if result is not None else ctx.load_constant(1)
