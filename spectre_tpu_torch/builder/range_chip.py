"""RangeChip: range checks via the lookup table, comparisons, div_mod (the
port's copy of `spectre_tpu/builder/range_chip.py`).

halo2-base's `RangeChip`: lookup_bits-limb decomposition into
lookup-enabled columns, `check_less_than`, `div_mod`.
"""

from __future__ import annotations

from ..fields import bn254
from .context import AssignedValue, Context
from .gate import GateChip

R = bn254.R


class RangeChip:
    def __init__(self, lookup_bits: int, gate: GateChip | None = None):
        self.lookup_bits = lookup_bits
        self.gate = gate or GateChip()

    def range_check(self, ctx: Context, a: AssignedValue, nbits: int):
        """Constrain 0 <= a < 2^nbits via lookup_bits-limb decomposition
        (bulk-appended: one splittable witness record + bulk lookup pushes)."""
        lb = self.lookup_bits
        av = a.value
        if av >= 1 << nbits:
            raise ValueError(f"range_check witness {av} >= 2^{nbits}")
        nlimbs = (nbits + lb - 1) // lb
        rem = nbits - (nlimbs - 1) * lb      # bits of the top limb
        mask = (1 << lb) - 1
        limb_vals = [(av >> (lb * i)) & mask for i in range(nlimbs)]
        start = ctx.bulk_cells(limb_vals)
        ctx.bulk_lookup("range",
                        [(start + i, v) for i, v in enumerate(limb_vals)])
        limbs = [AssignedValue(start + i, v)
                 for i, v in enumerate(limb_vals)]
        # top limb tighter bound: limb * 2^(lb-rem) must also be in table
        if rem < lb:
            shifted = self.gate.mul(ctx, limbs[-1], 1 << (lb - rem))
            ctx.push_lookup(shifted)
        acc = self.gate.inner_product_const(
            ctx, limbs, [1 << (lb * i) for i in range(nlimbs)])
        ctx.constrain_equal(acc, a)
        return limbs

    def check_less_than(self, ctx: Context, a: AssignedValue, b: AssignedValue,
                        nbits: int):
        """Constrain a < b, given both already known < 2^nbits."""
        # shifted = a - b + 2^nbits  in [0, 2^nbits)  iff  a < b
        t = self.gate.add(ctx, a, (1 << nbits) % R)
        shifted = self.gate.sub(ctx, t, b)
        self.range_check(ctx, shifted, nbits)

    def is_less_than(self, ctx: Context, a: AssignedValue, b: AssignedValue,
                     nbits: int) -> AssignedValue:
        """Return bit (a < b); both < 2^nbits. shifted = a - b + 2^nbits has
        bit nbits set iff a >= b."""
        t = self.gate.add(ctx, a, (1 << nbits) % R)
        shifted = self.gate.sub(ctx, t, b)
        sv = shifted.value
        hi = ctx.load_witness(sv >> nbits)      # 0 or 1
        self.gate.assert_bit(ctx, hi)
        lo = ctx.load_witness(sv & ((1 << nbits) - 1))
        self.range_check(ctx, lo, nbits)
        acc = self.gate.mul_add(ctx, hi, (1 << nbits) % R, lo)
        ctx.constrain_equal(acc, shifted)
        return self.gate.not_(ctx, hi)

    def div_mod(self, ctx: Context, a: AssignedValue, divisor: int,
                nbits: int):
        """(q, r) with a = q*divisor + r, 0 <= r < divisor, a < 2^nbits."""
        av = a.value
        q_v, r_v = divmod(av, divisor)
        q = ctx.load_witness(q_v)
        r = ctx.load_witness(r_v)
        acc = self.gate.mul_add(ctx, q, divisor % R, r)
        ctx.constrain_equal(acc, a)
        self.range_check(ctx, q, nbits)
        # r < divisor
        d_bits = max((divisor - 1).bit_length(), 1)
        self.range_check(ctx, r, d_bits)
        dc = ctx.load_constant(divisor)
        self.check_less_than(ctx, r, dc, d_bits + 1)
        return q, r
