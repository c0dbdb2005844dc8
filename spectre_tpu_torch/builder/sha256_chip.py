"""In-circuit SHA256 via packed nibble-op lookups (the port's copy of
`spectre_tpu/builder/sha256_chip.py`).

The flex-gate SHA256 chip lineage (`gadget/crypto/sha256_flex.rs`) on this
framework's single universal gate and multi-table lookup argument: every
4-bit XOR/AND is one membership proof of the packed value
(op<<12 | x<<8 | y<<4 | z) in the "nibble_op" table (~50k gate units a
block). The wide chip (sha256_wide_chip.py) subclasses it for its byte and
nibble range plumbing.

Words are (32-bit cell, 8 little-endian nibble cells); the nibble form is the
working representation, the cell form feeds arithmetic (mod-2^32 adds).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..fields import bn254
from ..ops.sha256 import H0, K
from .context import AssignedValue, Context
from .gate import GateChip

R = bn254.R

XOR_OP = 0
AND_OP = 1

_POW16 = [1 << (4 * i) for i in range(8)]


@dataclass
class Word:
    cell: AssignedValue
    nibs: list  # 8 nibble cells, little-endian

    @property
    def value(self) -> int:
        return self.cell.value


class Sha256Chip:
    """lookup_col: index of the lookup-advice column carrying 'nibble_op'."""

    def __init__(self, gate: GateChip | None = None):
        self.gate = gate or GateChip()

    # -- nibble plumbing ------------------------------------------------
    def _push_op(self, ctx: Context, op: int, x: AssignedValue, y: AssignedValue,
                 z_val: int) -> AssignedValue:
        """Witness z and prove (op, x, y, z) is a table row.

        SOUNDNESS INVARIANT: x and y must ALREADY be range-checked nibbles by
        the caller (decompositions check theirs; chained op outputs are checked
        here). z is range-checked before packing — without it (or with the old
        257*x "self-XOR" trick) the packed fields alias across bit boundaries
        and a malicious prover can forge bitwise results (found by review:
        packed 17 = 0x011 decodes as the valid XOR row 0^1=1)."""
        assert x.value < 16 and y.value < 16, "unchecked nibble into _push_op"
        z = ctx.load_witness(z_val)
        self._check_nibble(ctx, z)
        # packed = op*4096 + x*256 + y*16 + z — uniquely decodable since all
        # three fields are independently constrained to [0, 16)
        t1 = self.gate.mul_add(ctx, y, 16, z)
        packed = self.gate.mul_add(ctx, x, 256, t1)
        if op:
            packed = self.gate.add(ctx, packed, op << 12)
        ctx.push_lookup_table(packed, "nibble_op")
        return z

    def _check_nibble(self, ctx: Context, x: AssignedValue):
        """x in [0,16) via membership in the dedicated 16-row nibble table."""
        ctx.push_lookup_table(x, "nibble")

    def _decompose(self, ctx: Context, cell: AssignedValue) -> list:
        """cell (32-bit value) -> 8 checked nibbles, recomposition constrained
        (bulk-appended)."""
        v = cell.value
        assert v < (1 << 32)
        nib_vals = [(v >> (4 * i)) & 0xF for i in range(8)]
        start = ctx.bulk_cells(nib_vals)
        ctx.bulk_lookup("nibble",
                        [(start + i, nv) for i, nv in enumerate(nib_vals)])
        nibs = [AssignedValue(start + i, nv)
                for i, nv in enumerate(nib_vals)]
        acc = self.gate.inner_product_const(ctx, nibs, _POW16)
        ctx.constrain_equal(acc, cell)
        return nibs

    # -- word construction ---------------------------------------------
    def load_word(self, ctx: Context, v: int) -> Word:
        cell = ctx.load_witness(v & 0xFFFFFFFF)
        return Word(cell, self._decompose(ctx, cell))

    def constant_word(self, ctx: Context, v: int) -> Word:
        cell = ctx.load_constant(v & 0xFFFFFFFF)
        return Word(cell, self._decompose(ctx, cell))

    def word_from_cell(self, ctx: Context, cell: AssignedValue) -> Word:
        return Word(cell, self._decompose(ctx, cell))

    def word_from_bytes_be(self, ctx: Context, byte_cells: list) -> Word:
        """4 byte cells (big-endian, already range-checked to 8 bits) -> Word."""
        assert len(byte_cells) == 4
        cell = self.gate.inner_product_const(
            ctx, byte_cells, [1 << 24, 1 << 16, 1 << 8, 1])
        return self.word_from_cell(ctx, cell)

    def _recompose(self, ctx: Context, nibs: list) -> Word:
        cell = self.gate.inner_product_const(ctx, nibs, _POW16)
        return Word(cell, nibs)

    # -- bitwise ops ----------------------------------------------------
    def _nib_op(self, ctx: Context, op: int, a_nibs, b_nibs) -> list:
        """Bulk form of `_push_op` over a nibble vector: identical constraint
        structure (witness z, nibble-check z, pack (op,x,y,z), table lookup),
        appended through the bulk primitives. Inputs must already be checked
        nibbles (same soundness invariant as `_push_op`)."""
        if op == XOR_OP:
            z_vals = [x.value ^ y.value for x, y in zip(a_nibs, b_nibs)]
        else:
            z_vals = [x.value & y.value for x, y in zip(a_nibs, b_nibs)]
        zstart = ctx.bulk_cells(z_vals)
        ctx.bulk_lookup("nibble",
                        [(zstart + i, zv) for i, zv in enumerate(z_vals)])
        copies = ctx.copies
        pin = ctx.pin_const
        op_hi = op << 12
        flat = []
        lkp = []
        pos = len(ctx.adv_values)
        for i, (x, y) in enumerate(zip(a_nibs, b_nibs)):
            assert x.value < 16 and y.value < 16, "unchecked nibble into _nib_op"
            xv, yv, zv = x.value, y.value, z_vals[i]
            t1 = yv * 16 + zv
            # unit: t1 = y*16 + z  as  [z, y, 16, t1]
            copies += ((zstart + i) << 3, pos << 3, y.index << 3, (pos + 1) << 3)
            pin(pos + 2, 16)
            flat.append(zv), flat.append(yv), flat.append(16), flat.append(t1)
            packed = xv * 256 + t1
            # unit: packed = x*256 + t1  as  [t1, x, 256, packed]
            copies += ((pos + 3) << 3, (pos + 4) << 3, x.index << 3, (pos + 5) << 3)
            pin(pos + 6, 256)
            flat.append(t1), flat.append(xv), flat.append(256), flat.append(packed)
            pos += 8
            if op_hi:
                # unit: out = packed + op<<12  as  [packed, op<<12, 1, out]
                out = packed + op_hi
                copies += ((pos - 1) << 3, pos << 3)
                pin(pos + 1, op_hi)
                pin(pos + 2, 1)
                flat.append(packed), flat.append(op_hi), flat.append(1), \
                    flat.append(out)
                pos += 4
                lkp.append((pos - 1, out))
            else:
                lkp.append((pos - 1, packed))
        ctx.bulk_gated(flat)
        ctx.bulk_lookup("nibble_op", lkp)
        return [AssignedValue(zstart + i, zv)
                for i, zv in enumerate(z_vals)]

    def xor3(self, ctx: Context, a_nibs, b_nibs, c_nibs) -> list:
        return self._nib_op(ctx, XOR_OP, self._nib_op(ctx, XOR_OP, a_nibs, b_nibs), c_nibs)

    def ch(self, ctx: Context, e: Word, f: Word, g: Word) -> Word:
        """(e & f) ^ (~e & g), nibble-wise."""
        ef = self._nib_op(ctx, AND_OP, e.nibs, f.nibs)
        ne = [self.gate.sub(ctx, 15, x) for x in e.nibs]
        neg = self._nib_op(ctx, AND_OP, ne, g.nibs)
        return self._recompose(ctx, self._nib_op(ctx, XOR_OP, ef, neg))

    def maj(self, ctx: Context, a: Word, b: Word, c: Word) -> Word:
        """maj = (a + b + c - xor3(a,b,c)) / 2 — word-level identity (each bit
        position: sum of 3 bits = maj*2 + xor)."""
        x = self._recompose(ctx, self.xor3(ctx, a.nibs, b.nibs, c.nibs))
        s = self.gate.add(ctx, self.gate.add(ctx, a.cell, b.cell), c.cell)
        d = self.gate.sub(ctx, s, x.cell)
        mv = (a.value + b.value + c.value - x.value) // 2
        m = ctx.load_witness(mv)
        two_m = self.gate.mul(ctx, m, 2)
        ctx.constrain_equal(two_m, d)
        # m < 2^32 is implied bit-wise, but constrain anyway (cheap, safe):
        return self.word_from_cell(ctx, m)

    # -- rotations / shifts --------------------------------------------
    def _split(self, ctx: Context, w: Word, s: int):
        """w = hi * 2^s + lo with lo < 2^s, hi < 2^(32-s); returns (lo, hi)
        as cells with tight range checks via nibble lookups."""
        v = w.value
        lo_v, hi_v = v & ((1 << s) - 1), v >> s
        lo = ctx.load_witness(lo_v)
        hi = ctx.load_witness(hi_v)
        acc = self.gate.mul_add(ctx, hi, 1 << s, lo)
        ctx.constrain_equal(acc, w.cell)
        self._range_bits(ctx, lo, s)
        self._range_bits(ctx, hi, 32 - s)
        return lo, hi

    def _range_bits(self, ctx: Context, cell: AssignedValue, bits: int):
        """cell < 2^bits via nibble decomposition (+ shifted top nibble),
        bulk-appended."""
        v = cell.value
        assert v < (1 << bits)
        nn = (bits + 3) // 4
        nib_vals = [(v >> (4 * i)) & 0xF for i in range(nn)]
        start = ctx.bulk_cells(nib_vals)
        ctx.bulk_lookup("nibble",
                        [(start + i, nv) for i, nv in enumerate(nib_vals)])
        nibs = [AssignedValue(start + i, nv)
                for i, nv in enumerate(nib_vals)]
        rem = bits - 4 * (nn - 1)
        if rem < 4:
            shifted = self.gate.mul(ctx, nibs[-1], 1 << (4 - rem))
            self._check_nibble(ctx, shifted)
        acc = self.gate.inner_product_const(ctx, nibs, _POW16[:nn])
        ctx.constrain_equal(acc, cell)

    def rotr(self, ctx: Context, w: Word, r: int) -> Word:
        lo, hi = self._split(ctx, w, r)
        cell = self.gate.mul_add(ctx, lo, 1 << (32 - r), hi)
        return self.word_from_cell(ctx, cell)

    def shr(self, ctx: Context, w: Word, s: int) -> Word:
        _lo, hi = self._split(ctx, w, s)
        return self.word_from_cell(ctx, hi)

    # -- modular addition ----------------------------------------------
    def mod_add(self, ctx: Context, items: list) -> Word:
        """(sum of 32-bit words/cells/consts) mod 2^32."""
        total = 0
        acc = None
        for it in items:
            if isinstance(it, Word):
                total += it.value
                acc = it.cell if acc is None else self.gate.add(ctx, acc, it.cell)
            elif isinstance(it, AssignedValue):
                total += it.value
                acc = it if acc is None else self.gate.add(ctx, acc, it)
            else:
                total += int(it)
                acc = ctx.load_constant(int(it)) if acc is None else \
                    self.gate.add(ctx, acc, int(it))
        out_v = total & 0xFFFFFFFF
        carry_v = total >> 32
        assert carry_v < 16
        out = ctx.load_witness(out_v)
        carry = ctx.load_witness(carry_v)
        self._check_nibble(ctx, carry)
        recomb = self.gate.mul_add(ctx, carry, 1 << 32, out)
        ctx.constrain_equal(recomb, acc)
        return self.word_from_cell(ctx, out)

    # -- compression ----------------------------------------------------
    def compress(self, ctx: Context, state: list, block: list) -> list:
        """state: 8 Words; block: 16 Words -> 8 Words."""
        a, b, c, d, e, f, g, h = state
        w = list(block)
        for t in range(64):
            if t >= 16:
                s0w = w[t - 15]
                sig0 = self._recompose(ctx, self.xor3(
                    ctx, self.rotr(ctx, s0w, 7).nibs, self.rotr(ctx, s0w, 18).nibs,
                    self.shr(ctx, s0w, 3).nibs))
                s1w = w[t - 2]
                sig1 = self._recompose(ctx, self.xor3(
                    ctx, self.rotr(ctx, s1w, 17).nibs, self.rotr(ctx, s1w, 19).nibs,
                    self.shr(ctx, s1w, 10).nibs))
                w.append(self.mod_add(ctx, [sig1, w[t - 7], sig0, w[t - 16]]))
            s1 = self._recompose(ctx, self.xor3(
                ctx, self.rotr(ctx, e, 6).nibs, self.rotr(ctx, e, 11).nibs,
                self.rotr(ctx, e, 25).nibs))
            chv = self.ch(ctx, e, f, g)
            t1 = self.mod_add(ctx, [h, s1, chv, int(K[t]), w[t]])
            s0 = self._recompose(ctx, self.xor3(
                ctx, self.rotr(ctx, a, 2).nibs, self.rotr(ctx, a, 13).nibs,
                self.rotr(ctx, a, 22).nibs))
            majv = self.maj(ctx, a, b, c)
            t2 = self.mod_add(ctx, [s0, majv])
            h, g, f = g, f, e
            e = self.mod_add(ctx, [d, t1])
            d, c, b = c, b, a
            a = self.mod_add(ctx, [t1, t2])
        return [self.mod_add(ctx, [x, y]) for x, y in zip(state, [a, b, c, d, e, f, g, h])]

    def initial_state(self, ctx: Context) -> list:
        return [self.constant_word(ctx, int(v)) for v in H0]

    def digest_two_to_one(self, ctx: Context, left: list, right: list) -> list:
        """SSZ merkle node: sha256(left32 || right32); inputs/outputs are
        8-Word lists. One data block + the constant 512-bit-length pad block."""
        state = self.compress(ctx, self.initial_state(ctx), left + right)
        pad = [self.constant_word(ctx, 0x80000000)] + \
              [self.constant_word(ctx, 0)] * 14 + \
              [self.constant_word(ctx, 512)]
        return self.compress(ctx, state, pad)

    def digest_bytes(self, ctx: Context, byte_cells: list) -> list:
        """Full SHA256 of a byte-cell message (bytes already 8-bit checked).
        Padding is fixed at trace time by the message length."""
        msg_len = len(byte_cells)
        padded = list(byte_cells)
        padded.append(ctx.load_constant(0x80))
        while (len(padded) % 64) != 56:
            padded.append(ctx.load_constant(0))
        for byte in (8 * msg_len).to_bytes(8, "big"):
            padded.append(ctx.load_constant(byte))
        state = self.initial_state(ctx)
        for off in range(0, len(padded), 64):
            block = [self.word_from_bytes_be(ctx, padded[off + 4 * i:off + 4 * i + 4])
                     for i in range(16)]
            state = self.compress(ctx, state, block)
        return state
