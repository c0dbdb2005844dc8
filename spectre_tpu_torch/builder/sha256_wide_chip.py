"""Wide SHA-256 chip: hashing in the dedicated bit-ladder region (the port's
copy of `spectre_tpu/builder/sha256_wide_chip.py`).

`gadget/crypto/sha256_wide.rs:25-129` wraps the zkevm "vanilla" SHA circuit
(few rows, many columns, no lookups) for the hash-heavy committee-update
circuit; this is the same trade on this framework's expression machinery
(plonk/constraint_system.py, expressions.sha_expressions): each 64-byte
block occupies one 72-row slot of 104 bit columns and 10 word columns
(with the pinned act flag); the region's identities enforce the rounds, and
only word cells cross into the main region through copy constraints
(~200 main-region cells a block).

A slot's witness is a u32 round trace on the host, unpacked into its bit
ladders with numpy in bulk. Interface-compatible with Sha256Chip for the
gadget layer (digest_bytes, digest_two_to_one, constant_word,
word_from_bytes_be, _range_bits), which it subclasses for the byte and
nibble range plumbing.
"""

from __future__ import annotations

import numpy as np

from ..ops.sha256 import H0, K
from ..plonk.constraint_system import (SHA_A, SHA_ACT_WORD, SHA_CARRY, SHA_E,
                                       SHA_OUT_ROW, SHA_SEED_ROW,
                                       SHA_SLOT_ROWS, SHA_W)
from .context import AssignedValue, Context, shw_ref
from .sha256_chip import Sha256Chip

M32 = 0xFFFFFFFF
_SHIFTS = np.arange(32, dtype=np.uint64)


def _rotr(v, r):
    return ((v >> r) | (v << (32 - r))) & M32


def _bits(words) -> np.ndarray:
    """[m] 32-bit words -> [m, 32] uint32 bits, least significant first."""
    return ((np.asarray(words, dtype=np.uint64)[:, None] >> _SHIFTS) & 1).astype(np.uint32)


class WideWord:
    """A 32-bit word as one main-region cell (the region's bit ladder
    carries its bits)."""

    __slots__ = ("cell",)

    def __init__(self, cell: AssignedValue):
        self.cell = cell

    @property
    def value(self) -> int:
        return self.cell.value


class Sha256WideChip(Sha256Chip):
    def constant_word(self, ctx: Context, v: int) -> WideWord:
        return WideWord(ctx.load_constant(v & M32))

    def word_from_bytes_be(self, ctx: Context, byte_cells: list) -> WideWord:
        """4 byte cells (already 8-bit checked) -> word cell; the region's
        input identity binds its bits."""
        if len(byte_cells) != 4:
            raise ValueError("a word is 4 bytes")
        cell = self.gate.inner_product_const(
            ctx, byte_cells, [1 << 24, 1 << 16, 1 << 8, 1])
        return WideWord(cell)

    # -- region plumbing -------------------------------------------------

    @staticmethod
    def _trace_block(state: list, words: list):
        """u32 round trace: (rows, h_out, out_carries) with rows[t] =
        (w_t, a_t, e_t, ce, ca, cs)."""
        a, b, c, d, e, f, g, h = state
        w = list(words)
        rows = []
        for t in range(64):
            cs = 0
            if t >= 16:
                s0 = _rotr(w[t - 15], 7) ^ _rotr(w[t - 15], 18) ^ (w[t - 15] >> 3)
                s1 = _rotr(w[t - 2], 17) ^ _rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
                tot = w[t - 16] + s0 + w[t - 7] + s1
                w.append(tot & M32)
                cs = tot >> 32
            S1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
            ch = (e & f) ^ (~e & g)
            t1 = h + S1 + (ch & M32) + int(K[t]) + w[t]
            tot_e = d + t1
            new_e, ce = tot_e & M32, tot_e >> 32
            S0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
            mj = (a & b) | (a & c) | (b & c)
            tot_a = t1 + S0 + mj
            new_a, ca = tot_a & M32, tot_a >> 32
            h, g, f, e = g, f, e, new_e
            d, c, b, a = c, b, a, new_a
            rows.append((w[t], new_a, new_e, ce, ca, cs))
        fin = [a, b, c, d, e, f, g, h]
        h_out = [(s + v) & M32 for s, v in zip(state, fin)]
        out_c = [(s + v) >> 32 for s, v in zip(state, fin)]
        return rows, h_out, out_c

    def _fill_slot(self, ctx: Context, slot: int, state: list, words: list):
        """Fill one slot's witness; returns h_out. The copies for h_in, the
        inputs and the outputs are the caller's (it knows the sources)."""
        sd = ctx.sha_slots[slot]
        bits, wcols = sd["bits"], sd["words"]
        rows, h_out, out_c = self._trace_block(state, words)
        tr = np.array(rows, dtype=np.uint64)               # [64, 6]
        # seed rows: the a ladder's rows 0..3 hold H[3-r], the e ladder's H[7-r]
        bits[0:4, SHA_A:SHA_A + 32] = _bits(state[3::-1])
        bits[0:4, SHA_E:SHA_E + 32] = _bits(state[7:3:-1])
        wcols[SHA_SEED_ROW, 0:8] = state
        # round rows 4..67
        bits[4:68, SHA_W:SHA_W + 32] = _bits(tr[:, 0])
        bits[4:68, SHA_A:SHA_A + 32] = _bits(tr[:, 1])
        bits[4:68, SHA_E:SHA_E + 32] = _bits(tr[:, 2])
        bits[4:68, SHA_CARRY:SHA_CARRY + 3] = _bits(tr[:, 3])[:, :3]
        bits[4:68, SHA_CARRY + 3:SHA_CARRY + 6] = _bits(tr[:, 4])[:, :3]
        bits[4:68, SHA_CARRY + 6:SHA_CARRY + 8] = _bits(tr[:, 5])[:, :2]
        wcols[4:20, 8] = tr[:16, 0]
        # output row
        wcols[SHA_OUT_ROW, 0:8] = h_out
        bits[SHA_OUT_ROW, SHA_CARRY:SHA_CARRY + 8] = out_c
        # act = 1 on rows 0..68 (pinned to the constant 1 by the caller's copy)
        wcols[:SHA_OUT_ROW + 1, SHA_ACT_WORD] = 1
        return h_out

    def _compress_chain(self, ctx: Context, word_cells: list,
                        initial_state: list | None = None):
        """Run len(word_cells) / 16 chained blocks from the IV (or a
        constant midstate); word_cells are main-region cells of the padded
        message. Returns 8 WideWords mirroring the final h_out."""
        if len(word_cells) % 16:
            raise ValueError("a whole number of 16-word blocks")
        nblocks = len(word_cells) // 16
        copies = ctx.copies
        state = [int(v) for v in (H0 if initial_state is None else initial_state)]
        prev_slot = None
        for b in range(nblocks):
            blk = word_cells[16 * b:16 * b + 16]
            slot = ctx.alloc_sha_slot()
            base = slot * SHA_SLOT_ROWS
            # act pin: the copy to the constant 1 makes this slot's round
            # identities include the real K_t terms
            one = ctx.load_constant(1)
            copies += (one.index << 3, shw_ref(SHA_ACT_WORD, base + SHA_SEED_ROW))
            # h_in binding
            if prev_slot is None:
                for j in range(8):
                    cst = ctx.load_constant(state[j])
                    copies += (cst.index << 3, shw_ref(j, base + SHA_SEED_ROW))
            else:
                pbase = prev_slot * SHA_SLOT_ROWS
                for j in range(8):
                    copies += (shw_ref(j, pbase + SHA_OUT_ROW),
                               shw_ref(j, base + SHA_SEED_ROW))
            # input words -> word column 8, rows 4..19
            for t, wcell in enumerate(blk):
                copies += (wcell.cell.index << 3, shw_ref(8, base + 4 + t))
            state = self._fill_slot(ctx, slot, state, [w.value for w in blk])
            prev_slot = slot
        # mirror the final digest into the main region. The out-row identity
        # pins h_out only mod 2^32 with a boolean carry: the 32-bit range
        # check on the mirror makes it unique and pins the carry too
        # (intermediate blocks need none: the next slot's seed identity
        # recombines h_in from boolean ladder bits)
        out = []
        obase = prev_slot * SHA_SLOT_ROWS + SHA_OUT_ROW
        for j in range(8):
            cell = ctx.load_witness(state[j])
            self._range_bits(ctx, cell, 32)
            copies += (cell.index << 3, shw_ref(j, obase))
            out.append(WideWord(cell))
        return out

    # -- public interface (gadget layer) ---------------------------------

    def digest_two_to_one(self, ctx: Context, left: list, right: list) -> list:
        """SSZ merkle node sha256(left32 || right32); inputs are 8-word lists
        (WideWord or any word with .cell and .value)."""
        pad = [self.constant_word(ctx, 0x80000000)] + \
              [self.constant_word(ctx, 0)] * 14 + \
              [self.constant_word(ctx, 512)]
        return self._compress_chain(ctx, list(left) + list(right) + pad)

    def digest_bytes(self, ctx: Context, byte_cells: list) -> list:
        """SHA256 of a byte-cell message (bytes already 8-bit checked);
        fixed-shape padding, words packed 4 bytes to a cell."""
        msg_len = len(byte_cells)
        padded = list(byte_cells)
        padded.append(ctx.load_constant(0x80))
        while (len(padded) % 64) != 56:
            padded.append(ctx.load_constant(0))
        for byte in (8 * msg_len).to_bytes(8, "big"):
            padded.append(ctx.load_constant(byte))
        words = [self.word_from_bytes_be(ctx, padded[4 * i:4 * i + 4])
                 for i in range(len(padded) // 4)]
        return self._compress_chain(ctx, words)

    # the nibble-path entry points have no meaning on the wide chip
    def compress(self, *a, **k):
        raise NotImplementedError("the wide chip hashes in the region")

    def initial_state(self, *a, **k):
        raise NotImplementedError("the wide chip hashes in the region")
