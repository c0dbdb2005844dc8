"""In-circuit multi-scalar multiplication over BN254 G1 (non-native Fq) —
the port's copy of `spectre_tpu/builder/msm_chip.py`.

The in-circuit accumulator MSM at the heart of `AggregationCircuit`: fixed
4-bit windows, one shared doubling chain for all witness points, host
tables for the vk-constant points, and offset points so the strict chord
addition never meets the identity.

Why the offsets are sound: every addition is a constrained chord add
(x1 != x2 enforced), so the loop computes exactly

    acc = 16^63*C + sum_i k_i*P_i + (sum_j 16^j) * sum_i Q_i      (witness)
    acc2 =            sum_i k'_i*P'_i + 64 * sum_i Q'_ij          (constant)

for any satisfying witness; the known constant correction D is subtracted
at the end. The offsets only bear on completeness: an honest run fails
(negligibly) iff some intermediate x-coordinates collide.

Scalar decomposition: bits are witnessed and recombined mod r. A
non-canonical decomposition (s + r) gives the same group element because
|G1| = r (cofactor 1), so the split need not be canonical.
"""

from __future__ import annotations

import hashlib

from ..fields import bn254
from ..fields.common import tonelli_shanks
from .context import AssignedValue, Context
from .fp_chip import EccChip, FpChip

R = bn254.R
P = bn254.P
WINDOW = 4
NBITS = 256                      # 64 windows of 4 bits
NWINDOWS = NBITS // WINDOW


def deterministic_point(tag: bytes):
    """Nothing-up-my-sleeve BN254 G1 point: try-and-increment from a hash
    (the MSM's offset points; completeness only, see the module doc)."""
    x = int.from_bytes(hashlib.blake2b(b"spectre-tpu-msm/" + tag,
                                       digest_size=32).digest(), "big") % P
    while True:
        rhs = (x * x % P * x + 3) % P
        y = tonelli_shanks(rhs, P)
        if y is not None:
            # Fq-wrapped: the curve group's ops on plain ints skip the
            # modular reduction
            return (bn254.Fq(x), bn254.Fq(min(y, P - y)))
        x = (x + 1) % P


class MsmChip:
    def __init__(self, ecc: EccChip):
        if ecc.fp.p != P or ecc.b != 3:
            raise ValueError("MsmChip is BN254-G1 specific")
        self.ecc = ecc
        self.fp: FpChip = ecc.fp
        self.gate = ecc.fp.gate

    # -- scalar windows ---------------------------------------------------
    def _windows(self, ctx: Context, scalar: AssignedValue) -> list:
        """256 bit cells, grouped MSB-window-first: [(b0, b1, b2, b3), ...]
        (LSB-first within a window)."""
        bits = self.gate.num_to_bits(ctx, scalar, NBITS - 2)  # 254-bit field
        zero = ctx.load_constant(0)
        bits = bits + [zero, zero]  # pad to 256
        return [bits[j * WINDOW:(j + 1) * WINDOW] for j in range(NWINDOWS - 1, -1, -1)]

    def _select16(self, ctx: Context, table: list, bits4: list):
        """Binary select tree over 16 (x, y) CrtUint pairs; bits LSB-first."""
        ecc = self.ecc
        level = table
        for b in bits4:
            level = [ecc.select(ctx, b, level[2 * i + 1], level[2 * i])
                     for i in range(len(level) // 2)]
        return level[0]

    def _onehot16(self, ctx: Context, bits4: list) -> list:
        """One-hot 16-vector of cells from 4 bit cells (LSB-first)."""
        gate = self.gate
        level = [ctx.load_constant(1)]
        for b in bits4:
            nb = gate.not_(ctx, b)
            level = ([gate.mul(ctx, cell, nb) for cell in level]
                     + [gate.mul(ctx, cell, b) for cell in level])
        return level

    def _const_entry(self, ctx: Context, onehot: list, pts: list):
        """Inner product of a one-hot selector with 16 constant points: the
        selected point as a CrtUint pair (its limbs constrained by the
        one-hot linear combination, exact because the one-hot cells are 0/1
        and the constants canonical)."""
        fp = self.fp
        nl, lb = fp.big.num_limbs, fp.big.limb_bits
        xs, ys = [int(p[0]) for p in pts], [int(p[1]) for p in pts]
        out = []
        for coords in (xs, ys):
            limbs = []
            for li in range(nl):
                consts = [(c >> (lb * li)) & ((1 << lb) - 1) for c in coords]
                limbs.append(self.gate.inner_product_const(ctx, onehot, consts))
            sel = 0
            for i, c in enumerate(coords):
                if onehot[i].value:
                    sel = c
            out.append(fp.from_limbs(ctx, limbs, sel))
        return (out[0], out[1])

    # -- the MSM ----------------------------------------------------------
    def msm(self, ctx: Context, witness_pairs: list, constant_pairs: list):
        """sum of scalar*point over witness_pairs [(point_cells, scalar_cell)]
        and constant_pairs [(host_point, scalar_cell)]. Returns point cells.
        The witness points must already be constrained on the curve by the
        caller."""
        ecc, fp = self.ecc, self.fp
        g1 = bn254.g1_curve

        # --- witness part: one shared doubling chain ---
        c0_host = deterministic_point(b"acc-init")
        tables = []
        offsets = []
        for i, (pt, _s) in enumerate(witness_pairs):
            q_host = deterministic_point(b"witness-%d" % i)
            entries = [fp.load_constant_point(ctx, q_host)]
            for _ in range(1, 16):
                entries.append(ecc.add_unequal_lazy(ctx, entries[-1], pt))
            tables.append(entries)
            offsets.append(q_host)

        win_bits = [self._windows(ctx, s) for (_p, s) in witness_pairs]

        acc = fp.load_constant_point(ctx, c0_host)
        for j in range(NWINDOWS):
            if j:
                for _ in range(WINDOW):
                    acc = ecc.double_lazy(ctx, acc)
            for i in range(len(witness_pairs)):
                entry = self._select16(ctx, tables[i], win_bits[i][j])
                acc = ecc.add_unequal_lazy(ctx, acc, entry)

        # the witness part's correction:
        # acc = 16^63*C0 + sum k_i P_i + (sum_j 16^j) * sum Q_i
        d = g1.mul(c0_host, pow(16, NWINDOWS - 1, R))
        geom = sum(pow(16, j, R) for j in range(NWINDOWS)) % R
        for q_host in offsets:
            d = g1.add(d, g1.mul(q_host, geom))

        # --- constant part: scaled host tables, no doublings ---
        for i, (pt_host, s) in enumerate(constant_pairs):
            wins = self._windows(ctx, s)
            q_host = deterministic_point(b"const-%d" % i)
            for j in range(NWINDOWS):
                # window j (MSB-first in wins) covers exponent 16^(NW-1-j)
                base = g1.mul(pt_host, pow(16, NWINDOWS - 1 - j, R))
                entries = [q_host]
                for _ in range(1, 16):
                    entries.append(g1.add(entries[-1], base))
                entry = self._const_entry(ctx, self._onehot16(ctx, wins[j]), entries)
                acc = ecc.add_unequal_lazy(ctx, acc, entry)
                d = g1.add(d, q_host)

        # --- subtract the known correction D ---
        nd = fp.load_constant_point(ctx, (int(d[0]), (P - int(d[1])) % P))
        return ecc.add_unequal_lazy(ctx, acc, nd)
