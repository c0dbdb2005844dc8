"""StepCircuit: verify one sync-step of the Altair light-client protocol.

The port's copy of `spectre_tpu/models/step.py`: `sync_step_circuit.rs`
(`assign_virtual:64`), the full constraint set, with the BLS block:
- participation bit-check + sum, and the n-iteration conditional point-add
  aggregation loop over on-curve-checked pubkeys (`aggregate_pubkeys:292`,
  hot loop `:344-355`; blinded accumulator start so strict chords never
  degenerate);
- Poseidon commitment of the committee with the y-sign derived from the
  on-curve-bound y;
- SSZ roots of attested/finalized headers, the signing root, two Merkle
  proofs (finality `:174-183`, execution `:186-195`);
- in-circuit hash-to-curve of the signing root (`:165-169`), G2 signature
  assignment with a psi subgroup check (`assign_signature:279`), and the
  pairing check e(agg_pk, H(m)) * e(-g1, sig) == 1
  (`assert_valid_signature:171`);
- SHA256 public-input commitment truncated to 253 bits (`:199-221`).
Instances: [pub_inputs_commit, poseidon_commit] (`get_instances:228`).

The native aggregate-verify remains as a fast-fail witness guard; the same
property is enforced by constraints (without the guard, a forged signature
still leaves them unsatisfied).
"""

from __future__ import annotations

import hashlib

from ..builder import Context, GateChip, RangeChip
from ..builder.fp_chip import EccChip, FpChip
from ..builder.fp2_chip import Fp2Chip, G2Chip
from ..builder.fp12_chip import Fp12Chip
from ..builder.hash_to_curve_chip import HashToCurveChip
from ..builder.pairing_chip import PairingChip
from ..builder.poseidon_chip import PoseidonChip
from ..builder.sha256_chip import Sha256Chip
from ..builder.sha256_wide_chip import Sha256WideChip
from ..fields import bls12_381 as bls
from ..gadgets import poseidon_commit as PC
from ..gadgets import ssz_merkle as M
from ..spec import LIMB_BITS, NUM_LIMBS
from ..witness.types import SyncStepArgs
from .app_circuit import AppCircuit

# Accumulator blinding point for the aggregation loop: a fixed
# nothing-up-my-sleeve point subtracted back out at the end, so the strict
# chord additions never see x1 == x2 for honest witnesses (the reference
# seeds its loop from the first participant instead; a fixed offset keeps
# the loop shape static in the participation bits).
AGG_BLIND_SCALAR = int.from_bytes(b"spectre_tpu/step/agg-blind/v1", "big") % bls.R
AGG_BLIND = bls.g1_curve.mul(bls.G1_GEN, AGG_BLIND_SCALAR)

LIMB_MASK = (1 << LIMB_BITS) - 1
HALF_P = (bls.P - 1) // 2


def _fq_limbs(v: int):
    return [(int(v) >> (LIMB_BITS * i)) & LIMB_MASK for i in range(NUM_LIMBS)]


class StepCircuit(AppCircuit):
    name = "sync_step"
    # The reference splits its SHA backends per circuit for exactly the
    # reason we do: the step circuit is the one that gets COMPRESSED
    # (in-circuit-verified by the aggregation layer), so its proof must
    # stay small — the wide region adds 114 committed columns (+~550
    # opening evals), which dwarfs the compression circuit. Step therefore
    # uses the lookup ("flex") SHA chip (reference: `Sha256Chip` =
    # sha256_flex, `sync_step_circuit.rs:71`), committee-update keeps the
    # wide region (reference: `Sha256ChipWide`). The ~45k-cells/block cost
    # of the 66 hashed blocks is bought back by a big range table halving
    # every range-check in the non-native BLS arithmetic (reference pins
    # lookup_bits=20 at k=21 for the same reason,
    # `config/sync_step_testnet.json`). Measured at Testnet-512/k=21:
    # lookup_bits=16 -> 17 advice / 35.6M cells; 18 -> 16 advice / 32.79M
    # cells (-8%); every advice column dropped is one fewer commitment in
    # the inner proof and a smaller in-circuit verifier downstream.
    use_wide_sha = False
    default_lookup_bits = 18

    @classmethod
    def build(cls, ctx: Context, args: SyncStepArgs, spec,
              native_precheck: bool = True, use_wide_sha: bool | None = None):
        if use_wide_sha is None:
            use_wide_sha = cls.use_wide_sha
        gate = GateChip()
        rng = RangeChip(cls.default_lookup_bits, gate)
        sha_nib = Sha256Chip(gate)
        sha = Sha256WideChip(gate) if use_wide_sha else sha_nib
        poseidon = PoseidonChip(gate)
        fp = FpChip(rng)
        fp2 = Fp2Chip(fp)
        ecc = EccChip(fp)
        g2 = G2Chip(fp2)
        pairing = PairingChip(Fp12Chip(fp2))
        h2c = HashToCurveChip(pairing, sha_nib,
                              sha_wide=sha if use_wide_sha else None)
        n = spec.sync_committee_size
        if len(args.pubkeys_uncompressed) != n:
            raise ValueError(f"expected {n} pubkeys")
        if len(args.participation_bits) != n:
            raise ValueError(f"expected {n} participation bits")

        # --- witness-side fast-fail guard (constraints enforce the same) ---
        participating = [pk for pk, b in
                         zip(args.pubkeys_uncompressed, args.participation_bits) if b]
        sig = bls.g2_decompress(args.signature_compressed)
        if native_precheck:
            pts = [(bls.Fq(x), bls.Fq(y)) for x, y in participating]
            if not bls.fast_aggregate_verify(pts, args.signing_root(), sig,
                                             dst=spec.dst):
                raise ValueError("aggregate signature invalid (native pre-check)")

        # --- participation bits + sum ---
        bit_cells = []
        for b in args.participation_bits:
            c = ctx.load_witness(int(b))
            gate.assert_bit(ctx, c)
            bit_cells.append(c)
        participation_sum = gate.sum_(ctx, bit_cells)

        # --- pubkeys: on-curve assignment + poseidon commitment + the
        #     conditional-add aggregation loop (`aggregate_pubkeys:292`) ---
        if not any(args.participation_bits):
            raise ValueError("no participants: empty aggregation is not a "
                             "provable statement")
        half_p_limbs = _fq_limbs(HALF_P)
        limbs_list, sign_cells = [], []
        acc = fp.load_constant_point(ctx, AGG_BLIND)
        for (x, y), bit_cell in zip(args.pubkeys_uncompressed, bit_cells):
            pt = ecc.load_point(ctx, (x, y))      # y^2 = x^3 + 4 binds y to x
            xc, yc = pt
            # y_sign = ((p-1)/2 < y) from the ON-CURVE y limbs
            sign = cls._big_less_than_const(ctx, gate, rng, half_p_limbs,
                                            yc.limbs)
            limbs_list.append(xc.limbs)
            sign_cells.append(sign)
            summed = ecc.add_unequal_lazy(ctx, acc, pt)  # strict chord
            acc = (fp.select(ctx, bit_cell, summed[0], acc[0]),
                   fp.select(ctx, bit_cell, summed[1], acc[1]))
        neg_blind = fp.load_constant_point(
            ctx, bls.g1_curve.neg(AGG_BLIND))
        agg_pk = ecc.add_unequal_lazy(ctx, acc, neg_blind)
        poseidon_commit = PC.g1_array_poseidon(ctx, gate, poseidon,
                                               limbs_list, sign_cells)

        # --- header roots + signing root ---
        zero = ctx.load_constant(0)

        def byte_cells_checked(bs: bytes):
            return M.load_bytes_checked(ctx, sha, bs)

        def uint64_cells(v: int):
            return byte_cells_checked(int(v).to_bytes(8, "little"))

        def header_chunks(hdr):
            slot_cells = uint64_cells(hdr.slot)
            chunks = [
                M.bytes_to_chunk(ctx, sha, slot_cells + [zero] * 24),
                M.bytes_to_chunk(ctx, sha, uint64_cells(hdr.proposer_index) + [zero] * 24),
                M.bytes_to_chunk(ctx, sha, byte_cells_checked(hdr.parent_root)),
                M.bytes_to_chunk(ctx, sha, byte_cells_checked(hdr.state_root)),
                M.bytes_to_chunk(ctx, sha, byte_cells_checked(hdr.body_root)),
            ]
            return slot_cells, chunks

        att_slot_cells, att_chunks = header_chunks(args.attested_header)
        fin_slot_cells, fin_chunks = header_chunks(args.finalized_header)
        attested_root = M.merkleize_chunks(ctx, sha, att_chunks, limit=8)
        finalized_root = M.merkleize_chunks(ctx, sha, fin_chunks, limit=8)

        domain_chunk = M.bytes_to_chunk(ctx, sha, byte_cells_checked(args.domain))
        signing_root = sha.digest_two_to_one(ctx, attested_root, domain_chunk)

        # --- the BLS block (`:165-171`): hash the signing root to G2,
        #     assign + subgroup-check the signature, pairing check ---
        signing_root_bytes = cls._chunk_bytes(ctx, gate, sha, signing_root)
        msg_point = h2c.hash_to_g2(ctx, signing_root_bytes, spec.dst)
        sig_pt = g2.load_point(ctx, sig)
        pairing.assert_g2_subgroup(ctx, sig_pt)
        neg_g1 = fp.load_constant_point(ctx, bls.g1_curve.neg(bls.G1_GEN))
        pairing.assert_pairing_product_one(
            ctx, [(agg_pk, msg_point), (neg_g1, sig_pt)])

        # --- merkle proofs ---
        att_state_chunk = att_chunks[3]
        fin_branch = [M.bytes_to_chunk(ctx, sha, byte_cells_checked(b))
                      for b in args.finality_branch]
        M.verify_merkle_proof(ctx, sha, finalized_root, fin_branch,
                              spec.finalized_header_index, att_state_chunk)

        exec_chunk = M.bytes_to_chunk(ctx, sha,
                                      byte_cells_checked(args.execution_payload_root))
        exec_branch = [M.bytes_to_chunk(ctx, sha, byte_cells_checked(b))
                       for b in args.execution_payload_branch]
        fin_body_chunk = fin_chunks[4]
        M.verify_merkle_proof(ctx, sha, exec_chunk, exec_branch,
                              spec.execution_state_root_index, fin_body_chunk)

        # --- public input commitment ---
        sum_cells = M.load_bytes_checked(
            ctx, sha, int(participation_sum.value).to_bytes(8, "little"))
        acc = gate.inner_product_const(ctx, sum_cells, [1 << (8 * i) for i in range(8)])
        ctx.constrain_equal(acc, participation_sum)

        fin_root_bytes = cls._chunk_bytes(ctx, gate, sha, finalized_root)
        exec_root_bytes = cls._chunk_bytes(ctx, gate, sha, exec_chunk)

        concat = (att_slot_cells + fin_slot_cells + sum_cells
                  + fin_root_bytes + exec_root_bytes)
        digest_words = sha.digest_bytes(ctx, concat)
        pub_commit = cls._truncate_words_le(ctx, gate, sha, digest_words)

        ctx.expose_public(pub_commit)
        ctx.expose_public(poseidon_commit)
        return [pub_commit, poseidon_commit]

    # -- helpers ---------------------------------------------------------
    @staticmethod
    def _big_less_than_const(ctx, gate: GateChip, rng: RangeChip,
                             a_limbs_const: list, b_limbs: list):
        """(a < b) for a constant limb vector vs limb cells (both LIMB_BITS)."""
        result = None
        eq_chain = None
        for i in range(NUM_LIMBS - 1, -1, -1):
            ac = ctx.load_constant(a_limbs_const[i])
            lt = rng.is_less_than(ctx, ac, b_limbs[i], LIMB_BITS)
            eq = gate.is_equal(ctx, ac, b_limbs[i])
            if result is None:
                result = lt
                eq_chain = eq
            else:
                term = gate.and_(ctx, eq_chain, lt)
                result = gate.or_(ctx, result, term)
                eq_chain = gate.and_(ctx, eq_chain, eq)
        return result

    @staticmethod
    def _chunk_bytes(ctx, gate: GateChip, sha: Sha256Chip, chunk: list):
        """8-Word chunk -> 32 byte cells (BE), byte-decomposed + constrained."""
        out = []
        for w in chunk:
            v = w.value
            cells = []
            for i in range(4):
                c = ctx.load_witness((v >> (8 * (3 - i))) & 0xFF)
                sha._range_bits(ctx, c, 8)
                cells.append(c)
            acc = gate.inner_product_const(ctx, cells, [1 << 24, 1 << 16, 1 << 8, 1])
            ctx.constrain_equal(acc, w.cell)
            out.extend(cells)
        return out

    @staticmethod
    def _truncate_words_le(ctx, gate: GateChip, sha: Sha256Chip, words: list):
        """SHA digest (8 BE Words) -> field element from LE bytes with the top
        3 bits dropped (reference `truncate_sha256_into_single_elem:368`)."""
        byte_cells = StepCircuit._chunk_bytes(ctx, gate, sha, words)
        # byte 31 (last LE byte... byte_cells are BE order: byte 31 is index 31)
        top = byte_cells[31]
        bits = gate.num_to_bits(ctx, top, 8)
        cleared = gate.bits_to_num(ctx, bits[:5])
        # LE interpretation: digest[i] has weight 2^(8i), digest[31] masked
        coeffs = [1 << (8 * i) for i in range(32)]
        ordered = byte_cells[:31] + [cleared]
        return gate.inner_product_const(ctx, ordered, coeffs)

    @classmethod
    def get_instances(cls, args: SyncStepArgs, spec) -> list:
        """Native recomputation (reference `get_instances:228`)."""
        participation = sum(args.participation_bits)
        data = (int(args.attested_header.slot).to_bytes(8, "little")
                + int(args.finalized_header.slot).to_bytes(8, "little")
                + int(participation).to_bytes(8, "little")
                + args.finalized_header.hash_tree_root()
                + args.execution_payload_root)
        digest = bytearray(hashlib.sha256(data).digest())
        digest[31] &= 0x1F
        pub_commit = int.from_bytes(bytes(digest), "little")
        pts = [(bls.Fq(x), bls.Fq(y)) for x, y in args.pubkeys_uncompressed]
        poseidon = PC.committee_poseidon_from_uncompressed(pts)
        return [pub_commit, poseidon]
