"""Proof aggregation / compression circuit (the port's copy of
`spectre_tpu/models/aggregation.py`).

snark-verifier's `AggregationCircuit` (`aggregation_circuit.rs:69-124`): a
one-layer SHPLONK compression of an app snark. The inner proof, made with
the Poseidon transcript, is verified entirely in-circuit
(`plonk/in_circuit.py`); the final pairing is not performed: its two G1
inputs are exposed as 12 x 88-bit limbs followed by the app instances, so
the outer verifier (the EVM contract or the host) finishes with one pairing
check.

Statement: [lhs.x (3), lhs.y (3), rhs.x (3), rhs.y (3), app instances...]
where e(lhs, [tau]_2) == e(rhs, [1]_2) iff the inner proof verifies.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..builder.range_chip import RangeChip
from ..device import resolve
from ..fields import bn254
from ..plonk.srs import SRS
from ..plonk.transcript import Blake2bTranscript, PoseidonTranscript
from ..plonk.verifier import verify as plonk_verify
from .app_circuit import AppCircuit

R = bn254.R
ACC_LIMB_BITS = 88
ACC_LIMBS_PER_COORD = 3  # 12 limbs in all: (lhs.x, lhs.y, rhs.x, rhs.y) x 3
NUM_ACC_LIMBS = 12


@dataclass
class Accumulator:
    """Deferred KZG pairing check: e(lhs, [tau]_2) == e(rhs, [1]_2)."""

    lhs: object  # G1 point
    rhs: object

    def limbs(self) -> list[int]:
        """12 x 88-bit limbs, the aggregation circuit's first instances
        (snark-verifier's `LimbsEncoding<3, 88>`)."""
        out = []
        for pt in (self.lhs, self.rhs):
            for coord in (int(pt[0]), int(pt[1])):
                for i in range(ACC_LIMBS_PER_COORD):
                    out.append((coord >> (ACC_LIMB_BITS * i)) & ((1 << ACC_LIMB_BITS) - 1))
        return out

    @classmethod
    def from_limbs(cls, limbs: list) -> "Accumulator":
        if len(limbs) < NUM_ACC_LIMBS:
            raise ValueError(f"an accumulator is {NUM_ACC_LIMBS} limbs")
        coords = []
        for c in range(4):
            v = sum(int(limbs[3 * c + i]) << (ACC_LIMB_BITS * i)
                    for i in range(ACC_LIMBS_PER_COORD))
            coords.append(bn254.Fq(v))
        return cls(lhs=(coords[0], coords[1]), rhs=(coords[2], coords[3]))

    def check(self, srs: SRS) -> bool:
        return bn254.pairing_check([
            (self.lhs, srs.g2_tau),
            (bn254.g1_curve.neg(self.rhs), srs.g2_gen),
        ])


def accumulate(accs: list[Accumulator]) -> Accumulator:
    """A linear combination of deferred pairing checks into one. The
    challenges come from a transcript over the accumulator points
    themselves (Fiat-Shamir, re-derivable by any verifier and in-circuit:
    `VerifierChip.fold_accumulators`)."""
    g1 = bn254.g1_curve
    tr = PoseidonTranscript()
    for acc in accs:
        tr.common_point(acc.lhs)
        tr.common_point(acc.rhs)
    lhs, rhs = None, None
    for acc in accs:
        r = tr.challenge()
        lhs = g1.add(lhs, g1.mul(acc.lhs, r))
        rhs = g1.add(rhs, g1.mul(acc.rhs, r))
    return Accumulator(lhs, rhs)


@dataclass
class SnarkWitness:
    """One inner snark: its verifying key, public inputs and proof bytes
    (snark-verifier-sdk's `Snark`)."""

    vk: object                  # plonk VerifyingKey
    instances: list             # [[int]] public inputs
    proof: bytes                # Poseidon-transcript proof


@dataclass
class AggregationArgs:
    """The witness of one compression layer: the inner proof(s).

    Single-snark compression (the service's two-stage flow) uses the first
    four fields; `more_snarks` adds further inner proofs, folded into one
    deferred accumulator with transcript-bound challenges
    (`AggregationCircuit::new(Vec<Snark>)`)."""

    inner_vk: object            # plonk VerifyingKey of the app circuit
    srs: SRS
    inner_instances: list       # [[int]] app public inputs
    proof: bytes                # Poseidon-transcript app proof
    more_snarks: tuple = ()     # further SnarkWitness entries

    @property
    def snarks(self) -> list:
        return [SnarkWitness(self.inner_vk, self.inner_instances, self.proof)] + list(
            self.more_snarks)


class AggregationCircuit(AppCircuit):
    """In-circuit SHPLONK verification of app snarks.

    The app snark must be made with `PoseidonTranscript` (snark-verifier's
    `gen_snark_shplonk`); the outer proof may use any transcript, Keccak
    for the EVM path (`gen_evm_proof_shplonk`)."""

    name = "aggregation"
    default_lookup_bits = 14

    @classmethod
    def variant(cls, inner_name: str):
        """A subclass with its own name, so the pinnings of different inner
        circuits do not collide."""
        return type(f"AggregationCircuit_{inner_name}", (cls,),
                    {"name": f"aggregation_{inner_name}"})

    @classmethod
    def build(cls, ctx, args: AggregationArgs, spec):
        from ..plonk.in_circuit import VerifierChip
        vc = VerifierChip(RangeChip(lookup_bits=cls.default_lookup_bits))
        accs, all_inst_cells = [], []
        for sn in args.snarks:
            inst_cells = [[ctx.load_witness(int(v) % R) for v in col] for col in sn.instances]
            all_inst_cells.append(inst_cells)
            accs.append(vc.verify_proof(ctx, sn.vk, args.srs, inst_cells, sn.proof))
        if len(accs) == 1:
            lhs, rhs = accs[0]
        else:
            lhs, rhs = vc.fold_accumulators(ctx, accs)
        # the accumulator's limbs as canonical representatives (the outer
        # pairing check compares them coordinate for coordinate)
        out = []
        for pt in (lhs, rhs):
            for coord in pt:
                out.extend(vc.fq.canonicalize(ctx, coord).limbs)
        for cell in out:
            ctx.expose_public(cell)
        for inst_cells in all_inst_cells:
            for col in inst_cells:
                for cell in col:
                    ctx.expose_public(cell)
        return out

    @classmethod
    def get_instances(cls, args: AggregationArgs, spec) -> list:
        from ..plonk.in_circuit import VerifierChip
        accs = []
        for sn in args.snarks:
            acc = VerifierChip.native_accumulator(sn.vk, args.srs, sn.instances, sn.proof)
            if acc is None:
                raise ValueError("inner proof invalid")
            accs.append(acc)
        acc = accs[0] if len(accs) == 1 else accumulate(accs)
        flat = [int(v) % R for sn in args.snarks for col in sn.instances for v in col]
        return acc.limbs() + flat

    @classmethod
    def verify(cls, vk, srs: SRS, instances, proof: bytes, device=None,
               transcript_cls=Blake2bTranscript) -> bool:
        """The outer proof's verification including the deferred pairing:
        the whole check a consumer of the compressed proof makes."""
        if not super().verify(vk, srs, instances, proof, device, transcript_cls):
            return False
        return Accumulator.from_limbs(instances[:NUM_ACC_LIMBS]).check(srs)

    @classmethod
    def batch_verify(cls, vk, srs: SRS, items: list, transcript_cls=PoseidonTranscript,
                     device=None) -> bool:
        """items: [(instances, proof)], the host verification of a batch of
        app proofs (Poseidon by default: app snarks bound for aggregation
        are made with it)."""
        resolve(device)
        return all(plonk_verify(vk, srs, [inst], proof, transcript_cls=transcript_cls)
                   for inst, proof in items)
