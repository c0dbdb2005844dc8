"""Poseidon commitment to a sync-committee pubkey array (the port's copy of
`spectre_tpu/gadgets/poseidon_commit.py`).

`poseidon.rs:42-95` (`g1_array_poseidon`: fold each pubkey's
X-coordinate limbs 5->2 and sponge over the folded pairs + packed y-signs) and
its native mirrors (`poseidon_hash_g1_array:100`,
`..._from_uncompressed:147`, `..._from_compressed:166`). The circuit and the
native function here are the SAME folding scheme, so the commitment a
CommitteeUpdate proof outputs equals the one the Step proof consumes.

Our folding: X is NUM_LIMBS=5 limbs of LIMB_BITS=104 (spec.py); limbs fold to
2 field elements (limbs 0..2 -> lo via base 2^104, limbs 3..4 -> hi); y signs
pack 253 per field element.
"""

from __future__ import annotations

from ..fields import bn254
from ..ops import poseidon as P
from ..spec import LIMB_BITS, NUM_LIMBS
from ..builder.context import Context
from ..builder.gate import GateChip
from ..builder.poseidon_chip import PoseidonChip

R = bn254.R

FOLD_LO = 3  # limbs folded into the low element
SIGN_PACK = 253


def fold_limbs_native(x_limbs: list[int]) -> tuple[int, int]:
    assert len(x_limbs) == NUM_LIMBS
    lo = sum(v << (LIMB_BITS * i) for i, v in enumerate(x_limbs[:FOLD_LO])) % R
    hi = sum(v << (LIMB_BITS * i) for i, v in enumerate(x_limbs[FOLD_LO:])) % R
    return lo, hi


def g1_array_poseidon_native(x_limbs_list: list, y_signs: list[int]) -> int:
    """Native commitment: inputs are per-pubkey X limb vectors + y sign bits."""
    sponge = P.PoseidonSponge()
    for limbs in x_limbs_list:
        lo, hi = fold_limbs_native(limbs)
        sponge.absorb([lo, hi])
    for off in range(0, len(y_signs), SIGN_PACK):
        packed = 0
        for i, b in enumerate(y_signs[off:off + SIGN_PACK]):
            packed |= (int(b) & 1) << i
        sponge.absorb([packed])
    return sponge.squeeze()


def committee_poseidon_from_uncompressed(points) -> int:
    """Host: affine BLS12-381 G1 points -> commitment (reference:
    `poseidon_committee_commitment_from_uncompressed`, `poseidon.rs:147`)."""
    from ..fields import bls12_381 as bls
    limbs_list, signs = [], []
    mask = (1 << LIMB_BITS) - 1
    for pt in points:
        x = int(pt[0])
        limbs_list.append([(x >> (LIMB_BITS * i)) & mask for i in range(NUM_LIMBS)])
        signs.append(1 if bls.fq_sign(pt[1]) else 0)
    return g1_array_poseidon_native(limbs_list, signs)


def g1_array_poseidon(ctx: Context, gate: GateChip, poseidon: PoseidonChip,
                      x_limbs_cells: list, y_sign_cells: list):
    """In-circuit commitment. x_limbs_cells: per pubkey, NUM_LIMBS cells
    (already range-checked to LIMB_BITS); y_sign_cells: bit cells."""
    inputs = []
    for limbs in x_limbs_cells:
        assert len(limbs) == NUM_LIMBS
        lo = gate.inner_product_const(
            ctx, limbs[:FOLD_LO], [1 << (LIMB_BITS * i) for i in range(FOLD_LO)])
        hi = gate.inner_product_const(
            ctx, limbs[FOLD_LO:],
            [1 << (LIMB_BITS * i) for i in range(NUM_LIMBS - FOLD_LO)])
        inputs.extend([lo, hi])
    for off in range(0, len(y_sign_cells), SIGN_PACK):
        batch = y_sign_cells[off:off + SIGN_PACK]
        packed = gate.inner_product_const(ctx, batch, [1 << i for i in range(len(batch))])
        inputs.append(packed)
    return poseidon.hash_values(ctx, inputs)
