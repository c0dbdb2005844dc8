"""Default (self-signed) SyncStepArgs builder.

The port's copy of `spectre_tpu/witness/step.py` (`witness/step.rs:52-148`):
a deterministic committee signs the signing root of a fabricated attested
header; finality and execution branches are mock-rooted. Produces a
witness that satisfies StepCircuit without any chain data (used for keygen
and tests).
"""

from __future__ import annotations

from ..fields import bls12_381 as bls
from .rotation import mock_root
from .types import BeaconBlockHeader, SyncStepArgs


def default_sync_step_args(spec, seed: int = 1234,
                           participation: float = 1.0) -> SyncStepArgs:
    n = spec.sync_committee_size
    sks = [seed * 7919 + i + 1 for i in range(n)]
    pks = [bls.sk_to_pk(sk) for sk in sks]
    bits = [1 if i < int(n * participation) else 0 for i in range(n)]

    finalized = BeaconBlockHeader(
        slot=spec.slots_per_period + 32,
        proposer_index=3,
        parent_root=b"\x33" * 32,
        state_root=b"\x44" * 32,
        body_root=b"\x00" * 32,  # filled below from the execution branch
    )
    # execution payload root proven into the finalized BODY root
    exec_root = b"\x55" * 32
    exec_branch = [bytes([0xA0 + d]) * 32 for d in range(spec.execution_state_root_depth)]
    body_root = mock_root(exec_root, exec_branch, spec.execution_state_root_index)
    finalized.body_root = body_root

    # finalized header proven into the attested STATE root
    fin_root = finalized.hash_tree_root()
    fin_branch = [bytes([0xB0 + d]) * 32 for d in range(spec.finalized_header_depth)]
    attested_state_root = mock_root(fin_root, fin_branch, spec.finalized_header_index)
    attested = BeaconBlockHeader(
        slot=finalized.slot + 64,
        proposer_index=11,
        parent_root=b"\x66" * 32,
        state_root=attested_state_root,
        body_root=b"\x77" * 32,
    )

    args = SyncStepArgs(
        pubkeys_uncompressed=[(int(p[0]), int(p[1])) for p in pks],
        participation_bits=bits,
        attested_header=attested,
        finalized_header=finalized,
        finality_branch=fin_branch,
        execution_payload_root=exec_root,
        execution_payload_branch=exec_branch,
        domain=b"\x07" * 32,
    )
    signing_root = args.signing_root()
    msg_point = bls.hash_to_g2(signing_root, spec.dst)
    sigs = [bls.g2_curve.mul(msg_point, sk) for sk, b in zip(sks, bits) if b]
    args.signature_compressed = bls.g2_compress(bls.aggregate_signatures(sigs))
    return args
