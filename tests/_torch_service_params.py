"""Request params for the prover service's tests, built from the TINY
default args: the genEvmProof_SyncStepCompressed params of the reference's
`tests/test_service.py`, and a committee update whose finalized state root
holds the committee (the converter checks its branch)."""

import dataclasses

from spectre_tpu_torch import spec as SPEC
from spectre_tpu_torch.fields import bls12_381 as bls
from spectre_tpu_torch.witness.rotation import mock_root
from spectre_tpu_torch.witness.types import bytes48_root

TINY = SPEC.TINY


def _hdr(h):
    return {"slot": h.slot, "proposer_index": h.proposer_index,
            "parent_root": "0x" + h.parent_root.hex(), "state_root": "0x" + h.state_root.hex(),
            "body_root": "0x" + h.body_root.hex()}


def step_params(args):
    """The genEvmProof_SyncStepCompressed params of the reference's tests."""
    pks = ["0x" + bls.g1_compress((bls.Fq(x), bls.Fq(y))).hex()
           for x, y in args.pubkeys_uncompressed]
    update = {
        "attested_header": _hdr(args.attested_header),
        "finalized_header": _hdr(args.finalized_header),
        "finality_branch": ["0x" + b.hex() for b in args.finality_branch],
        "execution_payload_root": "0x" + args.execution_payload_root.hex(),
        "execution_branch": ["0x" + b.hex() for b in args.execution_payload_branch],
        "sync_aggregate": {"sync_committee_bits": args.participation_bits,
                           "sync_committee_signature": "0x" + args.signature_compressed.hex()},
    }
    return {"light_client_finality_update": update, "pubkeys": pks,
            "domain": "0x" + args.domain.hex()}


def committee_params(args):
    """A committee update whose finalized state root holds the committee
    (the converter checks the branch)."""
    agg = bls.g1_compress(bls.sk_to_pk(424242))
    branch = [b"\x11" * 32] * TINY.sync_committee_depth
    root = mock_root(args.committee_pubkeys_root(), [bytes48_root(agg)] + branch,
                     TINY.sync_committee_pubkeys_root_index)
    hdr = dataclasses.replace(args.finalized_header, state_root=root)
    return {"light_client_update": {
        "finalized_header": _hdr(hdr),
        "next_sync_committee": {"pubkeys": ["0x" + pk.hex() for pk in args.pubkeys_compressed],
                                "aggregate_pubkey": "0x" + agg.hex()},
        "next_sync_committee_branch": ["0x" + b.hex() for b in branch]}}
