"""Loaders for the reference's checked-in witness fixtures (DATA files; the
port's copy of `spectre_tpu/witness/ref_fixtures.py`).

Reference parity: the reference's unit tests run against
`test_data/sync_step_512.json` / `rotation_512.json` (serde of
`witness/step.rs:28-49` / `witness/rotation.rs:16-25`, loaded at
`sync_step_circuit.rs:455-457`). Loading the same JSON into this
framework's witness types gives cross-implementation conformance: the
fixtures were produced by the reference's Rust+blst generator, so a
signature/branch/instance that validates here proves interop of the whole
host stack (SSWU hash-to-curve, pairing, SSZ, gindex constants)."""

from __future__ import annotations

import json

from .types import BeaconBlockHeader, CommitteeUpdateArgs, SyncStepArgs


def _header(h: dict) -> BeaconBlockHeader:
    return BeaconBlockHeader(
        slot=int(h["slot"]),
        proposer_index=int(h["proposer_index"]),
        parent_root=bytes.fromhex(h["parent_root"][2:]),
        state_root=bytes.fromhex(h["state_root"][2:]),
        body_root=bytes.fromhex(h["body_root"][2:]),
    )


def load_sync_step(path: str) -> SyncStepArgs:
    with open(path) as f:
        d = json.load(f)
    return SyncStepArgs(
        signature_compressed=bytes(d["signature_compressed"]),
        pubkeys_uncompressed=[
            (int.from_bytes(bytes(pk[:48]), "big"),
             int.from_bytes(bytes(pk[48:]), "big"))
            for pk in d["pubkeys_uncompressed"]],
        # (sic) the reference serializes the field misspelled
        participation_bits=[1 if b else 0 for b in d["pariticipation_bits"]],
        attested_header=_header(d["attested_header"]),
        finalized_header=_header(d["finalized_header"]),
        finality_branch=[bytes(b) for b in d["finality_branch"]],
        execution_payload_root=bytes(d["execution_payload_root"]),
        execution_payload_branch=[bytes(b) for b in
                                  d["execution_payload_branch"]],
        domain=bytes(d["domain"]),
    )


def load_rotation(path: str) -> CommitteeUpdateArgs:
    with open(path) as f:
        d = json.load(f)
    return CommitteeUpdateArgs(
        pubkeys_compressed=[bytes(pk) for pk in d["pubkeys_compressed"]],
        finalized_header=_header(d["finalized_header"]),
        sync_committee_branch=[bytes(b) for b in d["sync_committee_branch"]],
    )
