"""Witness data structures and host SSZ helpers (the port's copy of
`spectre_tpu/witness/types.py`).

`witness/step.rs:28-49` (SyncStepArgs), `witness/rotation.rs:16-25`
(CommitteeUpdateArgs), and the SSZ hash_tree_root rules these circuits
recompute (uint64 -> LE chunk, Bytes48 -> 2-chunk root, containers ->
merkleized field roots).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..gadgets.ssz_merkle import merkleize_chunks_native, sha256_pair_native


def uint64_chunk(v: int) -> bytes:
    return int(v).to_bytes(8, "little") + b"\x00" * 24


def bytes48_root(b: bytes) -> bytes:
    if len(b) != 48:
        raise ValueError("expected 48 bytes")
    padded = b + b"\x00" * 16
    return sha256_pair_native(padded[:32], padded[32:])


@dataclass
class BeaconBlockHeader:
    slot: int = 0
    proposer_index: int = 0
    parent_root: bytes = b"\x00" * 32
    state_root: bytes = b"\x00" * 32
    body_root: bytes = b"\x00" * 32

    def hash_tree_root(self) -> bytes:
        return merkleize_chunks_native([
            uint64_chunk(self.slot),
            uint64_chunk(self.proposer_index),
            self.parent_root,
            self.state_root,
            self.body_root,
        ], limit=8)


@dataclass
class SyncStepArgs:
    """Inputs of StepCircuit (reference `witness/step.rs:28-49`)."""

    signature_compressed: bytes = b""          # 96B G2 signature
    pubkeys_uncompressed: list = field(default_factory=list)  # [(x, y) ints]
    participation_bits: list = field(default_factory=list)    # [0/1]
    attested_header: BeaconBlockHeader = field(default_factory=BeaconBlockHeader)
    finalized_header: BeaconBlockHeader = field(default_factory=BeaconBlockHeader)
    finality_branch: list = field(default_factory=list)       # [bytes32]
    execution_payload_root: bytes = b"\x00" * 32
    execution_payload_branch: list = field(default_factory=list)
    domain: bytes = b"\x00" * 32

    def signing_root(self) -> bytes:
        return sha256_pair_native(self.attested_header.hash_tree_root(), self.domain)


@dataclass
class CommitteeUpdateArgs:
    """Inputs of CommitteeUpdateCircuit (reference `witness/rotation.rs:16-25`)."""

    pubkeys_compressed: list = field(default_factory=list)    # [bytes48]
    finalized_header: BeaconBlockHeader = field(default_factory=BeaconBlockHeader)
    sync_committee_branch: list = field(default_factory=list)  # [bytes32]

    def committee_pubkeys_root(self) -> bytes:
        """Root of the pubkeys LIST (not the SyncCommittee container) —
        matches the in-circuit `sync_committee_root_ssz`."""
        import hashlib
        leaves = [hashlib.sha256(pk + b"\x00" * 16).digest()
                  for pk in self.pubkeys_compressed]
        return merkleize_chunks_native(leaves)
