"""Chain spec constants — per-network SSZ generalized indices and committee
size (the port's copy of `spectre_tpu/spec.py`).

Mirrors `eth-types/src/spec.rs:8-83` (`trait Spec` + `Minimal`, `Testnet`,
`Mainnet` impls) and the circuit field/limb shape of
`eth-types/src/lib.rs:12-16`. Circuits take a Spec instance.
"""

from __future__ import annotations

from dataclasses import dataclass

# BLS signature domain-separation tag (same for all reference networks,
# `spec.rs` `DST`). One definition; bls12_381 hashing takes it as an argument.
DST = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_"


@dataclass(frozen=True)
class Spec:
    """Mirror of `eth-types/src/spec.rs` trait consts (same names, snake_case)."""

    name: str
    sync_committee_size: int
    sync_committee_depth: int
    sync_committee_root_index: int
    execution_state_root_index: int
    execution_state_root_depth: int
    finalized_header_index: int
    finalized_header_depth: int
    dst: bytes = DST
    bytes_per_logs_bloom: int = 256
    max_extra_data_bytes: int = 32
    # beacon time parameters (not in the reference Spec trait; used by the
    # preprocessor/service layer for sync-period math)
    slots_per_epoch: int = 32
    epochs_per_sync_committee_period: int = 256
    # header SSZ shape: slot, proposer_index, parent_root, state_root, body_root
    header_num_fields: int = 5

    # derived (spec.rs computes these from the root index/depth)
    @property
    def sync_committee_pubkeys_root_index(self) -> int:
        return self.sync_committee_root_index * 2

    @property
    def sync_committee_pubkeys_depth(self) -> int:
        return self.sync_committee_depth + 1

    @property
    def slots_per_period(self) -> int:
        return self.slots_per_epoch * self.epochs_per_sync_committee_period

    def sync_period(self, slot: int) -> int:
        return slot // self.slots_per_period


# `spec.rs:28-44`
MINIMAL = Spec(
    name="minimal",
    sync_committee_size=32,
    sync_committee_depth=5,
    sync_committee_root_index=55,
    execution_state_root_index=9,
    execution_state_root_depth=4,
    finalized_header_index=105,
    finalized_header_depth=6,
    slots_per_epoch=8,
    epochs_per_sync_committee_period=8,
)

# `spec.rs:49-64`
TESTNET = Spec(
    name="testnet",
    sync_committee_size=512,
    sync_committee_depth=5,
    sync_committee_root_index=55,
    execution_state_root_index=25,
    execution_state_root_depth=4,
    finalized_header_index=105,
    finalized_header_depth=6,
)

# `spec.rs:69-83`
MAINNET = Spec(
    name="mainnet",
    sync_committee_size=512,
    sync_committee_depth=5,
    sync_committee_root_index=55,
    execution_state_root_index=25,
    execution_state_root_depth=4,
    finalized_header_index=105,
    finalized_header_depth=6,
)

# A 2-validator demo network for fast end-to-end runs (not in the reference;
# the circuits are size-generic, so this exercises every constraint at the
# smallest shape).
TINY = Spec(
    name="tiny",
    sync_committee_size=2,
    sync_committee_depth=5,
    sync_committee_root_index=55,
    execution_state_root_index=9,
    execution_state_root_depth=4,
    finalized_header_index=105,
    finalized_header_depth=6,
    slots_per_epoch=8,
    epochs_per_sync_committee_period=8,
)

SPECS = {s.name: s for s in (TINY, MINIMAL, TESTNET, MAINNET)}


# Circuit bigint shape for non-native BLS12-381 Fq over BN254 Fr
# (reference: `eth-types/src/lib.rs:12-13`).
NUM_LIMBS = 5
LIMB_BITS = 104
