"""Executable reference model of the Spectre light-client contract (the
port's copy of `spectre_tpu/contracts/spectre.py`).

Reference parity: the `Spectre` contract consumed by
`contract-tests/tests/spectre.rs:56-79` — storage: `head`,
`block_header_roots[slot]`, `execution_payload_roots[slot]`,
`sync_committee_poseidons[period]`; entry points `step(...)` and
`rotate(...)`, each gated by a pluggable verifier (MockVerifier in protocol
tests, the real SNARK verifier in production).
"""

from __future__ import annotations

from dataclasses import dataclass, field


class MockVerifier:
    """Accepts everything (reference `MockVerifier.sol` — protocol tests
    without proving)."""

    def verify(self, instances, proof) -> bool:
        return True


class NativeVerifier:
    """Wraps the real plonk verifier (stands in for the generated SNARK
    verifier contract until Solidity emission lands)."""

    def __init__(self, vk, srs):
        self.vk, self.srs = vk, srs

    def verify(self, instances, proof) -> bool:
        from ..plonk.verifier import verify
        return verify(self.vk, self.srs, [list(instances)], proof)


class EvmProofVerifier:
    """Runs proofs through the GENERATED Solidity verifier in the EVM
    simulator — the closest thing to on-chain verification the repo can
    do (the aggregation cadence publishes through this). Construct
    with the output of ``evm.gen_evm_verifier``; each ``verify`` call
    deploys + calls the contract in ``evm.simulator``."""

    def __init__(self, sol_src: str):
        self.sol_src = sol_src

    def verify(self, instances, proof) -> bool:
        from ..evm.simulator import run_verifier
        return run_verifier(self.sol_src, list(instances), proof)


@dataclass
class StepInput:
    """Mirror of the Solidity step input struct
    (`contract-tests/tests/step_input_encoding.rs`)."""

    attested_slot: int
    finalized_slot: int
    participation: int
    finalized_header_root: bytes
    execution_payload_root: bytes

    def to_public_inputs_commitment(self) -> int:
        """Solidity `toPublicInputsCommitment` equivalence
        (`step_input_encoding.rs:109-116`): must equal the circuit's
        instance[0]."""
        import hashlib
        data = (self.attested_slot.to_bytes(8, "little")
                + self.finalized_slot.to_bytes(8, "little")
                + self.participation.to_bytes(8, "little")
                + self.finalized_header_root
                + self.execution_payload_root)
        digest = bytearray(hashlib.sha256(data).digest())
        digest[31] &= 0x1F
        return int.from_bytes(bytes(digest), "little")


@dataclass
class SpectreContract:
    spec: object
    initial_sync_period: int
    initial_committee_poseidon: int
    step_verifier: object = field(default_factory=MockVerifier)
    rotate_verifier: object = field(default_factory=MockVerifier)
    head: int = 0
    block_header_roots: dict = field(default_factory=dict)
    execution_payload_roots: dict = field(default_factory=dict)
    sync_committee_poseidons: dict = field(default_factory=dict)
    # aggregation cadence: end-period -> published window
    # record; `agg_verifier` gates publishes (falls back to the rotate
    # verifier — the window tip IS a committee-class proof)
    aggregated_ranges: dict = field(default_factory=dict)
    agg_verifier: object = None

    def __post_init__(self):
        self.sync_committee_poseidons[self.initial_sync_period] = \
            self.initial_committee_poseidon

    # -- entry points ---------------------------------------------------
    def step(self, inp: StepInput, proof: bytes):
        period = self.spec.sync_period(inp.attested_slot)
        poseidon = self.sync_committee_poseidons.get(period)
        assert poseidon is not None, f"no committee for period {period}"
        commitment = inp.to_public_inputs_commitment()
        assert self.step_verifier.verify([commitment, poseidon], proof), \
            "step proof invalid"
        min_participation = 2 * self.spec.sync_committee_size // 3
        assert inp.participation > min_participation, "insufficient participation"
        if inp.finalized_slot > self.head:
            self.head = inp.finalized_slot
        self.block_header_roots[inp.finalized_slot] = inp.finalized_header_root
        self.execution_payload_roots[inp.finalized_slot] = inp.execution_payload_root

    def rotate(self, finalized_slot: int, next_committee_poseidon: int,
               header_root_lo: int, header_root_hi: int, proof: bytes):
        assert self.rotate_verifier.verify(
            [next_committee_poseidon, header_root_lo, header_root_hi], proof), \
            "rotate proof invalid"
        # the finalized header must already be known to the light client
        root = self.block_header_roots.get(finalized_slot)
        assert root is not None, "unknown finalized header"
        lo = int.from_bytes(root[16:], "big")
        hi = int.from_bytes(root[:16], "big")
        assert (lo, hi) == (header_root_lo, header_root_hi), \
            "header root mismatch"
        next_period = self.spec.sync_period(finalized_slot) + 1
        assert next_period not in self.sync_committee_poseidons, \
            "period already rotated"
        self.sync_committee_poseidons[next_period] = next_committee_poseidon

    def publish_aggregate(self, start_period: int, period: int,
                          committee_poseidon, instances, proof: bytes,
                          calldata=None) -> dict:
        """Publish an aggregation-cadence proof covering committee
        periods ``[start_period, period]``. The proof is
        verified by ``agg_verifier`` (the generated EVM verifier via
        :class:`EvmProofVerifier` in drills; ``rotate_verifier``
        otherwise). Replay-safe: re-publishing the IDENTICAL window is
        an idempotent no-op (crash between publish and journal append),
        but a conflicting proof for an already-published end period is
        refused."""
        period, start_period = int(period), int(start_period)
        assert start_period <= period, "empty aggregation window"
        prior = self.aggregated_ranges.get(period)
        if prior is not None:
            assert prior["committee_poseidon"] == committee_poseidon \
                and prior["start_period"] == start_period, \
                f"period {period} already aggregated with different content"
            return prior
        verifier = self.agg_verifier or self.rotate_verifier
        assert verifier.verify(list(instances), proof), \
            "aggregation proof invalid"
        rec = {"start_period": start_period, "period": period,
               "committee_poseidon": committee_poseidon,
               "calldata": calldata}
        self.aggregated_ranges[period] = rec
        return rec
