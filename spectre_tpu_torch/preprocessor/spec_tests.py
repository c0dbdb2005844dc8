"""Consensus-spec-test loader: official pyspec light_client/sync fixtures
-> circuit witnesses (the port's copy of
`spectre_tpu/preprocessor/spec_tests.py`; a failed check raises ValueError
with the reference's message, and the entry points that decompress pubkeys
take `device`: CUDA by default, where K6 runs, or "cpu").

Reference parity: `test-utils/src/lib.rs` — `read_test_files_and_gen_witness`
(`:87-131`), `valid_updates_from_test_path` (`:64-85`),
`get_initial_sync_committee_poseidon` (`:32-51`), and the converter
`to_sync_ciruit_witness` (`:133-244`): the step witness takes the signing
committee from `bootstrap.ssz_snappy`, participation + signature from the
update's sync_aggregate, the domain from ForkData(fork_version,
genesis_validators_root), the execution payload root as
hash_tree_root(finalized_header.execution); the rotation witness proves the
update's NEXT committee into the ATTESTED header's state root, with the
aggregate-pubkey root prepended to the branch
(`test-utils/src/lib.rs:104-118`).

Fixture directory layout (ethereum/consensus-specs test format):
    <test_dir>/meta.yaml
    <test_dir>/bootstrap.ssz_snappy
    <test_dir>/steps.yaml
    <test_dir>/updates_<n>.ssz_snappy   (names referenced from steps.yaml)
"""

from __future__ import annotations

import hashlib
import os

from ..device import resolve
from ..fields import bls12_381 as bls
from ..gadgets import poseidon_commit as PC
from ..gadgets.ssz_merkle import sha256_pair_native, verify_merkle_proof_native
from ..ops.field384 import g1_decompress_batch
from ..witness.types import (BeaconBlockHeader, CommitteeUpdateArgs,
                             SyncStepArgs, bytes48_root)
from . import snappy_codec, ssz

# Capella fork versions (consensus-specs config): the reference hardcodes the
# minimal-preset version `[3, 0, 0, 1]` (`test-utils/src/lib.rs:215`).
CAPELLA_FORK_VERSION = {
    "minimal": bytes([3, 0, 0, 1]),
    "mainnet": bytes([3, 0, 0, 0]),
    # The repo-local presets have no official consensus config; these
    # self-assigned versions only need to be internally consistent (the same
    # value signs and verifies the self-generated fixtures — distinct from
    # the official ones so domains can never cross).
    "testnet": bytes([3, 0, 0, 2]),
    "tiny": bytes([3, 0, 0, 3]),
}


def _fork_version(spec) -> bytes:
    if spec.name not in CAPELLA_FORK_VERSION:
        raise ValueError(
            f"no Capella fork version registered for spec {spec.name!r} — "
            f"signing-domain computation would be wrong")
    return CAPELLA_FORK_VERSION[spec.name]


def load_snappy_ssz(path: str, ssz_type: ssz.SSZType):
    with open(path, "rb") as f:
        return ssz_type.decode(snappy_codec.decompress(f.read()))


def dump_snappy_ssz(path: str, ssz_type: ssz.SSZType, value) -> None:
    with open(path, "wb") as f:
        f.write(snappy_codec.compress(ssz_type.encode(value)))


def read_meta(test_dir: str) -> dict:
    import yaml
    with open(os.path.join(test_dir, "meta.yaml")) as f:
        return yaml.safe_load(f)


def read_steps(test_dir: str) -> list:
    import yaml
    with open(os.path.join(test_dir, "steps.yaml")) as f:
        return yaml.safe_load(f)


def valid_updates_from_test_path(test_dir: str, spec) -> list:
    """The prefix of process_update steps (cut at the first force_update),
    deserialized (`test-utils/src/lib.rs:64-85`)."""
    update_type = ssz.light_client_update(spec)
    updates = []
    for step in read_steps(test_dir):
        if "process_update" not in step:
            break
        name = step["process_update"]["update"]
        updates.append(load_snappy_ssz(
            os.path.join(test_dir, f"{name}.ssz_snappy"), update_type))
    return updates


def _beacon_header(obj: ssz.Obj) -> BeaconBlockHeader:
    return BeaconBlockHeader(
        slot=obj.slot, proposer_index=obj.proposer_index,
        parent_root=obj.parent_root, state_root=obj.state_root,
        body_root=obj.body_root)


def to_sync_circuit_witness(spec, bootstrap_committee: ssz.Obj, update: ssz.Obj,
                            genesis_validators_root: bytes, device=None) -> SyncStepArgs:
    """`to_sync_ciruit_witness` (`test-utils/src/lib.rs:133-244`); the
    committee's pubkeys decompress on `device`."""
    exec_type = ssz.execution_payload_header(
        spec.bytes_per_logs_bloom, spec.max_extra_data_bytes)
    pubkeys = g1_decompress_batch(list(bootstrap_committee.pubkeys), device=device)
    domain = ssz.compute_domain(
        ssz.DOMAIN_SYNC_COMMITTEE,
        _fork_version(spec), genesis_validators_root)
    return SyncStepArgs(
        signature_compressed=update.sync_aggregate.sync_committee_signature,
        pubkeys_uncompressed=pubkeys,
        participation_bits=list(update.sync_aggregate.sync_committee_bits),
        attested_header=_beacon_header(update.attested_header.beacon),
        finalized_header=_beacon_header(update.finalized_header.beacon),
        finality_branch=list(update.finality_branch),
        execution_payload_root=exec_type.hash_tree_root(
            update.finalized_header.execution),
        execution_payload_branch=list(update.finalized_header.execution_branch),
        domain=domain)


def read_test_files_and_gen_witness(test_dir: str, spec, device=None) \
        -> tuple[SyncStepArgs, CommitteeUpdateArgs]:
    """`read_test_files_and_gen_witness` (`test-utils/src/lib.rs:87-131`);
    the committee's pubkeys decompress on `device`."""
    resolve(device)
    bootstrap = load_snappy_ssz(
        os.path.join(test_dir, "bootstrap.ssz_snappy"),
        ssz.light_client_bootstrap(spec))
    meta = read_meta(test_dir)
    gvr = bytes.fromhex(meta["genesis_validators_root"].replace("0x", ""))
    updates = valid_updates_from_test_path(test_dir, spec)
    if not updates:
        # official fixtures may open with force_update steps — Spectre can
        # only prove process_update sequences (reference cuts the same way,
        # `test-utils/src/lib.rs:64-66`)
        raise ValueError(f"no leading process_update steps in {test_dir}")
    update = updates[0]

    step_args = to_sync_circuit_witness(
        spec, bootstrap.current_sync_committee, update, gvr, device=device)

    # rotation witness: NEXT committee proven into the ATTESTED state root;
    # branch[0] = aggregate-pubkey root (sibling of the pubkeys root inside
    # the SyncCommittee container), per `test-utils/src/lib.rs:104-118`
    branch = [bytes48_root(update.next_sync_committee.aggregate_pubkey)]
    branch += list(update.next_sync_committee_branch)
    rotation_args = CommitteeUpdateArgs(
        pubkeys_compressed=list(update.next_sync_committee.pubkeys),
        finalized_header=step_args.attested_header,
        sync_committee_branch=branch)
    return step_args, rotation_args


def get_initial_sync_committee_poseidon(test_dir: str, spec,
                                        device=None) -> tuple[int, int]:
    """(sync_period, poseidon_commitment) from the bootstrap — the contract
    constructor params (`test-utils/src/lib.rs:32-51`); the pubkeys
    decompress on `device`."""
    resolve(device)
    bootstrap = load_snappy_ssz(
        os.path.join(test_dir, "bootstrap.ssz_snappy"),
        ssz.light_client_bootstrap(spec))
    pts = [(bls.Fq(x), bls.Fq(y)) for x, y in g1_decompress_batch(
        list(bootstrap.current_sync_committee.pubkeys), device=device)]
    commitment = PC.committee_poseidon_from_uncompressed(pts)
    period = bootstrap.header.beacon.slot // spec.slots_per_period
    return period, commitment


def verify_witness_branches(spec, step_args: SyncStepArgs,
                            rotation_args: CommitteeUpdateArgs) -> None:
    """Native pre-verification of every Merkle branch in the generated
    witnesses (the preprocessor does the same before proving,
    `preprocessor/src/step.rs:90-120`, `rotation.rs:105-118`)."""
    if not verify_merkle_proof_native(
            step_args.finalized_header.hash_tree_root(),
            step_args.finality_branch,
            spec.finalized_header_index,
            step_args.attested_header.state_root):
        raise ValueError("finality branch invalid")
    if not verify_merkle_proof_native(
            step_args.execution_payload_root,
            step_args.execution_payload_branch,
            spec.execution_state_root_index,
            step_args.finalized_header.body_root):
        raise ValueError("execution branch invalid")
    if not verify_merkle_proof_native(
            rotation_args.committee_pubkeys_root(),
            rotation_args.sync_committee_branch,
            spec.sync_committee_pubkeys_root_index,
            rotation_args.finalized_header.state_root):
        raise ValueError("committee branch invalid")


# ---------------------------------------------------------------------------
# Self-generated fixture in the official format (reference analog:
# `unit_test_gen.rs` builds test_data fixtures; here the output is the
# *pyspec directory layout* so real downloaded fixtures drop in unchanged)
# ---------------------------------------------------------------------------

def _filler(g: int) -> bytes:
    return hashlib.sha256(b"spectre-tpu/spec-test-filler/%d" % g).digest()


class GindexTree:
    """Sparse Merkle tree keyed by generalized index: internal nodes may be
    pinned directly (e.g. a committee root at gindex 55), unassigned
    subtrees fall back to deterministic filler nodes."""

    def __init__(self, assigned: dict[int, bytes]):
        self.assigned = dict(assigned)
        for g in self.assigned:
            for h in self.assigned:
                if g != h:
                    a, b = min(g, h), max(g, h)
                    while b > a:
                        b //= 2
                    if b == a:
                        raise ValueError(
                            f"gindex {min(g, h)} is an ancestor of {max(g, h)}")

    def _has_descendant(self, g: int) -> bool:
        return any(self._is_ancestor(g, k) for k in self.assigned)

    @staticmethod
    def _is_ancestor(anc: int, g: int) -> bool:
        while g > anc:
            g //= 2
        return g == anc

    def node(self, g: int) -> bytes:
        if g in self.assigned:
            return self.assigned[g]
        if self._has_descendant(g):
            return sha256_pair_native(self.node(2 * g), self.node(2 * g + 1))
        return _filler(g)

    def root(self) -> bytes:
        return self.node(1)

    def branch(self, g: int) -> list[bytes]:
        out = []
        while g > 1:
            out.append(self.node(g ^ 1))
            g //= 2
        return out


#: scenario -> description; mirrors the official suite's case shapes
#: (`consensus-specs` light_client/sync tests + `test-utils/src/lib.rs:64-85`
#: cut semantics)
SPEC_TEST_SCENARIOS = {
    "sync": "single happy-path process_update (finality + committee branches)",
    "multi_update": "two sequential process_update steps (updates_0/1); the "
                    "loader must return BOTH in order",
    "force_update_cut": "process_update followed by a force_update step; "
                        "valid_updates_from_test_path must CUT after the "
                        "first update",
    "no_finality": "process_update whose update carries NO finalized header "
                   "(zeroed header + zero branch, the official "
                   "no-finality shape); witness pre-verification must reject",
    "force_update_only": "fixture OPENING with force_update (skipped-period "
                         "shape): no provable prefix, the loader must raise",
}


def generate_spec_test(test_dir: str, spec, seed: int = 7,
                       scenario: str = "sync", device=None) -> None:
    """Write a self-consistent light_client/sync fixture in the official
    pyspec file format. The BLS signature is real (own keys), branches are
    honest paths through sparse state trees. `scenario` selects one of the
    official case shapes (SPEC_TEST_SCENARIOS); the committees' pubkeys
    decompress on `device`."""
    import yaml
    if scenario not in SPEC_TEST_SCENARIOS:
        raise ValueError(scenario)
    resolve(device)

    n = spec.sync_committee_size
    cur_sks = [seed * 7919 + i + 1 for i in range(n)]
    cur_pks = [bls.g1_compress(bls.sk_to_pk(sk)) for sk in cur_sks]
    nxt_pks = [bls.g1_compress(bls.sk_to_pk(seed * 104729 + i + 1))
               for i in range(n)]

    def committee_obj(pks):
        agg = bls.aggregate_pubkeys(
            [(bls.Fq(x), bls.Fq(y))
             for x, y in g1_decompress_batch(list(pks), device=device)])
        return ssz.Obj(pubkeys=list(pks), aggregate_pubkey=bls.g1_compress(agg))

    cur_committee = committee_obj(cur_pks)
    nxt_committee = committee_obj(nxt_pks)
    committee_type = ssz.sync_committee(spec)
    cur_root = committee_type.hash_tree_root(cur_committee)
    nxt_root = committee_type.hash_tree_root(nxt_committee)

    exec_type = ssz.execution_payload_header(
        spec.bytes_per_logs_bloom, spec.max_extra_data_bytes)

    def execution_header(tag: int) -> ssz.Obj:
        return ssz.Obj(
            parent_hash=_filler(1000 + tag), fee_recipient=b"\xee" * 20,
            state_root=_filler(1001 + tag), receipts_root=_filler(1002 + tag),
            logs_bloom=b"\x00" * spec.bytes_per_logs_bloom,
            prev_randao=_filler(1003 + tag), block_number=100 + tag,
            gas_limit=30_000_000, gas_used=21_000, timestamp=1_700_000_000 + tag,
            extra_data=b"spectre-tpu", base_fee_per_gas=7,
            block_hash=_filler(1004 + tag), transactions_root=_filler(1005 + tag),
            withdrawals_root=_filler(1006 + tag))

    def light_client_header(slot: int, proposer: int, tag: int,
                            state_root: bytes) -> ssz.Obj:
        execution = execution_header(tag)
        exec_root = exec_type.hash_tree_root(execution)
        # honest body tree: the execution payload sits at
        # EXECUTION_PAYLOAD gindex (depth 4) inside the block body
        gindex_exec = (1 << spec.execution_state_root_depth) | (
            spec.execution_state_root_index
            & ((1 << spec.execution_state_root_depth) - 1))
        body_tree = GindexTree({gindex_exec: exec_root})
        beacon = ssz.Obj(
            slot=slot, proposer_index=proposer,
            parent_root=_filler(2000 + tag), state_root=state_root,
            body_root=body_tree.root())
        return ssz.Obj(beacon=beacon, execution=execution,
                       execution_branch=body_tree.branch(gindex_exec))

    period_start = 2 * spec.slots_per_period
    gvr = _filler(3)
    domain = ssz.compute_domain(
        ssz.DOMAIN_SYNC_COMMITTEE, _fork_version(spec), gvr)

    def zeroed_light_client_header() -> ssz.Obj:
        """The official no-finality shape: an all-zero LightClientHeader."""
        execution = ssz.Obj(
            parent_hash=b"\x00" * 32, fee_recipient=b"\x00" * 20,
            state_root=b"\x00" * 32, receipts_root=b"\x00" * 32,
            logs_bloom=b"\x00" * spec.bytes_per_logs_bloom,
            prev_randao=b"\x00" * 32, block_number=0, gas_limit=0,
            gas_used=0, timestamp=0, extra_data=b"", base_fee_per_gas=0,
            block_hash=b"\x00" * 32, transactions_root=b"\x00" * 32,
            withdrawals_root=b"\x00" * 32)
        beacon = ssz.Obj(slot=0, proposer_index=0, parent_root=b"\x00" * 32,
                         state_root=b"\x00" * 32, body_root=b"\x00" * 32)
        return ssz.Obj(beacon=beacon, execution=execution,
                       execution_branch=[b"\x00" * 32]
                       * spec.execution_state_root_depth)

    def make_update(slot_off: int, tag_base: int, with_finality: bool = True):
        """One signed LightClientUpdate at period_start+slot_off, with its
        own finalized/attested headers over shared committees. Returns
        (update, artifacts-dict for steps.yaml/bootstrap)."""
        fin_state = GindexTree({spec.sync_committee_root_index - 1: cur_root,
                                spec.sync_committee_root_index: nxt_root})
        finalized = light_client_header(period_start + slot_off - 8, 3,
                                        tag_base, fin_state.root())
        fin_beacon_root = ssz.BEACON_BLOCK_HEADER.hash_tree_root(
            finalized.beacon)
        att_assigned = {
            spec.sync_committee_root_index - 1: cur_root,
            spec.sync_committee_root_index: nxt_root,
        }
        if with_finality:
            att_assigned[spec.finalized_header_index] = fin_beacon_root
        att_state = GindexTree(att_assigned)
        attested = light_client_header(period_start + slot_off, 11,
                                       tag_base + 1, att_state.root())
        att_beacon_root = ssz.BEACON_BLOCK_HEADER.hash_tree_root(
            attested.beacon)
        signing_root = sha256_pair_native(att_beacon_root, domain)
        msg_point = bls.hash_to_g2(signing_root, spec.dst)
        bits = [1] * n
        sig = bls.aggregate_signatures(
            [bls.g2_curve.mul(msg_point, sk)
             for sk, b in zip(cur_sks, bits) if b])
        fin_branch = (att_state.branch(spec.finalized_header_index)
                      if with_finality else
                      [b"\x00" * 32] * spec.finalized_header_depth)
        update = ssz.Obj(
            attested_header=attested,
            next_sync_committee=nxt_committee,
            next_sync_committee_branch=att_state.branch(
                spec.sync_committee_root_index),
            finalized_header=(finalized if with_finality
                              else zeroed_light_client_header()),
            finality_branch=fin_branch,
            sync_aggregate=ssz.Obj(sync_committee_bits=bits,
                                   sync_committee_signature=bls.g2_compress(sig)),
            signature_slot=attested.beacon.slot + 1)
        return update, {
            "finalized": finalized, "fin_state": fin_state,
            "fin_beacon_root": fin_beacon_root,
            "attested": attested, "att_beacon_root": att_beacon_root,
        }

    def process_update_step(idx: int, update: ssz.Obj, art: dict) -> dict:
        fin = update.finalized_header
        return {"process_update": {
            "update_fork_digest": "0x" + _filler(4)[:4].hex(),
            "update": f"updates_{idx}",
            "current_slot": int(art["attested"].beacon.slot + 2),
            "checks": {
                "optimistic_header": {
                    "slot": int(art["attested"].beacon.slot),
                    "beacon_root": "0x" + art["att_beacon_root"].hex(),
                    "execution_root": "0x" + exec_type.hash_tree_root(
                        art["attested"].execution).hex(),
                },
                "finalized_header": {
                    "slot": int(fin.beacon.slot),
                    "beacon_root": "0x" + ssz.BEACON_BLOCK_HEADER
                    .hash_tree_root(fin.beacon).hex(),
                    "execution_root": "0x" + exec_type.hash_tree_root(
                        fin.execution).hex(),
                },
            },
        }}

    def force_update_step(current_slot: int) -> dict:
        # official shape: advance past the update timeout with no
        # process_update (`TestStep::ForceUpdate`, ref test_types)
        return {"force_update": {
            "current_slot": int(current_slot),
            "checks": {},
        }}

    # -- assemble per scenario --
    updates: list = []       # (update, artifacts), files updates_<i>
    steps: list = []
    if scenario == "sync":
        u, a = make_update(16, 0)
        updates, steps = [(u, a)], [process_update_step(0, u, a)]
    elif scenario == "multi_update":
        u0, a0 = make_update(16, 0)
        u1, a1 = make_update(32, 10)
        updates = [(u0, a0), (u1, a1)]
        steps = [process_update_step(0, u0, a0),
                 process_update_step(1, u1, a1)]
    elif scenario == "force_update_cut":
        u, a = make_update(16, 0)
        updates = [(u, a)]
        steps = [process_update_step(0, u, a),
                 force_update_step(a["attested"].beacon.slot
                                   + spec.slots_per_period)]
    elif scenario == "no_finality":
        u, a = make_update(16, 0, with_finality=False)
        updates, steps = [(u, a)], [process_update_step(0, u, a)]
    elif scenario == "force_update_only":
        # a provable update file may exist on disk, but the step sequence
        # OPENS with force_update — nothing for Spectre to prove
        u, a = make_update(16, 0)
        updates = [(u, a)]
        steps = [force_update_step(a["attested"].beacon.slot + 2),
                 process_update_step(0, u, a)]

    # bootstrap anchored at the first update's finalized header (its state
    # tree holds both committees, so the bootstrap branch verifies)
    _, a0 = updates[0]
    bootstrap = ssz.Obj(
        header=a0["finalized"],
        current_sync_committee=cur_committee,
        current_sync_committee_branch=a0["fin_state"].branch(
            spec.sync_committee_root_index - 1))

    os.makedirs(test_dir, exist_ok=True)
    dump_snappy_ssz(os.path.join(test_dir, "bootstrap.ssz_snappy"),
                    ssz.light_client_bootstrap(spec), bootstrap)
    for i, (u, _) in enumerate(updates):
        dump_snappy_ssz(os.path.join(test_dir, f"updates_{i}.ssz_snappy"),
                        ssz.light_client_update(spec), u)
    with open(os.path.join(test_dir, "steps.yaml"), "w") as f:
        yaml.safe_dump(steps, f, sort_keys=False)
    meta = {
        "genesis_validators_root": "0x" + gvr.hex(),
        "trusted_block_root": "0x" + a0["fin_beacon_root"].hex(),
        "bootstrap_fork_digest": "0x" + _filler(4)[:4].hex(),
        "store_fork_digest": "0x" + _filler(4)[:4].hex(),
    }
    with open(os.path.join(test_dir, "meta.yaml"), "w") as f:
        yaml.safe_dump(meta, f, sort_keys=False)


def update_has_finality(step_args: SyncStepArgs) -> bool:
    """False for the official no-finality update shape (zeroed finalized
    header + zero branch): Spectre proves only finalized updates, so
    witness pre-verification is expected to REJECT such witnesses."""
    fh = step_args.finalized_header
    return not (fh.slot == 0 and fh.state_root == b"\x00" * 32
                and all(b == b"\x00" * 32 for b in step_args.finality_branch))
