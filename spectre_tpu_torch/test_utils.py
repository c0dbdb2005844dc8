"""Test fixtures: deterministic witness generation + loaders (the port's
copy of `spectre_tpu/test_utils.py`).

Reference parity: the `test-utils` crate (spec-test loader,
`test-utils/src/lib.rs:87-131`) and the `unit_test_gen` fixture generator
(`preprocessor/src/unit_test_gen.rs:21-314` — builds `sync_step_512.json` /
`rotation_512.json` from deterministic keys). Here fixtures are generated
from the same default witness builders the circuits use, so any environment
can rebuild them bit-for-bit (seeded, no chain snapshot needed).
"""

from __future__ import annotations

import json
import os

from .witness import default_committee_update_args, default_sync_step_args
from .witness.types import BeaconBlockHeader, CommitteeUpdateArgs, SyncStepArgs


def _hdr_json(h: BeaconBlockHeader) -> dict:
    return {
        "slot": h.slot,
        "proposer_index": h.proposer_index,
        "parent_root": "0x" + h.parent_root.hex(),
        "state_root": "0x" + h.state_root.hex(),
        "body_root": "0x" + h.body_root.hex(),
    }


def _hdr_from(d: dict) -> BeaconBlockHeader:
    return BeaconBlockHeader(
        slot=int(d["slot"]), proposer_index=int(d["proposer_index"]),
        parent_root=bytes.fromhex(d["parent_root"][2:]),
        state_root=bytes.fromhex(d["state_root"][2:]),
        body_root=bytes.fromhex(d["body_root"][2:]))


def dump_step_fixture(args: SyncStepArgs, path: str):
    data = {
        "signature_compressed": "0x" + args.signature_compressed.hex(),
        "pubkeys_uncompressed": [[hex(x), hex(y)] for x, y in args.pubkeys_uncompressed],
        "participation_bits": args.participation_bits,
        "attested_header": _hdr_json(args.attested_header),
        "finalized_header": _hdr_json(args.finalized_header),
        "finality_branch": ["0x" + b.hex() for b in args.finality_branch],
        "execution_payload_root": "0x" + args.execution_payload_root.hex(),
        "execution_payload_branch": ["0x" + b.hex() for b in args.execution_payload_branch],
        "domain": "0x" + args.domain.hex(),
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(data, f, indent=1)


def load_step_fixture(path: str) -> SyncStepArgs:
    with open(path) as f:
        d = json.load(f)
    return SyncStepArgs(
        signature_compressed=bytes.fromhex(d["signature_compressed"][2:]),
        pubkeys_uncompressed=[(int(x, 16), int(y, 16))
                              for x, y in d["pubkeys_uncompressed"]],
        participation_bits=[int(b) for b in d["participation_bits"]],
        attested_header=_hdr_from(d["attested_header"]),
        finalized_header=_hdr_from(d["finalized_header"]),
        finality_branch=[bytes.fromhex(b[2:]) for b in d["finality_branch"]],
        execution_payload_root=bytes.fromhex(d["execution_payload_root"][2:]),
        execution_payload_branch=[bytes.fromhex(b[2:])
                                  for b in d["execution_payload_branch"]],
        domain=bytes.fromhex(d["domain"][2:]))


def load_reference_step_fixture(path: str) -> SyncStepArgs:
    """Load a fixture in the upstream layout (`test_data/sync_step_512.json`,
    produced by `preprocessor/src/unit_test_gen.rs`): byte-array lists for
    signature/branches/domain, hex-string header fields, 96-byte uncompressed
    pubkeys. Used as a blst interop oracle (the signatures were produced by
    the C blst library against the real eth2 ciphersuite)."""
    with open(path) as f:
        d = json.load(f)

    hdr = _hdr_from  # upstream header JSON uses the same hex-field layout
    pks = []
    for raw in d["pubkeys_uncompressed"]:
        b = bytes(raw)
        pks.append((int.from_bytes(b[:48], "big"), int.from_bytes(b[48:], "big")))
    return SyncStepArgs(
        signature_compressed=bytes(d["signature_compressed"]),
        pubkeys_uncompressed=pks,
        participation_bits=[int(bool(b)) for b in d["pariticipation_bits"]],
        attested_header=hdr(d["attested_header"]),
        finalized_header=hdr(d["finalized_header"]),
        finality_branch=[bytes(b) for b in d["finality_branch"]],
        execution_payload_root=bytes(d["execution_payload_root"]),
        execution_payload_branch=[bytes(b) for b in d["execution_payload_branch"]],
        domain=bytes(d["domain"]))


def dump_rotation_fixture(args: CommitteeUpdateArgs, path: str):
    data = {
        "pubkeys_compressed": ["0x" + pk.hex() for pk in args.pubkeys_compressed],
        "finalized_header": _hdr_json(args.finalized_header),
        "sync_committee_branch": ["0x" + b.hex() for b in args.sync_committee_branch],
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(data, f, indent=1)


def load_rotation_fixture(path: str) -> CommitteeUpdateArgs:
    with open(path) as f:
        d = json.load(f)
    return CommitteeUpdateArgs(
        pubkeys_compressed=[bytes.fromhex(pk[2:]) for pk in d["pubkeys_compressed"]],
        finalized_header=_hdr_from(d["finalized_header"]),
        sync_committee_branch=[bytes.fromhex(b[2:])
                               for b in d["sync_committee_branch"]])


def generate_fixtures(spec, directory: str = "test_data", seed: int = 42):
    """Rebuild the deterministic fixture set (reference: `just gen-fixtures`
    analog of `unit_test_gen.rs`)."""
    n = spec.sync_committee_size
    step = default_sync_step_args(spec, seed=seed)
    rot = default_committee_update_args(spec, seed=seed)
    dump_step_fixture(step, os.path.join(directory, f"sync_step_{n}.json"))
    dump_rotation_fixture(rot, os.path.join(directory, f"rotation_{n}.json"))
    return step, rot


# ---------------------------------------------------------------------------
# consensus-spec-test loader (directory layout of ethereum/consensus-specs
# light_client/sync pyspec tests; fixtures must be downloaded separately —
# no network egress in this environment)
# ---------------------------------------------------------------------------

def read_spec_test_steps(test_dir: str):
    """Parse `steps.yaml` of a light_client/sync pyspec test into a list of
    (kind, payload) tuples (reference `test-utils/src/lib.rs:87-131` +
    `test_types.rs`). The full fixture pipeline (ssz_snappy containers ->
    circuit witnesses) lives in `preprocessor.spec_tests`; this wrapper is
    kept for step-sequence consumers."""
    from .preprocessor.spec_tests import read_steps

    out = []
    for step in read_steps(test_dir):
        if "process_update" in step:
            out.append(("process_update", step["process_update"]))
        elif "force_update" in step:
            out.append(("force_update", step["force_update"]))
    return out


def mesh_prove_fixture(k: int = 13, device=None):
    """Deterministic circuit, key and assignment for the mesh prove's byte
    check: a prove on a sharding plan must give the bytes of the prove on
    one device under the same seeded blinding. 1500 range-checked
    witnesses summed into one public output (the reference's fixture, at
    its k). Returns (srs, pk, assignment), keyed on `device`."""
    from .builder.context import Context
    from .builder.gate import GateChip
    from .builder.range_chip import RangeChip
    from .plonk.keygen import keygen
    from .plonk.srs import SRS

    ctx = Context()
    gate = GateChip()
    rng = RangeChip(8, gate)
    acc = ctx.load_zero()
    for i in range(1500):
        v = ctx.load_witness((i * 7 + 3) % 251)
        rng.range_check(ctx, v, 8)
        acc = gate.add(ctx, acc, v)
    ctx.expose_public(acc)
    cfg = ctx.auto_config(k=k, lookup_bits=8)
    asg = ctx.assignment(cfg)
    srs = SRS.load_or_setup(k, device=device)
    pk = keygen(srs, cfg, asg.fixed, asg.selectors, asg.copies, device=device)
    return srs, pk, asg


def seeded_blinding_rng(seed: int = 12345):
    """Deterministic stand-in for the ZK blinding source: makes a proof a
    pure function of (pk, witness, transcript) so backend/mesh byte-equality
    is checkable. NEVER use in production proving."""
    state = [seed]

    def rng():
        state[0] += 1
        return (state[0] * 0x9E3779B97F4A7C15) % (2**61 - 1)

    return rng
