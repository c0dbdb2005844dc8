"""Finality update -> SyncStepArgs, with native pre-verification (the port's
copy of `spectre_tpu/preprocessor/step.py`; a witness that fails a check
raises ValueError with the reference's message).

Reference parity: `preprocessor/src/step.rs:21-158`
(`step_args_from_finality_update`): decompress committee pubkeys, rebuild the
execution payload root, natively verify BOTH merkle branches and the
aggregate signature before any proving starts — a witness that cannot satisfy
the circuit is rejected here with a real error message instead of a prover
failure. The pubkeys decompress in one batch on `device` (K6 on the card,
`ops/field384.g1_decompress_batch`).
"""

from __future__ import annotations

from ..device import resolve
from ..fields import bls12_381 as bls
from ..gadgets.ssz_merkle import verify_merkle_proof_native
from ..ops.field384 import g1_decompress_batch
from ..utils.profiling import phase
from ..witness.types import BeaconBlockHeader, SyncStepArgs


def _hdr(d: dict) -> BeaconBlockHeader:
    return BeaconBlockHeader(
        slot=int(d["slot"]),
        proposer_index=int(d["proposer_index"]),
        parent_root=_b32(d["parent_root"]),
        state_root=_b32(d["state_root"]),
        body_root=_b32(d["body_root"]),
    )


def _b32(v) -> bytes:
    if isinstance(v, bytes):
        if len(v) != 32:
            raise ValueError(f"expected 32 bytes, got {len(v)}")
        return v
    return bytes.fromhex(v.removeprefix("0x"))


def _bytes(v) -> bytes:
    return v if isinstance(v, bytes) else bytes.fromhex(v.removeprefix("0x"))


def step_args_from_finality_update(update: dict, pubkeys_compressed: list,
                                   domain: bytes, spec, device=None) -> SyncStepArgs:
    """update: parsed LightClientFinalityUpdate-shaped dict with keys
    attested_header, finalized_header, finality_branch, sync_aggregate,
    execution_payload_root, execution_branch. device: where the pubkeys
    decompress (default CUDA; "cpu" runs the plain version)."""
    resolve(device)
    attested = _hdr(update["attested_header"])
    finalized = _hdr(update["finalized_header"])
    fin_branch = [_b32(b) for b in update["finality_branch"]]
    exec_root = _b32(update["execution_payload_root"])
    exec_branch = [_b32(b) for b in update["execution_branch"]]

    # native branch verification (reference `step.rs:90-120`); spanned
    # so `job/preprocess` has real children in getTrace
    with phase("preprocess/verify_branches"):
        if not verify_merkle_proof_native(
                finalized.hash_tree_root(), fin_branch,
                spec.finalized_header_index, attested.state_root):
            raise ValueError("finality branch does not verify")
        if not verify_merkle_proof_native(
                exec_root, exec_branch,
                spec.execution_state_root_index, finalized.body_root):
            raise ValueError("execution branch does not verify")

    bits = _participation_bits(update["sync_aggregate"]["sync_committee_bits"],
                               spec.sync_committee_size)
    with phase("preprocess/decompress_pubkeys"):
        pubkeys = [(bls.Fq(x), bls.Fq(y)) for x, y in
                   g1_decompress_batch([_bytes(pk) for pk in pubkeys_compressed],
                                       device=device)]
    if len(pubkeys) != spec.sync_committee_size:
        raise ValueError(f"{len(pubkeys)} pubkeys for a committee of "
                         f"{spec.sync_committee_size}")

    args = SyncStepArgs(
        signature_compressed=_bytes(
            update["sync_aggregate"]["sync_committee_signature"]),
        pubkeys_uncompressed=[(int(p[0]), int(p[1])) for p in pubkeys],
        participation_bits=bits,
        attested_header=attested,
        finalized_header=finalized,
        finality_branch=fin_branch,
        execution_payload_root=exec_root,
        execution_payload_branch=exec_branch,
        domain=domain,
    )

    # native signature verification (reject before proving)
    with phase("preprocess/verify_signature"):
        participating = [p for p, b in zip(pubkeys, bits) if b]
        sig = bls.g2_decompress(args.signature_compressed)
        if not bls.fast_aggregate_verify(participating, args.signing_root(),
                                         sig, dst=spec.dst):
            raise ValueError("aggregate signature does not verify")
    return args


def _participation_bits(bitfield, n: int) -> list[int]:
    if isinstance(bitfield, list):
        return [int(b) for b in bitfield][:n]
    raw = _bytes(bitfield)
    return [(raw[i // 8] >> (i % 8)) & 1 for i in range(n)]
