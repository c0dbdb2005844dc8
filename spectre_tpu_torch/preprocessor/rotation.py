"""Committee update -> CommitteeUpdateArgs, with native pre-verification (the
port's copy of `spectre_tpu/preprocessor/rotation.py`; a failed check
raises ValueError with the reference's message).

Reference parity: `preprocessor/src/rotation.rs:18-106`
(`rotation_args_from_update`), including the committee-branch construction
that proves the pubkeys list root inside the finalized state
(`lib.rs:262-267` — the branch is extended by the aggregate-pubkey sibling so
the PUBKEYS root, not the SyncCommittee container root, is the proven leaf).
Host work only: the pubkeys stay compressed.
"""

from __future__ import annotations

from ..gadgets.ssz_merkle import verify_merkle_proof_native
from ..utils.profiling import phase
from ..witness.types import CommitteeUpdateArgs, bytes48_root
from .step import _b32, _bytes, _hdr


def rotation_args_from_update(update: dict, spec) -> CommitteeUpdateArgs:
    """update keys: finalized_header, next_sync_committee {pubkeys,
    aggregate_pubkey}, next_sync_committee_branch."""
    finalized = _hdr(update["finalized_header"])
    pubkeys = [_bytes(pk) for pk in update["next_sync_committee"]["pubkeys"]]
    if len(pubkeys) != spec.sync_committee_size:
        raise ValueError(f"{len(pubkeys)} pubkeys for a committee of "
                         f"{spec.sync_committee_size}")
    branch = [_b32(b) for b in update["next_sync_committee_branch"]]

    # the chain's branch proves the SyncCommittee container root at
    # SYNC_COMMITTEE_ROOT_INDEX; extend it with the aggregate-pubkey sibling so
    # the leaf becomes the pubkeys list root at SYNC_COMMITTEE_PUBKEYS_ROOT_INDEX
    # (reference "magic swap", `preprocessor/src/lib.rs:262-267`)
    if len(branch) == spec.sync_committee_depth:
        agg_root = bytes48_root(_bytes(
            update["next_sync_committee"]["aggregate_pubkey"]))
        branch = [agg_root] + branch

    args = CommitteeUpdateArgs(
        pubkeys_compressed=pubkeys,
        finalized_header=finalized,
        sync_committee_branch=branch,
    )
    # spanned: hashing 512 pubkeys into the committee root is the dominant
    # cost here and belongs under job/preprocess in traces
    with phase("preprocess/verify_branches"):
        if not verify_merkle_proof_native(
                args.committee_pubkeys_root(), branch,
                spec.sync_committee_pubkeys_root_index, finalized.state_root):
            raise ValueError("sync committee branch does not verify")
    return args
