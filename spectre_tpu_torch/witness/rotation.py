"""Default (mock-rooted) CommitteeUpdateArgs (the port's copy of
`spectre_tpu/witness/rotation.py`).

`witness/rotation.rs:28-94`: deterministic pubkeys and a fabricated merkle
branch (`mock_root`): the state root is computed from the committee leaf
and an arbitrary branch, so the witness is self-consistent without chain
data.
"""

from __future__ import annotations

from ..fields import bls12_381 as bls
from ..gadgets.ssz_merkle import sha256_pair_native
from .types import BeaconBlockHeader, CommitteeUpdateArgs


def mock_root(leaf: bytes, branch: list[bytes], gindex: int) -> bytes:
    """Fold leaf up the branch to produce a consistent root (reference
    `witness/rotation.rs:77-94`)."""
    node = leaf
    g = gindex
    for sib in branch:
        node = sha256_pair_native(node, sib) if g % 2 == 0 \
            else sha256_pair_native(sib, node)
        g //= 2
    return node


def default_committee_update_args(spec, seed: int = 42) -> CommitteeUpdateArgs:
    n = spec.sync_committee_size
    pubkeys = [bls.g1_compress(bls.sk_to_pk(seed + i + 1)) for i in range(n)]
    args = CommitteeUpdateArgs(pubkeys_compressed=pubkeys)

    depth = spec.sync_committee_pubkeys_depth
    gindex = spec.sync_committee_pubkeys_root_index
    branch = [bytes([d]) * 32 for d in range(depth)]
    state_root = mock_root(args.committee_pubkeys_root(), branch, gindex)
    args.sync_committee_branch = branch
    args.finalized_header = BeaconBlockHeader(
        slot=spec.slots_per_period * 2 + 1,
        proposer_index=7,
        parent_root=b"\x11" * 32,
        state_root=state_root,
        body_root=b"\x22" * 32,
    )
    return args
