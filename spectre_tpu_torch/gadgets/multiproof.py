"""Generalized SSZ merkle multiproofs (native/witness side; the port's copy
of `spectre_tpu/gadgets/multiproof.py`, raising ValueError where it asserts).

Reference parity: `witness/multiproof.rs` (the reference vendors ssz-rs
PR#118): generalized-index helper-set computation, multiproof creation from
a full tree, and multi-merkle-root verification. The reference's test-data
generator uses these to derive the finality/execution/committee branches
from a real BeaconState; this module serves the same role for this
framework's preprocessor and fixture tooling.

Generalized indices: root = 1; node i has children 2i, 2i+1. All functions
are pure host math (witness preparation happens before circuits)."""

from __future__ import annotations

import hashlib


def _sha(a: bytes, b: bytes) -> bytes:
    return hashlib.sha256(a + b).digest()


def get_branch_indices(tree_index: int) -> list[int]:
    """Sibling indices along the path to the root (deepest first).
    Reference: `multiproof.rs` get_branch_indices."""
    out = []
    i = tree_index
    while i > 1:
        out.append(i ^ 1)
        i //= 2
    return out


def get_path_indices(tree_index: int) -> list[int]:
    """The node's own path to (excluding) the root, deepest first."""
    out = []
    i = tree_index
    while i > 1:
        out.append(i)
        i //= 2
    return out


def get_helper_indices(indices: list[int]) -> list[int]:
    """Minimal set of extra node indices needed to prove `indices`
    together, sorted descending (reference `multiproof.rs:79`): the union
    of all branch indices minus every index on any path (those are
    recomputed, not supplied)."""
    all_helpers: set[int] = set()
    all_path: set[int] = set()
    for idx in indices:
        all_helpers.update(get_branch_indices(idx))
        all_path.update(get_path_indices(idx))
    return sorted(all_helpers - all_path, reverse=True)


def merkle_tree(leaves: list[bytes]) -> dict[int, bytes]:
    """Full tree {gindex: node} over a power-of-two leaf list
    (reference `multiproof.rs:166`)."""
    n = len(leaves)
    if not n or n & (n - 1):
        raise ValueError("leaf count must be a power of two")
    nodes: dict[int, bytes] = {}
    for i, leaf in enumerate(leaves):
        nodes[n + i] = leaf
    for i in range(n - 1, 0, -1):
        nodes[i] = _sha(nodes[2 * i], nodes[2 * i + 1])
    return nodes


def create_multiproof(tree: dict[int, bytes], indices: list[int]):
    """(leaves, helper nodes) proving `indices` against tree[1]
    (reference `create_multiproof`)."""
    leaves = [tree[i] for i in indices]
    helpers = [tree[i] for i in get_helper_indices(indices)]
    return leaves, helpers


def calculate_multi_merkle_root(leaves: list[bytes], proof: list[bytes],
                                indices: list[int]) -> bytes:
    """Root from (leaves at indices, helper nodes) — reference
    `multiproof.rs:116`. Raises ValueError or KeyError on malformed or
    insufficient proofs."""
    if len(leaves) != len(indices):
        raise ValueError(f"{len(leaves)} leaves for {len(indices)} indices")
    helper_indices = get_helper_indices(indices)
    if len(proof) != len(helper_indices):
        raise ValueError(f"need {len(helper_indices)} helpers, got {len(proof)}")
    objects = dict(zip(indices, leaves))
    objects.update(zip(helper_indices, proof))
    # standard SSZ-spec merge loop: walk keys descending, emit parents as
    # both children appear (appended parents are processed after all deeper
    # nodes, preserving the invariant)
    keys = sorted(objects, reverse=True)
    pos = 0
    while pos < len(keys):
        key = keys[pos]
        if key > 1 and key ^ 1 in objects and key // 2 not in objects:
            objects[key // 2] = _sha(objects[(key | 1) ^ 1],
                                     objects[key | 1])
            keys.append(key // 2)
        pos += 1
    return objects[1]


def verify_multiproof(root: bytes, leaves: list[bytes], proof: list[bytes],
                      indices: list[int]) -> bool:
    try:
        return calculate_multi_merkle_root(leaves, proof, indices) == root
    except (ValueError, KeyError):
        return False
