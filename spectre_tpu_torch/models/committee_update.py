"""CommitteeUpdateCircuit: map the next sync committee to its commitments
(the port's copy of `spectre_tpu/models/committee_update.py`).

`committee_update_circuit.rs`: the in-circuit logic
(`assign_virtual:50`): SSZ root of the compressed pubkey list, X-coordinate
decode (`decode_pubkeys_x:129`), Poseidon commitment, finalized-header SSZ
root, committee-branch merkle proof against the finalized STATE root; public
outputs [poseidon_commit, header_root_lo, header_root_hi]
(`get_instances:198`).
"""

from __future__ import annotations

from ..builder import Context, GateChip
from ..builder.poseidon_chip import PoseidonChip
from ..builder.sha256_wide_chip import Sha256WideChip
from ..fields import bls12_381 as bls, bn254
from ..gadgets import poseidon_commit as PC
from ..gadgets import ssz_merkle as M
from ..spec import NUM_LIMBS
from ..witness.types import CommitteeUpdateArgs
from .app_circuit import AppCircuit

R = bn254.R


class CommitteeUpdateCircuit(AppCircuit):
    name = "committee_update"

    @classmethod
    def build(cls, ctx: Context, args: CommitteeUpdateArgs, spec):
        """Hashing runs on the wide-region chip (reference uses the zkevm
        wide SHA here for the same reason: this circuit is hash-dominated,
        `committee_update_circuit.rs:50` + `sha256_wide.rs`)."""
        gate = GateChip()
        sha = Sha256WideChip(gate)
        poseidon = PoseidonChip(gate)
        n = spec.sync_committee_size
        if len(args.pubkeys_compressed) != n:
            raise ValueError(f"expected {n} pubkeys")

        # load pubkey bytes (8-bit checked once; reused by SSZ + decode)
        pubkey_bytes = []
        for pk in args.pubkeys_compressed:
            if len(pk) != 48:
                raise ValueError("a compressed pubkey is 48 bytes")
            pubkey_bytes.append(M.load_bytes_checked(ctx, sha, pk))

        # --- committee pubkeys SSZ root (leaf = sha256(pk padded to 64)) ---
        zero = ctx.load_constant(0)
        leaves = []
        for cells in pubkey_bytes:
            padded = cells + [zero] * 16
            leaves.append(sha.digest_bytes(ctx, padded))
        committee_root = M.merkleize_chunks(ctx, sha, leaves)

        # --- decode X coordinates + y signs; Poseidon commitment ---
        limbs_list, sign_cells = [], []
        for cells in pubkey_bytes:
            flag_byte = cells[0]  # big-endian first byte carries the 3 flags
            bits = gate.num_to_bits(ctx, flag_byte, 8)
            cleared = gate.bits_to_num(ctx, bits[:5])
            y_sign = bits[5]
            le_bytes = list(reversed(cells[1:])) + [cleared]  # little-endian X
            limbs = []
            for i in range(NUM_LIMBS):
                chunk = le_bytes[13 * i:13 * i + 13]
                if chunk:
                    limbs.append(gate.inner_product_const(
                        ctx, chunk, [1 << (8 * j) for j in range(len(chunk))]))
                else:
                    limbs.append(ctx.load_constant(0))
            limbs_list.append(limbs)
            sign_cells.append(y_sign)
        poseidon_commit = PC.g1_array_poseidon(ctx, gate, poseidon,
                                               limbs_list, sign_cells)

        # --- finalized header SSZ root ---
        def uint64_chunk_cells(v: int):
            cells = M.load_bytes_checked(ctx, sha, int(v).to_bytes(8, "little"))
            return cells + [zero] * 24

        def root_chunk_cells(b: bytes):
            return M.load_bytes_checked(ctx, sha, b)

        hdr = args.finalized_header
        state_root_cells = root_chunk_cells(hdr.state_root)
        header_chunks = [
            M.bytes_to_chunk(ctx, sha, uint64_chunk_cells(hdr.slot)),
            M.bytes_to_chunk(ctx, sha, uint64_chunk_cells(hdr.proposer_index)),
            M.bytes_to_chunk(ctx, sha, root_chunk_cells(hdr.parent_root)),
            M.bytes_to_chunk(ctx, sha, state_root_cells),
            M.bytes_to_chunk(ctx, sha, root_chunk_cells(hdr.body_root)),
        ]
        header_root = M.merkleize_chunks(ctx, sha, header_chunks, limit=8)

        # --- committee branch against the finalized state root ---
        branch = [M.bytes_to_chunk(ctx, sha, root_chunk_cells(b))
                  for b in args.sync_committee_branch]
        state_chunk = M.bytes_to_chunk(ctx, sha, state_root_cells)
        M.verify_merkle_proof(ctx, sha, committee_root, branch,
                              spec.sync_committee_pubkeys_root_index, state_chunk)

        # --- public inputs: [poseidon, header_root_lo, header_root_hi] ---
        hi, lo = M.chunk_to_le_hilo(ctx, gate, header_root)
        ctx.expose_public(poseidon_commit)
        ctx.expose_public(lo)
        ctx.expose_public(hi)
        return [poseidon_commit, lo, hi]

    @classmethod
    def get_instances(cls, args: CommitteeUpdateArgs, spec) -> list:
        """The public inputs computed on the host (reference
        `get_instances:198`). The pubkeys decompress one by one with
        `bls12_381.g1_decompress`, which the reference's batched device
        decompress equals key for key."""
        pts = [bls.g1_decompress(b) for b in args.pubkeys_compressed]
        poseidon = PC.committee_poseidon_from_uncompressed(pts)
        root = args.finalized_header.hash_tree_root()
        lo = int.from_bytes(root[16:], "big")
        hi = int.from_bytes(root[:16], "big")
        return [poseidon, lo, hi]
