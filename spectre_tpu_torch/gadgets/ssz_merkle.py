"""SSZ merkleization gadgets (in-circuit) and their host mirrors (the
port's copy of `spectre_tpu/gadgets/ssz_merkle.py`).

`ssz_merkle.rs:27-73` (ssz_merkleize_chunks with zero-hash padding),
`:78-112` (gindex-guided merkle branch verification), ZERO_HASHES (`:114`).
Chunks are 8-word (32-byte) values from a SHA-256 chip.
"""

from __future__ import annotations

import hashlib

from ..builder.context import Context
from ..builder.sha256_chip import Sha256Chip


# -- native mirrors (witness-side; preprocessor uses these too) --------------

def sha256_pair_native(left: bytes, right: bytes) -> bytes:
    return hashlib.sha256(left + right).digest()


def zero_hashes(depth: int) -> list[bytes]:
    out = [b"\x00" * 32]
    for _ in range(depth):
        out.append(sha256_pair_native(out[-1], out[-1]))
    return out


def merkleize_chunks_native(chunks: list[bytes], limit: int | None = None) -> bytes:
    """Binary merkle root with zero-chunk padding up to `limit` leaves."""
    n = limit or max(len(chunks), 1)
    depth = max((n - 1).bit_length(), 0)
    layer = list(chunks)
    zh = zero_hashes(depth)
    for d in range(depth):
        if len(layer) % 2:
            layer.append(zh[d])
        layer = [sha256_pair_native(layer[i], layer[i + 1])
                 for i in range(0, len(layer), 2)]
    return layer[0] if layer else zh[depth]


def verify_merkle_proof_native(leaf: bytes, branch: list[bytes], gindex: int,
                               root: bytes) -> bool:
    node = leaf
    for sib in branch:
        if gindex % 2 == 0:
            node = sha256_pair_native(node, sib)
        else:
            node = sha256_pair_native(sib, node)
        gindex //= 2
    return node == root


# -- in-circuit versions -----------------------------------------------------

def merkleize_chunks(ctx: Context, sha: Sha256Chip, chunks: list, limit: int | None = None):
    """chunks: list of 8-Word lists -> 8-Word root.

    Zero-padding uses in-circuit constants of the precomputed zero-hash levels
    (reference precomputes 2 levels; we precompute all needed)."""
    n = limit or max(len(chunks), 1)
    depth = max((n - 1).bit_length(), 0)
    zh = zero_hashes(depth)

    def const_chunk(b: bytes):
        return [sha.constant_word(ctx, int.from_bytes(b[4 * i:4 * i + 4], "big"))
                for i in range(8)]

    layer = list(chunks)
    for d in range(depth):
        if len(layer) % 2:
            layer.append(const_chunk(zh[d]))
        layer = [sha.digest_two_to_one(ctx, layer[i], layer[i + 1])
                 for i in range(0, len(layer), 2)]
    return layer[0] if layer else const_chunk(zh[depth])


def verify_merkle_proof(ctx: Context, sha: Sha256Chip, leaf: list, branch: list,
                        gindex: int, root: list):
    """Constrain that `leaf` under `branch` at `gindex` hashes to `root`.

    gindex is a circuit-shape constant (reference: `verify_merkle_proof`,
    `ssz_merkle.rs:78` — the gindex comes from the Spec consts); branch items
    are 8-Word lists."""
    node = leaf
    g = gindex
    for sib in branch:
        if g % 2 == 0:
            node = sha.digest_two_to_one(ctx, node, sib)
        else:
            node = sha.digest_two_to_one(ctx, sib, node)
        g //= 2
    for a, b in zip(node, root):
        ctx.constrain_equal(a.cell, b.cell)


def load_bytes_checked(ctx: Context, sha: Sha256Chip, data: bytes) -> list:
    """Witness a byte string as 8-bit-checked cells (the shared loader both
    app circuits use for roots/branches/pubkeys)."""
    out = []
    for bt in data:
        c = ctx.load_witness(bt)
        sha._range_bits(ctx, c, 8)
        out.append(c)
    return out


def bytes_to_chunk(ctx: Context, sha: Sha256Chip, byte_cells: list) -> list:
    """32 byte cells (8-bit checked) -> 8-Word chunk (big-endian words)."""
    if len(byte_cells) != 32:
        raise ValueError("a chunk is 32 bytes")
    return [sha.word_from_bytes_be(ctx, byte_cells[4 * i:4 * i + 4])
            for i in range(8)]


def chunk_to_le_hilo(ctx: Context, gate, chunk: list):
    """8-Word BE chunk -> two 128-bit field values (hi, lo) for public-input
    packing (reference: `util/bytes.rs:7` bytes_be_to_u128)."""
    # words are big-endian; bytes 0..15 -> hi, 16..31 -> lo
    hi = gate.inner_product_const(ctx, [w.cell for w in chunk[:4]],
                                  [1 << 96, 1 << 64, 1 << 32, 1])
    lo = gate.inner_product_const(ctx, [w.cell for w in chunk[4:]],
                                  [1 << 96, 1 << 64, 1 << 32, 1])
    return hi, lo
