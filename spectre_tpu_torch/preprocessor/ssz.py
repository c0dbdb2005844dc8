"""Minimal SSZ codec for the Capella light-client container types (the
port's copy of `spectre_tpu/preprocessor/ssz.py`; malformed input raises
ValueError).

Reference parity: the reference consumes these containers through the
`ssz_rs` crate + `ethereum-consensus-types` fork (SURVEY.md L0) and its
spec-test loader deserializes `bootstrap.ssz_snappy` / `updates_*.ssz_snappy`
(`test-utils/src/lib.rs:87-131`, `test-utils/src/execution_payload_header.rs`).
This module implements just enough of the SSZ spec — basic uints, byte
vectors/lists, bitvectors, vectors of composites, containers with
variable-size members (4-byte offsets) — to encode/decode/hash_tree_root
those exact containers, so the official `consensus-spec-tests` fixture files
load unchanged.

Values are plain Python: ints, bytes, lists, and `Obj` (attribute bag) for
containers.
"""

from __future__ import annotations

from ..gadgets.ssz_merkle import merkleize_chunks_native, sha256_pair_native

BYTES_PER_CHUNK = 32
OFFSET_SIZE = 4


class Obj:
    """Container value: attribute bag with dict-style construction."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def __repr__(self):
        return f"Obj({', '.join(f'{k}={v!r}' for k, v in self.__dict__.items())})"

    def __eq__(self, other):
        return isinstance(other, Obj) and self.__dict__ == other.__dict__


def _pack_bytes(data: bytes) -> list[bytes]:
    """Pack serialized basic values into 32-byte chunks (zero-padded)."""
    if not data:
        return [b"\x00" * BYTES_PER_CHUNK]
    chunks = [data[i:i + BYTES_PER_CHUNK] for i in range(0, len(data), BYTES_PER_CHUNK)]
    chunks[-1] = chunks[-1].ljust(BYTES_PER_CHUNK, b"\x00")
    return chunks


def _mix_in_length(root: bytes, length: int) -> bytes:
    return sha256_pair_native(root, length.to_bytes(32, "little"))


class SSZType:
    is_fixed = True

    def size(self) -> int:            # fixed size in bytes
        raise NotImplementedError

    def encode(self, v) -> bytes:
        raise NotImplementedError

    def decode(self, data: bytes):
        raise NotImplementedError

    def hash_tree_root(self, v) -> bytes:
        raise NotImplementedError


class UintN(SSZType):
    def __init__(self, nbytes: int):
        self.nbytes = nbytes

    def size(self):
        return self.nbytes

    def encode(self, v) -> bytes:
        return int(v).to_bytes(self.nbytes, "little")

    def decode(self, data: bytes):
        if len(data) != self.nbytes:
            raise ValueError(f"uint{self.nbytes * 8} size mismatch")
        return int.from_bytes(data, "little")

    def hash_tree_root(self, v) -> bytes:
        return int(v).to_bytes(self.nbytes, "little").ljust(BYTES_PER_CHUNK, b"\x00")


uint64 = UintN(8)
uint256 = UintN(32)


class ByteVector(SSZType):
    def __init__(self, n: int):
        self.n = n

    def size(self):
        return self.n

    def encode(self, v) -> bytes:
        if len(v) != self.n:
            raise ValueError(f"ByteVector[{self.n}] got {len(v)}")
        return bytes(v)

    def decode(self, data: bytes):
        if len(data) != self.n:
            raise ValueError(f"ByteVector[{self.n}] size mismatch")
        return bytes(data)

    def hash_tree_root(self, v) -> bytes:
        return merkleize_chunks_native(_pack_bytes(bytes(v)))


class ByteList(SSZType):
    is_fixed = False

    def __init__(self, limit: int):
        self.limit = limit

    def encode(self, v) -> bytes:
        if len(v) > self.limit:
            raise ValueError(f"ByteList[{self.limit}] got {len(v)}")
        return bytes(v)

    def decode(self, data: bytes):
        if len(data) > self.limit:
            raise ValueError("ByteList over limit")
        return bytes(data)

    def hash_tree_root(self, v) -> bytes:
        limit_chunks = (self.limit + BYTES_PER_CHUNK - 1) // BYTES_PER_CHUNK
        root = merkleize_chunks_native(_pack_bytes(bytes(v)), limit=limit_chunks)
        return _mix_in_length(root, len(v))


class Bitvector(SSZType):
    """Value is a list of 0/1 ints, length n."""

    def __init__(self, n: int):
        self.n = n

    def size(self):
        return (self.n + 7) // 8

    def encode(self, v) -> bytes:
        if len(v) != self.n:
            raise ValueError(f"Bitvector[{self.n}] got {len(v)}")
        out = bytearray(self.size())
        for i, b in enumerate(v):
            if b:
                out[i // 8] |= 1 << (i % 8)
        return bytes(out)

    def decode(self, data: bytes):
        if len(data) != self.size():
            raise ValueError("Bitvector size mismatch")
        bits = [(data[i // 8] >> (i % 8)) & 1 for i in range(self.n)]
        # excess bits in the final byte must be zero
        for j in range(self.n, len(data) * 8):
            if (data[j // 8] >> (j % 8)) & 1:
                raise ValueError("Bitvector padding bits set")
        return bits

    def hash_tree_root(self, v) -> bytes:
        limit_chunks = (self.size() + BYTES_PER_CHUNK - 1) // BYTES_PER_CHUNK
        return merkleize_chunks_native(_pack_bytes(self.encode(v)), limit=limit_chunks)


class Vector(SSZType):
    """Vector of composite (or basic non-byte) elements."""

    def __init__(self, elem: SSZType, n: int):
        if not elem.is_fixed:
            raise ValueError("variable-size vector elements not needed here")
        self.elem = elem
        self.n = n

    def size(self):
        return self.elem.size() * self.n

    def encode(self, v) -> bytes:
        if len(v) != self.n:
            raise ValueError(f"Vector[{self.n}] got {len(v)}")
        return b"".join(self.elem.encode(x) for x in v)

    def decode(self, data: bytes):
        es = self.elem.size()
        if len(data) != es * self.n:
            raise ValueError("Vector size mismatch")
        return [self.elem.decode(data[i * es:(i + 1) * es]) for i in range(self.n)]

    def hash_tree_root(self, v) -> bytes:
        return merkleize_chunks_native(
            [self.elem.hash_tree_root(x) for x in v], limit=self.n)


class Container(SSZType):
    def __init__(self, name: str, fields: list[tuple[str, SSZType]]):
        self.name = name
        self.fields = fields
        self.is_fixed = all(t.is_fixed for _, t in fields)

    def size(self):
        if not self.is_fixed:
            raise ValueError(f"{self.name}: variable-size container has no fixed size")
        return sum(t.size() for _, t in self.fields)

    def encode(self, v) -> bytes:
        fixed_parts = []
        var_parts = []
        fixed_len = sum(t.size() if t.is_fixed else OFFSET_SIZE
                        for _, t in self.fields)
        offset = fixed_len
        for fname, ftype in self.fields:
            val = getattr(v, fname)
            if ftype.is_fixed:
                fixed_parts.append(ftype.encode(val))
            else:
                enc = ftype.encode(val)
                fixed_parts.append(offset.to_bytes(OFFSET_SIZE, "little"))
                var_parts.append(enc)
                offset += len(enc)
        return b"".join(fixed_parts) + b"".join(var_parts)

    def decode(self, data: bytes):
        if self.is_fixed:
            if len(data) != self.size():
                raise ValueError(f"{self.name}: size mismatch {len(data)} != {self.size()}")
        # pass 1: fixed fields + collect offsets
        pos = 0
        raw: list = []
        offsets: list[int] = []
        for fname, ftype in self.fields:
            if ftype.is_fixed:
                sz = ftype.size()
                raw.append(("fixed", fname, ftype, data[pos:pos + sz]))
                pos += sz
            else:
                off = int.from_bytes(data[pos:pos + OFFSET_SIZE], "little")
                raw.append(("var", fname, ftype, off))
                offsets.append(off)
                pos += OFFSET_SIZE
        if offsets and offsets[0] != pos:
            raise ValueError(f"{self.name}: first offset {offsets} != fixed length {pos}")
        offsets.append(len(data))
        out = Obj()
        vi = 0
        for kind, fname, ftype, payload in raw:
            if kind == "fixed":
                setattr(out, fname, ftype.decode(payload))
            else:
                start, end = offsets[vi], offsets[vi + 1]
                if not start <= end <= len(data):
                    raise ValueError(f"{self.name}: bad offsets")
                setattr(out, fname, ftype.decode(data[start:end]))
                vi += 1
        return out

    def hash_tree_root(self, v) -> bytes:
        return merkleize_chunks_native(
            [ftype.hash_tree_root(getattr(v, fname))
             for fname, ftype in self.fields])


# ---------------------------------------------------------------------------
# Capella light-client containers (ethereum/consensus-specs, capella preset;
# reference types: `ethereum-consensus-types` + `execution_payload_header.rs:13-33`)
# ---------------------------------------------------------------------------

Bytes20 = ByteVector(20)
Bytes32 = ByteVector(32)
Bytes48 = ByteVector(48)
Bytes96 = ByteVector(96)

BEACON_BLOCK_HEADER = Container("BeaconBlockHeader", [
    ("slot", uint64),
    ("proposer_index", uint64),
    ("parent_root", Bytes32),
    ("state_root", Bytes32),
    ("body_root", Bytes32),
])


def execution_payload_header(bytes_per_logs_bloom=256, max_extra_data_bytes=32):
    return Container("ExecutionPayloadHeader", [
        ("parent_hash", Bytes32),
        ("fee_recipient", Bytes20),
        ("state_root", Bytes32),
        ("receipts_root", Bytes32),
        ("logs_bloom", ByteVector(bytes_per_logs_bloom)),
        ("prev_randao", Bytes32),
        ("block_number", uint64),
        ("gas_limit", uint64),
        ("gas_used", uint64),
        ("timestamp", uint64),
        ("extra_data", ByteList(max_extra_data_bytes)),
        ("base_fee_per_gas", uint256),
        ("block_hash", Bytes32),
        ("transactions_root", Bytes32),
        ("withdrawals_root", Bytes32),
    ])


EXECUTION_BRANCH_DEPTH = 4       # floorlog2(EXECUTION_PAYLOAD_INDEX=25)
FINALITY_BRANCH_DEPTH = 6        # floorlog2(FINALIZED_ROOT_INDEX=105)
SYNC_COMMITTEE_BRANCH_DEPTH = 5  # floorlog2(NEXT_SYNC_COMMITTEE_INDEX=55)


def light_client_header(spec):
    return Container("LightClientHeader", [
        ("beacon", BEACON_BLOCK_HEADER),
        ("execution", execution_payload_header(
            spec.bytes_per_logs_bloom, spec.max_extra_data_bytes)),
        ("execution_branch", Vector(Bytes32, EXECUTION_BRANCH_DEPTH)),
    ])


def sync_committee(spec):
    return Container("SyncCommittee", [
        ("pubkeys", Vector(Bytes48, spec.sync_committee_size)),
        ("aggregate_pubkey", Bytes48),
    ])


def light_client_bootstrap(spec):
    return Container("LightClientBootstrap", [
        ("header", light_client_header(spec)),
        ("current_sync_committee", sync_committee(spec)),
        ("current_sync_committee_branch",
         Vector(Bytes32, SYNC_COMMITTEE_BRANCH_DEPTH)),
    ])


def sync_aggregate(spec):
    return Container("SyncAggregate", [
        ("sync_committee_bits", Bitvector(spec.sync_committee_size)),
        ("sync_committee_signature", Bytes96),
    ])


def light_client_update(spec):
    return Container("LightClientUpdate", [
        ("attested_header", light_client_header(spec)),
        ("next_sync_committee", sync_committee(spec)),
        ("next_sync_committee_branch",
         Vector(Bytes32, SYNC_COMMITTEE_BRANCH_DEPTH)),
        ("finalized_header", light_client_header(spec)),
        ("finality_branch", Vector(Bytes32, FINALITY_BRANCH_DEPTH)),
        ("sync_aggregate", sync_aggregate(spec)),
        ("signature_slot", uint64),
    ])


FORK_DATA = Container("ForkData", [
    ("current_version", ByteVector(4)),
    ("genesis_validators_root", Bytes32),
])

DOMAIN_SYNC_COMMITTEE = bytes([7, 0, 0, 0])


def compute_domain(domain_type: bytes, fork_version: bytes,
                   genesis_validators_root: bytes) -> bytes:
    """`compute_domain` per the consensus spec (reference:
    `ethereum_consensus_types::signing::compute_domain`, used at
    `test-utils/src/lib.rs:215-218`)."""
    fork_data_root = FORK_DATA.hash_tree_root(Obj(
        current_version=fork_version,
        genesis_validators_root=genesis_validators_root))
    return domain_type + fork_data_root[:28]
