"""Fiat-Shamir transcripts: Blake2b (native proofs), Poseidon (proofs bound
for in-circuit aggregation) and Keccak256 (the EVM path) — the port's copy
of `spectre_tpu/plonk/transcript.py`.

Proof stream format: every absorbed object is appended verbatim; the
verifier re-absorbs as it reads, so challenges are recomputed identically.
The three transcripts share the byte framing (`_TranscriptBase`) and differ
only in how challenges are derived.
"""

from __future__ import annotations

import hashlib

from ..fields import bn254
from ..ops import poseidon

R = bn254.R

_KECCAK_RC = (
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008)
_KECCAK_ROT = ((0, 36, 3, 41, 18), (1, 44, 10, 45, 2), (62, 6, 43, 15, 61),
               (28, 55, 25, 21, 56), (27, 20, 39, 8, 14))
_M64 = (1 << 64) - 1


def _keccak_f1600(state: list[int]) -> list[int]:
    """Keccak-f[1600] permutation on 25 lanes of 64 bits."""

    def rol(v, s):
        return ((v << s) | (v >> (64 - s))) & _M64

    a = state
    for rc in _KECCAK_RC:
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ rol(c[(x + 1) % 5], 1) for x in range(5)]
        a = [a[x + 5 * y] ^ d[x] for y in range(5) for x in range(5)]
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = rol(a[x + 5 * y], _KECCAK_ROT[x][y])
        a = [b[x + 5 * y] ^ ((~b[(x + 1) % 5 + 5 * y] & _M64) & b[(x + 2) % 5 + 5 * y])
             for y in range(5) for x in range(5)]
        a[0] ^= rc
    return a


def keccak256(data: bytes) -> bytes:
    """Keccak-256 (pre-NIST padding 0x01), as Ethereum uses it."""
    rate = 136
    state = [0] * 25
    msg = bytearray(data)
    msg.append(0x01)
    while len(msg) % rate:
        msg.append(0)
    msg[-1] |= 0x80
    for off in range(0, len(msg), rate):
        block = msg[off:off + rate]
        for i in range(rate // 8):
            state[i] ^= int.from_bytes(block[8 * i:8 * i + 8], "little")
        state = _keccak_f1600(state)
    return b"".join(state[i].to_bytes(8, "little") for i in range(4))


class _TranscriptBase:
    """Absorb/squeeze transcript + proof stream reader/writer. A subclass
    gives `_init_state`, `_absorb_bytes` and `_squeeze_bytes` (or its own
    `challenge`)."""

    def __init__(self, proof: bytes | None = None):
        self._state = self._init_state()
        self._proof = bytearray() if proof is None else None
        self._read_buf = proof
        self._read_pos = 0
        self._counter = 0

    def _init_state(self):
        raise NotImplementedError

    def _absorb_bytes(self, b: bytes):
        raise NotImplementedError

    def _squeeze_bytes(self) -> bytes:
        raise NotImplementedError

    # -- absorb (write side also appends to the proof stream) --
    def common_point(self, pt):
        self._absorb_bytes(b"P" + bn254.g1_to_bytes(pt))

    def common_scalar(self, v: int):
        self._absorb_bytes(b"S" + (int(v) % R).to_bytes(32, "big"))

    def write_point(self, pt):
        self.common_point(pt)
        self._proof += bn254.g1_to_bytes(pt)

    def write_scalar(self, v: int):
        self.common_scalar(v)
        self._proof += (int(v) % R).to_bytes(32, "big")

    def read_point(self):
        pt = bn254.g1_from_bytes(self._take(64))
        self.common_point(pt)
        return pt

    def read_scalar(self) -> int:
        v = int.from_bytes(self._take(32), "big")
        if v >= R:
            raise ValueError("non-canonical scalar in proof")
        self.common_scalar(v)
        return v

    def _take(self, n: int) -> bytes:
        if self._read_buf is None:
            raise ValueError("read on a write transcript")
        if self._read_pos + n > len(self._read_buf):
            raise ValueError("proof too short")
        out = self._read_buf[self._read_pos:self._read_pos + n]
        self._read_pos += n
        return out

    def finalize(self) -> bytes:
        if self._proof is None:
            raise ValueError("finalize on a read transcript")
        return bytes(self._proof)

    def assert_consumed(self):
        if self._read_buf is None or self._read_pos != len(self._read_buf):
            raise ValueError("proof has trailing bytes")

    # -- squeeze --
    def challenge(self) -> int:
        self._counter += 1
        self._absorb_bytes(b"C" + self._counter.to_bytes(4, "big"))
        return int.from_bytes(self._squeeze_bytes(), "big") % R


class Blake2bTranscript(_TranscriptBase):
    def _init_state(self):
        return hashlib.blake2b(b"spectre-tpu-transcript-v1", digest_size=64)

    def _absorb_bytes(self, b: bytes):
        self._state.update(b)

    def _squeeze_bytes(self) -> bytes:
        return self._state.copy().digest()


ACC_LIMB_BITS = 88
ACC_LIMBS = 3  # per coordinate; snark-verifier LimbsEncoding<3, 88>


def point_to_transcript_elements(pt) -> list[int]:
    """G1 point -> 6 field elements (3 x 88-bit limbs per coordinate), the
    encoding the aggregation circuit witnesses, so the in-circuit
    transcript absorbs exactly the cells its MSM operates on."""
    out = []
    for coord in (int(pt[0]), int(pt[1])):
        for i in range(ACC_LIMBS):
            out.append((coord >> (ACC_LIMB_BITS * i)) & ((1 << ACC_LIMB_BITS) - 1))
    return out


class PoseidonTranscript(_TranscriptBase):
    """Algebraic Fiat-Shamir over Fr: a Poseidon duplex sponge, T=3,
    RATE=2, R_F=8, R_P=57 (snark-verifier's `PoseidonTranscript`, the
    transcript of snarks bound for in-circuit aggregation: one permutation
    per RATE absorbed elements). The proof bytes are framed as in the other
    transcripts; only challenge derivation differs. Byte absorbs (the vk
    digest) go in as 16-byte big-endian chunks; a counter element precedes
    each squeeze. `builder.transcript_chip.TranscriptChip` is its
    cell-for-cell mirror."""

    T = 3
    RATE = 2
    R_F = 8
    R_P = 57

    def _init_state(self):
        self._pending: list[int] = []
        return [0] * self.T

    def _absorb_bytes(self, b: bytes):
        for off in range(0, len(b), 16):
            self._pending.append(int.from_bytes(b[off:off + 16], "big"))

    def common_point(self, pt):
        self._pending.extend(point_to_transcript_elements(pt))

    def common_scalar(self, v: int):
        self._pending.append(int(v) % R)

    def challenge(self) -> int:
        self._counter += 1
        self._pending.append(self._counter)
        state = self._state
        pend = self._pending
        for off in range(0, len(pend), self.RATE):
            chunk = pend[off:off + self.RATE]
            state = ([state[0]]
                     + [(state[1 + i] + v) % R for i, v in enumerate(chunk)]
                     + state[1 + len(chunk):])
            state = poseidon.permute_native(state, t=self.T, r_f=self.R_F, r_p=self.R_P)
        self._pending = []
        self._state = state
        return state[1]


class KeccakTranscript(_TranscriptBase):
    """Keccak-backed transcript for the EVM verification path: the state is
    a rolling hash h = keccak(h || absorbed), squeezed to 64 bytes."""

    def _init_state(self):
        self._buffer = b""
        return keccak256(b"spectre-tpu-transcript-v1")

    def _absorb_bytes(self, b: bytes):
        self._buffer += b

    def _squeeze_bytes(self) -> bytes:
        self._state = keccak256(self._state + self._buffer)
        self._buffer = b""
        return self._state + keccak256(self._state)
