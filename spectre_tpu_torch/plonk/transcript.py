"""Fiat-Shamir transcript (the port's copy of the Blake2b transcript of
`spectre_tpu/plonk/transcript.py`; the Poseidon and Keccak transcripts wait
for the aggregation slice).

Proof stream format: every absorbed object is appended verbatim; the
verifier re-absorbs as it reads, so challenges are recomputed identically.
"""

from __future__ import annotations

import hashlib

from ..fields import bn254

R = bn254.R


class Blake2bTranscript:
    """Absorb/squeeze transcript + proof stream reader/writer."""

    def __init__(self, proof: bytes | None = None):
        self._state = hashlib.blake2b(b"spectre-tpu-transcript-v1", digest_size=64)
        self._proof = bytearray() if proof is None else None
        self._read_buf = proof
        self._read_pos = 0
        self._counter = 0

    def _absorb_bytes(self, b: bytes):
        self._state.update(b)

    def _squeeze_bytes(self) -> bytes:
        return self._state.copy().digest()

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
