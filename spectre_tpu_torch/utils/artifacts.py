"""Checksum sidecars for parameter files (the port's copy of the sidecar
helpers of `spectre_tpu/utils/artifacts.py`): `<path>.sha256` holds the
hex SHA-256 of the file, written atomically beside it, and a reader refuses
a file that no longer matches."""

from __future__ import annotations

import hashlib
import os

SIDECAR_SUFFIX = ".sha256"


class ArtifactCorrupt(RuntimeError):
    """A file's bytes do not match its recorded digest."""

    def __init__(self, path: str, expected: str, actual: str):
        super().__init__(
            f"artifact integrity failure: {path} hashes to "
            f"{actual[:16]}…, its sidecar says {expected[:16]}…")
        self.path = path
        self.expected = expected
        self.actual = actual


def sha256_hex(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def atomic_write(path: str, data: bytes):
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def write_sidecar(path: str, data: bytes) -> str:
    """Write `<path>.sha256` for the file `path` whose bytes are `data`;
    returns the hex digest."""
    digest = sha256_hex(data)
    atomic_write(path + SIDECAR_SUFFIX, (digest + "\n").encode())
    return digest


def verify_sidecar(path: str, data: bytes):
    """Check the bytes `data` read from `path` against `<path>.sha256`. A
    missing sidecar is no error (files written before sidecars existed stay
    loadable); a mismatching one raises ArtifactCorrupt."""
    sidecar = path + SIDECAR_SUFFIX
    if not os.path.exists(sidecar):
        return
    with open(sidecar) as f:
        expected = f.read().strip()
    actual = sha256_hex(data)
    if actual != expected:
        raise ArtifactCorrupt(path, expected, actual)
