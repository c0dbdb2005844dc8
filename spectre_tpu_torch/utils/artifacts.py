"""Integrity-checked artifacts (the port's copy of
`spectre_tpu/utils/artifacts.py`).

* `ArtifactStore`: content-addressed files under `<base>/results/`, the
  sha256 as the name. The job journal records a digest, not the proof
  bytes; every read re-hashes and compares, and a file that no longer
  matches is moved to `quarantine/` (never served, never silently
  deleted) and reported as a typed `ArtifactCorrupt`. Writes are
  crash-atomic: tmp file + flush + fsync + `os.replace` + directory fsync.
  Fault-injection sites `artifact.write` / `artifact.read` (kinds
  `ioerror` and the bytes-mangling `corrupt`), see utils/faults.
* Checksum sidecars for parameter files: `<path>.sha256` holds the hex
  SHA-256 of the file, written atomically beside it, and a reader refuses
  a file that no longer matches.
"""

from __future__ import annotations

import hashlib
import os
import threading

from . import faults
from .health import HEALTH

RESULTS_DIR = "results"
QUARANTINE_DIR = "quarantine"
SIDECAR_SUFFIX = ".sha256"


class ArtifactCorrupt(RuntimeError):
    """An artifact's bytes do not match its recorded digest: raised
    instead of serving poisoned data."""

    def __init__(self, path: str, expected: str, actual: str):
        super().__init__(
            f"artifact integrity failure: {path} hashes to "
            f"{actual[:16]}…, journal/sidecar says {expected[:16]}…")
        self.path = path
        self.expected = expected
        self.actual = actual


def sha256_hex(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _fsync_dir(path: str):
    try:
        dfd = os.open(path or ".", os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass                       # not all filesystems allow dir fsync


def atomic_write(path: str, data: bytes):
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class ArtifactStore:
    """Content-addressed blob store under `<base_dir>/results/`.

    `write` returns the sha256 hex digest (the journal records it);
    `read(digest)` re-verifies and quarantines on mismatch. Thread-safe:
    concurrent writers of the same content converge on the same file."""

    def __init__(self, base_dir: str, health=HEALTH):
        self.dir = os.path.join(base_dir, RESULTS_DIR)
        self.quarantine_dir = os.path.join(self.dir, QUARANTINE_DIR)
        os.makedirs(self.dir, exist_ok=True)
        self.health = health
        self._lock = threading.Lock()

    def path_for(self, digest: str, suffix: str = ".bin") -> str:
        # `suffix` namespaces artifact kinds sharing the store: proof
        # results are `<sha256>.bin`, provenance manifests
        # `<sha256>.manifest.json`
        return os.path.join(self.dir, f"{digest}{suffix}")

    def exists(self, digest: str, suffix: str = ".bin") -> bool:
        return os.path.exists(self.path_for(digest, suffix))

    def write(self, data: bytes, suffix: str = ".bin",
              fault_site: str = "artifact.write") -> str:
        """Atomically persist `data`; returns its sha256 hex digest."""
        faults.check(fault_site)
        digest = sha256_hex(data)
        # corrupt-at-write: the digest records the intended bytes, the disk
        # gets flipped ones — the rot the read-side check catches
        data = faults.mangle(fault_site, data)
        path = self.path_for(digest, suffix)
        with self._lock:
            if not os.path.exists(path):
                atomic_write(path, data)
                _fsync_dir(self.dir)
        return digest

    def read(self, digest: str, suffix: str = ".bin") -> bytes:
        """Load + verify; a digest mismatch quarantines the file and
        raises ArtifactCorrupt instead of serving it."""
        faults.check("artifact.read")
        path = self.path_for(digest, suffix)
        with open(path, "rb") as f:
            data = f.read()
        data = faults.mangle("artifact.read", data)
        actual = sha256_hex(data)
        if actual != digest:
            self._quarantine(path)
            raise ArtifactCorrupt(path, digest, actual)
        return data

    def quarantine_bytes(self, data: bytes, suffix: str = ".bin") -> str:
        """Persist suspect bytes straight into `quarantine/` (named by
        their own sha256) for forensics, never into the served results
        namespace; returns the quarantine digest."""
        digest = sha256_hex(data)
        path = os.path.join(self.quarantine_dir, f"{digest}{suffix}")
        with self._lock:
            os.makedirs(self.quarantine_dir, exist_ok=True)
            if not os.path.exists(path):
                atomic_write(path, data)
        self.health.incr("artifacts_quarantined")
        return digest

    def _quarantine(self, path: str):
        """Move a poisoned file aside and count it."""
        with self._lock:
            os.makedirs(self.quarantine_dir, exist_ok=True)
            try:
                os.replace(path, os.path.join(self.quarantine_dir,
                                              os.path.basename(path)))
            except OSError:
                pass               # already moved by a racing reader
        self.health.incr("artifacts_quarantined")


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
