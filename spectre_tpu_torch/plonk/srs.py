"""KZG structured reference string (powers of tau), with a file cache (the
port's copy of `spectre_tpu/plonk/srs.py`, same tau and same SPTSRS02 file
format, so both packages hold byte-identical parameters).

`unsafe_setup` computes the G1 powers on the device: the powers of tau by
doubling products, then every tau^i G at once by a fixed-base windowed sum
through K2 (64 windows of 4 bits over a host table of d 2^(4j) G), then one
batch normalization to affine.
"""

from __future__ import annotations

import functools
import hashlib
import os

import numpy as np
import torch

from ..device import resolve
from ..fields import bn254
from ..ops import ec, field_ops as F, msm_kernels as MK
from ..utils import artifacts

R = bn254.R

PARAMS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "params")
_WIN = 4
_NWIN = 64          # 64 windows of 4 bits cover 254-bit scalars


@functools.cache
def _fixed_base_table(g) -> list:
    """[d 2^(4j) g for j < 64, d < 16] as one flat host list."""
    g1 = bn254.g1_curve
    table = []
    base = g
    for _ in range(_NWIN):
        row = [None]
        for _ in range(1, 1 << _WIN):
            row.append(g1.add(row[-1], base))
        table.extend(row)
        for _ in range(_WIN):
            base = g1.double(base)
    return table


def g1_powers_device(tau: int, n: int, device) -> torch.Tensor:
    """AoS32 projective points tau^i G for i < n, computed on `device`."""
    fr = F.fr_ctx()
    scal = F.from_mont(fr, F.powers(fr, tau, n, device))       # [n, 4] std
    table = ec.encode_points(_fixed_base_table(bn254.G1_GEN), device)
    acc = ec.inf_aos32(n, device)
    per_limb = 64 // _WIN
    for j in range(_NWIN):
        limb, shift = j // per_limb, _WIN * (j % per_limb)
        digit = (scal[:, limb] >> shift) & ((1 << _WIN) - 1)
        acc = MK.padd_aos32(acc, table[(j << _WIN) + digit].contiguous())
    return acc


class SRS:
    """g1_powers: [n, 8] uint64 affine standard limbs (tau^i G, (0, 0) =
    infinity); g2 elements as host points."""

    def __init__(self, k: int, g1_powers: np.ndarray, g2_gen, g2_tau):
        self.k = k
        self.n = 1 << k
        self.g1_powers = g1_powers
        self.g2_gen = g2_gen
        self.g2_tau = g2_tau
        self._digest = None
        self._bases: dict = {}

    def digest(self) -> str:
        if self._digest is None:
            h = hashlib.blake2b(digest_size=16)
            h.update(b"SPTSRS02")
            h.update(self.k.to_bytes(4, "little"))
            h.update(np.ascontiguousarray(self.g1_powers.astype("<u8")).tobytes())
            self._digest = h.hexdigest()
        return self._digest

    def device_base(self, device=None) -> torch.Tensor:
        """The G1 powers as an AoS32 [n, 24] Montgomery projective tensor
        (the MSM kernels' layout) on `device` (default CUDA), encoded there
        once and cached: an MSM reads a prefix of it as it is."""
        dev = resolve(device)
        key = str(dev)
        if key not in self._bases:
            xy = F.tensor_from_u64(self.g1_powers, dev)
            self._bases[key] = ec.encode_affine_std(xy)
        return self._bases[key]

    @classmethod
    def unsafe_setup(cls, k: int, seed: bytes = b"spectre-tpu-test-srs",
                     device=None) -> "SRS":
        """INSECURE deterministic setup: tau depends on the seed only (not
        k), so a small SRS is a prefix of a large one."""
        dev = resolve(device)
        tau = int.from_bytes(hashlib.sha256(seed).digest() * 2, "big") % R
        pts = g1_powers_device(tau, 1 << k, dev)
        g1p = F.tensor_to_u64(ec.normalize_std(pts))
        srs = cls(k, g1p, bn254.G2_GEN, bn254.g2_curve.mul(bn254.G2_GEN, tau))
        return srs

    @classmethod
    def load_or_setup(cls, k: int, directory: str | None = None,
                      device=None) -> "SRS":
        """The cached `kzg_bn254_<k>.srs`; else the prefix of a larger
        cached one (the powers of one tau), written as the k file; else a
        fresh `unsafe_setup`, written. Fault-injection site `srs.load`."""
        from ..utils import faults
        faults.check("srs.load")
        directory = directory or PARAMS_DIR
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, f"kzg_bn254_{k}.srs")
        if os.path.exists(path):
            return cls.read(path)
        for bigger in range(k + 1, 27):
            bp = os.path.join(directory, f"kzg_bn254_{bigger}.srs")
            if os.path.exists(bp):
                srs = cls.read(bp).truncate(k)
                srs.write(path)
                return srs
        srs = cls.unsafe_setup(k, device=device)
        srs.write(path)
        return srs

    def truncate(self, k: int) -> "SRS":
        """The first 2^k powers (a copy): the SRS of the same tau at k."""
        if k > self.k:
            raise ValueError(f"cannot truncate a 2^{self.k} SRS to 2^{k}")
        return SRS(k, self.g1_powers[:1 << k].copy(), self.g2_gen, self.g2_tau)

    # -- serialization: header || g1 limbs || g2 points (uncompressed BE) --
    def to_bytes(self) -> bytes:
        return (b"SPTSRS02" + self.k.to_bytes(4, "little")
                + self.g1_powers.astype("<u8").tobytes()
                + bn254.g2_to_bytes(self.g2_gen) + bn254.g2_to_bytes(self.g2_tau))

    def write(self, path: str):
        """The file, and its `<path>.sha256` sidecar for `read` to check."""
        raw = self.to_bytes()
        artifacts.atomic_write(path, raw)
        artifacts.write_sidecar(path, raw)

    @classmethod
    def read(cls, path: str) -> "SRS":
        """Raises artifacts.ArtifactCorrupt if the file no longer matches
        its sidecar (a file without one loads as it is)."""
        with open(path, "rb") as f:
            raw = f.read()
        artifacts.verify_sidecar(path, raw)
        if raw[:8] != b"SPTSRS02":
            raise ValueError("bad or stale SRS file")
        k = int.from_bytes(raw[8:12], "little")
        n = 1 << k
        off = 12
        g1 = np.frombuffer(raw[off:off + n * 64], dtype="<u8").reshape(n, 8).astype(np.uint64)
        off += n * 64
        g2_gen = bn254.g2_from_bytes(raw[off:off + 128])
        g2_tau = bn254.g2_from_bytes(raw[off + 128:off + 256])
        return cls(k, g1, g2_gen, g2_tau)
