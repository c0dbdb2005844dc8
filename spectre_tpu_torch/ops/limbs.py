"""Host-side conversion between Python ints and limb arrays.

Two host formats, both little-endian:
  * 16-bit limbs, [n, 16] (the reference's device wire format; the public
    SoA layout of the EC kernels keeps it);
  * 64-bit limbs, [n, 4] uint64 (the reference's host array format).
On the device the port stores field vectors as [n, 4] int64 tensors holding
the uint64 bit patterns, so a numpy [n, 4] uint64 array crosses with a
zero-copy `view(np.int64)`.
"""

from __future__ import annotations

import numpy as np

NLIMBS = 16
LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1


def ints_to_limbs16(vals) -> np.ndarray:
    """Iterable of ints -> [n, 16] uint32 (16-bit limbs, little-endian)."""
    return u64limbs_to_u16limbs(ints_to_limbs(vals))


def int_to_limbs16(v: int) -> np.ndarray:
    return ints_to_limbs16([v])[0]


def ints_to_limbs(vals, nlimbs: int = 4) -> np.ndarray:
    """list[int] -> [n, nlimbs] uint64 little-endian limb array."""
    nbytes = 8 * nlimbs
    buf = b"".join(int(v).to_bytes(nbytes, "little") for v in vals)
    return np.frombuffer(buf, dtype="<u8").reshape(-1, nlimbs).astype(
        np.uint64, copy=True)


def limbs_to_ints(arr: np.ndarray) -> list[int]:
    """[n, nl] uint64 limb array -> list of ints."""
    arr = np.ascontiguousarray(arr).view(np.uint64)
    n, nl = arr.shape
    buf = arr.astype("<u8", copy=False).tobytes()
    w = 8 * nl
    return [int.from_bytes(buf[i * w:(i + 1) * w], "little") for i in range(n)]


def u64limbs_to_u16limbs(arr: np.ndarray) -> np.ndarray:
    """[n, 4] uint64 -> [n, 16] uint32 16-bit limbs."""
    arr = np.ascontiguousarray(arr, dtype=np.uint64)
    return arr.astype("<u8").view("<u2").reshape(arr.shape[0], NLIMBS).astype(
        np.uint32)


def u16limbs_to_u64limbs(arr: np.ndarray) -> np.ndarray:
    """[n, 16] 16-bit limbs -> [n, 4] uint64."""
    arr = np.ascontiguousarray(arr, dtype=np.uint64) & np.uint64(LIMB_MASK)
    packed = np.ascontiguousarray(arr.astype("<u2"))
    return packed.view("<u8").reshape(arr.shape[0], 4).astype(np.uint64)
