"""Pippenger MSM over BN254 G1 on the device: signed digits, K1 bucket sums,
K2b weighted aggregation, and the window combine on the host.

The port of the reference's Pallas pipeline (`spectre_tpu/ops/msm.py`
`msm` with SPECTRE_MSM_IMPL=pallas, `msm_pallas.msm_soa`) in its vanilla
signed-digit mode: full 254-bit scalars recoded into digits in
[-2^(c-1)+1, 2^(c-1)], nwin = ceil(255 / c) windows, 2^(c-1) buckets per
window. The GLV and fixed-base modes are later work.
"""

from __future__ import annotations

import torch

from ..fields import bn254
from . import field_ops as F
from . import msm_kernels as MK

SCALAR_BITS = 254

# VMEM the reference's Pallas bucket kernel may spend on resident buckets;
# it sizes the reference's window table, which the port keeps so both
# packages run the same window.
_PALLAS_BUCKET_VMEM_BUDGET = 8 << 20


def default_window(n: int) -> int:
    """The reference's unsigned window table (`msm.default_window`)."""
    if n >= 1 << 18:
        return 13
    if n >= 1 << 12:
        return 10
    if n >= 1 << 7:
        return 7
    return 4


def num_windows(c: int, nbits: int = SCALAR_BITS) -> int:
    """ceil((nbits + 1) / c): room for the signed recode's final carry."""
    return (nbits + c) // c


def default_window_pallas(n: int) -> int:
    """Window of the reference's Pallas path for n 254-bit scalars
    (`msm.default_window_pallas`): the unsigned width for the size class,
    shrunk until the resident buckets fit the reference's VMEM budget."""
    c = default_window(n)
    while c > 1 and num_windows(c) * 48 * (1 << (c - 1)) * 4 > _PALLAS_BUCKET_VMEM_BUDGET:
        c -= 1
    return c


def window_digits(scalars: torch.Tensor, c: int, nwin: int) -> torch.Tensor:
    """Unsigned c-bit windows of standard-form scalars [n, 4] int64 ->
    [nwin, n] int64, lowest window first."""
    h = F._halves(scalars)                            # 8 x [n], < 2^32
    zero = torch.zeros_like(h[0])
    out = []
    for w in range(nwin):
        off = w * c
        k, s = off // 32, off % 32
        lo = h[k] if k < 8 else zero
        hi = h[k + 1] if k + 1 < 8 else zero
        out.append(((lo | (hi << 32)) >> s) & ((1 << c) - 1))
    return torch.stack(out)


def signed_digit_stream(scalars: torch.Tensor, c: int, nwin: int) -> torch.Tensor:
    """[n, 4] standard-form scalars -> [nwin, n] int32 signed digits in
    [-2^(c-1)+1, 2^(c-1)]: a digit above 2^(c-1) becomes d - 2^c with a
    carry of one into the next window (the reference's carry recode)."""
    half = 1 << (c - 1)
    raw = window_digits(scalars, c, nwin)
    carry = torch.zeros_like(raw[0])
    out = []
    for w in range(nwin):
        d = raw[w] + carry
        carry = (d > half).to(torch.int64)
        out.append(d - (carry << c))
    return torch.stack(out).to(torch.int32)


def msm_aos32(points: torch.Tensor, scalars: torch.Tensor, c: int | None = None):
    """points [n, 24] AoS32 Montgomery (the kernels' layout), scalars [n, 4]
    int64 standard form (values < r) -> affine (Fq, Fq) | None. Kernels on a
    CUDA device, their plain versions on the CPU."""
    n = points.shape[0]
    if scalars.shape != (n, 4):
        raise ValueError(f"scalars: expected [{n}, 4], got {tuple(scalars.shape)}")
    c = c or default_window_pallas(n)
    nwin = num_windows(c)
    digits = signed_digit_stream(scalars, c, nwin)
    negs = torch.zeros((1, n), dtype=torch.int32, device=points.device)
    nb = 1 << (c - 1)
    sums = MK.bucket_sums_aos32(points, digits, negs, c)
    return MK.combine_windows(MK.aggregate_buckets_aos32(sums, nwin, nb), c)


def msm_base(base: torch.Tensor, scalars_mont: torch.Tensor, c: int | None = None):
    """Commitment MSM against a device-resident AoS32 base [N, 24] (N >= m,
    `SRS.device_base`): the first m points, no copy or repack."""
    return msm_aos32(base[:scalars_mont.shape[0]], _std(scalars_mont), c)


def _std(scalars_mont: torch.Tensor) -> torch.Tensor:
    return F.from_mont(F.fr_ctx(), scalars_mont.contiguous())


def host_msm(points, scalars):
    """Host oracle: affine points and int scalars -> affine sum."""
    return bn254.g1_curve.msm(points, [int(s) % bn254.R for s in scalars])
