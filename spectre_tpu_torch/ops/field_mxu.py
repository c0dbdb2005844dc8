"""The Montgomery product over 8-bit limbs, its two constant-operand
products as matrix products (the port of `spectre_tpu/ops/field_mxu.py`).

A 256-bit product is a convolution of limb vectors. Over 8-bit limbs every
limb product is below 2^16 and a column of 32 of them below 2^21, so the
convolutions run exactly in 32-bit integer arithmetic. One Montgomery
product a * b * 2^-256 mod p is three of them (separated operand
scanning, the reference's form):

    t  = a * b                       64 columns, carried to 64 limbs
    m  = t_lo * p' mod 2^256         p' = -p^-1 mod 2^256
    u  = (t + m * p) / 2^256         then one conditional subtract (u < 2p)

The second and third convolutions have a constant operand, so each is a
true matrix product: [rows, 32] bytes times a constant Toeplitz matrix of
p' ([32, 32]) or of p ([32, 64]). On the TPU the reference leaves them to
XLA's matrix unit; on the H100 they run on the int8 tensor cores in kernel
K7 (csrc/field_mxu_kernels.cu, `mma.sync` m16n8k32 u8 x u8 -> s32, 16
elements an m-tile, everything in registers: a quad of lanes holds four
elements word-interleaved between the two products); t = a * b has no
shared operand and stays on the integer units there.

The port's field vectors are [..., 4] int64 Montgomery tensors
(field_ops), and their 8-bit limbs are the little-endian bytes of a
contiguous tensor: `_to8` and `_from8` are views, not the reference's
16-bit detour.

`mont_mul_mxu_plain` is K7's plain version (the three convolutions, the
carries and the subtract in elementwise int64 torch ops); `mont_mul` takes
K7 for a CUDA tensor and the plain version for a CPU tensor. It is the
product `field_ops.mont_mul` dispatches to when SPECTRE_FIELD_IMPL=mxu was
set at import or `field_ops.enable_mxu(True)` was called (`enabled` reads
the variable). The helpers `conv_matrix`, `mul_columns` and `_carry8` are
shared with the DFT-matrix short transform of ops/ntt.py.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from . import field_ops as F
from . import kernel_lib as KL

L8 = 32          # 8-bit limbs per 256-bit value
MASK8 = 0xFF


@functools.cache
def conv_matrix(la: int, lb: int, out_cols: int) -> np.ndarray:
    """One-hot [la*lb, out_cols] reduction matrix: (i, j) -> column i + j,
    columns at or above out_cols dropped (the reference's `conv_matrix`,
    the form the contraction takes on a matrix unit)."""
    S = np.zeros((la * lb, out_cols), dtype=np.int32)
    for i in range(la):
        for j in range(lb):
            k = i + j
            if k < out_cols:
                S[i * lb + j, k] = 1
    return S


def _bytes_of(v: int, n: int) -> np.ndarray:
    return np.array([(v >> (8 * i)) & MASK8 for i in range(n)], dtype=np.int32)


class MxuCtx:
    """Per-modulus constants in the 8-bit-limb domain."""

    def __init__(self, ctx: F.FieldCtx):
        self.base = ctx
        p = ctx.p
        self.p8 = _bytes_of(p, L8)
        pinv = (-pow(p, -1, 1 << 256)) % (1 << 256)     # p' = -p^-1 mod R
        self.pinv8 = _bytes_of(pinv, L8)


@functools.cache
def _mxu_ctx(name: str) -> MxuCtx:
    base = {"bn254_fr": F.fr_ctx, "bn254_fq": F.fq_ctx}[name]()
    return MxuCtx(base)


def _to8(a: torch.Tensor) -> torch.Tensor:
    """[..., 4] int64 -> [..., 32] int64 8-bit limbs (the tensor's bytes)."""
    return a.contiguous().view(torch.uint8).to(torch.int64)


def _from8(a8: torch.Tensor) -> torch.Tensor:
    """[..., 32] int64 8-bit limbs (< 2^8) -> [..., 4] int64."""
    return a8.to(torch.uint8).contiguous().view(torch.int64)


def _carry8(t: torch.Tensor, out_limbs: int) -> torch.Tensor:
    """Carry-propagate [..., k] int64 columns into out_limbs 8-bit limbs
    (little-endian), dropping any carry above them (callers size out_limbs
    so that none is left where it matters)."""
    outs, carry = [], torch.zeros_like(t[..., 0])
    for i in range(out_limbs):
        cur = carry + t[..., i] if i < t.shape[-1] else carry
        outs.append(cur & MASK8)
        carry = cur >> 8
    return torch.stack(outs, dim=-1)


def mul_columns(a8: torch.Tensor, b8: torch.Tensor, out_cols: int) -> torch.Tensor:
    """Convolution columns of a8 [..., la] and b8 [..., lb] (or a constant
    [lb]), no carries: [..., out_cols] int64, column k = sum_{i+j=k}
    a8_i b8_j, columns at or above out_cols dropped."""
    la, lb = a8.shape[-1], b8.shape[-1]
    shape = torch.broadcast_shapes(a8.shape[:-1], b8.shape[:-1])
    cols = torch.zeros(shape + (out_cols,), dtype=torch.int64, device=a8.device)
    for i in range(min(la, out_cols)):
        w = min(lb, out_cols - i)
        cols[..., i:i + w] += a8[..., i:i + 1] * b8[..., :w]
    return cols


def _const8(v: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(v.astype(np.int64)).to(device)


def cond_sub_p(ctx: F.FieldCtx, x: torch.Tensor) -> torch.Tensor:
    """x - p if x >= p, for [..., 4] int64 values below 2p."""
    return F._join(F._cond_sub_p_halves(ctx, F._halves(x)))


def redc_columns(ctx: F.FieldCtx, t8: torch.Tensor, pinv8: np.ndarray,
                 p8: np.ndarray) -> torch.Tensor:
    """u = (t + m p) / 2^(8 r) for t given as [..., 32 + r] 8-bit limbs and
    m = t mod 2^(8 r) times p' (r = len(pinv8) limbs of -p^-1 mod 2^(8 r)),
    then one conditional subtract: the canonical t 2^(-8 r) mod p for any
    t < 2^(8 r) p. Returns [..., 4] int64."""
    r = len(pinv8)
    t_lo = t8[..., :r]
    m8 = _carry8(mul_columns(t_lo, _const8(pinv8, t8.device), r), r)
    mp = mul_columns(m8, _const8(p8, t8.device), r + L8)
    # the low r limbs of t + m p are 0 mod 2^(8 r): only their carry into
    # the high half is kept
    low, carry = t_lo + mp[..., :r], torch.zeros_like(t_lo[..., 0])
    for i in range(r):
        carry = (low[..., i] + carry) >> 8
    hi = mp[..., r:] + t8[..., r:r + L8]
    hi[..., 0] += carry
    return cond_sub_p(ctx, _from8(_carry8(hi, L8)))


def mont_mul_mxu_plain(ctx: F.FieldCtx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of K7: a [..., 4] times b [m, 4], b read at i % m (as
    field_ops.mont_mul), by the three 8-bit-limb convolutions."""
    mc = _mxu_ctx(ctx.name)
    flat = a.reshape(-1, 4)
    reps = flat.shape[0] // b.shape[0]
    bb = b.repeat(reps, 1) if reps > 1 else b
    t8 = _carry8(mul_columns(_to8(flat), _to8(bb), 2 * L8), 2 * L8)
    return redc_columns(ctx, t8, mc.pinv8, mc.p8).reshape(a.shape)


def mont_mul(ctx: F.FieldCtx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K7: the Montgomery product a * b * 2^-256 mod p of a [..., 4] and
    b [m, 4] (b read at flat index mod m), Fr or Fq by ctx. The plain
    version for a CPU tensor."""
    b = b.reshape(-1, 4)
    n = a.numel() // 4
    if n % b.shape[0]:
        raise ValueError(f"mont_mul: {b.shape[0]} rows do not tile {n}")
    if a.device != b.device:
        raise ValueError("mont_mul: operands on different devices")
    if not a.is_cuda:
        return mont_mul_mxu_plain(ctx, a, b)
    KL.require(a, "mont_mul_mxu a", torch.int64, last=4)
    KL.require(b, "mont_mul_mxu b", torch.int64, ndim=2, last=4)
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("mont_mul_mxu: operands not 16-byte aligned")
    out = torch.empty_like(a)
    lib = KL.library("field_mxu_kernels")
    KL.KERNELS["K7_mont_mul_mxu"].launches += 1
    rc = lib.spt_mont_mul_mxu(a.data_ptr(), b.data_ptr(), b.shape[0], out.data_ptr(), n,
                              ctx.field_id, KL.stream_of(a))
    KL.check_launch(rc, "K7_mont_mul_mxu")
    return out


def enabled() -> bool:
    """Whether SPECTRE_FIELD_IMPL names this product."""
    return os.environ.get("SPECTRE_FIELD_IMPL") == "mxu"
