"""Montgomery arithmetic over BN254's Fr and Fq on torch tensors.

A field vector is an int64 tensor [..., 4]: four little-endian 64-bit limbs
holding the uint64 bit patterns of a value in Montgomery form with radix
R = 2^256, the radix of the JAX reference (`spectre_tpu/ops/field_ops.py`),
so both packages hold the same Montgomery values: the reference's 16 x 16-bit
limbs are this tensor's bytes.

Addition and subtraction are PyTorch ops on any device (the values are split
into 32-bit halves held in int64, so no op overflows or needs an unsigned
type). The Montgomery product is kernel K3 on a CUDA tensor and its plain
version on a CPU tensor: the reference's 16-round CIOS over 16-bit limbs in
int64, one Python loop iteration per limb.

K3 (csrc/field_kernels.cu, `mont_mul_kernel`): one thread per element, 8 x
32-bit limbs with 64-bit products, CIOS (8 rounds). The JAX package has no
Pallas kernel here (its product is XLA code); the port adds K3 because the
product chains of the NTT, the grand products and the quotient at 2^23 rows
are out of reach of plain tensor ops. Bound on the H100: memory. A product
is 257 32-bit multiply-adds against 96 bytes (two operands read, one
written), 2.7 per byte, below the card's 5 per byte (16.75 T/s over
3.35 TB/s); the design keeps every intermediate in registers so nothing but
those 96 bytes crosses to memory.

`mont_mul` dispatches, as the reference's does (`ops/field_ops.py:172`):
K3 by default, the 8-bit-limb product of ops/field_mxu.py (K7, its
constant-operand products on the tensor cores) when SPECTRE_FIELD_IMPL=mxu
was set at import or `enable_mxu(True)` was called. Both fields go
through it, and both products give the same canonical values.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from ..fields import bn254
from . import kernel_lib as KL
from . import limbs as L

NLIMBS = 16
MASK16 = 0xFFFF
MASK32 = 0xFFFFFFFF
FQ_ID, FR_ID = 0, 1       # field ids of the CUDA kernels (csrc/bn254.cuh)


class FieldCtx:
    """Per-modulus constants."""

    def __init__(self, p: int, name: str, field_id: int):
        self.p = p
        self.name = name
        self.field_id = field_id
        self.p_limbs = L.int_to_limbs16(p)
        self.n0inv16 = (-pow(p, -1, 1 << 16)) % (1 << 16)
        self.n0inv32 = (-pow(p, -1, 1 << 32)) % (1 << 32)
        self.r_mod_p = (1 << 256) % p
        self.r_inv = pow(self.r_mod_p, -1, p)
        self.r2 = self.r_mod_p * self.r_mod_p % p
        self.one_mont = L.int_to_limbs16(self.r_mod_p)

    # -- host encode/decode (numpy [n, 4] uint64 Montgomery limbs) --
    def encode(self, vals) -> np.ndarray:
        r, p = self.r_mod_p, self.p
        return L.ints_to_limbs([(int(v) % p) * r % p for v in vals])

    def decode(self, arr) -> list[int]:
        rinv, p = self.r_inv, self.p
        return [v * rinv % p for v in L.limbs_to_ints(np.asarray(arr))]


@functools.cache
def fr_ctx() -> FieldCtx:
    return FieldCtx(bn254.R, "bn254_fr", FR_ID)


@functools.cache
def fq_ctx() -> FieldCtx:
    return FieldCtx(bn254.P, "bn254_fq", FQ_ID)


# ---------------------------------------------------------------------------
# host <-> tensor
# ---------------------------------------------------------------------------

def tensor_from_u64(arr: np.ndarray, device) -> torch.Tensor:
    """numpy [..., 4] uint64 -> int64 tensor with the same bit patterns."""
    arr = np.ascontiguousarray(arr, dtype=np.uint64)
    return torch.from_numpy(arr.view(np.int64)).to(device)


def tensor_to_u64(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().contiguous().numpy().view(np.uint64)


def const(ctx: FieldCtx, v: int, device) -> torch.Tensor:
    """[1, 4] Montgomery tensor of one value."""
    return tensor_from_u64(ctx.encode([v]), device)


def from_ints(ctx: FieldCtx, vals, device) -> torch.Tensor:
    """Python ints -> [n, 4] Montgomery tensor (host encoding: small n)."""
    return tensor_from_u64(ctx.encode(vals), device)


def to_ints(ctx: FieldCtx, t: torch.Tensor) -> list[int]:
    """Montgomery tensor [..., 4] -> standard Python ints (flattened)."""
    return ctx.decode(tensor_to_u64(t.reshape(-1, 4)))


def from_std(ctx: FieldCtx, std, device) -> torch.Tensor:
    """Standard-form limbs (numpy uint64 or int64 tensor [..., 4], values
    < p) -> Montgomery tensor, converted on the device."""
    t = std if isinstance(std, torch.Tensor) else tensor_from_u64(std, device)
    return to_mont(ctx, t.to(device))


def to_std(ctx: FieldCtx, t: torch.Tensor) -> np.ndarray:
    """Montgomery tensor -> standard-form numpy [..., 4] uint64."""
    return tensor_to_u64(from_mont(ctx, t))


# ---------------------------------------------------------------------------
# 32-bit halves: add / sub / neg as tensor ops on any device
# ---------------------------------------------------------------------------

def _halves(x: torch.Tensor) -> list:
    """[..., 4] int64 -> 8 tensors [...] of 32-bit limbs (values < 2^32)."""
    out = []
    for k in range(4):
        limb = x[..., k]
        out.append(limb & MASK32)
        out.append((limb >> 32) & MASK32)
    return out


def _join(h: list) -> torch.Tensor:
    return torch.stack([h[2 * k] | (h[2 * k + 1] << 32) for k in range(4)],
                       dim=-1)


def _p_halves(ctx: FieldCtx) -> list[int]:
    return [(ctx.p >> (32 * i)) & MASK32 for i in range(8)]


def _cond_sub_p_halves(ctx: FieldCtx, s: list) -> list:
    """s if s < p else s - p, s normalized 32-bit limbs with s < 2p."""
    d, borrow = [], 0
    for si, pi in zip(s, _p_halves(ctx)):
        cur = si - pi - borrow
        d.append(cur & MASK32)
        borrow = (cur < 0).to(torch.int64)
    keep = borrow.bool()
    return [torch.where(keep, si, di) for si, di in zip(s, d)]


def add(ctx: FieldCtx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p; broadcasting like torch."""
    s, carry = [], 0
    for ai, bi in zip(_halves(a), _halves(b)):
        cur = ai + bi + carry
        s.append(cur & MASK32)
        carry = cur >> 32
    return _join(_cond_sub_p_halves(ctx, s))


def sub(ctx: FieldCtx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p; broadcasting like torch."""
    d, borrow = [], 0
    for ai, bi in zip(_halves(a), _halves(b)):
        cur = ai - bi - borrow
        d.append(cur & MASK32)
        borrow = (cur < 0).to(torch.int64)
    out, carry = [], 0
    for di, pi in zip(d, _p_halves(ctx)):
        cur = di + pi * borrow + carry
        out.append(cur & MASK32)
        carry = cur >> 32
    return _join(out)


def neg(ctx: FieldCtx, a: torch.Tensor) -> torch.Tensor:
    return sub(ctx, torch.zeros_like(a), a)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(dim=-1)


# ---------------------------------------------------------------------------
# Montgomery product: plain version (16-bit limbs in int64, CIOS)
# ---------------------------------------------------------------------------

def split16(x: torch.Tensor) -> torch.Tensor:
    """[..., 4] int64 -> [16, ...] int64 16-bit limbs, limb-major."""
    return torch.stack([(x[..., k // 4] >> (16 * (k % 4))) & MASK16
                        for k in range(NLIMBS)])


def join16(limbs: torch.Tensor) -> torch.Tensor:
    """[16, ...] 16-bit limbs -> [..., 4] int64."""
    return torch.stack([limbs[4 * k] | (limbs[4 * k + 1] << 16)
                        | (limbs[4 * k + 2] << 32) | (limbs[4 * k + 3] << 48)
                        for k in range(4)], dim=-1)


def _p_col16(ctx: FieldCtx, like: torch.Tensor) -> torch.Tensor:
    col = torch.tensor([int(v) for v in ctx.p_limbs], dtype=torch.int64,
                       device=like.device)
    return col.reshape((NLIMBS,) + (1,) * (like.dim() - 1))


def carry16(t: torch.Tensor):
    """Carry-propagate a [k, ...] accumulator -> (normalized limbs, carry)."""
    out, c = [], torch.zeros_like(t[0])
    for i in range(t.shape[0]):
        cur = t[i] + c
        out.append(cur & MASK16)
        c = cur >> 16
    return torch.stack(out), c


def cond_sub16(ctx: FieldCtx, a: torch.Tensor) -> torch.Tensor:
    """a if a < p else a - p, on [16, ...] normalized limbs (a < 2p)."""
    diff, borrow = [], torch.zeros_like(a[0])
    for i in range(NLIMBS):
        cur = a[i] - int(ctx.p_limbs[i]) - borrow
        diff.append(cur & MASK16)
        borrow = (cur < 0).to(torch.int64)
    return torch.where(borrow.bool(), a, torch.stack(diff))


def add16(ctx, a, b):
    out, _ = carry16(a + b)
    return cond_sub16(ctx, out)


def sub16(ctx, a, b):
    """a - b mod p on [16, ...] limbs, as a + (p - b) (the reference's
    `_k_sub`)."""
    pb, borrow = [], torch.zeros_like(b[0])
    for i in range(NLIMBS):
        cur = int(ctx.p_limbs[i]) - b[i] - borrow
        pb.append(cur & MASK16)
        borrow = (cur < 0).to(torch.int64)
    return add16(ctx, a, torch.stack(pb))


def mont_mul16(ctx: FieldCtx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """CIOS Montgomery product on [16, ...] int64 16-bit limbs: 16 rounds,
    each a multiply-accumulate of a by limb b[i] and of p by m (the
    reference's `_mont_mul_cios`, lanes across the trailing axes)."""
    p_col = _p_col16(ctx, a)
    # t[i:] is the reference's accumulator after i rounds: instead of
    # shifting it down one limb per round, the window moves up one row.
    t = torch.zeros((2 * NLIMBS + 1,) + tuple(a.shape[1:]), dtype=torch.int64,
                    device=a.device)
    for i in range(NLIMBS):
        prod = a * b[i]
        t[i:i + NLIMBS] += prod & MASK16
        t[i + 1:i + NLIMBS + 1] += prod >> 16
        m = (t[i] * ctx.n0inv16) & MASK16
        q = p_col * m
        t[i:i + NLIMBS] += q & MASK16
        t[i + 1:i + NLIMBS + 1] += q >> 16
        t[i + 1] += t[i] >> 16          # t[i] is now 0 mod 2^16
    res, _top = carry16(t[NLIMBS:2 * NLIMBS])
    return cond_sub16(ctx, res)


def mont_mul_plain(ctx: FieldCtx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: a [..., 4] times b [m, 4], b read at i % m."""
    flat = a.reshape(-1, 4)
    reps = flat.shape[0] // b.shape[0]
    bb = b.repeat(reps, 1) if reps > 1 else b
    out = join16(mont_mul16(ctx, split16(flat), split16(bb)))
    return out.reshape(a.shape)


_USE_MXU = False


def mont_mul(ctx: FieldCtx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a * b * R^-1 mod p, elementwise.

    a: [..., 4]; b: [m, 4] with m dividing a's element count, read at
    (flat index mod m) — m = 1 scales by one value, m = n multiplies every
    [n, 4] slice of a batch by the same vector. The CIOS product
    (`mont_mul_cios`: K3, or its plain version for a CPU tensor) by
    default; the 8-bit-limb product (`field_mxu.mont_mul`: K7, or its
    plain version) after `enable_mxu(True)` or with SPECTRE_FIELD_IMPL=mxu
    set at import (the reference's dispatch, `ops/field_ops.py:172`). The
    flag is read per call. Both give the same canonical values."""
    if _USE_MXU:
        from . import field_mxu
        return field_mxu.mont_mul(ctx, a, b)
    return mont_mul_cios(ctx, a, b)


def enable_mxu(on: bool = True) -> None:
    """Route `mont_mul` through the 8-bit-limb product (see above)."""
    global _USE_MXU
    _USE_MXU = bool(on)


def mxu_enabled() -> bool:
    return _USE_MXU


if os.environ.get("SPECTRE_FIELD_IMPL") == "mxu":
    enable_mxu()


def mont_mul_cios(ctx: FieldCtx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K3, the CIOS Montgomery product (arguments as `mont_mul`); the
    plain version for a CPU tensor."""
    b = b.reshape(-1, 4)
    n = a.numel() // 4
    if n % b.shape[0]:
        raise ValueError(f"mont_mul: {b.shape[0]} rows do not tile {n}")
    if a.device != b.device:
        raise ValueError("mont_mul: operands on different devices")
    if not a.is_cuda:
        return mont_mul_plain(ctx, a, b)
    KL.require(a, "mont_mul a", torch.int64, last=4)
    KL.require(b, "mont_mul b", torch.int64, ndim=2, last=4)
    out = torch.empty_like(a)
    lib = KL.library("field_kernels")
    KL.KERNELS["K3_mont_mul"].launches += 1
    rc = lib.spt_mont_mul(a.data_ptr(), b.data_ptr(), b.shape[0],
                          out.data_ptr(), n, ctx.field_id, KL.stream_of(a))
    KL.check_launch(rc, "K3_mont_mul")
    return out


# ---------------------------------------------------------------------------
# derived operations
# ---------------------------------------------------------------------------

def to_mont(ctx: FieldCtx, a: torch.Tensor) -> torch.Tensor:
    return mont_mul(ctx, a.contiguous(), const_raw(ctx.r2, a.device))


def from_mont(ctx: FieldCtx, a: torch.Tensor) -> torch.Tensor:
    return mont_mul(ctx, a.contiguous(), const_raw(1, a.device))


def const_raw(v: int, device) -> torch.Tensor:
    """[1, 4] tensor of the limbs of v itself (no Montgomery encoding)."""
    return tensor_from_u64(L.ints_to_limbs([v]), device)


def one_like(ctx: FieldCtx, a: torch.Tensor) -> torch.Tensor:
    return const_raw(ctx.r_mod_p, a.device).expand_as(a)


def mont_pow(ctx: FieldCtx, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e elementwise by square-and-multiply over the host exponent."""
    if e < 0:
        raise ValueError("negative exponent")
    result = one_like(ctx, a).contiguous()
    base = a.contiguous()
    while e:
        if e & 1:
            result = mont_mul(ctx, result, base)
        e >>= 1
        if e:
            base = mont_mul(ctx, base, base)
    return result


def prefix_prod(ctx: FieldCtx, a: torch.Tensor) -> torch.Tensor:
    """Inclusive running product along axis 0 of [n, 4]: log2(n) rounds of
    one elementwise product each (Hillis-Steele)."""
    out = a.contiguous()
    n, d = out.shape[0], 1
    while d < n:
        out = torch.cat([out[:d], mont_mul(ctx, out[d:], out[:n - d].contiguous())])
        d *= 2
    return out


def inv(ctx: FieldCtx, a: torch.Tensor) -> torch.Tensor:
    """Batch inversion of [n, 4] by Montgomery's trick: a prefix scan, a
    suffix scan, one host inversion of the total, one product. inv(0) = 0."""
    zero = is_zero(a)
    one = const_raw(ctx.r_mod_p, a.device)
    a1 = torch.where(zero[:, None], one, a)
    pre = prefix_prod(ctx, a1)
    suf = prefix_prod(ctx, a1.flip(0)).flip(0)
    total = to_ints(ctx, pre[-1:])[0]
    tinv = const(ctx, pow(total, -1, ctx.p), a.device)
    pre_ex = torch.cat([one, pre[:-1]])
    suf_ex = torch.cat([suf[1:], one])
    out = mont_mul(ctx, mont_mul(ctx, pre_ex, suf_ex.contiguous()), tinv)
    return torch.where(zero[:, None], torch.zeros_like(out), out)


def powers(ctx: FieldCtx, x: int, n: int, device) -> torch.Tensor:
    """[x^0, ..., x^(n-1)] as [n, 4] Montgomery, by doubling: the block
    [k, 2k) is the block [0, k) times x^k."""
    out = const(ctx, 1, device)
    k = 1
    while k < n:
        step = min(k, n - k)
        blk = mont_mul(ctx, out[:step], const(ctx, pow(x, k, ctx.p), device))
        out = torch.cat([out, blk])
        k *= 2
    return out[:n]


def field_sum(ctx: FieldCtx, a: torch.Tensor, dim: int = 0) -> list[int]:
    """Sum along `dim` of a Montgomery tensor [..., 4] -> standard ints (the
    remaining leading axes flattened). The 32-bit halves are summed exactly
    in int64 on the device (fine below 2^31 terms); the host folds the eight
    column sums and removes the Montgomery factor."""
    if a.shape[dim] >= 1 << 31:
        raise ValueError("field_sum: too many terms for exact int64 sums")
    cols = torch.stack(_halves(a), dim=-1).sum(dim=dim)      # [..., 8]
    flat = cols.reshape(-1, 8).cpu().tolist()
    p, rinv = ctx.p, ctx.r_inv
    return [sum(int(c) << (32 * i) for i, c in enumerate(row)) % p * rinv % p
            for row in flat]
