"""BLS12-381 Fq on the device: 384-bit Montgomery arithmetic and batched G1
pubkey decompression (the port's counterpart of `spectre_tpu/ops/field384.py`).

Values are [..., 6] int64 tensors holding the uint64 bit patterns of six
little-endian words, in Montgomery form with R = 2^384: the same values as
the JAX package's 24 x 16-bit limbs, and the bit layout of the 12 x 32-bit
limbs that the kernel reads.

    decompress_y        K6 (csrc/field384_kernels.cu): y = sqrt(x^3 + 4) and
                        whether it exists, a group of 8 lanes of a warp per
                        key, for a CUDA tensor; the plain version for a CPU
                        tensor
    decompress_y_plain  the plain PyTorch version: mont_mul and mont_pow in
                        torch integer ops, vectorised over the keys
    g1_decompress_batch the committee's compressed pubkeys -> affine points:
                        flags and canonical x checked on the host, the square
                        root on `device`, the sign applied on the host

The plain product splits each operand into 16-bit limbs (int64 holds their
products and column sums exactly), forms the schoolbook product in one
batched op and reduces it limb by limb (Montgomery REDC), then resolves the
carries over 48-bit words and subtracts p once if needed. sqrt uses the
p = 3 (mod 4) exponentiation: y = a^((p+1)/4), valid iff y^2 = a.
Malformed input raises ValueError where the JAX package asserts.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import resolve
from . import kernel_lib as KL
from . import limbs as L
from .field_ops import tensor_from_u64, tensor_to_u64

NWORDS = 6
NLIMBS16 = 24
MASK16 = 0xFFFF
MASK48 = (1 << 48) - 1


class Field384Ctx:
    def __init__(self, p: int, name: str):
        if p.bit_length() > 384 or p % 4 != 3:
            raise ValueError("Field384Ctx needs p < 2^384 with p = 3 mod 4")
        self.p = p
        self.name = name
        self.n0inv16 = (-pow(p, -1, 1 << 16)) % (1 << 16)
        self.r_mod_p = (1 << 384) % p
        self.sqrt_exp = (p + 1) // 4
        self._consts: dict = {}

    def encode(self, vals) -> np.ndarray:
        """Standard values -> [n, 6] uint64 words of their Montgomery forms."""
        return L.ints_to_limbs([(int(v) % self.p) * self.r_mod_p % self.p
                                for v in vals], NWORDS)

    def decode(self, arr) -> list[int]:
        """[n, 6] uint64 Montgomery words -> standard values."""
        rinv = pow(self.r_mod_p, -1, self.p)
        return [v * rinv % self.p for v in L.limbs_to_ints(np.asarray(arr))]

    def to_tensor(self, vals, device) -> torch.Tensor:
        return tensor_from_u64(self.encode(vals), device)

    def to_ints(self, t: torch.Tensor) -> list[int]:
        return self.decode(tensor_to_u64(t.reshape(-1, NWORDS)))

    def consts(self, device) -> dict:
        """p in 16-bit limbs and 48-bit words, and the Montgomery 1 and 4, on
        `device`."""
        key = str(device)
        c = self._consts.get(key)
        if c is None:
            c = dict(
                p16=torch.tensor([(self.p >> (16 * i)) & MASK16 for i in range(NLIMBS16)],
                                 dtype=torch.int64, device=device),
                p48=torch.tensor([(self.p >> (48 * i)) & MASK48 for i in range(8)],
                                 dtype=torch.int64, device=device),
                one16=_limbs16(self.to_tensor([1], device))[0],
                four16=_limbs16(self.to_tensor([4], device))[0],
                cols=(torch.arange(NLIMBS16, device=device)[:, None]
                      + torch.arange(NLIMBS16, device=device)[None, :]).reshape(-1),
            )
            self._consts[key] = c
        return c


@functools.cache
def bls_fq_ctx() -> Field384Ctx:
    from ..fields import bls12_381 as bls
    return Field384Ctx(bls.P, "bls12_381_fq")


# ---------------------------------------------------------------------------
# the plain version, on 16-bit limbs
# ---------------------------------------------------------------------------

def _limbs16(a: torch.Tensor) -> torch.Tensor:
    """[..., 6] words -> [..., 24] 16-bit limbs."""
    return torch.stack([(a >> s) & MASK16 for s in (0, 16, 32, 48)], dim=-1) \
        .reshape(*a.shape[:-1], NLIMBS16)


def _words(l16: torch.Tensor) -> torch.Tensor:
    """[..., 24] 16-bit limbs -> [..., 6] words."""
    q = l16.reshape(*l16.shape[:-1], NWORDS, 4)
    return q[..., 0] | (q[..., 1] << 16) | (q[..., 2] << 32) | (q[..., 3] << 48)


def _reduce(ctx: Field384Ctx, t: torch.Tensor) -> torch.Tensor:
    """Non-negative limbs t[..., k] < 2^40 of a value below 2p, 16 bits
    apart (at most 27 of them) -> its canonical 16-bit limbs mod p."""
    c = ctx.consts(t.device)
    shape = t.shape[:-1]
    t = torch.nn.functional.pad(t, (0, 27 - t.shape[-1]))
    # one parallel carry step (limbs < 2^25), then 48-bit words (< 2^58)
    hi = t >> 16
    t = t & MASK16
    t[..., 1:] += hi[..., :-1]
    t = t.reshape(*shape, 9, 3)
    w = t[..., 0] + (t[..., 1] << 16) + (t[..., 2] << 32)
    for k in range(8):
        w[..., k + 1] += w[..., k] >> 48
        w[..., k] &= MASK48
    w = w[..., :8]      # the value is below 2p < 2^382: word 8 is 0
    # w - p with a borrow chain; w < p where the chain borrows out
    d = w - c["p48"]
    for k in range(7):
        borrow = d[..., k] >> 63                      # -1 where negative
        d[..., k] += (borrow & 1) << 48
        d[..., k + 1] += borrow
    w = torch.where((d[..., 7] < 0).unsqueeze(-1), w, d)
    return torch.stack([(w >> s) & MASK16 for s in (0, 16, 32)], dim=-1) \
        .reshape(*shape, NLIMBS16)


def _mul16(ctx: Field384Ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a * b * 2^-384 mod p on [..., 24] 16-bit limbs."""
    c = ctx.consts(a.device)
    shape = torch.broadcast_shapes(a.shape, b.shape)[:-1]
    prod = (a.unsqueeze(-1) * b.unsqueeze(-2)).reshape(*shape, NLIMBS16 * NLIMBS16)
    t = torch.zeros(*shape, 2 * NLIMBS16 + 1, dtype=torch.int64, device=a.device)
    t.index_add_(-1, c["cols"], prod)                 # column sums < 2^37
    p16, n0 = c["p16"], ctx.n0inv16
    for i in range(NLIMBS16):
        # m zeroes limb i; its carry moves up one limb (limbs stay < 2^39)
        m = (t[..., i] * n0) & MASK16
        t[..., i:i + NLIMBS16] += p16 * m.unsqueeze(-1)
        t[..., i + 1] += t[..., i] >> 16
    return _reduce(ctx, t[..., NLIMBS16:])


def _add16(ctx: Field384Ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _reduce(ctx, a + b)


def _pow16(ctx: Field384Ctx, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e, left to right over the bits of e."""
    if e == 0:
        return ctx.consts(a.device)["one16"].expand(a.shape).clone()
    r = a
    for bit in bin(e)[3:]:
        r = _mul16(ctx, r, r)
        if bit == "1":
            r = _mul16(ctx, r, a)
    return r


def mont_mul(ctx: Field384Ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product of [..., 6] word tensors, in torch ops."""
    return _words(_mul16(ctx, _limbs16(a), _limbs16(b)))


def mont_pow(ctx: Field384Ctx, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e of a [..., 6] Montgomery tensor, in torch ops."""
    return _words(_pow16(ctx, _limbs16(a), e))


def add(ctx: Field384Ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _words(_add16(ctx, _limbs16(a), _limbs16(b)))


def decompress_y_plain(xm: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K6's plain version: x (Montgomery [n, 6]) -> (y = (x^3 + 4)^((p+1)/4)
    in Montgomery form, int32 flag y^2 == x^3 + 4)."""
    ctx = bls_fq_ctx()
    x = _limbs16(xm)
    rhs = _add16(ctx, _mul16(ctx, _mul16(ctx, x, x), x), ctx.consts(xm.device)["four16"])
    y = _pow16(ctx, rhs, ctx.sqrt_exp)
    ok = (_mul16(ctx, y, y) == rhs).all(dim=-1)
    return _words(y), ok.to(torch.int32)


def decompress_y(xm: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(y, ok) of decompress_y_plain: K6 for a CUDA tensor, the plain
    version for a CPU tensor."""
    if not xm.is_cuda:
        return decompress_y_plain(xm)
    KL.require(xm, "decompress_y x", torch.int64, ndim=2, last=NWORDS)
    y = torch.empty_like(xm)
    ok = torch.empty(xm.shape[0], dtype=torch.int32, device=xm.device)
    lib = KL.library("field384_kernels")
    KL.KERNELS["K6_g1_decompress"].launches += 1
    with KL.on_device(xm):
        rc = lib.spt_g1_sqrt(xm.data_ptr(), y.data_ptr(), ok.data_ptr(), xm.shape[0],
                             KL.stream_of(xm))
    KL.check_launch(rc, "K6_g1_decompress")
    return y, ok


def g1_decompress_batch(compressed: list[bytes], device=None) -> list[tuple[int, int]]:
    """Batched BLS12-381 G1 decompression (the 512-pubkey witness-side op),
    equal key for key to `bls12_381.g1_decompress`: flags and canonicality
    are checked on the host, the square root runs on `device` (default
    CUDA, through K6; "cpu" runs the plain version)."""
    dev = resolve(device)
    ctx = bls_fq_ctx()
    xs, signs = [], []
    for b in compressed:
        if len(b) != 48 or not b[0] & 0x80:
            raise ValueError("bad compressed G1")
        if b[0] & 0x40:
            raise ValueError("infinity not expected in committee keys")
        xi = int.from_bytes(bytes([b[0] & 0x1F]) + b[1:], "big")
        if xi >= ctx.p:
            raise ValueError("x not canonical")
        xs.append(xi)
        signs.append(bool(b[0] & 0x20))
    if not xs:
        return []
    y_m, ok = decompress_y(ctx.to_tensor(xs, dev))
    if not bool(ok.all()):
        raise ValueError("point not on curve")
    out = []
    for xi, y, sgn in zip(xs, ctx.to_ints(y_m), signs):
        # sign normalization matches bls12_381.fq_sign (y > (p-1)/2)
        if (y > (ctx.p - 1) // 2) != sgn:
            y = ctx.p - y
        out.append((xi, y))
    return out
