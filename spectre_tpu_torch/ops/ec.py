"""BN254 G1 on tensors: layouts, host encode/decode, and the plain complete
addition (the arithmetic of kernel K2, in PyTorch).

Points are homogeneous projective (X:Y:Z) over Fq in Montgomery form, with
infinity (0:1:0). Three layouts:

  SoA16   [48, N] int32: rows = X, Y, Z x 16 little-endian 16-bit limbs,
          columns = points. The reference's Pallas layout, kept at the
          public functions so the tests compare like with like.
  AoS32   [N, 24] int32: per point X, Y, Z x 8 little-endian 32-bit limbs
          (uint32 bit patterns). What the CUDA kernels read: one point is 96
          contiguous bytes. A field vector [N, 4] int64 viewed as int32 is
          exactly one coordinate of it.
  rows16  [N, 48] int64: the plain versions' working form of SoA16.

Addition is Renes-Costello-Batina alg. 7 (a = 0, b3 = 9), complete: the same
branch-free formula covers generic add, doubling, inverses and infinity, in
the operation order of the reference's `msm_pallas._k_padd`. Every field op
returns the canonical representative, so the plain version and K2 agree limb
for limb.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields import bn254
from . import field_ops as F
from . import glv

NL = F.NLIMBS
ROWS = 3 * NL


def _fq():
    return F.fq_ctx()


# ---------------------------------------------------------------------------
# layout conversions
# ---------------------------------------------------------------------------

def soa16_to_aos32(soa: torch.Tensor) -> torch.Tensor:
    """[48, N] 16-bit limbs -> [N, 24] int32 packed 32-bit limbs."""
    s = soa.to(torch.int64).reshape(3, 8, 2, -1)
    packed = s[:, :, 0] | (s[:, :, 1] << 16)                 # [3, 8, N]
    packed = packed - ((packed >> 31) << 32)                  # to int32 range
    return packed.to(torch.int32).permute(2, 0, 1).reshape(-1, 24).contiguous()


def aos32_to_rows16(aos: torch.Tensor) -> torch.Tensor:
    """[N, 24] int32 -> [N, 48] int64 16-bit limbs."""
    a = aos.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([a & 0xFFFF, a >> 16], dim=-1).reshape(-1, ROWS)


def rows16_to_aos32(rows: torch.Tensor) -> torch.Tensor:
    r = rows.reshape(-1, 24, 2)
    packed = r[..., 0] | (r[..., 1] << 16)
    packed = packed - ((packed >> 31) << 32)
    return packed.to(torch.int32).contiguous()


def aos32_to_soa16(aos: torch.Tensor) -> torch.Tensor:
    """[N, 24] int32 -> [48, N] int32 16-bit limbs."""
    return aos32_to_rows16(aos).t().to(torch.int32).contiguous()


def coords_to_aos32(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Three [N, 4] int64 Montgomery Fq vectors -> AoS32 points."""
    return torch.cat([c.contiguous().view(torch.int32) for c in (x, y, z)],
                     dim=1)


def aos32_coords(aos: torch.Tensor):
    """AoS32 points -> (X, Y, Z) as [N, 4] int64 Montgomery Fq vectors."""
    return tuple(aos[:, 8 * i:8 * (i + 1)].contiguous().view(torch.int64)
                 for i in range(3))


def inf_aos32(n: int, device) -> torch.Tensor:
    one = F.const_raw(_fq().r_mod_p, device).view(torch.int32)   # [1, 8]
    zero = torch.zeros_like(one)
    return torch.cat([zero, one, zero], dim=1).repeat(n, 1)


# ---------------------------------------------------------------------------
# host affine <-> device projective
# ---------------------------------------------------------------------------

def encode_affine_std(xy: torch.Tensor) -> torch.Tensor:
    """Affine standard limbs [N, 8] int64 (x || y, (0, 0) = infinity, the
    SRS file format) -> AoS32 projective Montgomery, converted on the
    device of `xy`."""
    ctx = _fq()
    x = F.to_mont(ctx, xy[:, :4].contiguous())
    y = F.to_mont(ctx, xy[:, 4:].contiguous())
    inf = (xy == 0).all(dim=1)[:, None]
    one = F.const_raw(ctx.r_mod_p, xy.device)
    y = torch.where(inf, one, y)
    z = torch.where(inf, torch.zeros_like(one), one.expand_as(x))
    return coords_to_aos32(x, y, z)


def encode_points(points, device) -> torch.Tensor:
    """Host list of affine (x, y) | None -> AoS32 (host encoding)."""
    ctx = _fq()
    xs, ys, zs = [], [], []
    for pt in points:
        if pt is None:
            xs.append(0), ys.append(1), zs.append(0)
        else:
            xs.append(int(pt[0])), ys.append(int(pt[1])), zs.append(1)
    coords = [torch.from_numpy(ctx.encode(v).view(np.int64)) for v in (xs, ys, zs)]
    return coords_to_aos32(*coords).to(device)


def decode_points(aos: torch.Tensor) -> list:
    """AoS32 projective -> host list of affine (Fq, Fq) | None."""
    ctx = _fq()
    xs, ys, zs = (ctx.decode(F.tensor_to_u64(c)) for c in aos32_coords(aos))
    out = []
    for x, y, z in zip(xs, ys, zs):
        if z == 0:
            out.append(None)
        else:
            zi = pow(z, -1, ctx.p)
            out.append((bn254.Fq(x * zi % ctx.p), bn254.Fq(y * zi % ctx.p)))
    return out


def normalize_std(aos: torch.Tensor) -> torch.Tensor:
    """AoS32 projective -> affine standard limbs [N, 8] int64 on the same
    device ((0, 0) for infinity): one batch inversion of Z, two products,
    and the conversion out of Montgomery form."""
    ctx = _fq()
    x, y, z = aos32_coords(aos)
    zi = F.inv(ctx, z)
    ax = F.from_mont(ctx, F.mont_mul(ctx, x, zi))
    ay = F.from_mont(ctx, F.mont_mul(ctx, y, zi))
    return torch.cat([ax, ay], dim=1)


# ---------------------------------------------------------------------------
# the GLV endomorphism
# ---------------------------------------------------------------------------

def endo(aos: torch.Tensor) -> torch.Tensor:
    """phi(X:Y:Z) = (beta X : Y : Z) on AoS32 points [..., 24] (the
    reference's `ec.endo`): one Fq product of every X by beta, K3 on a CUDA
    tensor with beta read as its one-row second operand. phi fixes infinity
    (beta 0 = 0) and keeps points on the curve, so the complete formulas
    cover its images as they cover the base."""
    flat = aos.reshape(-1, 24)
    fq = _fq()
    bx = F.mont_mul(fq, flat[:, :8].contiguous().view(torch.int64),
                    F.const(fq, glv.beta(), aos.device))
    return torch.cat([bx.view(torch.int32), flat[:, 8:]], dim=1).reshape(aos.shape)


# ---------------------------------------------------------------------------
# plain complete addition on [16, ...] limb stacks
# ---------------------------------------------------------------------------

def padd16(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """RCB complete add on [48, ...] int64 16-bit limb stacks: the plain
    version of K2. The values are those of the reference's `_k_padd` step
    for step; as in the reference's `ec.padd`, the independent field ops of
    each layer run as one stacked call (two Montgomery calls per add)."""
    ctx = _fq()
    add = lambda a, b: F.add16(ctx, a, b)        # noqa: E731
    sub = lambda a, b: F.sub16(ctx, a, b)        # noqa: E731
    mul = lambda a, b: F.mont_mul16(ctx, a, b)   # noqa: E731
    st = lambda *xs: torch.stack(xs, dim=1)      # noqa: E731
    x1, y1, z1 = p[:NL], p[NL:2 * NL], p[2 * NL:]
    x2, y2, z2 = q[:NL], q[NL:2 * NL], q[2 * NL:]
    s = add(st(x1, y1, x1, x2, y2, x2), st(y1, z1, z1, y2, z2, z2))
    la = torch.cat([st(x1, y1, z1), s[:, :3]], dim=1)
    lb = torch.cat([st(x2, y2, z2), s[:, 3:]], dim=1)
    t0, t1, t2, m3, m4, m5 = mul(la, lb).unbind(1)
    t3, t4, ycross = sub(sub(st(m3, m4, m5), st(t0, t1, t0)),
                         st(t1, t2, t2)).unbind(1)
    t0_3 = add(add(t0, t0), t0)
    v = st(t2, ycross)
    v2 = add(v, v)
    v4 = add(v2, v2)
    b3t2, b3y = add(add(v4, v4), v).unbind(1)    # 9 * t2, 9 * ycross
    z3p = add(t1, b3t2)
    t1m = sub(t1, b3t2)
    x3a, x3b, y3a, y3b, z3a, z3b = mul(
        st(t4, t3, b3y, t1m, t0_3, z3p), st(b3y, t1m, t0_3, z3p, t3, t4)).unbind(1)
    yz = add(st(y3b, z3b), st(y3a, z3a))
    return torch.cat([sub(x3b, x3a), yz[:, 0], yz[:, 1]])


def cneg16(mask: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """mask ? -p : p on [48, N] limb stacks: Y -> 0 - Y (the reference's
    `_k_cneg`; infinity (0:1:0) becomes (0:p-1:0), still infinity)."""
    y = p[NL:2 * NL]
    ny = F.sub16(_fq(), torch.zeros_like(y), y)
    return torch.cat([p[:NL], torch.where(mask, ny, y), p[2 * NL:]])
