"""GLV scalar decomposition for BN254 G1 (the port of
`spectre_tpu/ops/glv.py`).

BN254 has j-invariant 0, so E: y^2 = x^3 + 3 has the endomorphism
phi(x, y) = (beta x, y), beta a cube root of unity in Fq, which acts on G1
as multiplication by lambda, a cube root of unity in Fr. A scalar k splits
as k = k1 + k2 lambda (mod r) with |k1|, |k2| < 2^126, so one 254-bit MSM
row becomes two ~127-bit rows over [P ; phi(P)]: half the windows for twice
the points (phi is one Fq product a point, `ops.ec.endo`).

Two implementations share the derived constants:

  host (`decompose`, `decompose_batch`, `decompose_limbs16`): Python ints,
      the oracle the device split is held against.
  device (`decompose_device`, `split_limbs`): the same lattice
      arithmetic as torch ops on 16-bit limbs in int64 lanes, limb-major
      [L, n], on the scalars' device, with no host round trip. The rounded
      division is a Barrett product by floor(2^512 / 2r) and one exact
      correction step, and the residuals are taken mod 2^144 in two's
      complement (bit 143 is the sign): the reference's `decompose_device`
      step for step, so both give the same limbs.

The reference's device split is XLA code (lax.scan carry chains), not a
Pallas kernel, so here it is torch ops: ~900 elementwise launches a split,
the two halves stacked so that each runs over 2n lanes.

The constants are derived at first use (cube roots from the field
generators, the short lattice basis by a truncated extended Euclid) and
checked against the host curve, as the reference derives them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields import bn254
from . import field_ops as F

R = bn254.R
P = bn254.P

HALF_LIMBS = 8          # 16-bit limbs per half-scalar (128 bits)
MASK16 = 0xFFFF


@functools.cache
def _constants():
    """(beta, lam, basis) with phi(x, y) = (beta x, y) acting as
    multiplication by lam on G1, and basis = ((a1, b1), (a2, b2)) short
    lattice vectors with a + b lam = 0 (mod r) and determinant +r."""
    lam = pow(bn254.FR_GENERATOR, (R - 1) // 3, R)
    if lam == 1 or pow(lam, 3, R) != 1:
        raise RuntimeError("lambda derivation broken")
    beta, g = 1, 2
    while beta == 1:
        beta = pow(g, (P - 1) // 3, P)
        g += 1
    if pow(beta, 3, P) != 1:
        raise RuntimeError("beta derivation broken")

    gx, gy = int(bn254.G1_GEN[0]), int(bn254.G1_GEN[1])
    curve = bn254.g1_curve

    def matches(b, lm):
        want = curve.mul(bn254.G1_GEN, lm)
        return (int(want[0]), int(want[1])) == (b * gx % P, gy)

    found = next(((b, lm) for b in (beta, beta * beta % P)
                  for lm in (lam, lam * lam % R) if matches(b, lm)), None)
    if found is None:
        raise RuntimeError("no (beta, lambda) pairing satisfies phi == [lambda]")
    beta, lam = found

    # extended Euclid on (r, lam), truncated at sqrt(r): each remainder row
    # has s r + t lam = rem, so (rem, -t) lies in the kernel lattice
    sqrt_r = 1 << ((R.bit_length() + 1) // 2)
    rows = [(R, 0), (lam, 1)]
    while rows[-1][0] != 0:
        q = rows[-2][0] // rows[-1][0]
        rows.append((rows[-2][0] - q * rows[-1][0], rows[-2][1] - q * rows[-1][1]))
    idx = next(i for i, (rem, _t) in enumerate(rows) if rem < sqrt_r)
    v1 = (rows[idx][0], -rows[idx][1])
    cand_a = (rows[idx - 1][0], -rows[idx - 1][1])
    cand_b = (rows[idx + 1][0], -rows[idx + 1][1]) if idx + 1 < len(rows) else cand_a
    v2 = min(cand_a, cand_b, key=lambda v: v[0] * v[0] + v[1] * v[1])
    det = v1[0] * v2[1] - v2[0] * v1[1]
    if abs(det) != R:
        raise RuntimeError("lattice basis determinant != r")
    if det < 0:
        v2 = (-v2[0], -v2[1])
    if any((a + b * lam) % R for a, b in (v1, v2)):
        raise RuntimeError("basis vector outside the lattice")
    return beta, lam, (v1, v2)


def beta() -> int:
    return _constants()[0]


def lam() -> int:
    return _constants()[1]


@functools.cache
def _bound_bits() -> int:
    """Bit length bounding |k1|, |k2| (the Babai rounding error is at most
    half the basis coordinate sums): 126 for BN254."""
    (a1, b1), (a2, b2) = _constants()[2]
    bx = (abs(a1) + abs(a2) + 1) // 2
    by = (abs(b1) + abs(b2) + 1) // 2
    bits = max(bx.bit_length(), by.bit_length())
    if bits > 16 * HALF_LIMBS:
        raise RuntimeError("half-scalars overflow HALF_LIMBS limbs")
    return bits


def glv_bits() -> int:
    return _bound_bits()


# ---------------------------------------------------------------------------
# host oracle
# ---------------------------------------------------------------------------

def decompose(k: int) -> tuple[int, int]:
    """k -> (k1, k2), signed, with k1 + k2 lam = k (mod r) and |k1|, |k2|
    < 2^glv_bits(): Babai rounding in the (v1, v2) basis."""
    k = k % R
    (a1, b1), (a2, b2) = _constants()[2]
    c1 = (2 * k * b2 + R) // (2 * R)
    c2 = (-2 * k * b1 + R) // (2 * R)
    return k - c1 * a1 - c2 * a2, -c1 * b1 - c2 * b2


def decompose_batch(scalars):
    """Iterable of ints -> (abs1 [n, 8], abs2 [n, 8] uint32 16-bit limbs of
    |k1|, |k2|; neg1 [n], neg2 [n] bool signs), as the reference's."""
    ks = [int(v) for v in scalars]
    n = len(ks)
    abs1 = np.zeros((n, HALF_LIMBS), dtype=np.uint32)
    abs2 = np.zeros((n, HALF_LIMBS), dtype=np.uint32)
    neg1 = np.zeros(n, dtype=bool)
    neg2 = np.zeros(n, dtype=bool)
    bound = 1 << _bound_bits()
    for i, k in enumerate(ks):
        k1, k2 = decompose(k)
        if not (-bound < k1 < bound and -bound < k2 < bound):
            raise RuntimeError("half-scalar out of bound (lattice basis regression)")
        neg1[i], neg2[i] = k1 < 0, k2 < 0
        m1, m2 = abs(k1), abs(k2)
        for j in range(HALF_LIMBS):
            abs1[i, j] = (m1 >> (16 * j)) & MASK16
            abs2[i, j] = (m2 >> (16 * j)) & MASK16
    return abs1, abs2, neg1, neg2


def decompose_limbs16(sc16: np.ndarray):
    """[n, 16] 16-bit limb scalars -> decompose_batch's outputs."""
    arr = np.asarray(sc16, dtype=object)
    return decompose_batch(sum(int(v) << (16 * j) for j, v in enumerate(row))
                           for row in arr)


# ---------------------------------------------------------------------------
# device split: 16-bit limbs in int64 lanes, limb-major [L, n]
#
#   c1 = (2k b2 + r) // 2r      c2 = (2k |b1| + r) // 2r      (b1 < 0)
#
# The floor division is floor(x mu / 2^512), mu = floor(2^512 / 2r), which
# for x < 2^384 is the quotient or one less, then one correction where the
# remainder is still >= 2r. k1 = k - c1 a1 - c2 a2 and k2 = c1 |b1| - c2 b2
# are taken mod 2^144; bit 143 is the sign.
# ---------------------------------------------------------------------------

def _limbs(v: int, nl: int) -> list[int]:
    if not 0 <= v < 1 << (16 * nl):
        raise ValueError("constant overflows its limb count")
    return [(v >> (16 * i)) & MASK16 for i in range(nl)]


@functools.cache
def _device_consts() -> dict:
    """The split's constants as 16-bit limb lists, derived from the basis
    the host path uses."""
    (a1, b1), (a2, b2) = _constants()[2]
    if not (a1 > 0 and b1 < 0 and a2 > 0 and b2 > 0):
        raise RuntimeError("lattice basis sign structure changed: the device split is stale")
    return {
        "tb2": _limbs(2 * b2, 8), "tb1": _limbs(-2 * b1, 8), "r24": _limbs(R, 24),
        "mu": _limbs((1 << 512) // (2 * R), 17), "d17": _limbs(2 * R, 17),
        "a1": _limbs(a1, 8), "a2": _limbs(a2, 8), "nb1": _limbs(-b1, 8),
        "b2": _limbs(b2, 8),
    }


def _carry(t: torch.Tensor) -> torch.Tensor:
    """Normalize a limb-major accumulator (nonnegative entries < 2^62) to
    16-bit limbs, mod 2^(16 L)."""
    return F.carry16(t)[0]


def _mul_const(a: torch.Tensor, const, out_l: int) -> torch.Tensor:
    """a [La, ...] times a constant, mod 2^(16 out_l): one multiply-accumulate
    of a shifted row per constant limb (entries stay below 2^37), then one
    carry pass. const is a list of 16-bit limbs, each an int or a tensor
    broadcast against a row of a (a pair of constants, one per half)."""
    t = torch.zeros((out_l,) + tuple(a.shape[1:]), dtype=torch.int64, device=a.device)
    for j, bj in enumerate(const[:out_l]):
        if not isinstance(bj, int) or bj:
            m = min(a.shape[0], out_l - j)
            t[j:j + m] += a[:m] * bj
    return _carry(t)


def _col(limbs: list[int], like: torch.Tensor) -> torch.Tensor:
    """Limbs as a column broadcast against the rows of `like` [L, ...]."""
    col = torch.tensor(limbs[:like.shape[0]] + [0] * (like.shape[0] - len(limbs)),
                       dtype=torch.int64, device=like.device)
    return col.reshape((-1,) + (1,) * (like.dim() - 1))


@functools.cache
def _pair_consts(device: str) -> dict:
    """Pairs of constants for the two halves of a stacked [L, 2, n] split,
    as per-limb [2, 1] tensors on `device`."""
    cst = _device_consts()

    def pair(x, y):
        return [torch.tensor([[u], [v]], dtype=torch.int64, device=device)
                for u, v in zip(cst[x], cst[y])]

    return {"tb": pair("tb2", "tb1"), "a1_nb1": pair("a1", "nb1"), "a2_b2": pair("a2", "b2")}


def _sub_mod(a: torch.Tensor, b: torch.Tensor):
    """((a - b) mod 2^(16 L), final borrow: 1 where a < b)."""
    out, borrow = [], torch.zeros_like(a[0])
    for i in range(a.shape[0]):
        cur = a[i] - b[i] - borrow
        out.append(cur & MASK16)
        borrow = (cur < 0).to(torch.int64)
    return torch.stack(out), borrow


def _neg_mod(a: torch.Tensor) -> torch.Tensor:
    """Two's-complement negation mod 2^(16 L)."""
    return _carry(torch.cat([(a[:1] ^ MASK16) + 1, a[1:] ^ MASK16]))


def _floor_div_2r(x: torch.Tensor) -> torch.Tensor:
    """floor(x / 2r) for x [24, ...] (< 2^384): [9, ...] (quotients < 2^128)."""
    cst = _device_consts()
    qhat = _mul_const(x, cst["mu"], 41)[32:41]
    rhat, _ = _sub_mod(x[:17], _mul_const(qhat, cst["d17"], 17))
    _, borrow = _sub_mod(rhat, _col(cst["d17"], rhat).expand_as(rhat))
    return _carry(torch.cat([qhat[:1] + (1 - borrow), qhat[1:]]))


def split_limbs(k: torch.Tensor):
    """[16, n] int64 16-bit limbs of standard-form scalars (< r), limb-major
    -> (magnitudes [8, 2, n]: |k1| of every scalar, then |k2|; signs [2, n]
    bool), on k's device; equal limb for limb to the host decompose_batch.
    The two halves run stacked, so each step below is one torch op over 2n
    lanes: ~900 elementwise launches a split."""
    cst = _device_consts()
    pc = _pair_consts(str(k.device))
    n = k.shape[1]
    k2n = k[:, None, :].expand(16, 2, n)
    x = _mul_const(k2n, pc["tb"], 24)                     # [2k b2 ; 2k |b1|]
    x = _carry(x + _col(cst["r24"], x))
    c = _floor_div_2r(x)                                   # [c1 ; c2]
    u = _mul_const(c[:, :1].expand(9, 2, n), pc["a1_nb1"], 9)   # [c1 a1 ; c1 |b1|]
    v = _mul_const(c[:, 1:].expand(9, 2, n), pc["a2_b2"], 9)    # [c2 a2 ; c2 b2]
    d, _ = _sub_mod(torch.stack([k[:9], u[:, 1]], 1), torch.stack([u[:, 0], v[:, 1]], 1))
    kk, _ = _sub_mod(d, torch.stack([v[:, 0], torch.zeros_like(v[:, 0])], 1))   # [k1 ; k2]
    neg = ((kk[8] >> 15) & 1) != 0
    mag = torch.where(neg, _neg_mod(kk), kk)
    return mag[:HALF_LIMBS], neg


def decompose_device(sc16: torch.Tensor):
    """[n, 16] 16-bit limb scalars (values < r; the reference's wire format)
    -> (abs1 [n, 8], abs2 [n, 8] int64, neg1 [n], neg2 [n] bool), the
    reference's `decompose_device` outputs."""
    mag, neg = split_limbs(sc16.to(torch.int64).t().contiguous())
    return mag[:, 0].t().contiguous(), mag[:, 1].t().contiguous(), neg[0], neg[1]
