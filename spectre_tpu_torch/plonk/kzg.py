"""KZG commitments + BDFG20 (SHPLONK) multiopen (the port's copy of
`spectre_tpu/plonk/kzg.py`).

Prover side: every quotient ((p - r)/Z_S, L/(X - u)) is computed pointwise
on the evaluation domain (the divisor never vanishes there because the open
points are random), so the whole multiopen is elementwise device ops, NTTs
and one MSM per witness commitment. Verifier side: host arithmetic, its
commitments summed by one host MSM.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..fields import bn254
from .domain import Domain
from .srs import SRS

R = bn254.R


def commit(srs: SRS, coeffs: torch.Tensor, bk):
    """Commit to a coefficient-form poly: MSM over the tau powers. The SRS
    digest names the base, so SPECTRE_MSM_MODE=fixed builds one window table
    per SRS prefix and every commitment reuses it."""
    if coeffs.shape[0] > srs.n:
        raise ValueError("poly larger than SRS")
    return bk.msm(srs.device_base(bk.device), coeffs, base_key=srs.digest())


def commit_many(srs: SRS, coeffs_list: list, bk) -> list:
    for c in coeffs_list:
        if c.shape[0] > srs.n:
            raise ValueError("poly larger than SRS")
    return bk.msm_many(srs.device_base(bk.device), coeffs_list, base_key=srs.digest())


@dataclass
class OpenEntry:
    """One committed polynomial opened at a set of points."""

    coeffs: object              # [n, 4] coefficient tensor (prover side)
    commitment: object          # affine point (verifier side)
    points: tuple               # the query points (ints)
    evals: tuple                # claimed evaluations at those points


def _interp(points, evals) -> list[int]:
    """Lagrange interpolation -> coefficient list (degree < len(points))."""
    m = len(points)
    coeffs = [0] * m
    for j in range(m):
        denom = 1
        basis = [1]
        for k2 in range(m):
            if k2 == j:
                continue
            denom = denom * ((points[j] - points[k2]) % R) % R
            nb = [0] * (len(basis) + 1)
            for d, c in enumerate(basis):
                nb[d + 1] = (nb[d + 1] + c) % R
                nb[d] = (nb[d] - c * points[k2]) % R
            basis = nb
        scale = evals[j] * pow(denom, -1, R) % R
        for d, c in enumerate(basis):
            coeffs[d] = (coeffs[d] + c * scale) % R
    return coeffs


def _z_eval(points, x: int) -> int:
    out = 1
    for s in points:
        out = out * ((x - s) % R) % R
    return out


def _horner(coeffs, x: int) -> int:
    r = 0
    for c in reversed(coeffs):
        r = (r * x + c) % R
    return r


def _domain_linear_factors(domain: Domain, points, bk):
    """[n, 4] evals of Z_S(omega^i) = prod (omega^i - s)."""
    omegas = bk.powers(domain.omega, domain.n)
    acc = None
    for s in points:
        term = bk.sub(omegas, bk.const(s))
        acc = term if acc is None else bk.mul(acc, term)
    return acc


def _eval_small_poly_on_domain(domain: Domain, coeffs: list[int], bk):
    """Evaluate a degree <= 3 poly on the whole domain (Horner)."""
    omegas = bk.powers(domain.omega, domain.n)
    acc = bk.full(coeffs[-1], domain.n)
    for c in reversed(coeffs[:-1]):
        acc = bk.add_scalar(bk.mul(acc, omegas), c)
    return acc


def _pad(coeffs: torch.Tensor, n: int) -> torch.Tensor:
    if coeffs.shape[0] >= n:
        return coeffs
    out = torch.zeros((n, 4), dtype=coeffs.dtype, device=coeffs.device)
    out[:coeffs.shape[0]] = coeffs
    return out


def shplonk_open(srs: SRS, domain: Domain, entries: list[OpenEntry], transcript, bk):
    """Prover: BDFG20 two-commitment multiopen. The evals must already be in
    the transcript; this writes W1, W2."""
    v = transcript.challenge()
    n = domain.n
    all_points = []
    for e in entries:
        for p in e.points:
            if p not in all_points:
                all_points.append(p)

    h_evals = None
    vk = 1
    zinv_cache = {}
    opened = []          # (p_evals, r_coeffs) per entry
    for e in entries:
        key = e.points
        if key not in zinv_cache:
            zinv_cache[key] = bk.inv(_domain_linear_factors(domain, e.points, bk))
        p_evals = domain.coeff_to_lagrange(_pad(e.coeffs, n), bk)
        r_coeffs = _interp(e.points, e.evals)
        r_evals = _eval_small_poly_on_domain(domain, r_coeffs, bk)
        term = bk.scale(bk.mul(bk.sub(p_evals, r_evals), zinv_cache[key]), vk)
        h_evals = term if h_evals is None else bk.add(h_evals, term)
        opened.append((p_evals, r_coeffs))
        vk = vk * v % R
    del zinv_cache

    h_coeffs = domain.lagrange_to_coeff(h_evals, bk)
    w1 = commit(srs, h_coeffs, bk)
    transcript.write_point(w1)
    u = transcript.challenge()

    # L(X) = sum v^k Z_{T \ S_k}(u) (p_k(X) - r_k(u)) - Z_T(u) h(X)
    l_evals = None
    vk = 1
    for e, (p_evals, r_coeffs) in zip(entries, opened):
        z_rest = _z_eval([p for p in all_points if p not in e.points], u)
        r_u = _horner(r_coeffs, u)
        term = bk.scale(bk.sub(p_evals, bk.const(r_u)), vk * z_rest % R)
        l_evals = term if l_evals is None else bk.add(l_evals, term)
        vk = vk * v % R
    del opened
    z_t_u = _z_eval(all_points, u)
    l_evals = bk.sub(l_evals, bk.scale(domain.coeff_to_lagrange(h_coeffs, bk), z_t_u))

    # W2 = commit(L / (X - u)) via pointwise division on the domain
    omegas = bk.powers(domain.omega, n)
    denom_inv = bk.inv(bk.sub(omegas, bk.const(u)))
    w2 = commit(srs, domain.lagrange_to_coeff(bk.mul(l_evals, denom_inv), bk), bk)
    transcript.write_point(w2)


def shplonk_accumulate(srs: SRS, entries: list[OpenEntry], transcript):
    """Verifier scalar/MSM work without the pairing: returns (w2, f + u w2)
    with e(f + u w2, [1]_2) == e(w2, [tau]_2)."""
    v = transcript.challenge()
    w1 = transcript.read_point()
    u = transcript.challenge()
    w2 = transcript.read_point()

    all_points = []
    for e in entries:
        for p in e.points:
            if p not in all_points:
                all_points.append(p)

    # F + u W2 = sum v^k Z_rest(u) C_k - [sum v^k Z_rest(u) r_k(u)] G
    #            - Z_T(u) W1 + u W2, as one host MSM
    pts, scalars = [], []
    e_scalar = 0
    vk = 1
    for e in entries:
        z_rest = _z_eval([p for p in all_points if p not in e.points], u)
        r_u = _horner(_interp(e.points, e.evals), u)
        w = vk * z_rest % R
        pts.append(e.commitment)
        scalars.append(w)
        e_scalar = (e_scalar + w * r_u) % R
        vk = vk * v % R
    z_t_u = _z_eval(all_points, u)
    pts += [bn254.G1_GEN, w1, w2]
    scalars += [-e_scalar % R, -z_t_u % R, u]
    return w2, host_msm(pts, scalars)


# -- the verifier's MSM on the host: Pippenger over Jacobian coordinates in
# plain ints (y^2 = x^3 + 3), no inversion but the last --

_Q = bn254.P
_INF = (1, 1, 0)


def _jdouble(p):
    x, y, z = p
    if z == 0 or y == 0:
        return _INF
    a = x * x % _Q
    b = y * y % _Q
    c = b * b % _Q
    d = 2 * ((x + b) * (x + b) - a - c) % _Q
    e = 3 * a % _Q
    x3 = (e * e - 2 * d) % _Q
    return x3, (e * (d - x3) - 8 * c) % _Q, 2 * y * z % _Q


def _jadd(p, q):
    if p[2] == 0:
        return q
    if q[2] == 0:
        return p
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1 = z1 * z1 % _Q
    z2z2 = z2 * z2 % _Q
    u1 = x1 * z2z2 % _Q
    u2 = x2 * z1z1 % _Q
    s1 = y1 * z2 * z2z2 % _Q
    s2 = y2 * z1 * z1z1 % _Q
    if u1 == u2:
        return _jdouble(p) if s1 == s2 else _INF
    h = u2 - u1
    i = 4 * h * h % _Q
    j = h * i % _Q
    r = 2 * (s2 - s1) % _Q
    v = u1 * i % _Q
    x3 = (r * r - j - 2 * v) % _Q
    return (x3, (r * (v - x3) - 2 * s1 * j) % _Q,
            ((z1 + z2) * (z1 + z2) - z1z1 - z2z2) * h % _Q)


def host_msm(points: list, scalars: list):
    """sum s_i P_i for affine host points (None = infinity) and int
    scalars -> affine point or None. Exact: the same group element as
    `g1_curve.msm`, in a fraction of its time."""
    c = 5
    pairs = [((int(p[0]), int(p[1]), 1), int(s) % R)
             for p, s in zip(points, scalars) if p is not None and int(s) % R]
    acc = _INF
    for w in range(-(-R.bit_length() // c) - 1, -1, -1):
        for _ in range(c):
            acc = _jdouble(acc)
        buckets = [_INF] * (1 << c)
        for p, s in pairs:
            d = (s >> (w * c)) & ((1 << c) - 1)
            if d:
                buckets[d] = _jadd(buckets[d], p)
        run = total = _INF
        for b in range((1 << c) - 1, 0, -1):
            run = _jadd(run, buckets[b])
            total = _jadd(total, run)
        acc = _jadd(acc, total)
    x, y, z = acc
    if z == 0:
        return None
    zi = pow(z, -1, _Q)
    zi2 = zi * zi % _Q
    return (bn254.Fq(x * zi2 % _Q), bn254.Fq(y * zi2 * zi % _Q))
