"""KZG commitments + BDFG20 (SHPLONK) multiopen (the port's copy of
`spectre_tpu/plonk/kzg.py`).

Prover side: every quotient ((p - r)/Z_S, L/(X - u)) is computed pointwise
on the evaluation domain (the divisor never vanishes there because the open
points are random), so the whole multiopen is elementwise device ops, NTTs
and one MSM per witness commitment. Verifier side: host arithmetic.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..fields import bn254
from .domain import Domain
from .srs import SRS

R = bn254.R


def commit(srs: SRS, coeffs: torch.Tensor, bk):
    """Commit to a coefficient-form poly: MSM over the tau powers."""
    if coeffs.shape[0] > srs.n:
        raise ValueError("poly larger than SRS")
    return bk.msm(srs.device_base(bk.device), coeffs)


def commit_many(srs: SRS, coeffs_list: list, bk) -> list:
    for c in coeffs_list:
        if c.shape[0] > srs.n:
            raise ValueError("poly larger than SRS")
    return bk.msm_many(srs.device_base(bk.device), coeffs_list)


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
    g1 = bn254.g1_curve
    v = transcript.challenge()
    w1 = transcript.read_point()
    u = transcript.challenge()
    w2 = transcript.read_point()

    all_points = []
    for e in entries:
        for p in e.points:
            if p not in all_points:
                all_points.append(p)

    f_acc = None
    e_scalar = 0
    vk = 1
    for e in entries:
        z_rest = _z_eval([p for p in all_points if p not in e.points], u)
        r_u = _horner(_interp(e.points, e.evals), u)
        w = vk * z_rest % R
        f_acc = g1.add(f_acc, g1.mul(e.commitment, w))
        e_scalar = (e_scalar + w * r_u) % R
        vk = vk * v % R
    z_t_u = _z_eval(all_points, u)
    f_acc = g1.add(f_acc, g1.neg(g1.mul(bn254.G1_GEN, e_scalar)))
    f_acc = g1.add(f_acc, g1.neg(g1.mul(w1, z_t_u)))
    return w2, g1.add(f_acc, g1.mul(w2, u))
