"""Evaluation domains for the vanishing argument (the port's copy of
`spectre_tpu/plonk/domain.py`): a 2^k subgroup for the witness columns and
its 4x coset extension g<omega_ext> for the quotient. Transforms take the
backend that holds the tensors."""

from __future__ import annotations

import functools

import torch

from ..fields import bn254

R = bn254.R

EXTENSION = 4
COSET_GEN = bn254.FR_GENERATOR  # 7
DELTA = pow(bn254.FR_GENERATOR, 1 << bn254.FR_S, R)


@functools.cache
def get_domain(k: int) -> "Domain":
    return Domain(k)


class Domain:
    def __init__(self, k: int):
        if k + 2 > bn254.FR_S:
            raise ValueError("domain too large for Fr's 2-adicity")
        self.k = k
        self.n = 1 << k
        self.omega = bn254.fr_root_of_unity(k)
        self.omega_inv = pow(self.omega, -1, R)
        self.k_ext = k + 2
        self.n_ext = 1 << self.k_ext
        self.omega_ext = bn254.fr_root_of_unity(self.k_ext)

    # -- transforms ([..., n, 4] Montgomery tensors) --
    def lagrange_to_coeff(self, evals, bk):
        return bk.intt(evals, self.omega)

    def coeff_to_lagrange(self, coeffs, bk):
        return bk.ntt(coeffs, self.omega)

    def lagrange_to_coeff_many(self, evals_list, bk) -> list:
        return bk.intt_many(evals_list, self.omega)

    def coeff_to_extended(self, coeffs, bk):
        """Evaluate degree < n polys on the coset g<omega_ext> (size 4n)."""
        return bk.coset_lde(coeffs, self.omega_ext, COSET_GEN, self.n_ext)

    def extended_to_coeff(self, evals, bk):
        return bk.coset_ilde(evals, self.omega_ext, COSET_GEN)

    # -- closed-form helper evaluations --
    def vanishing_inv_period_vals(self) -> tuple[int, ...]:
        """The EXTENSION distinct values of 1/((g omega_ext^i)^n - 1): the
        extended-domain vanishing inverse repeats them with period 4."""
        gn = pow(COSET_GEN, self.n, R)
        wn = pow(self.omega_ext, self.n, R)
        return tuple(pow((gn * pow(wn, i, R) - 1) % R, -1, R)
                     for i in range(EXTENSION))

    def evaluate_vanishing(self, x: int) -> int:
        return (pow(x, self.n, R) - 1) % R

    def lagrange_evals(self, x: int, rows) -> dict[int, int]:
        """L_i(x) = omega^i (x^n - 1) / (n (x - omega^i)) for given rows."""
        zx = self.evaluate_vanishing(x)
        out = {}
        ninv = pow(self.n, -1, R)
        for i in rows:
            wi = pow(self.omega, i, R)
            if (x - wi) % R == 0:
                out[i] = 1
            elif zx == 0:
                out[i] = 0
            else:
                out[i] = wi * zx % R * pow((x - wi) % R, -1, R) % R * ninv % R
        return out

    def rotate_extended(self, evals: torch.Tensor, by: int) -> torch.Tensor:
        """On the 4n coset: rotation by omega = 4 steps of omega_ext."""
        return torch.roll(evals, -by * EXTENSION, dims=0)
