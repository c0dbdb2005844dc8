"""TorchBackend: the prover's bulk math on one torch device.

The counterpart of the reference's `TpuBackend` (`spectre_tpu/plonk/
backend.py` :182-576) behind the interface its prover uses. Every column is
an [n, 4] int64 Montgomery tensor (ops.field_ops) that stays on the device
between operations; values reach the host only as transcript scalars,
opened evaluations and proof points. On a CUDA device the products, NTT
stages and MSMs run the port's kernels; on the CPU their plain versions.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve
from ..fields import bn254
from ..ops import field_ops as F, msm as MSM, ntt as NTT

R = bn254.R


class TorchBackend:
    name = "torch"

    def __init__(self, device=None):
        self.device = resolve(device)
        self.ctx = F.fr_ctx()
        self.tables = NTT.Twiddles(self.device)

    # -- host <-> device --
    def from_ints(self, vals) -> torch.Tensor:
        return F.from_ints(self.ctx, vals, self.device)

    def from_std(self, arr: np.ndarray) -> torch.Tensor:
        """[n, 4] uint64 standard limbs (values < R) -> Montgomery tensor."""
        return F.from_std(self.ctx, arr, self.device)

    def to_ints(self, t: torch.Tensor) -> list[int]:
        return F.to_ints(self.ctx, t)

    def const(self, s: int) -> torch.Tensor:
        return F.const(self.ctx, s % R, self.device)

    def full(self, s: int, n: int) -> torch.Tensor:
        return self.const(s).repeat(n, 1)

    # -- elementwise Fr ops on [n, 4] --
    def mul(self, a, b):
        if a.shape[0] == 1 and b.shape[0] != 1:
            a, b = b, a
        return F.mont_mul(self.ctx, a.contiguous(), b.contiguous())

    def add(self, a, b):
        return F.add(self.ctx, a, b)

    def sub(self, a, b):
        return F.sub(self.ctx, a, b)

    def inv(self, a):
        return F.inv(self.ctx, a)

    def scale(self, a, s: int):
        return F.mont_mul(self.ctx, a.contiguous(), self.const(s))

    def add_scalar(self, a, s: int):
        return F.add(self.ctx, a, self.const(s))

    def axpy(self, a, s: int, b):
        """a*s + b elementwise (the quotient's y-fold)."""
        return F.add(self.ctx, self.scale(a, s), b)

    def powers(self, x: int, n: int):
        return self.tables.powers(x % R, n)

    def prefix_prod(self, a):
        return F.prefix_prod(self.ctx, a)

    def powers_of(self, x: int, n: int):
        """[x^0 .. x^(n-1)], not cached (for one-off points)."""
        return F.powers(self.ctx, x % R, n, self.device)

    def evaluate(self, coeffs: torch.Tensor, pw: torch.Tensor) -> int:
        """sum_i coeffs[i] x^i given pw = powers of x: one product and one
        exact sum."""
        return F.field_sum(self.ctx, F.mont_mul(
            self.ctx, coeffs.contiguous(), pw[:coeffs.shape[0]].contiguous()))[0]

    # -- NTTs --
    def ntt(self, coeffs, omega: int):
        return NTT.ntt(coeffs, omega, self.tables)

    def intt(self, evals, omega: int):
        return NTT.intt(evals, omega, self.tables)

    def ntt_many(self, coeffs_list, omega: int) -> list:
        if not coeffs_list:
            return []
        return list(NTT.ntt(torch.stack(coeffs_list), omega, self.tables).unbind(0))

    def intt_many(self, evals_list, omega: int) -> list:
        if not evals_list:
            return []
        return list(NTT.intt(torch.stack(evals_list), omega, self.tables).unbind(0))

    def coset_lde(self, coeffs, omega: int, g: int, n_out: int):
        return NTT.coset_lde(coeffs, omega, g, n_out, self.tables)

    def coset_lde_many(self, coeffs_list, omega: int, g: int, n_out: int) -> list:
        if not coeffs_list:
            return []
        return list(NTT.coset_lde(torch.stack(coeffs_list), omega, g, n_out,
                                  self.tables).unbind(0))

    def coset_ilde(self, evals, omega: int, g: int):
        return NTT.coset_ilde(evals, omega, g, self.tables)

    # -- MSM against a device-resident base ([N, 24] AoS32, srs.device_base),
    # in the mode SPECTRE_MSM_MODE names; base_key (the SRS digest) keys the
    # expanded base and the fixed-base table --
    def msm(self, base: torch.Tensor, scalars: torch.Tensor, base_key=None):
        return MSM.msm_base(base, scalars, base_key=base_key)

    def msm_many(self, base: torch.Tensor, scalars_list, base_key=None) -> list:
        return MSM.msm_batch(base, scalars_list, base_key=base_key)
