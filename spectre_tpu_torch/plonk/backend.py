"""TorchBackend: the prover's bulk math on one torch device.

The counterpart of the reference's `TpuBackend` (`spectre_tpu/plonk/
backend.py` :182-576) behind the interface its prover uses. Every column is
an [n, 4] int64 Montgomery tensor (ops.field_ops) that stays on the device
between operations; values reach the host only as transcript scalars,
opened evaluations and proof points. On a CUDA device the products, NTT
stages and MSMs run the port's kernels; on the CPU their plain versions.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..device import resolve
from ..fields import bn254
from ..ops import field_ops as F, msm as MSM, ntt as NTT
from ..parallel.batch_msm import batch_msm_dp
from ..parallel.mesh import local_devices, make_mesh
from ..parallel.plan import ShardingPlan, current_plan, plan_for_mesh
from ..parallel.sharded_msm import sharded_msm
from ..parallel.sharded_ntt import sharded_ntt

R = bn254.R

# MSMs and NTTs at least this large ride the plan's mesh when it has more
# than one shard (the reference's gates; SPECTRE_SHARD_MSM_MIN_LOGN and
# SPECTRE_SHARD_NTT_MIN_LOGN override them, read per call)
SHARD_MSM_MIN_LOGN = 20
SHARD_NTT_MIN_LOGN = 18


def _min_logn(var: str, default: int) -> int:
    return int(os.environ.get(var, str(default)))


class TorchBackend:
    """plan: the ShardingPlan the large MSMs, NTTs and the quotient shard
    over (a mesh of devices, which may repeat one). Without one, the plan
    of this backend's kind of device under SPECTRE_MESH_SHAPE when that is
    set (read per call), else the one-device plan of `device`: the mesh
    path is taken only when asked for (the reference's TpuBackend takes
    the mesh of every device by default). A one-device plan runs
    everything on `device`."""

    name = "torch"

    def __init__(self, device=None, plan: ShardingPlan | None = None):
        self.device = resolve(device)
        self.ctx = F.fr_ctx()
        self.tables = NTT.Twiddles(self.device)
        self._plan = plan

    @property
    def plan(self) -> ShardingPlan:
        if self._plan is not None:
            return self._plan
        if os.environ.get("SPECTRE_MESH_SHAPE", "").strip():
            return current_plan(local_devices(self.device.type))
        return plan_for_mesh(make_mesh(devices=[self.device]))

    def _use_mesh(self, n: int, var: str, default: int) -> bool:
        return self.plan.n_devices > 1 and n >= 1 << _min_logn(var, default)

    def _use_mesh_ntt(self, n: int) -> bool:
        return self._use_mesh(n, "SPECTRE_SHARD_NTT_MIN_LOGN", SHARD_NTT_MIN_LOGN)

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

    # -- NTTs: on the plan's data axis (parallel.sharded_ntt) from 2^18
    # points when it shards, else on this device --
    def _sharded_ntt(self, a, omega: int, post=None):
        return sharded_ntt(a.contiguous(), omega, self.plan, post)

    def ntt(self, coeffs, omega: int):
        if self._use_mesh_ntt(coeffs.shape[0]):
            return self._sharded_ntt(coeffs, omega)
        return NTT.ntt(coeffs, omega, self.tables)

    def intt(self, evals, omega: int):
        n = evals.shape[0]
        if self._use_mesh_ntt(n):
            return self._sharded_ntt(evals, pow(omega, -1, R),
                                     self.const(pow(n, -1, R)))
        return NTT.intt(evals, omega, self.tables)

    def ntt_many(self, coeffs_list, omega: int) -> list:
        if not coeffs_list:
            return []
        if self._use_mesh_ntt(coeffs_list[0].shape[0]):
            return [self.ntt(c, omega) for c in coeffs_list]
        return list(NTT.ntt(torch.stack(coeffs_list), omega, self.tables).unbind(0))

    def intt_many(self, evals_list, omega: int) -> list:
        if not evals_list:
            return []
        if self._use_mesh_ntt(evals_list[0].shape[0]):
            return [self.intt(e, omega) for e in evals_list]
        return list(NTT.intt(torch.stack(evals_list), omega, self.tables).unbind(0))

    def coset_lde(self, coeffs, omega: int, g: int, n_out: int):
        if self._use_mesh_ntt(n_out):
            padded = torch.zeros((n_out, 4), dtype=torch.int64, device=coeffs.device)
            padded[:coeffs.shape[0]] = NTT.coset_scale(coeffs, g, tables=self.tables)
            return self._sharded_ntt(padded, omega)
        return NTT.coset_lde(coeffs, omega, g, n_out, self.tables)

    def coset_lde_many(self, coeffs_list, omega: int, g: int, n_out: int) -> list:
        if not coeffs_list:
            return []
        if self._use_mesh_ntt(n_out):
            return [self.coset_lde(c, omega, g, n_out) for c in coeffs_list]
        return list(NTT.coset_lde(torch.stack(coeffs_list), omega, g, n_out,
                                  self.tables).unbind(0))

    def coset_ilde(self, evals, omega: int, g: int):
        n = evals.shape[0]
        if self._use_mesh_ntt(n):
            return self._sharded_ntt(evals, pow(omega, -1, R), self.tables.ilde_post(g, n))
        return NTT.coset_ilde(evals, omega, g, self.tables)

    # -- MSM against a device-resident base ([N, 24] AoS32, srs.device_base),
    # in the mode SPECTRE_MSM_MODE names; base_key (the SRS digest) keys the
    # expanded base and the fixed-base table. One MSM of 2^20 points or more
    # shards over the plan's mesh (parallel.sharded_msm); a batch of several
    # spreads over its devices (parallel.batch_msm) --
    def msm(self, base: torch.Tensor, scalars: torch.Tensor, base_key=None):
        if self._use_mesh(scalars.shape[0], "SPECTRE_SHARD_MSM_MIN_LOGN", SHARD_MSM_MIN_LOGN):
            return sharded_msm(base, MSM._std(scalars), self.plan, base_key=base_key)
        return MSM.msm_base(base, scalars, base_key=base_key)

    def msm_many(self, base: torch.Tensor, scalars_list, base_key=None) -> list:
        if self.plan.n_devices > 1 and len(scalars_list) > 1:
            return batch_msm_dp(base, [MSM._std(s) for s in scalars_list], self.plan,
                                base_key=base_key)
        return MSM.msm_batch(base, scalars_list, base_key=base_key)
