"""One explicit ShardingPlan for the mesh prove path (the port of
`spectre_tpu/parallel/plan.py`).

The plan is the placement contract over one ("data", "win") mesh:

  * points and scalars  rows along "data" (`pad_rows` pads with infinity
                        points and zero scalars so the axis divides)
  * Pippenger windows   along "win" (`pad_windows`)
  * fixed-base tables   each shard holds T[w] for its own windows over its
                        own rows, built where it is used
  * signed-digit recode per shard: a shard holds whole scalars, so the
                        carry never crosses a shard boundary
  * NTT                 the Bailey split `ntt_split(logn)`, rows along
                        "data", the transpose an all-to-all of blocks
  * quotient            extended columns row-sharded over every device
                        (`batch_devices`)

A sharded tensor is a list of per-shard tensors, each on its shard's
device. Exchanges go through `move`, which copies with
`tensor.to(device, non_blocking=True)` (a peer copy between two cards,
nothing between two shards of one card) and counts the bytes that cross
from one shard to another, whatever the devices. The plan also caches the
commitment base placed per shard (`placed_base`, the reference's
`backend._mesh_base`) and the shards' fixed-base tables, and counts the
sharded programs it ran (`stats`).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from .mesh import DATA_AXIS, WIN_AXIS, Mesh, default_mesh

STAT_KEYS = ("sharded_msm", "batch_msm", "sharded_ntt", "quotient", "quotient_ops",
             "bytes_exchanged")


@dataclasses.dataclass(eq=False)
class ShardingPlan:
    """Placement contract for one mesh; interned per device grid
    (`plan_for_mesh`), so the caches it holds outlive each call."""

    mesh: Mesh

    def __post_init__(self):
        self._stats = dict.fromkeys(STAT_KEYS, 0)
        self._bases: dict = {}
        self.tables: dict = {}

    # -- shape --

    @property
    def ndata(self) -> int:
        return len(self.mesh.devices)

    @property
    def nwin_shards(self) -> int:
        return len(self.mesh.devices[0])

    @property
    def n_devices(self) -> int:
        return self.ndata * self.nwin_shards

    def device(self, d: int, w: int = 0) -> torch.device:
        return self.mesh.devices[d][w]

    @property
    def data_devices(self) -> list:
        """The devices of the data axis (win shard 0): the sharded NTT's."""
        return [row[0] for row in self.mesh.devices]

    @property
    def batch_devices(self) -> list:
        """Every shard's device, flat: the batched MSM's and the
        quotient's."""
        return list(self.mesh.flat)

    @property
    def physical_devices(self) -> list:
        """The distinct devices, in mesh order."""
        return list(dict.fromkeys(self.mesh.flat))

    # -- padding --

    def pad_rows(self, n: int) -> int:
        """Rows padded so the data axis divides evenly."""
        d = self.ndata
        return ((n + d - 1) // d) * d

    def pad_windows(self, nwin: int) -> int:
        """Window count padded so the win axis divides evenly (padded
        windows read digits beyond nbits: always zero)."""
        s = self.nwin_shards
        return ((nwin + s - 1) // s) * s

    # -- NTT decomposition --

    def ntt_split(self, logn: int, shards: int | None = None) -> tuple[int, int]:
        """(logr, logc) Bailey split of a 2^logn NTT such that `shards`
        (default: the data axis) divides both matrix dims; raises when the
        transform is too small for it."""
        s = self.ndata if shards is None else shards
        logr = logn // 2
        logc = logn - logr
        if (1 << logr) % s or (1 << logc) % s:
            raise ValueError(f"2^{logn} NTT cannot split across {s} shards "
                             f"(a Bailey dim of 2^{logr} x 2^{logc} is not a multiple)")
        return logr, logc

    # -- batch axis --

    @functools.cached_property
    def batch_mesh(self) -> Mesh:
        """The flat ("batch",) mesh over the same devices, for the batched
        MSM and the quotient."""
        return Mesh([[d] for d in self.mesh.flat], axis_names=("batch",))

    # -- exchanges and counters --

    def move(self, t: torch.Tensor, src: int, dst: int, device) -> torch.Tensor:
        """`t` from shard `src` onto shard `dst`'s `device`; the bytes count
        as exchanged when the shards differ."""
        if src != dst:
            self._stats["bytes_exchanged"] += t.numel() * t.element_size()
        return t.to(device, non_blocking=True)

    def count(self, what: str, by: int = 1) -> None:
        self._stats[what] += by

    def stats(self) -> dict:
        """Sharded MSMs, batched MSMs, sharded NTTs, sharded quotients and
        their dispatched ops, and the bytes exchanged between shards, since
        the last `reset_stats`."""
        return dict(self._stats)

    def reset_stats(self) -> None:
        self._stats = dict.fromkeys(STAT_KEYS, 0)

    # -- resident data --

    def placed_base(self, key, build) -> list:
        """The commitment base placed per shard, cached under `key` (the
        caller names the base, its prefix and its expansion); `build()`
        makes it on a miss. Few entries: one SRS base a prover."""
        hit = self._bases.get(key)
        if hit is None:
            if len(self._bases) > 4:
                self._bases.clear()
            hit = self._bases[key] = build()
        return hit

    def clear(self) -> None:
        """Drop the placed bases and the fixed-base tables."""
        self._bases.clear()
        self.tables.clear()

    # -- introspection --

    def describe(self) -> dict:
        return {
            "mesh": dict(self.mesh.shape),
            "n_devices": self.n_devices,
            "devices": [str(d) for d in self.mesh.flat],
            "points": f"rows over '{DATA_AXIS}'",
            "windows": f"over '{WIN_AXIS}'",
            "fixed_table": f"T[w] of each shard's windows over its rows",
            "recode": "per-shard signed-digit",
            "ntt": f"Bailey row/col, rows over '{DATA_AXIS}', transpose = all-to-all",
        }


# interned plans: the caches a plan holds (placed bases, tables) live as long
# as the plan, so the same device grid must give the same plan
_PLANS: dict = {}


def plan_for_mesh(mesh: Mesh) -> ShardingPlan:
    """The interned ShardingPlan of a ("data", "win") mesh (the same device
    grid -> the same plan object)."""
    key = tuple(tuple(str(d) for d in row) for row in mesh.devices)
    plan = _PLANS.get(key)
    if plan is None:
        if len(_PLANS) > 16:
            _PLANS.clear()
        plan = _PLANS[key] = ShardingPlan(mesh=mesh)
    return plan


def current_plan(devices: list | None = None) -> ShardingPlan:
    """The plan of `default_mesh(devices)` (all local devices unless given,
    honouring SPECTRE_MESH_SHAPE), interned."""
    return plan_for_mesh(default_mesh(devices))
