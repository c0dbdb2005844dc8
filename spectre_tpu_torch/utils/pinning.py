"""Circuit-shape pinning: (k, columns, tables, break points) frozen in JSON
(the port's copy of `spectre_tpu/utils/pinning.py`, read side).

`Halo2ConfigPinning` / `Eth2ConfigPinning` (`util/circuit.rs:26-78`): the
prover recreates the circuit from a pinning on every request instead of
deriving the layout again. The port reads the tracked `build/*.pinning.json`
files and never writes one; `Pinning.check` holds a built context to the
pinned shape.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

from ..plonk.constraint_system import CircuitConfig


@dataclass
class Pinning:
    config: CircuitConfig
    break_points: list

    @classmethod
    def read(cls, path: str) -> "Pinning":
        with open(path) as f:
            data = json.load(f)
        c = dict(data["config"])
        c["lookup_tables"] = tuple(c.get("lookup_tables") or ())
        return cls(CircuitConfig(**c), list(data["break_points"]))

    def check(self, ctx, lookup_bits: int) -> None:
        """Raise ValueError unless the context lays out as pinned: the same
        lookup bits, no more SHA slots than pinned, and the same advice
        break points."""
        cfg = self.config
        if cfg.lookup_bits != lookup_bits:
            raise ValueError(f"pinned lookup_bits {cfg.lookup_bits} != {lookup_bits}")
        if cfg.num_sha_slots < len(ctx.sha_slots):
            raise ValueError(f"pinning has {cfg.num_sha_slots} sha slots, the "
                             f"circuit uses {len(ctx.sha_slots)}")
        _, bp = ctx.column_starts(cfg)
        if bp != self.break_points:
            raise ValueError("the circuit's break points differ from the pinned ones")
