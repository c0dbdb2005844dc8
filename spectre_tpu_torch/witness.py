"""A seeded, satisfying flex-gate witness for a pinned circuit shape.

Stands in for the real circuit builders (the StepCircuit needs the builder
chips, BLS12-381 and SHA-256 of later slices) so the prove runs at a
pinned production shape: every gate-advice column is filled with vertical
gates q (a + b c - d) = 0 on rows 4j..4j+3, every lookup-advice column with
random members of its table, and a few thousand copy constraints chain gate
outputs into later gate inputs, across columns and into the lookup, fixed
and instance columns. Columns are numpy uint64 arrays, built in bulk.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np

from .plonk.constraint_system import Assignment, CircuitConfig, table_column


def config_from_pinning(path: str, k: int | None = None) -> CircuitConfig:
    """CircuitConfig from a `*.pinning.json`; `k` overrides the row count
    and shrinks the range table with it (lookup_bits <= k - 3) if needed."""
    with open(path) as f:
        c = json.load(f)["config"]
    k = int(c["k"]) if k is None else k
    return CircuitConfig(
        k=k, num_advice=int(c["num_advice"]),
        num_lookup_advice=int(c["num_lookup_advice"]),
        num_fixed=int(c["num_fixed"]),
        lookup_bits=min(int(c["lookup_bits"]), k - 3),
        num_instance=int(c.get("num_instance", 1)),
        lookup_tables=tuple(c.get("lookup_tables", ())),
        num_sha_slots=int(c.get("num_sha_slots", 0)))


@dataclass
class FlexCircuit:
    cfg: CircuitConfig
    fixed: list
    selectors: list
    copies: list
    assignment: Assignment

    @property
    def instances(self) -> list:
        return self.assignment.instances


def _table_members(cfg: CircuitConfig, table_id: str) -> np.ndarray:
    col = table_column(cfg, table_id)
    size = {"range": 1 << cfg.lookup_bits, "nibble": 16, "nibble_op": 512}[table_id]
    return col[:size]


def flex_circuit(cfg: CircuitConfig, seed: int, num_copies: int = 4096,
                 num_public: int = 4, value_bits: int = 20) -> FlexCircuit:
    cfg.validate()
    rng = np.random.default_rng(seed)
    n, u = cfg.n, cfg.usable_rows
    gates = u // 4                       # rows 4j..4j+3 < u
    na, nl = cfg.num_advice, cfg.num_lookup_advice
    top = 1 << value_bits

    a = rng.integers(0, top, (na, gates), dtype=np.uint64)
    b = rng.integers(0, top, (na, gates), dtype=np.uint64)
    c = rng.integers(0, top, (na, gates), dtype=np.uint64)
    d = a + b * c

    lookup = []
    for j in range(nl):
        members = _table_members(cfg, cfg.table_id(j))
        col = np.zeros(n, dtype=np.uint64)
        col[:u] = members[rng.integers(0, members.shape[0], u)]
        lookup.append(col)
    fixed = []
    for _ in range(cfg.num_fixed):
        col = np.zeros(n, dtype=np.uint64)
        col[:u] = rng.integers(0, top, u, dtype=np.uint64)
        fixed.append(col)

    # copies into distinct gate inputs, processed by target gate so every
    # source value is final when it is read
    copies = []
    if gates > 1:
        targets = rng.choice(na * (gates - 1), size=min(num_copies, na * (gates - 1)),
                             replace=False)
        order = np.argsort(targets % (gates - 1) + 1, kind="stable")
        kinds = rng.integers(0, 8, targets.shape[0])   # source mix
        for t, kind in zip(targets[order], kinds[order]):
            col, g = int(t // (gates - 1)), int(t % (gates - 1)) + 1
            if kind == 0 and nl:                       # from a lookup cell
                lj, row = int(rng.integers(nl)), int(rng.integers(u))
                val, src = lookup[lj][row], (cfg.col_lookup_advice(lj), row)
            elif kind == 1 and cfg.num_fixed:          # from a fixed cell
                fj, row = int(rng.integers(cfg.num_fixed)), int(rng.integers(u))
                val, src = fixed[fj][row], (cfg.col_fixed(fj), row)
            else:                                      # from an earlier output
                scol, sg = int(rng.integers(na)), int(rng.integers(g))
                val, src = d[scol, sg], (cfg.col_gate_advice(scol), 4 * sg + 3)
            a[col, g] = val
            d[col, g] = a[col, g] + b[col, g] * c[col, g]
            copies.append((src, (cfg.col_gate_advice(col), 4 * g)))

    advice, selectors = [], []
    for col in range(na):
        v = np.zeros(n, dtype=np.uint64)
        v[0:4 * gates:4] = a[col]
        v[1:4 * gates:4] = b[col]
        v[2:4 * gates:4] = c[col]
        v[3:4 * gates:4] = d[col]
        advice.append(v)
        q = np.zeros(n, dtype=np.uint64)
        q[0:4 * gates:4] = 1
        selectors.append(q)

    # public inputs: gate outputs, bound to instance rows by copies
    public = []
    for i in range(min(num_public, gates)):
        col, g = i % na, gates - 1 - i
        public.append(int(d[col, g]))
        copies.append(((cfg.col_instance(0), i), (cfg.col_gate_advice(col), 4 * g + 3)))
    instances = [public] + [[] for _ in range(cfg.num_instance - 1)]

    asg = Assignment(cfg, advice, lookup, fixed, selectors, instances, copies)
    return FlexCircuit(cfg, fixed, selectors, copies, asg)
