"""PLONKish constraint system: the fixed arithmetization (the port's copy of
`spectre_tpu/plonk/constraint_system.py`).

One universal gate (halo2-lib's "vertical" flex gate):
    q[i] * (a[i] + a[i+1] * a[i+2] - a[i+3]) = 0
per gate-advice column, plus copy constraints (chunked permutation argument),
plus lookup arguments binding the lookup-advice columns to table columns.

Column order (global permutation indexing):
    [gate advice][lookup advice][fixed][sha word][instance]

Columns may be given as lists of ints, 1-D numpy integer arrays, or
[n, 4] uint64 standard-form limb arrays; `column_std` normalizes them. The
sigma construction is vectorized numpy on the host and the lookup
permutation runs as tensor ops on the prover's device, so both keep up at
2^21 rows.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..fields import bn254
from ..ops import limbs as L

R = bn254.R

ZK_ROWS = 5
PERM_CHUNK = 2  # columns per permutation grand-product (degree 4 budget)
NUM_H_CHUNKS = 3
# the wide SHA-256 region's column counts: part of the circuit shape (and of
# the vk digest); proving it is later work, so the port refuses sha slots
SHA_BIT_COLS = 104
SHA_WORD_COLS = 10


@dataclass(frozen=True)
class CircuitConfig:
    """Circuit shape — the pinning payload (`k`, column counts, lookup
    tables). lookup_tables: table id per lookup-advice column ("range",
    "nibble", "nibble_op"); empty means "range" for every column."""

    k: int
    num_advice: int
    num_lookup_advice: int
    num_fixed: int
    lookup_bits: int
    num_instance: int = 1
    lookup_tables: tuple = ()
    num_sha_slots: int = 0

    @property
    def n(self) -> int:
        return 1 << self.k

    @property
    def zk_rows(self) -> int:
        return ZK_ROWS + 2 if self.num_sha_slots else ZK_ROWS

    @property
    def usable_rows(self) -> int:
        return self.n - self.zk_rows - 1

    @property
    def last_row(self) -> int:
        return self.usable_rows  # l_last index

    @property
    def num_sha_word(self) -> int:
        return SHA_WORD_COLS if self.num_sha_slots else 0

    @property
    def num_sha_bit(self) -> int:
        return SHA_BIT_COLS if self.num_sha_slots else 0

    @property
    def num_perm_columns(self) -> int:
        return (self.num_advice + self.num_lookup_advice + self.num_fixed
                + self.num_sha_word + self.num_instance)

    @property
    def num_perm_chunks(self) -> int:
        return (self.num_perm_columns + PERM_CHUNK - 1) // PERM_CHUNK

    def col_gate_advice(self, j):
        return j

    def col_lookup_advice(self, j):
        return self.num_advice + j

    def col_fixed(self, j):
        return self.num_advice + self.num_lookup_advice + j

    def col_instance(self, j):
        return (self.num_advice + self.num_lookup_advice + self.num_fixed
                + self.num_sha_word + j)

    def table_id(self, j: int) -> str:
        if self.lookup_tables:
            return self.lookup_tables[j]
        return "range"

    def validate(self):
        if self.num_sha_slots:
            raise NotImplementedError(
                "the wide SHA-256 region is not ported yet (num_sha_slots > 0)")
        if self.lookup_bits >= self.k or (1 << self.lookup_bits) > self.usable_rows:
            raise ValueError("table must fit the usable rows")
        if self.num_instance < 1:
            raise ValueError("at least one instance column")
        if self.lookup_tables and len(self.lookup_tables) != self.num_lookup_advice:
            raise ValueError("one table id per lookup-advice column")
        if "nibble_op" in (self.lookup_tables or ()) and 512 > self.usable_rows:
            raise ValueError("nibble_op table (512 rows) does not fit usable rows")


@dataclass
class Assignment:
    """Witness-side circuit assignment. copies: list of ((col_a, row_a),
    (col_b, row_b)) equality constraints in the global column indexing."""

    config: CircuitConfig
    advice: list            # [num_advice] columns of n values
    lookup_advice: list     # [num_lookup_advice] columns
    fixed: list             # [num_fixed] columns
    selectors: list         # [num_advice] 0/1 columns
    instances: list         # [num_instance][<= usable] ints
    copies: list = field(default_factory=list)

    def instance_column(self, j) -> np.ndarray:
        col = np.zeros((self.config.n, 4), dtype=np.uint64)
        vals = self.instances[j]
        if len(vals):
            col[:len(vals)] = L.ints_to_limbs([int(v) % R for v in vals])
        return col


def column_std(col, n: int) -> np.ndarray:
    """One column (list of ints, 1-D numpy integer array of non-negative
    values, or [n, 4] uint64 standard limbs) -> [n, 4] uint64, values
    reduced mod R."""
    if isinstance(col, np.ndarray) and col.ndim == 2:
        out = np.ascontiguousarray(col, dtype=np.uint64)
    elif isinstance(col, np.ndarray) and col.dtype.kind in "iu":
        if col.dtype.kind == "i" and (col < 0).any():
            raise ValueError("negative column values: pass them reduced mod R")
        out = np.zeros((col.shape[0], 4), dtype=np.uint64)
        out[:, 0] = col.astype(np.uint64)
    else:
        out = L.ints_to_limbs([int(v) % R for v in col])
    if out.shape != (n, 4):
        raise ValueError(f"column has shape {out.shape}, expected ({n}, 4)")
    return out


def table_column(cfg: CircuitConfig, table_id: str = "range") -> np.ndarray:
    """Table values [n] uint64, zero-padded (zero is a member of every
    table, so padding rows remain valid entries).

    "range":     0..2^lookup_bits-1
    "nibble":    0..15
    "nibble_op": packed 4-bit bitwise triples (op << 12) | (x << 8) |
                 (y << 4) | f_op(x, y), op 0 = XOR, op 1 = AND."""
    if table_id == "range":
        vals = np.arange(1 << cfg.lookup_bits, dtype=np.uint64)
    elif table_id == "nibble":
        vals = np.arange(16, dtype=np.uint64)
    elif table_id == "nibble_op":
        x, y = np.meshgrid(np.arange(16, dtype=np.uint64),
                           np.arange(16, dtype=np.uint64), indexing="ij")
        x, y = x.ravel(), y.ravel()
        vals = np.concatenate([(x << 8) | (y << 4) | (x ^ y),
                               (1 << 12) | (x << 8) | (y << 4) | (x & y)])
    else:
        raise KeyError(table_id)
    out = np.zeros(cfg.n, dtype=np.uint64)
    out[:vals.shape[0]] = vals
    return out


# ---------------------------------------------------------------------------
# permutation helpers
# ---------------------------------------------------------------------------

def sigma_targets(cfg: CircuitConfig, copies) -> tuple[np.ndarray, np.ndarray]:
    """The copy permutation as (column, row) targets, each [m * n] int64:
    sigma(j, i) = (jp, ip) flattened at j * n + i.

    Cycle construction is halo2's next-pointer merge (swapping successors of
    two cells in distinct cycles concatenates them) with small-to-large
    membership relabeling — the reference's `build_sigma` exactly, so both
    packages build the same permutation from the same copies."""
    n = cfg.n
    m = cfg.num_perm_columns
    u = cfg.usable_rows

    nxt: dict = {}
    cyc: dict = {}
    members: dict = {}
    for (ca, ra), (cb, rb) in copies:
        if not (0 <= ca < m and 0 <= cb < m):
            raise ValueError("copy column out of range")
        if not (ra < u and rb < u):
            raise ValueError("copy constraint in blinding rows")
        a = ca * n + ra
        b = cb * n + rb
        for x in (a, b):
            if x not in nxt:
                nxt[x] = x
                cyc[x] = x
                members[x] = [x]
        ia, ib = cyc[a], cyc[b]
        if ia == ib:
            continue
        if len(members[ia]) < len(members[ib]):
            ia, ib = ib, ia
        for cell in members[ib]:
            cyc[cell] = ia
        members[ia].extend(members.pop(ib))
        nxt[a], nxt[b] = nxt[b], nxt[a]

    tgt = np.arange(m * n, dtype=np.int64)
    if nxt:
        keys = np.fromiter(nxt.keys(), dtype=np.int64, count=len(nxt))
        vals = np.fromiter(nxt.values(), dtype=np.int64, count=len(nxt))
        tgt[keys] = vals
    return tgt // n, tgt % n


def _dense_ids(rows: torch.Tensor):
    """[m, 4] int64 limb rows (uint64 bit patterns) -> (ids [m] int64 in
    numeric order of the 256-bit values, distinct rows [v, 4]): a stable
    sort per limb, least significant first (sign bit flipped so the signed
    sort is the unsigned order), then run boundaries."""
    idx = torch.arange(rows.shape[0], device=rows.device)
    for limb in range(4):
        key = rows[idx, limb] ^ _SIGN
        idx = idx[torch.argsort(key, stable=True)]
    srt = rows[idx]
    new = torch.ones(rows.shape[0], dtype=torch.bool, device=rows.device)
    new[1:] = (srt[1:] != srt[:-1]).any(dim=1)
    ids = torch.empty_like(idx)
    ids[idx] = torch.cumsum(new.to(torch.int64), 0) - 1
    return ids, srt[new]


_SIGN = -(1 << 63)


def permute_lookup(cfg: CircuitConfig, a_vals: torch.Tensor, t_vals: torch.Tensor):
    """halo2-style (A', T') for one lookup argument over the active rows:
    [n, 4] int64 standard-form limb tensors in and out, on their device.

    A' = sorted A; T' = a permutation of T aligning first occurrences:
    A'[i] == A'[i-1] or A'[i] == T'[i]. The unused table values fill the
    remaining rows in the reference's order (distinct values by first
    appearance in T, each repeated by its leftover count), so both packages
    produce the same columns."""
    u, dev = cfg.usable_rows, a_vals.device
    ids, uniq = _dense_ids(torch.cat([a_vals[:u], t_vals[:u]]))
    a_id, t_id = ids[:u], ids[u:]
    nv = uniq.shape[0]

    a_sorted = torch.sort(a_id).values
    first = torch.ones(u, dtype=torch.bool, device=dev)
    first[1:] = a_sorted[1:] != a_sorted[:-1]
    t_count = torch.bincount(t_id, minlength=nv)
    need = a_sorted[first]
    missing = need[t_count[need] == 0]
    if missing.numel():
        bad = L.limbs_to_ints(uniq[missing[:1]].cpu().numpy().view(np.uint64))[0]
        raise ValueError(f"lookup value {bad} not in table")
    t_prime = torch.empty(u, dtype=torch.int64, device=dev)
    t_prime[first] = need
    left = t_count.clone()
    left[need] -= 1
    big = torch.full((nv,), u, dtype=torch.int64, device=dev)
    first_pos = big.scatter_reduce(0, t_id, torch.arange(u, device=dev), "amin")
    present = int((t_count > 0).sum())
    by_appearance = torch.argsort(first_pos, stable=True)[:present]
    t_prime[~first] = torch.repeat_interleave(by_appearance, left[by_appearance])

    pad = torch.zeros((cfg.n - u, 4), dtype=torch.int64, device=dev)
    return torch.cat([uniq[a_sorted], pad]), torch.cat([uniq[t_prime], pad])
