"""PLONKish constraint system: the fixed arithmetization (the port's copy of
`spectre_tpu/plonk/constraint_system.py`).

One universal gate (halo2-lib's "vertical" flex gate):
    q[i] * (a[i] + a[i+1] * a[i+2] - a[i+3]) = 0
per gate-advice column, plus copy constraints (chunked permutation argument),
plus lookup arguments binding the lookup-advice columns to table columns.

Column order (global permutation indexing):
    [gate advice][lookup advice][fixed][sha word][instance]

The wide SHA-256 region (`num_sha_slots > 0`): per block slot of
SHA_SLOT_ROWS rows, SHA_BIT_COLS bit columns (outside the permutation) hold
the w/a/e bit ladders and the addition carries, and SHA_WORD_COLS word
columns (in the permutation) hold h_in/h_out, the input words and the
pinned activity flag, copy-linked into the main region. Every identity is
homogeneous in the advice (the round constant enters as fixed_K * act), so
all-zero unused slots satisfy them (expressions.sha_expressions).

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
from ..ops.sha256 import K as SHA_K

R = bn254.R

ZK_ROWS = 5
GATE_ROWS = 4   # the vertical gate reads rotations 0..+3 of its column
PERM_CHUNK = 2  # columns per permutation grand-product (degree 4 budget)
NUM_H_CHUNKS = 3

# --- the wide SHA-256 region ---
SHA_BIT_COLS = 104      # w[32] | a[32] | e[32] | carries[8]
SHA_WORD_COLS = 10      # h state words [8] | input words | act flag
SHA_SLOT_ROWS = 72      # 4 seed + 64 rounds + 1 output (+3 spare)
SHA_SEED_ROW = 3
SHA_OUT_ROW = 68
SHA_NUM_SELECTORS = 7   # bit, seed, round, sched, inp, out, act-chain
SHA_W, SHA_A, SHA_E, SHA_CARRY = 0, 32, 64, 96
# act lives in a word column (permutation-enabled) so the chip pins it to
# the constant 1 on used slots: an unpinned act could be zeroed to prove a
# K-less hash variant
SHA_ACT_WORD = 9


def sha_selector_columns(cfg: "CircuitConfig") -> tuple[np.ndarray, np.ndarray]:
    """The SHA region's fixed content: the 7 selector columns [7, n] and
    the round-constant column [n], uint64, patterned per slot (the
    reference's `sha_selector_columns`, built in bulk)."""
    n, nsl = cfg.n, cfg.num_sha_slots
    if nsl and (nsl - 1) * SHA_SLOT_ROWS + SHA_OUT_ROW >= cfg.usable_rows:
        raise ValueError("sha slot exceeds usable rows")
    slot = np.zeros((SHA_NUM_SELECTORS, SHA_SLOT_ROWS), dtype=np.uint64)
    slot[0, :SHA_OUT_ROW + 1] = 1                 # q_bit rows 0..68
    slot[1, SHA_SEED_ROW] = 1                     # q_seed
    slot[2, 4:68] = 1                             # q_round rows 4..67
    slot[3, 20:68] = 1                            # q_sched rows 20..67
    slot[4, 4:20] = 1                             # q_inp rows 4..19
    slot[5, SHA_OUT_ROW] = 1                      # q_out
    slot[6, 1:SHA_OUT_ROW + 1] = 1                # q_act rows 1..68
    kslot = np.zeros(SHA_SLOT_ROWS, dtype=np.uint64)
    kslot[4:68] = SHA_K
    sel = np.zeros((SHA_NUM_SELECTORS, n), dtype=np.uint64)
    kcol = np.zeros(n, dtype=np.uint64)
    rows = nsl * SHA_SLOT_ROWS
    sel[:, :rows] = np.tile(slot, nsl)
    kcol[:rows] = np.tile(kslot, nsl)
    return sel, kcol


def gate_coverage(selectors) -> np.ndarray:
    """[num_advice, n] uint8 mask of the rows some active gate window
    reads: a selector firing at row r binds rows r..r+GATE_ROWS-1 of its
    column (the auditor's row-coverage primitive)."""
    sel = np.asarray(selectors, dtype=np.uint8)
    cov = sel.copy()
    for off in range(1, GATE_ROWS):
        cov[:, off:] |= sel[:, :sel.shape[1] - off]
    return cov


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
    def max_expr_degree(self) -> int:
        """Degree budget of one constraint expression, each column
        polynomial (advice, fixed, selector, sigma, z, l0/llast/lblind, X)
        counting 1: an expression of column-degree d has degree <= d (n - 1);
        divided by the vanishing polynomial, the quotient must fit the
        NUM_H_CHUNKS committed chunks, so d <= NUM_H_CHUNKS + 1 (the
        auditor's CA-DEGREE rule holds the expressions to it)."""
        return NUM_H_CHUNKS + 1

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

    def col_sha_word(self, j):
        return self.num_advice + self.num_lookup_advice + self.num_fixed + j

    def col_instance(self, j):
        return (self.num_advice + self.num_lookup_advice + self.num_fixed
                + self.num_sha_word + j)

    def table_id(self, j: int) -> str:
        if self.lookup_tables:
            return self.lookup_tables[j]
        return "range"

    def validate(self):
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
    """Witness-side circuit assignment. copies: ((col_a, row_a), (col_b,
    row_b)) equality constraints in the global column indexing, as a list
    of pairs or an [m, 4] integer array of (col_a, row_a, col_b, row_b)
    rows. sha_bit / sha_word: the SHA region's columns, numpy [104, n] bits
    and [10, n] 32-bit words (None without SHA slots)."""

    config: CircuitConfig
    advice: list            # [num_advice] columns of n values
    lookup_advice: list     # [num_lookup_advice] columns
    fixed: list             # [num_fixed] columns
    selectors: list         # [num_advice] 0/1 columns
    instances: list         # [num_instance][<= usable] ints
    copies: list = field(default_factory=list)
    sha_bit: object = None
    sha_word: object = None

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

def sigma_merge_plain(a: np.ndarray, b: np.ndarray, k: int) -> np.ndarray:
    """The cycle merge over cells 0..k-1 for the copy pairs (a[i], b[i]):
    each cell's successor in its cycle, [k] int64. halo2's next-pointer
    merge (swapping the successors of two cells in distinct cycles joins
    the cycles) with small-to-large membership relabelling, in Python: the
    plain version of `csrc/sigma_host.cpp`."""
    nxt = list(range(k))
    cyc = list(range(k))
    members: dict = {}
    for ca, cb in zip(a.tolist(), b.tolist()):
        ia, ib = cyc[ca], cyc[cb]
        if ia == ib:
            continue
        ma = members.get(ia) or [ia]
        mb = members.pop(ib, None) or [ib]
        if len(ma) < len(mb):
            ia, ib, ma, mb = ib, ia, mb, ma
            members.pop(ib, None)
        for cell in mb:
            cyc[cell] = ia
        ma.extend(mb)
        members[ia] = ma
        nxt[ca], nxt[cb] = nxt[cb], nxt[ca]
    return np.array(nxt, dtype=np.int64)


def sigma_merge_native(a: np.ndarray, b: np.ndarray, k: int, lib=None) -> np.ndarray:
    """`sigma_merge_plain` in host C++ (`csrc/sigma_host.cpp`, built on
    first use; raises if it cannot be built). lib: a loaded library to use
    instead."""
    from ..ops import kernel_lib as KL
    lib = lib or KL.host_library("sigma_host")
    a = np.ascontiguousarray(a, dtype=np.int64)
    b = np.ascontiguousarray(b, dtype=np.int64)
    if a.shape != b.shape:
        raise ValueError("one b cell for each a cell")
    nxt = np.empty(k, dtype=np.int64)
    rc = lib.spt_sigma_merge(a.ctypes.data, b.ctypes.data, a.shape[0], k, nxt.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"spt_sigma_merge failed with code {rc}")
    return nxt


def sigma_targets(cfg: CircuitConfig, copies, native: bool = False
                  ) -> tuple[np.ndarray, np.ndarray]:
    """The copy permutation as (column, row) targets, each [m * n] int64:
    sigma(j, i) = (jp, ip) flattened at j * n + i.

    The cycles are the reference's `build_sigma` exactly (halo2's
    next-pointer merge with small-to-large relabelling), so both packages
    build the same permutation from the same copies. native: merge in host
    C++ (`sigma_merge_native`, keygen on the card) instead of the Python
    loop; the targets are the same."""
    n = cfg.n
    m = cfg.num_perm_columns
    u = cfg.usable_rows

    cp = np.asarray(copies, dtype=np.int64).reshape(-1, 4)
    if cp.size:
        if (cp[:, 0].min() < 0 or cp[:, 2].min() < 0
                or cp[:, 0].max() >= m or cp[:, 2].max() >= m):
            raise ValueError("copy column out of range")
        if cp[:, 1].max() >= u or cp[:, 3].max() >= u:
            raise ValueError("copy constraint in blinding rows")
    # the cells the copies touch, as flat indices j * n + i renumbered
    # 0..k-1 (a cell no copy touches is its own cycle); the merge only
    # compares cycle sizes, so the numbering does not change its result
    flat = np.concatenate([cp[:, 0] * n + cp[:, 1], cp[:, 2] * n + cp[:, 3]])
    cells, ids = np.unique(flat, return_inverse=True)
    merge = sigma_merge_native if native else sigma_merge_plain
    nxt = merge(ids[:cp.shape[0]], ids[cp.shape[0]:], cells.shape[0])
    tgt = np.arange(m * n, dtype=np.int64)
    tgt[cells] = cells[nxt]
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
