"""Context: the virtual advice and lookup cell streams, the copy manager and
the layout into physical columns (the port's copy of
`spectre_tpu/builder/context.py`).

Cells are Python ints mod R; every op appends a unit of cells: bare
witnesses, or vertical-gate activations q*(s0 + s1*s2 - s3) = 0 of 4 cells
each. The layout cuts the one advice stream at gate-unit boundaries across
the advice columns (the break points), exactly as the reference does, so a
pinned `break_points` list reproduces.

What differs from the reference is the bookkeeping, kept in flat int lists
so that a circuit of millions of cells lays out with numpy in bulk:
  * copy endpoints are int codes, `(index << 3) | kind`: kind 0 an advice
    stream cell, 1 a SHA word cell (index = word column << 32 | row), 2 + t
    the lookup stream of the t-th table used (`ctx.copies` holds the codes
    of both ends, pair after pair);
  * only gated records are kept: an ungated cell may sit on any row, so the
    column breaks depend on the gated 4-blocks alone.
"""

from __future__ import annotations

import numpy as np

from ..fields import bn254
from ..ops import limbs as L
from ..plonk.constraint_system import (Assignment, CircuitConfig, SHA_BIT_COLS,
                                       SHA_SLOT_ROWS, SHA_WORD_COLS)

R = bn254.R

ADV, SHW, LKP = 0, 1, 2


def shw_ref(j: int, row: int) -> int:
    """Copy endpoint of the SHA word cell (column j, global row)."""
    return (((j << 32) | row) << 3) | SHW


class AssignedValue:
    """Handle to an advice-stream cell: its index and its value. Cells are
    immutable once appended, so the value is stored directly."""

    __slots__ = ("index", "value")

    def __init__(self, index: int, value: int):
        self.index = index
        self.value = value

    def __repr__(self):
        return f"AV(adv[{self.index}]=0x{self.value:x})"


class Context:
    def __init__(self):
        self.adv_values: list[int] = []       # advice stream
        self.gated: list[int] = []            # gated records: start, size, ...
        self.lkp_streams: dict[str, list[int]] = {}   # per table id
        self._lkp_kind: dict[str, int] = {}
        self.copies: list[int] = []           # endpoint codes, a, b, a, b, ...
        self.constants: dict[int, int] = {}   # value -> fixed row
        self.const_uses: list[int] = []       # adv idx, fixed row, ...
        self.instance_cells: list[AssignedValue] = []
        # wide SHA region slots (builder/sha256_wide_chip.py): per slot,
        # bits [SLOT_ROWS, SHA_BIT_COLS] uint32, words [SLOT_ROWS,
        # SHA_WORD_COLS] uint64
        self.sha_slots: list[dict] = []

    def alloc_sha_slot(self) -> int:
        """Reserve one wide-SHA block slot; returns its index (global row
        base = index * SHA_SLOT_ROWS)."""
        self.sha_slots.append({
            "bits": np.zeros((SHA_SLOT_ROWS, SHA_BIT_COLS), np.uint32),
            "words": np.zeros((SHA_SLOT_ROWS, SHA_WORD_COLS), np.uint64),
        })
        return len(self.sha_slots) - 1

    def lkp_ref(self, table: str, idx: int) -> int:
        """Copy endpoint of cell idx of a table's lookup stream."""
        kind = self._lkp_kind.setdefault(table, LKP + len(self._lkp_kind))
        if kind > 7:
            raise ValueError("at most six lookup tables")
        return (idx << 3) | kind

    # -- primitive appends --
    def load_witness(self, v: int) -> AssignedValue:
        v = int(v) % R
        self.adv_values.append(v)
        return AssignedValue(len(self.adv_values) - 1, v)

    def load_constant(self, v: int) -> AssignedValue:
        av = self.load_witness(v)
        self.pin_const(av.index, av.value)
        return av

    def load_zero(self) -> AssignedValue:
        return self.load_constant(0)

    def gate_unit(self, vals: list[int], copy_from: list) -> list[AssignedValue]:
        """Append a gated 4-cell unit. copy_from[i] is None (fresh cell),
        an AssignedValue (equality to an existing cell), or ("const", v)."""
        if len(vals) != 4:
            raise ValueError("a gate unit has 4 cells")
        start = self.bulk_gated([v % R for v in vals])
        adv = self.adv_values
        out = []
        for i, src in enumerate(copy_from):
            if isinstance(src, AssignedValue):
                if src.value != adv[start + i]:
                    raise ValueError("copy value mismatch")
                self.copies += (src.index << 3, (start + i) << 3)
            elif isinstance(src, tuple) and src and src[0] == "const":
                self.pin_const(start + i, src[1] % R)
            out.append(AssignedValue(start + i, adv[start + i]))
        return out

    def gate_unit_out(self, v0: int, v1: int, v2: int, v3: int,
                      s0, s1, s2, s3, out_i: int) -> AssignedValue:
        """Fast path: append one gated unit, return only the out_i cell.
        Sources s0..s3: None (fresh), AssignedValue (copy), or an int
        (constant pin). Values must already be reduced mod R."""
        adv = self.adv_values
        start = len(adv)
        adv.append(v0), adv.append(v1), adv.append(v2), adv.append(v3)
        self.gated += (start, 4)
        copies = self.copies
        i = start
        for src in (s0, s1, s2, s3):
            if src is not None:
                if src.__class__ is AssignedValue:
                    if src.value != adv[i]:
                        raise ValueError("copy value mismatch")
                    copies += (src.index << 3, i << 3)
                else:
                    self.pin_const(i, src)
            i += 1
        return AssignedValue(start + out_i, adv[start + out_i])

    # -- bulk primitives: hot chips build value lists in tight loops and
    # append through these; the constraints are those of the per-op paths --

    def bulk_cells(self, vals: list[int]) -> int:
        """Append ungated witness cells (already reduced mod R); returns
        the start index."""
        start = len(self.adv_values)
        self.adv_values.extend(vals)
        return start

    def bulk_gated(self, flat_vals: list[int]) -> int:
        """Append len(flat_vals) // 4 gated 4-cell units (values reduced
        mod R) as one record; returns the start index. Callers register
        copies and pins themselves."""
        start = len(self.adv_values)
        self.adv_values.extend(flat_vals)
        if flat_vals:
            self.gated += (start, len(flat_vals))
        return start

    def bulk_lookup(self, table: str, idx_val_pairs) -> None:
        """Push (adv index, value) pairs into a lookup table stream."""
        stream = self.lkp_streams.setdefault(table, [])
        base = len(stream)
        kind = self.lkp_ref(table, 0)
        copies = self.copies
        for j, (i, v) in enumerate(idx_val_pairs):
            stream.append(v)
            copies += (i << 3, ((base + j) << 3) | kind)

    def pin_const(self, adv_idx: int, v: int) -> None:
        """Constant-pin an advice cell by index (value already reduced)."""
        row = self.constants.setdefault(v, len(self.constants))
        self.const_uses += (adv_idx, row)

    def push_lookup(self, av: AssignedValue) -> None:
        """Copy a cell into the range-table lookup stream."""
        self.push_lookup_table(av, "range")

    def push_lookup_table(self, av: AssignedValue, table: str) -> None:
        """Copy a cell into the lookup stream of the given table."""
        stream = self.lkp_streams.setdefault(table, [])
        stream.append(av.value)
        self.copies += (av.index << 3, self.lkp_ref(table, len(stream) - 1))

    def constrain_equal(self, a: AssignedValue, b: AssignedValue):
        if a.value != b.value:
            raise ValueError("constrain_equal on unequal values")
        self.copies += (a.index << 3, b.index << 3)

    def constrain_constant(self, a: AssignedValue, v: int):
        if a.value != int(v) % R:
            raise ValueError("constrain_constant mismatch")
        self.pin_const(a.index, int(v) % R)

    def expose_public(self, a: AssignedValue):
        """Append a cell to the instance column (copy-constrained)."""
        self.instance_cells.append(a)

    def cell_references(self) -> dict:
        """The auditor's hook (`analysis.circuit_audit`): per advice-stream
        cell, whether it sits in a gated unit (the vertical gate reads its
        4 rows) and whether a copy, a constant pin or the instance column
        references it. An ungated cell with neither is a free witness the
        proof never binds. {"n_cells", "gated", "referenced"}, the last two
        uint8 arrays indexed by stream position."""
        n = len(self.adv_values)
        gated = np.zeros(n, np.uint8)
        g = np.array(self.gated, dtype=np.int64).reshape(-1, 2)
        if g.size:
            cover = np.zeros(n + 1, np.int64)
            np.add.at(cover, g[:, 0], 1)
            np.add.at(cover, g[:, 0] + g[:, 1], -1)
            gated[np.cumsum(cover[:n]) > 0] = 1
        referenced = np.zeros(n, np.uint8)
        codes = np.array(self.copies, dtype=np.int64)
        adv = codes[(codes & 7) == ADV] >> 3
        uses = np.array(self.const_uses, dtype=np.int64).reshape(-1, 2)[:, 0]
        inst = np.array([av.index for av in self.instance_cells], dtype=np.int64)
        for idx in (adv, uses, inst):
            referenced[idx[(idx >= 0) & (idx < n)]] = 1
        return {"n_cells": n, "gated": gated, "referenced": referenced}

    def cell_placement(self, cfg: CircuitConfig) -> tuple[np.ndarray, np.ndarray]:
        """The auditor's hook: the (column, row) of every advice-stream cell
        the layout of `cfg` placed, as two arrays indexed by stream
        position; taken with the memoized layout, so the two never
        disagree."""
        self.layout(cfg)
        starts, total = self._placed
        idx = np.arange(total, dtype=np.int64)
        col = np.searchsorted(starts, idx, side="right") - 1
        return col, idx - starts[col]

    def stats(self) -> dict:
        return {
            "advice_cells": len(self.adv_values),
            "lookup_cells": {t: len(v) for t, v in self.lkp_streams.items()},
            "copies": len(self.copies) // 2,
            "constants": len(self.constants),
            "instances": len(self.instance_cells),
            "sha_slots": len(self.sha_slots),
        }

    def auto_config(self, k: int, lookup_bits: int, min_advice: int = 1) -> CircuitConfig:
        """Column counts sized from the stream lengths (the reference's
        `auto_config`, halo2-lib's `calculate_params`)."""
        probe = CircuitConfig(k=k, num_advice=1, num_lookup_advice=1,
                              num_fixed=1, lookup_bits=lookup_bits,
                              num_sha_slots=len(self.sha_slots))
        u = probe.usable_rows
        # advice columns: a gated break wastes at most 3 rows a column
        num_advice = max(min_advice, (len(self.adv_values) + u - 1) // (u - 3))
        tables = []
        for tid in sorted(self.lkp_streams):
            ncols = max(1, (len(self.lkp_streams[tid]) + u - 1) // u)
            tables.extend([tid] * ncols)
        if not tables:
            tables = ["range"]  # the config always carries one table
        num_fixed = max(1, (len(self.constants) + u - 1) // u)
        nsl = len(self.sha_slots)
        if nsl * SHA_SLOT_ROWS > u:
            raise ValueError("sha slots exceed usable rows: raise k")
        return CircuitConfig(k=k, num_advice=num_advice,
                             num_lookup_advice=len(tables), num_fixed=num_fixed,
                             lookup_bits=lookup_bits, lookup_tables=tuple(tables),
                             num_sha_slots=nsl)

    # ------------------------------------------------------------------
    # layout: streams -> physical columns -> plonk.Assignment
    # ------------------------------------------------------------------

    def column_starts(self, cfg: CircuitConfig) -> tuple[list, list]:
        """Where the advice stream breaks into columns: (stream index at
        which each used column starts, break points). A column holds a
        contiguous run of the stream from row 0; it ends before the first
        gated 4-block that would cross the last usable row, or when full."""
        u, total = cfg.usable_rows, len(self.adv_values)
        g = np.array(self.gated, dtype=np.int64).reshape(-1, 2)
        g_start, g_end = g[:, 0], g[:, 0] + g[:, 1]
        starts, break_points = [0], []
        while True:
            s = starts[-1]
            lim = s + u                    # first stream index past the column
            brk = lim if total > lim else None
            # a gated block starting at p in (lim - 4, lim) does not fit
            i = int(np.searchsorted(g_start, lim - 1, side="right")) - 1
            while i >= 0 and g_end[i] > lim - 3:
                first = max(lim - 3, int(g_start[i]))
                p = int(g_start[i]) + -(-(first - int(g_start[i])) // 4) * 4
                if p <= min(lim - 1, int(g_end[i]) - 4) and p < total:
                    brk = p if brk is None else min(brk, p)
                i -= 1
            if brk is None:
                break_points.append(total - s)
                return starts, break_points
            break_points.append(brk - s)
            starts.append(brk)
            if len(starts) > cfg.num_advice:
                raise ValueError("advice overflow: raise k or columns")

    def layout(self, cfg: CircuitConfig):
        """Place the streams into columns. Returns (advice, lookup, fixed,
        selectors, copies, instances, break_points): advice, lookup and
        fixed columns as [n, 4] uint64 standard limbs, selectors as [n]
        uint64, copies as an [m, 4] int64 array of (col_a, row_a, col_b,
        row_b) in the reference's order. Memoized on the config."""
        cached = getattr(self, "_layout_cache", None)
        if cached is not None and cached[0] == cfg:
            return cached[1]
        result = self._layout_uncached(cfg)
        self._layout_cache = (cfg, result)
        return result

    def _layout_uncached(self, cfg: CircuitConfig):
        n, u = cfg.n, cfg.usable_rows
        total = len(self.adv_values)
        starts, break_points = self.column_starts(cfg)
        starts_a = np.array(starts, dtype=np.int64)
        self._placed = (starts_a, total)

        def place(idx):
            col = np.searchsorted(starts_a, idx, side="right") - 1
            return col, idx - starts_a[col]

        vals = L.ints_to_limbs(self.adv_values) if total else np.zeros((0, 4), np.uint64)
        advice = np.zeros((cfg.num_advice, n, 4), dtype=np.uint64)
        for c, s in enumerate(starts):
            e = starts[c + 1] if c + 1 < len(starts) else total
            advice[c, :e - s] = vals[s:e]
        del vals
        selectors = np.zeros((cfg.num_advice, n), dtype=np.uint64)
        g = np.array(self.gated, dtype=np.int64).reshape(-1, 2)
        if g.size:
            nblk = g[:, 1] // 4
            first = np.repeat(g[:, 0] - 4 * (np.cumsum(nblk) - nblk), nblk)
            blocks = first + 4 * np.arange(int(nblk.sum()), dtype=np.int64)
            bc, br = place(blocks)
            selectors[bc, br] = 1

        # lookup columns, grouped by table id (the order of cfg.lookup_tables)
        lookup = np.zeros((cfg.num_lookup_advice, n, 4), dtype=np.uint64)
        cols_for_table: dict[str, list[int]] = {}
        for j in range(cfg.num_lookup_advice):
            cols_for_table.setdefault(cfg.table_id(j), []).append(j)
        lkp_col = {}
        for tid, stream in self.lkp_streams.items():
            cols = cols_for_table.get(tid, [])
            if not cols:
                raise ValueError(f"no lookup column configured for table {tid}")
            if len(stream) > len(cols) * u:
                raise ValueError(f"lookup overflow for table {tid}")
            lkp_col[self._lkp_kind[tid]] = np.array(cols, dtype=np.int64)
            limbs = L.ints_to_limbs(stream)
            for ci, c in enumerate(cols):
                part = limbs[ci * u:(ci + 1) * u]
                lookup[c, :part.shape[0]] = part

        fixed = np.zeros((cfg.num_fixed, n, 4), dtype=np.uint64)
        if self.constants:
            if len(self.constants) > cfg.num_fixed * u:
                raise ValueError("fixed overflow")
            frow = np.fromiter(self.constants.values(), dtype=np.int64,
                               count=len(self.constants))
            fixed[frow // u, frow % u] = L.ints_to_limbs(self.constants.keys())

        def check(idx, size, key=lambda i: i):
            # an endpoint past its stream names no cell: refuse it, with the
            # reference's KeyError
            bad = (idx < 0) | (idx >= size)
            if bad.any():
                raise KeyError(key(int(idx[bad][0])))

        # copy endpoints -> global (column, row)
        def coords(code):
            kind, v = code & 7, code >> 3
            col = np.zeros_like(v)
            row = np.zeros_like(v)
            m = kind == ADV
            if m.any():
                check(v[m], total)
                c, r = place(v[m])
                col[m], row[m] = cfg.col_gate_advice(c), r
            m = kind == SHW
            col[m] = cfg.col_sha_word(v[m] >> 32)
            row[m] = v[m] & 0xFFFFFFFF
            for kd, cols in lkp_col.items():
                m = kind == kd
                tid = next(t for t, k in self._lkp_kind.items() if k == kd)
                check(v[m], len(self.lkp_streams[tid]), lambda i: (tid, i))
                col[m] = cfg.col_lookup_advice(cols[v[m] // u])
                row[m] = v[m] % u
            return col, row

        pairs = np.array(self.copies, dtype=np.int64).reshape(-1, 2)
        ca, ra = coords(pairs[:, 0])
        cb, rb = coords(pairs[:, 1])
        uses = np.array(self.const_uses, dtype=np.int64).reshape(-1, 2)
        check(uses[:, 1], len(self.constants))
        check(uses[:, 0], total)
        ua, ura = place(uses[:, 0])
        inst = np.array([av.index for av in self.instance_cells], dtype=np.int64)
        check(inst, total)
        ia, ira = place(inst)
        copies = np.concatenate([
            np.stack([ca, ra, cb, rb], axis=1),
            np.stack([ua, ura, cfg.col_fixed(uses[:, 1] // u), uses[:, 1] % u], axis=1),
            np.stack([ia, ira, np.full_like(inst, cfg.col_instance(0)),
                      np.arange(inst.shape[0], dtype=np.int64)], axis=1),
        ]).astype(np.int64)
        instances = [[av.value for av in self.instance_cells]]
        return (list(advice), list(lookup), list(fixed), list(selectors), copies,
                instances, break_points)

    def sha_columns(self, cfg: CircuitConfig):
        """The slot list as full region columns ([104, n] uint32 bits,
        [10, n] uint64 words), or (None, None) without slots."""
        if not self.sha_slots:
            return None, None
        if cfg.num_sha_slots < len(self.sha_slots):
            raise ValueError("config allocates fewer sha slots than the circuit used")
        rows = len(self.sha_slots) * SHA_SLOT_ROWS
        sha_bit = np.zeros((SHA_BIT_COLS, cfg.n), np.uint32)
        sha_word = np.zeros((SHA_WORD_COLS, cfg.n), np.uint64)
        sha_bit[:, :rows] = np.concatenate([s["bits"] for s in self.sha_slots]).T
        sha_word[:, :rows] = np.concatenate([s["words"] for s in self.sha_slots]).T
        return sha_bit, sha_word

    def assignment(self, cfg: CircuitConfig) -> Assignment:
        advice, lookup, fixed, selectors, copies, instances, _bp = self.layout(cfg)
        sha_bit, sha_word = self.sha_columns(cfg)
        return Assignment(cfg, advice, lookup, fixed, selectors, instances,
                          copies, sha_bit=sha_bit, sha_word=sha_word)
