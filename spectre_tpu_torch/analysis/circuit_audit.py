"""The circuit soundness audit over a builder Context and its CircuitConfig
(the port of `spectre_tpu/analysis/circuit_audit.py`: the same rules,
keys and messages, over the port's flat-array builder).

Rules (all keyed for baseline suppression, see findings.py):

  CA-UNDERCONSTRAINED  error    ungated advice cell referenced by no gate,
                                copy, constant pin, lookup push or
                                instance exposure: a free witness.
  CA-DEGREE            error    constraint expression whose column-degree
                                exceeds cfg.max_expr_degree (the quotient
                                would not fit the committed h chunks).
  CA-TABLE-UNBOUND     error    lookup stream with no configured
                                lookup-advice column, or a configured table
                                id the constraint system cannot make.
  CA-TABLE-OVERFLOW    error    lookup stream longer than its columns hold.
  CA-COPY-ORPHAN       error    copy, constant pin or instance exposure
                                naming a cell that was never assigned.
  CA-DEAD-SELECTOR     warning  all-zero selector column (a dead gate).
  CA-DEAD-FIXED        warning  all-zero fixed column.
  CA-ROW-UNBOUND       error    placed advice cell on a row no gate window
                                (rotations 0..+3) covers and no copy,
                                constant or instance endpoint binds.
  CA-ROW-DEAD-SELECTOR warning  selector firing on a row whose window reads
                                no placed cell; SHA selectors armed over
                                slots the circuit never filled.

The port's Context keeps copy endpoints as int codes ((index << 3) | kind,
builder/context.py) and lays out with numpy, so the walks here are numpy
over those arrays; the findings are the reference's, key for key and
message for message. Pure host code: no SRS, keygen or prove.
"""

from __future__ import annotations

import numpy as np

from ..builder.context import ADV, SHW
from ..plonk.constraint_system import (GATE_ROWS, SHA_SLOT_ROWS, SHA_WORD_COLS,
                                       CircuitConfig, gate_coverage,
                                       sha_selector_columns, table_column)
from ..plonk.expressions import all_expressions
from .findings import Finding, Severity

_CS_FILE = "spectre_tpu_torch/plonk/constraint_system.py"
_CTX_FILE = "spectre_tpu_torch/builder/context.py"


class DegreeCtx:
    """all_expressions context computing each expression's column-degree:
    every column polynomial (advice, fixed, selector, sigma, grand product,
    l0/llast/lblind, the identity X) counts as degree 1; mul adds degrees,
    add/sub take the max, scalar ops keep them. The protocol of the
    prover's and verifier's contexts (plonk/prover.py `_TensorCtx`), so the
    audited degrees are those of the expressions that get proven."""

    l0 = 1
    llast = 1
    lblind = 1
    x_col = 1

    def var(self, key, rot):
        return 1

    def mul(self, a, b):
        return a + b

    def add(self, a, b):
        return max(a, b)

    def sub(self, a, b):
        return max(a, b)

    def scale(self, a, s):
        return a

    def add_const(self, a, s):
        return a

    def const(self, s):
        return 0


def expression_degrees(cfg: CircuitConfig, expressions_fn=all_expressions):
    """Column-degree of every constraint expression, in yield order."""
    # beta/gamma enter as scalars (degree 0); any values work
    return list(expressions_fn(cfg, DegreeCtx(), 0xBEEF, 0xCAFE))


def _audit_degrees(cfg, name, expressions_fn) -> list:
    out = []
    budget = cfg.max_expr_degree
    for i, deg in enumerate(expression_degrees(cfg, expressions_fn)):
        if deg > budget:
            out.append(Finding(
                "circuit", "CA-DEGREE", Severity.ERROR, _CS_FILE, name,
                f"expression #{i} has column-degree {deg} > budget {budget} "
                f"(quotient would overflow the committed h chunks)",
                key=f"CA-DEGREE:{name}:expr{i}"))
    return out


def _audit_cell_references(ctx, name) -> list:
    refs = ctx.cell_references()
    loose = np.nonzero((refs["gated"] == 0) & (refs["referenced"] == 0))[0]
    if not loose.size:
        return []
    preview = ", ".join(str(int(i)) for i in loose[:8])
    more = f", ... ({loose.size} total)" if loose.size > 8 else ""
    return [Finding(
        "circuit", "CA-UNDERCONSTRAINED", Severity.ERROR, _CTX_FILE, name,
        f"{loose.size} ungated advice cell(s) with no gate/copy/lookup/"
        f"instance reference: stream indices [{preview}{more}] — free "
        f"witnesses the proof never binds",
        # the count in the key: a baseline entry resurfaces if the number
        # of accepted loose cells drifts
        key=f"CA-UNDERCONSTRAINED:{name}:{loose.size}")]


def _audit_tables(ctx, cfg, name) -> list:
    out = []
    configured: dict = {}
    for j in range(cfg.num_lookup_advice):
        configured[cfg.table_id(j)] = configured.get(cfg.table_id(j), 0) + 1
    for tid in configured:
        try:
            table_column(cfg, tid)
        except KeyError:
            out.append(Finding(
                "circuit", "CA-TABLE-UNBOUND", Severity.ERROR, _CS_FILE, name,
                f"configured lookup table id {tid!r} is unknown to "
                f"table_column() — keygen would fail",
                key=f"CA-TABLE-UNBOUND:{name}:cfg:{tid}"))
    u = cfg.usable_rows
    for tid, stream in ctx.lkp_streams.items():
        ncols = configured.get(tid, 0)
        if ncols == 0:
            out.append(Finding(
                "circuit", "CA-TABLE-UNBOUND", Severity.ERROR, _CS_FILE, name,
                f"lookup stream {tid!r} ({len(stream)} cells) has no "
                f"lookup-advice column bound in cfg.lookup_tables "
                f"{cfg.lookup_tables!r} — layout would fail and the lookups "
                f"would never be enforced",
                key=f"CA-TABLE-UNBOUND:{name}:{tid}"))
        elif len(stream) > ncols * u:
            out.append(Finding(
                "circuit", "CA-TABLE-OVERFLOW", Severity.ERROR, _CS_FILE, name,
                f"lookup stream {tid!r} has {len(stream)} cells but the "
                f"{ncols} configured column(s) hold only {ncols * u}",
                key=f"CA-TABLE-OVERFLOW:{name}:{tid}"))
    return out


def _endpoint_error(ctx, code: int) -> str | None:
    """What is wrong with a copy endpoint code, or None."""
    kind, idx = code & 7, code >> 3
    n_adv = len(ctx.adv_values)
    if kind == ADV:
        return None if 0 <= idx < n_adv else f"advice index {idx} outside stream of {n_adv}"
    if kind == SHW:
        j, row = idx >> 32, idx & 0xFFFFFFFF
        if not 0 <= j < SHA_WORD_COLS:
            return f"sha word column {j} out of range"
        if not 0 <= row < len(ctx.sha_slots) * SHA_SLOT_ROWS:
            return f"sha word row {row} outside the {len(ctx.sha_slots)} allocated slot(s)"
        return None
    tid = next((t for t, k in ctx._lkp_kind.items() if k == kind), None)
    st = ctx.lkp_streams.get(tid) if tid is not None else None
    if st is None:
        return f"lookup stream {tid!r} does not exist"
    if not 0 <= idx < len(st):
        return f"lookup index {idx} outside {tid!r} stream of {len(st)}"
    return None


def _bad_codes(ctx, codes: np.ndarray) -> np.ndarray:
    """Positions of the endpoint codes that may be in error, in order: a
    cheap vector test, each hit then checked by `_endpoint_error`."""
    kind, idx = codes & 7, codes >> 3
    ok = (kind == ADV) & (idx >= 0) & (idx < len(ctx.adv_values))
    ok |= (kind == SHW) & (idx >> 32 < SHA_WORD_COLS) & \
        (idx & 0xFFFFFFFF < len(ctx.sha_slots) * SHA_SLOT_ROWS)
    for tid, k in ctx._lkp_kind.items():
        st = ctx.lkp_streams.get(tid)
        if st is not None:
            ok |= (kind == k) & (idx >= 0) & (idx < len(st))
    return np.nonzero(~ok)[0]


def _audit_copy_orphans(ctx, cfg, name) -> list:
    n_adv = len(ctx.adv_values)
    out = []
    seen = set()

    def report(detail, where):
        if detail in seen:
            return
        seen.add(detail)
        out.append(Finding(
            "circuit", "CA-COPY-ORPHAN", Severity.ERROR, _CTX_FILE, name,
            f"{where} references an unassigned cell: {detail} — the "
            f"permutation cycle would touch a cell no column carries",
            key=f"CA-COPY-ORPHAN:{name}:{detail}"))

    codes = np.array(ctx.copies, dtype=np.int64)
    for pos in _bad_codes(ctx, codes):
        err = _endpoint_error(ctx, int(codes[pos]))
        if err:
            report(err, "copy constraint")
    n_const_rows = len(ctx.constants)
    uses = np.array(ctx.const_uses, dtype=np.int64).reshape(-1, 2)
    bad = (uses[:, 0] < 0) | (uses[:, 0] >= n_adv) | (uses[:, 1] < 0) | \
        (uses[:, 1] >= n_const_rows)
    for adv_idx, fix_row in uses[bad].tolist():
        if not 0 <= adv_idx < n_adv:
            report(f"advice index {adv_idx} outside stream of {n_adv}", "constant pin")
        if not 0 <= fix_row < n_const_rows:
            report(f"fixed row {fix_row} outside the {n_const_rows} interned constants",
                   "constant pin")
    for av in ctx.instance_cells:
        err = _endpoint_error(ctx, av.index << 3)
        if err:
            report(err, "instance exposure")
    if len(ctx.instance_cells) > cfg.usable_rows:
        report(f"{len(ctx.instance_cells)} instance cells exceed "
               f"usable rows {cfg.usable_rows}", "instance column")
    return out


def _audit_dead_columns(ctx, cfg, name) -> list:
    out = []
    try:
        _adv, _lkp, fixed, selectors, _cp, _inst, _bp = ctx.layout(cfg)
    except (ValueError, KeyError) as e:
        # a broken layout is already reported by the orphan/table rules;
        # surface the failure rather than crash the audit
        return [Finding(
            "circuit", "CA-DEAD-FIXED", Severity.WARNING, _CTX_FILE, name,
            f"layout failed ({e}) — dead-column audit skipped",
            key=f"CA-LAYOUT-FAILED:{name}")]
    for j, col in enumerate(selectors):
        if not np.any(col):
            out.append(Finding(
                "circuit", "CA-DEAD-SELECTOR", Severity.WARNING, _CS_FILE, name,
                f"selector column {j} is all-zero: the vertical gate in "
                f"advice column {j} is never active (dead gate)",
                key=f"CA-DEAD-SELECTOR:{name}:{j}"))
    for j, col in enumerate(fixed):
        if not np.any(col):
            out.append(Finding(
                "circuit", "CA-DEAD-FIXED", Severity.WARNING, _CS_FILE, name,
                f"fixed column {j} is all-zero (dead constants column)",
                key=f"CA-DEAD-FIXED:{name}:{j}"))
    return out


def _mutated(mutate, placement, selectors, copies):
    """Run the mutation hook on copies of the reference's forms
    (placement {stream index: (column, row)}, selectors as lists, copies
    as ((col, row), (col, row)) pairs); back to arrays."""
    pl = {i: (int(c), int(r)) for i, (c, r) in enumerate(zip(*placement))}
    cp = [((a, b), (c, d)) for a, b, c, d in copies.tolist()]
    res = mutate(pl, [list(c) for c in np.asarray(selectors).tolist()], cp)
    if res is None:
        return placement, selectors, copies
    pl, sel, cp = res
    idx = np.fromiter(pl.keys(), dtype=np.int64, count=len(pl))
    cr = np.array(list(pl.values()), dtype=np.int64).reshape(-1, 2)
    arr = np.array([[a, b, c, d] for (a, b), (c, d) in cp], dtype=np.int64).reshape(-1, 4)
    return (cr[:, 0], cr[:, 1], idx), np.asarray(sel, dtype=np.uint64), arr


def audit_rows(ctx, cfg, name, mutate=None) -> list:
    """Row-wise gate-coverage audit over the physical assignment grid.

    Joins `ctx.cell_placement(cfg)` (stream index -> (column, row)) with
    the layout's selector grid and the global copy endpoints: a placed cell
    no selector window (rotations 0..+GATE_ROWS-1, `gate_coverage`) reads
    and no copy, constant or instance endpoint lands on is CA-ROW-UNBOUND;
    a selector firing on a row whose window holds no placed cell is
    CA-ROW-DEAD-SELECTOR, as are SHA selectors armed over unfilled slots.

    `mutate` is for the mutation tests: it receives copies of
    (placement, selectors, copies) in the reference's forms and may return
    a modified triple; seeded row-level bugs must surface as findings."""
    try:
        _adv, _lkp, _fx, selectors, copies, _inst, _bp = ctx.layout(cfg)
        col_of, row_of = ctx.cell_placement(cfg)
    except (ValueError, KeyError) as e:
        return [Finding(
            "circuit", "CA-ROW-UNBOUND", Severity.WARNING, _CTX_FILE, name,
            f"layout failed ({e}) — row-coverage audit skipped",
            key=f"CA-ROW-LAYOUT-FAILED:{name}")]
    idxs = np.arange(col_of.shape[0], dtype=np.int64)
    if mutate is not None:
        (col_of, row_of, idxs), selectors, copies = _mutated(
            mutate, (col_of, row_of), selectors, copies)

    n, ncols = cfg.n, cfg.num_advice
    cov = gate_coverage(selectors)                      # [ncols, n]
    bound = np.zeros((ncols, n), np.uint8)
    if len(copies):
        ends = np.asarray(copies, dtype=np.int64).reshape(-1, 2)
        cc, rr = ends[:, 0], ends[:, 1]
        ok = (cc >= 0) & (cc < ncols) & (rr >= 0) & (rr < n)
        bound[cc[ok], rr[ok]] = 1

    out = []
    occ = np.zeros((ncols, n), np.uint8)
    if idxs.size:
        cols, rows = col_of, row_of
        free = (cov[cols, rows] == 0) & (bound[cols, rows] == 0)
        if free.any():
            per_col = np.bincount(cols[free], minlength=ncols)
            for c in np.nonzero(per_col)[0]:
                sel = free & (cols == c)
                where = sorted(zip(rows[sel].tolist(), idxs[sel].tolist()))[:6]
                preview = ", ".join(f"r{r}(cell {i})" for r, i in where)
                more = (f", ... ({int(per_col[c])} total)" if per_col[c] > 6 else "")
                out.append(Finding(
                    "circuit", "CA-ROW-UNBOUND", Severity.ERROR, _CTX_FILE, name,
                    f"advice column {int(c)}: {int(per_col[c])} placed "
                    f"cell(s) on rows no gate window covers and no copy "
                    f"binds [{preview}{more}] — free witness rows",
                    key=f"CA-ROW-UNBOUND:{name}:col{int(c)}:{int(per_col[c])}"))
        # occupancy -> window occupancy: selector row r is live iff any of
        # rows r..r+GATE_ROWS-1 holds a placed cell
        occ[cols, rows] = 1
    wocc = occ.copy()
    for off in range(1, GATE_ROWS):
        wocc[:, :n - off] |= occ[:, off:]
    sel_grid = np.asarray(selectors, np.uint8)
    dead = (sel_grid == 1) & (wocc == 0)
    for c in np.nonzero(dead.any(axis=1))[0]:
        drows = np.nonzero(dead[c])[0]
        preview = ", ".join(str(int(r)) for r in drows[:6])
        more = f", ... ({len(drows)} total)" if len(drows) > 6 else ""
        out.append(Finding(
            "circuit", "CA-ROW-DEAD-SELECTOR", Severity.WARNING, _CTX_FILE, name,
            f"selector column {int(c)} fires on {len(drows)} row(s) whose "
            f"gate window reads no placed cell [rows {preview}{more}] — "
            f"vacuous gate activation",
            key=f"CA-ROW-DEAD-SELECTOR:{name}:col{int(c)}:{len(drows)}"))

    if cfg.num_sha_slots:
        # structural SHA selectors patterned for cfg.num_sha_slots slots;
        # rows of slots the circuit never filled are vacuously gated
        sha_sel, _k = sha_selector_columns(cfg)
        used_rows = len(ctx.sha_slots) * SHA_SLOT_ROWS
        stale = np.asarray(sha_sel, np.uint8)[:, used_rows:]
        for j in np.nonzero(stale.any(axis=1))[0]:
            cnt = int(stale[j].sum())
            out.append(Finding(
                "circuit", "CA-ROW-DEAD-SELECTOR", Severity.WARNING, _CS_FILE, name,
                f"sha selector {int(j)} armed on {cnt} row(s) beyond the "
                f"{len(ctx.sha_slots)} filled slot(s) (cfg allocates "
                f"{cfg.num_sha_slots}) — vacuous structural gating",
                key=f"CA-ROW-DEAD-SELECTOR:{name}:sha{int(j)}:{cnt}"))
    return out


def audit_context(ctx, cfg: CircuitConfig, name: str,
                  expressions_fn=all_expressions, row_mutate=None) -> list:
    """Run every circuit-audit rule; returns findings in severity order.

    `expressions_fn` is for the mutation tests: a constraint generator with
    a seeded over-degree expression must give CA-DEGREE. `row_mutate` is
    the row audit's hook (`audit_rows`)."""
    findings = []
    findings += _audit_cell_references(ctx, name)
    findings += _audit_degrees(cfg, name, expressions_fn)
    findings += _audit_tables(ctx, cfg, name)
    findings += _audit_copy_orphans(ctx, cfg, name)
    findings += _audit_dead_columns(ctx, cfg, name)
    findings += audit_rows(ctx, cfg, name, mutate=row_mutate)
    findings.sort(key=lambda f: -Severity.ORDER[f.severity])
    return findings
