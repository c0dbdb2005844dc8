"""MockProver: constraint satisfaction without proving (the port's copy of
`spectre_tpu/plonk/mock.py`).

halo2's `MockProver::run(...).assert_satisfied()`: the copy constraints
and lookup memberships are checked directly, then every constraint of the
prover's `all_expressions` is evaluated row-wise on the base domain, with
the reference's order of checks, its challenges and its failure messages,
raised as ValueError (where the reference asserts, as everywhere in the
port). The columns are [n, 4] Montgomery tensors on the backend's device
(the kernels on a CUDA device, their plain versions on the CPU); the grand
products are prefix products with one batch inversion a chunk, as the
prover's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields import bn254
from .backend import TorchBackend
from .constraint_system import (PERM_CHUNK, Assignment, CircuitConfig, column_std,
                                permute_lookup, sha_selector_columns, table_column)
from .domain import DELTA, Domain
from .expressions import all_expressions, perm_column_keys
from .keygen import ROT_LAST, build_sigma
from .prover import PhaseTimer, _running_product

R = bn254.R

# any nonzero challenges decide satisfaction; these are the reference's
BETA, GAMMA = 0xBEEF, 0xCAFE


class _TensorCtx:
    """Expression context over [n, 4] Montgomery tensors; rotations are
    index shifts mod n."""

    def __init__(self, cfg: CircuitConfig, dom: Domain, columns: dict, bk):
        self._cfg, self._cols, self._bk = cfg, columns, bk
        n, dev = cfg.n, bk.device
        self.x_col = bk.powers(dom.omega, n)
        one = bk.const(1)[0]

        def indicator(rows) -> torch.Tensor:
            t = torch.zeros((n, 4), dtype=torch.int64, device=dev)
            t[rows] = one
            return t

        self.l0 = indicator(0)
        self.llast = indicator(cfg.last_row)
        self.lblind = indicator(slice(cfg.usable_rows + 1, None))

    def var(self, key, rot):
        col = self._cols[key]
        if rot == ROT_LAST:
            rot = self._cfg.last_row
        return torch.roll(col, -rot, 0) if rot else col

    def mul(self, a, b):
        return self._bk.mul(a, b)

    def add(self, a, b):
        return self._bk.add(a, b)

    def sub(self, a, b):
        return self._bk.sub(a, b)

    def scale(self, a, s):
        return self._bk.scale(a, s % R)

    def add_const(self, a, s):
        return self._bk.add_scalar(a, s)

    def const(self, s):
        return self._bk.const(s)


def _gather(cols: list, c_idx: np.ndarray, r_idx: np.ndarray) -> np.ndarray:
    """Rows r_idx of the [n, 4] columns c_idx, one column at a time."""
    out = np.empty((c_idx.shape[0], 4), dtype=np.uint64)
    order = np.argsort(c_idx, kind="stable")
    bounds = np.searchsorted(c_idx[order], np.arange(len(cols) + 1))
    for c in range(len(cols)):
        idx = order[bounds[c]:bounds[c + 1]]
        if idx.size:
            out[idx] = cols[c][r_idx[idx]]
    return out


def _as_int(limbs: np.ndarray) -> int:
    return sum(int(v) << (64 * i) for i, v in enumerate(limbs))


def _rows_in(rows: np.ndarray, table: np.ndarray) -> np.ndarray:
    """Which [m, 4] uint64 rows appear among the table's rows."""
    void = np.dtype((np.void, 32))
    return np.isin(np.ascontiguousarray(rows).view(void).ravel(),
                   np.ascontiguousarray(table).view(void).ravel())


def mock_prove(cfg: CircuitConfig, assignment: Assignment, fixed_values=None,
               selector_values=None, sigma_values=None, table_values=None,
               device=None) -> bool:
    """True, or ValueError naming the first violated copy, lookup row or
    (expression, row), in the reference's order and words. Keygen's
    products (sigma, the tables) are rebuilt from the assignment when not
    supplied, so a circuit can be checked without an SRS. device: where the
    columns live (default CUDA)."""
    bk = TorchBackend(device)
    dom = Domain(cfg.k)
    n, u = cfg.n, cfg.usable_rows
    fixed_std = [column_std(f, n) for f in (fixed_values or assignment.fixed)]
    sel_std = [column_std(s, n) for s in (selector_values or assignment.selectors)]
    if sigma_values:
        sigma = [bk.from_std(column_std(s, n)) for s in sigma_values]
    else:
        sigma = build_sigma(cfg, assignment.copies, bk, PhaseTimer(bk.device))
    tab_std = [column_std(t, n) for t in (table_values or [
        table_column(cfg, cfg.table_id(j)) for j in range(cfg.num_lookup_advice)])]
    adv_std = [column_std(v, n) for v in assignment.advice]
    ladv_std = [column_std(v, n) for v in assignment.lookup_advice]
    shw_std = [column_std(assignment.sha_word[j], n) for j in range(cfg.num_sha_word)]
    inst_std = [assignment.instance_column(j) for j in range(cfg.num_instance)]

    # --- direct checks first (better messages than the polynomial ones) ---
    by_kind = {"adv": adv_std, "ladv": ladv_std, "fix": fixed_std, "shw": shw_std,
               "inst": inst_std}
    colv = [by_kind[kind][j] for kind, j in perm_column_keys(cfg)]
    cp = np.asarray(assignment.copies, dtype=np.int64).reshape(-1, 4)
    if cp.size:
        va = _gather(colv, cp[:, 0], cp[:, 1])
        vb = _gather(colv, cp[:, 2], cp[:, 3])
        bad = np.nonzero((va != vb).any(axis=1))[0]
        if bad.size:
            i = int(bad[0])
            ca, ra, cb, rb = (int(x) for x in cp[i])
            raise ValueError(
                f"copy constraint violated: col{ca}[{ra}]={_as_int(va[i])} "
                f"!= col{cb}[{rb}]={_as_int(vb[i])}")

    for j, col in enumerate(ladv_std):
        bad = np.nonzero(~_rows_in(col[:u], tab_std[j][:u]))[0]
        if bad.size:
            row = int(bad[0])
            raise ValueError(f"lookup col {j} row {row}: {_as_int(col[row])} not in table")

    # --- full polynomial constraint evaluation (the prover's expressions) ---
    columns = {}
    for kind, cols in (("adv", adv_std), ("ladv", ladv_std), ("fix", fixed_std),
                       ("q", sel_std), ("tab", tab_std), ("inst", inst_std)):
        for j, c in enumerate(cols):
            columns[(kind, j)] = bk.from_std(c)
    for j, s in enumerate(sigma):
        columns[("sig", j)] = s
    if cfg.num_sha_slots:
        for j in range(cfg.num_sha_bit):
            columns[("shb", j)] = bk.from_std(column_std(assignment.sha_bit[j], n))
        for j, c in enumerate(shw_std):
            columns[("shw", j)] = bk.from_std(c)
        sha_sel, sha_k = sha_selector_columns(cfg)
        for j, v in enumerate(sha_sel):
            columns[("shq", j)] = bk.from_std(column_std(v, n))
        columns[("shk", 0)] = bk.from_std(column_std(sha_k, n))

    # grand products, as the prover makes them
    col_keys = perm_column_keys(cfg)
    omega_pows = bk.powers(dom.omega, n)
    prev_end = 1
    for ch in range(cfg.num_perm_chunks):
        num = den = None
        for gidx, key in list(enumerate(col_keys))[ch * PERM_CHUNK:(ch + 1) * PERM_CHUNK]:
            v = columns[key]
            dj = pow(DELTA, gidx, R)
            id_term = bk.add_scalar(bk.add(v, bk.scale(omega_pows, BETA * dj % R)), GAMMA)
            sig_term = bk.add_scalar(bk.add(v, bk.scale(columns[("sig", gidx)], BETA)), GAMMA)
            num = id_term if num is None else bk.mul(num, id_term)
            den = sig_term if den is None else bk.mul(den, sig_term)
        z, end = _running_product(bk, bk.mul(num, bk.inv(den)), u, prev_end)
        prev_end = prev_end * end % R
        columns[("pz", ch)] = z
    if prev_end != 1:
        raise ValueError("permutation grand product != 1")

    for j in range(cfg.num_lookup_advice):
        pa, pt = permute_lookup(cfg, torch.from_numpy(ladv_std[j].view(np.int64)).to(bk.device),
                                torch.from_numpy(tab_std[j].view(np.int64)).to(bk.device))
        columns[("pA", j)] = bk.from_std(pa)
        columns[("pT", j)] = bk.from_std(pt)
        num = bk.mul(bk.add_scalar(columns[("ladv", j)], BETA),
                     bk.add_scalar(columns[("tab", j)], GAMMA))
        den = bk.mul(bk.add_scalar(columns[("pA", j)], BETA),
                     bk.add_scalar(columns[("pT", j)], GAMMA))
        columns[("lz", j)], _ = _running_product(bk, bk.mul(num, bk.inv(den)), u, 1)

    ctx = _TensorCtx(cfg, dom, columns, bk)
    for ei, vals in enumerate(all_expressions(cfg, ctx, BETA, GAMMA)):
        nz = torch.nonzero((vals != 0).any(dim=1))
        if nz.numel():
            row = int(nz[0, 0])
            val = bk.to_ints(vals[row:row + 1])[0]
            raise ValueError(f"constraint #{ei} violated at row {row} (value {val})")
    return True
