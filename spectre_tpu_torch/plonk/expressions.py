"""The constraint expressions, written once, evaluated two ways (the port's
copy of `spectre_tpu/plonk/expressions.py`, without the SHA region).

`all_expressions(cfg, ctx)` yields the ordered stream of constraint values;
the prover instantiates ctx over extended-domain tensors, the verifier over
scalars at the challenge point. One definition keeps both sides combining
identical polynomials with identical y-powers.
"""

from __future__ import annotations

from ..fields import bn254
from .constraint_system import CircuitConfig, PERM_CHUNK
from .domain import DELTA
from .keygen import ROT_LAST

R = bn254.R


def perm_column_keys(cfg: CircuitConfig):
    """Global permutation column index -> var key."""
    keys = []
    for j in range(cfg.num_advice):
        keys.append(("adv", j))
    for j in range(cfg.num_lookup_advice):
        keys.append(("ladv", j))
    for j in range(cfg.num_fixed):
        keys.append(("fix", j))
    for j in range(cfg.num_sha_word):
        keys.append(("shw", j))
    for j in range(cfg.num_instance):
        keys.append(("inst", j))
    return keys


def all_expressions(cfg: CircuitConfig, c, beta: int, gamma: int):
    """Ordered constraint stream. ctx protocol: var(key, rot), mul/add/sub,
    scale(a, int), add_const(a, int), const(int), l0, llast, lblind, x_col.

    A generator: in the prover each expression is a full extended-domain
    tensor (256 MB at k=21), so yielding one at a time into the y-fold keeps
    a single expression live."""
    cfg.validate()
    one = c.const(1)

    # --- gates: q_j * (a + a1*a2 - a3) ---
    for j in range(cfg.num_advice):
        a0 = c.var(("adv", j), 0)
        a1 = c.var(("adv", j), 1)
        a2 = c.var(("adv", j), 2)
        a3 = c.var(("adv", j), 3)
        q = c.var(("q", j), 0)
        yield c.mul(q, c.sub(c.add(a0, c.mul(a1, a2)), a3))

    # --- permutation argument ---
    col_keys = perm_column_keys(cfg)
    nch = cfg.num_perm_chunks
    act = c.sub(one, c.add(c.llast, c.lblind))
    yield c.mul(c.l0, c.sub(c.var(("pz", 0), 0), one))
    for ch in range(1, nch):
        yield c.mul(c.l0, c.sub(c.var(("pz", ch), 0),
                                c.var(("pz", ch - 1), ROT_LAST)))
    for ch in range(nch):
        cols = list(enumerate(col_keys))[ch * PERM_CHUNK:(ch + 1) * PERM_CHUNK]
        left = c.var(("pz", ch), 1)
        right = c.var(("pz", ch), 0)
        for gidx, key in cols:
            v = c.var(key, 0)
            sig = c.var(("sig", gidx), 0)
            left = c.mul(left, c.add_const(c.add(v, c.scale(sig, beta)), gamma))
            dj = pow(DELTA, gidx, R)
            right = c.mul(right, c.add_const(
                c.add(v, c.scale(c.x_col, beta * dj % R)), gamma))
        yield c.mul(act, c.sub(left, right))
    zl = c.var(("pz", nch - 1), 0)
    yield c.mul(c.llast, c.sub(c.mul(zl, zl), zl))

    # --- lookups ---
    for j in range(cfg.num_lookup_advice):
        a = c.var(("ladv", j), 0)
        pa = c.var(("pA", j), 0)
        pa_prev = c.var(("pA", j), -1)
        pt = c.var(("pT", j), 0)
        tab = c.var(("tab", j), 0)
        lz = c.var(("lz", j), 0)
        lz1 = c.var(("lz", j), 1)
        yield c.mul(c.l0, c.sub(lz, one))
        left = c.mul(lz1, c.mul(c.add_const(pa, beta), c.add_const(pt, gamma)))
        right = c.mul(lz, c.mul(c.add_const(a, beta), c.add_const(tab, gamma)))
        yield c.mul(act, c.sub(left, right))
        yield c.mul(c.llast, c.sub(c.mul(lz, lz), lz))
        yield c.mul(c.l0, c.sub(pa, pt))
        yield c.mul(act, c.mul(c.sub(pa, pt), c.sub(pa, pa_prev)))


class ScalarCtx:
    """Verifier side: everything is an int mod R; vars come from proof evals."""

    def __init__(self, cfg, evals: dict, l0: int, llast: int, lblind: int, x: int):
        self._evals = evals
        self.l0 = l0
        self.llast = llast
        self.lblind = lblind
        self.x_col = x

    def var(self, key, rot):
        return self._evals[(key, rot)]

    def mul(self, a, b):
        return a * b % R

    def add(self, a, b):
        return (a + b) % R

    def sub(self, a, b):
        return (a - b) % R

    def scale(self, a, s):
        return a * s % R

    def add_const(self, a, s):
        return (a + s) % R

    def const(self, s):
        return s % R
