"""The constraint expressions, written once, evaluated two ways (the port's
copy of `spectre_tpu/plonk/expressions.py`).

`all_expressions(cfg, ctx)` yields the ordered stream of constraint values;
the prover instantiates ctx over extended-domain tensors, the verifier over
scalars at the challenge point. One definition keeps both sides combining
identical polynomials with identical y-powers.
"""

from __future__ import annotations

from ..fields import bn254
from .constraint_system import (CircuitConfig, PERM_CHUNK, SHA_A, SHA_ACT_WORD,
                                SHA_BIT_COLS, SHA_CARRY, SHA_E, SHA_OUT_ROW,
                                SHA_SEED_ROW, SHA_W)
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

    if cfg.num_sha_slots:
        yield from sha_expressions(cfg, c)


def sha_expressions(cfg: CircuitConfig, c):
    """The wide SHA-256 region's identities (constraint_system.py).

    All identities are homogeneous in the advice cells — the only constant
    term is K_t, entering as fixed_K * act — so all-zero (unused) slots
    satisfy every one. Degree stays <= 4: selector(1) x bitexpr(<=3).

    Column layout inside ("shb", j): w bits 0-31, a bits 32-63, e bits
    64-95, carries 96-103 (ce[3] | ca[3] | cs[2]). act is WORD column 9
    (permutation-enabled so the chip pins it to 1 on used slots). Selectors
    ("shq", s): 0 bit-boolean, 1 seed, 2 round, 3 sched, 4 inp, 5 out,
    6 act-chain. ("shk", 0): per-round K constants."""
    def w(i, rot=0):
        return c.var(("shb", SHA_W + i), rot)

    def a(i, rot=0):
        return c.var(("shb", SHA_A + i), rot)

    def e(i, rot=0):
        return c.var(("shb", SHA_E + i), rot)

    def carry(i, rot=0):
        return c.var(("shb", SHA_CARRY + i), rot)

    def q(s):
        return c.var(("shq", s), 0)

    def xor2(x, y):
        # x + y - 2xy
        return c.sub(c.add(x, y), c.scale(c.mul(x, y), 2))

    def xor3(x, y, z):
        # x+y+z - 2(xy+yz+zx) + 4xyz
        s3 = c.add(c.add(x, y), z)
        p2 = c.add(c.add(c.mul(x, y), c.mul(y, z)), c.mul(z, x))
        p3 = c.mul(c.mul(x, y), z)
        return c.add(c.sub(s3, c.scale(p2, 2)), c.scale(p3, 4))

    def recomb(bit_fn, rot=0):
        acc = None
        for i in range(32):
            t = c.scale(bit_fn(i, rot), 1 << i)
            acc = t if acc is None else c.add(acc, t)
        return acc

    def wsum(terms):
        acc = None
        for t in terms:
            acc = t if acc is None else c.add(acc, t)
        return acc

    # --- booleanness of every bit column (incl. carries) + act ---
    qb = q(0)
    for j in range(SHA_BIT_COLS):
        b = c.var(("shb", j), 0)
        yield c.mul(qb, c.sub(c.mul(b, b), b))
    actv = c.var(("shw", SHA_ACT_WORD), 0)
    yield c.mul(qb, c.sub(c.mul(actv, actv), actv))

    # --- act chain: constant within the slot ---
    yield c.mul(q(6), c.sub(actv, c.var(("shw", SHA_ACT_WORD), -1)))

    # --- seed rows bind the a/e ladders to h_in words (q_seed, row 3) ---
    qs = q(1)
    for j in range(4):
        yield c.mul(qs, c.sub(recomb(a, -j), c.var(("shw", j), 0)))
        yield c.mul(qs, c.sub(recomb(e, -j), c.var(("shw", 4 + j), 0)))

    # --- input rows bind w to the input word column (q_inp, t=0..15) ---
    yield c.mul(q(4), c.sub(recomb(w), c.var(("shw", 8), 0)))

    # --- round identities (q_round, t=0..63) ---
    qr = q(2)
    # sigma1(e[t-1]) bits: rotr6 ^ rotr11 ^ rotr25
    sig1 = recomb(lambda i, _r: xor3(e((i + 6) % 32, -1), e((i + 11) % 32, -1),
                                     e((i + 25) % 32, -1)))
    # ch(e,f,g) = g + e*(f-g) bitwise, on e(t-1), e(t-2), e(t-3)
    ch = recomb(lambda i, _r: c.add(e(i, -3),
                                    c.mul(e(i, -1), c.sub(e(i, -2), e(i, -3)))))
    k_act = c.mul(c.var(("shk", 0), 0), actv)
    # identity A: e(t) + ce*2^32 = a(t-4) + e(t-4) + sig1 + ch + K*act + w(t)
    ce = wsum([c.scale(carry(i), 1 << (32 + i)) for i in range(3)])
    lhs_a = c.add(recomb(e), ce)
    rhs_a = wsum([recomb(a, -4), recomb(e, -4), sig1, ch, k_act, recomb(w)])
    yield c.mul(qr, c.sub(lhs_a, rhs_a))
    # sigma0(a[t-1]) and maj(a(t-1), a(t-2), a(t-3))
    sig0 = recomb(lambda i, _r: xor3(a((i + 2) % 32, -1), a((i + 13) % 32, -1),
                                     a((i + 22) % 32, -1)))

    def majbit(i, _r):
        b1, b2, b3 = a(i, -1), a(i, -2), a(i, -3)
        p12 = c.mul(b1, b2)
        return c.sub(c.add(c.add(p12, c.mul(b1, b3)), c.mul(b2, b3)),
                     c.scale(c.mul(p12, b3), 2))

    maj = recomb(majbit)
    # identity B: a(t) + ca*2^32 + a(t-4) = e(t) + ce*2^32 + sig0 + maj
    ca = wsum([c.scale(carry(3 + i), 1 << (32 + i)) for i in range(3)])
    lhs_b = wsum([recomb(a), ca, recomb(a, -4)])
    rhs_b = wsum([recomb(e), ce, sig0, maj])
    yield c.mul(qr, c.sub(lhs_b, rhs_b))

    # --- schedule (q_sched, t=16..63) ---
    # sigma0s: rotr7 ^ rotr18 ^ shr3 on w(t-15); shr3 bit i = w[i+3], 0 for
    # i > 28; sigma1s: rotr17 ^ rotr19 ^ shr10 on w(t-2)
    def s0bit(i, _r):
        x = w((i + 7) % 32, -15)
        y = w((i + 18) % 32, -15)
        if i <= 28:
            return xor3(x, y, w(i + 3, -15))
        return xor2(x, y)

    def s1bit(i, _r):
        x = w((i + 17) % 32, -2)
        y = w((i + 19) % 32, -2)
        if i <= 21:
            return xor3(x, y, w(i + 10, -2))
        return xor2(x, y)

    cs = wsum([c.scale(carry(6 + i), 1 << (32 + i)) for i in range(2)])
    lhs_s = c.add(recomb(w), cs)
    rhs_s = wsum([recomb(w, -16), recomb(s0bit), recomb(w, -7), recomb(s1bit)])
    yield c.mul(q(3), c.sub(lhs_s, rhs_s))

    # --- output row: h_out = h_in + final ladder (q_out, row 68) ---
    qo = q(5)
    back = SHA_SEED_ROW - SHA_OUT_ROW                # -65
    for j in range(8):
        fin = recomb(a if j < 4 else e, -(1 + (j % 4)))
        lhs_o = c.add(c.var(("shw", j), 0), c.scale(carry(j), 1 << 32))
        rhs_o = c.add(c.var(("shw", j), back), fin)
        yield c.mul(qo, c.sub(lhs_o, rhs_o))


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
