"""The quotient sharded over every device of a ShardingPlan (the port of
`spectre_tpu/parallel/sharded_quotient.py`).

The single-device quotient (`plonk/prover.py _quotient`) evaluates every
[4n, 4] extended column, every gate expression and the inverse transform
on one device. On a plan of D > 1 shards this engine runs the same
pipeline with each extended column a list of D row blocks, block i on
shard i's device:

  * LDE prefetch: the columns the expression stream reads, D at a time,
    one column a shard (the batch axis: a coset LDE through K4 on its own
    device), then resharded by rows (block t to shard t: the all-to-all).
  * Gate arithmetic: each primitive (K3 products, the adds, the y-fold) on
    every shard's block, no exchange.
  * Rotations: out[j] = x[(j + s) mod m] for any static shift s = q B + r
    (B = m / D) takes shard (d + q)'s block from row r and r rows of shard
    (d + q + 1): at most two block moves. The SHA region reaches 65 rows
    back and the permutation argument rotates by `last_row`, so no fixed
    halo would do.
  * The fused inverse: the vanishing inverse folded by one table product
    on each shard (as the single-device stage 1 folds it), then the coset
    iNTT as the Bailey split over the same shards, its n^-1 g^-i table
    applied on the shards (`sharded_ntt.bailey`).

Columns and rotations live in the prover's byte-budgeted LRU, so an
evicted one costs a recompute, never a wrong value. The gates are the
reference's: SPECTRE_QUOTIENT_SHARDED=0 turns the engine off,
SPECTRE_SHARD_QUOTIENT_MIN_LOGN (default 18) is the least log2 of the
extended domain it takes; a plan whose shard count cannot split the
domain falls back to the single device visibly (COUNTERS
["quotient_sharded_degraded"], a manifest event, a line on stderr), as
does a failure inside the engine (`plonk/prover.py`).
"""

from __future__ import annotations

import os
import sys

import torch

from ..fields import bn254
from ..ops import field_ops as F, ntt as NTT
from ..plonk.domain import COSET_GEN, EXTENSION
from ..plonk.expressions import all_expressions
from ..plonk.keygen import ROT_LAST
from .plan import ShardingPlan
from .sharded_ntt import bailey

R = bn254.R

# visible fallbacks of the mesh quotient (the reference's ServiceHealth
# counter), beside ops.msm.COUNTERS
COUNTERS = {"quotient_sharded_degraded": 0}


def _shard_min_logn() -> int:
    return int(os.environ.get("SPECTRE_SHARD_QUOTIENT_MIN_LOGN", "18"))


def eligible(plan: ShardingPlan, m: int) -> bool:
    """Whether the plan's shard count divides both Bailey dims of the
    extended domain (which also partitions its rows into equal blocks)."""
    d = plan.n_devices
    if d <= 1 or m % d or m & (m - 1):
        return False
    logm = m.bit_length() - 1
    logr = logm // 2
    return (1 << logr) % d == 0 and (1 << (logm - logr)) % d == 0


def degrade(reason: str, **detail) -> None:
    """Count a fall back to the single-device quotient, visibly."""
    COUNTERS["quotient_sharded_degraded"] += 1
    from ..observability.manifest import record_event
    record_event("quotient_sharded_degraded", reason=reason, **detail)
    print(f"[quotient] sharded quotient degraded ({reason}): {detail}; this quotient "
          f"runs on one device", file=sys.stderr, flush=True)


def mesh_engine(bk, dom):
    """The sharded engine when the mesh path applies, else None. Quietly
    None: the kill switch, a one-device plan, a domain below the gate;
    visibly (`degrade`): a plan whose shards cannot split the domain."""
    if os.environ.get("SPECTRE_QUOTIENT_SHARDED", "1") == "0":
        return None
    plan = bk.plan
    if plan.n_devices <= 1:
        return None
    if dom.n_ext.bit_length() - 1 < _shard_min_logn():
        return None
    if not eligible(plan, dom.n_ext):
        degrade("ineligible_shape", n_ext=dom.n_ext, n_devices=plan.n_devices)
        return None
    return MeshQuotientEngine(plan, bk, dom)


class MeshQuotientEngine:
    """The quotient's device work over row-sharded extended columns (lists
    of D blocks [m / D, 4], block i on shard i's device)."""

    name = "sharded"

    def __init__(self, plan: ShardingPlan, bk, dom):
        self.plan, self.bk, self.dom = plan, bk, dom
        self.devices = plan.batch_devices
        self.m = dom.n_ext
        self.block = self.m // len(self.devices)
        self._consts: dict = {}

    def shard_rows(self, t: torch.Tensor, src: int = -1) -> list:
        """A [m, 4] tensor of shard `src` (-1: the caller) as row blocks."""
        b = self.block
        return [self.plan.move(t[i * b:(i + 1) * b], src, i, dev)
                for i, dev in enumerate(self.devices)]

    def lde(self, polys: list) -> list:
        """Coset LDEs of coefficient tensors [n, 4] as row-sharded columns:
        poly j on shard j mod D (a K4 transform there), then resharded."""
        out = [None] * len(polys)
        d = len(self.devices)
        for base in range(0, len(polys), d):
            for i, p in enumerate(polys[base:base + d]):
                dev = self.devices[i]
                e = NTT.coset_lde(self.plan.move(p, -1, i, dev)[None], self.dom.omega_ext,
                                  COSET_GEN, self.m, NTT.Twiddles(dev))[0]
                out[base + i] = self.shard_rows(e, i)
        return out

    def roll(self, col: list, shift: int) -> list:
        """out[j] = x[(j + shift) mod m] (torch.roll by -shift) of a
        row-sharded column: at most two block moves a shard."""
        d, b = len(col), self.block
        q, r = divmod(shift % self.m, b)
        out = []
        for i, dev in enumerate(self.devices):
            a = self.plan.move(col[(i + q) % d], (i + q) % d, i, dev)
            if r == 0:
                out.append(a)
                continue
            nxt = self.plan.move(col[(i + q + 1) % d][:r], (i + q + 1) % d, i, dev)
            out.append(torch.cat([a[r:], nxt]))
        return out

    def const(self, i: int, s: int) -> torch.Tensor:
        """The Montgomery [1, 4] value s on shard i's device."""
        key = (str(self.devices[i]), s % R)
        hit = self._consts.get(key)
        if hit is None:
            hit = self._consts[key] = F.const(F.fr_ctx(), s % R, self.devices[i])
        return hit

    def map(self, fn, *cols) -> list:
        """fn applied shard by shard to row-sharded operands."""
        self.plan.count("quotient_ops")
        return [fn(i, *(c[i] for c in cols)) for i in range(len(self.devices))]

    def inverse(self, acc: list) -> torch.Tensor:
        """h in coefficient form [m, 4] on the backend's device: the
        vanishing inverse folded by one table product a shard, then the
        coset iNTT as the Bailey split over the shards, n^-1 g^-i applied
        there."""
        ctx = F.fr_ctx()
        vinv = self.bk.from_ints(list(self.dom.vanishing_inv_period_vals()))
        h = [self.plan.move(F.mont_mul(ctx, a, self.plan.move(vinv, -1, -1, a.device)), i, -1,
                            self.bk.device)
             for i, a in enumerate(acc)]
        post = self.bk.tables.ilde_post(COSET_GEN, self.m)
        return bailey(torch.cat(h), pow(self.dom.omega_ext, -1, R), self.plan, self.devices,
                      post=post)


class MeshCtx:
    """`all_expressions` context over row-sharded extended columns: the
    mesh twin of the prover's `_TensorCtx`, with its ops in the same
    order."""

    def __init__(self, engine: MeshQuotientEngine, ext):
        self._e, self._ext = engine, ext
        self._ctx = F.fr_ctx()
        self.l0 = self.llast = self.lblind = self.x_col = None

    def var(self, key, rot):
        return self._ext(key, rot)

    def mul(self, a, b):
        def one(i, x, y):
            if x.shape[0] == 1 and y.shape[0] != 1:
                x, y = y, x
            return F.mont_mul(self._ctx, x.contiguous(), y.contiguous())
        return self._e.map(one, a, b)

    def add(self, a, b):
        return self._e.map(lambda i, x, y: F.add(self._ctx, x, y), a, b)

    def sub(self, a, b):
        return self._e.map(lambda i, x, y: F.sub(self._ctx, x, y), a, b)

    def scale(self, a, s):
        return self._e.map(lambda i, x: F.mont_mul(self._ctx, x.contiguous(),
                                                   self._e.const(i, s)), a)

    def add_const(self, a, s):
        return self._e.map(lambda i, x: F.add(self._ctx, x, self._e.const(i, s)), a)

    def const(self, s):
        return [self._e.const(i, s) for i in range(len(self._e.devices))]

    def fold(self, acc, y, e):
        """acc y + e, the y-fold (the backend's `axpy`)."""
        return self._e.map(lambda i, a, x: F.add(
            self._ctx, F.mont_mul(self._ctx, a.contiguous(), self._e.const(i, y)), x), acc, e)


def referenced_keys(cfg) -> list:
    """The column keys `all_expressions` reads, in first-read order."""
    class _Recorder:
        l0 = llast = lblind = x_col = None

        def __init__(self):
            self.keys = {}

        def var(self, key, rot):
            self.keys.setdefault(key, None)

        def mul(self, a, b):
            return None

        add = sub = mul

        def scale(self, a, s):
            return None

        add_const = scale

        def const(self, s):
            return None

    rec = _Recorder()
    for _ in all_expressions(cfg, rec, 1, 1):
        pass
    return list(rec.keys)


def quotient(engine: MeshQuotientEngine, cfg, dom, poly_for, beta: int, gamma: int, y: int,
             lru) -> torch.Tensor:
    """h(X) in coefficient form [4n, 4] on the backend's device, the same
    values as the single-device quotient: the expression stream folded one
    expression at a time over row-sharded extended columns drawn through
    `lru` (the prover's byte-budgeted cache), then the fused inverse."""
    bk, n, u = engine.bk, cfg.n, cfg.usable_rows
    engine.plan.count("quotient")

    def ext(key, rot=0):
        rkey = (key, rot)
        hit = lru.get(rkey)
        if hit is not None:
            return hit
        if rot == 0:
            return lru.put(rkey, engine.lde([poly_for(key)])[0])
        r = cfg.last_row if rot == ROT_LAST else rot
        return lru.put(rkey, engine.roll(ext(key), r * EXTENSION))

    def lagrange_ext(rows):
        vals = torch.zeros((n, 4), dtype=torch.int64, device=bk.device)
        vals[rows] = bk.const(1)
        return engine.lde([dom.lagrange_to_coeff(vals, bk)])[0]

    keys = referenced_keys(cfg)
    d = len(engine.devices)
    for base in range(0, len(keys), d):
        chunk = [k for k in keys[base:base + d] if lru.get((k, 0)) is None]
        for k, col in zip(chunk, engine.lde([poly_for(k) for k in chunk])):
            lru.put((k, 0), col)

    ctx = MeshCtx(engine, ext)
    ctx.l0 = lagrange_ext([0])
    ctx.llast = lagrange_ext([cfg.last_row])
    ctx.lblind = lagrange_ext(list(range(u + 1, n)))
    ctx.x_col = engine.shard_rows(bk.scale(bk.powers(dom.omega_ext, dom.n_ext), COSET_GEN))

    acc = None
    for e in all_expressions(cfg, ctx, beta, gamma):
        acc = e if acc is None else ctx.fold(acc, y, e)
    # the columns go before the inverse, as on one device; `ext` calls
    # itself, a reference cycle that would otherwise hold them (and the
    # caller's LRU) until the garbage collector's next full pass
    del ctx, ext
    lru.clear()
    return engine.inverse(acc)
