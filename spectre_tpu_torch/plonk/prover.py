"""The prover: witness commitments -> grand products -> quotient -> multiopen
(the port of `spectre_tpu/plonk/prover.py` and of the device quotient of
`plonk/quotient_device.py`).

Every column lives on the backend's device as an [n, 4] Montgomery tensor;
the reference's per-element Python loops (blinding, the grand products'
running products, the Horner evaluations) are tensor ops here. The
transcript order, the point encoding and the order of `blinding_rng` calls
are the reference's exactly, so a seeded prove gives the same bytes in both
packages.
"""

from __future__ import annotations

import collections
import secrets
import time

import torch

from ..fields import bn254
from ..ops import field_ops as F, limbs as L
from ..parallel import sharded_quotient as SQ
from .backend import TorchBackend
from . import kzg
from .constraint_system import (Assignment, NUM_H_CHUNKS, PERM_CHUNK,
                                column_std, permute_lookup)
from .domain import COSET_GEN, DELTA
from .expressions import all_expressions, perm_column_keys
from .keygen import ProvingKey, ROT_LAST
from .srs import SRS
from .transcript import Blake2bTranscript

R = bn254.R


class PhaseTimer:
    """Wall-clock seconds per prove phase (synchronizing the device at each
    boundary, so a phase holds the device work it enqueued)."""

    def __init__(self, device):
        self.device = device
        self.seconds: dict = {}
        self._t = None
        self._name = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self, name: str):
        self.stop()
        self._sync()
        self._name, self._t = name, time.perf_counter()

    def stop(self):
        if self._name is not None:
            self._sync()
            self.seconds[self._name] = (self.seconds.get(self._name, 0.0)
                                        + time.perf_counter() - self._t)
            self._name = None


class _ExtCache:
    """Byte-budgeted LRU of extended-coset tensors. Every entry is derived
    data (an LDE of a polynomial the prover holds, or a rotation of another
    entry), so eviction costs recompute time, never correctness."""

    def __init__(self, budget_bytes: int):
        self.budget = budget_bytes
        self._d = collections.OrderedDict()
        self._bytes = 0

    def get(self, key):
        hit = self._d.get(key)
        if hit is not None:
            self._d.move_to_end(key)
        return hit

    @staticmethod
    def _size(t) -> int:
        """Bytes of a tensor, or of a row-sharded column (a list of them)."""
        if isinstance(t, list):
            return sum(x.numel() * x.element_size() for x in t)
        return t.numel() * t.element_size()

    def put(self, key, t):
        size = self._size(t)
        if size > self.budget:
            return t
        while self._bytes + size > self.budget and self._d:
            _, old = self._d.popitem(last=False)
            self._bytes -= self._size(old)
        self._d[key] = t
        self._bytes += size
        return t

    def clear(self) -> None:
        """Drop every entry (their device memory)."""
        self._d.clear()
        self._bytes = 0


def _ext_budget(device: torch.device) -> int:
    """LRU budget: 45% of the card's memory (the key, the prover's columns
    and one expression's temporaries share the rest); 2 GiB on the CPU."""
    if device.type == "cuda":
        return int(torch.cuda.get_device_properties(device).total_memory * 0.45)
    return 2 << 30


class _TensorCtx:
    """Prover-side expression context over extended-domain tensors."""

    def __init__(self, cfg, dom, bk, ext):
        self._cfg, self._dom, self._bk, self._ext = cfg, dom, bk, ext
        self.x_col = bk.scale(bk.powers(dom.omega_ext, dom.n_ext), COSET_GEN)
        self.l0 = self.llast = self.lblind = None

    def var(self, key, rot):
        return self._ext(key, rot)

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


def _set_rows(bk, t: torch.Tensor, start: int, vals: list) -> torch.Tensor:
    """t with rows start.. replaced by the given ints."""
    if not vals:
        return t
    out = t.clone()
    out[start:start + len(vals)] = bk.from_ints(vals)
    return out


def _running_product(bk, ratio: torch.Tensor, u: int, start: int):
    """z = [start, start*p0, start*p0*p1, ...] with the ratio's rows >= u
    deactivated (set to one); also returns the product over rows < u."""
    n = ratio.shape[0]
    one = bk.const(1)
    ratio = ratio.clone()
    ratio[u:] = one
    prefix = bk.prefix_prod(ratio)
    end = bk.to_ints(prefix[u - 1:u])[0] if u >= 1 else 1
    z = torch.cat([one, prefix[:n - 1]])
    if start != 1:
        z = bk.scale(z, start)
    return z, end


def prove(pk: ProvingKey, srs: SRS, assignment: Assignment, bk=None,
          transcript=None, blinding_rng=None, device=None, timer=None) -> bytes:
    """Prove on the backend's device (default: a TorchBackend on `device`,
    which defaults to CUDA).

    blinding_rng: optional zero-arg callable returning a uniform element of
    [0, R) for the blinding rows and tails; default `secrets`. A seeded
    callable makes the proof a pure function of (pk, witness), byte-equal
    to the reference's proof with the same callable. timer: an optional
    PhaseTimer that receives per-phase seconds."""
    bk = bk or TorchBackend(device)
    rand = blinding_rng or (lambda: secrets.randbelow(R))
    timer = timer or PhaseTimer(bk.device)
    cfg = pk.vk.config
    cfg.validate()
    dom = pk.vk.domain
    n, u = cfg.n, cfg.usable_rows
    tr = transcript or Blake2bTranscript()

    # --- bind statement: vk digest + instances ---
    tr._absorb_bytes(pk.vk.digest())
    for col in assignment.instances:
        for v in col:
            tr.common_scalar(int(v) % R)

    # --- 1. blind + commit advice and lookup-advice columns ---
    timer.start("commit_advice")

    def blind(col):
        std = column_std(col, n).copy()
        tail = [rand() for _ in range(u, n)]
        if tail:
            std[u:] = L.ints_to_limbs(tail)
        return std

    adv_host = [blind(v) for v in assignment.advice]
    ladv_host = [blind(v) for v in assignment.lookup_advice]
    # the SHA region's bit and word columns: numpy rows, blinded in bulk
    shb_host = [blind(assignment.sha_bit[j]) for j in range(cfg.num_sha_bit)]
    shw_host = [blind(assignment.sha_word[j]) for j in range(cfg.num_sha_word)]
    values: dict = {}     # key -> lagrange values (device)
    polys: dict = {}      # key -> coefficients (device)

    def commit_cols(items):
        for key, vals in items:
            values[key] = vals
            polys[key] = dom.lagrange_to_coeff(vals, bk)
            tr.write_point(kzg.commit(srs, polys[key], bk))

    commit_cols([(("adv", j), bk.from_std(v)) for j, v in enumerate(adv_host)]
                + [(("ladv", j), bk.from_std(v)) for j, v in enumerate(ladv_host)])
    commit_cols([(("shb", j), bk.from_std(v)) for j, v in enumerate(shb_host)])
    commit_cols([(("shw", j), bk.from_std(v)) for j, v in enumerate(shw_host)])
    del shb_host, shw_host

    # --- 2. lookup permuted columns ---
    timer.start("lookup_permute")
    lk_items = []
    for j in range(cfg.num_lookup_advice):
        a_std = F.tensor_from_u64(ladv_host[j], bk.device)
        pa, pt_col = permute_lookup(cfg, a_std, pk.table_std[j])
        lk_items.append((("pA", j), bk.from_std(pa)))
        lk_items.append((("pT", j), bk.from_std(pt_col)))
    del adv_host
    commit_cols(lk_items)

    beta = tr.challenge()
    gamma = tr.challenge()

    # --- 3. permutation grand products (chunk-linked) ---
    timer.start("grand_products")
    inst_vals = [bk.from_std(assignment.instance_column(j))
                 for j in range(cfg.num_instance)]
    col_keys = perm_column_keys(cfg)
    omega_pows = bk.powers(dom.omega, n)

    def col_values(key):
        kind, j = key
        if kind in ("adv", "ladv", "shw"):
            return values[key]
        if kind == "fix":
            return pk.fixed_values[j]
        if kind == "inst":
            return inst_vals[j]
        raise KeyError(key)

    prev_end = 1
    gp_items = []
    for ch in range(cfg.num_perm_chunks):
        cols = list(enumerate(col_keys))[ch * PERM_CHUNK:(ch + 1) * PERM_CHUNK]
        num = den = None
        for gidx, key in cols:
            v = col_values(key)
            dj = pow(DELTA, gidx, R)
            id_term = bk.add_scalar(bk.add(v, bk.scale(omega_pows, beta * dj % R)), gamma)
            sig_term = bk.add_scalar(bk.add(v, bk.scale(pk.sigma_values[gidx], beta)), gamma)
            num = id_term if num is None else bk.mul(num, id_term)
            den = sig_term if den is None else bk.mul(den, sig_term)
        z, end = _running_product(bk, bk.mul(num, bk.inv(den)), u, prev_end)
        prev_end = prev_end * end % R
        # the tail rows u+1.. are outside every active constraint but z is
        # opened at x and omega x: randomize them as the reference does
        z = _set_rows(bk, z, u + 1, [rand() for _ in range(u + 1, n)])
        gp_items.append((("pz", ch), z))
    if prev_end != 1:
        raise ValueError("permutation product != 1 (copy constraints unsatisfiable)")

    # --- 4. lookup grand products ---
    for j in range(cfg.num_lookup_advice):
        a_v, pa_v = values[("ladv", j)], values[("pA", j)]
        pt_v, t_v = values[("pT", j)], pk.table_values[j]
        num = bk.mul(bk.add_scalar(a_v, beta), bk.add_scalar(t_v, gamma))
        den = bk.mul(bk.add_scalar(pa_v, beta), bk.add_scalar(pt_v, gamma))
        z, end = _running_product(bk, bk.mul(num, bk.inv(den)), u, 1)
        if end != 1:
            raise ValueError("lookup product != 1 (a lookup value is not in its table)")
        z = _set_rows(bk, z, u + 1, [rand() for _ in range(u + 1, n)])
        gp_items.append((("lz", j), z))
    commit_cols(gp_items)
    del gp_items

    y = tr.challenge()

    timer.start("quotient")
    for j, v in enumerate(inst_vals):
        polys[("inst", j)] = dom.lagrange_to_coeff(v, bk)
    values.clear()

    def poly_for(key):
        kind, j = key
        if key in polys:
            return polys[key]
        if kind == "shk":
            return pk.sha_k_poly
        return {"q": pk.selector_polys, "fix": pk.fixed_polys,
                "sig": pk.sigma_polys, "tab": pk.table_polys,
                "shq": pk.sha_selector_polys}[kind][j]

    h_coeffs = _quotient(cfg, dom, bk, poly_for, beta, gamma, y)
    # deg h <= 3n - 4: a nonzero top chunk means the division by the
    # vanishing polynomial was inexact (the witness violates a constraint)
    if bool((h_coeffs[NUM_H_CHUNKS * n:] != 0).any()):
        raise ValueError("quotient not a polynomial: witness violates constraints")
    timer.start("commit_h")
    for i in range(NUM_H_CHUNKS):
        polys[("h", i)] = h_coeffs[i * n:(i + 1) * n].contiguous()
    del h_coeffs
    for pt in kzg.commit_many(srs, [polys[("h", i)] for i in range(NUM_H_CHUNKS)], bk):
        tr.write_point(pt)

    x = tr.challenge()

    # --- 6. evaluations per the query plan ---
    timer.start("evals")
    plan = pk.vk.query_plan()
    evals = {}
    point_powers = {}
    for key, rot in plan:
        pt = pk.vk.rotation_point(x, rot)
        if pt not in point_powers:
            point_powers[pt] = bk.powers_of(pt, n)
        ev = bk.evaluate(poly_for(key), point_powers[pt])
        evals[(key, rot)] = ev
        tr.write_scalar(ev)

    # --- 7. SHPLONK multiopen ---
    del point_powers
    timer.start("multiopen")
    by_key: dict = {}
    for key, rot in plan:
        by_key.setdefault(key, []).append(rot)
    entries = []
    for key, rots in by_key.items():
        pts = tuple(pk.vk.rotation_point(x, r) for r in rots)
        evs = tuple(evals[(key, r)] for r in rots)
        entries.append(kzg.OpenEntry(poly_for(key), None, pts, evs))
    kzg.shplonk_open(srs, dom, entries, tr, bk)
    timer.stop()
    return tr.finalize()


def _quotient(cfg, dom, bk, poly_for, beta, gamma, y) -> torch.Tensor:
    """h(X) = (sum_i y^(N-1-i) e_i(X)) / Z_H(X) in coefficient form [4n, 4]:
    the expression stream folded one expression at a time over extended
    columns drawn through a byte-budgeted LRU, then one product by the
    period-4 vanishing inverse and one coset iLDE. On a backend whose plan
    shards (`parallel.sharded_quotient.mesh_engine`) the same pipeline runs
    over row-sharded columns; a failure there falls back to this device,
    visibly."""
    engine = SQ.mesh_engine(bk, dom)
    if engine is not None:
        lru = _ExtCache(sum(_ext_budget(d) for d in engine.plan.physical_devices))
        try:
            return SQ.quotient(engine, cfg, dom, poly_for, beta, gamma, y, lru)
        except Exception as e:   # the mesh path failed: this device proves, visibly
            lru.clear()
            SQ.degrade("mesh_exception", error=f"{type(e).__name__}: {e}", n_ext=dom.n_ext)
    n, u = cfg.n, cfg.usable_rows
    lru = _ExtCache(_ext_budget(bk.device))

    def ext(key, rot=0):
        rkey = (key, rot)
        hit = lru.get(rkey)
        if hit is not None:
            return hit
        if rot == 0:
            return lru.put(rkey, dom.coeff_to_extended(poly_for(key), bk))
        r = cfg.last_row if rot == ROT_LAST else rot
        return lru.put(rkey, dom.rotate_extended(ext(key), r))

    def lagrange_ext(rows):
        vals = torch.zeros((n, 4), dtype=torch.int64, device=bk.device)
        vals[rows] = bk.const(1)
        return dom.coeff_to_extended(dom.lagrange_to_coeff(vals, bk), bk)

    ctx = _TensorCtx(cfg, dom, bk, ext)
    ctx.l0 = lagrange_ext([0])
    ctx.llast = lagrange_ext([cfg.last_row])
    ctx.lblind = lagrange_ext(list(range(u + 1, n)))

    acc = None
    for e in all_expressions(cfg, ctx, beta, gamma):
        acc = e if acc is None else bk.axpy(acc, y, e)
    del lru, ctx
    vinv = bk.from_ints(list(dom.vanishing_inv_period_vals()))
    return dom.extended_to_coeff(bk.mul(acc, vinv), bk)

