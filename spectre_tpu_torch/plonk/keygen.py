"""Key generation: fixed-column commitments, permutation sigmas, query plan
(the port's copy of `spectre_tpu/plonk/keygen.py`; the vk digest, the
commitment order and the query plan are the reference's exactly, so both
packages derive the same verifying key)."""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import torch

from ..fields import bn254
from ..ops import field_ops as F
from .backend import TorchBackend
from .constraint_system import (CircuitConfig, NUM_H_CHUNKS, SHA_A, SHA_ACT_WORD,
                                SHA_CARRY, SHA_E, SHA_NUM_SELECTORS, SHA_OUT_ROW,
                                SHA_SEED_ROW, SHA_W, column_std, sha_selector_columns,
                                sigma_targets, table_column)
from .domain import DELTA, Domain, get_domain
from .srs import SRS
from . import kzg

R = bn254.R

# rotation tag for the "last usable row" query used by permutation chunk links
ROT_LAST = "last"


@dataclass
class VerifyingKey:
    config: CircuitConfig
    selector_commits: list
    fixed_commits: list
    sigma_commits: list
    table_commits: list    # one per lookup-advice column (cfg.table_id(j))
    sha_selector_commits: list = None   # the SHA region's 7 selectors
    sha_k_commit: object = None         # its round-constant column

    @property
    def domain(self) -> Domain:
        return get_domain(self.config.k)

    def digest(self) -> bytes:
        h = hashlib.blake2b(digest_size=32)
        cfg = self.config
        h.update(repr((cfg.k, cfg.num_advice, cfg.num_lookup_advice, cfg.num_fixed,
                       cfg.lookup_bits, cfg.num_instance,
                       cfg.num_sha_slots)).encode())
        h.update(repr(cfg.lookup_tables).encode())
        for pt in (self.selector_commits + self.fixed_commits
                   + self.sigma_commits + self.table_commits
                   + (self.sha_selector_commits or [])
                   + ([self.sha_k_commit] if cfg.num_sha_slots else [])):
            h.update(bn254.g1_to_bytes(pt))
        return h.digest()

    def commitment_plan(self):
        """Ordered commitment keys as read from the proof stream, with the
        challenge boundaries: (keys, pre_beta_gamma, pre_y, pre_x)."""
        cfg = self.config
        keys = [("adv", j) for j in range(cfg.num_advice)]
        keys += [("ladv", j) for j in range(cfg.num_lookup_advice)]
        keys += [("shb", j) for j in range(cfg.num_sha_bit)]
        keys += [("shw", j) for j in range(cfg.num_sha_word)]
        for j in range(cfg.num_lookup_advice):
            keys.append(("pA", j))
            keys.append(("pT", j))
        pre_bg = len(keys)
        keys += [("pz", c) for c in range(cfg.num_perm_chunks)]
        keys += [("lz", j) for j in range(cfg.num_lookup_advice)]
        pre_y = len(keys)
        keys += [("h", i) for i in range(NUM_H_CHUNKS)]
        return keys, pre_bg, pre_y, len(keys)

    def fixed_commitment_map(self) -> dict:
        """key -> commitment for the vk-side (non-proof) commitments."""
        out = {}
        for j, c in enumerate(self.table_commits):
            out[("tab", j)] = c
        for j, c in enumerate(self.selector_commits):
            out[("q", j)] = c
        for j, c in enumerate(self.fixed_commits):
            out[("fix", j)] = c
        for j, c in enumerate(self.sigma_commits):
            out[("sig", j)] = c
        for j, c in enumerate(self.sha_selector_commits or []):
            out[("shq", j)] = c
        if self.config.num_sha_slots:
            out[("shk", 0)] = self.sha_k_commit
        return out

    def query_plan(self):
        """Ordered (key, rotation) pairs — the eval section of the proof."""
        cfg = self.config
        plan = []
        for j in range(cfg.num_advice):
            for rot in (0, 1, 2, 3):
                plan.append((("adv", j), rot))
        for j in range(cfg.num_lookup_advice):
            plan.append((("ladv", j), 0))
            plan.append((("pA", j), 0))
            plan.append((("pA", j), -1))
            plan.append((("pT", j), 0))
            plan.append((("lz", j), 0))
            plan.append((("lz", j), 1))
        for c in range(cfg.num_perm_chunks):
            plan.append((("pz", c), 0))
            plan.append((("pz", c), 1))
            if c + 1 < cfg.num_perm_chunks:
                plan.append((("pz", c), ROT_LAST))
        for j in range(cfg.num_advice):
            plan.append((("q", j), 0))
        for j in range(cfg.num_fixed):
            plan.append((("fix", j), 0))
        for j in range(cfg.num_perm_columns):
            plan.append((("sig", j), 0))
        for j in range(cfg.num_lookup_advice):
            plan.append((("tab", j), 0))
        if cfg.num_sha_slots:
            for i in range(32):                       # w bits
                for rot in (0, -2, -7, -15, -16):
                    plan.append((("shb", SHA_W + i), rot))
            for i in range(32):                       # a bits
                for rot in (0, -1, -2, -3, -4):
                    plan.append((("shb", SHA_A + i), rot))
            for i in range(32):                       # e bits
                for rot in (0, -1, -2, -3, -4):
                    plan.append((("shb", SHA_E + i), rot))
            for i in range(8):                        # carries
                plan.append((("shb", SHA_CARRY + i), 0))
            back = SHA_SEED_ROW - SHA_OUT_ROW
            for j in range(8):
                plan.append((("shw", j), 0))
                plan.append((("shw", j), back))
            plan.append((("shw", 8), 0))
            plan.append((("shw", SHA_ACT_WORD), 0))   # act flag
            plan.append((("shw", SHA_ACT_WORD), -1))
            for sel in range(SHA_NUM_SELECTORS):
                plan.append((("shq", sel), 0))
            plan.append((("shk", 0), 0))
        for i in range(NUM_H_CHUNKS):
            plan.append((("h", i), 0))
        return plan

    def assert_rotation_injective(self):
        """Distinct rotation tags of the query plan must be distinct points
        omega^rot x (the reference's check): the SHA region's -65 and its
        ladder rotations down to -16 against ROT_LAST among them."""
        dom = self.domain
        seen = {}
        for _key, rot in self.query_plan():
            idx = self.config.last_row if rot == ROT_LAST else rot % dom.n
            w = pow(dom.omega, idx, R)
            prev = seen.setdefault(w, rot)
            if not (prev == rot or (isinstance(prev, int) and isinstance(rot, int)
                                    and prev % dom.n == rot % dom.n)):
                raise ValueError(f"rotation tags {prev} and {rot} share omega^rot")

    def rotation_point(self, x: int, rot) -> int:
        dom = self.domain
        if rot == ROT_LAST:
            return pow(dom.omega, self.config.last_row, R) * x % R
        if rot < 0:
            return pow(dom.omega_inv, -rot, R) * x % R
        return pow(dom.omega, rot, R) * x % R


@dataclass
class ProvingKey:
    """Coefficient forms (device tensors, Montgomery) for the quotient and
    the openings; value forms for the grand products; the tables also in
    standard form for the lookup permutation."""

    vk: VerifyingKey
    selector_polys: list
    fixed_polys: list
    sigma_polys: list
    table_polys: list          # one per lookup-advice column
    selector_values: list
    fixed_values: list
    sigma_values: list
    table_values: list         # device tensors, one per lookup-advice column
    table_std: list            # [n, 4] int64 standard limbs, same device
    sha_selector_polys: list = None
    sha_k_poly: object = None


def build_sigma(cfg: CircuitConfig, copies, bk: TorchBackend, timer) -> list:
    """sigma_j[i] = delta^j' omega^i' where (j', i') = sigma(j, i): one
    gather of the delta and omega power tables and one product per column,
    on the backend's device. The cycle merge runs in host C++ when the
    backend is on the card, as the Python loop on the CPU."""
    n, m = cfg.n, cfg.num_perm_columns
    timer.start("sigma_merge")
    jp, ip = sigma_targets(cfg, copies, native=bk.device.type == "cuda")
    timer.start("sigma")
    dom = Domain(cfg.k)
    omega = bk.powers(dom.omega, n)
    delta = bk.from_ints([pow(DELTA, j, R) for j in range(m)])
    jp_t = torch.from_numpy(jp).to(bk.device)
    ip_t = torch.from_numpy(ip).to(bk.device)
    return [bk.mul(delta[jp_t[j * n:(j + 1) * n]], omega[ip_t[j * n:(j + 1) * n]])
            for j in range(m)]


def keygen(srs: SRS, cfg: CircuitConfig, fixed_columns: list, selectors: list,
           copies: list, bk: TorchBackend | None = None, device=None,
           timer=None) -> ProvingKey:
    """Generate pk/vk from the circuit's fixed content on the backend's
    device (default: a TorchBackend on `device`, which defaults to CUDA).

    fixed_columns: [num_fixed] columns; selectors: [num_advice] 0/1 columns;
    copies: global copy-constraint pairs. timer: an optional
    prover.PhaseTimer that receives the seconds of the phases columns,
    sigma_merge (the copy cycles), sigma, interpolate and commit."""
    from .prover import PhaseTimer     # prover imports this module
    bk = bk or TorchBackend(device)
    timer = timer or PhaseTimer(bk.device)
    timer.start("columns")
    cfg.validate()
    dom = Domain(cfg.k)
    if srs.n < cfg.n:
        raise ValueError("SRS too small for circuit")
    n = cfg.n

    sel_vals = [bk.from_std(column_std(s, n)) for s in selectors]
    fix_vals = [bk.from_std(column_std(f, n)) for f in fixed_columns]
    tab_ids = sorted({cfg.table_id(j) for j in range(cfg.num_lookup_advice)})
    tab_std = {t: F.tensor_from_u64(column_std(table_column(cfg, t), n), bk.device)
               for t in tab_ids}
    tab_vals = {t: bk.from_std(tab_std[t]) for t in tab_ids}
    sigma_vals = build_sigma(cfg, copies, bk, timer)

    timer.start("interpolate")
    sel_polys = dom.lagrange_to_coeff_many(sel_vals, bk)
    fix_polys = dom.lagrange_to_coeff_many(fix_vals, bk)
    sig_polys = dom.lagrange_to_coeff_many(sigma_vals, bk)
    tab_polys = dict(zip(tab_ids, dom.lagrange_to_coeff_many(
        [tab_vals[t] for t in tab_ids], bk)))

    sha_polys = []
    if cfg.num_sha_slots:
        sha_sel, sha_k = sha_selector_columns(cfg)
        sha_polys = dom.lagrange_to_coeff_many(
            [bk.from_std(column_std(c, n)) for c in (*sha_sel, sha_k)], bk)

    timer.start("commit")
    pts = kzg.commit_many(srs, sel_polys + fix_polys + sig_polys
                          + [tab_polys[t] for t in tab_ids] + sha_polys, bk)
    ns, nf, ng, nt = len(sel_polys), len(fix_polys), len(sig_polys), len(tab_ids)
    tab_commit = dict(zip(tab_ids, pts[ns + nf + ng:ns + nf + ng + nt]))
    sha_commits = pts[ns + nf + ng + nt:]
    col_tabs = [cfg.table_id(j) for j in range(cfg.num_lookup_advice)]
    vk = VerifyingKey(
        config=cfg,
        selector_commits=pts[:ns],
        fixed_commits=pts[ns:ns + nf],
        sigma_commits=pts[ns + nf:ns + nf + ng],
        table_commits=[tab_commit[t] for t in col_tabs],
        sha_selector_commits=sha_commits[:-1] if sha_commits else None,
        sha_k_commit=sha_commits[-1] if sha_commits else None,
    )
    vk.assert_rotation_injective()
    timer.stop()
    return ProvingKey(vk, sel_polys, fix_polys, sig_polys,
                      [tab_polys[t] for t in col_tabs],
                      sel_vals, fix_vals, sigma_vals,
                      [tab_vals[t] for t in col_tabs],
                      [tab_std[t] for t in col_tabs],
                      sha_selector_polys=sha_polys[:-1] if sha_polys else None,
                      sha_k_poly=sha_polys[-1] if sha_polys else None)

