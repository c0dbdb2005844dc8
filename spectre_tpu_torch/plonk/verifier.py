"""The verifier: transcript replay, identity check at x, SHPLONK pairing
check (the port's copy of `spectre_tpu/plonk/verifier.py`). Host math only:
a handful of field ops, two MSM-sized sums of a few dozen points, and one
pairing check in Python."""

from __future__ import annotations

from ..fields import bn254
from . import kzg
from .expressions import ScalarCtx, all_expressions
from .keygen import VerifyingKey
from .srs import SRS
from .transcript import Blake2bTranscript

R = bn254.R


def verify(vk: VerifyingKey, srs: SRS, instances: list, proof: bytes,
           transcript_cls=Blake2bTranscript) -> bool:
    acc = verify_deferred(vk, srs, instances, proof, transcript_cls)
    if acc is None:
        return False
    tau_side, one_side = acc
    return bn254.pairing_check([
        (one_side, srs.g2_gen),
        (bn254.g1_curve.neg(tau_side), srs.g2_tau),
    ])


def verify_deferred(vk: VerifyingKey, srs: SRS, instances: list, proof: bytes,
                    transcript_cls=Blake2bTranscript):
    """Everything but the pairing. Returns the deferred check (tau_side,
    one_side) with e(tau_side, [tau]_2) == e(one_side, [1]_2), or None if
    the identity fails or the bytes are malformed. The aggregation's native
    accumulator shares this definition (with the Poseidon transcript)."""
    try:
        return _verify_deferred_inner(vk, srs, instances, proof, transcript_cls)
    except (AssertionError, ValueError):
        return None


def _verify_deferred_inner(vk: VerifyingKey, srs: SRS, instances: list, proof: bytes,
                           transcript_cls):
    cfg = vk.config
    dom = vk.domain
    n, u = cfg.n, cfg.usable_rows
    tr = transcript_cls(proof)

    tr._absorb_bytes(vk.digest())
    for col in instances:
        if len(col) > u:
            raise ValueError("too many public inputs")
        for v in col:
            tr.common_scalar(int(v) % R)

    keys, pre_bg, pre_y, pre_x = vk.commitment_plan()
    commits = {}
    for key in keys[:pre_bg]:
        commits[key] = tr.read_point()
    beta = tr.challenge()
    gamma = tr.challenge()
    for key in keys[pre_bg:pre_y]:
        commits[key] = tr.read_point()
    y = tr.challenge()
    for key in keys[pre_y:pre_x]:
        commits[key] = tr.read_point()
    x = tr.challenge()

    plan = vk.query_plan()
    evals = {}
    for key, rot in plan:
        evals[(key, rot)] = tr.read_scalar()

    # --- instance evaluations (computed, not read: public input binding) ---
    for j in range(cfg.num_instance):
        rows = list(range(len(instances[j])))
        lag = dom.lagrange_evals(x, rows)
        evals[(("inst", j), 0)] = sum(
            int(v) * lag[i] for i, v in enumerate(instances[j])) % R

    # --- gate/permutation/lookup identity at x ---
    lag_special = dom.lagrange_evals(x, [0, cfg.last_row] + list(range(u + 1, n)))
    l0 = lag_special[0]
    llast = lag_special[cfg.last_row]
    lblind = sum(lag_special[i] for i in range(u + 1, n)) % R

    ctx = ScalarCtx(cfg, evals, l0, llast, lblind, x)
    acc = 0
    for e in all_expressions(cfg, ctx, beta, gamma):
        acc = (acc * y + e) % R
    xn = pow(x, n, R)
    h_at_x = (evals[(("h", 0), 0)] + xn * evals[(("h", 1), 0)]
              + xn * xn % R * evals[(("h", 2), 0)]) % R
    if acc != h_at_x * dom.evaluate_vanishing(x) % R:
        return None

    # --- SHPLONK ---
    fixed_commits = vk.fixed_commitment_map()
    by_key: dict = {}
    for key, rot in plan:
        by_key.setdefault(key, []).append(rot)
    entries = []
    for key, rots in by_key.items():
        pts = tuple(vk.rotation_point(x, r) for r in rots)
        evs = tuple(evals[(key, r)] for r in rots)
        com = commits[key] if key in commits else fixed_commits[key]
        entries.append(kzg.OpenEntry(None, com, pts, evs))
    tau_side, one_side = kzg.shplonk_accumulate(srs, entries, tr)
    tr.assert_consumed()
    return tau_side, one_side
