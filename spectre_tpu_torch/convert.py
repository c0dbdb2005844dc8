"""The reference's objects -> the port's objects, and back to plain arrays.

The JAX package keeps keys and parameters as numpy arrays (coefficient
forms [n, 4] uint64 standard limbs, SRS powers [n, 8] uint64), Python int
lists (value forms) and host points whose coordinates convert with int().
These functions read exactly those attributes, duck-typed: nothing here
imports the JAX package. With them one keygen's output can feed both
provers.
"""

from __future__ import annotations

import numpy as np

from .fields import bn254
from .ops import field_ops as F
from .plonk.constraint_system import Assignment, CircuitConfig, column_std
from .plonk.keygen import ProvingKey, VerifyingKey
from .plonk.srs import SRS


def g1_point(pt):
    """A reference G1 point ((x, y) with int()-able coordinates, or None)."""
    if pt is None:
        return None
    return (bn254.Fq(int(pt[0])), bn254.Fq(int(pt[1])))


def g2_point(pt):
    """A reference G2 point, given by its 128-byte uncompressed encoding."""
    return bn254.g2_from_bytes(bytes(pt))


def circuit_config(ref_cfg) -> CircuitConfig:
    return CircuitConfig(
        k=int(ref_cfg.k), num_advice=int(ref_cfg.num_advice),
        num_lookup_advice=int(ref_cfg.num_lookup_advice),
        num_fixed=int(ref_cfg.num_fixed), lookup_bits=int(ref_cfg.lookup_bits),
        num_instance=int(ref_cfg.num_instance),
        lookup_tables=tuple(ref_cfg.lookup_tables),
        num_sha_slots=int(ref_cfg.num_sha_slots))


def srs(k: int, g1_powers: np.ndarray, g2_gen_bytes: bytes, g2_tau_bytes: bytes) -> SRS:
    """SRS from the reference's arrays: g1_powers [n, 8] uint64 and the two
    G2 points as 128-byte encodings (`bn254.g2_to_bytes`)."""
    return SRS(int(k), np.ascontiguousarray(g1_powers, dtype=np.uint64),
               g2_point(g2_gen_bytes), g2_point(g2_tau_bytes))


def srs_arrays(s: SRS) -> dict:
    return {"k": s.k, "g1_powers": s.g1_powers,
            "g2_gen": bn254.g2_to_bytes(s.g2_gen),
            "g2_tau": bn254.g2_to_bytes(s.g2_tau)}


def proving_key(ref_pk, device) -> ProvingKey:
    """ProvingKey from the reference's: coefficient arrays go to `device` in
    Montgomery form, value lists likewise, commitments become port points."""
    ref_vk = ref_pk.vk
    cfg = circuit_config(ref_vk.config)
    if cfg.num_sha_slots:
        raise NotImplementedError("SHA-region keys are not ported yet")
    fr = F.fr_ctx()
    n = cfg.n

    def coeffs(arrs):
        return [F.from_std(fr, np.ascontiguousarray(a, dtype=np.uint64), device)
                for a in arrs]

    def vals(cols):
        return [F.from_std(fr, column_std(c, n), device) for c in cols]

    vk = VerifyingKey(
        config=cfg,
        selector_commits=[g1_point(p) for p in ref_vk.selector_commits],
        fixed_commits=[g1_point(p) for p in ref_vk.fixed_commits],
        sigma_commits=[g1_point(p) for p in ref_vk.sigma_commits],
        table_commits=[g1_point(p) for p in ref_vk.table_commits])
    tab_std = [F.tensor_from_u64(column_std(c, n), device) for c in ref_pk.table_values]
    return ProvingKey(
        vk, coeffs(ref_pk.selector_polys), coeffs(ref_pk.fixed_polys),
        coeffs(ref_pk.sigma_polys), coeffs(ref_pk.table_polys),
        vals(ref_pk.selector_values), vals(ref_pk.fixed_values),
        vals(ref_pk.sigma_values),
        [F.from_std(fr, t, device) for t in tab_std], tab_std)


def proving_key_arrays(pk: ProvingKey) -> dict:
    """The port's key as the reference's plain forms: coefficient arrays
    [n, 4] uint64, value forms as int lists, commitments as int pairs."""
    fr = F.fr_ctx()

    def pts(ps):
        return [None if p is None else (int(p[0]), int(p[1])) for p in ps]

    vk = pk.vk
    return {
        "selector_polys": [F.to_std(fr, t) for t in pk.selector_polys],
        "fixed_polys": [F.to_std(fr, t) for t in pk.fixed_polys],
        "sigma_polys": [F.to_std(fr, t) for t in pk.sigma_polys],
        "table_polys": [F.to_std(fr, t) for t in pk.table_polys],
        "selector_values": [F.to_ints(fr, t) for t in pk.selector_values],
        "fixed_values": [F.to_ints(fr, t) for t in pk.fixed_values],
        "sigma_values": [F.to_ints(fr, t) for t in pk.sigma_values],
        "table_values": [F.to_ints(fr, t) for t in pk.table_values],
        "selector_commits": pts(vk.selector_commits),
        "fixed_commits": pts(vk.fixed_commits),
        "sigma_commits": pts(vk.sigma_commits),
        "table_commits": pts(vk.table_commits),
        "digest": vk.digest(),
    }


def assignment(ref_asg) -> Assignment:
    return Assignment(
        config=circuit_config(ref_asg.config),
        advice=list(ref_asg.advice), lookup_advice=list(ref_asg.lookup_advice),
        fixed=list(ref_asg.fixed), selectors=list(ref_asg.selectors),
        instances=[list(map(int, col)) for col in ref_asg.instances],
        copies=list(ref_asg.copies))
