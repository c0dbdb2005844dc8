"""Audit targets: the three app circuits at their smallest real shapes (the
port of `spectre_tpu/analysis/circuits.py`).

Each builder returns (ctx, cfg, name): a witness-generated Context and the
auto-sized CircuitConfig the prover would use. The tiny spec (2
validators) keeps witness generation to seconds for the committee update
and tens of seconds for the step's BLS block; the aggregation target
verifies a small k=10 inner snark in-circuit, proved first on `device`
(the port's default, CUDA, unless the caller names another).
"""

from __future__ import annotations


def _tiny():
    from .. import spec as S
    return S.TINY


def build_committee_update(device=None):
    from ..models import CommitteeUpdateCircuit
    from ..witness import default_committee_update_args
    spec = _tiny()
    args = default_committee_update_args(spec)
    ctx = CommitteeUpdateCircuit.build_context(args, spec, device=device)
    cfg = ctx.auto_config(k=17, lookup_bits=CommitteeUpdateCircuit.default_lookup_bits)
    return ctx, cfg, "committee_update:tiny"


def build_sync_step(device=None):
    from ..models import StepCircuit
    from ..witness import default_sync_step_args
    spec = _tiny()
    args = default_sync_step_args(spec)
    ctx = StepCircuit.build_context(args, spec, device=device)
    # lookup_bits=18 needs k >= 19 for the range table to fit usable rows
    cfg = ctx.auto_config(k=19, lookup_bits=StepCircuit.default_lookup_bits)
    return ctx, cfg, "sync_step:tiny"


def build_aggregation(device=None):
    import random

    from ..builder.context import Context
    from ..builder.range_chip import RangeChip
    from ..models.aggregation import AggregationArgs, AggregationCircuit
    from ..plonk.keygen import keygen
    from ..plonk.prover import prove
    from ..plonk.srs import SRS
    from ..plonk.transcript import PoseidonTranscript

    # a small inner app snark (the reference's, tests/test_aggregation.py)
    random.seed(3)
    ictx = Context()
    rng = RangeChip(lookup_bits=8)
    g = rng.gate
    a = ictx.load_witness(1234)
    b = ictx.load_witness(5678)
    c = g.mul(ictx, a, b)
    rng.range_check(ictx, a, 16)
    ictx.expose_public(c)
    icfg = ictx.auto_config(k=10, lookup_bits=8)
    iasg = ictx.assignment(icfg)
    srs = SRS.unsafe_setup(10, device=device)
    pk = keygen(srs, icfg, iasg.fixed, iasg.selectors, iasg.copies, device=device)
    proof = prove(pk, srs, iasg, device=device, transcript=PoseidonTranscript())

    args = AggregationArgs(inner_vk=pk.vk, srs=srs, inner_instances=iasg.instances,
                           proof=proof)
    spec = _tiny()
    ctx = AggregationCircuit.build_context(args, spec, device=device)
    cfg = ctx.auto_config(k=15, lookup_bits=AggregationCircuit.default_lookup_bits)
    return ctx, cfg, "aggregation:tiny"


AUDIT_CIRCUITS = {
    "committee_update": build_committee_update,
    "sync_step": build_sync_step,
    "aggregation": build_aggregation,
}
