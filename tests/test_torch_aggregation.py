"""Stage 2 on the CPU: the port's aggregation layer against the JAX
package's, on the inner proofs of `tests/test_aggregation.py` (two k=10 app
circuits proved under the Poseidon transcript with seeded blinding).

The accumulator encoding and fold, the native accumulator, the in-circuit
transcript and MSM, the whole `AggregationCircuit` context (the in-circuit
verifier, 5.8 M advice cells; with a second snark, the fold) compared stream
for stream with the reference's, the statement, the reject paths, the
tracked k=22 pinning, and the native sigma merge on the aggregation's
copies. The outer prove at k=17 under Keccak: the reference's, on the CPU
(`slow`), against the record of tests/data/torch_agg_k17_keccak.json, which
`tests/test_torch_cuda.py` holds the port's prove on the card to.
"""

import gc

import numpy as np
import pytest
import torch

from spectre_tpu.builder.context import Context as RContext
from spectre_tpu.builder.msm_chip import deterministic_point as ref_deterministic_point
from spectre_tpu.builder.range_chip import RangeChip as RRangeChip
from spectre_tpu.builder.transcript_chip import TranscriptChip as RTranscriptChip
from spectre_tpu.fields import bn254 as rbn
from spectre_tpu.models import aggregation as RA
from spectre_tpu.plonk import backend as RB
from spectre_tpu.plonk import transcript as RT
from spectre_tpu.plonk.in_circuit import VerifierChip as RVerifierChip
from spectre_tpu.plonk.keygen import keygen as ref_keygen
from spectre_tpu.plonk.prover import prove as ref_prove
from spectre_tpu.plonk.srs import SRS as RSRS
from spectre_tpu.plonk.verifier import verify as ref_verify
from spectre_tpu_torch import spec as SPEC
from spectre_tpu_torch.builder.context import Context
from spectre_tpu_torch.builder.fp_chip import EccChip
from spectre_tpu_torch.builder.msm_chip import MsmChip, deterministic_point
from spectre_tpu_torch.builder.range_chip import RangeChip
from spectre_tpu_torch.builder.transcript_chip import TranscriptChip
from spectre_tpu_torch.fields import bn254
from spectre_tpu_torch.models import aggregation as A
from spectre_tpu_torch.plonk import transcript as T
from spectre_tpu_torch.plonk.constraint_system import sigma_targets
from spectre_tpu_torch.plonk.in_circuit import VerifierChip
from spectre_tpu_torch.plonk.keygen import keygen
from spectre_tpu_torch.plonk.prover import prove
from spectre_tpu_torch.plonk.srs import SRS
from spectre_tpu_torch.plonk.verifier import verify

from _torch_agg_k17 import app as _app, seeded as _rng
from _torch_ctx_compare import assert_contexts_equal, snapshot

R, P = bn254.R, bn254.P


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads per test process: the tier-1 run has six workers
    on one machine, and timing-sensitive tests elsewhere share its cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _xy(pt):
    return None if pt is None else (int(pt[0]), int(pt[1]))


def _cell_xy(pt):
    return (pt[0].value % P, pt[1].value % P)


def _inner(which: int, seed: int, port_prove: bool):
    """(reference (pk, srs, instances, proof), port (pk, srs, instances,
    proof)): the app circuit keyed by each package (equal vk digests) and
    proved by the reference under Poseidon with seeded blinding; the port
    proves it too when port_prove, else it takes the reference's bytes."""
    rctx = RContext()
    _app(rctx, RRangeChip(lookup_bits=8), which)
    rcfg = rctx.auto_config(k=10, lookup_bits=8)
    rasg = rctx.assignment(rcfg)
    rsrs = RSRS.unsafe_setup(10)
    rpk = ref_keygen(rsrs, rcfg, rasg.fixed, rasg.selectors, rasg.copies, RB.get_backend("cpu"))
    rproof = ref_prove(rpk, rsrs, rasg, RB.get_backend("cpu"), transcript=RT.PoseidonTranscript(),
                       blinding_rng=_rng(seed))

    ctx = Context()
    _app(ctx, RangeChip(lookup_bits=8), which)
    cfg = ctx.auto_config(k=10, lookup_bits=8)
    asg = ctx.assignment(cfg)
    srs = SRS.unsafe_setup(10, device="cpu")
    pk = keygen(srs, cfg, asg.fixed, asg.selectors, asg.copies, device="cpu")
    assert pk.vk.digest() == rpk.vk.digest()
    proof = rproof
    if port_prove:
        proof = prove(pk, srs, asg, device="cpu", transcript=T.PoseidonTranscript(),
                      blinding_rng=_rng(seed))
    return (rpk, rsrs, rasg.instances, rproof), (pk, srs, asg.instances, proof)


@pytest.fixture(scope="module")
def inner():
    return _inner(1, 3, port_prove=True)


@pytest.fixture(scope="module")
def inner2():
    return _inner(2, 8, port_prove=False)


def _args(port, more=()):
    pk, srs, inst, proof = port
    return A.AggregationArgs(inner_vk=pk.vk, srs=srs, inner_instances=inst, proof=proof,
                             more_snarks=tuple(A.SnarkWitness(p.vk, i, pr)
                                               for p, _, i, pr in more))


def _rargs(ref, more=()):
    rpk, rsrs, inst, proof = ref
    return RA.AggregationArgs(inner_vk=rpk.vk, srs=rsrs, inner_instances=inst, proof=proof,
                              more_snarks=tuple(RA.SnarkWitness(p.vk, i, pr)
                                                for p, _, i, pr in more))


def _built(ref_args, args):
    """(the port's context, the reference's snapshot, the reference's
    instance values): the reference is built first and kept only as its
    snapshot."""
    rctx = RA.AggregationCircuit.build_context(ref_args, None)
    rvals = [av.value for av in rctx.instance_cells]
    ref = snapshot(rctx)
    del rctx
    gc.collect()
    ctx = A.AggregationCircuit.build_context(args, None, device="cpu")
    return ctx, ref, rvals


@pytest.fixture(scope="module")
def agg(inner):
    ref, port = inner
    return _built(_rargs(ref), _args(port))


@pytest.fixture(scope="module")
def agg2(inner, inner2):
    (ref1, port1), (ref2, port2) = inner, inner2
    return _built(_rargs(ref1, [ref2]), _args(port1, [port2]))


# -- the inner proof and the accumulator --------------------------------

def test_inner_poseidon_proof_is_byte_identical(inner):
    (rpk, rsrs, rinst, rproof), (pk, srs, inst, proof) = inner
    assert inst == rinst and proof == rproof
    assert verify(pk.vk, srs, inst, proof, transcript_cls=T.PoseidonTranscript)
    assert ref_verify(rpk.vk, rsrs, rinst, proof, transcript_cls=RT.PoseidonTranscript)


def test_accumulator_limbs_and_accumulate_equal_reference():
    g1, rg1 = bn254.g1_curve, rbn.g1_curve
    accs = [A.Accumulator(g1.mul(bn254.G1_GEN, i + 2), g1.mul(bn254.G1_GEN, i + 9))
            for i in range(3)]
    raccs = [RA.Accumulator(rg1.mul(rbn.G1_GEN, i + 2), rg1.mul(rbn.G1_GEN, i + 9))
             for i in range(3)]
    for acc, racc in zip(accs, raccs):
        assert acc.limbs() == racc.limbs()
        back = A.Accumulator.from_limbs(acc.limbs())
        assert (_xy(back.lhs), _xy(back.rhs)) == (_xy(acc.lhs), _xy(acc.rhs))
    for order in (slice(None), slice(None, None, -1)):
        got, want = A.accumulate(accs[order]), RA.accumulate(raccs[order])
        assert (_xy(got.lhs), _xy(got.rhs)) == (_xy(want.lhs), _xy(want.rhs))
    with pytest.raises(ValueError):
        A.Accumulator.from_limbs([0] * 11)


def test_native_accumulator_equals_reference(inner):
    (rpk, rsrs, rinst, rproof), (pk, srs, inst, proof) = inner
    acc = VerifierChip.native_accumulator(pk.vk, srs, inst, proof)
    racc = RVerifierChip.native_accumulator(rpk.vk, rsrs, rinst, rproof)
    assert (_xy(acc.lhs), _xy(acc.rhs)) == (_xy(racc.lhs), _xy(racc.rhs))
    assert acc.check(srs)
    bad = [[(inst[0][0] + 1) % R]]
    assert VerifierChip.native_accumulator(pk.vk, srs, bad, proof) is None
    assert RVerifierChip.native_accumulator(rpk.vk, rsrs, bad, rproof) is None


def test_tampered_commitment_fails_in_both(inner):
    """A flipped byte of the first commitment: rejected at parse, by the
    identity, or by the pairing, the same way in both packages."""
    (rpk, rsrs, rinst, rproof), (pk, srs, inst, proof) = inner
    bad = bytearray(proof)
    bad[1] ^= 1
    acc = VerifierChip.native_accumulator(pk.vk, srs, inst, bytes(bad))
    racc = RVerifierChip.native_accumulator(rpk.vk, rsrs, rinst, bytes(bad))
    assert (acc is None) == (racc is None)
    assert acc is None or not acc.check(srs)
    if acc is None:
        with pytest.raises(ValueError, match="inner proof invalid"):
            A.AggregationCircuit.get_instances(_args((pk, srs, inst, bytes(bad))), None)


def test_batch_verify(inner):
    _, (pk, srs, inst, proof) = inner
    agg = A.AggregationCircuit
    assert agg.batch_verify(pk.vk, srs, [(inst[0], proof)], device="cpu")
    assert not agg.batch_verify(pk.vk, srs, [(inst[0], proof)],
                                transcript_cls=T.Blake2bTranscript, device="cpu")


# -- the chips --------------------------------------------------------------

def test_transcript_chip_equals_native_and_reference():
    """One seeded absorb sequence (scalars, point limbs, constant bytes) in
    the chip and in the native transcript: the same challenges, and the
    port's context equals the reference chip's."""
    rng = np.random.default_rng(23)
    ops = []
    for _ in range(12):
        kind = int(rng.integers(0, 4))
        if kind == 0:
            ops.append(("scalars", [int.from_bytes(rng.bytes(32), "big") % R
                                    for _ in range(int(rng.integers(1, 5)))]))
        elif kind == 1:
            ops.append(("point", int(rng.integers(2, 1 << 60))))
        elif kind == 2:
            ops.append(("bytes", rng.bytes(32)))
        else:
            ops.append(("challenge", None))
    ops.append(("challenge", None))

    def run(ctx, chip, native, g1, gen, elements):
        got, want = [], []
        for kind, v in ops:
            if kind == "scalars":
                chip.absorb([ctx.load_witness(s) for s in v])
                for s in v:
                    native.common_scalar(s)
            elif kind == "point":
                pt = g1.mul(gen, v)
                chip.absorb_point_limbs(ctx, [ctx.load_witness(e) for e in elements(pt)])
                native.common_point(pt)
            elif kind == "bytes":
                chip.absorb_constant_bytes(ctx, v)
                native._absorb_bytes(v)
            else:
                got.append(chip.challenge(ctx).value)
                want.append(native.challenge())
        return got, want

    ctx, rctx = Context(), RContext()
    got, want = run(ctx, TranscriptChip(), T.PoseidonTranscript(), bn254.g1_curve,
                    bn254.G1_GEN, T.point_to_transcript_elements)
    rgot, _ = run(rctx, RTranscriptChip(), RT.PoseidonTranscript(), rbn.g1_curve,
                  rbn.G1_GEN, RT.point_to_transcript_elements)
    assert got == want == rgot and len(got) >= 2
    assert_contexts_equal(ctx, rctx)
    with pytest.raises(ValueError):
        TranscriptChip().absorb_point_limbs(ctx, [])


def test_small_msm_chip_equals_native_msm():
    """2 witness pairs and 2 constant pairs: the chip's point equals the
    host MSM, and its context equals the reference chip's."""
    rng = np.random.default_rng(29)
    ks = [int(rng.integers(2, 1 << 62)) for _ in range(4)]
    ss = [int.from_bytes(rng.bytes(32), "big") % R for _ in range(4)]

    def run(ctx, vc, g1, gen):
        pts = [g1.mul(gen, k) for k in ks]
        wit = []
        for pt, s in zip(pts[:2], ss[:2]):
            x, y = vc.fq.load(ctx, int(pt[0])), vc.fq.load(ctx, int(pt[1]))
            vc.ecc.constrain_on_curve(ctx, x, y)
            wit.append(((x, y), ctx.load_witness(s)))
        const = [(pt, ctx.load_witness(s)) for pt, s in zip(pts[2:], ss[2:])]
        return vc.msm.msm(ctx, wit, const)

    ctx, rctx = Context(), RContext()
    got = run(ctx, VerifierChip(RangeChip(lookup_bits=14)), bn254.g1_curve, bn254.G1_GEN)
    run(rctx, RVerifierChip(RRangeChip(lookup_bits=14)), rbn.g1_curve, rbn.G1_GEN)
    g1 = bn254.g1_curve
    want = None
    for k, s in zip(ks, ss):
        want = g1.add(want, g1.mul(bn254.G1_GEN, k * s % R))
    assert _cell_xy(got) == _xy(want)
    assert_contexts_equal(ctx, rctx)
    for tag in (b"acc-init", b"witness-0", b"const-1"):
        assert _xy(deterministic_point(tag)) == _xy(ref_deterministic_point(tag))
    with pytest.raises(ValueError, match="BN254-G1"):
        MsmChip(EccChip(VerifierChip(RangeChip(lookup_bits=14)).fq, b=4))


# -- the whole circuit ------------------------------------------------------

def test_aggregation_context_equals_reference(agg):
    ctx, ref, _ = agg
    assert len(ctx.adv_values) > 5_000_000
    assert_contexts_equal(ctx, ref)


def test_statement_and_get_instances(inner, agg):
    """12 accumulator limbs, then the app instances: the cells the build
    exposed, get_instances of both packages, and the native accumulator."""
    (rpk, rsrs, rinst, rproof), port = inner
    ctx, _, rvals = agg
    args = _args(port)
    stmt = A.AggregationCircuit.get_instances(args, None)
    assert stmt == [av.value for av in ctx.instance_cells] == rvals
    assert stmt == RA.AggregationCircuit.get_instances(_rargs(inner[0]), None)
    assert len(stmt) == A.NUM_ACC_LIMBS + sum(len(c) for c in port[2])
    assert stmt[A.NUM_ACC_LIMBS:] == [int(v) % R for col in port[2] for v in col]
    acc = A.Accumulator.from_limbs(stmt[:A.NUM_ACC_LIMBS])
    native = VerifierChip.native_accumulator(port[0].vk, port[1], port[2], port[3])
    assert (_xy(acc.lhs), _xy(acc.rhs)) == (_xy(native.lhs), _xy(native.rhs))
    assert acc.check(port[1])


def test_fold_context_equals_reference(inner, inner2, agg2):
    """Two snarks (distinct vks): the folded context equals the reference's
    stream for stream, and its statement is `accumulate` of the two native
    accumulators."""
    ctx, ref, rvals = agg2
    assert_contexts_equal(ctx, ref)
    (_, p1), (_, p2) = inner, inner2
    stmt = [av.value for av in ctx.instance_cells]
    assert stmt == rvals == A.AggregationCircuit.get_instances(_args(p1, [p2]), None)
    accs = [VerifierChip.native_accumulator(p[0].vk, p[1], p[2], p[3]) for p in (p1, p2)]
    want = A.accumulate(accs)
    acc = A.Accumulator.from_limbs(stmt[:A.NUM_ACC_LIMBS])
    assert (_xy(acc.lhs), _xy(acc.rhs)) == (_xy(want.lhs), _xy(want.rhs))
    assert acc.check(p1[1])
    assert len(stmt) == A.NUM_ACC_LIMBS + 2


def test_wrong_instance_rejected_at_witness_time(inner):
    """The in-circuit identity check refuses a proof of other instances:
    ValueError in the port where the reference asserts."""
    (rpk, rsrs, rinst, rproof), (pk, srs, inst, proof) = inner
    ctx = Context()
    vc = VerifierChip(RangeChip(lookup_bits=14))
    cells = [[ctx.load_witness((int(v) + 1) % R) for v in col] for col in inst]
    with pytest.raises(ValueError, match="unequal"):
        vc.verify_proof(ctx, pk.vk, srs, cells, proof)
    rctx = RContext()
    rvc = RVerifierChip(RRangeChip(lookup_bits=14))
    rcells = [[rctx.load_witness((int(v) + 1) % R) for v in col] for col in rinst]
    with pytest.raises(AssertionError):
        rvc.verify_proof(rctx, rpk.vk, rsrs, rcells, rproof)


def test_native_sigma_merge_on_aggregation_copies(agg):
    """The aggregation context's copies (laid out at k=17): the host C++
    cycle merge gives the Python loop's targets exactly."""
    ctx, _, _ = agg
    cfg = ctx.auto_config(k=17, lookup_bits=A.AggregationCircuit.default_lookup_bits)
    copies = ctx.assignment(cfg).copies
    assert len(copies) > 1_000_000
    plain = sigma_targets(cfg, copies)
    native = sigma_targets(cfg, copies, native=True)
    assert np.array_equal(plain[0], native[0]) and np.array_equal(plain[1], native[1])


def test_committee_variant_reads_the_tracked_pinning():
    from spectre_tpu import spec as RSPEC
    circuit = A.AggregationCircuit.variant("committee_update")
    ref = RA.AggregationCircuit.variant("committee_update")
    assert circuit.name == ref.name == "aggregation_committee_update"
    path = circuit.pinning_path(SPEC.TESTNET, 22)
    assert (open(path).read() == open(ref.pinning_path(RSPEC.TESTNET, 22)).read())
    cfg = circuit.pinning(SPEC.TESTNET, 22).config
    assert (cfg.k, cfg.num_advice, cfg.num_lookup_advice, cfg.lookup_bits, cfg.num_fixed,
            cfg.num_instance) == (22, 16, 2, 14, 1, 1)


# -- the outer prove (slow) ---------------------------------------------------

@pytest.mark.slow
def test_outer_prove_at_k17_is_byte_identical():
    """The reference's outer circuit keyed and proved at k=17 under Keccak
    with seeded blinding, on the CPU: its vk digest, statement and proof
    bytes are the ones recorded in tests/data/torch_agg_k17_keccak.json,
    which `tests/test_torch_cuda.py` holds the port's prove on the card to
    (the port's CPU kernels would take hours at 2^17)."""
    import _torch_agg_k17 as K17
    assert K17.reference_outer() == K17.read_record()


def test_outer_record_is_the_k17_statement(inner):
    """The record the card's outer prove is held to carries the statement
    of this inner proof: the 12 limbs of the accumulator the port's native
    verifier computes, then the inner instance."""
    import _torch_agg_k17 as K17
    _, port = inner
    pk, srs, inst, proof = port
    rec = K17.read_record()
    assert (rec["k"], K17.INNER_SEED) == (17, 3)
    stmt = A.AggregationCircuit.get_instances(_args(port), K17.OuterSpec)
    assert [hex(v) for v in stmt] == rec["instances"]
    acc = VerifierChip.native_accumulator(pk.vk, srs, inst, proof)
    assert stmt == acc.limbs() + [v for col in inst for v in col]
