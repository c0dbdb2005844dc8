"""Stage 2 of the sync step on the CPU: the port's
`AggregationCircuit.variant("sync_step")` against the JAX package's, and the
reference's tracked step fixtures in the port's EVM.

The step's stage-1 proof has three lookup columns over the nibble, nibble_op
and range tables; the in-circuit verifier meets that multi-table lookup
argument only here. The step-shaped inner circuit of
`tests/_torch_step_inner.py` has the same tables at k=10: its Poseidon proof
is byte-identical in both packages, and the outer context over it equals the
reference's stream for stream. The outer shape rule of the reference's flow
(`scripts/_compressed_flow.py`) is `models.aggregation.outer_k`; the variant's
pinning auto-sizes without writing a file. The tracked step fixtures of
build/: the port's default step args give the tracked statement, the
tracked verifier compiled by the port accepts the tracked compressed proof
in the metered VM, and the Spectre contract's stepCompressed takes it
through that verifier as the reference's contract does.
"""

import gc
import json
import os
import sys

import pytest
import torch

from spectre_tpu import spec as RSPEC
from spectre_tpu.builder.context import Context as RContext
from spectre_tpu.builder.gate import GateChip as RGateChip
from spectre_tpu.builder.range_chip import RangeChip as RRangeChip
from spectre_tpu.builder.sha256_chip import Sha256Chip as RSha256Chip
from spectre_tpu.contracts import sol_gen as RSG
from spectre_tpu.contracts import spectre as RCS
from spectre_tpu.evm import solc as RSOLC
from spectre_tpu.evm import solc_spectre as RSS
from spectre_tpu.evm import vm as RV
from spectre_tpu.models import aggregation as RA
from spectre_tpu.plonk import backend as RB
from spectre_tpu.plonk import transcript as RT
from spectre_tpu.plonk.keygen import keygen as ref_keygen
from spectre_tpu.plonk.prover import prove as ref_prove
from spectre_tpu.plonk.srs import SRS as RSRS
from spectre_tpu.plonk.verifier import verify as ref_verify
from spectre_tpu_torch import spec as SPEC
from spectre_tpu_torch.contracts import sol_gen as SG
from spectre_tpu_torch.contracts import spectre as CS
from spectre_tpu_torch.evm import solc as SOLC
from spectre_tpu_torch.evm import solc_spectre as SS
from spectre_tpu_torch.evm import vm as V
from spectre_tpu_torch.models import StepCircuit
from spectre_tpu_torch.models import aggregation as A
from spectre_tpu_torch.plonk import transcript as T
from spectre_tpu_torch.plonk.verifier import verify
from spectre_tpu_torch.witness import default_sync_step_args

import _torch_step_inner as S
from _torch_ctx_compare import assert_contexts_equal, snapshot

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

BUILD = os.path.join(REPO, "build")
TAMPER_BYTE = chip_smoke.TAMPER_BYTE


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads per test process: the tier-1 run has six workers
    on one machine, and timing-sensitive tests elsewhere share its cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# -- the step-shaped inner proof ----------------------------------------------

@pytest.fixture(scope="module")
def inner():
    """(reference (pk, srs, instances, proof), port (pk, srs, instances,
    proof)): the step-shaped app keyed at k=10 and proved under Poseidon
    with seeded blinding by each package."""
    rctx = S.build(RContext(), RGateChip, RRangeChip, RSha256Chip)
    rcfg = rctx.auto_config(k=S.INNER_K, lookup_bits=S.INNER_LOOKUP_BITS)
    rasg = rctx.assignment(rcfg)
    rsrs = RSRS.unsafe_setup(S.INNER_K)
    bk = RB.get_backend("cpu")
    rpk = ref_keygen(rsrs, rcfg, rasg.fixed, rasg.selectors, rasg.copies, bk)
    rproof = ref_prove(rpk, rsrs, rasg, bk, transcript=RT.PoseidonTranscript(),
                       blinding_rng=S.seeded(S.INNER_SEED))
    return (rpk, rsrs, rasg.instances, rproof), S.port_inner("cpu")


def test_inner_has_the_steps_three_lookup_tables(inner):
    (rpk, _, rinst, _), (pk, _, inst, _) = inner
    cfg = pk.vk.config
    assert (cfg.k, cfg.num_lookup_advice, cfg.lookup_tables) == (S.INNER_K, 3, S.TABLES)
    assert (cfg.k, cfg.num_advice, cfg.num_lookup_advice, cfg.lookup_tables) == (
        rpk.vk.config.k, rpk.vk.config.num_advice, rpk.vk.config.num_lookup_advice,
        rpk.vk.config.lookup_tables)
    assert inst == rinst and len(inst[0]) == 2


def test_inner_poseidon_proof_is_byte_identical(inner):
    (rpk, rsrs, rinst, rproof), (pk, srs, inst, proof) = inner
    assert pk.vk.digest() == rpk.vk.digest()
    assert proof == rproof
    assert verify(pk.vk, srs, inst, proof, transcript_cls=T.PoseidonTranscript)
    assert ref_verify(rpk.vk, rsrs, rinst, proof, transcript_cls=RT.PoseidonTranscript)
    assert not verify(pk.vk, srs, inst, proof, transcript_cls=T.Blake2bTranscript)


# -- the outer context ----------------------------------------------------------

def _reference_flow_k(rctx) -> int:
    """The outer k of the reference's flow (scripts/_compressed_flow.py, with
    the range and cap of scripts/prove_step_compressed.py), on its context."""
    for k in range(20, 25):
        cagg = rctx.auto_config(k=k, lookup_bits=RA.AggregationCircuit.default_lookup_bits)
        if cagg.num_advice <= 12:
            return k
    raise AssertionError("no k in 20..24")


@pytest.fixture(scope="module")
def agg(inner):
    """(the port's context, the reference's snapshot, the reference's
    instance values, the reference flow's outer k and its shape there): the
    reference is built first and kept only as its snapshot."""
    (rpk, rsrs, rinst, rproof), (pk, srs, inst, proof) = inner
    rargs = RA.AggregationArgs(inner_vk=rpk.vk, srs=rsrs, inner_instances=rinst, proof=rproof)
    rctx = RA.AggregationCircuit.variant("sync_step").build_context(rargs, None)
    rvals = [av.value for av in rctx.instance_cells]
    rk = _reference_flow_k(rctx)
    rcfg = rctx.auto_config(k=rk, lookup_bits=RA.AggregationCircuit.default_lookup_bits)
    ref = snapshot(rctx)
    del rctx
    gc.collect()
    args = A.AggregationArgs(inner_vk=pk.vk, srs=srs, inner_instances=inst, proof=proof)
    ctx = A.AggregationCircuit.variant("sync_step").build_context(args, None, device="cpu")
    return ctx, ref, rvals, rk, rcfg


def test_step_aggregation_context_equals_reference(agg):
    ctx, ref, _, _, _ = agg
    assert len(ctx.adv_values) > 5_000_000
    assert_contexts_equal(ctx, ref)


def test_statement_and_get_instances(inner, agg):
    """12 accumulator limbs, then the inner circuit's 2 instances: the cells
    the build exposed, get_instances of both packages, and the native
    accumulator, which passes its pairing check."""
    (rpk, rsrs, rinst, rproof), (pk, srs, inst, proof) = inner
    ctx, _, rvals, _, _ = agg
    args = A.AggregationArgs(inner_vk=pk.vk, srs=srs, inner_instances=inst, proof=proof)
    stmt = A.AggregationCircuit.variant("sync_step").get_instances(args, None)
    assert stmt == [av.value for av in ctx.instance_cells] == rvals
    assert stmt == RA.AggregationCircuit.get_instances(
        RA.AggregationArgs(inner_vk=rpk.vk, srs=rsrs, inner_instances=rinst, proof=rproof), None)
    assert len(stmt) == A.NUM_ACC_LIMBS + 2 and stmt[A.NUM_ACC_LIMBS:] == inst[0]
    assert A.Accumulator.from_limbs(stmt[:A.NUM_ACC_LIMBS]).check(srs)


def test_outer_shape_rule_gives_the_reference_flows_k(agg):
    """models.aggregation.outer_k on the port's context is the k the reference's flow
    picks on its own, and the shape auto-sized there is the reference's."""
    ctx, _, _, rk, rcfg = agg
    lookup_bits = A.AggregationCircuit.default_lookup_bits
    assert A.outer_k(ctx, lookup_bits) == rk
    cfg = ctx.auto_config(k=rk, lookup_bits=lookup_bits)
    assert (cfg.k, cfg.num_advice, cfg.num_lookup_advice, cfg.num_fixed, cfg.lookup_tables) == (
        rcfg.k, rcfg.num_advice, rcfg.num_lookup_advice, rcfg.num_fixed, rcfg.lookup_tables)
    assert cfg.num_advice <= A.MAX_OUTER_ADVICE
    assert rk == 20 or ctx.auto_config(k=rk - 1, lookup_bits=lookup_bits).num_advice > 12


def test_variant_name_and_pinning_path_equal_reference(agg):
    """The variant's name and pinning path are the reference's; no pinning
    is tracked at k=21, so pinning() sizes the shape from the context (its
    break points the context's own) and writes no file."""
    ctx = agg[0]
    circuit = A.AggregationCircuit.variant("sync_step")
    ref = RA.AggregationCircuit.variant("sync_step")
    assert circuit.name == ref.name == "aggregation_sync_step" == "aggregation_" + StepCircuit.name
    path = circuit.pinning_path(SPEC.TESTNET, 21)
    assert os.path.realpath(path) == os.path.realpath(ref.pinning_path(RSPEC.TESTNET, 21))
    assert not os.path.exists(path)
    with pytest.raises(FileNotFoundError):
        circuit.pinning(SPEC.TESTNET, 21)
    pin = circuit.pinning(SPEC.TESTNET, 21, ctx)
    assert pin.config == ctx.auto_config(k=21, lookup_bits=circuit.default_lookup_bits)
    assert pin.break_points == ctx.column_starts(pin.config)[1]
    assert not os.path.exists(path)


# -- the tracked step fixtures --------------------------------------------------

def _tracked():
    """The tracked step verifier's source, the compressed proof's
    instances and bytes."""
    return chip_smoke.read_tracked_evm("step")


@pytest.fixture(scope="module")
def step_args():
    return default_sync_step_args(SPEC.TESTNET)


def _step_input(cs, args):
    return cs.StepInput(attested_slot=args.attested_header.slot,
                        finalized_slot=args.finalized_header.slot,
                        participation=sum(args.participation_bits),
                        finalized_header_root=args.finalized_header.hash_tree_root(),
                        execution_payload_root=args.execution_payload_root)


def test_default_step_args_give_the_tracked_statement(step_args):
    """The StepInput of the port's default args commits to the tracked
    instances[12] (in both packages' StepInput), and the step's committee
    Poseidon is instances[13]."""
    _, inst, _ = _tracked()
    assert len(inst) == A.NUM_ACC_LIMBS + 2
    commitment = _step_input(CS, step_args).to_public_inputs_commitment()
    assert commitment == _step_input(RCS, step_args).to_public_inputs_commitment()
    assert commitment == inst[12]
    assert StepCircuit.get_instances(step_args, SPEC.TESTNET) == inst[12:]


def test_tracked_step_proof_in_the_port_vm():
    """The tracked verifier compiled by the port (the reference compiler's
    bytecode) accepts the tracked compressed step proof in the metered VM
    with the evm_real of build/compressed_testnet_21.json, and rejects it
    with a byte flipped."""
    src, inst, pf = _tracked()
    assert SOLC.compile_verifier(src) == RSOLC.compile_verifier(src)
    with open(os.path.join(BUILD, "compressed_testnet_21.json")) as f:
        rec = json.load(f)
    got = SOLC.vm_verify(src, inst, pf, tamper_byte=TAMPER_BYTE)
    assert got["ok"] and not got["reverted"] and got["tamper_rejected"]
    real = rec["evm_real"]
    assert (got["gas_execution"], got["gas_total"], got["runtime_bytes"], got["eip170_ok"]) == \
        (real["gas_execution"], real["gas_total"], real["deployed_bytes"], real["eip170_ok"])
    assert len(pf) == rec["stage2_proof_bytes"] == 5600


def _step_compressed_flow(pkg_v, compile_verifier, compile_spectre, gen_spectre_sol, spec, cs,
                          args) -> list:
    """One World: the tracked step verifier compiled by the package, a
    Spectre holding the step's committee Poseidon for the attested period;
    stepCompressed with the tracked proof flipped, then whole. Returns
    each transaction's (success, revert reason, gas) and the state after
    it: head() and the finalized slot's header and payload roots."""
    src, inst, pf = _tracked()
    inp = _step_input(cs, args)
    world = pkg_v.World()
    _, init, _ = compile_verifier(src)
    step_v, _ = world.deploy(init, enforce_eip170=False)
    rotate_v, _ = world.deploy(chip_smoke.constant_verifier(False))
    _, spectre_init, _ = compile_spectre(gen_spectre_sol(spec))
    spectre, _ = world.deploy(spectre_init, chip_smoke.words(
        spec.sync_period(inp.attested_slot), inst[13], step_v, rotate_v))

    def state():
        out = []
        for sig, arg in (("head()", ()), ("blockHeaderRoots(uint256)", (inp.finalized_slot,)),
                         ("executionPayloadRoots(uint256)", (inp.finalized_slot,))):
            ok, ret, _ = world.call_view(spectre, chip_smoke.selector(sig)
                                         + chip_smoke.words(*arg))
            assert ok
            out.append(int.from_bytes(ret, "big"))
        return tuple(out)

    words = chip_smoke.words
    trace = []
    for proof in (chip_smoke.tampered(pf, TAMPER_BYTE), pf):
        ok, out, gas = world.transact(spectre, chip_smoke.selector(chip_smoke.STEP_C_SIG) + words(
            inp.attested_slot, inp.finalized_slot, inp.participation)
            + inp.finalized_header_root + inp.execution_payload_root
            + words(*inst[:12]) + words(32 * 18) + chip_smoke.padded(proof), gas=100_000_000)
        trace.append((ok, pkg_v.revert_reason(out) if not ok else None, gas, state()))
    return trace


def test_step_compressed_on_chain_equals_reference(step_args):
    """stepCompressed through the compiled tracked verifier: the flipped
    proof reverts and leaves head() at 0, the tracked proof moves head() to
    the finalized slot and stores its roots; the same trace, gas included,
    as the reference's contract, compiler and VM give."""
    got = _step_compressed_flow(V, SOLC.compile_verifier, SS.compile_spectre,
                                SG.gen_spectre_sol, SPEC.TESTNET, CS, step_args)
    want = _step_compressed_flow(RV, RSOLC.compile_verifier, RSS.compile_spectre,
                                 RSG.gen_spectre_sol, RSPEC.TESTNET, RCS, step_args)
    assert got == want
    (bad_ok, reason, _, bad_state), (ok, _, _, state) = got
    assert not bad_ok and reason in chip_smoke.VERIFIER_REVERTS and bad_state == (0, 0, 0)
    fin = step_args.finalized_header
    assert ok and state == (fin.slot, int.from_bytes(fin.hash_tree_root(), "big"),
                            int.from_bytes(step_args.execution_payload_root, "big"))


def test_streamed_order_is_todays_codegen_order(inner, monkeypatch):
    """The reference's codegen folds each constraint right after its
    temporaries since its all_expressions became a generator; fed a list
    (the eager order of before, in which the step's tracked verifier was
    generated) it emits every temporary first. chip_smoke.streamed_order
    turns the eager source into today's, and leaves today's as it is. The
    tracked step verifier in today's order compiles to its 44,380 runtime
    bytes."""
    from spectre_tpu.evm import codegen as RCG

    (rpk, rsrs, _, _), _ = inner
    now = RCG.gen_evm_verifier(rpk.vk, rsrs, num_instances=2)
    all_expressions = RCG.all_expressions
    monkeypatch.setattr(RCG, "all_expressions", lambda *a, **k: list(all_expressions(*a, **k)))
    eager = RCG.gen_evm_verifier(rpk.vk, rsrs, num_instances=2)
    assert eager != now and sorted(eager.split("\n")) == sorted(now.split("\n"))
    assert chip_smoke.streamed_order(eager) == now
    assert chip_smoke.streamed_order(now) == now
    src, _, _ = _tracked()
    streamed = chip_smoke.streamed_order(src)
    assert streamed != src
    assert SOLC.compile_verifier(streamed)[2]["runtime_bytes"] == 44380
