"""The port's StepCircuit on the CPU against the JAX package's, at the TINY
spec (2 pubkeys): the default args, the whole built context stream for
stream (24.6 M advice cells, 13.9 M copies, compared without a layout; the
full-width layout at the pinned testnet shape is checked on the GPU by
chip_smoke.py through Pinning.check), the instances, the native pre-check
and the device default of the entry points.
"""

import gc

import pytest
import torch

from spectre_tpu import spec as RSPEC
from spectre_tpu.models import StepCircuit as RStep
from spectre_tpu.witness import default_sync_step_args as ref_args
from spectre_tpu_torch import spec as SPEC
from spectre_tpu_torch.fields import bls12_381 as bls
from spectre_tpu_torch.models import StepCircuit
from spectre_tpu_torch.witness import default_sync_step_args

from _torch_ctx_compare import assert_contexts_equal, snapshot

TESTNET_K = 21


@pytest.fixture(scope="module")
def tiny():
    """(args, reference args, port context, snapshot of the reference
    context): the reference is built first and kept only as its snapshot,
    which holds the worker's peak memory to one context and a half."""
    rargs = ref_args(RSPEC.TINY)
    ref = snapshot(RStep.build_context(rargs, RSPEC.TINY))
    gc.collect()
    args = default_sync_step_args(SPEC.TINY)
    ctx = StepCircuit.build_context(args, SPEC.TINY, device="cpu")
    return args, rargs, ctx, ref


def _header(h):
    return (h.slot, h.proposer_index, h.parent_root, h.state_root, h.body_root)


def test_default_sync_step_args_equal_reference(tiny):
    args, rargs, _, _ = tiny
    assert args.pubkeys_uncompressed == rargs.pubkeys_uncompressed
    assert args.participation_bits == rargs.participation_bits
    assert _header(args.attested_header) == _header(rargs.attested_header)
    assert _header(args.finalized_header) == _header(rargs.finalized_header)
    assert args.finality_branch == rargs.finality_branch
    assert args.execution_payload_root == rargs.execution_payload_root
    assert args.execution_payload_branch == rargs.execution_payload_branch
    assert args.domain == rargs.domain
    assert args.signature_compressed == rargs.signature_compressed
    assert args.signing_root() == rargs.signing_root()


def test_tiny_context_equals_reference_stream_for_stream(tiny):
    _, _, ctx, ref = tiny
    assert ctx.stats()["advice_cells"] == len(ref.adv_values) > 20_000_000
    assert sorted(ctx.lkp_streams) == ["nibble", "nibble_op", "range"]
    assert_contexts_equal(ctx, ref)


def test_tiny_instances_equal_get_instances_of_both(tiny):
    args, rargs, ctx, _ = tiny
    got = StepCircuit.get_instances(args, SPEC.TINY)
    assert got == RStep.get_instances(rargs, RSPEC.TINY)
    assert got == [av.value for av in ctx.instance_cells]
    assert len(got) == 2


def test_wrong_signature_fails_the_native_precheck():
    args = default_sync_step_args(SPEC.TINY)
    args.signature_compressed = bls.g2_compress(bls.g2_curve.mul(bls.G2_GEN, 123))
    with pytest.raises(ValueError, match="aggregate signature invalid"):
        StepCircuit.build_context(args, SPEC.TINY, device="cpu")


def test_agg_blind_is_the_reference_constant():
    from spectre_tpu.models import step as rstep
    from spectre_tpu_torch.models import step
    assert step.AGG_BLIND_SCALAR == rstep.AGG_BLIND_SCALAR
    assert [int(c) for c in step.AGG_BLIND] == [int(c) for c in rstep.AGG_BLIND]
    assert (StepCircuit.use_wide_sha, StepCircuit.default_lookup_bits) == (False, 18)


def test_pinned_testnet_shape_reads_without_writing():
    path = StepCircuit.pinning_path(SPEC.TESTNET, TESTNET_K)
    before = open(path, "rb").read()
    pin = StepCircuit.pinning(SPEC.TESTNET, TESTNET_K)
    cfg = pin.config
    assert (cfg.k, cfg.num_advice, cfg.num_lookup_advice, cfg.lookup_bits) == (21, 16, 3, 18)
    assert sorted(cfg.lookup_tables) == ["nibble", "nibble_op", "range"]
    assert len(pin.break_points) == cfg.num_advice
    assert open(path, "rb").read() == before


def test_step_entry_points_default_to_cuda(tiny):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable here")
    args = tiny[0]
    with pytest.raises(RuntimeError, match="CUDA"):
        StepCircuit.build_context(args, SPEC.TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        StepCircuit.create_pk(None, SPEC.TINY, TESTNET_K, args)
    with pytest.raises(RuntimeError, match="CUDA"):
        StepCircuit.prove(None, None, args, SPEC.TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        StepCircuit.verify(None, None, [], b"")
