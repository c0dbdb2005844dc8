"""The port's circuit builder on the CPU against the JAX reference: the SHA
chips, the host Poseidon and BLS12-381 G1 code, and the committee-update
circuit at the TINY spec (2 pubkeys). Every input is made from a seed and
every comparison is exact: bytes, ints, limb arrays and copy lists equal.
"""

import hashlib
import random

import numpy as np
import pytest
import torch

from spectre_tpu import spec as RSPEC
from spectre_tpu.builder import Context as RContext, GateChip as RGateChip
from spectre_tpu.builder.sha256_wide_chip import Sha256WideChip as RWideChip
from spectre_tpu.fields import bls12_381 as rbls
from spectre_tpu.gadgets import poseidon_commit as RPC, ssz_merkle as RM
from spectre_tpu.models import CommitteeUpdateCircuit as RCommittee
from spectre_tpu.ops import poseidon as RP, sha256 as RSHA
from spectre_tpu.witness.rotation import default_committee_update_args as ref_args
from spectre_tpu_torch import convert, spec as SPEC
from spectre_tpu_torch.builder import Context, GateChip
from spectre_tpu_torch.builder.sha256_chip import Sha256Chip
from spectre_tpu_torch.builder.sha256_wide_chip import Sha256WideChip
from spectre_tpu_torch.fields import bls12_381 as bls
from spectre_tpu_torch.gadgets import poseidon_commit as PC, ssz_merkle as M
from spectre_tpu_torch.models import CommitteeUpdateCircuit
from spectre_tpu_torch.ops import limbs as L, poseidon as P, sha256 as SHA
from spectre_tpu_torch.plonk.constraint_system import sha_selector_columns
from spectre_tpu_torch.witness import default_committee_update_args

TINY_K = 13     # the k tests/test_models.py mocks the TINY committee update at


def _digest(chip_cls, ctx, msg: bytes) -> bytes:
    sha = chip_cls(GateChip())
    cells = M.load_bytes_checked(ctx, sha, msg)
    words = sha.digest_bytes(ctx, cells)
    return b"".join(int(w.value).to_bytes(4, "big") for w in words)


@pytest.mark.parametrize("length", [0, 3, 48, 55, 64, 100])
def test_wide_chip_digest_equals_hashlib(length):
    msg = bytes(random.Random(length).randrange(256) for _ in range(length))
    ctx = Context()
    assert _digest(Sha256WideChip, ctx, msg) == hashlib.sha256(msg).digest()
    assert len(ctx.sha_slots) == len(SHA.pad_message(msg))


def test_nibble_chip_digest_equals_hashlib():
    msg = b"abc"
    assert _digest(Sha256Chip, Context(), msg) == hashlib.sha256(msg).digest()


def test_wide_chip_context_equals_reference():
    """One message through both chips gives the same streams, copies and
    region columns (laid out at the smallest k that holds them)."""
    msg = bytes(random.Random(7).randrange(256) for _ in range(80))
    ctx, rctx = Context(), RContext()
    _digest(Sha256WideChip, ctx, msg)
    rsha = RWideChip(RGateChip())
    rsha.digest_bytes(rctx, RM.load_bytes_checked(rctx, rsha, msg))
    cfg, rcfg = ctx.auto_config(k=9, lookup_bits=5), rctx.auto_config(k=9, lookup_bits=5)
    assert cfg == convert.circuit_config(rcfg)
    _assert_assignments_equal(ctx.assignment(cfg), rctx.assignment(rcfg))


def test_host_sha256_helpers_equal_reference():
    rng = random.Random(1)
    for length in (0, 55, 56, 64, 119):
        msg = bytes(rng.randrange(256) for _ in range(length))
        assert np.array_equal(SHA.pad_message(msg), RSHA.pad_message(msg))
    msgs = [bytes(rng.randrange(256) for _ in range(64)) for _ in range(3)]
    assert SHA.sha256_many(msgs) == [hashlib.sha256(m).digest() for m in msgs]
    assert np.array_equal(SHA.H0, RSHA.H0) and np.array_equal(SHA.K, RSHA.K)
    words = SHA.bytes32_to_words(msgs[0][:32])
    assert SHA.words_to_bytes32(words) == msgs[0][:32]


def test_sha_selector_columns_equal_reference():
    from spectre_tpu.plonk.constraint_system import CircuitConfig as RConfig
    from spectre_tpu.plonk.constraint_system import sha_selector_columns as ref_sel

    kw = dict(k=9, num_advice=2, num_lookup_advice=1, num_fixed=1, lookup_bits=5,
              lookup_tables=("nibble",), num_sha_slots=5)
    sel, kcol = sha_selector_columns(convert.circuit_config(RConfig(**kw)))
    rsel, rk = ref_sel(RConfig(**kw))
    assert np.array_equal(sel, np.array(rsel, dtype=np.uint64))
    assert np.array_equal(kcol, np.array(rk, dtype=np.uint64))


def test_poseidon_constants_equal_reference():
    rc, mds = P.constants()
    assert (rc, mds) == RP.constants()
    assert len(rc) == (P.R_F + P.R_P) * P.T and len(mds) == P.T


def test_poseidon_permutation_and_sponge_equal_reference():
    rng = random.Random(5)
    for _ in range(3):
        state = [rng.randrange(P.R) for _ in range(P.T)]
        assert P.permute_native(state) == RP.permute_native(state)
    vals = [rng.randrange(P.R) for _ in range(25)]
    ours, ref = P.PoseidonSponge(), RP.PoseidonSponge()
    ours.absorb(vals)
    ref.absorb(vals)
    assert ours.squeeze() == ref.squeeze()
    limbs = [[rng.randrange(1 << 104) for _ in range(5)] for _ in range(4)]
    signs = [rng.randrange(2) for _ in range(4)]
    assert (PC.g1_array_poseidon_native(limbs, signs)
            == RPC.g1_array_poseidon_native(limbs, signs))


def test_g1_compress_decompress_equal_reference():
    rng = random.Random(9)
    for sk in [1, 2] + [rng.randrange(1, bls.R) for _ in range(4)]:
        pt, rpt = bls.sk_to_pk(sk), rbls.sk_to_pk(sk)
        b = bls.g1_compress(pt)
        assert b == rbls.g1_compress(rpt)
        back, rback = bls.g1_decompress(b), rbls.g1_decompress(b)
        assert (int(back[0]), int(back[1])) == (int(rback[0]), int(rback[1]))
        assert back == pt
    inf = bls.g1_compress(None)
    assert inf == rbls.g1_compress(None) and bls.g1_decompress(inf) is None
    with pytest.raises(ValueError):
        bls.g1_decompress(b"\x00" * 48)                  # no compression flag
    with pytest.raises(ValueError):
        bls.g1_decompress(bytes([0x9F]) + b"\xff" * 47)  # x >= p


# --- the committee update at the TINY spec --------------------------------

@pytest.fixture(scope="module")
def tiny():
    args, rargs = default_committee_update_args(SPEC.TINY), ref_args(RSPEC.TINY)
    ctx = CommitteeUpdateCircuit.build_context(args, SPEC.TINY, device="cpu")
    rctx = RCommittee.build_context(rargs, RSPEC.TINY)
    return args, rargs, ctx, rctx


def test_default_committee_update_args_equal_reference(tiny):
    args, rargs, _, _ = tiny
    assert args.pubkeys_compressed == rargs.pubkeys_compressed
    assert args.sync_committee_branch == rargs.sync_committee_branch
    h, rh = args.finalized_header, rargs.finalized_header
    assert (h.slot, h.proposer_index, h.parent_root, h.state_root, h.body_root) == \
        (rh.slot, rh.proposer_index, rh.parent_root, rh.state_root, rh.body_root)
    assert h.hash_tree_root() == rh.hash_tree_root()
    assert args.committee_pubkeys_root() == rargs.committee_pubkeys_root()


def _assert_assignments_equal(asg, rasg):
    for name in ("advice", "lookup_advice", "fixed"):
        ours, ref = getattr(asg, name), getattr(rasg, name)
        assert len(ours) == len(ref), name
        for j, (a, b) in enumerate(zip(ours, ref)):
            assert np.array_equal(a, L.ints_to_limbs(b)), f"{name}[{j}]"
    assert len(asg.selectors) == len(rasg.selectors)
    for a, b in zip(asg.selectors, rasg.selectors):
        assert np.array_equal(a, np.array(b, dtype=np.uint64))
    assert np.array_equal(asg.sha_bit, rasg.sha_bit)
    assert np.array_equal(asg.sha_word, rasg.sha_word)
    assert np.array_equal(asg.copies, np.array(rasg.copies, dtype=np.int64).reshape(-1, 4))
    assert asg.instances == rasg.instances


def test_tiny_assignment_equals_reference_field_by_field(tiny):
    _, _, ctx, rctx = tiny
    cfg = ctx.auto_config(k=TINY_K, lookup_bits=CommitteeUpdateCircuit.default_lookup_bits)
    rcfg = rctx.auto_config(k=TINY_K, lookup_bits=RCommittee.default_lookup_bits)
    assert cfg == convert.circuit_config(rcfg)
    assert cfg.num_sha_slots > 0
    _assert_assignments_equal(ctx.assignment(cfg), rctx.assignment(rcfg))
    assert ctx.layout(cfg)[6] == rctx.layout(rcfg)[6]          # break points
    assert ctx.stats()["copies"] == len(rctx.copies)


def test_tiny_get_instances_equal_reference(tiny):
    args, rargs, ctx, _ = tiny
    got = CommitteeUpdateCircuit.get_instances(args, SPEC.TINY)
    assert got == RCommittee.get_instances(rargs, RSPEC.TINY)
    assert got == [av.value for av in ctx.instance_cells]


def test_pinned_testnet_shape_reads_without_writing():
    path = CommitteeUpdateCircuit.pinning_path(SPEC.TESTNET, 18)
    before = open(path, "rb").read()
    pin = CommitteeUpdateCircuit.pinning(SPEC.TESTNET, 18)
    assert (pin.config.k, pin.config.num_advice, pin.config.num_sha_slots) == (18, 22, 2070)
    assert pin.config.lookup_tables == ("nibble",)
    assert len(pin.break_points) == pin.config.num_advice
    assert open(path, "rb").read() == before


def test_committee_entry_points_default_to_cuda(tiny):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable here")
    args = tiny[0]
    with pytest.raises(RuntimeError, match="CUDA"):
        CommitteeUpdateCircuit.build_context(args, SPEC.TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        CommitteeUpdateCircuit.create_pk(None, SPEC.TINY, TINY_K, args)
    with pytest.raises(RuntimeError, match="CUDA"):
        CommitteeUpdateCircuit.prove(None, None, args, SPEC.TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        CommitteeUpdateCircuit.verify(None, None, [], b"")
