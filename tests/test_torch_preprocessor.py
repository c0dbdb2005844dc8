"""Witness acquisition's host side on the CPU against the JAX package: the
consensus-spec-test loader and generator (`preprocessor/spec_tests.py`), the
SSZ containers and the snappy codec, multiproofs, the serde fixture loaders
and `test_utils`. The same inputs go through both packages and every
comparison is exact: args field by field, bytes, roots, verdicts and error
messages (the port raises ValueError where the reference asserts).
"""

import dataclasses
import glob
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from spectre_tpu import spec as RSPEC, test_utils as RTU
from spectre_tpu.gadgets import multiproof as RMP
from spectre_tpu.preprocessor import snappy_codec as RSN, spec_tests as RST, ssz as RSSZ
from spectre_tpu.witness import (default_committee_update_args as ref_committee_args,
                                 default_sync_step_args as ref_step_args)
from spectre_tpu.witness import ref_fixtures as RRF
from spectre_tpu_torch import spec as SPEC, test_utils as TU
from spectre_tpu_torch.gadgets import multiproof as MP
from spectre_tpu_torch.preprocessor import (snappy_codec as SN, spec_tests as ST, ssz,
                                            step_args_from_finality_update)
from spectre_tpu_torch.witness import (default_committee_update_args,
                                       default_sync_step_args)
from spectre_tpu_torch.witness import ref_fixtures as RF

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES_DIR = os.path.join(REPO, "consensus-spec-tests", "tests", "minimal", "capella",
                         "light_client", "sync", "pyspec_tests")
CASES = sorted(os.path.basename(d) for d in glob.glob(os.path.join(CASES_DIR, "*"))
               if os.path.isdir(d))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads per test process: the tier-1 run has six workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _same(port_obj, ref_obj) -> None:
    """Two args dataclasses of the two packages, field by field."""
    assert type(port_obj).__name__ == type(ref_obj).__name__
    assert dataclasses.asdict(port_obj) == dataclasses.asdict(ref_obj)


def _outcome(fn, *args, exc=Exception):
    """(result, None) or (None, the message of the exception fn raised)."""
    try:
        return fn(*args), None
    except exc as e:
        return None, str(e)


def test_all_five_cases_are_vendored():
    assert CASES == ["force_update_cut_selfgen", "light_client_sync_selfgen",
                     "multi_update_selfgen", "process_update_no_finality_selfgen",
                     "skipped_period_force_update_selfgen"]


@pytest.mark.parametrize("case", CASES)
def test_vendored_case_gives_the_reference_args_or_refusal(case):
    d = os.path.join(CASES_DIR, case)
    assert TU.read_spec_test_steps(d) == RTU.read_spec_test_steps(d)
    assert ST.read_meta(d) == RST.read_meta(d)
    assert (ST.get_initial_sync_committee_poseidon(d, SPEC.MINIMAL, device="cpu")
            == RST.get_initial_sync_committee_poseidon(d, RSPEC.MINIMAL))
    ref, ref_err = _outcome(RST.read_test_files_and_gen_witness, d, RSPEC.MINIMAL,
                            exc=ValueError)
    if ref_err is not None:
        with pytest.raises(ValueError) as e:
            ST.read_test_files_and_gen_witness(d, SPEC.MINIMAL, device="cpu")
        assert str(e.value) == ref_err
        assert ST.valid_updates_from_test_path(d, SPEC.MINIMAL) == []
        return
    port = ST.read_test_files_and_gen_witness(d, SPEC.MINIMAL, device="cpu")
    _same(port[0], ref[0])
    _same(port[1], ref[1])
    assert ST.update_has_finality(port[0]) == RST.update_has_finality(ref[0])
    _, ref_verdict = _outcome(RST.verify_witness_branches, RSPEC.MINIMAL, *ref,
                              exc=AssertionError)
    _, verdict = _outcome(ST.verify_witness_branches, SPEC.MINIMAL, *port, exc=ValueError)
    assert verdict == ref_verdict
    # every update of the valid prefix, each on its own
    updates = ST.valid_updates_from_test_path(d, SPEC.MINIMAL)
    ref_updates = RST.valid_updates_from_test_path(d, RSPEC.MINIMAL)
    assert len(updates) == len(ref_updates) >= 1
    bootstrap = ST.load_snappy_ssz(os.path.join(d, "bootstrap.ssz_snappy"),
                                   ssz.light_client_bootstrap(SPEC.MINIMAL))
    gvr = bytes.fromhex(ST.read_meta(d)["genesis_validators_root"][2:])
    rboot = RST.load_snappy_ssz(os.path.join(d, "bootstrap.ssz_snappy"),
                                RSSZ.light_client_bootstrap(RSPEC.MINIMAL))
    for u, ru in list(zip(updates, ref_updates))[1:]:
        _same(ST.to_sync_circuit_witness(SPEC.MINIMAL, bootstrap.current_sync_committee, u,
                                         gvr, device="cpu"),
              RST.to_sync_circuit_witness(RSPEC.MINIMAL, rboot.current_sync_committee, ru,
                                          gvr))


@pytest.mark.parametrize("scenario", list(RST.SPEC_TEST_SCENARIOS))
def test_generator_writes_the_reference_files(scenario, tmp_path):
    assert ST.SPEC_TEST_SCENARIOS == RST.SPEC_TEST_SCENARIOS
    assert ST.CAPELLA_FORK_VERSION == RST.CAPELLA_FORK_VERSION
    RST.generate_spec_test(str(tmp_path / "ref"), RSPEC.TINY, 7, scenario)
    ST.generate_spec_test(str(tmp_path / "port"), SPEC.TINY, 7, scenario, device="cpu")
    names = sorted(os.listdir(tmp_path / "ref"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    assert {"bootstrap.ssz_snappy", "meta.yaml", "steps.yaml", "updates_0.ssz_snappy"} \
        <= set(names)
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "ref" / name).read_bytes()


def test_generated_fixture_loads_and_verifies(tmp_path):
    """The port's TINY fixture, read back by the port's loader: the args the
    reference's loader gives, every branch and the signature verify, and the
    bootstrap's Poseidon is the step's committee instance."""
    from spectre_tpu_torch.fields import bls12_381 as bls
    from spectre_tpu_torch.models import StepCircuit

    d = str(tmp_path)
    ST.generate_spec_test(d, SPEC.TINY, 3, "sync", device="cpu")
    step, rot = ST.read_test_files_and_gen_witness(d, SPEC.TINY, device="cpu")
    ref = RST.read_test_files_and_gen_witness(d, RSPEC.TINY)
    _same(step, ref[0])
    _same(rot, ref[1])
    ST.verify_witness_branches(SPEC.TINY, step, rot)
    pts = [(bls.Fq(x), bls.Fq(y)) for x, y in step.pubkeys_uncompressed]
    assert bls.fast_aggregate_verify(pts, step.signing_root(),
                                     bls.g2_decompress(step.signature_compressed),
                                     dst=SPEC.TINY.dst)
    period, poseidon = ST.get_initial_sync_committee_poseidon(d, SPEC.TINY, device="cpu")
    assert period == step.finalized_header.slot // SPEC.TINY.slots_per_period
    assert poseidon == StepCircuit.get_instances(step, SPEC.TINY)[1]


def test_gindex_tree_refuses_an_ancestor():
    with pytest.raises(AssertionError, match="ancestor"):
        RST.GindexTree({2: b"\x00" * 32, 5: b"\x00" * 32})
    with pytest.raises(ValueError, match="gindex 2 is an ancestor of 5"):
        ST.GindexTree({2: b"\x00" * 32, 5: b"\x00" * 32})
    t, rt = ST.GindexTree({9: b"\x01" * 32}), RST.GindexTree({9: b"\x01" * 32})
    assert t.root() == rt.root() and t.branch(9) == rt.branch(9)


# ---------------------------------------------------------------------------
# containers and the codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,kind", [("bootstrap.ssz_snappy", "light_client_bootstrap"),
                                       ("updates_0.ssz_snappy", "light_client_update"),
                                       ("updates_1.ssz_snappy", "light_client_update")])
def test_containers_round_trip_through_both_packages(name, kind):
    path = os.path.join(CASES_DIR, "multi_update_selfgen", name)
    blob = open(path, "rb").read()
    raw = RSN.decompress(blob)
    assert SN.decompress(blob) == raw
    assert SN.compress(raw) == RSN.compress(raw)
    t, rt = getattr(ssz, kind)(SPEC.MINIMAL), getattr(RSSZ, kind)(RSPEC.MINIMAL)
    obj, robj = t.decode(raw), rt.decode(raw)
    assert t.encode(obj) == raw == rt.encode(robj)
    assert t.hash_tree_root(obj) == rt.hash_tree_root(robj)
    # the port's object through the reference's type and back
    assert rt.encode(rt.decode(t.encode(obj))) == raw
    assert t.decode(rt.encode(robj)) == obj


def test_beacon_header_and_domain_equal_the_reference():
    from spectre_tpu_torch.witness.types import BeaconBlockHeader

    h = dict(slot=7, proposer_index=3, parent_root=b"\x01" * 32, state_root=b"\x02" * 32,
             body_root=b"\x03" * 32)
    root = ssz.BEACON_BLOCK_HEADER.hash_tree_root(ssz.Obj(**h))
    assert root == RSSZ.BEACON_BLOCK_HEADER.hash_tree_root(RSSZ.Obj(**h))
    assert root == BeaconBlockHeader(**h).hash_tree_root()
    gvr = hashlib.sha256(b"gvr").digest()
    for version in ST.CAPELLA_FORK_VERSION.values():
        assert (ssz.compute_domain(ssz.DOMAIN_SYNC_COMMITTEE, version, gvr)
                == RSSZ.compute_domain(RSSZ.DOMAIN_SYNC_COMMITTEE, version, gvr))


def test_ssz_refusals_match_the_reference():
    cases = [
        (lambda m: m.Bitvector(4).decode(b"\xff"), "Bitvector padding bits set"),
        (lambda m: m.Bitvector(4).decode(b"\x01\x00"), "Bitvector size mismatch"),
        (lambda m: m.uint64.decode(b"\x00" * 7), "uint64 size mismatch"),
        (lambda m: m.Bytes32.decode(b"\x00" * 31), "ByteVector[32] size mismatch"),
        (lambda m: m.ByteList(4).decode(b"\x00" * 5), "ByteList over limit"),
        (lambda m: m.Vector(m.Bytes32, 2).decode(b"\x00" * 32), "Vector size mismatch"),
        (lambda m: m.BEACON_BLOCK_HEADER.decode(b"\x00" * 10), "BeaconBlockHeader: size "
                                                              "mismatch 10 != 112"),
    ]
    for fn, msg in cases:
        with pytest.raises(AssertionError, match=msg.replace("[", r"\[")):
            fn(RSSZ)
        with pytest.raises(ValueError, match=msg.replace("[", r"\[")):
            fn(ssz)
    bv = ssz.Bitvector(4)
    assert bv.decode(bv.encode([1, 0, 1, 0])) == [1, 0, 1, 0]


def _snappy_payloads():
    rnd = np.random.default_rng(11).integers(0, 256, size=70000, dtype=np.uint8).tobytes()
    return [b"", b"a", b"hello" * 1000, rnd, bytes(300)]


def test_snappy_equals_the_reference():
    for payload in _snappy_payloads():
        blob = SN.compress(payload)
        assert blob == RSN.compress(payload)
        assert SN.decompress(blob) == payload == RSN.decompress(blob)
    # copy elements: a 2-byte-offset copy, an overlapping copy, a 1-byte
    # offset copy and a 4-byte offset copy
    streams = [
        bytes([8, 3 << 2]) + b"abcd" + bytes([(3 << 2) | 2]) + (4).to_bytes(2, "little"),
        bytes([8, 1 << 2]) + b"ab" + bytes([(5 << 2) | 2]) + (2).to_bytes(2, "little"),
        bytes([9, 4 << 2]) + b"abcde" + bytes([((4 - 4) << 2) | 1, 5]),
        bytes([8, 3 << 2]) + b"wxyz" + bytes([(3 << 2) | 3]) + (4).to_bytes(4, "little"),
    ]
    for s in streams:
        assert SN.decompress(s) == RSN.decompress(s)
    bad = [bytes([8, 3 << 2]) + b"ab",                            # truncated literal
           bytes([8, (3 << 2) | 2]) + (9).to_bytes(2, "little"),  # offset out of range
           bytes([9, 3 << 2]) + b"abcd"]                           # length mismatch
    for s in bad:
        _, ref_err = _outcome(RSN.decompress, s, exc=ValueError)
        _, err = _outcome(SN.decompress, s, exc=ValueError)
        assert ref_err is not None and err == ref_err
    with pytest.raises(ValueError, match="uvarint too long"):
        SN.decompress(b"\xff" * 10)


# ---------------------------------------------------------------------------
# multiproofs
# ---------------------------------------------------------------------------

def test_multiproof_roots_and_verdicts_equal_the_reference():
    rng = np.random.default_rng(5)
    leaves = [rng.integers(0, 256, size=32, dtype=np.uint8).tobytes() for _ in range(32)]
    tree, rtree = MP.merkle_tree(leaves), RMP.merkle_tree(leaves)
    assert tree == rtree
    root = tree[1]
    for indices in ([37], [40, 41], [33, 50, 62], [5, 48], [34, 35, 56]):
        assert MP.get_helper_indices(indices) == RMP.get_helper_indices(indices)
        got, want = MP.create_multiproof(tree, indices), RMP.create_multiproof(rtree, indices)
        assert got == want
        ls, proof = got
        assert MP.calculate_multi_merkle_root(ls, proof, indices) == root
        assert MP.verify_multiproof(root, ls, proof, indices)
        # forgeries: a flipped leaf, a flipped helper, a wrong index, a
        # missing helper, an extra helper
        flip = lambda b: bytes([b[0] ^ 1]) + b[1:]  # noqa: E731
        forged = [
            ([flip(ls[0])] + ls[1:], proof, indices),
            (ls, [flip(proof[0])] + proof[1:], indices),
            (ls, proof, [indices[0] ^ 1] + indices[1:]),
            (ls, proof[:-1], indices),
            (ls, proof + [proof[0]], indices),
            (ls + [ls[0]], proof, indices),
        ]
        for args in forged:
            assert MP.verify_multiproof(root, *args) == RMP.verify_multiproof(root, *args)
            assert not MP.verify_multiproof(root, *args)
    with pytest.raises(ValueError, match="power of two"):
        MP.merkle_tree(leaves[:3])
    with pytest.raises(ValueError, match="need 5 helpers, got 4"):
        MP.calculate_multi_merkle_root([leaves[0]], [leaves[0]] * 4, [37])


# ---------------------------------------------------------------------------
# the serde fixture loaders and test_utils
# ---------------------------------------------------------------------------

def _serde_hdr(h):
    return {"slot": h.slot, "proposer_index": h.proposer_index,
            "parent_root": "0x" + h.parent_root.hex(), "state_root": "0x" + h.state_root.hex(),
            "body_root": "0x" + h.body_root.hex()}


def _serde_json(step, rot) -> tuple[dict, dict]:
    """The reference Rust serde layout of both witnesses (byte lists,
    96-byte uncompressed pubkeys, the misspelled participation field)."""
    s = {
        "signature_compressed": list(step.signature_compressed),
        "pubkeys_uncompressed": [list(x.to_bytes(48, "big") + y.to_bytes(48, "big"))
                                 for x, y in step.pubkeys_uncompressed],
        "pariticipation_bits": [bool(b) for b in step.participation_bits],
        "attested_header": _serde_hdr(step.attested_header),
        "finalized_header": _serde_hdr(step.finalized_header),
        "finality_branch": [list(b) for b in step.finality_branch],
        "execution_payload_root": list(step.execution_payload_root),
        "execution_payload_branch": [list(b) for b in step.execution_payload_branch],
        "domain": list(step.domain),
    }
    r = {
        "pubkeys_compressed": [list(pk) for pk in rot.pubkeys_compressed],
        "finalized_header": _serde_hdr(rot.finalized_header),
        "sync_committee_branch": [list(b) for b in rot.sync_committee_branch],
    }
    return s, r


def test_ref_fixtures_load_equal_in_both_packages(tmp_path):
    step, rot = default_sync_step_args(SPEC.TINY), default_committee_update_args(SPEC.TINY)
    _same(step, ref_step_args(RSPEC.TINY))
    _same(rot, ref_committee_args(RSPEC.TINY))
    s, r = _serde_json(step, rot)
    (tmp_path / "sync_step_2.json").write_text(json.dumps(s))
    (tmp_path / "rotation_2.json").write_text(json.dumps(r))
    got = RF.load_sync_step(str(tmp_path / "sync_step_2.json"))
    _same(got, RRF.load_sync_step(str(tmp_path / "sync_step_2.json")))
    _same(got, step)
    got = RF.load_rotation(str(tmp_path / "rotation_2.json"))
    _same(got, RRF.load_rotation(str(tmp_path / "rotation_2.json")))
    _same(got, rot)
    _same(TU.load_reference_step_fixture(str(tmp_path / "sync_step_2.json")),
          RTU.load_reference_step_fixture(str(tmp_path / "sync_step_2.json")))


def test_test_utils_fixtures_equal_the_reference(tmp_path):
    step, rot = TU.generate_fixtures(SPEC.TINY, str(tmp_path / "port"), seed=5)
    rstep, rrot = RTU.generate_fixtures(RSPEC.TINY, str(tmp_path / "ref"), seed=5)
    _same(step, rstep)
    _same(rot, rrot)
    for name in ("sync_step_2.json", "rotation_2.json"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "ref" / name).read_bytes()
    _same(TU.load_step_fixture(str(tmp_path / "port" / "sync_step_2.json")), step)
    _same(TU.load_rotation_fixture(str(tmp_path / "port" / "rotation_2.json")), rot)
    a, b = TU.seeded_blinding_rng(9), RTU.seeded_blinding_rng(9)
    assert [a() for _ in range(5)] == [b() for _ in range(5)]
    # the mesh prove's fixture, at the reference's k (its keygen at k=13
    # takes minutes on the CPU: tests/test_torch_parallel.py proves it
    # under -m slow)
    import inspect
    assert inspect.signature(TU.mesh_prove_fixture).parameters["k"].default == \
        inspect.signature(RTU.mesh_prove_fixture).parameters["k"].default == 13


# ---------------------------------------------------------------------------
# entry points: CUDA by default
# ---------------------------------------------------------------------------

class TestDeviceDefault:
    """Without a GPU, every new entry point called without device= raises."""

    @pytest.fixture(autouse=True)
    def _no_gpu(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default is usable here")

    def test_entry_points_raise_without_a_gpu(self, tmp_path):
        from spectre_tpu_torch.fields import bls12_381 as bls
        from spectre_tpu_torch.ops.field384 import g1_decompress_batch

        d = os.path.join(CASES_DIR, "light_client_sync_selfgen")
        keys = [bls.g1_compress(bls.G1_GEN)]
        boot = ST.load_snappy_ssz(os.path.join(d, "bootstrap.ssz_snappy"),
                                  ssz.light_client_bootstrap(SPEC.MINIMAL))
        update = ST.valid_updates_from_test_path(d, SPEC.MINIMAL)[0]
        calls = [
            lambda **kw: g1_decompress_batch(keys, **kw),
            lambda **kw: ST.read_test_files_and_gen_witness(d, SPEC.MINIMAL, **kw),
            lambda **kw: ST.get_initial_sync_committee_poseidon(d, SPEC.MINIMAL, **kw),
            lambda **kw: ST.to_sync_circuit_witness(SPEC.MINIMAL, boot.current_sync_committee,
                                                    update, bytes(32), **kw),
            lambda **kw: ST.generate_spec_test(str(tmp_path / "g"), SPEC.TINY, 1, "sync", **kw),
            lambda **kw: step_args_from_finality_update({}, keys, bytes(32), SPEC.TINY, **kw),
        ]
        for call in calls:
            with pytest.raises(RuntimeError, match="CUDA"):
                call()
        assert g1_decompress_batch(keys, device="cpu") == [
            (int(bls.G1_GEN[0]), int(bls.G1_GEN[1]))]
        assert not os.path.exists(tmp_path / "g")
