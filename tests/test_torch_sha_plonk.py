"""The wide SHA-256 region through the port's plonk layer on the CPU, against
the JAX reference: the expression stream, the query and commitment plans,
the vk digest, and a seeded prove of a wide-SHA digest circuit whose bytes
equal the reference's; plus the SRS's truncation, its derivation from a
larger cached file and its checksum sidecar.

The digest circuit is the one of tests/test_sha_wide.py::TestWideProve
(one 64-byte block: sha256 of a 21-byte message, two digest words public)
at k=7, the smallest k whose usable rows hold its 72-row slot. Every
comparison is exact.
"""

import hashlib
import os
import random

import numpy as np
import pytest
import torch

from spectre_tpu.builder import Context as RContext, GateChip as RGateChip
from spectre_tpu.builder.sha256_wide_chip import Sha256WideChip as RWideChip
from spectre_tpu.gadgets import ssz_merkle as RM
from spectre_tpu.plonk import backend as RB
from spectre_tpu.plonk.expressions import ScalarCtx as RScalarCtx
from spectre_tpu.plonk.expressions import all_expressions as ref_expressions
from spectre_tpu.plonk.keygen import VerifyingKey as RVerifyingKey, keygen as ref_keygen
from spectre_tpu.plonk.prover import prove as ref_prove
from spectre_tpu.plonk.srs import SRS as RSRS
from spectre_tpu.plonk.verifier import verify as ref_verify
from spectre_tpu.utils.pinning import Pinning as RPinning
from spectre_tpu_torch import convert
from spectre_tpu_torch.builder import Context, GateChip
from spectre_tpu_torch.builder.sha256_wide_chip import Sha256WideChip
from spectre_tpu_torch.fields import bn254
from spectre_tpu_torch.gadgets import ssz_merkle as M
from spectre_tpu_torch.plonk.expressions import ScalarCtx, all_expressions
from spectre_tpu_torch.plonk.kzg import host_msm
from spectre_tpu_torch.plonk.keygen import VerifyingKey, keygen
from spectre_tpu_torch.plonk.prover import PhaseTimer, prove
from spectre_tpu_torch.plonk.srs import SRS
from spectre_tpu_torch.plonk.verifier import verify
from spectre_tpu_torch.utils import artifacts
from spectre_tpu_torch.utils.pinning import Pinning

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTEE_PIN = os.path.join(REPO, "build", "committee_update_testnet_18.pinning.json")
MSG = b"prove the wide region"
K = 7
R = bn254.R


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads per test process: the tier-1 run has six workers
    on one machine, and timing-sensitive tests elsewhere share its cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _rng(seed: int):
    r = random.Random(seed)
    return lambda: r.randrange(R)


def _digest_circuit(ctx_cls, gate_cls, chip_cls, merkle):
    ctx = ctx_cls()
    sha = chip_cls(gate_cls())
    words = sha.digest_bytes(ctx, merkle.load_bytes_checked(ctx, sha, MSG))
    for w in words[:2]:
        ctx.expose_public(w.cell)
    return ctx


@pytest.fixture(scope="module")
def wide():
    """Both packages key and prove the digest circuit, each from its own
    builder, with the same seeded blinding."""
    rctx = _digest_circuit(RContext, RGateChip, RWideChip, RM)
    rcfg = rctx.auto_config(k=K, lookup_bits=5)
    rsrs = RSRS.unsafe_setup(K)
    rasg = rctx.assignment(rcfg)
    rpk = ref_keygen(rsrs, rcfg, rasg.fixed, rasg.selectors, rasg.copies,
                     RB.get_backend("cpu"))
    rproof = ref_prove(rpk, rsrs, rasg, RB.get_backend("cpu"), blinding_rng=_rng(5))

    ctx = _digest_circuit(Context, GateChip, Sha256WideChip, M)
    cfg = ctx.auto_config(k=K, lookup_bits=5)
    srs = SRS.unsafe_setup(K, device="cpu")
    asg = ctx.assignment(cfg)
    pk = keygen(srs, cfg, asg.fixed, asg.selectors, asg.copies, device="cpu")
    timer = PhaseTimer(torch.device("cpu"))
    proof = prove(pk, srs, asg, device="cpu", blinding_rng=_rng(5), timer=timer)
    return dict(rcfg=rcfg, rsrs=rsrs, rasg=rasg, rpk=rpk, rproof=rproof,
                cfg=cfg, srs=srs, asg=asg, pk=pk, proof=proof, timer=timer)


def test_digest_circuit_shape(wide):
    cfg = wide["cfg"]
    assert cfg == convert.circuit_config(wide["rcfg"])
    assert cfg.num_sha_slots == 1 and cfg.k == K
    digest = hashlib.sha256(MSG).digest()
    assert wide["asg"].instances == [[int.from_bytes(digest[:4], "big"),
                                      int.from_bytes(digest[4:8], "big")]]


def test_vk_digest_and_plans_equal_reference(wide):
    vk, rvk = wide["pk"].vk, wide["rpk"].vk
    assert vk.digest() == rvk.digest()
    assert vk.query_plan() == rvk.query_plan()
    assert vk.commitment_plan() == rvk.commitment_plan()
    assert ({k: (int(p[0]), int(p[1])) for k, p in vk.fixed_commitment_map().items()}
            == {k: (int(p[0]), int(p[1])) for k, p in rvk.fixed_commitment_map().items()})


def test_wide_proof_is_byte_identical(wide):
    assert wide["proof"] == wide["rproof"]
    assert {"commit_advice", "quotient", "multiopen"} <= set(wide["timer"].seconds)


def test_wide_proof_verifies_in_both_packages(wide):
    inst = wide["asg"].instances
    assert verify(wide["pk"].vk, wide["srs"], inst, wide["proof"])
    assert ref_verify(wide["rpk"].vk, wide["rsrs"], inst, wide["proof"])


def test_wide_proof_rejects_a_flipped_instance(wide):
    bad = [list(wide["asg"].instances[0])]
    bad[0][0] ^= 1
    assert not verify(wide["pk"].vk, wide["srs"], bad, wide["proof"])
    assert not ref_verify(wide["rpk"].vk, wide["rsrs"], bad, wide["proof"])


def test_keygen_sha_columns_equal_reference(wide):
    """The SHA selectors' and round constants' coefficient forms equal the
    reference's, and convert.py carries the reference's key across."""
    from spectre_tpu_torch.ops import field_ops as F

    pk, rpk = wide["pk"], wide["rpk"]
    fr = F.fr_ctx()
    assert len(pk.sha_selector_polys) == len(rpk.sha_selector_polys) == 7
    for ours, ref in zip(pk.sha_selector_polys + [pk.sha_k_poly],
                         rpk.sha_selector_polys + [rpk.sha_k_poly]):
        assert np.array_equal(F.to_std(fr, ours), ref)
    assert convert.proving_key(rpk, "cpu").vk.digest() == rpk.vk.digest()


def _seeded_evals(seed: bytes):
    """Values keyed by (key, rotation), independent of reading order."""
    class Evals(dict):
        def __missing__(self, k):
            v = int.from_bytes(hashlib.sha256(seed + repr(k).encode()).digest(), "big") % R
            self[k] = v
            return v
    return Evals()


def test_committee_expression_stream_equals_reference():
    """The pinned committee config's whole stream through ScalarCtx on
    seeded evaluations: every expression value equal, in the same order."""
    cfg = Pinning.read(COMMITTEE_PIN).config
    rcfg = RPinning.read(COMMITTEE_PIN).config
    beta, gamma = 0x1234567, 0x7654321
    args = (11, 22, 33, 44)
    ev, rev = _seeded_evals(b"e"), _seeded_evals(b"e")
    ours = list(all_expressions(cfg, ScalarCtx(cfg, ev, *args), beta, gamma))
    ref = list(ref_expressions(rcfg, RScalarCtx(rcfg, rev, *args), beta, gamma))
    assert ours == ref
    assert len(ours) == 190
    assert set(ev) == set(rev)
    assert len([k for k in ev if k[0][0] == "shb"]) == 488


def test_committee_plans_equal_reference():
    """Query and commitment plans at the pinned committee config, with
    the injectivity of its rotation tags (-65 among them)."""
    cfg = Pinning.read(COMMITTEE_PIN).config
    rcfg = RPinning.read(COMMITTEE_PIN).config
    vk = VerifyingKey(cfg, [], [], [], [])
    rvk = RVerifyingKey(rcfg, [], [], [], [])
    assert vk.query_plan() == rvk.query_plan()
    assert vk.commitment_plan() == rvk.commitment_plan()
    assert (("shw", 0), -65) in vk.query_plan()
    vk.assert_rotation_injective()


def test_host_msm_equals_curve_sum():
    rng = random.Random(2)
    g1 = bn254.g1_curve
    pts = [g1.mul(bn254.G1_GEN, rng.randrange(1, R)) for _ in range(12)]
    pts += [None, pts[0], g1.neg(pts[1])]
    scalars = [rng.randrange(R) for _ in range(12)] + [7, R - 1, 1]
    assert host_msm(pts, scalars) == g1.msm(pts, scalars)
    assert host_msm(pts[:1], [0]) is None


# --- SRS: truncation, derivation from a larger file, the sidecar -----------

@pytest.fixture(scope="module")
def srs9():
    return SRS.unsafe_setup(9, device="cpu")


def test_srs_truncate_equals_smaller_setup(srs9):
    small = SRS.unsafe_setup(7, device="cpu")
    cut = srs9.truncate(7)
    assert cut.to_bytes() == small.to_bytes()
    assert cut.digest() == small.digest() == RSRS.unsafe_setup(7).digest()
    with pytest.raises(ValueError):
        small.truncate(8)


def test_srs_derives_from_a_larger_cached_file(srs9, tmp_path):
    srs9.write(str(tmp_path / "kzg_bn254_9.srs"))
    got = SRS.load_or_setup(7, str(tmp_path), device="cpu")
    assert got.to_bytes() == srs9.truncate(7).to_bytes()
    path = tmp_path / "kzg_bn254_7.srs"
    assert path.read_bytes() == got.to_bytes()
    assert (tmp_path / "kzg_bn254_7.srs.sha256").read_text().strip() == \
        hashlib.sha256(path.read_bytes()).hexdigest()
    assert SRS.read(str(path)).digest() == got.digest()


def test_srs_sidecar_refuses_a_corrupted_file(srs9, tmp_path):
    path = str(tmp_path / "kzg_bn254_9.srs")
    srs9.write(path)
    raw = bytearray(open(path, "rb").read())
    raw[100] ^= 1
    open(path, "wb").write(bytes(raw))
    with pytest.raises(artifacts.ArtifactCorrupt):
        SRS.read(path)
    with pytest.raises(artifacts.ArtifactCorrupt):
        SRS.load_or_setup(9, str(tmp_path), device="cpu")
    os.remove(path + artifacts.SIDECAR_SUFFIX)       # no sidecar: loads as it is
    assert SRS.read(path).k == 9
