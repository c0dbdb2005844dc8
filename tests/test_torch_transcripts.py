"""The port's Fiat-Shamir transcripts against the JAX package's on the CPU:
Keccak-256 itself, the challenge streams of the Poseidon and Keccak
transcripts over one seeded absorb sequence, and the K=6 readiness circuit
of `prover_service/selfverify.py` proved under each transcript with the
same seeded blinding: byte-identical proofs, accepted by both verifiers
(a flipped instance rejected by both), and equal deferred accumulators.
"""

import random

import numpy as np
import pytest
import torch

from spectre_tpu.fields import bn254 as rbn
from spectre_tpu.plonk import backend as RB
from spectre_tpu.plonk import transcript as RT
from spectre_tpu.plonk.prover import prove as ref_prove
from spectre_tpu.plonk.verifier import verify as ref_verify
from spectre_tpu.plonk.verifier import verify_deferred as ref_verify_deferred
from spectre_tpu.prover_service.selfverify import _tiny_setup
from spectre_tpu_torch import convert
from spectre_tpu_torch.fields import bn254
from spectre_tpu_torch.plonk import transcript as T
from spectre_tpu_torch.plonk.keygen import keygen
from spectre_tpu_torch.plonk.prover import prove
from spectre_tpu_torch.plonk.srs import SRS
from spectre_tpu_torch.plonk.verifier import verify, verify_deferred

TRANSCRIPTS = {"poseidon": (T.PoseidonTranscript, RT.PoseidonTranscript),
               "keccak": (T.KeccakTranscript, RT.KeccakTranscript)}


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
    return lambda: r.randrange(rbn.R)


def _xy(pt):
    return None if pt is None else (int(pt[0]), int(pt[1]))


def test_keccak256_equals_reference_on_seeded_bytes():
    """Every length from 0 to 300 bytes (two rate blocks and the padding
    edges 135, 136 among them)."""
    rng = np.random.default_rng(17)
    for n in range(301):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert T.keccak256(data) == RT.keccak256(data), n
    # the empty string's Keccak-256 (Ethereum's constant)
    assert T.keccak256(b"").hex() == (
        "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470")


def test_point_encoding_equals_reference():
    pt = bn254.g1_curve.mul(bn254.G1_GEN, 12345)
    rpt = rbn.g1_curve.mul(rbn.G1_GEN, 12345)
    assert T.point_to_transcript_elements(pt) == RT.point_to_transcript_elements(rpt)
    assert all(v < 1 << T.ACC_LIMB_BITS for v in T.point_to_transcript_elements(pt))


@pytest.mark.parametrize("name", sorted(TRANSCRIPTS))
def test_challenge_streams_equal_reference(name):
    """One seeded sequence of point, scalar and byte absorbs with
    challenges between them: the same challenges and the same proof bytes,
    and a reader of those bytes derives the same challenges again."""
    port_cls, ref_cls = TRANSCRIPTS[name]
    rng = np.random.default_rng(5)
    ops = []
    for _ in range(60):
        kind = int(rng.integers(0, 5))
        if kind == 0:
            ops.append(("point", int(rng.integers(1, 1 << 62))))
        elif kind == 1:
            ops.append(("scalar", int.from_bytes(rng.bytes(32), "big") % rbn.R))
        elif kind == 2:
            ops.append(("bytes", rng.bytes(int(rng.integers(0, 70)))))
        else:
            ops.append(("challenge", None))

    def run(tr, curve, gen, reader=False):
        out = []
        for kind, v in ops:
            if kind == "point":
                pt = curve.mul(gen, v)
                out.append(_xy(tr.read_point()) if reader else tr.write_point(pt))
            elif kind == "scalar":
                out.append(tr.read_scalar() if reader else tr.write_scalar(v))
            elif kind == "bytes":
                tr._absorb_bytes(v)
            else:
                out.append(tr.challenge())
        return [c for c in out if c is not None]

    port, ref = port_cls(), ref_cls()
    got = run(port, bn254.g1_curve, bn254.G1_GEN)
    want = run(ref, rbn.g1_curve, rbn.G1_GEN)
    assert got == want and len(got) > 10
    proof = port.finalize()
    assert proof == ref.finalize()
    reader = port_cls(proof)
    again = run(reader, bn254.g1_curve, bn254.G1_GEN, reader=True)
    reader.assert_consumed()
    assert [c for (kind, _), c in zip([o for o in ops if o[0] != "bytes"], again)
            if kind == "challenge"] == got


@pytest.fixture(scope="module")
def tiny():
    """The readiness circuit: the reference's key, and the port's from the
    same assignment."""
    rpk, rsrs, rasg, out = _tiny_setup()
    srs = SRS.unsafe_setup(6, device="cpu")
    asg = convert.assignment(rasg)
    pk = keygen(srs, asg.config, asg.fixed, asg.selectors, asg.copies, device="cpu")
    assert pk.vk.digest() == rpk.vk.digest()
    return rpk, rsrs, rasg, out, pk, srs, asg


@pytest.mark.parametrize("name", sorted(TRANSCRIPTS))
def test_tiny_proof_under_transcript_is_byte_identical(tiny, name):
    port_cls, ref_cls = TRANSCRIPTS[name]
    rpk, rsrs, rasg, out, pk, srs, asg = tiny
    rproof = ref_prove(rpk, rsrs, rasg, RB.get_backend("cpu"), transcript=ref_cls(),
                       blinding_rng=_rng(0xC0FFEE))
    proof = prove(pk, srs, asg, device="cpu", transcript=port_cls(),
                  blinding_rng=_rng(0xC0FFEE))
    assert proof == rproof
    assert verify(pk.vk, srs, [[out]], proof, transcript_cls=port_cls)
    assert ref_verify(rpk.vk, rsrs, [[out]], proof, transcript_cls=ref_cls)
    # the other transcripts derive other challenges: the proof is theirs only
    assert not verify(pk.vk, srs, [[out]], proof)
    flipped = [[out ^ 1]]
    assert not verify(pk.vk, srs, flipped, proof, transcript_cls=port_cls)
    assert not ref_verify(rpk.vk, rsrs, flipped, proof, transcript_cls=ref_cls)
    acc = verify_deferred(pk.vk, srs, [[out]], proof, transcript_cls=port_cls)
    racc = ref_verify_deferred(rpk.vk, rsrs, [[out]], proof, transcript_cls=ref_cls)
    assert acc is not None and [_xy(p) for p in acc] == [_xy(p) for p in racc]
    assert verify_deferred(pk.vk, srs, flipped, proof, transcript_cls=port_cls) is None
