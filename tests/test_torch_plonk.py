"""The slice as a whole on the CPU: the port's SRS, keygen and prove against
the JAX reference with CpuBackend.

With the same seeded `blinding_rng`, the port's proofs are byte-identical to
the reference's for the K=6 readiness circuit of
`prover_service/selfverify.py` and for a small flex-gate circuit; both
verifiers accept them and reject a one-byte tamper. convert.py carries a
reference SRS and proving key across and back unchanged.
"""

import random

import numpy as np
import pytest
import torch

from spectre_tpu.fields import bn254 as rbn
from spectre_tpu.plonk import backend as RB
from spectre_tpu.plonk.constraint_system import Assignment as RefAssignment
from spectre_tpu.plonk.constraint_system import CircuitConfig as RefConfig
from spectre_tpu.plonk.keygen import keygen as ref_keygen
from spectre_tpu.plonk.prover import prove as ref_prove
from spectre_tpu.plonk.srs import SRS as RefSRS
from spectre_tpu.plonk.verifier import verify as ref_verify
from spectre_tpu.prover_service.selfverify import _tiny_setup
from spectre_tpu_torch import convert
from spectre_tpu_torch.plonk.keygen import keygen
from spectre_tpu_torch.plonk.prover import PhaseTimer, prove
from spectre_tpu_torch.plonk.srs import SRS
from spectre_tpu_torch.plonk.verifier import verify
from spectre_tpu_torch.witness import flex_circuit


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


def _tamper(proof: bytes, at: int) -> bytes:
    bad = bytearray(proof)
    bad[at] ^= 1
    return bytes(bad)


@pytest.fixture(scope="module")
def tiny():
    """The reference's readiness circuit, keyed and proved by the reference."""
    pk, srs, asg, out = _tiny_setup()
    proof = ref_prove(pk, srs, asg, RB.get_backend("cpu"), blinding_rng=_rng(0xC0FFEE))
    return pk, srs, asg, out, proof


def test_srs_bytes_equal_reference():
    port = SRS.unsafe_setup(6, device="cpu")
    ref = RefSRS.unsafe_setup(6)
    assert np.array_equal(port.g1_powers, ref.g1_powers)
    assert bytes(rbn.g2_to_bytes(ref.g2_tau)) == convert.srs_arrays(port)["g2_tau"]
    assert port.digest() == ref.digest()


def test_tiny_circuit_proof_is_byte_identical(tiny):
    rpk, rsrs, rasg, out, rproof = tiny
    srs = SRS.unsafe_setup(6, device="cpu")
    asg = convert.assignment(rasg)
    pk = keygen(srs, asg.config, asg.fixed, asg.selectors, asg.copies, device="cpu")
    assert pk.vk.digest() == rpk.vk.digest()
    timer = PhaseTimer(pk.sigma_values[0].device)
    proof = prove(pk, srs, asg, device="cpu", blinding_rng=_rng(0xC0FFEE), timer=timer)
    assert proof == rproof
    assert set(timer.seconds) >= {"commit_advice", "quotient", "multiopen"}
    assert verify(pk.vk, srs, [[out]], proof)
    assert ref_verify(rpk.vk, rsrs, [[out]], proof)
    for at in (100, len(proof) - 40):
        bad = _tamper(proof, at)
        assert not verify(pk.vk, srs, [[out]], bad)
        assert not ref_verify(rpk.vk, rsrs, [[out]], bad)


def test_flex_circuit_from_reference_keygen_is_byte_identical():
    """One keygen's output (the reference's) feeds both provers."""
    kw = dict(k=7, num_advice=3, num_lookup_advice=1, num_fixed=1,
              lookup_bits=5, lookup_tables=("range",))
    fc = flex_circuit(convert.circuit_config(RefConfig(**kw)), seed=3, num_copies=24)
    cols = lambda cs: [[int(v) for v in c] for c in cs]      # noqa: E731
    rcfg = RefConfig(**kw)
    rsrs = RefSRS.unsafe_setup(7)
    rpk = ref_keygen(rsrs, rcfg, cols(fc.fixed), cols(fc.selectors), fc.copies,
                     RB.get_backend("cpu"))
    a = fc.assignment
    rasg = RefAssignment(rcfg, cols(a.advice), cols(a.lookup_advice), cols(a.fixed),
                         cols(a.selectors), a.instances, fc.copies)
    rproof = ref_prove(rpk, rsrs, rasg, RB.get_backend("cpu"), blinding_rng=_rng(9))

    srs = convert.srs(7, rsrs.g1_powers, rbn.g2_to_bytes(rsrs.g2_gen),
                      rbn.g2_to_bytes(rsrs.g2_tau))
    pk = convert.proving_key(rpk, "cpu")
    assert pk.vk.digest() == rpk.vk.digest()
    proof = prove(pk, srs, convert.assignment(rasg), device="cpu", blinding_rng=_rng(9))
    assert proof == rproof
    assert verify(pk.vk, srs, a.instances, proof)
    assert ref_verify(rpk.vk, rsrs, a.instances, proof)
    assert not verify(pk.vk, srs, a.instances, _tamper(proof, 64 * 9 + 5))


def test_convert_round_trips_reference_srs_and_key(tiny):
    rpk, rsrs, _, _, _ = tiny
    srs = convert.srs(rsrs.k, rsrs.g1_powers, rbn.g2_to_bytes(rsrs.g2_gen),
                      rbn.g2_to_bytes(rsrs.g2_tau))
    back = convert.srs_arrays(srs)
    assert np.array_equal(back["g1_powers"], rsrs.g1_powers)
    assert back["g2_gen"] == rbn.g2_to_bytes(rsrs.g2_gen)
    assert back["g2_tau"] == rbn.g2_to_bytes(rsrs.g2_tau)

    arrays = convert.proving_key_arrays(convert.proving_key(rpk, "cpu"))
    for name in ("selector_polys", "fixed_polys", "sigma_polys", "table_polys"):
        assert all(np.array_equal(a, b) for a, b in zip(arrays[name], getattr(rpk, name)))
    for name in ("selector_values", "fixed_values", "sigma_values", "table_values"):
        want = [[int(v) for v in col] for col in getattr(rpk, name)]
        assert arrays[name] == want
    for name in ("selector_commits", "fixed_commits", "sigma_commits", "table_commits"):
        want = [None if p is None else (int(p[0]), int(p[1]))
                for p in getattr(rpk.vk, name)]
        assert arrays[name] == want
    assert arrays["digest"] == rpk.vk.digest()


@pytest.mark.parametrize("table", ["range", "nibble_op"])
def test_permute_lookup_matches_reference(table):
    """The device lookup permutation (sort, first occurrences, leftovers in
    first-appearance order) equals the reference's host version."""
    from spectre_tpu.plonk.constraint_system import permute_lookup as ref_permute
    from spectre_tpu.plonk.constraint_system import table_column as ref_table
    from spectre_tpu_torch.ops import limbs as L
    from spectre_tpu_torch.plonk.constraint_system import (CircuitConfig,
                                                           column_std, permute_lookup)

    kw = dict(k=10, num_advice=1, num_lookup_advice=1, num_fixed=0,
              lookup_bits=6, lookup_tables=(table,))
    cfg, rcfg = CircuitConfig(**kw), RefConfig(**kw)
    tab = ref_table(rcfg, table)
    members = tab[:64] if table == "range" else tab[:512]
    rng = np.random.default_rng(11)
    a = [int(members[i]) for i in rng.integers(0, len(members), cfg.n)]
    want_a, want_t = ref_permute(rcfg, a, tab)
    to_t = lambda col: torch.from_numpy(column_std(col, cfg.n).view(np.int64))  # noqa: E731
    got_a, got_t = permute_lookup(cfg, to_t(a), to_t(tab))
    assert L.limbs_to_ints(got_a.numpy().view(np.uint64)) == want_a
    assert L.limbs_to_ints(got_t.numpy().view(np.uint64)) == want_t
    with pytest.raises(ValueError, match="not in table"):
        permute_lookup(cfg, to_t([10 ** 6] + a[1:]), to_t(tab))
