"""The port's EVM tail against the JAX package's on the CPU, with exact
equality: the calldata encoders, the generated Solidity verifier (the K=7
circuit of `tests/test_evm.py` and its 12-limb accumulator circuit, keyed
by the port), its bytecode, the simulator's and the metered VM's verdicts,
revert reasons and gas, the VM's opcodes and precompiles one by one, and
the tracked committee and step verifiers of build/.

The port's generated source differs from the reference's in one line only,
its second, which names the generator; comments do not reach the bytecode,
so the compiled bytes are equal outright.
"""

import json
import os
import random

import numpy as np
import pytest
import torch

from spectre_tpu.builder import Context as RefContext
from spectre_tpu.evm import codegen as RC
from spectre_tpu.evm import gas as RG
from spectre_tpu.evm import simulator as RS
from spectre_tpu.evm import solc as RSOLC
from spectre_tpu.evm import vm as RV
from spectre_tpu.fields import bn254 as rbn
from spectre_tpu.models.aggregation import Accumulator as RefAccumulator
from spectre_tpu.native import host
from spectre_tpu.plonk import backend as RB
from spectre_tpu.plonk.constraint_system import Assignment as RefAssignment
from spectre_tpu.plonk.constraint_system import CircuitConfig as RefConfig
from spectre_tpu.plonk.keygen import keygen as ref_keygen
from spectre_tpu.plonk.prover import prove as ref_prove
from spectre_tpu.plonk.srs import SRS as RefSRS
from spectre_tpu.plonk.transcript import KeccakTranscript as RefKeccak
from spectre_tpu.plonk.verifier import verify as ref_verify
from spectre_tpu.prover_service import calldata as RCD
from spectre_tpu_torch import convert
from spectre_tpu_torch.builder import Context
from spectre_tpu_torch.evm import codegen as C
from spectre_tpu_torch.evm import gas as G
from spectre_tpu_torch.evm import simulator as S
from spectre_tpu_torch.evm import solc as SOLC
from spectre_tpu_torch.evm import vm as V
from spectre_tpu_torch.fields import bn254
from spectre_tpu_torch.models.aggregation import Accumulator
from spectre_tpu_torch.plonk.keygen import keygen
from spectre_tpu_torch.plonk.srs import SRS
from spectre_tpu_torch.prover_service import calldata as CD

K = 7
BUILD = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build")
GENERATOR_LINE = "// Auto-generated by spectre_tpu_torch.evm.codegen — DO NOT EDIT."
TRACKED = {
    "committee": ("aggregation_committee_testnet_22_verifier.sol",
                  "agg_committee_testnet_22_keccak.proof"),
    "step": ("aggregation_sync_step_testnet_21_verifier.sol",
             "agg_step_testnet_21_keccak.proof"),
}


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


def _equal_but_generator_line(port_src: str, ref_src: str) -> None:
    got, want = port_src.split("\n"), ref_src.split("\n")
    assert len(got) == len(want)
    assert got[1] == GENERATOR_LINE
    assert want[1] == "// Auto-generated by spectre_tpu.evm.codegen — DO NOT EDIT."
    diff = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    assert diff == [1], diff[:3]


# ---------------------------------------------------------------------------
# the K=7 circuit and the accumulator circuit, keyed by both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def srs_pair():
    """The K=7 SRS of each package (the same tau)."""
    return RefSRS.unsafe_setup(K), SRS.unsafe_setup(K, device="cpu")


@pytest.fixture(scope="module")
def tiny(srs_pair):
    """The K=7 circuit of tests/test_evm.py: the reference's key and seeded
    Keccak proof, the port's key from the same assignment, and the verifier
    each package generates."""
    from test_plonk import _tiny_circuit
    rsrs, srs = srs_pair
    cfg = RefConfig(k=K, num_advice=1, num_lookup_advice=1, num_fixed=1, lookup_bits=4)
    advice, lookup, fixed, selectors, copies, out = _tiny_circuit(cfg)
    rpk = ref_keygen(rsrs, cfg, fixed, selectors, copies)
    rasg = RefAssignment(cfg, advice, lookup, fixed, selectors, [[out]], copies)
    proof = ref_prove(rpk, rsrs, rasg, RB.get_backend("cpu"), transcript=RefKeccak(),
                      blinding_rng=_rng(0xE7))
    asg = convert.assignment(rasg)
    pk = keygen(srs, asg.config, asg.fixed, asg.selectors, asg.copies, device="cpu")
    assert pk.vk.digest() == rpk.vk.digest()
    return dict(instances=[out], proof=proof,
                src=C.gen_evm_verifier(pk.vk, srs, num_instances=1),
                ref_src=RC.gen_evm_verifier(rpk.vk, rsrs, num_instances=1))


def _acc_limbs(rsrs, s: int, valid: bool) -> list:
    """tests/test_evm.py's accumulator: [s]G against [s]tau G (valid) or
    [s+1]G (invalid); its 12 limbs, the same from both packages."""
    g1 = rbn.g1_curve
    lhs = g1.mul(rbn.G1_GEN, s)
    if valid:
        tau_g = host.limbs_to_ints(rsrs.g1_powers[1:2].reshape(2, 4))
        rhs = g1.mul((rbn.Fq(tau_g[0]), rbn.Fq(tau_g[1])), s)
    else:
        rhs = g1.mul(rbn.G1_GEN, s + 1)
    racc = RefAccumulator(lhs=lhs, rhs=rhs)
    assert racc.check(rsrs) is valid
    acc = Accumulator(lhs=(bn254.Fq(int(lhs[0])), bn254.Fq(int(lhs[1]))),
                      rhs=(bn254.Fq(int(rhs[0])), bn254.Fq(int(rhs[1]))))
    assert acc.limbs() == racc.limbs()
    return acc.limbs()


@pytest.fixture(scope="module")
def acc(srs_pair):
    """tests/test_evm.py's 12-limb accumulator circuit, valid and invalid:
    the reference's key and proof, the port's key from the port's builder
    (one key: both variants lay out the same fixed columns, selectors and
    copies, which the fixture checks), and each package's verifier with
    num_acc_limbs=12."""
    rsrs, srs = srs_pair
    out, port_key = {}, None
    for name, valid in (("valid", True), ("invalid", False)):
        limbs = _acc_limbs(rsrs, 12345, valid)
        rctx = RefContext()
        for v in limbs:
            rctx.expose_public(rctx.load_witness(v))
        rcfg = rctx.auto_config(k=K, lookup_bits=4)
        advice, lookup, fixed, selectors, copies, instances, _ = rctx.layout(rcfg)
        rpk = ref_keygen(rsrs, rcfg, fixed, selectors, copies)
        rasg = RefAssignment(rcfg, advice, lookup, fixed, selectors, instances, copies)
        proof = ref_prove(rpk, rsrs, rasg, RB.get_backend("cpu"), transcript=RefKeccak(),
                          blinding_rng=_rng(0xACC))
        assert ref_verify(rpk.vk, rsrs, instances, proof, transcript_cls=RefKeccak)

        ctx = Context()
        for v in limbs:
            ctx.expose_public(ctx.load_witness(v))
        cfg = ctx.auto_config(k=K, lookup_bits=4)
        assert cfg == convert.circuit_config(rcfg)
        _, _, pfixed, psel, pcopies, pinst, _ = ctx.layout(cfg)
        assert [list(map(int, col)) for col in pinst] == [list(map(int, c)) for c in instances]
        if port_key is None:
            port_key = (pfixed, psel, pcopies,
                        keygen(srs, cfg, pfixed, psel, pcopies, device="cpu"))
        else:
            for a, b in zip(port_key[:3], (pfixed, psel, pcopies)):
                assert np.array_equal(np.asarray(a), np.asarray(b))
        pk = port_key[3]
        assert pk.vk.digest() == rpk.vk.digest()
        out[name] = dict(
            instances=[int(v) for v in instances[0]], proof=proof,
            src=C.gen_evm_verifier(pk.vk, srs, num_instances=12, num_acc_limbs=12),
            ref_src=RC.gen_evm_verifier(rpk.vk, rsrs, num_instances=12, num_acc_limbs=12))
    return out


def _verifier(tiny, acc, name):
    return tiny if name == "tiny" else acc[name.split("_")[1]]


# ---------------------------------------------------------------------------
# calldata
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_instances,proof_len", [(15, 7200), (14, 6400), (1, 100), (0, 0)])
def test_calldata_encoders_equal_reference(num_instances, proof_len):
    rng = np.random.default_rng(1000 * num_instances + proof_len)
    instances = [int.from_bytes(rng.bytes(32), "big") % bn254.R for _ in range(num_instances)]
    if num_instances:
        instances[0] = bn254.R - 1
    proof = rng.bytes(proof_len)
    blob = CD.encode_calldata(instances, proof)
    assert blob == RCD.encode_calldata(instances, proof)
    assert CD.decode_calldata(blob, num_instances) == (instances, proof)
    assert CD.decode_calldata(blob, num_instances) == RCD.decode_calldata(blob, num_instances)
    abi = C.encode_calldata(instances, proof)
    assert abi == RC.encode_calldata(instances, proof)
    assert len(abi) == 4 + 32 * (4 + num_instances) + -(-proof_len // 32) * 32
    if (num_instances, proof_len) == (15, 7200):
        assert len(abi) == 7812


def test_abi_calldata_reduces_instances_like_reference():
    """The ABI encoder writes each instance mod R, as the reference's does."""
    instances = [bn254.R + 5, 2 ** 256 - 1, 0]
    assert C.encode_calldata(instances, b"\x01") == RC.encode_calldata(instances, b"\x01")


# ---------------------------------------------------------------------------
# the generated verifier and its bytecode
# ---------------------------------------------------------------------------

VERIFIERS = ("tiny", "acc_valid", "acc_invalid")


@pytest.mark.parametrize("name", VERIFIERS)
def test_generated_verifier_equals_reference_but_the_generator_line(tiny, acc, name):
    v = _verifier(tiny, acc, name)
    _equal_but_generator_line(v["src"], v["ref_src"])


@pytest.mark.parametrize("name", VERIFIERS)
def test_compiled_verifier_equals_reference(tiny, acc, name):
    v = _verifier(tiny, acc, name)
    assert SOLC.compile_verifier(v["src"]) == RSOLC.compile_verifier(v["ref_src"])


def test_gas_and_size_estimates_equal_reference(tiny):
    cd = C.encode_calldata(tiny["instances"], tiny["proof"])
    assert G.estimate_gas(tiny["src"], calldata=cd) == RG.estimate_gas(tiny["ref_src"],
                                                                       calldata=cd)
    assert G.estimate_deployed_size(tiny["src"]) == RG.estimate_deployed_size(tiny["ref_src"])
    assert G.analyze_verifier(tiny["src"]) == RG.analyze_verifier(tiny["ref_src"])


# the real proof and tests/test_evm.py's forgeries
CASES = {
    "real": lambda inst, pf: (inst, pf),
    "tampered_commitment": lambda inst, pf: (inst, _tamper(pf, 100)),
    "tampered_tail": lambda inst, pf: (inst, _tamper(pf, len(pf) - 100)),
    "wrong_instance": lambda inst, pf: ([inst[0] + 1], pf),
    "wrong_length": lambda inst, pf: (inst, pf + b"\x00" * 32),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_simulator_verdict_equals_reference(tiny, case):
    inst, pf = CASES[case](tiny["instances"], tiny["proof"])
    got = S.run_verifier(tiny["src"], inst, pf)
    assert got == RS.run_verifier(tiny["ref_src"], inst, pf)
    assert got is (case == "real")


@pytest.mark.parametrize("case", sorted(CASES))
def test_vm_verdict_revert_and_gas_equal_reference(tiny, case):
    inst, pf = CASES[case](tiny["instances"], tiny["proof"])
    got = SOLC.vm_verify(tiny["src"], inst, pf)
    assert got == RSOLC.vm_verify(tiny["ref_src"], inst, pf)
    assert got["ok"] is (case == "real")
    if case == "wrong_length":
        assert got["revert"] == "proof length"


def test_invalid_accumulator_returns_false_in_the_vm(acc):
    """The outer proof is valid; only the deferred accumulator pairing
    fails, which returns false rather than reverting."""
    v = acc["invalid"]
    got = SOLC.vm_verify(v["src"], v["instances"], v["proof"])
    assert got["ok"] is False and not got["reverted"]
    assert got["gas_execution"] > 45000 + 34000 * 2


# ---------------------------------------------------------------------------
# the VM, opcode by opcode and precompile by precompile
# ---------------------------------------------------------------------------

def _ret_word(a):
    a.push(0)
    a.op("MSTORE")
    a.push(32)
    a.push(0)
    a.op("RETURN")


def _prog_arith(a):
    a.push(20)
    a.push(22)
    a.op("ADD")
    a.push(7)
    a.op("MUL")
    a.push(3)
    a.op("SWAP1", "SUB")
    a.push(5)
    a.op("SWAP1", "DIV")
    _ret_word(a)


def _prog_mulmod(a):
    a.push(bn254.R)
    a.push(bn254.R - 5)
    a.push(bn254.R - 3)
    a.op("MULMOD")
    a.push(bn254.R)
    a.op("SWAP1")
    a.push(bn254.R - 1)
    a.op("ADDMOD")
    _ret_word(a)


def _prog_keccak(a):
    a.push(int.from_bytes(b"spectre" + b"\x00" * 25, "big"))
    a.push(0)
    a.op("MSTORE")
    a.push(7)
    a.push(0)
    a.op("SHA3")
    _ret_word(a)


def _prog_jumps(a):
    a.push(0)
    a.op("CALLDATALOAD", "DUP1", "ISZERO")
    a.pushl("fail")
    a.op("JUMPI", "DUP1", "ADD")
    _ret_word(a)
    a.label("fail")
    a.push(0)
    a.push(0)
    a.op("REVERT")


def _prog_bad_jump(a):
    a.push(3)
    a.op("JUMP")


def _precompile_prog(addr, data, ret_size):
    def prog(a):
        for i in range(0, len(data), 32):
            a.push(int.from_bytes(data[i:i + 32].ljust(32, b"\x00"), "big"))
            a.push(i)
            a.op("MSTORE")
        a.push(ret_size)
        a.push(0)
        a.push(len(data))
        a.push(0)
        a.push(addr)
        a.op("GAS", "STATICCALL")
        a.push(ret_size)
        a.op("MSTORE8")
        a.push(ret_size + 1)
        a.push(0)
        a.op("RETURN")
    return prog


def _words(*vals) -> bytes:
    return b"".join(int(v).to_bytes(32, "big") for v in vals)


def _g2_words(g1pt, g2pt) -> bytes:
    return _words(g1pt[0], g1pt[1], g2pt[0].c[1], g2pt[0].c[0], g2pt[1].c[1], g2pt[1].c[0])


def _vm_cases():
    g = bn254.g1_curve
    p = bn254.G1_GEN
    q2 = g.mul(p, 2)
    g2 = bn254.G2_GEN
    negp = (p[0], -p[1])
    q = g.mul(p, 5)
    R = bn254.R
    return {
        "arith": (_prog_arith, b""),
        "mulmod": (_prog_mulmod, b""),
        "keccak": (_prog_keccak, b""),
        "jumps_taken": (_prog_jumps, (21).to_bytes(32, "big")),
        "jumps_revert": (_prog_jumps, b""),
        "invalid_jump": (_prog_bad_jump, b""),
        "sha256": (_precompile_prog(2, b"spectre-evm" * 5, 32), b""),
        "ecadd": (_precompile_prog(6, _words(p[0], p[1], q[0], q[1]), 64), b""),
        "ecmul": (_precompile_prog(7, _words(p[0], p[1], 7), 64), b""),
        "ecmul_infinity": (_precompile_prog(7, _words(p[0], p[1], R), 64), b""),
        "ecmul_off_curve": (_precompile_prog(7, _words(1, 1, 7), 64), b""),
        "pairing_balanced": (_precompile_prog(8, _g2_words(p, g2) + _g2_words(negp, g2), 32),
                             b""),
        "pairing_unbalanced": (_precompile_prog(8, _g2_words(q2, g2), 32), b""),
        "modexp": (_precompile_prog(5, _words(32, 32, 32, 1234567, R - 2, R), 32), b""),
    }


VM_CASES = sorted(_vm_cases())


@pytest.mark.parametrize("case", VM_CASES)
def test_vm_execute_equals_reference(case):
    """The same program assembled by each package's Asm, run by each
    package's execute: equal bytecode, success, output and gas."""
    from spectre_tpu.evm.solc import Asm as RefAsm
    prog, calldata = _vm_cases()[case]
    a, ra = SOLC.Asm(), RefAsm()
    prog(a)
    prog(ra)
    code = a.assemble()
    assert code == ra.assemble()
    gas = 5000 if case == "invalid_jump" else 10_000_000
    got = V.execute(code, calldata, gas)
    assert got == RV.execute(code, calldata, gas)
    ok, out, used = got
    if case == "keccak":
        assert out == V.keccak256(b"spectre")
    elif case == "mulmod":
        assert int.from_bytes(out, "big") == ((bn254.R - 5) * (bn254.R - 3) + bn254.R - 1) % bn254.R
    elif case == "invalid_jump":
        assert not ok and used == 5000
    elif case.startswith("pairing"):
        assert ok and out[32] == 1 and int.from_bytes(out[:32], "big") == (case == "pairing_balanced")
    elif case == "ecmul_off_curve":
        assert ok and out[64] == 0


@pytest.mark.parametrize("data", [b"", b"\x00\x01", b"\x00" * 64 + b"\xff" * 33])
def test_intrinsic_gas_equals_reference(data):
    assert V.tx_intrinsic_gas(data) == RV.tx_intrinsic_gas(data)
    assert V.tx_intrinsic_gas(data) == 21000 + 4 * data.count(0) + 16 * (len(data) - data.count(0))


@pytest.mark.parametrize("size", [100, 24576, 24577])
def test_deploy_enforces_eip170_like_reference(size):
    init = SOLC._init_code(b"\x00" * size)
    assert init == RSOLC._init_code(b"\x00" * size)
    if size > 24576:
        with pytest.raises(Exception):
            V.deploy(init)
        with pytest.raises(Exception):
            RV.deploy(init)
    else:
        assert V.deploy(init) == RV.deploy(init)
        assert V.deploy(init)[0] == b"\x00" * size


def test_revert_reason_decoder_equals_reference():
    payload = (bytes.fromhex("08c379a0") + (32).to_bytes(32, "big") + (5).to_bytes(32, "big")
               + b"hello".ljust(32, b"\x00"))
    for blob in (payload, b"", b"\x00" * 4):
        assert V.revert_reason(blob) == RV.revert_reason(blob)
    assert V.revert_reason(payload) == "hello"


# ---------------------------------------------------------------------------
# the tracked verifiers and proofs of build/
# ---------------------------------------------------------------------------

def _tracked(name):
    sol, proof = TRACKED[name]
    with open(os.path.join(BUILD, sol)) as f:
        src = f.read()
    with open(os.path.join(BUILD, proof), "rb") as f:
        pf = f.read()
    with open(os.path.join(BUILD, proof + ".instances.json")) as f:
        inst = [int(v, 16) for v in json.load(f)["instances"]]
    return src, inst, pf


@pytest.mark.parametrize("name", sorted(TRACKED))
def test_tracked_verifier_bytecode_equals_reference(name):
    src, _, _ = _tracked(name)
    got = SOLC.compile_verifier(src)
    assert got == RSOLC.compile_verifier(src)
    if name == "committee":
        assert got[2]["runtime_bytes"] == 56636


@pytest.mark.parametrize("name", sorted(TRACKED))
def test_tracked_gas_and_size_estimates_equal_reference(name):
    src, inst, pf = _tracked(name)
    cd = C.encode_calldata(inst, pf)
    assert cd == RC.encode_calldata(inst, pf)
    assert G.estimate_gas(src, calldata=cd) == RG.estimate_gas(src, calldata=cd)
    assert G.estimate_deployed_size(src) == RG.estimate_deployed_size(src)


def test_tracked_committee_proof_in_the_port_vm():
    """The port's VM on the tracked compressed committee proof gives the
    evm_real that build/compressed_committee_testnet_18.json records, and
    rejects the proof with byte 41 flipped."""
    src, inst, pf = _tracked("committee")
    assert len(inst) == 15 and len(C.encode_calldata(inst, pf)) == 7812
    with open(os.path.join(BUILD, "compressed_committee_testnet_18.json")) as f:
        rec = json.load(f)["evm_real"]
    got = SOLC.vm_verify(src, inst, pf, tamper_byte=41)
    assert got["ok"] and not got["reverted"] and got["tamper_rejected"]
    assert (got["gas_execution"], got["gas_total"], got["runtime_bytes"], got["eip170_ok"]) == \
        (rec["gas_execution"], rec["gas_total"], rec["deployed_bytes"], rec["eip170_ok"])
