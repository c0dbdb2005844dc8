"""The port's Spectre contract against the JAX package's on the CPU, with
exact equality: the generated Spectre.sol text for every spec, its
bytecode, and the step, rotate, compressed and replay flows of
`tests/test_spectre_evm.py` run as transactions in each package's World
(success, revert reasons, gas and post-state equal), the statement-level
interpreter SolSpectre and the Python model SpectreContract on the same
flows, and the World's storage semantics.
"""

import types

import pytest

from spectre_tpu import spec as RSP
from spectre_tpu.contracts import sol_gen as RSG
from spectre_tpu.contracts import spectre as RCS
from spectre_tpu.evm import solc as RSOLC
from spectre_tpu.evm import solc_spectre as RSS
from spectre_tpu.evm import vm as RV
from spectre_tpu_torch import spec as SP
from spectre_tpu_torch.contracts import sol_gen as SG
from spectre_tpu_torch.contracts import spectre as CS
from spectre_tpu_torch.evm import solc as SOLC
from spectre_tpu_torch.evm import solc_spectre as SS
from spectre_tpu_torch.evm import vm as V
from spectre_tpu_torch.plonk.transcript import keccak256

PORT = types.SimpleNamespace(V=V, Asm=SOLC.Asm, init_code=SOLC._init_code, sol_gen=SG,
                             compile=SS.compile_spectre, cs=CS, spec=SP)
REF = types.SimpleNamespace(V=RV, Asm=RSOLC.Asm, init_code=RSOLC._init_code, sol_gen=RSG,
                            compile=RSS.compile_spectre, cs=RCS, spec=RSP.SPECS)
SPEC_NAMES = ("tiny", "minimal", "testnet", "mainnet")
STEP_SIG = "step((uint64,uint64,uint64,bytes32,bytes32),bytes)"
ROTATE_SIG = "rotate(uint256,uint256,uint256,uint256,bytes)"
STEP_C_SIG = "stepCompressed((uint64,uint64,uint64,bytes32,bytes32),uint256[12],bytes)"
ROTATE_C_SIG = "rotateCompressed(uint256,uint256,uint256,uint256,uint256[12],bytes)"


def _spec(pkg, name):
    return getattr(pkg.spec, name.upper()) if pkg is PORT else pkg.spec[name]


def _sel(sig: str) -> bytes:
    return keccak256(sig.encode())[:4]


def _pad(proof: bytes) -> bytes:
    return len(proof).to_bytes(32, "big") + proof + b"\x00" * (-len(proof) % 32)


def _words(*vals) -> bytes:
    return b"".join(int(v).to_bytes(32, "big") for v in vals)


def _contract(pkg, build) -> bytes:
    """Init code that deploys the runtime `build` assembles."""
    a = pkg.Asm()
    build(a)
    return pkg.init_code(a.assemble())


def _mock_verifier(pkg, result: bool) -> bytes:
    def prog(a):
        a.push(1 if result else 0)
        a.push(0)
        a.op("MSTORE")
        a.push(32)
        a.push(0)
        a.op("RETURN")
    return _contract(pkg, prog)


def _step_input(pkg, spec, **kw):
    d = dict(attested_slot=2 * spec.slots_per_period + 5,
             finalized_slot=2 * spec.slots_per_period + 1, participation=2,
             finalized_header_root=b"\xAA" * 32, execution_payload_root=b"\xBB" * 32)
    d.update(kw)
    return pkg.cs.StepInput(**d)


def _input_words(inp) -> bytes:
    return (_words(inp.attested_slot, inp.finalized_slot, inp.participation)
            + inp.finalized_header_root + inp.execution_payload_root)


def _step_calldata(inp, proof: bytes) -> bytes:
    return _sel(STEP_SIG) + _input_words(inp) + _words(192) + _pad(proof)


def _rotate_calldata(slot, poseidon, lo, hi, proof: bytes) -> bytes:
    return _sel(ROTATE_SIG) + _words(slot, poseidon, lo, hi, 160) + _pad(proof)


def _step_c_calldata(inp, acc, proof: bytes) -> bytes:
    return _sel(STEP_C_SIG) + _input_words(inp) + _words(*acc) + _words(32 * 18) + _pad(proof)


def _rotate_c_calldata(slot, poseidon, lo, hi, acc, proof: bytes) -> bytes:
    return (_sel(ROTATE_C_SIG) + _words(slot, poseidon, lo, hi) + _words(*acc)
            + _words(32 * 17) + _pad(proof))


class _Deployment:
    def __init__(self, pkg, spec_name="tiny", period=2, poseidon=0x1234, step_ok=True,
                 rotate_ok=True):
        self.pkg, self.V = pkg, pkg.V
        self.spec = _spec(pkg, spec_name)
        self.world = pkg.V.World()
        step_v, _ = self.world.deploy(_mock_verifier(pkg, step_ok))
        rot_v, _ = self.world.deploy(_mock_verifier(pkg, rotate_ok))
        self.runtime, init, self.meta = pkg.compile(pkg.sol_gen.gen_spectre_sol(self.spec))
        self.addr, self.deploy_gas = self.world.deploy(init, _words(period, poseidon, step_v,
                                                                    rot_v))

    def view(self, sig: str, *words) -> int:
        ok, out, _ = self.world.call_view(self.addr, _sel(sig) + _words(*words))
        assert ok, f"{sig} reverted: {self.V.revert_reason(out)}"
        return int.from_bytes(out, "big")

    def transact(self, calldata: bytes):
        ok, out, gas = self.world.transact(self.addr, calldata)
        return ok, self.V.revert_reason(out) if not ok else out.hex(), gas


def _roots(inp):
    root = inp.finalized_header_root
    return int.from_bytes(root[16:], "big"), int.from_bytes(root[:16], "big")


def _state(d, inp) -> tuple:
    nxt = d.spec.sync_period(inp.finalized_slot) + 1
    return (d.view("head()"), d.view("blockHeaderRoots(uint256)", inp.finalized_slot),
            d.view("executionPayloadRoots(uint256)", inp.finalized_slot),
            d.view("syncCommitteePoseidons(uint256)", nxt))


# each flow drives one deployment and returns its trace: every
# transaction's (success, revert reason or output, gas) and the state after
def _flow_step_then_older(pkg):
    d = _Deployment(pkg)
    inp = _step_input(pkg, d.spec)
    trace = [d.transact(_step_calldata(inp, b"\x11" * 64)), _state(d, inp)]
    older = _step_input(pkg, d.spec, attested_slot=inp.attested_slot + 1,
                        finalized_slot=inp.finalized_slot - 1)
    trace += [d.transact(_step_calldata(older, b"")), _state(d, inp)]
    trace.append(d.transact(_step_calldata(inp, b"")))   # a rewrite: cheaper storage
    return trace


def _flow_step_rejections(pkg):
    trace = []
    d = _Deployment(pkg)
    trace.append(d.transact(_step_calldata(_step_input(pkg, d.spec, participation=1), b"")))
    cd = bytearray(_step_calldata(_step_input(pkg, d.spec), b""))
    cd[4:36] = (1 << 64).to_bytes(32, "big")
    trace.append(d.transact(bytes(cd)))
    trace.append(_Deployment(pkg, period=0).transact(
        _step_calldata(_step_input(pkg, d.spec), b"")))
    trace.append(_Deployment(pkg, step_ok=False).transact(
        _step_calldata(_step_input(pkg, d.spec), b"")))
    trace.append(d.transact(b"\x00\x01\x02"))
    return trace


def _flow_rotate_and_replay(pkg):
    d = _Deployment(pkg)
    inp = _step_input(pkg, d.spec)
    lo, hi = _roots(inp)
    trace = [d.transact(_step_calldata(inp, b""))]
    trace.append(d.transact(_rotate_calldata(inp.finalized_slot, 0x999, lo + 1, hi, b"")))
    trace.append(d.transact(_rotate_calldata(inp.finalized_slot + 1, 0x999, lo, hi, b"")))
    trace.append(d.transact(_rotate_calldata(inp.finalized_slot, 0x777, lo, hi, b"")))
    trace.append(_state(d, inp))
    trace.append(d.transact(_rotate_calldata(inp.finalized_slot, 0x888, lo, hi, b"")))
    trace.append(_state(d, inp))
    return trace


def _flow_rotate_verifier_refuses(pkg):
    d = _Deployment(pkg, rotate_ok=False)
    inp = _step_input(pkg, d.spec)
    lo, hi = _roots(inp)
    trace = [d.transact(_step_calldata(inp, b""))]
    trace.append(d.transact(_rotate_calldata(inp.finalized_slot, 0x777, lo, hi, b"\x01")))
    trace.append(d.transact(_rotate_c_calldata(inp.finalized_slot, 0x777, lo, hi,
                                               list(range(12)), b"\x01" * 40)))
    trace.append(_state(d, inp))
    return trace


def _flow_compressed(pkg):
    """stepCompressed then rotateCompressed, at the testnet spec."""
    d = _Deployment(pkg, spec_name="testnet")
    inp = _step_input(pkg, d.spec, participation=400)
    lo, hi = _roots(inp)
    acc = [(1 << 88) - 1 - i for i in range(12)]
    trace = [d.transact(_step_c_calldata(inp, acc, b"\x42" * 7200)), _state(d, inp)]
    trace.append(d.transact(_rotate_c_calldata(inp.finalized_slot, 0x5151, lo, hi, acc,
                                               b"\x42" * 7200)))
    trace.append(_state(d, inp))
    trace.append(d.transact(_rotate_c_calldata(inp.finalized_slot, 0x5152, lo, hi, acc, b"")))
    trace.append(d.view("toPublicInputsCommitment((uint64,uint64,uint64,bytes32,bytes32))",
                        inp.attested_slot, inp.finalized_slot, inp.participation,
                        int.from_bytes(inp.finalized_header_root, "big"),
                        int.from_bytes(inp.execution_payload_root, "big")))
    assert trace[-1] == inp.to_public_inputs_commitment()
    trace += [d.view("SLOTS_PER_PERIOD()"), d.view("SYNC_COMMITTEE_SIZE()"), d.deploy_gas]
    return trace


FLOWS = {f.__name__[len("_flow_"):]: f for f in (
    _flow_step_then_older, _flow_step_rejections, _flow_rotate_and_replay,
    _flow_rotate_verifier_refuses, _flow_compressed)}
EXPECTED_REVERTS = {
    "step_rejections": ["insufficient participation", "abi: uint64", "no committee for period",
                        "step proof invalid"],
    "rotate_and_replay": ["header root mismatch", "unknown finalized header",
                          "period already rotated"],
    "rotate_verifier_refuses": ["rotate proof invalid", "rotate proof invalid"],
}


@pytest.mark.parametrize("spec_name", SPEC_NAMES)
def test_spectre_sol_equals_reference(spec_name):
    src = SG.gen_spectre_sol(_spec(PORT, spec_name))
    assert src == RSG.gen_spectre_sol(_spec(REF, spec_name))
    assert "function rotateCompressed(" in src and "function stepCompressed(" in src


@pytest.mark.parametrize("spec_name", ("tiny", "testnet"))
def test_spectre_bytecode_equals_reference(spec_name):
    got = SS.compile_spectre(SG.gen_spectre_sol(_spec(PORT, spec_name)))
    assert got == RSS.compile_spectre(RSG.gen_spectre_sol(_spec(REF, spec_name)))
    assert got[2]["runtime_bytes"] <= 24576


@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_contract_flow_equals_reference(flow):
    got = FLOWS[flow](PORT)
    assert got == FLOWS[flow](REF)
    reverts = [t[1] for t in got if isinstance(t, tuple) and len(t) == 3 and t[0] is False]
    if flow in EXPECTED_REVERTS:
        assert reverts[:len(EXPECTED_REVERTS[flow])] == EXPECTED_REVERTS[flow]
    if flow == "compressed":
        assert got[0][0] and got[2][0] and got[3][3] == 0x5151
        assert got[4][:2] == (False, "period already rotated")


class _Verdict:
    def __init__(self, ok):
        self.ok = ok

    def verify(self, instances, proof):
        return self.ok


def _interpreted(pkg):
    """The statement-level interpreter and the Python model on one flow."""
    spec = _spec(pkg, "tiny")
    out = []
    for verdict in (True, False):
        sol = pkg.sol_gen.SolSpectre(spec, 2, 0x1234, _Verdict(verdict), _Verdict(True))
        model = pkg.cs.SpectreContract(spec=spec, initial_sync_period=2,
                                       initial_committee_poseidon=0x1234,
                                       step_verifier=_Verdict(verdict))
        inp = _step_input(pkg, spec)
        for runner in (lambda: sol.step(inp, b""), lambda: model.step(inp, b"")):
            try:
                runner()
                out.append("ok")
            except AssertionError as e:   # SolRevert is an AssertionError
                out.append(str(e))
        out += [sol.storage["head"], model.head]
        lo, hi = _roots(inp)
        for runner in (lambda: sol.rotate(inp.finalized_slot, 0x777, lo, hi, b""),
                       lambda: model.rotate(inp.finalized_slot, 0x777, lo, hi, b"")):
            try:
                runner()
                out.append("ok")
            except AssertionError as e:
                out.append(str(e))
        out.append(model.sync_committee_poseidons.get(spec.sync_period(inp.finalized_slot) + 1))
    return out


def test_interpreter_and_model_equal_reference():
    got = _interpreted(PORT)
    assert got == _interpreted(REF)
    assert got[:6] == ["ok", "ok", _step_input(PORT, SP.TINY).finalized_slot,
                       _step_input(PORT, SP.TINY).finalized_slot, "ok", "ok"]


def _world_storage(pkg):
    """A reverting frame leaves no storage, a dirty slot costs the warm
    price, clearing a slot refunds."""
    out = []

    def revert(a):
        a.push(0xDEAD)
        a.push(7)
        a.op("SSTORE")
        a.push(0)
        a.push(0)
        a.op("REVERT")

    def rewrite(a):
        for val in (5, 7):
            a.push(val)
            a.push(3)
            a.op("SSTORE")
        a.op("STOP")

    def clear(a):
        a.push(0)
        a.push(11)
        a.op("SSTORE")
        a.op("STOP")

    for prog, preset in ((revert, {}), (rewrite, {}), (clear, {11: 5})):
        w = pkg.V.World()
        addr, gas = w.deploy(_contract(pkg, prog))
        w.contracts[addr].storage.update(preset)
        out.append((gas,) + tuple(w.transact(addr, b"")) + (dict(w.contracts[addr].storage),))
    return out


def test_world_storage_semantics_equal_reference():
    got = _world_storage(PORT)
    assert got == _world_storage(REF)
    assert got[0][1] is False and got[0][4] == {}
    assert got[1][4] == {3: 7} and 22000 < got[1][3] - 21000 < 22400
    assert got[2][4] == {} and got[2][3] - 21000 < 5000 - 800
