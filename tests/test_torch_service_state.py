"""The port's ProverState (`spectre_tpu_torch/prover_service/state.py`) on the
CPU, with stub circuits where the testnet ones would take minutes, and the
two repairs that came with it: the step's outer-k rule in
`models/aggregation.py` and `AppCircuit.create_pk`'s disk cache.

The rules the port keeps where the reference moves to its CPU backend:
a device failure fails the job with -32005 and nothing proves again; a
proof that fails verification is proved once more on the state's own
device, then quarantined and refused. The compressed mode proves the app
snark under Poseidon and the outer proof under Keccak, and serves the
aggregation statement.
"""

import os
import random
import types

import pytest
import torch

from spectre_tpu_torch import spec as SPEC
from spectre_tpu_torch.builder import Context, GateChip
from spectre_tpu_torch.fields import bn254
from spectre_tpu_torch.models import aggregation as AG
from spectre_tpu_torch.models.aggregation import Accumulator, AggregationCircuit
from spectre_tpu_torch.models.app_circuit import AppCircuit
from spectre_tpu_torch.plonk import transcript as T
from spectre_tpu_torch.plonk.srs import SRS
from spectre_tpu_torch.prover_service import rpc, rpc_client, selfverify
from spectre_tpu_torch.prover_service.state import ProverState
from spectre_tpu_torch.utils import faults
from spectre_tpu_torch.utils.health import HEALTH
from spectre_tpu_torch.witness import default_committee_update_args

from _torch_service_params import committee_params

TINY = SPEC.TINY


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads per test process: the tier-1 run has six workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _no_fault_plan():
    faults.clear()
    yield
    faults.clear()


@pytest.fixture(autouse=True)
def _self_verify_always(monkeypatch):
    """Pin the self-verify policy these tests assert on: another test in the
    same process (the reference's bench) may leave SPECTRE_SELF_VERIFY=off
    in os.environ, and selfverify.policy() reads it at every call."""
    monkeypatch.setenv("SPECTRE_SELF_VERIFY", "always")


def _stub(name):
    """A circuit class that records where it was asked to prove, proves
    nothing, and verifies as told."""

    class Stub:
        calls: list = []
        error = None
        verifies = True

        @classmethod
        def create_pk(cls, srs, spec, k, dummy_args, device=None, cache=False,
                      cache_dir=None):
            return types.SimpleNamespace(vk=types.SimpleNamespace(config=None))

        @classmethod
        def build_context(cls, args, spec, device=None):
            return types.SimpleNamespace(layout=lambda cfg: None)

        @classmethod
        def prove(cls, pk, srs, args, spec, device=None, ctx=None, timer=None,
                  transcript=None):
            cls.calls.append(str(device))
            if cls.error is not None:
                raise cls.error
            return b"\x05" * 32

        @classmethod
        def get_instances(cls, args, spec):
            return [1, 2, 3]

        @classmethod
        def verify(cls, vk, srs, instances, proof, device=None, transcript_cls=None):
            return cls.verifies

    Stub.name = name
    Stub.calls = []
    return Stub


@pytest.fixture
def served(tmp_path):
    """A ProverState over stub circuits, booted on the CPU (its k=6 SRS made
    there), then pointed at "cuda" as its device, served over HTTP; yields
    (state, client, the committee request's params)."""
    runs = []

    class StubState(ProverState):
        step_circuit = _stub("sync_step")
        committee_circuit = _stub("committee_update")

    check = selfverify.SelfCheck(runner=lambda: runs.append(1) or True)
    st = StubState(TINY, 6, 6, device="cpu", params_dir=str(tmp_path),
                   key_args={"step": None, "committee": None}, self_check=check)
    assert st.self_check.runs == 1 and set(st.boot_seconds) == {
        "srs", "step_pk", "committee_pk", "self_check"}
    # the proves are stubs: the device they are asked for is recorded, not used
    st.device = torch.device("cuda")
    srv = rpc.serve(st, port=0, background=True, scrub_interval=0)
    client = rpc_client.ProverClient(f"http://127.0.0.1:{srv.server_address[1]}/rpc",
                                     timeout=120)
    try:
        yield st, client, committee_params(default_committee_update_args(TINY))
    finally:
        srv.shutdown()
        st.jobs.stop()


def _committee(client, params):
    with pytest.raises(rpc_client.RpcError) as e:
        client.gen_evm_proof_committee_update_compressed(params["light_client_update"])
    return e.value


class TestNoCpuFallback:
    def test_fault_at_backend_prove_fails_the_job(self, served):
        st, client, params = served
        before = HEALTH.get("prove_device_failures_oom")
        faults.arm("backend.prove", "oom")
        err = _committee(client, params)
        assert err.code == rpc.JOB_FAILED
        assert err.message == ("job failed: device prove failed (oom): InjectedFault: "
                               "injected fault at backend.prove (oom)")
        assert st.committee_circuit.calls == []
        assert HEALTH.get("prove_device_failures_oom") == before + 1

    def test_device_oom_is_not_retried(self, served):
        st, client, params = served
        st.committee_circuit.error = RuntimeError("CUDA out of memory. Tried to allocate 2 GiB")
        err = _committee(client, params)
        assert err.code == rpc.JOB_FAILED and "device prove failed (oom)" in err.message
        assert st.committee_circuit.calls == ["cuda"]

    def test_failed_self_verification_reproves_on_the_same_device(self, served):
        st, client, params = served
        st.committee_circuit.verifies = False
        retried = HEALTH.get("proofs_sdc_retried")
        err = _committee(client, params)
        assert err.code == rpc.JOB_FAILED
        assert err.message.startswith("proof failed self-verification: committee proof failed "
                                      "self-verification after a re-prove on its device")
        assert st.committee_circuit.calls == ["cuda", "cuda"]
        assert HEALTH.get("proofs_sdc_retried") == retried + 1
        assert st.self_check.runs == 2             # re-probed after the re-prove
        assert os.listdir(st.jobs.store.quarantine_dir)

    def test_a_good_proof_is_served(self, served):
        st, client, params = served
        res = client.gen_evm_proof_committee_update_compressed(params["light_client_update"])
        assert res["instances"] == ["0x1", "0x2", "0x3"] and res["committee_poseidon"] == "0x1"
        assert st.committee_circuit.calls == ["cuda"]
        man = client.get_manifest(client.submit_committee_update(params["light_client_update"]))
        assert man["kernels"]["builds"] == 0
        assert {"job/preprocess", "prove/witness", "prove/layout", "prove/snark",
                "prove/self_verify"} <= set(man["phase_seconds"])


def _seeded(seed):
    r = random.Random(seed)
    return lambda: r.randrange(bn254.R)


class TinyApp:
    """The readiness circuit as an app circuit: its real proof on the CPU
    (seeded blinding), recording the transcript it was made under."""

    name = "tiny"
    transcripts: list = []

    @classmethod
    def build_context(cls, args, spec, device=None):
        _, _, asg, _ = selfverify._tiny_setup("cpu")
        return types.SimpleNamespace(layout=lambda cfg: None, assignment=lambda cfg: asg)

    @classmethod
    def prove(cls, pk, srs, args, spec, device=None, ctx=None, timer=None, transcript=None):
        from spectre_tpu_torch.plonk.prover import prove
        cls.transcripts.append(type(transcript))
        return prove(pk, srs, ctx.assignment(None), device="cpu", transcript=transcript,
                     blinding_rng=_seeded(7), timer=timer)

    @classmethod
    def get_instances(cls, args, spec):
        return [selfverify._tiny_setup("cpu")[3]]


class StubAgg(AggregationCircuit):
    """The aggregation circuit with its build and prove stubbed (a k=22
    outer prove is minutes); get_instances is the real one."""

    name = "aggregation_tiny"
    seen: list = []

    @classmethod
    def build_context(cls, args, spec, device=None):
        return types.SimpleNamespace(layout=lambda cfg: None)

    @classmethod
    def prove(cls, pk, srs, args, spec, device=None, ctx=None, timer=None, transcript=None):
        cls.seen.append(("prove", type(transcript), srs.k, args.proof))
        return b"outer"

    @classmethod
    def verify(cls, vk, srs, instances, proof, device=None, transcript_cls=None):
        cls.seen.append(("verify", transcript_cls, srs.k))
        return True


def test_compressed_mode_proves_poseidon_then_keccak():
    pk, srs, _, out = selfverify._tiny_setup("cpu")
    st = ProverState.__new__(ProverState)
    st.spec, st.device, st.compress = TINY, torch.device("cpu"), True
    st.srs = {6: srs, 7: types.SimpleNamespace(k=7)}
    st.k_agg = {"step": 7, "committee": 7}
    st.step_agg = StubAgg
    st.step_agg_pk = types.SimpleNamespace(vk=types.SimpleNamespace(config=None))
    TinyApp.transcripts, StubAgg.seen = [], []
    proof, inst = st._compressed(TinyApp, pk, 6, StubAgg, st.step_agg_pk, 7, None)
    assert proof == b"outer"
    assert TinyApp.transcripts == [T.PoseidonTranscript]
    (what, tr, k, inner), = StubAgg.seen
    assert (what, tr, k) == ("prove", T.KeccakTranscript, 7)
    assert len(inst) == AG.NUM_ACC_LIMBS + 1 and inst[-1] == out
    assert Accumulator.from_limbs(inst[:AG.NUM_ACC_LIMBS]).check(srs)
    assert AggregationCircuit.get_instances(
        AG.AggregationArgs(pk.vk, srs, [[out]], inner), TINY) == inst
    assert st.verify_proof("step", proof, inst)
    assert StubAgg.seen[-1] == ("verify", T.KeccakTranscript, 7)


def test_k_agg_per_variant():
    from spectre_tpu_torch.prover_service.state import _per_variant
    assert _per_variant(17) == {"step": 17, "committee": 17}
    assert _per_variant({"step": 21, "committee": 22}) == {"step": 21, "committee": 22}


def test_outer_k_sizes_the_step_aggregation_at_21():
    """The reference flow's rule on the testnet step's outer context counts
    (22,454,006 advice cells, 2,197,024 range lookups): k=21, 11 advice."""
    ctx = Context()
    ctx.adv_values = range(22454006)
    ctx.lkp_streams = {"range": range(2197024)}
    k = AG.outer_k(ctx, AggregationCircuit.default_lookup_bits)
    cfg = ctx.auto_config(k=k, lookup_bits=AggregationCircuit.default_lookup_bits)
    assert (k, cfg.num_advice, cfg.num_lookup_advice) == (21, 11, 2)
    ctx.adv_values = range(12 * (1 << 24))
    with pytest.raises(ValueError, match="no k in 20..24"):
        AG.outer_k(ctx, 14)


class Square(AppCircuit):
    """x -> x^2, one gate: a circuit small enough to key in seconds."""

    name = "square"
    default_lookup_bits = 4

    @classmethod
    def build(cls, ctx, args, spec):
        x = ctx.load_witness(args)
        ctx.expose_public(GateChip().mul(ctx, x, x))

    @classmethod
    def get_instances(cls, args, spec):
        return [args * args % bn254.R]


def test_create_pk_cache_loads_an_equal_key_without_keygen(tmp_path, monkeypatch):
    from spectre_tpu_torch.models import app_circuit
    srs = SRS.unsafe_setup(6, device="cpu")
    pk = Square.create_pk(srs, TINY, 6, 3, device="cpu", cache=True, cache_dir=str(tmp_path))
    assert os.path.exists(Square.pk_path(TINY, 6, str(tmp_path)))

    def no_keygen(*a, **kw):
        raise AssertionError("keygen ran")

    monkeypatch.setattr(app_circuit, "keygen", no_keygen)
    again = Square.create_pk(srs, TINY, 6, 3, device="cpu", cache=True, cache_dir=str(tmp_path))
    assert again.vk.digest() == pk.vk.digest()
    assert torch.equal(again.sigma_polys[0], pk.sigma_polys[0])
    # a key written under another SRS is not served
    other = SRS.unsafe_setup(6, seed=b"another", device="cpu")
    with pytest.raises(AssertionError, match="keygen ran"):
        Square.create_pk(other, TINY, 6, 3, device="cpu", cache=True, cache_dir=str(tmp_path))


@pytest.mark.parametrize("method,verifies,want", [
    ("genEvmProof_SyncStepCompressed", True, True),
    ("genEvmProof_CommitteeUpdateCompressed", False, False),
    ("genEvmProof_AggregationCadence", False, False),
])
def test_cross_verify_checks_another_hosts_proof(method, verifies, want):
    """A proof made elsewhere, verified on this host's keys under the kind
    its method names (the aggregation cadence's tip is a committee proof)."""
    seen = []

    class Verifier:
        def verify_proof(self, kind, proof, instances):
            seen.append((kind, proof, instances))
            return verifies

    result = {"proof": "0x0a0b", "instances": ["0x1", "0x2"]}
    assert selfverify.cross_verify(Verifier(), method, result) is want
    assert seen == [("step" if "Step" in method else "committee", b"\x0a\x0b", [1, 2])]
    assert selfverify.cross_verify(Verifier(), method, {"status": "not a proof"})
