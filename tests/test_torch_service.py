"""The port's prover service (`spectre_tpu_torch/prover_service/`) against the
reference's (`spectre_tpu/prover_service/`), over real HTTP on 127.0.0.1.

As the reference's `tests/test_service.py`: duck-typed states stand in for
the prover where a real prove would take minutes. The same requests go to
both servers and give the same JSON bodies; the witness digest and the job
journal are shared between the packages; the two clients drive either
server. The port's own rules are held here too: nothing falls back to the
CPU (a device failure fails the job, a proof that fails verification is
proved once more on the state's own device), and one real K=6 prove through
the port's server gives the reference's bytes.
"""

import dataclasses
import json
import random
import urllib.error
import urllib.request

import pytest
import torch

from spectre_tpu import spec as RSPEC
from spectre_tpu.fields import bn254 as rbn
from spectre_tpu.plonk import backend as RB
from spectre_tpu.plonk.prover import prove as ref_prove
from spectre_tpu.prover_service import jobs as rjobs, rpc as rrpc
from spectre_tpu.prover_service import rpc_client as rclient
from spectre_tpu.prover_service.selfverify import _tiny_setup as ref_tiny_setup
from spectre_tpu.utils.health import ServiceHealth as RefServiceHealth
from spectre_tpu_torch import spec as SPEC
from spectre_tpu_torch.fields import bls12_381 as bls
from spectre_tpu_torch.models import CommitteeUpdateCircuit, StepCircuit
from spectre_tpu_torch.preprocessor import rotation_args_from_update
from spectre_tpu_torch.prover_service import jobs, rpc, rpc_client, selfverify
from spectre_tpu_torch.prover_service.calldata import decode_calldata
from spectre_tpu_torch.utils import faults
from spectre_tpu_torch.utils.health import HEALTH, ServiceHealth
from spectre_tpu_torch.witness import default_committee_update_args, default_sync_step_args

from _torch_service_params import committee_params, step_params

TINY, RTINY = SPEC.TINY, RSPEC.TINY


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


@pytest.fixture(scope="module")
def tiny_args():
    sargs = default_sync_step_args(TINY)
    cargs = default_committee_update_args(TINY)
    return sargs, cargs, step_params(sargs), committee_params(cargs)


class FakeState:
    """A canned prover, duck-typed for either package's server: the proof
    bytes are fixed, the instances the port's get_instances of the args
    (host code, equal to the reference's). compress=True puts 12
    accumulator limbs before them, as a compressed proof's statement."""

    device = "cpu"       # where the port's preprocessor decompresses

    def __init__(self, spec, compress=False, step_error=None):
        self.spec = spec
        self.concurrency = 1
        self.compress = compress
        self.step_error = step_error

    def _inst(self, inst):
        return ([7 + i for i in range(12)] + inst) if self.compress else inst

    def prove_step(self, args):
        if self.step_error is not None:
            raise self.step_error
        return b"\x01" * 64, self._inst(StepCircuit.get_instances(args, TINY))

    def prove_committee(self, args):
        return b"\x02" * 64, self._inst(CommitteeUpdateCircuit.get_instances(args, TINY))


def post(port, payload, raw=None, timeout=120):
    """(HTTP status, JSON body) of one POST /rpc."""
    body = raw if raw is not None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}/rpc", data=body,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.load(resp)
    except urllib.error.HTTPError as exc:
        return exc.code, json.load(exc)


def call(method, params=None, id_=1):
    return {"jsonrpc": "2.0", "id": id_, "method": method, "params": params or {}}


@pytest.fixture
def servers(tmp_path):
    """A started (reference, port) server pair over fresh states; yields a
    function making them from state factories and queue kwargs."""
    started = []

    def make(ref_state, port_state, fresh_health=False, **queue_kw):
        """fresh_health: each queue counts on a new ServiceHealth of its
        package (the retry_after price reads its running mean)."""
        pair = []
        for mod, st, sub, health in ((rrpc, ref_state, "ref", RefServiceHealth),
                                     (rpc, port_state, "port", ServiceHealth)):
            kw = dict(queue_kw, health=health()) if fresh_health else queue_kw
            srv = mod.serve(st, port=0, background=True, journal_dir=str(tmp_path / sub),
                            scrub_interval=0, **kw)
            started.append((srv, st))
            pair.append(srv.server_address[1])
        return pair

    yield make
    for srv, st in started:
        srv.shutdown()
        st.jobs.stop()


def _same(ref_port, port_port, payload, raw=None):
    """The JSON body both servers answer, which must be equal (and so must
    their HTTP status)."""
    a, b = post(ref_port, payload, raw), post(port_port, payload, raw)
    assert a == b, (payload, a, b)
    return b[1]


class TestWitnessDigest:
    @pytest.mark.parametrize("method,params", [
        ("genEvmProof_SyncStepCompressed", {"b": [1, 2], "a": "0x01"}),
        ("genEvmProof_CommitteeUpdateCompressed", {"light_client_update": {"x": {"z": 1}}}),
        ("submitProof_SyncStepCompressed", {}),
    ])
    def test_equal_on_the_same_request(self, method, params):
        assert jobs.witness_digest(method, params) == rjobs.witness_digest(method, params)
        assert jobs.witness_digest(method, dict(reversed(list(params.items())))) == \
            jobs.witness_digest(method, params)


def _runner(method, params):
    if params.get("fail"):
        raise ValueError("refused: " + params["fail"])
    return {"proof": "0x" + "ab" * 8, "instances": [hex(params["i"])]}


def _drive(mod, directory):
    """Done, failed and deduplicated jobs through a queue of `mod`, its
    journal and results in `directory`; returns the job ids."""
    q = mod.JobQueue(_runner, journal_dir=directory, scrub_interval=0)
    ids = [q.submit("m", {"i": i}) for i in range(3)]
    ids.append(q.submit("m", {"i": 9, "fail": "no"}))
    ids.append(q.submit("m", {"i": 0}))                  # dedup of the first
    for jid in ids:
        q.wait(jid, timeout=30)
    q.stop()
    return ids


class TestJournal:
    @pytest.mark.parametrize("writer,reader", [(rjobs, jobs), (jobs, rjobs)],
                             ids=["reference-to-port", "port-to-reference"])
    def test_replays_into_the_same_job_states(self, tmp_path, writer, reader):
        ids = _drive(writer, str(tmp_path))
        assert ids[0] == ids[4]
        want = writer.JobJournal(str(tmp_path)).replay()
        got = reader.JobJournal(str(tmp_path)).replay()
        assert sorted(got) == sorted(want) == sorted(set(ids))
        for jid in want:
            assert dataclasses.asdict(got[jid]) == dataclasses.asdict(want[jid])
        # a queue of the reader recovers the results through its store
        q = reader.JobQueue(_runner, journal_dir=str(tmp_path), scrub_interval=0)
        try:
            assert [q.result(j).result for j in ids[:3]] == \
                [{"proof": "0x" + "ab" * 8, "instances": [hex(i)]} for i in range(3)]
            assert q.result(ids[3]).status == "failed"
            assert q.result(ids[3]).error == {"kind": "ValueError", "message": "refused: no"}
            assert q.submit("m", {"i": 1}) == ids[1]      # a dedup hit after replay
        finally:
            q.stop()


def _drop_times(body):
    if isinstance(body, dict):
        return {k: _drop_times(v) for k, v in body.items()
                if k not in ("submitted_at", "queue_wait_s", "peak_rss_mb", "manifest_digest")}
    return body


class TestJsonRpc:
    def test_same_bodies_from_both_servers(self, servers, tiny_args):
        sargs, cargs, sp, cp = tiny_args
        a, b = servers(FakeState(RTINY), FakeState(TINY))
        _same(a, b, call("ping"))
        res = _same(a, b, call(rpc.RPC_METHOD_STEP, sp))["result"]
        assert [int(v, 16) for v in res["instances"]] == StepCircuit.get_instances(sargs, TINY)
        res = _same(a, b, call(rpc.RPC_METHOD_COMMITTEE, cp, 2))["result"]
        inst = CommitteeUpdateCircuit.get_instances(
            rotation_args_from_update(cp["light_client_update"], TINY), TINY)
        assert int(res["committee_poseidon"], 16) == inst[0]
        assert decode_calldata(bytes.fromhex(res["calldata"][2:]), 3) == (inst, b"\x02" * 64)
        # a resubmit is a dedup hit on the blocking call's job
        sub = _same(a, b, call(rpc.RPC_METHOD_STEP_SUBMIT, sp, 3))["result"]
        assert sub["status"] == "done"
        st_a = post(a, call("getProofStatus", {"job_id": sub["job_id"]}))[1]
        st_b = post(b, call("getProofStatus", {"job_id": sub["job_id"]}))[1]
        assert _drop_times(st_a) == _drop_times(st_b)
        _same(a, b, call("getProofResult", {"job_id": sub["job_id"]}))
        _same(a, b, call("cancelProof", {"job_id": sub["job_id"]}))
        _same(a, b, call("getProofResult", {"job_id": "nope"}))
        _same(a, b, call("getProofManifest", {"job_id": "nope"}))
        _same(a, b, call("getTrace", {"job_id": "nope"}))
        _same(a, b, call("nope"))
        _same(a, b, call(rpc.RPC_METHOD_STEP, {}))                   # -32602, in dispatch
        bad = dict(sp)
        del bad["pubkeys"]
        _same(a, b, call(rpc.RPC_METHOD_STEP, bad, 4))              # -32602, in the job
        _same(a, b, None, raw=b"{nope")                             # -32700
        _same(a, b, [1, 2, 3])                                      # -32600
        _same(a, b, {"method": "ping", "id": 1})                    # -32600
        # the follower's methods: -32601, as without a follower
        for method in ("getLightClientUpdate", "followerStatus"):
            assert post(a, call(method))[1]["error"]["code"] == \
                post(b, call(method))[1]["error"]["code"] == rpc.METHOD_NOT_FOUND

    def test_rejections_are_minus_32000(self, servers, tiny_args):
        """The reference asserts where the port raises ValueError: both
        reach the wire as -32000 witness rejected, with the same message."""
        sargs, _, sp, _ = tiny_args
        a, b = servers(FakeState(RTINY, step_error=AssertionError("bad witness")),
                       FakeState(TINY, step_error=ValueError("bad witness")))
        body = _same(a, b, call(rpc.RPC_METHOD_STEP, sp))
        assert body["error"] == {"code": -32000, "message": "witness rejected: bad witness"}

    def test_preprocessor_refusal_is_minus_32000(self, servers, tiny_args):
        _, _, sp, _ = tiny_args
        a, b = servers(FakeState(RTINY), FakeState(TINY))
        upd = dict(sp["light_client_finality_update"],
                   finality_branch=["0x" + "00" * 32] * TINY.finalized_header_depth)
        body = _same(a, b, call(rpc.RPC_METHOD_STEP, dict(sp, light_client_finality_update=upd)))
        assert body["error"] == {"code": -32000,
                                    "message": "witness rejected: finality branch does not verify"}
        sig = "0x" + bls.g2_compress(bls.g2_curve.mul(bls.G2_GEN, 123)).hex()
        agg = dict(sp["light_client_finality_update"]["sync_aggregate"],
                   sync_committee_signature=sig)
        upd = dict(sp["light_client_finality_update"], sync_aggregate=agg)
        body = post(b, call(rpc.RPC_METHOD_STEP, dict(sp, light_client_finality_update=upd)))
        assert body[1]["error"] == {"code": -32000, "message":
                                    "witness rejected: aggregate signature does not verify"}

    def test_compressed_statement_puts_the_poseidon_at_12(self, servers, tiny_args):
        _, cargs, _, cp = tiny_args
        a, b = servers(FakeState(RTINY, compress=True), FakeState(TINY, compress=True))
        res = _same(a, b, call(rpc.RPC_METHOD_COMMITTEE, cp))["result"]
        assert int(res["committee_poseidon"], 16) == \
            CommitteeUpdateCircuit.get_instances(cargs, TINY)[0]

    def test_overload_carries_retry_after(self, servers, tiny_args):
        _, _, sp, _ = tiny_args
        a, b = servers(FakeState(RTINY), FakeState(TINY), fresh_health=True, queue_depth=0)
        ra = post(a, call(rpc.RPC_METHOD_STEP_SUBMIT, sp))
        rb = post(b, call(rpc.RPC_METHOD_STEP_SUBMIT, sp))
        assert ra == rb and rb[0] == 429
        assert rb[1]["error"]["code"] == rpc.SERVICE_OVERLOADED
        assert rb[1]["error"]["data"]["retry_after_s"] > 0


class TestClients:
    @pytest.mark.parametrize("server_mod,client_mod", [(rrpc, rpc_client), (rpc, rclient)],
                             ids=["port-client-reference-server",
                                  "reference-client-port-server"])
    def test_cross(self, tmp_path, tiny_args, server_mod, client_mod):
        sargs, cargs, sp, cp = tiny_args
        state = FakeState(RTINY if server_mod is rrpc else TINY)
        srv = server_mod.serve(state, port=0, background=True, journal_dir=str(tmp_path),
                               scrub_interval=0)
        try:
            c = client_mod.ProverClient(f"http://127.0.0.1:{srv.server_address[1]}/rpc",
                                        timeout=120)
            assert c.ping() == "pong"
            res = c.gen_evm_proof_sync_step_compressed(sp["light_client_finality_update"],
                                                       sp["pubkeys"], sp["domain"])
            assert [int(v, 16) for v in res["instances"]] == \
                StepCircuit.get_instances(sargs, TINY)
            jid = c.submit_committee_update(cp["light_client_update"])
            res = c.wait_for_proof(jid, poll=0.05, timeout=60)
            assert int(res["committee_poseidon"], 16) == \
                CommitteeUpdateCircuit.get_instances(cargs, TINY)[0]
            assert c.proof_status(jid)["status"] == "done"
            assert "counters" in c.health()
            assert c.get_manifest(jid)["job_id"] == jid
            with pytest.raises(client_mod.RpcError) as e:
                c.proof_result("nope")
            assert e.value.code == rpc.JOB_NOT_FOUND
            assert "spectre_prove_latency_seconds_count" in c.metrics_text()
        finally:
            srv.shutdown()
            state.jobs.stop()


def _seeded(seed):
    r = random.Random(seed)
    return lambda: r.randrange(rbn.R)


class TinyState:
    """Proves the readiness circuit on the CPU with seeded blinding, whatever
    the request; verifies for real; its self-check runs on its device."""

    device = torch.device("cpu")
    concurrency = 1
    compress = False

    def __init__(self):
        self.spec = TINY
        self.self_check = selfverify.SelfCheck(device="cpu")

    def prove_step(self, args):
        from spectre_tpu_torch.plonk.prover import prove
        pk, srs, asg, out = selfverify._tiny_setup("cpu")
        return prove(pk, srs, asg, device="cpu", blinding_rng=_seeded(0xC0FFEE)), [out]

    def verify_proof(self, kind, proof, instances):
        from spectre_tpu_torch.plonk.verifier import verify
        pk, srs, _, _ = selfverify._tiny_setup("cpu")
        return verify(pk.vk, srs, [instances], proof)


def test_one_real_prove_through_the_port_server(tmp_path, tiny_args):
    """The K=6 readiness circuit proved through the port's server on the
    CPU: the reference's bytes under the same seeded blinding, verified
    before serving; /healthz is 503 until the self-check has passed on the
    state's device."""
    _, _, sp, _ = tiny_args
    state = TinyState()
    srv = rpc.serve(state, port=0, background=True, journal_dir=str(tmp_path), scrub_interval=0)
    try:
        c = rpc_client.ProverClient(f"http://127.0.0.1:{srv.server_address[1]}/rpc",
                                    timeout=300)
        status, body = c.healthz()
        assert status == 503 and body["self_check"]["ok"] is False
        assert state.self_check.run()
        status, body = c.healthz()
        assert status == 200 and body["self_check"] == {"ok": True, "runs": 1,
                                                        "last_error": None}
        verified = HEALTH.get("proofs_verified")
        res = c.gen_evm_proof_sync_step_compressed(sp["light_client_finality_update"],
                                                   sp["pubkeys"], sp["domain"])
        assert HEALTH.get("proofs_verified") == verified + 1
        pk, srs, asg, out = ref_tiny_setup()
        want = ref_prove(pk, srs, asg, RB.get_backend("cpu"), blinding_rng=_seeded(0xC0FFEE))
        assert bytes.fromhex(res["proof"][2:]) == want
        assert res["instances"] == [hex(out)]
    finally:
        srv.shutdown()
        state.jobs.stop()
