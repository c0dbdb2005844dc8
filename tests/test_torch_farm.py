"""The port's proof farm (`spectre_tpu_torch/prover_service/dispatcher.py`)
against the reference's (`spectre_tpu/prover_service/dispatcher.py`).

The reference's failover matrix (`tests/test_farm.py`), case for case, on the
port: replica crash mid-prove -> lease takeover with a byte-identical proof,
breaker-open replica receives no work, SDC re-prove on a different replica
(cross-host verification), dispatcher restart replays leases without
double-proving, lease expiry on a stalled replica, beacon quorum ignores a
lone dissenting head, the UpdateStore 10k-period memory bound, membership
and capability placement. Every replica is an in-process LocalReplica with a
canned runner, clocks are injectable, fault plans come from the port's
utils.faults.

Then the port against the reference on the same seeded inputs: rendezvous
routing (the port's per-variant aggregation k included), lease and member
journals replayed across the packages, both packages' clients against both
heads, a K=6 prove through the port's farm with one takeover giving the
reference's seeded bytes, and the phase heartbeats that keep a lease alive
across a prove longer than the lease.
"""

import hashlib
import json
import os
import socket
import subprocess
import sys
import threading
import time
import tracemalloc
import urllib.request

import pytest
import torch

from spectre_tpu_torch.observability import manifest as obs_manifest
from spectre_tpu_torch.prover_service.dispatcher import (Dispatcher, HttpReplica,
                                                   LocalReplica,
                                                   NoReplicaAvailable)
from spectre_tpu_torch.prover_service.jobs import JobQueue, witness_digest
from spectre_tpu_torch.utils import faults
from spectre_tpu_torch.utils.breaker import BreakerOpen, CircuitBreaker
from spectre_tpu_torch.utils.health import HEALTH, ServiceHealth

METHOD = "genEvmProof_SyncStepCompressed"
PROOF = bytes(range(64))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads per test process: the tier-1 run has six workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    yield
    faults.clear()


def _result(proof: bytes = PROOF) -> dict:
    return {"proof": "0x" + proof.hex(), "instances": ["0x7", "0x9"]}


def _digest_of(result: dict) -> str:
    return hashlib.sha256(json.dumps(result, sort_keys=True,
                                     separators=(",", ":")).encode()
                          ).hexdigest()


def _mk_runner(calls: list, proof: bytes = PROOF, mangle_site=None):
    """Canned queue-runner: records calls, returns a deterministic
    result (optionally passing the proof bytes through a mangle site —
    the SDC stand-in)."""
    def runner(method, params, heartbeat=None):
        calls.append(method)
        p = faults.mangle(mangle_site, proof) if mangle_site else proof
        return _result(p)
    return runner


def _ranked_ids(ids, method=METHOD, params=None):
    """Replica ids in the dispatcher's rendezvous order for a digest —
    so tests can pin WHICH replica is tried first."""
    digest = witness_digest(method, params if params is not None else {})
    return sorted(ids, key=lambda rid: hashlib.sha256(
        f"{digest}|{rid}".encode()).hexdigest())


class _VerifyState:
    """Cross-host verifier: accepts exactly the canned PROOF bytes."""

    def __init__(self, proof: bytes = PROOF):
        self._proof = proof
        self.calls = 0

    def verify_proof(self, kind, proof, instances):
        self.calls += 1
        return proof == self._proof


# -- circuit breaker unit (shared beacon/dispatcher machinery) --------------


class TestCircuitBreaker:
    def test_full_state_machine_with_fake_clock(self):
        clk = [0.0]
        h = ServiceHealth()
        br = CircuitBreaker(threshold=2, cooldown=10.0, health=h,
                            counter_prefix="t", clock=lambda: clk[0])
        assert br.state == "closed"
        br.admit()
        br.record(False)
        assert br.state == "closed"
        br.record(False)                      # threshold -> OPEN + trip
        assert br.state == "open"
        assert h.get("t_trips") == 1
        with pytest.raises(BreakerOpen):
            br.admit()                        # fails fast while open
        assert 0.0 < br.remaining() <= 10.0
        clk[0] = 10.0                         # cooldown over -> half-open
        assert br.state == "half-open"
        br.admit()                            # the one trial admission
        assert h.get("t_half_open") == 1
        br.record(False)                      # failed trial -> re-open
        assert br.state == "open"
        assert h.get("t_trips") == 2
        clk[0] = 20.0
        br.admit()
        br.record(True)                       # successful trial -> closed
        assert br.state == "closed"
        assert br.consecutive_failures == 0
        assert br.snapshot() == {"state": "closed", "state_code": 0,
                                 "consecutive_failures": 0}


# -- routing ----------------------------------------------------------------


class TestRouting:
    def test_same_witness_prefers_same_replica(self, tmp_path):
        calls = {"a": [], "b": [], "c": []}
        d = Dispatcher([LocalReplica(r, runner=_mk_runner(calls[r]))
                        for r in calls], poll_s=0.005)
        for _ in range(3):
            assert d.dispatch(METHOD, {"w": 1}) == _result()
        first = _ranked_ids(list(calls), params={"w": 1})[0]
        assert len(calls[first]) == 3
        assert all(not calls[r] for r in calls if r != first)

    def test_breaker_open_replica_gets_no_work(self, tmp_path):
        calls = {"a": [], "b": []}
        d = Dispatcher([LocalReplica(r, runner=_mk_runner(calls[r]))
                        for r in calls], poll_s=0.005, breaker_threshold=2,
                       breaker_cooldown=60.0)
        first, second = _ranked_ids(list(calls))
        for _ in range(2):                    # trip the preferred replica
            d.breaker(first).record(False)
        assert d.breaker(first).state == "open"
        skips0 = HEALTH.get("dispatcher_breaker_skips")
        assert d.dispatch(METHOD, {}) == _result()
        assert calls[first] == []             # open breaker: skipped
        assert len(calls[second]) == 1
        assert HEALTH.get("dispatcher_breaker_skips") == skips0 + 1

    def test_failing_health_probe_skips_not_crashes(self, monkeypatch):
        calls = {"a": [], "b": []}
        d = Dispatcher([LocalReplica(r, runner=_mk_runner(calls[r]))
                        for r in calls], poll_s=0.005)
        first, second = _ranked_ids(list(calls))
        un0 = HEALTH.get("dispatcher_replica_unhealthy")
        # the probe fault fires once: the FIRST-ranked replica's probe
        # blows up, it is skipped (not crashed), work lands on the other
        monkeypatch.setenv("SPECTRE_FAULT_PLAN", "replica.health:raise:1")
        assert d.dispatch(METHOD, {}) == _result()
        assert calls[first] == [] and len(calls[second]) == 1
        assert HEALTH.get("dispatcher_replica_unhealthy") == un0 + 1
        snap = {r["replica_id"]: r for r in d.snapshot()["replicas"]}
        assert snap[first]["healthy"] is False
        assert snap[second]["healthy"] is True

    def test_no_replica_available(self):
        d = Dispatcher([], poll_s=0.005)
        n0 = HEALTH.get("dispatcher_no_replica")
        with pytest.raises(NoReplicaAvailable):
            d.dispatch(METHOD, {})
        assert HEALTH.get("dispatcher_no_replica") == n0 + 1

    def test_capability_routing(self):
        calls = {"step-only": [], "full": []}
        d = Dispatcher([
            LocalReplica("step-only", runner=_mk_runner(calls["step-only"]),
                         capabilities={METHOD}),
            LocalReplica("full", runner=_mk_runner(calls["full"]))],
            poll_s=0.005)
        d.dispatch("genEvmProof_CommitteeUpdateCompressed", {})
        assert calls["step-only"] == []       # can't serve committee
        assert len(calls["full"]) == 1

    def test_duplicate_replica_id_rejected(self):
        d = Dispatcher([LocalReplica("a", runner=_mk_runner([]))])
        with pytest.raises(ValueError, match="duplicate replica id"):
            d.register(LocalReplica("a", runner=_mk_runner([])))

    def test_deterministic_prover_error_not_failed_over(self):
        """Witness rejection is the JOB's fault, not the replica's: it
        re-raises unchanged instead of burning the other replicas."""
        calls_b = []

        def bad_witness(method, params, heartbeat=None):
            raise AssertionError("finality branch mismatch")

        ids = _ranked_ids(["a", "b"])
        runners = {ids[0]: bad_witness, ids[1]: _mk_runner(calls_b)}
        d = Dispatcher([LocalReplica(r, runner=runners[r]) for r in ids],
                       poll_s=0.005)
        with pytest.raises(AssertionError, match="finality branch"):
            d.dispatch(METHOD, {})
        assert calls_b == []                  # no failover for bad input


# -- the acceptance drill: crash mid-prove -> lease takeover ----------------


class TestFailoverDrill:
    def test_replica_crash_byte_identical_takeover(self, tmp_path,
                                                   monkeypatch):
        """SPECTRE_FAULT_PLAN=replica.dispatch:crash:1
        against 3 in-process replicas — the job completes on a surviving
        replica, the result digest is byte-identical to a clean
        single-replica prove, dispatcher_lease_takeovers ticks once."""
        # clean single-replica reference prove first (no faults armed)
        ref = Dispatcher([LocalReplica("solo", runner=_mk_runner([]))],
                         poll_s=0.005)
        ref_digest = _digest_of(ref.dispatch(METHOD, {"w": "drill"}))

        calls = {"r1": [], "r2": [], "r3": []}
        d = Dispatcher([LocalReplica(r, runner=_mk_runner(calls[r]))
                        for r in calls],
                       journal_dir=str(tmp_path), lease_s=30.0, poll_s=0.005)
        take0 = HEALTH.get("dispatcher_lease_takeovers")
        fail0 = HEALTH.get("dispatcher_replica_failures")
        monkeypatch.setenv("SPECTRE_FAULT_PLAN", "replica.dispatch:crash:1")
        result = d.dispatch(METHOD, {"w": "drill"})
        assert _digest_of(result) == ref_digest     # byte-identical
        assert faults.fired_count("replica.dispatch") == 1
        assert HEALTH.get("dispatcher_lease_takeovers") == take0 + 1
        assert HEALTH.get("dispatcher_replica_failures") == fail0 + 1
        # the crash killed the first-ranked replica BEFORE its runner ran;
        # exactly one surviving replica proved
        first, second, _ = _ranked_ids(list(calls), params={"w": "drill"})
        assert calls[first] == []
        assert len(calls[second]) == 1
        assert sum(len(c) for c in calls.values()) == 1
        # the lease journal tells the story: crashed grant, takeover
        # grant, done release
        recs = [json.loads(line) for line in
                (tmp_path / "dispatcher.leases.jsonl").read_text()
                .splitlines()]
        events = [(r["event"], r.get("outcome")) for r in recs]
        assert events == [("lease", None), ("release", "crashed"),
                          ("lease", None), ("release", "done")]
        assert recs[0]["replica"] == first
        assert recs[2]["replica"] == second and recs[2]["takeover"] is True

    def test_manifest_records_both_replicas(self, monkeypatch):
        calls = {"a": [], "b": []}
        d = Dispatcher([LocalReplica(r, runner=_mk_runner(calls[r]))
                        for r in calls], poll_s=0.005)
        monkeypatch.setenv("SPECTRE_FAULT_PLAN", "replica.dispatch:crash:1")
        with obs_manifest.collect_events() as events:
            d.dispatch(METHOD, {})
        leases = [e for e in events if e["kind"] == "replica_lease"]
        assert [e["takeover"] for e in leases] == [False, True]
        assert leases[0]["replica"] != leases[1]["replica"]

    def test_lease_journal_ioerror_tolerated(self, tmp_path, monkeypatch):
        """`replica.lease:ioerror` (disk trouble on the lease journal)
        must not fail the prove — counted, farm keeps going."""
        d = Dispatcher([LocalReplica("a", runner=_mk_runner([]))],
                       journal_dir=str(tmp_path), poll_s=0.005)
        j0 = HEALTH.get("dispatcher_lease_journal_failures")
        monkeypatch.setenv("SPECTRE_FAULT_PLAN", "replica.lease:ioerror:1")
        assert d.dispatch(METHOD, {}) == _result()
        assert HEALTH.get("dispatcher_lease_journal_failures") == j0 + 1


# -- lease expiry on a stalled (not crashed) replica ------------------------


class TestLeaseExpiry:
    def test_stalled_replica_lease_expires_and_job_moves(self):
        clk = [0.0]
        release = threading.Event()
        ids = _ranked_ids(["stall", "live"])
        calls_live = []

        def stalling(method, params, heartbeat=None):
            clk[0] += 1000.0          # way past the lease, never renewing
            release.wait(10.0)        # disowned thread parks here

        runners = {"stall": stalling, "live": _mk_runner(calls_live)}
        # make the STALLED replica the rendezvous favourite
        d = Dispatcher([LocalReplica(ids[0], runner=runners["stall"]),
                        LocalReplica(ids[1], runner=runners["live"])],
                       lease_s=60.0, poll_s=0.005, clock=lambda: clk[0])
        exp0 = HEALTH.get("dispatcher_lease_expired")
        take0 = HEALTH.get("dispatcher_lease_takeovers")
        try:
            assert d.dispatch(METHOD, {}) == _result()
        finally:
            release.set()
        assert HEALTH.get("dispatcher_lease_expired") == exp0 + 1
        assert HEALTH.get("dispatcher_lease_takeovers") == take0 + 1
        assert len(calls_live) == 1

    def test_heartbeat_renews_lease(self):
        """A slow-but-renewing replica keeps its lease: the runner's
        heartbeat resets expiry, so a prove longer than lease_s still
        completes on the SAME replica."""
        clk = [0.0]
        calls = []

        def slow(method, params, heartbeat=None):
            for _ in range(5):
                clk[0] += 40.0        # 200s of "work" under a 60s lease
                heartbeat()
            calls.append(method)
            return _result()

        d = Dispatcher([LocalReplica("slow", runner=slow)],
                       lease_s=60.0, poll_s=0.005, clock=lambda: clk[0])
        exp0 = HEALTH.get("dispatcher_lease_expired")
        assert d.dispatch(METHOD, {}) == _result()
        assert len(calls) == 1
        assert HEALTH.get("dispatcher_lease_expired") == exp0


# -- SDC: cross-host verification reroutes to a different replica -----------


class TestSdcReroute:
    def _farm(self, tmp_path=None, verify=None):
        ids = _ranked_ids(["a", "b"])
        calls = {rid: [] for rid in ids}
        # the rendezvous favourite passes its proof through the SDC
        # mangle site; the other returns clean bytes
        reps = [LocalReplica(ids[0], runner=_mk_runner(
                    calls[ids[0]], mangle_site="proof.bytes")),
                LocalReplica(ids[1], runner=_mk_runner(calls[ids[1]]))]
        d = Dispatcher(reps, poll_s=0.005,
                       journal_dir=str(tmp_path) if tmp_path else None,
                       verify_state=verify or _VerifyState())
        return d, ids, calls

    def test_sdc_reproved_on_different_replica(self, tmp_path, monkeypatch):
        # an earlier bench run may have left SPECTRE_SELF_VERIFY=off in
        # the process env; cross-verification honors the same policy knob
        monkeypatch.setenv("SPECTRE_SELF_VERIFY", "always")
        d, ids, calls = self._farm(tmp_path)
        sdc0 = HEALTH.get("dispatcher_sdc_rerouted")
        xf0 = HEALTH.get("proofs_cross_verify_failed")
        xok0 = HEALTH.get("proofs_cross_verified")
        monkeypatch.setenv("SPECTRE_FAULT_PLAN", "proof.bytes:corrupt:1")
        with obs_manifest.collect_events() as events:
            result = d.dispatch(METHOD, {})
        assert result == _result()            # the CLEAN bytes are served
        assert len(calls[ids[0]]) == 1 and len(calls[ids[1]]) == 1
        assert HEALTH.get("dispatcher_sdc_rerouted") == sdc0 + 1
        assert HEALTH.get("proofs_cross_verify_failed") == xf0 + 1
        assert HEALTH.get("proofs_cross_verified") == xok0 + 1
        # manifest pins BOTH hosts: the corrupting one and the fixer
        reroute = [e for e in events if e["kind"] == "sdc_reroute"]
        assert reroute == [{"kind": "sdc_reroute",
                            "from_replica": ids[0], "to_replica": ids[1]}]
        leases = [e["replica"] for e in events
                  if e["kind"] == "replica_lease"]
        assert leases == [ids[0], ids[1]]

    def test_double_sdc_fails_job(self, monkeypatch):
        from spectre_tpu_torch.prover_service.selfverify import ProofVerifyFailed
        monkeypatch.setenv("SPECTRE_SELF_VERIFY", "always")
        ids = _ranked_ids(["a", "b"])
        calls = {rid: [] for rid in ids}
        d = Dispatcher([LocalReplica(r, runner=_mk_runner(
                            calls[r], mangle_site="proof.bytes"))
                        for r in ids],
                       poll_s=0.005, verify_state=_VerifyState())
        monkeypatch.setenv("SPECTRE_FAULT_PLAN", "proof.bytes:corrupt:2")
        with pytest.raises(ProofVerifyFailed):
            d.dispatch(METHOD, {})
        # both replicas produced unverifiable bytes -> terminal, same
        # error class as the single-host verify-before-serve path
        assert len(calls[ids[0]]) == 1 and len(calls[ids[1]]) == 1

    def test_sdc_bytes_quarantined(self, tmp_path, monkeypatch):
        from spectre_tpu_torch.utils.artifacts import ArtifactStore
        monkeypatch.setenv("SPECTRE_SELF_VERIFY", "always")
        d, ids, calls = self._farm()
        store = ArtifactStore(str(tmp_path))

        class _Q:                              # queue façade: just a store
            pass

        q = _Q()
        q.store = store
        d.attach_queue(q)
        monkeypatch.setenv("SPECTRE_FAULT_PLAN", "proof.bytes:corrupt:1")
        d.dispatch(METHOD, {})
        quarantined = os.listdir(store.quarantine_dir)
        assert len(quarantined) == 1
        assert quarantined[0].endswith(".proof")
        with open(os.path.join(store.quarantine_dir, quarantined[0]),
                  "rb") as f:
            bad = f.read()
        assert bad != PROOF                    # the CORRUPT bytes, parked


# -- restart: lease journal replay ------------------------------------------


class TestLeaseReplay:
    def test_restart_replays_open_lease_and_reroutes(self, tmp_path,
                                                     monkeypatch):
        """Dispatcher dies right after journaling a lease grant (the
        post-append crash window): the restarted dispatcher must not
        re-trust the replica that died holding the lease, and the
        queue's dedup must not double-prove."""
        qdir, ddir = str(tmp_path / "q"), str(tmp_path / "d")
        ids = _ranked_ids(["a", "b"], params={"w": 1})
        calls1 = {rid: [] for rid in ids}
        d1 = Dispatcher([LocalReplica(r, runner=_mk_runner(calls1[r]))
                         for r in ids], journal_dir=ddir, poll_s=0.005)
        q1 = JobQueue(d1, concurrency=1, journal_dir=qdir)
        monkeypatch.setenv("SPECTRE_FAULT_PLAN", "replica.lease:crash:1")
        # the InjectedCrash kills the worker thread like a dead process;
        # silence the default excepthook traceback spam
        old_hook = threading.excepthook
        threading.excepthook = lambda args: None
        try:
            jid = q1.submit(METHOD, {"w": 1})
            deadline = time.time() + 120
            while faults.fired_count("replica.lease") < 1:
                assert time.time() < deadline, "lease crash never fired"
                time.sleep(0.01)
            deadline = time.time() + 120
            while any(s["thread"] is not None and s["thread"].is_alive()
                      for s in q1._slots):
                assert time.time() < deadline, "worker did not die"
                time.sleep(0.01)
        finally:
            threading.excepthook = old_hook
        assert q1.status(jid)["status"] == "running"   # crashed mid-job
        assert not calls1[ids[0]] and not calls1[ids[1]]
        q1.stop()

        monkeypatch.delenv("SPECTRE_FAULT_PLAN")
        faults.clear()                        # disarm for the restart
        rep0 = HEALTH.get("dispatcher_leases_replayed")
        take0 = HEALTH.get("dispatcher_lease_takeovers")
        calls2 = {rid: [] for rid in ids}
        d2 = Dispatcher([LocalReplica(r, runner=_mk_runner(calls2[r]))
                         for r in ids], journal_dir=ddir, poll_s=0.005)
        assert HEALTH.get("dispatcher_leases_replayed") == rep0 + 1
        q2 = JobQueue(d2, concurrency=1, journal_dir=qdir)
        try:
            job = q2.wait(jid, timeout=10)    # recovery requeued it
            assert job.status == "done"
            assert job.result == _result()
            # the dead-lease replica is excluded: the OTHER one proved
            assert calls2[ids[0]] == []
            assert len(calls2[ids[1]]) == 1
            assert HEALTH.get("dispatcher_lease_takeovers") == take0 + 1
            # resubmitting the same witness is a dedup cache hit
            assert q2.submit(METHOD, {"w": 1}) == jid
            assert sum(len(c) for c in calls2.values()) == 1
        finally:
            q2.stop()

    def test_replay_skips_torn_tail_and_done_leases(self, tmp_path):
        ddir = str(tmp_path)
        d1 = Dispatcher([LocalReplica("a", runner=_mk_runner([]))],
                        journal_dir=ddir, poll_s=0.005)
        d1.dispatch(METHOD, {"w": 1})         # grant + done release
        path = os.path.join(ddir, "dispatcher.leases.jsonl")
        with open(path, "a") as f:
            f.write('{"event": "lease", "digest": "tor')   # torn append
        rep0 = HEALTH.get("dispatcher_leases_replayed")
        d2 = Dispatcher([LocalReplica("a", runner=_mk_runner([]))],
                        journal_dir=ddir, poll_s=0.005)
        # the done lease is NOT an exclusion and the torn line is skipped
        assert HEALTH.get("dispatcher_leases_replayed") == rep0
        assert d2.dispatch(METHOD, {"w": 1}) == _result()


# -- lease-journal startup compaction ----------------------------------------


_LEASE_HISTORY = [
    {"event": "lease", "digest": "d1", "replica": "a"},
    {"event": "release", "digest": "d1", "replica": "a",
     "outcome": "done"},
    {"event": "lease", "digest": "d2", "replica": "a"},
    {"event": "release", "digest": "d2", "replica": "a",
     "outcome": "failed"},
    {"event": "lease", "digest": "d3", "replica": "b"},   # still open
]


def _write_lease_journal(ddir, records=_LEASE_HISTORY) -> str:
    path = os.path.join(ddir, "dispatcher.leases.jsonl")
    with open(path, "w") as f:
        for rec in records:
            f.write(json.dumps(rec, sort_keys=True) + "\n")
    return path


class TestLeaseCompaction:
    def test_startup_compaction_is_a_replay_fixpoint(self, tmp_path):
        """Restart compacts the grant/release history down to open
        leases + exclusions; replaying the compacted file reconstructs
        the SAME state, and a further restart has nothing left to drop."""
        ddir = str(tmp_path)
        path = _write_lease_journal(ddir)
        c0 = HEALTH.get("dispatcher_lease_compactions")
        d1 = Dispatcher([LocalReplica(r, runner=_mk_runner([]))
                         for r in ("a", "b")], journal_dir=ddir,
                        poll_s=0.005)
        assert HEALTH.get("dispatcher_lease_compactions") == c0 + 1
        assert d1._excluded == {"d2": {"a"}, "d3": {"b"}}
        assert d1._takeover_due == {"d3"}
        lines = [json.loads(ln) for ln in
                 open(path).read().splitlines() if ln.strip()]
        # the done pair and the open lease's separate grant are gone
        assert len(lines) == 2
        assert {(r["event"], r["digest"]) for r in lines} == \
            {("release", "d2"), ("lease", "d3")}
        # replaying the compacted journal reconstructs identical state
        # and, being the fixpoint, does NOT compact again
        d2 = Dispatcher([LocalReplica(r, runner=_mk_runner([]))
                         for r in ("a", "b")], journal_dir=ddir,
                        poll_s=0.005)
        assert HEALTH.get("dispatcher_lease_compactions") == c0 + 1
        assert d2._excluded == d1._excluded
        assert d2._takeover_due == d1._takeover_due

    def test_crash_mid_compact_leaves_original_journal(self, tmp_path,
                                                       monkeypatch):
        """`replica.lease_compact:crash` fires in the staged-but-not-
        swapped window: the original journal survives byte-for-byte, and
        the next startup re-compacts to the same state."""
        ddir = str(tmp_path)
        path = _write_lease_journal(ddir)
        before = open(path, "rb").read()
        monkeypatch.setenv("SPECTRE_FAULT_PLAN",
                           "replica.lease_compact:crash:1")
        with pytest.raises(faults.InjectedCrash):
            Dispatcher([LocalReplica("a", runner=_mk_runner([]))],
                       journal_dir=ddir, poll_s=0.005)
        assert open(path, "rb").read() == before
        monkeypatch.delenv("SPECTRE_FAULT_PLAN")
        faults.clear()
        d = Dispatcher([LocalReplica(r, runner=_mk_runner([]))
                        for r in ("a", "b")], journal_dir=ddir,
                       poll_s=0.005)
        assert d._excluded == {"d2": {"a"}, "d3": {"b"}}
        assert d._takeover_due == {"d3"}
        lines = [ln for ln in open(path).read().splitlines() if ln.strip()]
        assert len(lines) == 2

    def test_compact_ioerror_tolerated_keeps_history(self, tmp_path,
                                                     monkeypatch):
        """Disk trouble during compaction degrades to keeping the full
        history (counted), never to losing lease state."""
        ddir = str(tmp_path)
        path = _write_lease_journal(ddir)
        before = open(path, "rb").read()
        f0 = HEALTH.get("dispatcher_lease_compact_failures")
        monkeypatch.setenv("SPECTRE_FAULT_PLAN",
                           "replica.lease_compact:ioerror:1")
        d = Dispatcher([LocalReplica(r, runner=_mk_runner([]))
                        for r in ("a", "b")], journal_dir=ddir,
                       poll_s=0.005)
        assert HEALTH.get("dispatcher_lease_compact_failures") == f0 + 1
        assert open(path, "rb").read() == before
        assert d._excluded == {"d2": {"a"}, "d3": {"b"}}


# -- multi-beacon quorum ----------------------------------------------------


class _StubBeacon:
    def __init__(self, head_root, breaker_state="closed", error=None):
        self._head = head_root
        self.breaker_state = breaker_state
        self._error = error
        self.demoted = 0
        self.polls = 0

    def finality_update(self):
        self.polls += 1
        if self._error is not None:
            raise self._error
        return {"finalized_header": {"slot": 64, "root": self._head},
                "signature_slot": 66}

    def demote(self):
        self.demoted += 1


class TestBeaconQuorum:
    def _quorum(self, *clients, quorum=2):
        from spectre_tpu_torch.preprocessor.beacon import BeaconQuorum
        return BeaconQuorum(list(clients), quorum=quorum)

    def test_dissenting_beacon_ignored_and_demoted(self):
        """2-of-3 agree on the finalized head; the
        lone divergent beacon is outvoted and demoted."""
        a, b = _StubBeacon("0xaa"), _StubBeacon("0xaa")
        liar = _StubBeacon("0xff")
        dis0 = HEALTH.get("beacon_quorum_dissent")
        upd = self._quorum(a, b, liar).finality_update()
        assert upd["finalized_header"]["root"] == "0xaa"
        assert liar.demoted == 1 and a.demoted == 0 and b.demoted == 0
        assert HEALTH.get("beacon_quorum_dissent") == dis0 + 1

    def test_no_quorum_raises(self):
        from spectre_tpu_torch.preprocessor.beacon import QuorumNotReached
        f0 = HEALTH.get("beacon_quorum_failures")
        q = self._quorum(_StubBeacon("0xaa"), _StubBeacon("0xbb"),
                         _StubBeacon("0xcc"))
        with pytest.raises(QuorumNotReached, match="split"):
            q.finality_update()
        assert HEALTH.get("beacon_quorum_failures") == f0 + 1

    def test_erroring_beacon_tolerated(self):
        e0 = HEALTH.get("beacon_quorum_errors")
        upd = self._quorum(_StubBeacon("0xaa"), _StubBeacon("0xaa"),
                           _StubBeacon(None, error=TimeoutError("down"))
                           ).finality_update()
        assert upd["finalized_header"]["root"] == "0xaa"
        assert HEALTH.get("beacon_quorum_errors") == e0 + 1

    def test_breaker_open_beacon_skipped(self):
        parked = _StubBeacon("0xff", breaker_state="open")
        upd = self._quorum(_StubBeacon("0xaa"), _StubBeacon("0xaa"),
                           parked).finality_update()
        assert upd["finalized_header"]["root"] == "0xaa"
        assert parked.polls == 0              # never even polled

    def test_quorum_clamped_to_pool_size(self):
        q = self._quorum(_StubBeacon("0xaa"), quorum=5)
        assert q.quorum == 1
        assert q.finality_update()["finalized_header"]["root"] == "0xaa"

    def test_needs_clients(self):
        from spectre_tpu_torch.preprocessor.beacon import BeaconQuorum
        with pytest.raises(ValueError):
            BeaconQuorum([])

    def test_persistent_dissenter_trips_own_breaker(self):
        """demote() rides the real breaker: a beacon outvoted
        `threshold` times in a row drops out of the pool entirely."""
        from spectre_tpu_torch.preprocessor.beacon import BeaconClient
        bc = BeaconClient("http://127.0.0.1:9", breaker_threshold=2,
                          breaker_cooldown=60.0)
        assert bc.breaker_state == "closed"
        bc.demote()
        bc.demote()
        assert bc.breaker_state == "open"


# -- UpdateStore memory bound (10k-period backfill) -------------------------


class TestUpdateStoreBound:
    def test_10k_period_backfill_fits_lru_budget(self, tmp_path):
        """A mainnet-scale backfill (10k committee periods) must replay
        into a BOUNDED resident set: offsets+digests only, full records
        LRU-capped, cache misses reloaded from the journal offset."""
        from spectre_tpu_torch.follower.updates import (UPDATE_SUFFIX, UpdateStore,
                                                  _canonical)
        from spectre_tpu_torch.utils.artifacts import ArtifactStore

        n, cap, probe = 10_000, 256, 1234
        pos = lambda p: f"0x{p:x}"
        art = ArtifactStore(str(tmp_path))
        lines = []
        for p in range(n):
            result = {"proof": "0x01", "instances": ["0x1"],
                      "committee_poseidon": pos(p)}
            if p in (probe, n - 2, n - 1):
                # only the records the test actually reads back (and the
                # tip, which replay re-verifies) need real artifacts
                digest = art.write(_canonical(result), UPDATE_SUFFIX)
            else:
                digest = f"{p:064x}"
            lines.append(json.dumps(
                {"kind": "committee", "period": p, "digest": digest,
                 "committee_poseidon": pos(p),
                 "prev_poseidon": pos(p - 1) if p else None},
                sort_keys=True, separators=(",", ":")))
        with open(tmp_path / "follower.updates.jsonl", "w") as f:
            f.write("\n".join(lines) + "\n")

        ev0 = HEALTH.get("follower_update_cache_evictions")
        tracemalloc.start()
        try:
            store = UpdateStore(str(tmp_path), cache_periods=cap)
            _, peak = tracemalloc.get_traced_memory()
        finally:
            tracemalloc.stop()
        assert peak < 64 * 2**20              # the fixed RSS budget pin
        assert len(store._committee) == n     # every period indexed...
        assert len(store._committee._lru) <= cap   # ...few resident
        assert HEALTH.get("follower_update_cache_evictions") > ev0
        assert store.tip_period() == n - 1
        assert store.anchor_period() == 0
        # a cold period reloads through its journal offset — record AND
        # artifact round-trip
        rec = store.get_committee(probe)
        assert rec["result"]["committee_poseidon"] == pos(probe)
        assert len(store._committee._lru) <= cap

    def test_journal_name_matches_follower(self, tmp_path):
        from spectre_tpu_torch.follower import updates as U
        assert U.JOURNAL_NAME == "follower.updates.jsonl"


# -- farm-aware RPC plumbing ------------------------------------------------


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class _ServeState:
    """Bare state for serve(): the dispatcher replaces the runner, so no
    prove methods are ever touched."""
    concurrency = 1


class TestFarmRpc:
    def test_healthz_and_errors_carry_farm_identity(self, tmp_path):
        """The full acceptance surface over HTTP: serve() with a
        dispatcher -> prove lands on a replica, /healthz grows the
        dispatcher section, RPC errors are stamped with the serving
        replica id (RpcError.replica_id)."""
        from spectre_tpu_torch.prover_service.rpc import serve
        from spectre_tpu_torch.prover_service.rpc_client import (ProverClient,
                                                           RpcError)
        calls = []
        d = Dispatcher([LocalReplica("farm-1", runner=_mk_runner(calls))],
                       journal_dir=str(tmp_path), poll_s=0.005)
        server = serve(_ServeState(), port=0, background=True,
                       journal_dir=str(tmp_path), dispatcher=d,
                       replica_id="head-1")
        port = server.server_address[1]
        try:
            client = ProverClient(f"http://127.0.0.1:{port}", timeout=10)
            assert client._call(METHOD, {"w": 1}) == _result()
            assert len(calls) == 1            # the farm proved it
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/healthz", timeout=5) as resp:
                snap = json.load(resp)
            reps = {r["replica_id"]: r
                    for r in snap["dispatcher"]["replicas"]}
            assert reps["farm-1"]["breaker"]["state"] == "closed"
            assert reps["farm-1"]["dispatched"] == 1
            assert snap["counters"]["dispatcher_jobs_dispatched"] >= 1
            with pytest.raises(RpcError) as exc:
                client.proof_status("no-such-job")
            assert exc.value.code == -32004
            assert exc.value.replica_id == "head-1"
            assert "[replica head-1]" in str(exc.value)
        finally:
            server.shutdown()

    def test_conn_reset_retry_rotates_endpoint(self, tmp_path):
        """A client with several farm frontends retries a connection
        reset against a DIFFERENT endpoint."""
        from spectre_tpu_torch.prover_service.rpc import serve
        from spectre_tpu_torch.prover_service.rpc_client import ProverClient
        dead = f"http://127.0.0.1:{_free_port()}"
        server = serve(_ServeState(), port=0, background=True,
                       journal_dir=str(tmp_path))
        live = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            client = ProverClient([dead, live], timeout=10, conn_retries=1,
                                  sleep=lambda s: None)
            assert client.ping() == "pong"    # refused -> rotate -> live
            assert client.url == live
        finally:
            server.shutdown()

    def test_single_url_client_unchanged(self):
        from spectre_tpu_torch.prover_service.rpc_client import ProverClient
        c = ProverClient("http://127.0.0.1:1")
        assert c.urls == ["http://127.0.0.1:1"]
        assert c.url == "http://127.0.0.1:1"
        with pytest.raises(ValueError):
            ProverClient([])


# -- dynamic membership ------------------------------------------------------


AGG_METHOD = "genEvmProof_AggregationCadence"


class TestMembership:
    def test_register_heartbeat_ttl_lifecycle(self):
        """registerReplica joins the fleet with a capability record;
        re-announces are heartbeats; a member silent past ttl_s is
        demoted through its breaker and deregistered; a re-join keeps
        the open breaker (readmission via the half-open trial)."""
        clk = [0.0]
        d = Dispatcher([], ttl_s=30.0, clock=lambda: clk[0], poll_s=0.005)
        hb0 = HEALTH.get("dispatcher_heartbeats")
        ttl0 = HEALTH.get("dispatcher_member_ttl_expired")
        res = d.register_remote("dyn-1", url="http://127.0.0.1:1",
                                capabilities={"device": "cpu",
                                              "memory_mb": 1024,
                                              "max_k": 17})
        assert res == {"replica_id": "dyn-1", "ttl_s": 30.0, "members": 1}
        row = d.snapshot()["replicas"][0]
        assert row["dynamic"] is True
        assert row["capabilities"]["device"] == "cpu"
        assert row["capabilities"]["max_k"] == 17
        assert row["url"] == "http://127.0.0.1:1"
        assert row["last_heartbeat_age_s"] == 0.0
        clk[0] = 20.0                         # heartbeat refreshes TTL
        d.register_remote("dyn-1", url="http://127.0.0.1:1")
        assert HEALTH.get("dispatcher_heartbeats") == hb0 + 1
        clk[0] = 45.0                         # 25 s since announce: alive
        assert d.sweep_members() == []
        clk[0] = 51.0                         # 31 s: past the TTL
        assert d.sweep_members() == ["dyn-1"]
        assert d.snapshot()["members"] == 0
        assert HEALTH.get("dispatcher_member_ttl_expired") == ttl0 + 1
        assert d.breaker("dyn-1").state == "open"   # demoted, not dropped
        # re-join: membership is back, the breaker history is NOT reset
        d.register_remote("dyn-1", url="http://127.0.0.1:1")
        snap = d.snapshot()
        assert snap["members"] == 1 and snap["dynamic_members"] == 1
        assert d.breaker("dyn-1").state == "open"

    def test_member_journal_replay_and_compaction(self, tmp_path):
        """A dispatcher restart reconstructs the fleet from
        dispatcher.members.jsonl (last join/leave per id wins) and
        compacts it to the replay fixpoint."""
        d1 = Dispatcher([], journal_dir=str(tmp_path), ttl_s=30.0,
                        poll_s=0.005)
        d1.register_remote("m1", url="http://127.0.0.1:9001",
                           capabilities={"max_k": 18,
                                         "mesh_shape": [2, 4]})
        d1.register_remote("m2", url="http://127.0.0.1:9002")
        d1.deregister("m2", reason="drain")
        rep0 = HEALTH.get("dispatcher_members_replayed")
        d2 = Dispatcher([], journal_dir=str(tmp_path), ttl_s=30.0,
                        poll_s=0.005)
        snap = d2.snapshot()
        assert [r["replica_id"] for r in snap["replicas"]] == ["m1"]
        assert snap["replicas"][0]["dynamic"] is True
        assert snap["replicas"][0]["capabilities"]["max_k"] == 18
        assert snap["replicas"][0]["capabilities"]["mesh_shape"] == [2, 4]
        assert HEALTH.get("dispatcher_members_replayed") == rep0 + 1
        lines = [ln for ln in
                 (tmp_path / "dispatcher.members.jsonl").read_text()
                 .splitlines() if ln.strip()]
        assert len(lines) == 1                # compacted to one join
        assert json.loads(lines[0])["replica"] == "m1"

    def test_static_id_never_shadowed_by_journal(self, tmp_path):
        """A statically-registered replica keeps its in-process identity
        even when the member journal remembers a same-named announce."""
        d1 = Dispatcher([], journal_dir=str(tmp_path), poll_s=0.005)
        d1.register_remote("a", url="http://127.0.0.1:9009")
        calls = []
        d2 = Dispatcher([LocalReplica("a", runner=_mk_runner(calls))],
                        journal_dir=str(tmp_path), poll_s=0.005)
        assert d2.dispatch(METHOD, {}) == _result()
        assert len(calls) == 1                # the LOCAL replica proved

    def test_register_fault_site_leaves_fleet_unchanged(self):
        faults.arm("replica.register", "raise", 1)
        d = Dispatcher([], poll_s=0.005)
        with pytest.raises(faults.InjectedFault):
            d.register_remote("x", url="http://127.0.0.1:1")
        assert d.snapshot()["members"] == 0
        d.register_remote("x", url="http://127.0.0.1:1")  # next announce
        assert d.snapshot()["members"] == 1

    def test_register_without_url_rejected(self):
        d = Dispatcher([], poll_s=0.005)
        with pytest.raises(ValueError, match="needs a url"):
            d.register_remote("nourl")

    def test_announce_loop_joins_fleet_over_http(self, tmp_path):
        """Full announce wiring: serve(announce=...) spawns the
        heartbeat loop, the dispatcher head admits the replica with its
        capability record, /healthz lists capability + heartbeat age,
        and /metrics grows the membership gauges."""
        from spectre_tpu_torch.observability.prom import render
        from spectre_tpu_torch.prover_service.rpc import serve
        d = Dispatcher([], journal_dir=str(tmp_path), ttl_s=60.0,
                       poll_s=0.005)
        port = _free_port()
        # the head announces itself to itself: one process exercises
        # both sides of the registerReplica loop
        server = serve(_ServeState(), host="127.0.0.1", port=port,
                       background=True, journal_dir=str(tmp_path),
                       dispatcher=d, replica_id="self-1",
                       announce=f"http://127.0.0.1:{port}",
                       announce_interval=0.05)
        try:
            deadline = time.time() + 120
            while time.time() < deadline and d.snapshot()["members"] == 0:
                time.sleep(0.02)
            snap = d.snapshot()
            assert snap["members"] == 1 and snap["dynamic_members"] == 1
            row = snap["replicas"][0]
            assert row["replica_id"] == "self-1"
            assert row["url"] == f"http://127.0.0.1:{port}"
            assert row["capabilities"]["memory_mb"]   # sysconf-derived
            assert row["last_heartbeat_age_s"] is not None
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/healthz", timeout=5) as resp:
                hz = json.load(resp)
            reps = {x["replica_id"]: x
                    for x in hz["dispatcher"]["replicas"]}
            assert reps["self-1"]["capabilities"]["url"] == \
                f"http://127.0.0.1:{port}"
            assert reps["self-1"]["last_heartbeat_age_s"] is not None
            metrics = render()
            # the membership gauges are a union over every live
            # Dispatcher (weakset registry), so other tests' uncollected
            # dispatchers may inflate the counts — pin OUR replica's
            # sample and a lower bound, not the global total
            assert 'spectre_replica_heartbeat_age_s{replica="self-1"}' \
                in metrics
            dyn = [ln for ln in metrics.splitlines()
                   if ln.startswith('spectre_dispatcher_members'
                                    '{kind="dynamic"}')]
            assert dyn and int(float(dyn[0].split()[-1])) >= 1
        finally:
            server._announce_stop.set()
            server.shutdown()

    def test_announce_failure_tolerated_and_retried(self, tmp_path):
        """An injected announce failure is counted and absorbed — the
        replica keeps serving and the NEXT heartbeat joins it."""
        from spectre_tpu_torch.prover_service.rpc import serve
        faults.arm("replica.announce", "raise", 1)
        d = Dispatcher([], journal_dir=str(tmp_path), ttl_s=60.0,
                       poll_s=0.005)
        port = _free_port()
        af0 = HEALTH.get("replica_announce_failures")
        server = serve(_ServeState(), host="127.0.0.1", port=port,
                       background=True, journal_dir=str(tmp_path),
                       dispatcher=d, replica_id="flaky-1",
                       announce=f"http://127.0.0.1:{port}",
                       announce_interval=0.05)
        try:
            deadline = time.time() + 120
            while time.time() < deadline and d.snapshot()["members"] == 0:
                time.sleep(0.02)
            assert d.snapshot()["members"] == 1
            assert HEALTH.get("replica_announce_failures") == af0 + 1
        finally:
            server._announce_stop.set()
            server.shutdown()


# -- capability-aware placement ----------------------------------------------


class TestPlacement:
    def test_aggregation_routes_to_mesh_or_big_memory(self):
        """Aggregation proves land only on replicas advertising a mesh
        or the largest declared memory — zero fallbacks while one is
        healthy."""
        calls = {r: [] for r in ("plain", "meshy", "big")}
        caps = {"plain": {"memory_mb": 8192},
                "meshy": {"mesh_shape": [2, 4], "memory_mb": 4096},
                "big": {"memory_mb": 65536}}
        d = Dispatcher([LocalReplica(r, runner=_mk_runner(calls[r]),
                                     capabilities=caps[r])
                        for r in calls], poll_s=0.005)
        fb0 = HEALTH.get("dispatcher_placement_fallbacks")
        for i in range(8):
            assert d.dispatch(AGG_METHOD, {"w": i}) == _result()
        assert calls["plain"] == []
        assert len(calls["meshy"]) + len(calls["big"]) == 8
        assert HEALTH.get("dispatcher_placement_fallbacks") == fb0

    def test_max_k_placement(self):
        """k-sized work skips replicas DECLARING a too-small max_k even
        when rendezvous ranks them first."""
        calls = {"tiny": [], "big": []}
        d = Dispatcher([
            LocalReplica("tiny", runner=_mk_runner(calls["tiny"]),
                         capabilities={"max_k": 14}),
            LocalReplica("big", runner=_mk_runner(calls["big"]),
                         capabilities={"max_k": 22})],
            poll_s=0.005, method_k={METHOD: 20})
        params = next({"w": i} for i in range(64)
                      if _ranked_ids(["tiny", "big"],
                                     params={"w": i})[0] == "tiny")
        assert d.dispatch(METHOD, params) == _result()
        assert calls["tiny"] == [] and len(calls["big"]) == 1

    def test_undeclared_capabilities_constrain_nothing(self):
        """A capability-less fleet routes exactly like before — plain
        rendezvous, no fallback accounting."""
        calls = {"a": [], "b": []}
        d = Dispatcher([LocalReplica(r, runner=_mk_runner(calls[r]))
                        for r in calls], poll_s=0.005)
        fb0 = HEALTH.get("dispatcher_placement_fallbacks")
        assert d.dispatch(AGG_METHOD, {"w": 3}) == _result()
        first = _ranked_ids(list(calls), method=AGG_METHOD,
                            params={"w": 3})[0]
        assert len(calls[first]) == 1
        assert HEALTH.get("dispatcher_placement_fallbacks") == fb0

    def test_fallback_counter_when_no_capable_replica_healthy(self):
        """With every eligible replica behind an open breaker, work
        still lands — on the ranked remainder, visibly counted."""
        calls = {"meshy": [], "plain": []}
        d = Dispatcher([
            LocalReplica("meshy", runner=_mk_runner(calls["meshy"]),
                         capabilities={"mesh_shape": [2, 2]}),
            LocalReplica("plain", runner=_mk_runner(calls["plain"]))],
            poll_s=0.005, breaker_threshold=1, breaker_cooldown=60.0)
        d.breaker("meshy").record(False)      # threshold 1 -> open
        fb0 = HEALTH.get("dispatcher_placement_fallbacks")
        assert d.dispatch(AGG_METHOD, {}) == _result()
        assert calls["meshy"] == [] and len(calls["plain"]) == 1
        assert HEALTH.get("dispatcher_placement_fallbacks") == fb0 + 1


# -- hygiene pins -----------------------------------------------------------


class TestFarmHygiene:
    def test_dispatcher_importable_without_torch_or_jax(self):
        """prom.py imports dispatcher_snapshot on every /metrics render
        and the CLI builds a Dispatcher before any prove: the module pulls
        in neither torch nor jax at import time."""
        probe = (
            "import builtins\n"
            "real = builtins.__import__\n"
            "def guard(name, *a, **k):\n"
            "    assert name.split('.')[0] not in ('jax', 'torch', 'spectre_tpu'), name\n"
            "    return real(name, *a, **k)\n"
            "builtins.__import__ = guard\n"
            "import spectre_tpu_torch.prover_service.dispatcher\n"
            "import spectre_tpu_torch.utils.breaker\n"
            "print('ok')\n"
        )
        out = subprocess.run(
            [sys.executable, "-c", probe], capture_output=True, text=True,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == "ok"

    def test_fault_sites_name_the_port_modules(self):
        """The farm's fault sites are registered under the port's modules,
        where they fire."""
        for site, path in (("replica.dispatch", "prover_service/dispatcher.py"),
                           ("replica.register", "prover_service/dispatcher.py"),
                           ("replica.announce", "prover_service/rpc.py"),
                           ("follower.journal", "follower/updates.py"),
                           ("gateway.pack_write", "gateway/packs.py")):
            assert faults.SITES[site][0] == "spectre_tpu_torch/" + path

    def test_fault_sites_documented(self):
        for site in ("replica.dispatch", "replica.health", "replica.lease",
                     "replica.register", "replica.announce"):
            assert site in faults.SITES


# -- the port against the reference --------------------------------------------

from spectre_tpu.prover_service import dispatcher as rdisp          # noqa: E402
from spectre_tpu.prover_service import rpc as rrpc                  # noqa: E402
from spectre_tpu.prover_service import rpc_client as rclient        # noqa: E402
from spectre_tpu.utils import faults as rfaults                     # noqa: E402
from spectre_tpu.utils.health import HEALTH as RHEALTH              # noqa: E402
from spectre_tpu_torch.prover_service import dispatcher as pdisp     # noqa: E402
from spectre_tpu_torch.prover_service import rpc as prpc             # noqa: E402
from spectre_tpu_torch.prover_service import rpc_client as pclient   # noqa: E402

PACKAGES = {"port": pdisp, "reference": rdisp}
COMMITTEE = "genEvmProof_CommitteeUpdateCompressed"
ROUTE_CAPS = {"r-small": {"max_k": 21, "memory_mb": 4096},
              "r-big": {"max_k": 22, "memory_mb": 81920},
              "r-mesh": {"mesh_shape": [2, 2], "max_k": 22},
              "r-plain": None}


class _CompressState:
    """A compressing state's k knobs: the port's per-variant aggregation k
    (the tracked testnet verifiers' degrees)."""
    k_step, k_committee, compress = 21, 18, True
    k_agg = {"step": 21, "committee": 22}
    device = torch.device("cuda")


def _route_farm(mod, **kw):
    return mod.Dispatcher([mod.LocalReplica(rid, runner=_mk_runner([]), capabilities=caps)
                           for rid, caps in ROUTE_CAPS.items()], poll_s=0.005, **kw)


class TestAgainstReference:
    def test_rendezvous_routing_equal_over_1000_digests(self):
        """The same replica ids and capability records route 1,000 seeded
        digests to the same replica in both packages, for the step, the
        committee and the aggregation methods. The port reads its state's
        per-variant aggregation k (21 for the step, 22 for the committee);
        the reference, whose k_agg is one int, is given them explicitly."""
        port = _route_farm(pdisp, verify_state=_CompressState())
        ref = _route_farm(rdisp, method_k={METHOD: 21, COMMITTEE: 22, AGG_METHOD: 22})
        assert port._method_k(METHOD) == 21 and port._method_k(COMMITTEE) == 22
        rng = __import__("random").Random(11)
        picks = {}
        for method in (METHOD, COMMITTEE, AGG_METHOD):
            for _ in range(1000):
                digest = "%064x" % rng.getrandbits(256)
                a = port._route(method, digest, set()).replica_id
                b = ref._route(method, digest, set()).replica_id
                assert a == b, (method, digest)
                picks.setdefault(method, set()).add(a)
        # the k filter and the aggregation's placement really constrained
        assert "r-small" not in picks[COMMITTEE] and "r-small" in picks[METHOD]
        assert picks[AGG_METHOD] <= {"r-big", "r-mesh"}

    def test_capability_record_reads_per_variant_k_agg_and_device(self):
        """The port's record names the state's torch device type and takes
        the largest k over the app circuits and both aggregation circuits;
        the reference's drops a per-variant k_agg (its isinstance(k, int))."""
        rec = pdisp.capability_record(_CompressState(), url="http://x")
        assert rec["device"] == "cuda" and rec["max_k"] == 22 and rec["url"] == "http://x"
        ref_rec = rdisp.capability_record(_CompressState(), url="http://x")
        assert ref_rec["max_k"] == 21
        cpu = pdisp.capability_record(type("S", (), {"device": torch.device("cpu"),
                                                     "k_step": 6, "k_committee": 7})())
        assert cpu["device"] == "cpu" and cpu["max_k"] == 7

    @pytest.mark.parametrize("writer,reader", [("port", "reference"), ("reference", "port")])
    def test_lease_journal_replays_in_the_other_package(self, tmp_path, writer, reader):
        """A lease journal written by one package's Dispatcher (a done
        lease, a failed one, an open one) replays in the other to the same
        exclusions and takeovers, and compacts to the same bytes."""
        w = PACKAGES[writer]
        ddir = tmp_path / "w"

        def flaky(method, params, heartbeat=None):
            raise ConnectionError("replica went away")

        ids = _ranked_ids(["a", "b"], params={"w": 2})
        d = w.Dispatcher([w.LocalReplica(ids[0], runner=flaky),
                          w.LocalReplica(ids[1], runner=_mk_runner([]))],
                         journal_dir=str(ddir), poll_s=0.005)
        d.dispatch(METHOD, {"w": 1})                 # done (or failed + done)
        d.dispatch(METHOD, {"w": 2})                 # ids[0] fails, ids[1] proves
        d._grant("feed" * 16, ids[1], takeover=False)   # open at the crash
        copies = {}
        for name in ("port", "reference"):
            dst = tmp_path / name
            dst.mkdir()
            (dst / "dispatcher.leases.jsonl").write_bytes(
                (ddir / "dispatcher.leases.jsonl").read_bytes())
            copies[name] = PACKAGES[name].Dispatcher(
                [PACKAGES[name].LocalReplica(r, runner=_mk_runner([])) for r in ("a", "b")],
                journal_dir=str(dst), poll_s=0.005)
        mine, theirs = copies[writer], copies[reader]
        assert theirs._excluded == mine._excluded
        assert theirs._takeover_due == mine._takeover_due == {"feed" * 16}
        assert any(ids[0] in v for v in theirs._excluded.values())
        assert (tmp_path / "port" / "dispatcher.leases.jsonl").read_bytes() == \
            (tmp_path / "reference" / "dispatcher.leases.jsonl").read_bytes()

    @pytest.mark.parametrize("writer,reader", [("port", "reference"), ("reference", "port")])
    def test_member_journal_replays_in_the_other_package(self, tmp_path, writer, reader):
        """Joins and leaves journaled by one package rebuild the same fleet,
        capability records included, in the other."""
        w, r = PACKAGES[writer], PACKAGES[reader]
        d = w.Dispatcher([], journal_dir=str(tmp_path), ttl_s=30.0, poll_s=0.005)
        d.register_remote("m1", url="http://127.0.0.1:9001",
                          capabilities={"device": "cuda", "max_k": 22, "memory_mb": 81559.0,
                                        "mesh_shape": [1]})
        d.register_remote("m2", url="http://127.0.0.1:9002")
        d.register_remote("m3", url="http://127.0.0.1:9003", capabilities={"max_k": 18})
        d.deregister("m2", reason="drain")
        got = r.Dispatcher([], journal_dir=str(tmp_path), ttl_s=30.0, poll_s=0.005).snapshot()
        want = w.Dispatcher([], journal_dir=str(tmp_path), ttl_s=30.0,
                            poll_s=0.005).snapshot()
        keys = ("replica_id", "dynamic", "capabilities", "url")
        assert [{k: x[k] for k in keys} for x in got["replicas"]] == \
            [{k: x[k] for k in keys} for x in want["replicas"]]
        assert [x["replica_id"] for x in got["replicas"]] == ["m1", "m3"]
        assert got["replicas"][0]["capabilities"]["device"] == "cuda"

    def test_both_clients_drive_both_heads(self, tmp_path):
        """Either package's client proves through either package's farm
        head, reads its dispatcher section, registers a replica and gets
        errors stamped with the head's replica id."""
        heads = {}
        port_d = pdisp.Dispatcher([pdisp.LocalReplica("farm-p", runner=_mk_runner([]))],
                                  journal_dir=str(tmp_path / "p"), poll_s=0.005)
        ref_d = rdisp.Dispatcher([rdisp.LocalReplica("farm-p", runner=_mk_runner([]))],
                                 journal_dir=str(tmp_path / "r"), poll_s=0.005)
        heads["port"] = prpc.serve(_ServeState(), port=0, background=True,
                                   journal_dir=str(tmp_path / "p"), dispatcher=port_d,
                                   replica_id="head-port")
        heads["reference"] = rrpc.serve(_ServeState(), port=0, background=True,
                                        journal_dir=str(tmp_path / "r"), dispatcher=ref_d,
                                        replica_id="head-reference")
        try:
            for head, srv in heads.items():
                url = f"http://127.0.0.1:{srv.server_address[1]}"
                for client_mod in (pclient, rclient):
                    c = client_mod.ProverClient(url, timeout=30)
                    assert c._call(METHOD, {"w": head}) == _result()
                    reps = c.health()["dispatcher"]["replicas"]
                    assert [x["replica_id"] for x in reps][0] == "farm-p"
                    res = c._call("registerReplica", {"replica_id": "dyn",
                                                      "url": "http://127.0.0.1:1"})
                    assert res["replica_id"] == "dyn" and res["members"] == 2
                    with pytest.raises(client_mod.RpcError) as exc:
                        c.proof_status("no-such-job")
                    assert exc.value.code == -32004
                    assert exc.value.replica_id == f"head-{head}"
        finally:
            for srv in heads.values():
                srv.shutdown()


# -- a real prove through the port's farm ---------------------------------------


def _seeded(seed):
    from spectre_tpu_torch.fields import bn254
    r = __import__("random").Random(seed)
    return lambda: r.randrange(bn254.R)


class _TinyState:
    """Proves the K=6 readiness circuit on the CPU with seeded blinding,
    whatever the request, and verifies for real."""

    device = torch.device("cpu")
    concurrency = 1
    compress = False

    def __init__(self):
        from spectre_tpu_torch import spec as SPEC
        self.spec = SPEC.TINY
        self.proves = 0

    def prove_step(self, args, heartbeat=None):
        from spectre_tpu_torch.plonk.prover import prove
        from spectre_tpu_torch.prover_service.selfverify import _tiny_setup
        self.proves += 1
        pk, srs, asg, out = _tiny_setup("cpu")
        return prove(pk, srs, asg, device="cpu", blinding_rng=_seeded(0xFA12)), [out]

    def verify_proof(self, kind, proof, instances):
        from spectre_tpu_torch.plonk.verifier import verify
        from spectre_tpu_torch.prover_service.selfverify import _tiny_setup
        pk, srs, _, _ = _tiny_setup("cpu")
        return verify(pk.vk, srs, [instances], proof)


def test_k6_prove_through_the_farm_after_one_takeover_equals_reference(monkeypatch):
    """One K=6 prove through a port Dispatcher over two LocalReplicas with
    replica.dispatch:crash:1: one takeover, the surviving replica proves
    once, the head cross-verifies, and the bytes are the reference's under
    the same seeded blinding."""
    from _torch_service_params import step_params
    from spectre_tpu.plonk import backend as RB
    from spectre_tpu.plonk.prover import prove as ref_prove
    from spectre_tpu.prover_service.selfverify import _tiny_setup as ref_tiny_setup
    from spectre_tpu_torch import spec as SPEC
    from spectre_tpu_torch.witness import default_sync_step_args

    monkeypatch.setenv("SPECTRE_SELF_VERIFY", "always")
    params = step_params(default_sync_step_args(SPEC.TINY))
    states = {rid: _TinyState() for rid in ("rep-a", "rep-b")}
    head = _TinyState()
    d = Dispatcher([LocalReplica(rid, state=st) for rid, st in states.items()],
                   lease_s=300.0, poll_s=0.005, verify_state=head)
    take0 = HEALTH.get("dispatcher_lease_takeovers")
    xv0 = HEALTH.get("proofs_cross_verified")
    monkeypatch.setenv("SPECTRE_FAULT_PLAN", "replica.dispatch:crash:1")
    res = d.dispatch(METHOD, params)
    assert faults.fired_count("replica.dispatch") == 1
    assert HEALTH.get("dispatcher_lease_takeovers") == take0 + 1
    assert HEALTH.get("proofs_cross_verified") == xv0 + 1
    assert sorted(st.proves for st in states.values()) == [0, 1]
    pk, srs, asg, out = ref_tiny_setup()
    want = ref_prove(pk, srs, asg, RB.get_backend("cpu"), blinding_rng=_seeded(0xFA12))
    assert bytes.fromhex(res["proof"][2:]) == want
    assert res["instances"] == [hex(out)]


# -- heartbeats at a prove's phase boundaries ------------------------------------


@pytest.mark.parametrize("compress", [False, True], ids=["snark", "compressed"])
def test_lease_shorter_than_the_prove_holds_across_its_phases(tmp_path, monkeypatch, compress):
    """A LocalReplica prove on a ProverState whose every phase (witness,
    layout, prove; the aggregation's build, layout and prove too when
    compressing) takes 40 s of the dispatcher's clock: the whole prove is
    120-240 s, the lease 60 s. The state stamps the heartbeat at every
    phase boundary, so the lease never lapses: 0 takeovers, 0 expiries,
    and no gap the dispatcher saw exceeds one phase."""
    import types

    from _torch_service_params import committee_params
    from spectre_tpu_torch import spec as SPEC
    from spectre_tpu_torch.prover_service import selfverify
    from spectre_tpu_torch.prover_service.state import ProverState
    from spectre_tpu_torch.witness import default_committee_update_args

    monkeypatch.setenv("SPECTRE_SELF_VERIFY", "always")
    clk = [0.0]

    def phase_costs_40s():
        clk[0] += 40.0

    def stub(name):
        class Stub:
            @classmethod
            def create_pk(cls, srs, spec, k, dummy_args, device=None, cache=False,
                          cache_dir=None):
                return types.SimpleNamespace(vk=types.SimpleNamespace(config=None))

            @classmethod
            def build_context(cls, args, spec, device=None):
                phase_costs_40s()
                return types.SimpleNamespace(layout=lambda cfg: phase_costs_40s())

            @classmethod
            def prove(cls, pk, srs, args, spec, device=None, ctx=None, timer=None,
                      transcript=None):
                phase_costs_40s()
                return b"\x05" * 32

            @classmethod
            def get_instances(cls, args, spec):
                return list(range(1, 15))   # 12 limbs + the app's

            @classmethod
            def verify(cls, vk, srs, instances, proof, device=None, transcript_cls=None):
                return True

            @classmethod
            def variant(cls, name):
                return cls
        Stub.name = name
        return Stub

    class PhasedState(ProverState):
        step_circuit = stub("sync_step")
        committee_circuit = stub("committee_update")
        aggregation_circuit = stub("aggregation")

    st = PhasedState(SPEC.TINY, 6, 6, device="cpu", params_dir=str(tmp_path),
                     key_args={"step": None, "committee": None}, compress=compress,
                     k_agg=6, self_check=selfverify.SelfCheck(runner=lambda: True))
    gaps, last = [], [0.0]

    def heartbeat():
        gaps.append(clk[0] - last[0])
        last[0] = clk[0]

    d = Dispatcher([LocalReplica("card", state=st)], lease_s=60.0, poll_s=0.005,
                   clock=lambda: clk[0])
    take0 = HEALTH.get("dispatcher_lease_takeovers")
    exp0 = HEALTH.get("dispatcher_lease_expired")
    params = committee_params(default_committee_update_args(SPEC.TINY))
    res = d.dispatch(COMMITTEE, params, heartbeat=heartbeat)
    assert res["proof"] == "0x" + "05" * 32
    assert clk[0] == (240.0 if compress else 120.0) > d.lease_s
    assert HEALTH.get("dispatcher_lease_takeovers") == take0
    assert HEALTH.get("dispatcher_lease_expired") == exp0
    assert max(gaps) <= 40.0


def test_aggregation_build_longer_than_the_default_lease_holds_it(tmp_path, monkeypatch):
    """A compressing LocalReplica whose aggregation build takes 150 s of the
    dispatcher's clock, past the default 120 s lease, every other phase 40
    s: the state hands the build its heartbeat (AggregationArgs.heartbeat),
    which the build stamps between its steps (transcript, MSM terms,
    pairing inputs; 50 s each here), so the lease never lapses: 0
    takeovers, 0 expiries, one prove, and no gap between two of the
    state's stamps longer than the lease."""
    import types

    from _torch_service_params import committee_params
    from spectre_tpu_torch import spec as SPEC
    from spectre_tpu_torch.models.aggregation import AggregationArgs
    from spectre_tpu_torch.prover_service import selfverify
    from spectre_tpu_torch.prover_service.state import ProverState
    from spectre_tpu_torch.witness import default_committee_update_args

    monkeypatch.setenv("SPECTRE_SELF_VERIFY", "always")
    monkeypatch.delenv("SPECTRE_REPLICA_LEASE_S", raising=False)
    clk = [0.0]

    def costs(seconds):
        clk[0] += seconds

    def stub(name):
        class Stub:
            @classmethod
            def create_pk(cls, srs, spec, k, dummy_args, device=None, cache=False,
                          cache_dir=None):
                return types.SimpleNamespace(vk=types.SimpleNamespace(config=None))

            @classmethod
            def build_context(cls, args, spec, device=None):
                if isinstance(args, AggregationArgs):
                    for _ in range(3):        # transcript, MSM terms, pairing inputs
                        costs(50.0)
                        if args.heartbeat is not None:
                            args.heartbeat()
                else:
                    costs(40.0)
                return types.SimpleNamespace(layout=lambda cfg: costs(40.0))

            @classmethod
            def prove(cls, pk, srs, args, spec, device=None, ctx=None, timer=None,
                      transcript=None):
                costs(40.0)
                return b"\x06" * 32

            @classmethod
            def get_instances(cls, args, spec):
                return list(range(1, 15))   # 12 limbs + the app's

            @classmethod
            def verify(cls, vk, srs, instances, proof, device=None, transcript_cls=None):
                return True

            @classmethod
            def variant(cls, name):
                return cls
        Stub.name = name
        return Stub

    stamps, proves = [], []

    class PhasedState(ProverState):
        step_circuit = stub("sync_step")
        committee_circuit = stub("committee_update")
        aggregation_circuit = stub("aggregation")

        def prove_committee(self, args, heartbeat=None):
            proves.append(clk[0])

            def stamp():
                stamps.append(clk[0])
                heartbeat()
            return super().prove_committee(args, heartbeat=stamp)

    st = PhasedState(SPEC.TINY, 6, 6, device="cpu", params_dir=str(tmp_path),
                     key_args={"step": None, "committee": None}, compress=True,
                     k_agg=6, self_check=selfverify.SelfCheck(runner=lambda: True))
    d = Dispatcher([LocalReplica("card", state=st)], poll_s=0.005, clock=lambda: clk[0])
    take0 = HEALTH.get("dispatcher_lease_takeovers")
    exp0 = HEALTH.get("dispatcher_lease_expired")
    params = committee_params(default_committee_update_args(SPEC.TINY))
    res = d.dispatch(COMMITTEE, params)
    assert res["proof"] == "0x" + "06" * 32
    assert d.lease_s == 120.0
    assert clk[0] == 3 * 40.0 + 150.0 + 2 * 40.0
    assert HEALTH.get("dispatcher_lease_takeovers") == take0
    assert HEALTH.get("dispatcher_lease_expired") == exp0
    assert proves == [0.0]
    marks = [0.0, *stamps, clk[0]]
    gaps = [b - a for a, b in zip(marks, marks[1:])]
    assert max(gaps) <= 50.0 < d.lease_s


# -- the CLI's farm flags ------------------------------------------------------


class _FakeProverState:
    """Records how the CLI boots its state; proves nothing."""
    booted = []

    def __init__(self, spec, k_step, k_committee, concurrency, device, **kw):
        self.spec, self.device, self.concurrency = spec, device, concurrency
        self.k_step, self.k_committee = k_step, k_committee
        self.boot_seconds, self.jobs = {}, None
        _FakeProverState.booted.append(dict(device=device, **kw))


def test_rpc_cli_farm_flags_make_a_dispatcher_head(monkeypatch, tmp_path):
    """`rpc --replicas ... --lease-s ... --ttl-s ...` boots the state on the
    card by default and serves it as a farm head over HttpReplicas;
    --replica-id and the announce flags reach serve()."""
    from spectre_tpu_torch.prover_service import cli, rpc as prpc_mod, state as pstate

    served = {}
    monkeypatch.setattr(pstate, "ProverState", _FakeProverState)
    monkeypatch.setattr(prpc_mod, "serve", lambda state, host, port, **kw: served.update(
        state=state, host=host, port=port, **kw))
    _FakeProverState.booted.clear()
    cli.main(["rpc", "--replicas", "http://10.0.0.1:3000, http://10.0.0.2:3000",
              "--replica-id", "head-1", "--lease-s", "45", "--ttl-s", "20",
              "--announce-to", "http://10.0.0.9:3000", "--announce-interval", "3",
              "--advertise-url", "http://me:3000", "--params-dir", str(tmp_path)])
    assert _FakeProverState.booted[0]["device"] == "cuda"
    d = served["dispatcher"]
    assert [r.replica_id for r in d.replicas] == ["http://10.0.0.1:3000", "http://10.0.0.2:3000"]
    assert all(isinstance(r, HttpReplica) for r in d.replicas)
    assert (d.lease_s, d.ttl_s, d.verify_state) == (45.0, 20.0, served["state"])
    assert (served["replica_id"], served["announce"], served["announce_interval"],
            served["advertise_url"]) == ("head-1", "http://10.0.0.9:3000", 3.0, "http://me:3000")
    assert d._journal_path == os.path.join(str(tmp_path), "dispatcher.leases.jsonl")

    served.clear()
    cli.main(["rpc", "--device", "cpu"])
    assert _FakeProverState.booted[-1]["device"] == "cpu"
    assert served["dispatcher"] is None and served["announce"] is None
