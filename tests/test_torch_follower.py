"""The port's follower (`spectre_tpu_torch/follower/`) against the
reference's (`spectre_tpu/follower/`).

The reference's drills (`tests/test_follower.py`), case for case, on the
port: a fixture-backed fake beacon synthesizes valid light-client updates
(mock-rooted branches and real BLS aggregate signatures, parameterized by
slot and period), so the follower runs the port's preprocessor on the CPU
against a canned-proof state. An unbroken verified update chain across
period boundaries, kill-mid-prove crash replay resuming the chain with
byte-identical stored updates, a cache-hit serving path that never touches
the prover, the beacon-outage degrade/recover loop, the corrupt-update and
diskfull drills, chain order, the tracker, and the aggregation cadence
published through the port's EVM verifier.

Then the port against the reference on the same seeded inputs: an update
store written by either package is read by the other with equal digests,
and both followers, over the same scripted beacon and canned jobs, submit
the same (method, params) sequence and store the same chain.
"""

import json
import threading
import time
import urllib.request

import pytest
import torch

from spectre_tpu_torch import spec as SP
from spectre_tpu_torch.fields import bls12_381 as bls
from spectre_tpu_torch.follower import (ChainOrderError, Follower, UpdateStore,
                                  follower_snapshot)
from spectre_tpu_torch.follower.scheduler import ProofScheduler
from spectre_tpu_torch.follower.tracker import CommitteeUpdateDue, HeadTracker
from spectre_tpu_torch.models import CommitteeUpdateCircuit, StepCircuit
from spectre_tpu_torch.prover_service.jobs import JobQueue
from spectre_tpu_torch.prover_service.rpc import run_proof_method
from spectre_tpu_torch.utils import faults
from spectre_tpu_torch.utils.health import HEALTH
from spectre_tpu_torch.witness.rotation import mock_root
from spectre_tpu_torch.witness.types import (BeaconBlockHeader, CommitteeUpdateArgs,
                                       SyncStepArgs)

TINY = SP.TINY            # 2 validators, 64 slots per sync period
STEP_SEED = 1234
DOMAIN = b"\x07" * 32


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


def _counter(name: str) -> int:
    return HEALTH.snapshot()["counters"].get(name, 0)


# -- fixture beacon ----------------------------------------------------------

def _hdr_dict(h: BeaconBlockHeader) -> dict:
    return {"slot": h.slot, "proposer_index": h.proposer_index,
            "parent_root": "0x" + h.parent_root.hex(),
            "state_root": "0x" + h.state_root.hex(),
            "body_root": "0x" + h.body_root.hex()}


def _step_sks(spec):
    return [STEP_SEED * 7919 + i + 1 for i in range(spec.sync_committee_size)]


def _step_pubkeys_hex(spec):
    return ["0x" + bls.g1_compress(bls.sk_to_pk(sk)).hex()
            for sk in _step_sks(spec)]


def _mk_finality_update(spec, fin_slot: int) -> dict:
    """A valid LightClientFinalityUpdate for `fin_slot`: mock-rooted
    finality/execution branches, really signed by the deterministic
    step committee (witness/step.py parameterized by slot)."""
    sks = _step_sks(spec)
    finalized = BeaconBlockHeader(
        slot=fin_slot, proposer_index=3, parent_root=b"\x33" * 32,
        state_root=b"\x44" * 32, body_root=b"\x00" * 32)
    exec_root = b"\x55" * 32
    exec_branch = [bytes([0xA0 + d]) * 32
                   for d in range(spec.execution_state_root_depth)]
    finalized.body_root = mock_root(exec_root, exec_branch,
                                    spec.execution_state_root_index)
    fin_branch = [bytes([0xB0 + d]) * 32
                  for d in range(spec.finalized_header_depth)]
    attested = BeaconBlockHeader(
        slot=fin_slot + 2, proposer_index=11, parent_root=b"\x66" * 32,
        state_root=mock_root(finalized.hash_tree_root(), fin_branch,
                             spec.finalized_header_index),
        body_root=b"\x77" * 32)
    args = SyncStepArgs(
        pubkeys_uncompressed=[(int(x), int(y)) for x, y in
                              (bls.sk_to_pk(sk) for sk in sks)],
        participation_bits=[1] * spec.sync_committee_size,
        attested_header=attested, finalized_header=finalized,
        finality_branch=fin_branch, execution_payload_root=exec_root,
        execution_payload_branch=exec_branch, domain=DOMAIN)
    msg = bls.hash_to_g2(args.signing_root(), spec.dst)
    sig = bls.aggregate_signatures([bls.g2_curve.mul(msg, sk) for sk in sks])
    return {
        "attested_header": _hdr_dict(attested),
        "finalized_header": _hdr_dict(finalized),
        "finality_branch": ["0x" + b.hex() for b in fin_branch],
        "execution_payload_root": "0x" + exec_root.hex(),
        "execution_branch": ["0x" + b.hex() for b in exec_branch],
        "sync_aggregate": {
            "sync_committee_bits": [1] * spec.sync_committee_size,
            "sync_committee_signature":
                "0x" + bls.g2_compress(sig).hex(),
        },
    }


def _mk_committee_update(spec, period: int) -> dict:
    """A valid committee update for `period` (distinct committee per
    period — witness/rotation.py parameterized by seed). The branch is
    built at pubkeys depth so no aggregate-pubkey extension is needed."""
    seed = 1000 * (period + 1)
    n = spec.sync_committee_size
    pks = [bls.sk_to_pk(seed + i + 1) for i in range(n)]
    pubkeys = [bls.g1_compress(p) for p in pks]
    args = CommitteeUpdateArgs(pubkeys_compressed=pubkeys)
    branch = [bytes([(period + d) % 251]) * 32
              for d in range(spec.sync_committee_pubkeys_depth)]
    state_root = mock_root(args.committee_pubkeys_root(), branch,
                           spec.sync_committee_pubkeys_root_index)
    finalized = BeaconBlockHeader(
        slot=period * spec.slots_per_period + 1, proposer_index=7,
        parent_root=b"\x11" * 32, state_root=state_root,
        body_root=b"\x22" * 32)
    agg = bls.g1_compress(bls.aggregate_pubkeys(pks)) \
        if hasattr(bls, "aggregate_pubkeys") else pubkeys[0]
    return {
        "finalized_header": _hdr_dict(finalized),
        "next_sync_committee": {
            "pubkeys": ["0x" + pk.hex() for pk in pubkeys],
            "aggregate_pubkey": "0x" + agg.hex(),
        },
        "next_sync_committee_branch": ["0x" + b.hex() for b in branch],
    }


class FakeBeacon:
    """Duck-typed BeaconClient: deterministic valid updates, an
    `outage` switch for the degrade drill."""

    def __init__(self, spec, fin_slot: int):
        self.spec = spec
        self.fin_slot = fin_slot
        self.outage = False
        self._fin_cache: dict[int, dict] = {}
        self._com_cache: dict[int, dict] = {}

    def advance(self, fin_slot: int):
        self.fin_slot = fin_slot

    def finality_update(self) -> dict:
        if self.outage:
            raise OSError("beacon down")
        if self.fin_slot not in self._fin_cache:
            self._fin_cache[self.fin_slot] = _mk_finality_update(
                self.spec, self.fin_slot)
        return self._fin_cache[self.fin_slot]

    def committee_updates(self, period: int, count: int = 1) -> list:
        if self.outage:
            raise OSError("beacon down")
        if period not in self._com_cache:
            self._com_cache[period] = _mk_committee_update(self.spec, period)
        return [self._com_cache[period]]


# -- canned-proof state ------------------------------------------------------

class _FollowerState:
    """Canned prover (proving for real is minutes): real get_instances,
    fault-checkable at `backend.prove` for the crash drill, counts every
    prove call so the cache-hit pin can assert the prover was idle. Its
    device is the CPU: the step's preprocessing decompresses the committee's
    pubkeys there."""

    device = torch.device("cpu")

    def __init__(self, spec):
        self.spec = spec
        self.concurrency = 1
        self.calls = 0

    def prove_step(self, args):
        faults.check("backend.prove")
        self.calls += 1
        return b"\x01" * 64, StepCircuit.get_instances(args, self.spec)

    def prove_committee(self, args):
        faults.check("backend.prove")
        self.calls += 1
        return (b"\x02" * 64,
                CommitteeUpdateCircuit.get_instances(args, self.spec))


def _mk_queue(state, journal_dir, **kw):
    runner = lambda method, params, heartbeat=None: \
        run_proof_method(state, method, params, heartbeat=heartbeat)
    return JobQueue(runner, concurrency=1, journal_dir=str(journal_dir),
                    stall_timeout=600.0, **kw)


def _stop_queue(jobs, timeout: float = 120.0):
    """Stop a queue and wait for its workers: a job still in flight would
    otherwise run on into the interpreter's exit (a daemon thread inside
    torch's C++ code there aborts the process)."""
    jobs.stop()
    for slot in jobs._slots:
        t = slot["thread"]
        if t is not None and t is not __import__("threading").current_thread():
            t.join(timeout)


def _drive(follower, predicate, timeout_s: float = 600.0, sleep_s: float = 0.02):
    """run_once until `predicate()` (jobs finish on worker threads). A
    deadline, not a count of cycles: the step's preprocessing (the port's
    plain decompression and the native pairing check) takes seconds a job
    when six test workers share the host."""
    deadline = time.monotonic() + timeout_s
    while True:
        follower.run_once()
        if predicate():
            return
        if time.monotonic() > deadline:
            raise AssertionError("follower did not converge")
        time.sleep(sleep_s)


class _ScriptedJob:
    def __init__(self, jid, result):
        self.id = jid
        self.result = result
        self.manifest_digest = None


class ScriptedJobs:
    """Duck-typed JobQueue whose completions the test scripts by hand —
    the only way to pin out-of-order completion deterministically."""

    def __init__(self):
        self._status: dict[str, str] = {}
        self._results: dict[str, _ScriptedJob] = {}
        self._n = 0

    def submit(self, method, params) -> str:
        self._n += 1
        jid = f"j{self._n}"
        self._status[jid] = "running"
        return jid

    def status(self, jid):
        return {"status": self._status[jid]}

    def result(self, jid):
        return self._results.get(jid)

    def finish(self, jid, result: dict):
        self._status[jid] = "done"
        self._results[jid] = _ScriptedJob(jid, result)


# -- drills ------------------------------------------------------------------

class TestFollowerChain:
    def test_unbroken_chain_across_period_boundaries(self, tmp_path):
        """Acceptance: a beacon advanced across >=2 period boundaries
        yields an unbroken verified update chain + the head step proof;
        the lag gauges return to zero."""
        state = _FollowerState(TINY)
        jobs = _mk_queue(state, tmp_path)
        beacon = FakeBeacon(TINY, fin_slot=80)           # period 1
        fol = Follower(TINY, beacon, jobs, directory=str(tmp_path),
                       pubkeys=_step_pubkeys_hex(TINY), domain=DOMAIN)
        try:
            for fin_slot in (80, 144, 208):              # periods 1, 2, 3
                beacon.advance(fin_slot)
                period = TINY.sync_period(fin_slot)
                _drive(fol, lambda: fol.store.has_committee(period)
                       and fol.store.has_step(fin_slot))
            assert fol.store.tip_period() == 3
            assert sorted(fol.store._committee) == [1, 2, 3]
            assert fol.store.verify_chain()
            # linkage: each record carries its predecessor's poseidon
            for p in (2, 3):
                rec = fol.store.get_committee(p)
                prev = fol.store.get_committee(p - 1)
                assert rec["prev_poseidon"] == \
                    prev["result"]["committee_poseidon"]
            assert fol.tracker.head_lag_slots == 0
            assert fol.tracker.periods_behind == 0
            assert fol.scheduler.backlog == 0
            # provenance linkage: stored records point at their job +
            # manifest (manifest may be None for a journal-less queue,
            # but the job id is always threaded through)
            assert fol.store.get_committee(3)["job_id"]
        finally:
            _stop_queue(jobs)

    def test_crash_mid_prove_replay_resumes_chain_byte_identical(
            self, tmp_path):
        """Acceptance: kill mid-prove, journal replay resumes the chain,
        stored updates byte-identical to an uninterrupted run."""
        beacon = FakeBeacon(TINY, fin_slot=80)

        # reference: an uninterrupted run in its own directory
        ref_dir = tmp_path / "ref"
        state_ref = _FollowerState(TINY)
        jobs_ref = _mk_queue(state_ref, ref_dir)
        fol_ref = Follower(TINY, beacon, jobs_ref, directory=str(ref_dir))
        _drive(fol_ref, lambda: fol_ref.store.has_committee(1))
        ref_rec = fol_ref.store._committee[1]
        _stop_queue(jobs_ref)

        # crash run: the first prove dies mid-flight (InjectedCrash is a
        # BaseException — the worker thread is killed, the job stays
        # `running` in the journal, exactly a SIGKILL's footprint)
        run_dir = tmp_path / "run"
        state_a = _FollowerState(TINY)
        jobs_a = _mk_queue(state_a, run_dir)
        fol_a = Follower(TINY, beacon, jobs_a, directory=str(run_dir))
        faults.install_plan("backend.prove:crash:1")
        fol_a.run_once()                        # poll + submit
        deadline = time.time() + 120.0
        while faults.fired_count("backend.prove") < 1:
            assert time.time() < deadline, "crash fault never fired"
            time.sleep(0.01)
        time.sleep(0.05)                        # let the worker die
        assert not fol_a.store.has_committee(1)
        _stop_queue(jobs_a)

        # restart: replay requeues the running job; a fresh follower on
        # the same directory re-derives the missing period and the
        # witness-digest dedup hands it the SAME job
        state_b = _FollowerState(TINY)
        jobs_b = _mk_queue(state_b, run_dir)
        fol_b = Follower(TINY, beacon, jobs_b, directory=str(run_dir))
        try:
            _drive(fol_b, lambda: fol_b.store.has_committee(1))
            assert fol_b.store.verify_chain()
            rec = fol_b.store._committee[1]
            # content-addressed: digest equality IS byte equality
            assert rec["digest"] == ref_rec["digest"]
            assert rec["committee_poseidon"] == ref_rec["committee_poseidon"]
        finally:
            _stop_queue(jobs_b)

    def test_restart_replays_journal_and_serves_without_reproving(
            self, tmp_path):
        """A restarted UpdateStore replays its journal, re-verifies the
        chain tip and serves stored updates without any prover involved."""
        state = _FollowerState(TINY)
        jobs = _mk_queue(state, tmp_path)
        beacon = FakeBeacon(TINY, fin_slot=144)
        fol = Follower(TINY, beacon, jobs, directory=str(tmp_path))
        _drive(fol, lambda: fol.store.has_committee(2))
        calls = state.calls
        _stop_queue(jobs)

        store2 = UpdateStore(str(tmp_path))
        assert store2.tip_period() == 2
        assert store2.verify_chain()
        assert store2.get_committee(2)["result"]["committee_poseidon"] \
            == fol.store._committee[2]["committee_poseidon"]
        assert state.calls == calls


class TestFollowerServing:
    def test_cache_hit_never_touches_prover(self, tmp_path):
        """Acceptance pin: getLightClientUpdate for a pre-proved period
        completes without a prove call or a job submission — one
        content-verified artifact read."""
        from spectre_tpu_torch.prover_service.rpc import serve

        state = _FollowerState(TINY)
        jobs = _mk_queue(state, tmp_path)
        state.jobs = jobs               # serve() reuses via ensure_jobs
        store = UpdateStore(str(tmp_path))
        store.append_committee(5, {"proof": "0x02", "instances": ["0x1"],
                                   "committee_poseidon": "0xabc"},
                               job_id="job-5")
        beacon = FakeBeacon(TINY, fin_slot=5 * TINY.slots_per_period)
        fol = Follower(TINY, beacon, jobs, store=store)
        server = serve(state, port=0, background=True, follower=fol)
        port = server.server_address[1]
        try:
            resp = _rpc_post(port, {"jsonrpc": "2.0", "id": 1,
                                    "method": "getLightClientUpdate",
                                    "params": {"period": 5}})
            assert resp["result"]["period"] == 5
            assert resp["result"]["result"]["committee_poseidon"] == "0xabc"
            assert state.calls == 0                 # prover never touched
            assert jobs.stats()["jobs"] == {}       # no job submitted

            rng = _rpc_post(port, {"jsonrpc": "2.0", "id": 2,
                                   "method": "getUpdateRange",
                                   "params": {"start_period": 5,
                                              "count": 3}})
            assert len(rng["result"]["updates"]) == 1
            assert rng["result"]["missing"] == [6, 7]

            st = _rpc_post(port, {"jsonrpc": "2.0", "id": 3,
                                  "method": "followerStatus",
                                  "params": {}})
            assert st["result"]["chain_ok"] is True
            assert st["result"]["tip_period"] == 5

            miss = _rpc_post(port, {"jsonrpc": "2.0", "id": 4,
                                    "method": "getLightClientUpdate",
                                    "params": {"period": 9}})
            assert miss["error"]["code"] == -32007
            assert state.calls == 0
        finally:
            server.shutdown()
            _stop_queue(jobs)

    def test_follower_methods_absent_without_follower(self, tmp_path):
        from spectre_tpu_torch.prover_service.rpc import serve

        state = _FollowerState(TINY)
        state.jobs = _mk_queue(state, tmp_path)
        server = serve(state, port=0, background=True)
        port = server.server_address[1]
        try:
            resp = _rpc_post(port, {"jsonrpc": "2.0", "id": 1,
                                    "method": "followerStatus",
                                    "params": {}})
            assert resp["error"]["code"] == -32601
        finally:
            server.shutdown()
            _stop_queue(state.jobs)


class TestFollowerFaults:
    def test_beacon_outage_degrades_then_recovers(self, tmp_path):
        """Acceptance: outage flips `degraded` + counts beacon errors,
        in-flight work still pumps; recovery re-derives missed work and
        head_lag returns to 0."""
        state = _FollowerState(TINY)
        jobs = _mk_queue(state, tmp_path)
        beacon = FakeBeacon(TINY, fin_slot=80)
        fol = Follower(TINY, beacon, jobs, directory=str(tmp_path),
                       pubkeys=_step_pubkeys_hex(TINY), domain=DOMAIN)
        try:
            _drive(fol, lambda: fol.store.has_step(80))
            assert fol.tracker.head_lag_slots == 0

            beacon.outage = True
            beacon.advance(144)
            before = _counter("follower_beacon_errors")
            fol.run_once()
            assert fol.degraded is True
            assert _counter("follower_beacon_errors") == before + 1

            beacon.outage = False
            _drive(fol, lambda: fol.store.has_step(144)
                   and fol.store.has_committee(2))
            assert fol.degraded is False
            assert fol.tracker.head_lag_slots == 0
            assert fol.tracker.periods_behind == 0

            # the lag gauges are exported for every live follower
            from spectre_tpu_torch.observability import prom
            text = prom.render()
            assert "spectre_follower_head_lag_slots" in text
            assert "spectre_follower_periods_behind" in text
            assert "spectre_follower_scheduler_backlog" in text
            assert any(f.get("head_lag_slots") == 0
                       for f in follower_snapshot())
        finally:
            _stop_queue(jobs)

    def test_corrupt_stored_update_quarantined_and_reproved(self, tmp_path):
        """Acceptance drill: rot under a stored update is caught by the
        content-addressed read, the record is dropped, and the follower
        re-proves the period."""
        state = _FollowerState(TINY)
        jobs = _mk_queue(state, tmp_path)
        beacon = FakeBeacon(TINY, fin_slot=80)
        fol = Follower(TINY, beacon, jobs, directory=str(tmp_path))
        try:
            _drive(fol, lambda: fol.store.has_committee(1))
            before = _counter("follower_updates_invalidated")
            faults.install_plan("artifact.read:corrupt:1")
            assert fol.store.get_committee(1) is None   # dropped + quarantined
            assert _counter("follower_updates_invalidated") == before + 1
            assert not fol.store.has_committee(1)

            _drive(fol, lambda: fol.store.has_committee(1))  # re-proved
            assert fol.store.get_committee(1)["result"]["committee_poseidon"]
            assert fol.store.verify_chain()
        finally:
            _stop_queue(jobs)

    def test_diskfull_on_update_store_retries_next_cycle(self, tmp_path):
        """Acceptance drill: ENOSPC under the chain journal counts on
        follower_store_write_failures and the append retries (the job
        result is still journaled — nothing is lost)."""
        clk = {"t": 0.0}
        state = _FollowerState(TINY)
        jobs = _mk_queue(state, tmp_path)
        beacon = FakeBeacon(TINY, fin_slot=80)
        fol = Follower(TINY, beacon, jobs, directory=str(tmp_path),
                       clock=lambda: clk["t"])
        try:
            faults.install_plan("follower.journal:diskfull:1")
            before = _counter("follower_store_write_failures")

            def _failed_once():
                return _counter("follower_store_write_failures") == before + 1

            _drive(fol, _failed_once)
            assert not fol.store.has_committee(1)

            clk["t"] += 120.0          # past the retry backoff
            _drive(fol, lambda: fol.store.has_committee(1))
            assert fol.store.verify_chain()
            assert fol.store.get_committee(1) is not None
        finally:
            _stop_queue(jobs)

    def test_scheduler_honors_overload_retry_after(self):
        """A -32001 shed backs the item off by the server's own
        retry_after_s hint instead of hammering the queue."""
        from spectre_tpu_torch.prover_service.jobs import ServiceOverloaded
        from spectre_tpu_torch.follower.tracker import CommitteeUpdateDue

        clk = {"t": 0.0}
        submitted = []

        class SheddingJobs:
            def __init__(self):
                self.shed_left = 2

            def submit(self, method, params):
                if self.shed_left > 0:
                    self.shed_left -= 1
                    raise ServiceOverloaded("queue full", 7.5)
                submitted.append(method)
                return "jid-1"

            def status(self, jid):
                return {"status": "running"}

        class EmptyStore:
            def has_committee(self, p):
                return False

            def has_step(self, s):
                return False

        sched = ProofScheduler(SheddingJobs(), EmptyStore(),
                               clock=lambda: clk["t"])
        sched.offer([CommitteeUpdateDue(1, {"light_client_update": {}})])
        before = _counter("follower_submits_shed")
        summary = sched.pump()
        assert summary["shed"] == 1 and not submitted
        assert _counter("follower_submits_shed") == before + 1
        sched.pump()                       # still inside the backoff window
        assert not submitted
        clk["t"] = 7.6
        sched.pump()                       # second shed, re-priced backoff
        assert not submitted
        clk["t"] = 16.0
        sched.pump()
        assert submitted == ["genEvmProof_CommitteeUpdateCompressed"]
        assert sched.backlog == 1          # in flight until collected


class TestChainOrder:
    """Out-of-order completion must never break the committee chain
    (a backfill whose period-5 job failed transiently while 6
    finished first used to journal 6 with prev_poseidon=None — and
    nothing ever healed it)."""

    def test_out_of_order_completion_holds_until_predecessor_stored(
            self, tmp_path):
        jobs = ScriptedJobs()
        store = UpdateStore(str(tmp_path))
        sched = ProofScheduler(jobs, store, clock=lambda: 0.0)
        sched.offer([
            CommitteeUpdateDue(5, {"light_client_update": {"p": 5}}),
            CommitteeUpdateDue(6, {"light_client_update": {"p": 6}}),
        ])
        sched.pump()                    # j1 <- period 5, j2 <- period 6
        before = _counter("follower_chain_waits")
        jobs.finish("j2", {"committee_poseidon": "0xb"})    # 6 lands first
        sched.pump()
        assert not store.has_committee(6)       # held, NOT stored with a
        assert store.verify_chain()             # dangling None link
        assert _counter("follower_chain_waits") == before + 1
        jobs.finish("j1", {"committee_poseidon": "0xa"})
        summary = sched.pump()          # period order: 5 lands, then 6
        assert summary["stored"] == 2
        assert store._committee[6]["prev_poseidon"] == "0xa"
        assert store.verify_chain()
        assert sched.backlog == 0

    def test_append_committee_rejects_gap_allows_anchor_reprove(
            self, tmp_path):
        store = UpdateStore(str(tmp_path))
        store.append_committee(3, {"committee_poseidon": "0xa"})
        with pytest.raises(ChainOrderError):
            store.append_committee(5, {"committee_poseidon": "0xc"})
        store.append_committee(4, {"committee_poseidon": "0xb"})
        store.append_committee(5, {"committee_poseidon": "0xc"})
        assert store.verify_chain()
        # the trust anchor may legitimately be re-appended with no
        # predecessor after a read-time invalidation
        faults.install_plan("artifact.read:corrupt:1")
        assert store.get_committee(3) is None
        assert store.anchor_period() == 3       # the anchor never moves
        store.append_committee(3, {"committee_poseidon": "0xa"})
        assert sorted(store._committee) == [3, 4, 5]
        assert store.verify_chain()

    def test_hole_below_tip_reemitted_by_tracker(self, tmp_path):
        """missing periods derive from the chain anchor, not
        tip+1 — a quarantined mid-chain record is re-emitted even
        though periods above it are stored."""
        store = UpdateStore(str(tmp_path))
        for p, pos in ((1, "0xa"), (2, "0xb"), (3, "0xc")):
            store.append_committee(p, {"committee_poseidon": pos})
        beacon = FakeBeacon(TINY, fin_slot=3 * TINY.slots_per_period + 16)
        tr = HeadTracker(beacon, TINY, store)
        assert tr.poll() == []                  # chain complete: no work
        faults.install_plan("artifact.read:corrupt:1")
        assert store.get_committee(2) is None   # mid-chain invalidation
        assert store.tip_period() == 3
        items = tr.poll()
        assert [i.period for i in items] == [2]  # hole BELOW the tip
        store.append_committee(2, {"committee_poseidon": "0xb"})
        assert store.verify_chain()
        assert tr.poll() == []

    def test_store_retry_backoff_honored_on_collect_path(self, tmp_path):
        """the keep_job backoff after a store-write OSError must
        actually delay the next append attempt — pump cycles inside the
        window skip the entry instead of hammering a full disk."""
        clk = {"t": 0.0}
        attempts = {"n": 0}

        class FullDiskStore(UpdateStore):
            def append_committee(self, *a, **kw):
                attempts["n"] += 1
                raise OSError("No space left on device")

        jobs = ScriptedJobs()
        sched = ProofScheduler(jobs, FullDiskStore(str(tmp_path)),
                               clock=lambda: clk["t"])
        sched.offer([CommitteeUpdateDue(1, {"light_client_update": {}})])
        sched.pump()
        jobs.finish("j1", {"committee_poseidon": "0xa"})
        sched.pump()
        assert attempts["n"] == 1
        sched.pump()                    # inside the 1 s backoff window
        sched.pump()
        assert attempts["n"] == 1       # backoff honored, no hammering
        clk["t"] = 1.5                  # past the window
        sched.pump()
        assert attempts["n"] == 2

    def test_replay_skips_corrupt_midline_keeps_tail(self, tmp_path):
        """a corrupt journal line mid-file (bit rot) is skipped
        and counted; only a torn LAST line truncates the replay."""
        store = UpdateStore(str(tmp_path))
        store.append_committee(1, {"committee_poseidon": "0xa"})
        store.append_committee(2, {"committee_poseidon": "0xb"})
        with open(store.path) as f:
            lines = f.read().splitlines()
        lines.insert(1, '{"kind": "committe')        # rot mid-file
        with open(store.path, "w") as f:
            f.write("\n".join(lines) + "\n")
        before = _counter("follower_journal_corrupt_lines")
        store2 = UpdateStore(str(tmp_path))
        assert sorted(store2._committee) == [1, 2]   # tail survived
        assert _counter("follower_journal_corrupt_lines") == before + 1
        assert store2.verify_chain()

        # a torn last line is still a tolerated crash footprint
        with open(store.path, "a") as f:
            f.write('{"kind": "step", "slot"')
        b2 = _counter("follower_journal_corrupt_lines")
        store3 = UpdateStore(str(tmp_path))
        assert sorted(store3._committee) == [1, 2]
        # the mid-file rot still counts (+1); the torn tail adds nothing
        assert _counter("follower_journal_corrupt_lines") == b2 + 1


class TestTracker:
    def test_backfill_bounded_per_poll(self, tmp_path):
        """A tracker far behind queues at most SPECTRE_FOLLOW_BACKFILL
        committee periods per poll and counts the deferral."""
        store = UpdateStore(str(tmp_path))
        beacon = FakeBeacon(TINY, fin_slot=6 * TINY.slots_per_period)
        tr = HeadTracker(beacon, TINY, store, backfill=2)
        before = _counter("follower_backfill_deferred")
        items = tr.poll()
        assert [i.period for i in items] == [6]  # anchored at first-seen
        # a store with an old tip is genuinely behind: periods 1..6 due
        store.append_committee(0, {"committee_poseidon": "0x0"})
        items = tr.poll()
        assert [i.period for i in items] == [1, 2]
        assert _counter("follower_backfill_deferred") == before + 1
        assert tr.periods_behind == 6

    def test_steps_disabled_without_domain_and_pubkeys(self, tmp_path):
        store = UpdateStore(str(tmp_path))
        beacon = FakeBeacon(TINY, fin_slot=80)
        tr = HeadTracker(beacon, TINY, store)
        assert not tr.steps_enabled
        items = tr.poll()
        assert all(i.key()[0] == "committee" for i in items)


# -- aggregation cadence -----------------------------------------------------

@pytest.fixture(scope="module")
def evm_agg_setup():
    """A real proof of the K=6 readiness circuit under Keccak and the
    Solidity verifier the port generates for the port's key of it: the
    canned committee prover serves this proof, so the published
    aggregate's bytes verify in the port's EVM simulator. The proof is the
    reference's (the same circuit and SRS give the same key; proving it in
    the port is the cost of the plain CPU kernels and is held elsewhere)."""
    from spectre_tpu.plonk import backend as RB
    from spectre_tpu.plonk.prover import prove as ref_prove
    from spectre_tpu.plonk.transcript import KeccakTranscript as RefKeccak
    from spectre_tpu.prover_service.selfverify import _tiny_setup as ref_tiny_setup
    from spectre_tpu_torch.evm import gen_evm_verifier
    from spectre_tpu_torch.prover_service.selfverify import _tiny_setup

    pk, srs, _, out = _tiny_setup("cpu")
    rpk, rsrs, rasg, rout = ref_tiny_setup()
    assert pk.vk.digest() == rpk.vk.digest() and out == rout
    proof = ref_prove(rpk, rsrs, rasg, RB.get_backend("cpu"), transcript=RefKeccak())
    src = gen_evm_verifier(pk.vk, srs, num_instances=1)
    return out, proof, src


class _EvmAggState(_FollowerState):
    """Canned prover whose committee proofs are a REAL plonk proof of
    the tiny circuit — every stored period carries EVM-verifiable bytes
    (the poseidon chain still links: one circuit, one instance)."""

    def __init__(self, spec, proof: bytes, out: int):
        super().__init__(spec)
        self._proof, self._out = proof, out

    def prove_committee(self, args):
        faults.check("backend.prove")
        self.calls += 1
        return self._proof, [self._out]


class _CountingVerifier:
    """Delegating verifier wrapper: pins that the EVM simulator really
    ran once per publish (not short-circuited by a mock)."""

    def __init__(self, inner):
        self.inner = inner
        self.calls = 0

    def verify(self, instances, proof) -> bool:
        self.calls += 1
        return self.inner.verify(instances, proof)


class TestAggregationCadence:
    def test_cadence_publishes_evm_verified_windows(self, tmp_path,
                                                    evm_agg_setup):
        """A follower driven across 2x the cadence
        (5 periods, cadence 2) submits the aggregation circuit over the
        stored chain at each sealed boundary and publishes through the
        contract surface gated by the GENERATED Solidity verifier in
        evm.simulator — calldata included."""
        from spectre_tpu_torch.contracts.spectre import (EvmProofVerifier,
                                                   SpectreContract)
        from spectre_tpu_torch.evm.simulator import run_verifier
        from spectre_tpu_torch.follower.scheduler import AggregationPublisher
        from spectre_tpu_torch.prover_service.calldata import decode_calldata

        out, proof, src = evm_agg_setup
        verifier = _CountingVerifier(EvmProofVerifier(src))
        contract = SpectreContract(TINY, 0, 0, agg_verifier=verifier)
        state = _EvmAggState(TINY, proof, out)
        jobs = _mk_queue(state, tmp_path)
        beacon = FakeBeacon(TINY, fin_slot=80)
        windows_before = _counter("follower_cadence_windows")
        published_before = _counter("follower_aggregations_published")
        fol = Follower(TINY, beacon, jobs, directory=str(tmp_path),
                       cadence_periods=2,
                       publisher=AggregationPublisher(contract))
        try:
            assert fol.snapshot()["agg_cadence_periods"] == 2
            for fin_slot in (80, 144, 208, 272, 336):    # periods 1..5
                beacon.advance(fin_slot)
                period = TINY.sync_period(fin_slot)
                _drive(fol, lambda: fol.store.has_committee(period))
            # boundaries seal strictly below the tip: p=2 and p=4
            _drive(fol, lambda: fol.store.has_aggregate(2)
                   and fol.store.has_aggregate(4))
            assert fol.store.latest_aggregate_period() == 4
            assert not fol.store.has_aggregate(5)        # tip not sealed
            assert sorted(contract.aggregated_ranges) == [2, 4]
            assert verifier.calls == 2                   # EVM sim ran twice
            for end, start in ((2, 1), (4, 3)):
                pub = contract.aggregated_ranges[end]
                assert pub["start_period"] == start
                # the published calldata decodes to exactly the
                # instances + proof the simulator accepted
                blob = bytes.fromhex(pub["calldata"].removeprefix("0x"))
                inst, prf = decode_calldata(blob, 1)
                assert inst == [out] and prf == proof
                rec = fol.store.get_aggregate(end)
                assert rec["start_period"] == start
                assert rec["result"]["committee_poseidon"] == hex(out)
                assert rec["result"]["aggregated"] == 2
                assert rec["job_id"]
            # acceptance, stated literally: the published calldata
            # verifies in evm.simulator
            inst, prf = decode_calldata(bytes.fromhex(
                contract.aggregated_ranges[4]["calldata"]
                .removeprefix("0x")), 1)
            assert run_verifier(src, inst, prf)
            assert _counter("follower_cadence_windows") == \
                windows_before + 2
            assert _counter("follower_aggregations_published") == \
                published_before + 2
            assert fol.store.snapshot()["latest_aggregate_period"] == 4
        finally:
            _stop_queue(jobs)

    def test_cadence_restart_rederives_only_unpublished_windows(
            self, tmp_path):
        """has_aggregate() is the dedup key and it SURVIVES restart: a
        follower rebuilt over the same journal never re-submits (or
        re-publishes) a window that already landed."""
        from spectre_tpu_torch.contracts.spectre import SpectreContract
        from spectre_tpu_torch.follower.scheduler import AggregationPublisher

        beacon = FakeBeacon(TINY, fin_slot=80)

        state_a = _FollowerState(TINY)
        jobs_a = _mk_queue(state_a, tmp_path)
        contract_a = SpectreContract(TINY, 0, 0)
        fol_a = Follower(TINY, beacon, jobs_a, directory=str(tmp_path),
                         cadence_periods=2,
                         publisher=AggregationPublisher(contract_a))
        for fin_slot in (80, 144, 208):                  # periods 1..3
            beacon.advance(fin_slot)
            period = TINY.sync_period(fin_slot)
            _drive(fol_a, lambda: fol_a.store.has_committee(period))
        _drive(fol_a, lambda: fol_a.store.has_aggregate(2))
        assert sorted(contract_a.aggregated_ranges) == [2]
        _stop_queue(jobs_a)

        # replayed store already knows window 2 is done
        store_b = UpdateStore(str(tmp_path))
        assert store_b.has_aggregate(2)
        assert store_b.latest_aggregate_period() == 2

        windows_before = _counter("follower_cadence_windows")
        state_b = _FollowerState(TINY)
        jobs_b = _mk_queue(state_b, tmp_path)
        contract_b = SpectreContract(TINY, 0, 0)
        fol_b = Follower(TINY, beacon, jobs_b, store=store_b,
                         cadence_periods=2,
                         publisher=AggregationPublisher(contract_b))
        try:
            for fin_slot in (272, 336):                  # periods 4, 5
                beacon.advance(fin_slot)
                period = TINY.sync_period(fin_slot)
                _drive(fol_b, lambda: fol_b.store.has_committee(period))
            _drive(fol_b, lambda: fol_b.store.has_aggregate(4))
            # only the NEW window was derived; window 2 never re-ran
            assert _counter("follower_cadence_windows") == \
                windows_before + 1
            assert sorted(contract_b.aggregated_ranges) == [4]
        finally:
            _stop_queue(jobs_b)

    def test_publish_failure_keeps_job_and_retries(self, tmp_path):
        """A publish rejection (simulator refusal, transport break) must
        not lose the finished proof: the job is kept, the failure
        counted, and the SAME job re-publishes after the backoff — no
        re-prove, no resubmission."""
        from spectre_tpu_torch.follower.scheduler import AggregationPublisher

        clk = {"t": 0.0}
        store = UpdateStore(str(tmp_path))
        for p, pos in ((1, "0xa"), (2, "0xb"), (3, "0xc")):
            store.append_committee(p, {"committee_poseidon": pos,
                                       "proof": "0x" + "02" * 64,
                                       "instances": [pos]})

        class FlakyContract:
            def __init__(self):
                self.fails = 1
                self.published = []

            def publish_aggregate(self, **kw):
                if self.fails:
                    self.fails -= 1
                    raise AssertionError("simulator rejected calldata")
                self.published.append(kw)
                return kw

        contract = FlakyContract()
        jobs = ScriptedJobs()
        sched = ProofScheduler(jobs, store, clock=lambda: clk["t"],
                               cadence_periods=2,
                               publisher=AggregationPublisher(contract))
        sched.pump()                        # derives [1,2] -> submits j1
        assert jobs._n == 1
        jobs.finish("j1", {"proof": "0x" + "02" * 64, "instances": ["0xb"],
                           "committee_poseidon": "0xb",
                           "start_period": 1, "period": 2})
        before = _counter("follower_publish_failures")
        sched.pump()                        # publish refused
        assert _counter("follower_publish_failures") == before + 1
        assert not store.has_aggregate(2)   # never journaled unpublished
        assert not contract.published
        sched.pump()                        # inside the backoff window
        assert not contract.published
        clk["t"] = 2.0                      # past the 1 s backoff
        sched.pump()
        assert store.has_aggregate(2)
        assert len(contract.published) == 1
        assert contract.published[0]["period"] == 2
        assert jobs._n == 1                 # same job: no re-prove
        assert sched.backlog == 0

    def test_cadence_window_hole_skipped_until_chain_heals(self, tmp_path):
        """A quarantined mid-window record makes the window underfull:
        it is counted (follower_cadence_holes), skipped this cycle, and
        re-derived once the chain heals — never submitted with a gap."""
        store = UpdateStore(str(tmp_path))
        for p, pos in ((1, "0xa"), (2, "0xb"), (3, "0xc")):
            store.append_committee(p, {"committee_poseidon": pos})
        jobs = ScriptedJobs()
        sched = ProofScheduler(jobs, store, clock=lambda: 0.0,
                               cadence_periods=2)
        holes_before = _counter("follower_cadence_holes")
        faults.install_plan("artifact.read:corrupt:1")
        sched.pump()                        # window read hits the rot
        assert _counter("follower_cadence_holes") == holes_before + 1
        assert jobs._n == 0                 # nothing submitted with a gap
        store.append_committee(1, {"committee_poseidon": "0xa"})  # heal
        sched.pump()
        assert jobs._n == 1                 # window re-derived intact

    def test_agg_method_rejects_broken_chain(self):
        """The aggregation circuit re-checks every poseidon link: a
        tampered window is refused as witness-rejected (the port raises
        ValueError where the reference asserts; both -> -32000), which the
        dispatcher never fails over."""
        from spectre_tpu_torch.prover_service.rpc import RPC_METHOD_AGG

        state = _FollowerState(TINY)
        good = [{"period": 1, "prev_poseidon": None,
                 "committee_poseidon": "0xa", "proof": "0x01",
                 "instances": ["0x1"]},
                {"period": 2, "prev_poseidon": "0xa",
                 "committee_poseidon": "0xb", "proof": "0x02",
                 "instances": ["0x2"]}]
        res = run_proof_method(state, RPC_METHOD_AGG,
                               {"start_period": 1, "period": 2,
                                "chain": good})
        assert res["aggregated"] == 2
        assert res["committee_poseidon"] == "0xb"
        assert state.calls == 0             # aggregation never re-proves

        broken = [dict(good[0]), dict(good[1], prev_poseidon="0xbad")]
        with pytest.raises(ValueError, match="chain link broken"):
            run_proof_method(state, RPC_METHOD_AGG,
                             {"start_period": 1, "period": 2,
                              "chain": broken})
        gap = [dict(good[0]), dict(good[1], period=3)]
        with pytest.raises(ValueError, match="not contiguous"):
            run_proof_method(state, RPC_METHOD_AGG,
                             {"start_period": 1, "period": 3,
                              "chain": gap})


# -- the port against the reference --------------------------------------------

from spectre_tpu import spec as RSP                                   # noqa: E402
from spectre_tpu.follower import Follower as RefFollower              # noqa: E402
from spectre_tpu.follower import UpdateStore as RefUpdateStore        # noqa: E402
from spectre_tpu_torch.prover_service.jobs import witness_digest      # noqa: E402

STORES = {"port": UpdateStore, "reference": RefUpdateStore}
REC_KEYS = ("kind", "period", "slot", "digest", "committee_poseidon",
            "prev_poseidon", "job_id", "manifest_digest", "start_period")


def _rec(rec):
    return {k: rec.get(k) for k in REC_KEYS}


class _RecordingJobs:
    """Canned JobQueue: records every (method, params) submitted and
    finishes each job at once with a result derived from the witness
    digest, so both followers see the same completions."""

    def __init__(self):
        self.submitted = []
        self._results = {}

    def submit(self, method, params):
        self.submitted.append((method, json.loads(json.dumps(params))))
        jid = f"j{len(self.submitted)}"
        digest = witness_digest(method, params)
        self._results[jid] = _ScriptedJob(jid, {
            "proof": "0x" + digest, "instances": ["0x" + digest[:16]],
            "committee_poseidon": "0x" + digest[16:32]})
        return jid

    def status(self, jid):
        return {"status": "done"}

    def result(self, jid):
        return self._results.get(jid)


class TestAgainstReference:
    @pytest.mark.parametrize("writer,reader", [("port", "reference"), ("reference", "port")])
    def test_update_store_read_by_the_other_package(self, tmp_path, writer, reader):
        """A store written by one package (committee chain, steps, an
        aggregate) replays in the other: the same records and digests, the
        same stored bodies, the same chain and live set."""
        w = STORES[writer](str(tmp_path))
        for p in range(3, 8):
            w.append_committee(p, {"proof": "0x" + bytes([p]).hex() * 40,
                                   "instances": [hex(p)], "committee_poseidon": hex(p * 31)},
                               job_id=f"job-{p}")
        for slot in (200, 264):
            w.append_step(slot, {"proof": "0x01", "instances": [hex(slot)]}, job_id=f"s{slot}")
        w.append_aggregate(6, {"proof": "0x02", "committee_poseidon": hex(6 * 31),
                               "aggregated": 2}, start_period=5, job_id="agg-6")
        r = STORES[reader](str(tmp_path))
        again = STORES[writer](str(tmp_path))
        for p in range(3, 8):
            assert _rec(r.get_committee(p)) == _rec(again.get_committee(p))
            assert r.get_committee(p)["result"] == again.get_committee(p)["result"]
        for slot in (200, 264):
            assert _rec(r.get_step(slot)) == _rec(again.get_step(slot))
        assert _rec(r.get_aggregate(6)) == _rec(again.get_aggregate(6))
        assert r.verify_chain() and r.tip_period() == 7 and r.anchor_period() == 3
        assert r.latest_step_slot() == 264
        assert r.live_artifacts() == again.live_artifacts()

    def test_followers_submit_the_same_sequence_and_store_the_same_chain(self, tmp_path):
        """Both packages' followers over the same scripted beacon, across
        three period boundaries with steps on, and canned jobs: the same
        (method, params) submissions in the same order, the same stored
        chain (records and digests), the same lag gauges."""
        beacon = FakeBeacon(TINY, fin_slot=80)
        pubkeys = _step_pubkeys_hex(TINY)
        runs = {}
        for name, cls, spec in (("port", Follower, TINY), ("reference", RefFollower, RSP.TINY)):
            jobs = _RecordingJobs()
            fol = cls(spec, beacon, jobs, directory=str(tmp_path / name),
                      pubkeys=pubkeys, domain=DOMAIN, backfill=2)
            for fin_slot in (80, 144, 208, 272, 400):
                beacon.advance(fin_slot)
                for _ in range(3):
                    fol.run_once()
            runs[name] = (jobs, fol)
        (pj, pf), (rj, rf) = runs["port"], runs["reference"]
        assert len(pj.submitted) >= 8
        assert pj.submitted == rj.submitted
        assert sorted(pf.store._committee) == sorted(rf.store._committee)
        for p in sorted(pf.store._committee):
            assert _rec(pf.store.get_committee(p)) == _rec(rf.store.get_committee(p))
        for slot in (80, 144, 208, 272, 400):
            assert _rec(pf.store.get_step(slot)) == _rec(rf.store.get_step(slot))
        assert pf.store.verify_chain() and rf.store.verify_chain()
        for gauge in ("head_lag_slots", "periods_behind", "scheduler_backlog", "chain_ok"):
            assert pf.snapshot()[gauge] == rf.snapshot()[gauge]


def _rpc_post(port, payload, timeout=60):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/rpc", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.load(resp)


def test_follow_cli_boots_on_the_card_and_serves_the_follower(monkeypatch, tmp_path):
    """`follow` boots its state on the card unless --device says otherwise,
    builds a Follower over the beacon (a quorum for several URLs), mounts
    the gateway with --gateway, serves it in the background and runs the
    loop."""
    from spectre_tpu_torch.follower import daemon
    from spectre_tpu_torch.preprocessor import beacon as pbeacon
    from spectre_tpu_torch.prover_service import cli, rpc as prpc_mod, state as pstate

    booted, served, ran = [], {}, []

    class FakeState:
        def __init__(self, spec, k_step, k_committee, concurrency, device, **kw):
            booted.append(device)
            self.spec, self.concurrency, self.jobs = spec, concurrency, None

    monkeypatch.setattr(pstate, "ProverState", FakeState)
    monkeypatch.setattr(prpc_mod, "serve", lambda state, host, port, **kw: served.update(kw))
    monkeypatch.setattr(daemon.Follower, "run", lambda self, stop, poll_s=None: ran.append(poll_s))
    pubkeys = tmp_path / "pubkeys.json"
    pubkeys.write_text(json.dumps(_step_pubkeys_hex(TINY)))
    cli.main(["--spec", "tiny", "follow", "--beacon-api", "http://127.0.0.1:9,http://127.0.0.1:10",
              "--params-dir", str(tmp_path), "--gateway", "--pack-periods", "4",
              "--pubkeys-file", str(pubkeys), "--domain", "0x" + DOMAIN.hex(),
              "--poll-s", "0.5"])
    assert booted == ["cuda"] and ran == [0.5]
    fol, gw = served["follower"], served["gateway"]
    assert isinstance(fol.tracker.beacon, pbeacon.BeaconQuorum)
    assert fol.tracker.steps_enabled and gw.packs.pack_periods == 4
    assert served["background"] is True and served["journal_dir"] == str(tmp_path)
    served.clear()
    cli.main(["--spec", "tiny", "follow", "--beacon-api", "http://127.0.0.1:9",
              "--params-dir", str(tmp_path / "b"), "--device", "cpu"])
    assert booted[-1] == "cpu" and served["gateway"] is None
    for q in (fol.jobs, served["follower"].jobs):
        _stop_queue(q)
