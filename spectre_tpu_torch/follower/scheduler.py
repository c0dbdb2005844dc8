"""Proof scheduler: work items -> JobQueue submissions (the port's copy
of `spectre_tpu/follower/scheduler.py`).

Every work item flows through the EXISTING admission-control path
(:meth:`JobQueue.submit`) — so proactive follower proving gets the crash
journal, witness-digest dedup, load shedding, worker supervision and the
verify-before-serve gate for free, and shares one concurrency governor
with request-driven proving.

Scheduling policy:

* committee-update items always submit before step items (a missed
  rotation strands the verified update chain; a missed step only delays
  head freshness — steps backfill);
* a ``ServiceOverloaded`` shed backs the item off by the server's own
  ``retry_after_s`` hint (the -32001 contract) instead of hammering;
* a failed job retries with capped exponential backoff
  (``follower_jobs_failed`` counts);
* committee results land in the store in PERIOD ORDER: a completion
  whose earlier committee periods are still pending holds its finished
  job (``follower_chain_waits``) instead of journaling a record with a
  dangling ``prev_poseidon`` — out-of-order completion can never break
  the verified chain;
* double submission is impossible by construction — an item already
  proved is filtered against the update store, an item already in
  flight keeps its job id, and a resubmission after restart hits the
  queue's witness-digest dedup.

Completion side: a ``done`` job's result is appended to the
:class:`~spectre_tpu_torch.follower.updates.UpdateStore` together with its
job id and provenance-manifest digest (the flight-recorder linkage). A
store write failure (e.g. injected ENOSPC) counts on
``follower_store_write_failures`` and retries next cycle — the job
result is still journaled, nothing is lost.

Aggregation cadence: with ``SPECTRE_AGG_CADENCE_PERIODS=N``
(or ``cadence_periods=N``), every N sealed committee periods the
scheduler derives an :class:`~spectre_tpu_torch.follower.tracker.AggregationDue`
window purely from the update store — no beacon involved — and submits
the ``genEvmProof_AggregationCadence`` circuit over the stored chain.
The done proof is published through the configured
:class:`AggregationPublisher` (the EVM-verifiable Spectre contract
surface) BEFORE being journaled as an ``aggregate`` record, so a
publish failure (``follower_publish_failures``) retries next cycle with
the finished job kept, and a restart re-derives exactly the unpublished
windows (``store.has_aggregate`` is the dedup key). Aggregation items
sort after committees and steps: compressing history must never starve
the live chain.
"""

from __future__ import annotations

import os
import time

from ..prover_service.jobs import ServiceOverloaded
from ..utils.health import HEALTH
from ..utils.profiling import phase
from .tracker import AggregationDue, CommitteeUpdateDue
from .updates import ChainOrderError

RETRY_BASE_S = 1.0
RETRY_CAP_S = 60.0

CADENCE_ENV = "SPECTRE_AGG_CADENCE_PERIODS"
CADENCE_DEFAULT = 0                      # 0 = cadence disabled


class PublicationError(RuntimeError):
    """Publishing an aggregation proof to the contract surface failed
    (simulator rejected the calldata, replay refused, transport broke).
    The scheduler keeps the finished job and retries next cycle."""


class AggregationPublisher:
    """Publishes a completed aggregation window through the Spectre
    contract surface (``contracts/spectre.py``) — in tests and drills
    the contract's verifier runs the generated Solidity through
    ``evm.simulator``, so a publish IS an EVM verification."""

    def __init__(self, contract, health=HEALTH):
        self.contract = contract
        self.health = health

    def publish(self, item, result: dict) -> None:
        from ..prover_service.selfverify import decode_result
        try:
            proof, instances = decode_result(result)
            self.contract.publish_aggregate(
                start_period=item.start_period,
                period=item.period,
                committee_poseidon=result.get("committee_poseidon"),
                instances=instances,
                proof=proof,
                calldata=result.get("calldata"),
            )
        except Exception as exc:
            raise PublicationError(
                f"aggregation window [{item.start_period}, {item.period}] "
                f"rejected: {exc}") from exc
        self.health.incr("follower_aggregations_published")


class ProofScheduler:
    def __init__(self, jobs, store, health=HEALTH, clock=time.monotonic,
                 retry_base_s: float = RETRY_BASE_S,
                 retry_cap_s: float = RETRY_CAP_S,
                 cadence_periods: int | None = None,
                 publisher: AggregationPublisher | None = None):
        self.jobs = jobs
        self.store = store
        self.health = health
        self._clock = clock
        self.retry_base_s = retry_base_s
        self.retry_cap_s = retry_cap_s
        if cadence_periods is None:
            try:
                cadence_periods = int(os.environ.get(CADENCE_ENV)
                                      or CADENCE_DEFAULT)
            except ValueError:
                cadence_periods = CADENCE_DEFAULT
        self.cadence_periods = max(0, int(cadence_periods))
        self.publisher = publisher
        # key -> {"item", "jid", "attempts", "not_before"}
        self._pending: dict[tuple, dict] = {}

    @property
    def backlog(self) -> int:
        return len(self._pending)

    def _satisfied(self, item) -> bool:
        if isinstance(item, CommitteeUpdateDue):
            return self.store.has_committee(item.period)
        if isinstance(item, AggregationDue):
            return self.store.has_aggregate(item.period)
        return self.store.has_step(item.slot)

    def offer(self, items) -> int:
        """Adopt new work items (idempotent per key). Returns how many
        were actually new."""
        fresh = 0
        for item in items:
            key = item.key()
            if key in self._pending or self._satisfied(item):
                continue
            self._pending[key] = {"item": item, "jid": None,
                                  "attempts": 0, "not_before": 0.0}
            fresh += 1
        return fresh

    def pump(self) -> dict:
        """One scheduling cycle: submit every eligible item (committee
        items first), then collect finished jobs into the store."""
        summary = {"submitted": 0, "stored": 0, "failed": 0, "shed": 0}
        self._offer_cadence()
        now = self._clock()
        entries = sorted(
            self._pending.items(),
            key=lambda kv: (0 if isinstance(kv[1]["item"],
                                            CommitteeUpdateDue)
                            else 2 if isinstance(kv[1]["item"],
                                                 AggregationDue) else 1,
                            kv[0][1]))
        for key, ent in entries:
            if self._pending.get(key) is not ent:
                continue
            if now < ent["not_before"]:
                continue      # backing off (shed, failure OR store retry)
            if ent["jid"] is None:
                self._submit(ent, summary)
            if ent["jid"] is not None:
                self._collect(key, ent, summary, now)
        return summary

    def _offer_cadence(self):
        """Derive due aggregation windows from the update store: one
        per ``cadence_periods`` sealed committee periods, anchored at
        the chain anchor. A window is due once its end period is sealed
        (strictly below the tip — its successor pins it, so the window
        contents can never change) and no ``aggregate`` record exists
        for it yet; a window with a mid-chain hole (quarantined record)
        is skipped this cycle (``follower_cadence_holes``) and
        re-derived once the chain heals."""
        n = self.cadence_periods
        if n <= 0:
            return
        anchor = self.store.anchor_period()
        tip = self.store.tip_period()
        if anchor is None or tip is None:
            return
        for p in range(anchor + n - 1, tip, n):
            key = ("aggregation", p)
            if key in self._pending or self.store.has_aggregate(p):
                continue
            start = p - n + 1
            chain = []
            for q in range(start, p + 1):
                rec = self.store.get_committee(q)
                if rec is None:
                    break
                res = rec.get("result") or {}
                chain.append({
                    "period": rec["period"],
                    "prev_poseidon": rec.get("prev_poseidon"),
                    "committee_poseidon": res.get("committee_poseidon"),
                    "proof": res.get("proof"),
                    "instances": res.get("instances"),
                    "calldata": res.get("calldata"),
                })
            if len(chain) != n:
                self.health.incr("follower_cadence_holes")
                continue
            item = AggregationDue(p, start, {
                "start_period": start, "period": p, "chain": chain})
            self._pending[key] = {"item": item, "jid": None,
                                  "attempts": 0, "not_before": 0.0}
            self.health.incr("follower_cadence_windows")

    def _submit(self, ent: dict, summary: dict):
        item = ent["item"]
        try:
            with phase("follower/submit"):
                ent["jid"] = self.jobs.submit(item.method,
                                              dict(item.params))
            self.health.incr("follower_jobs_submitted")
            summary["submitted"] += 1
        except ServiceOverloaded as exc:
            # honor the server's own backoff pricing (-32001 contract)
            ent["not_before"] = self._clock() + exc.retry_after_s
            self.health.incr("follower_submits_shed")
            summary["shed"] += 1

    def _chain_blocked(self, item) -> bool:
        """Committee results must land in the store in period order —
        a record links to its predecessor's poseidon commitment, so
        storing period p while an earlier period is still pending would
        journal a dangling ``prev_poseidon=None`` that nothing heals.
        Out-of-order completions (a transient failure on p-1, a
        concurrency>1 queue finishing p first) hold their finished job
        until every earlier committee period has been stored; within
        one pump cycle entries are processed in period order, so the
        successor lands in the same cycle its predecessor does."""
        if not isinstance(item, CommitteeUpdateDue):
            return False
        return any(isinstance(e["item"], CommitteeUpdateDue)
                   and e["item"].period < item.period
                   for e in self._pending.values())

    def _collect(self, key: tuple, ent: dict, summary: dict, now: float):
        st = self.jobs.status(ent["jid"])
        if st is None:
            # queue restarted without this job: resubmit next cycle
            ent["jid"] = None
            return
        if st["status"] in ("queued", "running"):
            return
        if st["status"] == "done":
            if self._chain_blocked(ent["item"]):
                # keep the finished job; re-checked every cycle
                self.health.incr("follower_chain_waits")
                return
            job = self.jobs.result(ent["jid"])
            if job is None or job.result is None:
                self._backoff(ent, now)
                self.health.incr("follower_results_unavailable")
                return
            try:
                with phase("follower/store_update"):
                    self._store(ent["item"], job)
            except ChainOrderError:
                # defense in depth: the predecessor is missing from the
                # store and not pending (e.g. backfill hasn't emitted it
                # yet) — keep the finished job until it lands
                self.health.incr("follower_chain_order_rejected")
                return
            except PublicationError:
                # the contract surface refused or broke: the proof is
                # done and journaled — keep the finished job and retry
                # the publish next cycle
                self.health.incr("follower_publish_failures")
                self._backoff(ent, now, keep_job=True)
                return
            except OSError:
                # diskfull & friends: the job result is still journaled;
                # retry the append next cycle
                self.health.incr("follower_store_write_failures")
                self._backoff(ent, now, keep_job=True)
                return
            del self._pending[key]
            summary["stored"] += 1
            return
        # failed / cancelled: capped exponential backoff, then re-prove
        self._backoff(ent, now)
        self.health.incr("follower_jobs_failed")
        summary["failed"] += 1

    def _backoff(self, ent: dict, now: float, keep_job: bool = False):
        ent["attempts"] += 1
        if not keep_job:
            ent["jid"] = None
        ent["not_before"] = now + min(
            self.retry_cap_s, self.retry_base_s * 2 ** (ent["attempts"] - 1))

    def _store(self, item, job):
        manifest_digest = getattr(job, "manifest_digest", None)
        if isinstance(item, CommitteeUpdateDue):
            self.store.append_committee(item.period, job.result,
                                        job_id=job.id,
                                        manifest_digest=manifest_digest)
        elif isinstance(item, AggregationDue):
            # publish BEFORE journaling: has_aggregate() is the dedup
            # key, so a window must never be marked done while its
            # proof is unpublished — a crash between publish and append
            # merely re-publishes (the contract's replay guard absorbs)
            if self.publisher is not None:
                self.publisher.publish(item, job.result)
            self.store.append_aggregate(item.period, job.result,
                                        start_period=item.start_period,
                                        job_id=job.id,
                                        manifest_digest=manifest_digest)
        else:
            self.store.append_step(item.slot, job.result, job_id=job.id,
                                   manifest_digest=manifest_digest)
