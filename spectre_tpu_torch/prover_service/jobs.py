"""Async proof job queue with a crash-safe journal (the port's copy of
`spectre_tpu/prover_service/jobs.py`; the journal's records and the
witness digest are the reference's, so one journal reads the same in both
packages).

* **JobQueue** — `submit()` returns a job id immediately; a bounded worker
  pool (sharing `ProverState.semaphore`, so batch + RPC + async load honor
  one concurrency cap) runs a `runner(method, params)` callback per job
  with per-job timeout and cancellation. The blocking `genEvmProof_*`
  RPC methods are `submit()` + `wait()` on top of the same queue.
* **JobJournal** — append-only JSONL under `params_dir`, fsync'd on every
  state transition (queued -> running -> done/failed). A restarted service
  replays the journal: finished jobs keep their results (dedup hits),
  jobs caught mid-prove are re-queued instead of lost. A torn final line
  (crash mid-append) is tolerated and ignored.
* **Dedup by witness digest** — jobs are keyed by a sha256 over the
  canonical (method, params) JSON, so a client that retries a submit (or a
  restart replay racing a client resubmit) never double-proves.

Timeouts cannot interrupt a compute-bound Python thread, so expiry is
enforced at the bookkeeping layer: the job is marked failed the moment its
deadline passes (observed by pollers and by the worker), and the eventual
runner result is discarded. Cancellation works the same way for running
jobs and dequeues queued ones outright.

Overload + integrity layer:

* **Admission control** — the queue is bounded (`SPECTRE_JOB_QUEUE_DEPTH`,
  default 64): a full backlog rejects new submissions with a typed
  :class:`ServiceOverloaded` carrying `retry_after_s` (priced at the p90
  of the queue-local prove-latency histogram; ServiceHealth mean as the
  cold-start fallback). A host-memory watermark
  (`SPECTRE_MEM_WATERMARK_MB`, `/proc/self/statm`) sheds new work before
  the box OOMs. Counters: `jobs_shed_queue` / `jobs_shed_memory`; a memory
  shed journals a `shed_memory` record naming the per-job `peak_rss_mb` of
  every running job (replay-inert: no job_id).
* **Deadline propagation** — a client-supplied `deadline_s` clamps the
  per-job timeout at submit time.
* **Worker supervision** — workers stamp a monotonic heartbeat between
  prove phases (a `heartbeat` callback threaded through the runner into
  `ProverState.prove_*`); a supervisor thread detects a worker stalled
  past `SPECTRE_WORKER_STALL_S`, marks its job `failed(stalled)`, spawns
  a replacement worker for the slot (the hung thread is disowned — on an
  eventual return it notices it lost its slot and exits) and bumps
  `workers_replaced`. The supervisor never proves inline.
* **Artifact offload** — proof results live in an integrity-checked
  content-addressed store (utils/artifacts) under
  `params_dir/results/<sha256>.bin`; the journal records the digest, not
  the payload. Replay re-verifies digests and quarantines corrupt files
  (the job degrades to failed + re-provable) instead of serving poison.

Provenance manifests: every job that reaches a worker also emits a
per-proof manifest (observability/manifest.py — timestamps with queue
wait split out, the MSM mode and env knobs, degrade/fault events, table
LRU deltas, the kernel builds and launches of the job, phase seconds, peak
RSS, result digest), written as an artifact (`<sha256>.manifest.json`);
the journal stores only the digest. A broken manifest sink never fails a
prove (fault site `manifest.write`, counter `manifest_write_failures`).

Fault-injection sites: `journal.write` (a journal-write failure fails the
job rather than wedging the queue), `journal.compact`,
`artifact.write`/`artifact.read`, `manifest.write`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import inspect
import json
import os
import queue
import threading
import time

from ..observability import compilelog as obs_compilelog
from ..observability import manifest as obs_manifest
from ..observability import metrics as obs_metrics
from ..observability import tracing as obs_tracing
from ..observability.rss import SAMPLER as RSS_SAMPLER
from ..observability.rss import rss_mb
from ..utils import faults
from ..utils.artifacts import ArtifactCorrupt, ArtifactStore
from ..utils.health import HEALTH
from .scrubber import Scrubber

JOURNAL_NAME = "jobs.journal.jsonl"

# admission control: bound the backlog, shed before the box OOMs
QUEUE_DEPTH_ENV = "SPECTRE_JOB_QUEUE_DEPTH"
QUEUE_DEPTH_DEFAULT = 64
MEM_WATERMARK_ENV = "SPECTRE_MEM_WATERMARK_MB"      # 0 / unset = disabled
WORKER_STALL_ENV = "SPECTRE_WORKER_STALL_S"
WORKER_STALL_DEFAULT_S = 600.0

# retry_after_s fallback when no prove has completed yet (nothing observed)
DEFAULT_PROVE_LATENCY_S = 30.0

# terminal states never transition again; "queued"/"running" are live
TERMINAL = ("done", "failed", "cancelled")

# startup-replay compaction trigger: past this size the journal is
# rewritten keeping only the terminal-state tail per job (the JSONL
# otherwise grows unbounded)
COMPACT_ENV = "SPECTRE_JOURNAL_COMPACT_BYTES"
COMPACT_DEFAULT_BYTES = 4 << 20


def _compact_threshold() -> int:
    return int(os.environ.get(COMPACT_ENV, str(COMPACT_DEFAULT_BYTES)))


def _env_num(name: str, default: float) -> float:
    v = os.environ.get(name)
    return float(v) if v else default


class ServiceOverloaded(RuntimeError):
    """Load shed: the submission was REJECTED (queue full / memory
    watermark), not queued. Carries the backoff hint the RPC layer turns
    into `-32001` + HTTP 429 `Retry-After`."""

    def __init__(self, reason: str, retry_after_s: float):
        super().__init__(f"service overloaded ({reason}); "
                         f"retry after {retry_after_s:.1f}s")
        self.reason = reason
        self.retry_after_s = retry_after_s


def witness_digest(method: str, params: dict) -> str:
    """Canonical digest of a proof request — the dedup key."""
    blob = json.dumps([method, params], sort_keys=True,
                      separators=(",", ":")).encode()
    return hashlib.sha256(blob).hexdigest()


@dataclasses.dataclass
class Job:
    id: str
    method: str
    params: dict
    digest: str
    status: str = "queued"
    submitted_at: float = 0.0
    admitted_at: float | None = None    # admission-control pass
    started_at: float | None = None
    finished_at: float | None = None
    timeout: float | None = None
    attempts: int = 0
    result: dict | None = None
    result_digest: str | None = None    # sha256 of the offloaded artifact
    error: dict | None = None
    cancel_requested: bool = False
    peak_rss_mb: float | None = None    # per-job RSS attribution
    queue_wait_s: float | None = None   # admission -> worker start
    manifest_digest: str | None = None  # provenance manifest artifact

    def public(self) -> dict:
        """Status view returned by getProofStatus (no result payload)."""
        d = {"job_id": self.id, "status": self.status,
             "method": self.method, "digest": self.digest,
             "attempts": self.attempts,
             "submitted_at": self.submitted_at}
        if self.error is not None:
            d["error"] = self.error
        if self.peak_rss_mb is not None:
            d["peak_rss_mb"] = self.peak_rss_mb
        if self.queue_wait_s is not None:
            d["queue_wait_s"] = self.queue_wait_s
        if self.manifest_digest is not None:
            d["manifest_digest"] = self.manifest_digest
        return d


class JobJournal:
    """Append-only JSONL journal, fsync'd per record."""

    def __init__(self, directory: str):
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, JOURNAL_NAME)
        self._lock = threading.Lock()

    def append(self, record: dict):
        faults.check("journal.write")
        line = json.dumps(record, sort_keys=True,
                          separators=(",", ":")) + "\n"
        with self._lock:
            with open(self.path, "a") as f:
                f.write(line)
                f.flush()
                os.fsync(f.fileno())

    def replay(self) -> dict[str, Job]:
        """Fold the journal into the last-known state per job.

        Torn final lines (a crash mid-append) parse-fail and are skipped;
        every complete record was fsync'd so ordering is trustworthy."""
        jobs: dict[str, Job] = {}
        if not os.path.exists(self.path):
            return jobs
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue                     # torn tail record
                ev, jid = rec.get("event"), rec.get("job_id")
                if not jid:
                    continue
                if ev == "submit":
                    jobs[jid] = Job(
                        id=jid, method=rec.get("method", ""),
                        params=rec.get("params") or {},
                        digest=rec.get("digest", ""),
                        submitted_at=rec.get("ts", 0.0),
                        admitted_at=rec.get("admitted"),
                        timeout=rec.get("timeout"))
                    continue
                job = jobs.get(jid)
                if job is None:
                    continue                     # journal truncated earlier
                if ev == "running":
                    job.status = "running"
                    job.started_at = rec.get("ts")
                    job.attempts = rec.get("attempt", job.attempts + 1)
                elif ev == "requeued":
                    job.status = "queued"
                    job.started_at = None
                elif ev == "done":
                    job.status = "done"
                    # offloaded records carry the artifact digest; the
                    # inline form stays readable
                    job.result = rec.get("result")
                    job.result_digest = rec.get("result_digest")
                    job.finished_at = rec.get("ts")
                    job.peak_rss_mb = rec.get("peak_rss_mb")
                    job.manifest_digest = rec.get("manifest_digest")
                elif ev == "failed":
                    job.status = "failed"
                    job.error = rec.get("error")
                    job.finished_at = rec.get("ts")
                    job.peak_rss_mb = rec.get("peak_rss_mb")
                    job.manifest_digest = rec.get("manifest_digest")
                elif ev == "cancelled":
                    job.status = "cancelled"
                    job.finished_at = rec.get("ts")
        return jobs

    def size(self) -> int:
        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0

    def compact(self, jobs):
        """Rewrite the JSONL keeping only the terminal-state tail per job:
        one `submit` record plus (for terminal jobs) the final event —
        every intermediate running/requeued transition is dropped. Done
        jobs keep their results so a restarted service still serves them.

        Crash-safe: the replacement is written to a sidecar file, fsync'd,
        and atomically `os.replace`d over the journal — a crash mid-compact
        (fault site `journal.compact`, fired after the rewrite is staged
        but before the swap) leaves the ORIGINAL journal untouched and the
        next startup simply re-compacts."""
        tmp = self.path + ".compact"
        with self._lock:
            with open(tmp, "w") as f:
                for job in sorted(jobs, key=lambda j: j.submitted_at):
                    sub = {"event": "submit", "job_id": job.id,
                           "method": job.method, "params": job.params,
                           "digest": job.digest, "timeout": job.timeout,
                           "ts": job.submitted_at}
                    if job.admitted_at is not None:
                        sub["admitted"] = job.admitted_at
                    recs = [sub]
                    if job.status in TERMINAL:
                        rec = {"event": job.status, "job_id": job.id,
                               "ts": job.finished_at}
                        # an offloaded result compacts to its digest — never
                        # re-inline the payload, the journal must stay
                        # O(#jobs)
                        if job.result_digest is not None:
                            rec["result_digest"] = job.result_digest
                        elif job.result is not None:
                            rec["result"] = job.result
                        if job.error is not None:
                            rec["error"] = job.error
                        if job.peak_rss_mb is not None:
                            rec["peak_rss_mb"] = job.peak_rss_mb
                        # the manifest stays an O(1) digest through
                        # compaction, exactly like the result artifact
                        if job.manifest_digest is not None:
                            rec["manifest_digest"] = job.manifest_digest
                        recs.append(rec)
                    for rec in recs:
                        f.write(json.dumps(rec, sort_keys=True,
                                           separators=(",", ":")) + "\n")
                f.flush()
                # crash window: sidecar staged, original journal intact
                faults.check("journal.compact")
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
            # fsync the directory so the rename survives power loss
            try:
                dfd = os.open(os.path.dirname(self.path) or ".", os.O_RDONLY)
                try:
                    os.fsync(dfd)
                finally:
                    os.close(dfd)
            except OSError:
                pass


class JobQueue:
    """Bounded async worker pool over a `runner(method, params)` callback.

    `concurrency` sizes the worker threads. `semaphore` (optional) is an
    EXTERNAL concurrency governor for runners that do not self-govern; the
    ProverState runner acquires `state.semaphore` inside prove_* itself
    (non-reentrant — do not pass the same semaphore at both layers), so
    async jobs, blocking RPCs and batch proves already draw from one
    permit pool.
    """

    def __init__(self, runner, concurrency: int = 1,
                 journal_dir: str | None = None, semaphore=None,
                 default_timeout: float | None = None, health=HEALTH,
                 queue_depth: int | None = None,
                 mem_watermark_mb: float | None = None,
                 stall_timeout: float | None = None,
                 clock=time.monotonic, sleep_interval: float | None = None,
                 latency_hist=None, scrub_interval: float | None = None,
                 scrub_min_age: float | None = None, live_providers=()):
        """`queue_depth`/`mem_watermark_mb`/`stall_timeout` default to the
        SPECTRE_JOB_QUEUE_DEPTH / SPECTRE_MEM_WATERMARK_MB /
        SPECTRE_WORKER_STALL_S env knobs. `clock` and `sleep_interval` are
        the supervisor's injectable time source and scan period (the
        BeaconClient pattern: stall tests run deterministic + fast).
        `latency_hist` (injectable for tests) is the queue-local prove
        latency histogram that prices `retry_after_s` at its p90.
        `scrub_interval`/`scrub_min_age` (SPECTRE_SCRUB_INTERVAL_S
        / SPECTRE_SCRUB_MIN_AGE_S) govern the artifact scrubber — interval
        0 disables the periodic thread (scrubNow still works).
        `live_providers`: zero-arg callables returning extra (digest,
        suffix) pairs the scrubber must keep (see add_live_provider)."""
        self.runner = runner
        self.concurrency = max(1, int(concurrency))
        self.semaphore = semaphore
        self.default_timeout = default_timeout
        self.health = health
        self.journal = JobJournal(journal_dir) if journal_dir else None
        self.store = ArtifactStore(journal_dir, health=health) \
            if journal_dir else None
        self.queue_depth = int(queue_depth if queue_depth is not None
                               else _env_num(QUEUE_DEPTH_ENV,
                                             QUEUE_DEPTH_DEFAULT))
        self.mem_watermark_mb = float(
            mem_watermark_mb if mem_watermark_mb is not None
            else _env_num(MEM_WATERMARK_ENV, 0.0))
        self.stall_timeout = float(
            stall_timeout if stall_timeout is not None
            else _env_num(WORKER_STALL_ENV, WORKER_STALL_DEFAULT_S))
        self._clock = clock
        # retry_after pricing: a queue-local histogram — p90 of what
        # this queue observed, not a process-wide mean a single outlier
        # can poison
        self.latency = (latency_hist if latency_hist is not None
                        else obs_metrics.queue_latency_histogram())
        self._jobs: dict[str, Job] = {}
        self._by_digest: dict[str, str] = {}
        self._q: queue.Queue = queue.Queue()
        self._cv = threading.Condition()
        self._seq = 0
        self._stopped = False
        self._stop_event = threading.Event()
        # does the runner accept a heartbeat callback? (inspected once —
        # plain runner(method, params) callables keep working unchanged)
        self._runner_heartbeat = _accepts_heartbeat(runner)
        # external keep-set providers: subsystems sharing the results/
        # namespace (the follower's update store, the gateway's packs)
        # contribute their own (digest, suffix) pairs so neither
        # compaction-time nor periodic scrubs expire an artifact a chain
        # record references. Registered before the scrubber/_recover so
        # the post-compaction pass already sees them.
        self._live_providers = list(live_providers)
        # artifact scrubber: built before _recover so the
        # post-compaction pass can expire freshly-orphaned artifacts
        self.scrubber = Scrubber(self.store, self._live_artifacts,
                                 health=health, min_age_s=scrub_min_age) \
            if self.store is not None else None
        if self.journal is not None:
            self._recover()
        # per-slot worker bookkeeping: the supervisor compares each slot's
        # heartbeat against `clock()` and replaces the thread on stall
        self._slots = [{"thread": None, "beat": self._clock(), "job": None}
                       for _ in range(self.concurrency)]
        for i in range(self.concurrency):
            self._spawn_worker(i)
        self._supervisor = threading.Thread(
            target=self._supervise_loop, daemon=True,
            name="prover-job-supervisor",
            args=(sleep_interval if sleep_interval is not None
                  else max(0.05, min(self.stall_timeout / 4.0, 1.0)),))
        self._supervisor.start()
        if self.scrubber is not None:
            self.scrubber.start(scrub_interval, self._stop_event)

    def _spawn_worker(self, slot: int):
        t = threading.Thread(target=self._worker_loop, daemon=True,
                             name=f"prover-job-worker-{slot}",
                             args=(slot,))
        self._slots[slot]["thread"] = t
        self._slots[slot]["beat"] = self._clock()
        t.start()

    # -- recovery ----------------------------------------------------------

    def _recover(self):
        replayed = self.journal.replay()
        for job in replayed.values():
            self._jobs[job.id] = job
            # restore the id counter past every replayed job: a fresh
            # submission after restart must never mint a colliding id
            # (which would silently OVERWRITE the replayed record)
            try:
                self._seq = max(self._seq, int(job.id.rsplit("-", 1)[1]))
            except (IndexError, ValueError):
                pass
            if job.status == "done":
                self._resolve_result(job)
            # last submit wins the digest slot; terminal-but-failed jobs
            # stay resubmittable (dedup only pins live/done jobs)
            if job.status not in ("failed", "cancelled"):
                self._by_digest[job.digest] = job.id
            if job.status == "running":
                # caught mid-prove by a crash: re-run it
                job.status = "queued"
                job.started_at = None
                self._append({"event": "requeued", "job_id": job.id,
                              "ts": time.time()})
                self._q.put(job.id)
                self.health.incr("jobs_requeued")
            elif job.status == "queued":
                self._q.put(job.id)
        if replayed:
            self.health.incr("journal_replays")
        # startup compaction: replay (plus its requeue appends) is the one
        # moment the full job map is authoritative and no workers write
        if self.journal.size() > _compact_threshold():
            try:
                self.journal.compact(list(self._jobs.values()))
                self.health.incr("journal_compactions")
            except faults.InjectedCrash:
                raise          # simulated death mid-compact (tests)
            except Exception:
                # a failed compaction costs disk, never correctness: the
                # original journal is still the source of truth
                self.health.incr("journal_compact_failures")
            else:
                # the scrub pass that follows compaction: the compacted
                # journal is now the authority on which digests are live —
                # artifacts it no longer references are expired, corrupt
                # ones quarantined
                if self.scrubber is not None:
                    try:
                        self.scrubber.scrub()
                    except Exception:
                        self.health.incr("artifacts_scrub_errors")

    def _resolve_result(self, job: Job):
        """Re-hydrate a done job's result from the artifact store,
        RE-VERIFYING the digest. A corrupt artifact is quarantined (by
        the store) and the job degrades to failed — its digest slot is
        not pinned, so a resubmission simply re-proves."""
        if job.result is not None or job.result_digest is None:
            return                       # inline (legacy) or nothing to do
        if self.store is None:
            job.status = "failed"
            job.error = {"kind": "ArtifactCorrupt",
                         "message": "result artifact store unavailable"}
            return
        try:
            job.result = json.loads(self.store.read(job.result_digest))
        except (ArtifactCorrupt, OSError, ValueError) as exc:
            job.status = "failed"
            job.error = _error_dict(exc)
            try:
                self._append({"event": "failed", "job_id": job.id,
                              "error": job.error, "ts": time.time()})
            except Exception:
                self.health.incr("journal_write_failures")

    # -- journal helper ----------------------------------------------------

    def _append(self, record: dict):
        if self.journal is not None:
            self.journal.append(record)

    # -- submission / polling ---------------------------------------------

    def retry_after_s(self) -> float:
        with self._cv:
            return self.retry_after_locked()

    def _admit_locked(self, digest: str):
        """Load-shedding gate (called with _cv held, AFTER the dedup
        check — a retry of known work is free and never shed)."""
        pending = sum(1 for j in self._jobs.values()
                      if j.status == "queued")
        if pending >= self.queue_depth:
            self.health.incr("jobs_shed_queue")
            raise ServiceOverloaded("queue full", self.retry_after_locked())
        if self.mem_watermark_mb > 0:
            rss = rss_mb()
            if rss is not None and rss >= self.mem_watermark_mb:
                self.health.incr("jobs_shed_memory")
                # attribution: name the running jobs (and their RSS
                # high-water marks) the shed protected the box from. No
                # top-level job_id, so journal replay skips the record by
                # design.
                running = [{"job_id": j.id,
                            "peak_rss_mb": RSS_SAMPLER.peak(j.id)}
                           for j in self._jobs.values()
                           if j.status == "running"]
                try:
                    self._append({"event": "shed_memory",
                                  "ts": time.time(),
                                  "rss_mb": round(rss, 1),
                                  "running": running})
                except Exception:
                    self.health.incr("journal_write_failures")
                raise ServiceOverloaded("memory watermark",
                                        self.retry_after_locked())

    def retry_after_locked(self) -> float:
        """Backoff hint for shed submissions: the backlog ahead of a
        retrying client, priced at the p90 of this queue's observed
        prove latency (a single outlier must not inflate the hint the
        way it inflates a mean). Falls back to the ServiceHealth running mean until the queue has
        completed a job of its own.

        Note on wait vs prove: the p90 here covers the PROVE
        only (worker start -> finish); the time a job spends queued is
        modelled by the `backlog / concurrency` factor. The observed
        split is exported separately — `spectre_queue_wait_seconds`
        (admission -> start) vs `spectre_prove_latency_seconds` — and
        every manifest records its own `queue_wait_s`/`prove_s`, so an
        inflated retry hint can be attributed to queueing or to slow
        proves, not guessed at."""
        p90 = self.latency.quantile(0.9)
        if p90 is None:
            p90 = self.health.mean("prove_latency_s",
                                   DEFAULT_PROVE_LATENCY_S)
        backlog = sum(1 for j in self._jobs.values()
                      if j.status in ("queued", "running"))
        est = p90 * max(1.0, float(backlog)) / float(self.concurrency)
        return round(min(max(est, 1.0), 600.0), 3)

    def submit(self, method: str, params: dict,
               timeout: float | None = None,
               deadline_s: float | None = None) -> str:
        """`deadline_s` (client-supplied) CLAMPS the effective per-job
        timeout — a client that must answer its own caller in 60s gets a
        job that gives up by then rather than burning a worker on a
        result nobody will read. Raises :class:`ServiceOverloaded` when
        admission control sheds the submission."""
        arrival = time.time()           # request arrival, pre-admission
        digest = witness_digest(method, params)
        eff_timeout = timeout if timeout is not None else self.default_timeout
        if deadline_s is not None:
            eff_timeout = deadline_s if eff_timeout is None \
                else min(eff_timeout, deadline_s)
        with self._cv:
            existing = self._by_digest.get(digest)
            if existing is not None:
                job = self._jobs.get(existing)
                if job is not None and job.status not in ("failed",
                                                          "cancelled"):
                    self.health.incr("jobs_deduped")
                    return job.id
            self._admit_locked(digest)
            self._seq += 1
            jid = f"{digest[:16]}-{self._seq:04d}"
            # submitted == request arrival, admitted == the instant the
            # admission gate passed; the worker measures queue wait from
            # `admitted` (the job only exists as queue work from then on)
            job = Job(id=jid, method=method, params=params, digest=digest,
                      submitted_at=arrival, admitted_at=time.time(),
                      timeout=eff_timeout)
            self._jobs[jid] = job
            self._by_digest[digest] = jid
        try:
            self._append({"event": "submit", "job_id": jid, "method": method,
                          "params": params, "digest": digest,
                          "timeout": job.timeout, "ts": job.submitted_at,
                          "admitted": job.admitted_at})
        except Exception as exc:
            # a dead journal must not wedge the queue: fail the job loudly
            with self._cv:
                job.status = "failed"
                job.error = _error_dict(exc)
                job.finished_at = time.time()
                self._cv.notify_all()
            self.health.incr("journal_write_failures")
            return jid
        self._q.put(jid)
        self.health.incr("jobs_submitted")
        return jid

    def status(self, job_id: str) -> dict | None:
        with self._cv:
            job = self._jobs.get(job_id)
            if job is None:
                return None
            self._expire_locked(job)
            return job.public()

    def result(self, job_id: str) -> Job | None:
        with self._cv:
            job = self._jobs.get(job_id)
            if job is not None:
                self._expire_locked(job)
            return job

    def wait(self, job_id: str, timeout: float | None = None) -> Job:
        deadline = None if timeout is None else time.time() + timeout
        with self._cv:
            while True:
                job = self._jobs[job_id]
                self._expire_locked(job)
                if job.status in TERMINAL:
                    return job
                remain = None if deadline is None else deadline - time.time()
                if remain is not None and remain <= 0:
                    return job
                self._cv.wait(timeout=min(0.5, remain)
                              if remain is not None else 0.5)

    def cancel(self, job_id: str) -> bool:
        with self._cv:
            job = self._jobs.get(job_id)
            if job is None or job.status in TERMINAL:
                return False
            job.cancel_requested = True
            if job.status == "queued":
                self._finish_locked(job, "cancelled")
                return True
        # running: the worker's result is discarded at completion
        return True

    def stats(self) -> dict:
        with self._cv:
            counts: dict[str, int] = {}
            for job in self._jobs.values():
                counts[job.status] = counts.get(job.status, 0) + 1
            return {"jobs": counts, "workers": self.concurrency,
                    "queue_depth": self.queue_depth}

    def stop(self):
        self._stopped = True
        self._stop_event.set()     # also stops the scrubber's wait loop
        for _ in range(self.concurrency):
            self._q.put(None)

    # -- artifact scrubbing ------------------------------------------------

    def _live_artifacts(self) -> set:
        """(digest, suffix) pairs some known job still references — the
        scrubber's keep-set. Every status counts: a failed job's partial
        artifacts are cheap, and expiry must never race a retry."""
        live = set()
        with self._cv:
            for job in self._jobs.values():
                if job.result_digest is not None:
                    live.add((job.result_digest, ".bin"))
                if job.manifest_digest is not None:
                    live.add((job.manifest_digest,
                              obs_manifest.MANIFEST_SUFFIX))
        for provider in list(self._live_providers):
            # a broken provider propagates: the scrub pass fails (counted
            # by its caller) rather than running with a partial keep-set
            # and expiring artifacts that are actually live
            live |= set(provider())
        return live

    def add_live_provider(self, provider):
        """Register a zero-arg callable returning extra (digest, suffix)
        pairs to protect from orphan expiry (idempotent)."""
        if provider not in self._live_providers:
            self._live_providers.append(provider)

    def scrub_now(self) -> dict:
        """One synchronous scrubber pass (the scrubNow RPC / CLI entry)."""
        if self.scrubber is None:
            return {"scanned": 0, "corrupt": 0, "expired": 0, "skipped": 0}
        return self.scrubber.scrub()

    # -- worker ------------------------------------------------------------

    def _expire_locked(self, job: Job):
        if (job.status == "running" and job.timeout is not None
                and job.started_at is not None
                and time.time() > job.started_at + job.timeout):
            self._finish_locked(job, "failed",
                                error={"kind": "TimeoutError",
                                       "message": f"job exceeded "
                                       f"{job.timeout}s timeout"})
            self.health.incr("jobs_timed_out")

    def _finish_locked(self, job: Job, status: str, result=None, error=None,
                       result_digest=None):
        job.status = status
        job.result = result
        job.result_digest = result_digest
        job.error = error
        job.finished_at = time.time()
        self._cv.notify_all()
        try:
            rec = {"event": status, "job_id": job.id, "ts": job.finished_at}
            # offloaded results journal as their digest; the payload lives
            # in the integrity-checked artifact store
            if result_digest is not None:
                rec["result_digest"] = result_digest
            elif result is not None:
                rec["result"] = result
            if error is not None:
                rec["error"] = error
            if job.peak_rss_mb is not None:
                rec["peak_rss_mb"] = job.peak_rss_mb
            # journal carries the manifest DIGEST only (O(#jobs), like
            # the result artifact); replay re-verifies through the store
            if job.manifest_digest is not None:
                rec["manifest_digest"] = job.manifest_digest
            self._append(rec)
        except Exception:
            # the in-memory state already transitioned; a journal failure
            # here only costs replay fidelity, never a wedged client
            self.health.incr("journal_write_failures")

    def _write_manifest(self, job: Job, *, trace, kernel_events, events,
                        lru_before, peak_rss_mb, finished,
                        result_digest=None, error=None) -> str | None:
        """Build + persist the job's provenance manifest through the
        artifact store (`<sha256>.manifest.json`); returns the digest.

        IO-tolerant by the metrics.write contract: fault site
        `manifest.write` fires inside the store write, and ANY failure
        (broken disk, serialization surprise) counts
        `manifest_write_failures` and returns None — the job still
        finishes, its manifest degrades to absent. Only an InjectedCrash
        propagates (a dead process writes nothing, which is the state
        replay tests recover from)."""
        if self.store is None:
            return None
        try:
            man = obs_manifest.build(
                job_id=job.id, method=job.method,
                witness_digest=job.digest, attempts=job.attempts,
                submitted=job.submitted_at, admitted=job.admitted_at,
                started=job.started_at, finished=finished,
                queue_wait_s=job.queue_wait_s, trace=trace,
                kernel_events=kernel_events, events=events,
                lru_before=lru_before,
                lru_after=obs_manifest.lru_snapshot(),
                peak_rss_mb=peak_rss_mb, result_digest=result_digest,
                error=None if error is None
                else f"{error.get('kind')}: {error.get('message')}")
            return self.store.write(obs_manifest.to_bytes(man),
                                    suffix=obs_manifest.MANIFEST_SUFFIX,
                                    fault_site="manifest.write")
        except faults.InjectedCrash:
            raise
        except Exception:
            self.health.incr("manifest_write_failures")
            return None

    def manifest(self, job_id: str) -> dict | None:
        """Load + RE-VERIFY a job's provenance manifest from the artifact
        store. Returns None when the job has no manifest digest yet (live
        job, crashed worker, tolerated write failure) or when the stored
        bytes fail verification (the store quarantines them) — manifests
        degrade to absent; result-serving rules are unchanged."""
        with self._cv:
            job = self._jobs.get(job_id)
            digest = job.manifest_digest if job is not None else None
        if digest is None or self.store is None:
            return None
        try:
            return obs_manifest.from_bytes(
                self.store.read(digest,
                                suffix=obs_manifest.MANIFEST_SUFFIX))
        except (ArtifactCorrupt, OSError, ValueError):
            self.health.incr("manifest_read_failures")
            return None

    def _beat(self, slot: int, jid: str):
        """Heartbeat stamp — called by the worker between prove phases
        (threaded into the runner as a zero-arg callback)."""
        s = self._slots[slot]
        if s["job"] == jid:
            s["beat"] = self._clock()

    def _owns_slot(self, slot: int) -> bool:
        return self._slots[slot]["thread"] is threading.current_thread()

    def _worker_loop(self, slot: int):
        while True:
            jid = self._q.get()
            # a replaced (previously stalled) worker that wakes back up
            # has LOST its slot: put the item back and die quietly — the
            # replacement thread owns the queue now
            if not self._owns_slot(slot):
                if jid is not None:
                    self._q.put(jid)
                return
            if jid is None or self._stopped:
                return
            with self._cv:
                job = self._jobs.get(jid)
                if job is None or job.status != "queued":
                    continue                    # cancelled / replaced
                job.status = "running"
                job.started_at = time.time()
                job.attempts += 1
                attempt = job.attempts
                # queue-wait decomposition: one float, three sinks — the
                # job record, the manifest, and the
                # spectre_queue_wait_seconds histogram observe the same
                # value. Journals without `admitted` fall back to the
                # submit time.
                job.queue_wait_s = round(
                    max(0.0, job.started_at
                        - (job.admitted_at if job.admitted_at is not None
                           else job.submitted_at)), 6)
                self._slots[slot]["job"] = jid
                self._slots[slot]["beat"] = self._clock()
            obs_metrics.QUEUE_WAIT.observe(job.queue_wait_s)
            try:
                self._append({"event": "running", "job_id": jid,
                              "attempt": attempt, "ts": job.started_at})
            except Exception as exc:
                with self._cv:
                    self._finish_locked(job, "failed",
                                        error=_error_dict(exc))
                    if self._slots[slot]["job"] == jid:
                        self._slots[slot]["job"] = None
                self.health.incr("journal_write_failures")
                continue
            sem = self.semaphore
            heartbeat = (lambda s=slot, j=jid: self._beat(s, j))
            t0 = time.time()
            # per-job attribution: RSS peak + span trace for
            # the runner's lifetime. prove runs ON this thread, so every
            # profiling.phase below the runner attaches to the trace via
            # the thread-local — no plumbing through prove_* signatures.
            RSS_SAMPLER.start(jid)
            # provenance capture: kernel builds and launches,
            # degrade/fault events and table-LRU deltas for the runner's
            # lifetime (builds and events thread-local; launches are
            # process-wide counters)
            lru_before = obs_manifest.lru_snapshot()
            kernel_events: list = []
            run_events: list = []
            job_trace = None
            try:
                if sem is not None:
                    sem.acquire()
                try:
                    with obs_tracing.trace(jid) as tr, \
                            obs_compilelog.capture(kernel_events), \
                            obs_manifest.collect_events(run_events):
                        job_trace = tr
                        if self._runner_heartbeat:
                            result = self.runner(job.method, job.params,
                                                 heartbeat=heartbeat)
                        else:
                            result = self.runner(job.method, job.params)
                finally:
                    if sem is not None:
                        sem.release()
            except faults.InjectedCrash:
                # simulated hard kill: write NOTHING (that is the point —
                # journal replay must recover a torn "running" state) and
                # take this worker down like a dead process would. The
                # sampler entry is still released (a real dead process
                # takes its sampler thread with it; this one is shared).
                RSS_SAMPLER.finish(jid)
                raise
            except Exception as exc:
                peak = RSS_SAMPLER.finish(jid)
                # failed proves get manifests too — "what degraded before
                # it died" is exactly what post-mortems need
                man_digest = self._write_manifest(
                    job, trace=job_trace, kernel_events=kernel_events,
                    events=run_events, lru_before=lru_before,
                    peak_rss_mb=peak, finished=time.time(),
                    error=_error_dict(exc))
                with self._cv:
                    if self._slots[slot]["job"] == jid:
                        self._slots[slot]["job"] = None
                    if not self._owns_slot(slot):
                        return      # disowned: replacement took the slot
                    if job.status == "running":
                        job.peak_rss_mb = peak
                        job.manifest_digest = man_digest
                        self._finish_locked(job, "failed",
                                            error=_error_dict(exc))
                self.health.incr("jobs_failed")
                continue
            peak = RSS_SAMPLER.finish(jid)
            # retry_after estimates feed on real observed latency: the
            # running-mean gauge (healthz view + cold-start fallback),
            # the queue-local p90 pricing histogram, and the registered
            # exposition histogram
            dt = time.time() - t0
            self.health.observe("prove_latency_s", dt)
            self.latency.observe(dt)
            obs_metrics.PROVE_LATENCY.observe(dt)
            # offload the result OUTSIDE the lock (file IO); a write
            # failure (fault site artifact.write) fails the job, never
            # the queue
            digest, offload_err = None, None
            if self.store is not None and self.journal is not None:
                try:
                    digest = self.store.write(_result_blob(result))
                except Exception as exc:
                    offload_err = _error_dict(exc)
            # the provenance manifest is itself an artifact (written
            # before the terminal journal record so that record can carry
            # its digest); its sink is IO-tolerant — see _write_manifest
            man_digest = self._write_manifest(
                job, trace=job_trace, kernel_events=kernel_events,
                events=run_events, lru_before=lru_before,
                peak_rss_mb=peak, finished=time.time(),
                result_digest=None if offload_err is not None else digest,
                error=offload_err)
            with self._cv:
                if self._slots[slot]["job"] == jid:
                    self._slots[slot]["job"] = None
                if not self._owns_slot(slot):
                    # a stalled-then-returned worker: the supervisor
                    # already failed this job and replaced us — discard
                    # the late result and die without touching the slot
                    return
                if job.cancel_requested:
                    self._finish_locked(job, "cancelled")
                    continue
                if job.status != "running":
                    continue                    # expired meanwhile: discard
                job.peak_rss_mb = peak
                job.manifest_digest = man_digest
                if offload_err is not None:
                    self._finish_locked(job, "failed", error=offload_err)
                    self.health.incr("jobs_failed")
                    continue
                self._finish_locked(job, "done", result=result,
                                    result_digest=digest)
            self.health.incr("jobs_done")

    # -- supervision -------------------------------------------------------

    def _supervise_loop(self, interval: float):
        """Watchdog: a worker whose heartbeat is older than
        `stall_timeout` while it owns a job is presumed hung (wedged
        device call, deadlocked extension, ...). Python threads cannot be
        killed, so the job is marked failed(stalled), the thread is
        DISOWNED and a replacement takes over the slot. Bookkeeping only
        — the supervisor never proves inline (state.semaphore is
        non-reentrant)."""
        while not self._stop_event.wait(interval):
            if self._stopped:
                return
            now = self._clock()
            for i, s in enumerate(self._slots):
                jid = s["job"]
                if jid is None or now - s["beat"] <= self.stall_timeout:
                    continue
                with self._cv:
                    if self._slots[i]["job"] != jid:
                        continue               # finished while we looked
                    job = self._jobs.get(jid)
                    if job is not None and job.status == "running":
                        self._finish_locked(
                            job, "failed",
                            error={"kind": "StalledWorker",
                                   "message":
                                   f"worker heartbeat stalled > "
                                   f"{self.stall_timeout}s; worker "
                                   f"replaced"})
                    self._slots[i]["job"] = None
                    self._spawn_worker(i)      # disowns the hung thread
                self.health.incr("workers_replaced")


def _error_dict(exc: BaseException) -> dict:
    return {"kind": type(exc).__name__, "message": str(exc)}


def _result_blob(result) -> bytes:
    """Canonical bytes of a job result for the artifact store (the journal
    records sha256 over exactly these)."""
    return json.dumps(result, sort_keys=True,
                      separators=(",", ":")).encode()


def _accepts_heartbeat(fn) -> bool:
    """Does this runner take a `heartbeat` callback? Inspected once at
    queue construction; plain runner(method, params) callables keep
    working unchanged."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    return any(p.name == "heartbeat" or p.kind == p.VAR_KEYWORD
               for p in sig.parameters.values())


def ensure_jobs(state, journal_dir: str | None = None, runner=None,
                default_timeout: float | None = None, **queue_kw) -> JobQueue:
    """Attach (once) a JobQueue to any prover-state-like object.

    Reuses `state.semaphore`/`state.concurrency` when present so the async
    queue and the blocking/batch paths share one concurrency cap. `runner`
    defaults to the RPC proof dispatcher (heartbeat-aware: the worker's
    stall-detection stamp threads through run_proof_method into
    ProverState.prove_*). Extra `queue_kw` (queue_depth,
    mem_watermark_mb, stall_timeout, ...) pass straight to JobQueue."""
    jobsq = getattr(state, "jobs", None)
    if jobsq is not None:
        return jobsq
    if runner is None:
        from .rpc import run_proof_method
        runner = lambda method, params, heartbeat=None: run_proof_method(
            state, method, params, heartbeat=heartbeat)
    # NOTE: no JobQueue-level semaphore here — the default runner goes
    # through state.prove_* which acquire state.semaphore THEMSELVES
    # (threading.Semaphore is not reentrant; acquiring at both layers
    # deadlocks at concurrency=1). The worker-pool size mirrors the same
    # cap, so queued jobs drain at exactly the governed parallelism.
    jobsq = JobQueue(
        runner,
        concurrency=getattr(state, "concurrency", 1),
        journal_dir=journal_dir if journal_dir is not None
        else getattr(state, "params_dir", None),
        default_timeout=default_timeout, **queue_kw)
    state.jobs = jobsq
    # a Dispatcher runner gets the queue handed back so its SDC
    # quarantine reaches the queue's artifact store
    if hasattr(runner, "attach_queue"):
        runner.attach_queue(jobsq)
    return jobsq
