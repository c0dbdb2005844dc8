"""Proof-farm dispatcher: fault-tolerant dispatch over prover replicas (the
port's copy of `spectre_tpu/prover_service/dispatcher.py`; its journals,
routing and wire are the reference's, so a journal written by either
package replays in the other).

The JobQueue runs every prove on the local ProverState. This module lifts
the queue's worker supervision one level — from threads inside one process
to replicas across hosts — so the service survives a replica dying
mid-prove, a silently corrupting host, or a whole rack going dark:

* **Replicas** register with a capability/health record.
  :class:`LocalReplica` wraps an in-process ProverState (or any runner
  callable — tests use canned runners); :class:`HttpReplica` fronts a
  remote prover via the ``rpc_client`` submit/poll API.
* **Routing** is rendezvous hashing on the witness digest — the
  JobQueue's dedup key — so retries and resubmits of the same witness land
  on the same replica (warm caches) without any shared routing state.
* **Leases**: a replica owns a job only while its heartbeat renews. A
  crashed replica signals nothing (its prove thread just dies); a stalled
  one stops renewing; either way the lease expires and the job is
  re-dispatched with the failed replica excluded
  (``dispatcher_lease_takeovers``). Grants and releases are journaled
  (``dispatcher.leases.jsonl``, fsync'd like the job journal), so a
  dispatcher restart replays open leases as exclusions instead of
  re-trusting the replica that died holding them — combined with the
  queue's witness-digest dedup, a restart never double-proves. The
  port's ProverState renews at every phase boundary of a prove (the
  witness, the layout, the prove, and the aggregation's build), so a
  lease longer than the longest phase holds across a card-length prove.
* **Per-replica circuit breaker** — the beacon breaker machinery
  (utils/breaker.py): N consecutive failures stop a replica receiving
  work for a cooldown, one half-open trial re-admits it. A replica whose
  card fails (``DeviceProveFailed``) fails its dispatch and counts on
  that breaker; nothing re-proves on the CPU.
* **Cross-host verification**: with a ``verify_state``, every proof a
  replica returns is re-verified by the *dispatcher's* host before
  release; a verify failure quarantines the bytes and re-dispatches to a
  *different* replica (``dispatcher_sdc_rerouted``).

The Dispatcher is callable with the JobQueue runner signature
``(method, params, heartbeat=None)``, so ``ensure_jobs(state,
runner=dispatcher)`` points an unchanged queue (and the follower above
it) at the farm. Fault sites ``replica.dispatch`` / ``replica.health`` /
``replica.lease`` / ``replica.register`` (utils/faults.py) make the
whole failover matrix drillable; every ``dispatcher_*`` counter rides
HEALTH.snapshot() into ``/healthz`` and ``/metrics``.

Membership and placement:

* **Dynamic membership with liveness** — replicas announce themselves
  (``registerReplica`` RPC -> :meth:`Dispatcher.register_remote`) with
  a structured :class:`ReplicaCapabilities` record (device kind, memory
  MB, mesh shape, supported methods, max k). Re-announcements are
  heartbeats; a replica silent past ``SPECTRE_REPLICA_TTL_S`` is
  demoted through its circuit breaker and deregistered
  (:meth:`sweep_members`). Joins and leaves are fsync-journaled
  (``dispatcher.members.jsonl``), replayed and compacted like the lease
  journal, so a dispatcher restart reconstructs the fleet — every
  replayed member gets one fresh TTL window to re-announce.
* **Capability-aware placement** — rendezvous hashing stays, but ranks
  the *eligible* set first: aggregation/compression proves go to
  replicas advertising a mesh or the largest memory, k-sized work to
  replicas whose declared ``max_k`` covers the job (the port's states
  carry one aggregation k per variant, ``{"step": 21, "committee": 22}``,
  and both are read). Only when no capable replica is healthy does
  routing fall back to the rest, visibly
  (``dispatcher_placement_fallbacks``).

Nothing here imports torch (prom.py pulls :func:`dispatcher_snapshot`);
the prover imports stay inside the replica prove paths.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
import weakref

from ..observability import manifest as obs_manifest
from ..utils import faults
from ..utils.breaker import BreakerOpen, CircuitBreaker
from ..utils.health import HEALTH

LEASE_JOURNAL_NAME = "dispatcher.leases.jsonl"
MEMBER_JOURNAL_NAME = "dispatcher.members.jsonl"

TTL_ENV = "SPECTRE_REPLICA_TTL_S"
TTL_DEFAULT_S = 60.0
ANNOUNCE_ENV = "SPECTRE_ANNOUNCE_INTERVAL_S"
ANNOUNCE_DEFAULT_S = 15.0

# exclusion-map bound: digests of completed jobs are dropped eagerly;
# this caps pathological churn (many distinct failing digests)
_MAX_EXCLUDED_DIGESTS = 4096


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    return float(v) if v else default


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v else default


class NoReplicaAvailable(RuntimeError):
    """Every candidate replica is excluded, unhealthy, breaker-open or
    has already failed this job."""


def _is_infra_error(exc: BaseException) -> bool:
    """Failures worth failing over: another replica may well succeed.

    Deterministic prover errors (witness rejection, verify failure,
    bad params) re-raise unchanged so the RPC error taxonomy — and any
    caller matching on exception class — sees exactly what a
    single-replica deployment would."""
    if isinstance(exc, (TimeoutError, ConnectionError,
                        faults.InjectedFault, OSError)):
        return True
    # RpcError from an HttpReplica: retry elsewhere only for
    # overload/internal; -32000/-32005-style outcomes are deterministic
    return getattr(exc, "code", None) in (-32001, -32603)


# -- capability records -----------------------------------------------------


class ReplicaCapabilities:
    """Structured capability record a replica announces:
    device kind, memory MB, mesh shape, the set of supported RPC
    methods (None = all) and the largest circuit size (``max_k``) the
    box can prove. ``url`` is where the dispatcher reaches the replica.
    Every field is optional — an empty record constrains nothing, so a
    capability-less fleet routes exactly like before."""

    FIELDS = ("device", "memory_mb", "mesh_shape", "methods", "max_k", "url")

    def __init__(self, device=None, memory_mb=None, mesh_shape=None,
                 methods=None, max_k=None, url=None):
        self.device = str(device) if device else None
        self.memory_mb = float(memory_mb) if memory_mb is not None else None
        self.mesh_shape = (tuple(int(x) for x in mesh_shape)
                           if mesh_shape else None)
        self.methods = set(methods) if methods else None
        self.max_k = int(max_k) if max_k is not None else None
        self.url = str(url) if url else None

    @classmethod
    def coerce(cls, value) -> "ReplicaCapabilities | None":
        """Accept the structured record, a plain dict (the RPC wire
        form), or a bare iterable of method names."""
        if value is None or isinstance(value, cls):
            return value
        if isinstance(value, dict):
            return cls(**{k: v for k, v in value.items() if k in cls.FIELDS})
        return cls(methods=value)

    def supports_method(self, method: str) -> bool:
        return self.methods is None or method in self.methods

    def to_dict(self) -> dict:
        return {
            "device": self.device,
            "memory_mb": self.memory_mb,
            "mesh_shape": list(self.mesh_shape) if self.mesh_shape else None,
            "methods": sorted(self.methods) if self.methods else None,
            "max_k": self.max_k,
            "url": self.url,
        }

    def __repr__(self):
        return f"<ReplicaCapabilities {self.to_dict()}>"


def _agg_ks(k_agg) -> list:
    """The aggregation k of a state: the reference's one int, or the
    port's one per variant ({"step": 21, "committee": 22})."""
    if isinstance(k_agg, dict):
        return list(k_agg.values())
    return [k_agg]


def _agg_k(k_agg, method: str):
    """The aggregation k that proves `method`: the committee's for the
    committee and aggregation-cadence methods, the step's otherwise."""
    if not isinstance(k_agg, dict):
        return k_agg
    kind = "committee" if ("Committee" in method or "Aggregation" in method) \
        else "step"
    return k_agg.get(kind)


def capability_record(state=None, url: str | None = None) -> dict:
    """Best-effort capability record for THIS host, announced by
    ``serve()``'s announce loop. Memory comes from sysconf, the mesh
    shape from ``SPECTRE_MESH_SHAPE``, device kind (the state's torch
    device type, ``cuda`` on the card) and max k (the aggregation's too,
    per variant, when the state compresses) from the ProverState when one
    is given."""
    rec: dict = {"device": None, "memory_mb": None, "mesh_shape": None,
                 "methods": None, "max_k": None, "url": url}
    try:
        pages = os.sysconf("SC_PHYS_PAGES")
        page = os.sysconf("SC_PAGE_SIZE")
        rec["memory_mb"] = round(pages * page / 2 ** 20, 1)
    except (AttributeError, OSError, ValueError):
        pass
    mesh = os.environ.get("SPECTRE_MESH_SHAPE", "")
    if mesh.strip():
        try:
            rec["mesh_shape"] = [int(x) for x in
                                 mesh.replace("x", ",").split(",")
                                 if x.strip()]
        except ValueError:
            pass
    if state is not None:
        device = getattr(state, "device", None)
        if device is not None:
            # the state's torch device type: "cuda" on the card
            rec["device"] = getattr(device, "type", None) or str(device)
        ks = [getattr(state, a, None) for a in ("k_step", "k_committee")]
        if getattr(state, "compress", False):
            ks.extend(_agg_ks(getattr(state, "k_agg", None)))
        ks = [k for k in ks if isinstance(k, int)]
        if ks:
            rec["max_k"] = max(ks)
    return rec


# -- replicas ---------------------------------------------------------------


class Replica:
    """Registration record + prove entry for one prover replica."""

    def __init__(self, replica_id: str, capabilities=None):
        self.replica_id = str(replica_id)
        # structured record; bare method-name sets coerce
        self.caps = ReplicaCapabilities.coerce(capabilities)

    def supports(self, method: str) -> bool:
        return self.caps is None or self.caps.supports_method(method)

    def healthy(self) -> bool:
        faults.check("replica.health")
        return self._healthy()

    def _healthy(self) -> bool:
        return True

    def prove(self, method: str, params: dict, heartbeat=None) -> dict:
        raise NotImplementedError

    def __repr__(self):
        return f"<{type(self).__name__} {self.replica_id}>"


class LocalReplica(Replica):
    """In-process replica: proves on a ProverState (or a custom runner
    callable with the queue-runner signature — tests use canned ones)."""

    def __init__(self, replica_id: str, state=None, runner=None,
                 capabilities=None):
        super().__init__(replica_id, capabilities)
        self.state = state
        self._runner = runner

    def prove(self, method: str, params: dict, heartbeat=None) -> dict:
        faults.check("replica.dispatch")
        if self._runner is not None:
            return self._runner(method, params, heartbeat=heartbeat)
        from .rpc import run_proof_method
        return run_proof_method(self.state, method, params,
                                heartbeat=heartbeat)

    def _healthy(self) -> bool:
        return self.state is not None or self._runner is not None


class HttpReplica(Replica):
    """Remote replica via the resilient rpc_client: submit + poll, each
    status poll renewing the dispatcher lease (heartbeat)."""

    def __init__(self, replica_id: str, client, poll_s: float = 1.0,
                 sleep=time.sleep, capabilities=None):
        super().__init__(replica_id, capabilities)
        self.client = client
        self.poll_s = poll_s
        self._sleep = sleep

    def _healthy(self) -> bool:
        try:
            return self.client.ping() == "pong"
        except faults.InjectedCrash:
            raise
        except Exception:
            return False

    def prove(self, method: str, params: dict, heartbeat=None) -> dict:
        faults.check("replica.dispatch")
        from .rpc import (RPC_METHOD_AGG, RPC_METHOD_AGG_SUBMIT,
                          RPC_METHOD_COMMITTEE, RPC_METHOD_COMMITTEE_SUBMIT,
                          RPC_METHOD_STEP, RPC_METHOD_STEP_SUBMIT)
        submit = {RPC_METHOD_STEP: RPC_METHOD_STEP_SUBMIT,
                  RPC_METHOD_COMMITTEE: RPC_METHOD_COMMITTEE_SUBMIT,
                  RPC_METHOD_AGG: RPC_METHOD_AGG_SUBMIT,
                  }.get(method)
        if submit is None:
            return self.client._call(method, params)
        jid = self.client._call_shedding(
            submit, params,
            timeout=min(self.client.timeout, 60.0))["job_id"]
        while True:
            st = self.client.proof_status(jid)
            if heartbeat is not None:
                heartbeat()      # remote made progress -> renew the lease
            if st["status"] in ("done", "failed", "cancelled"):
                return self.client.proof_result(jid)
            self._sleep(self.poll_s)


# -- registry for /metrics (prom.py) ---------------------------------------

_DISPATCHERS: "weakref.WeakSet" = weakref.WeakSet()


def dispatcher_snapshot() -> list[dict]:
    """Per-replica state of every live Dispatcher, for the Prometheus
    exporter (spectre_replica_* gauges) — mirrors beacon.breaker_snapshot."""
    out: list[dict] = []
    for d in list(_DISPATCHERS):
        out.extend(d.snapshot()["replicas"])
    return out


# -- dispatcher -------------------------------------------------------------


class Dispatcher:
    """Routes queue jobs across replicas with leases, breakers and
    cross-host verification. Callable with the JobQueue runner
    signature, so ``ensure_jobs(state, runner=dispatcher)`` is the whole
    integration."""

    def __init__(self, replicas=(), journal_dir=None, lease_s=None,
                 verify_state=None, health=HEALTH, clock=time.monotonic,
                 poll_s: float = 0.02, health_ttl_s: float = 5.0,
                 breaker_threshold: int | None = None,
                 breaker_cooldown: float | None = None,
                 ttl_s: float | None = None,
                 method_k: dict | None = None):
        self.lease_s = lease_s if lease_s is not None \
            else _env_float("SPECTRE_REPLICA_LEASE_S", 120.0)
        self.ttl_s = ttl_s if ttl_s is not None \
            else _env_float(TTL_ENV, TTL_DEFAULT_S)
        self.verify_state = verify_state
        self.health = health
        self._clock = clock
        self.poll_s = poll_s
        self.health_ttl_s = health_ttl_s
        # per-method circuit-size hints for max-k placement; methods the
        # dict (and the verify_state fallback) don't cover route unhinted
        self.method_k = dict(method_k) if method_k else {}
        self._breaker_threshold = breaker_threshold \
            if breaker_threshold is not None \
            else _env_int("SPECTRE_REPLICA_CB_THRESHOLD", 5)
        self._breaker_cooldown = breaker_cooldown \
            if breaker_cooldown is not None \
            else _env_float("SPECTRE_REPLICA_CB_COOLDOWN", 30.0)
        self._lock = threading.Lock()
        self.replicas: list[Replica] = []
        self._breakers: dict[str, CircuitBreaker] = {}
        self._stats: dict[str, dict] = {}
        self._excluded: dict[str, set] = {}     # digest -> failed replica ids
        self._takeover_due: set[str] = set()    # digests with a dead lease
        self._active: dict[str, str] = {}       # digest -> replica id
        self._health_cache: dict[str, tuple] = {}
        self._heartbeats: dict[str, float] = {}  # rid -> last announce
        self._dynamic: set[str] = set()          # TTL-governed member ids
        self._queue = None                      # attached by ensure_jobs
        for r in replicas:
            self.register(r)
        self._journal_path = None
        self._member_journal_path = None
        if journal_dir is not None:
            os.makedirs(journal_dir, exist_ok=True)
            self._journal_path = os.path.join(journal_dir, LEASE_JOURNAL_NAME)
            self._member_journal_path = os.path.join(journal_dir,
                                                     MEMBER_JOURNAL_NAME)
            self._replay_journal()
            self._replay_members()
        _DISPATCHERS.add(self)

    # -- registration ------------------------------------------------------

    def register(self, replica: Replica, dynamic: bool = False) -> None:
        with self._lock:
            if any(r.replica_id == replica.replica_id for r in self.replicas):
                raise ValueError(f"duplicate replica id {replica.replica_id}")
            self.replicas.append(replica)
            if replica.replica_id not in self._breakers:
                self._breakers[replica.replica_id] = CircuitBreaker(
                    threshold=self._breaker_threshold,
                    cooldown=self._breaker_cooldown,
                    health=self.health, counter_prefix="dispatcher_breaker")
            if dynamic:
                self._dynamic.add(replica.replica_id)
                self._heartbeats[replica.replica_id] = self._clock()
        self.health.incr("dispatcher_replicas_registered")

    def register_remote(self, replica_id: str, url: str | None = None,
                        capabilities=None, _journal: bool = True) -> dict:
        """``registerReplica`` RPC entry: first announce joins the fleet
        as a TTL-governed :class:`HttpReplica`; re-announces are
        heartbeats that refresh the capability record. A re-join after a
        TTL deregistration keeps the replica's existing breaker — an
        open breaker stays open, so a flapping box earns readmission
        through the half-open trial like any other failure."""
        faults.check("replica.register")
        rid = str(replica_id)
        caps = ReplicaCapabilities.coerce(capabilities)
        if caps is not None and url and caps.url is None:
            caps.url = str(url)
        with self._lock:
            existing = next((r for r in self.replicas
                             if r.replica_id == rid), None)
        if existing is None:
            if not url:
                raise ValueError(
                    f"registerReplica for {rid} needs a url to dial back")
            from .rpc_client import ProverClient
            replica = HttpReplica(
                rid, ProverClient(url),
                capabilities=caps or ReplicaCapabilities(url=url))
            self.register(replica, dynamic=True)
            self.health.incr("dispatcher_members_joined")
            if _journal:
                self._member_journal({
                    "event": "join", "replica": rid, "url": url,
                    "capabilities": replica.caps.to_dict(),
                    "ts": time.time()})
        else:
            if caps is not None:
                existing.caps = caps
            if url and isinstance(existing, HttpReplica) \
                    and url not in existing.client.urls:
                existing.client.url = url   # replica moved (new port)
            with self._lock:
                self._heartbeats[rid] = self._clock()
            self.health.incr("dispatcher_heartbeats")
        return {"replica_id": rid, "ttl_s": self.ttl_s,
                "members": len(self.replicas)}

    def deregister(self, replica_id: str, reason: str = "manual") -> bool:
        """Remove a replica from membership (journaled). Breaker and
        dispatch stats survive, so a later re-join keeps its history."""
        rid = str(replica_id)
        with self._lock:
            before = len(self.replicas)
            self.replicas = [r for r in self.replicas
                             if r.replica_id != rid]
            removed = len(self.replicas) < before
            self._dynamic.discard(rid)
            self._heartbeats.pop(rid, None)
            self._health_cache.pop(rid, None)
        if removed:
            self.health.incr("dispatcher_members_left")
            self._member_journal({"event": "leave", "replica": rid,
                                  "reason": reason, "ts": time.time()})
        return removed

    def sweep_members(self) -> list[str]:
        """Liveness sweep (clock-driven — called from dispatch() and
        snapshot(), no background thread): a dynamic member whose last
        announce is older than ``ttl_s`` is demoted through its existing
        circuit breaker (in-flight routing stops admitting it before it
        is even gone) and then deregistered, journaled as a leave."""
        now = self._clock()
        with self._lock:
            expired = [rid for rid in self._dynamic
                       if now - self._heartbeats.get(rid, 0.0) > self.ttl_s]
        for rid in expired:
            br = self._breakers.get(rid)
            while br is not None and br.state != "open":
                br.record(False)
            self.deregister(rid, reason="ttl")
            self.health.incr("dispatcher_member_ttl_expired")
        return expired

    def breaker(self, replica_id: str) -> CircuitBreaker:
        return self._breakers[replica_id]

    def attach_queue(self, jobsq) -> None:
        """Called by ensure_jobs: gives the dispatcher the queue's
        artifact store (SDC quarantine) without a constructor cycle."""
        self._queue = jobsq

    # -- lease journal -----------------------------------------------------

    def _replay_journal(self):
        try:
            with open(self._journal_path, "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            return
        open_leases: dict[str, str] = {}
        failed: list[tuple] = []
        lines = 0
        for line in raw.split(b"\n"):
            if not line.strip():
                continue
            lines += 1
            try:
                rec = json.loads(line)
            except ValueError:
                continue        # torn tail (crash mid-append)
            ev = rec.get("event")
            if ev == "lease":
                open_leases[rec["digest"]] = rec["replica"]
            elif ev == "release":
                open_leases.pop(rec["digest"], None)
                if rec.get("outcome") != "done":
                    failed.append((rec["digest"], rec["replica"]))
        for digest, rid in failed:
            self._excluded.setdefault(digest, set()).add(rid)
        for digest, rid in open_leases.items():
            # the previous dispatcher died while this replica held the
            # lease: don't re-trust it for this digest, and count the
            # first re-grant as a takeover
            self._excluded.setdefault(digest, set()).add(rid)
            self._takeover_due.add(digest)
            self.health.incr("dispatcher_leases_replayed")
        # startup compaction: keep only what replay needs — the full
        # grant/release history grows without bound on a long-lived head
        kept = len(open_leases) + len(failed)
        if lines > kept:
            self._compact_journal(open_leases, failed)

    def _compact_journal(self, open_leases: dict, failed: list):
        """Atomically rewrite the lease journal down to its replay
        fixpoint (the JobJournal.compact idiom): one `lease` record per
        still-open lease and one failed `release` per exclusion —
        replaying the compacted file reconstructs exactly the state
        replaying the full history did. Crash-safe: the rewrite is
        staged to a sidecar, fsync'd, then `os.replace`d; a crash in the
        staged-but-unswapped window (fault site `replica.lease_compact`)
        leaves the ORIGINAL journal untouched and the next startup
        re-compacts. IO errors are tolerated (the journal keeps its full
        history, counted on dispatcher_lease_compact_failures)."""
        tmp = self._journal_path + ".compact"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                for digest, rid in sorted(failed):
                    # a release with no prior grant replays straight
                    # into the exclusion set
                    f.write(json.dumps(
                        {"event": "release", "digest": digest,
                         "replica": rid, "outcome": "failed"},
                        sort_keys=True) + "\n")
                for digest, rid in sorted(open_leases.items()):
                    f.write(json.dumps(
                        {"event": "lease", "digest": digest,
                         "replica": rid}, sort_keys=True) + "\n")
                f.flush()
                # crash window: sidecar staged, original journal intact
                faults.check("replica.lease_compact")
                os.fsync(f.fileno())
            os.replace(tmp, self._journal_path)
            try:
                dfd = os.open(os.path.dirname(self._journal_path) or ".",
                              os.O_RDONLY)
                try:
                    os.fsync(dfd)
                finally:
                    os.close(dfd)
            except OSError:
                pass
            self.health.incr("dispatcher_lease_compactions")
        except faults.InjectedCrash:
            raise
        except Exception:
            self.health.incr("dispatcher_lease_compact_failures")

    def _journal(self, rec: dict):
        """fsync'd append; `replica.lease` fires AFTER a grant lands on
        disk (the post-append crash window journal replay must cover).
        IO errors are tolerated — the farm keeps proving with in-memory
        lease state, counted on dispatcher_lease_journal_failures."""
        try:
            if self._journal_path is not None:
                with open(self._journal_path, "a", encoding="utf-8") as f:
                    f.write(json.dumps(rec, sort_keys=True) + "\n")
                    f.flush()
                    os.fsync(f.fileno())
            if rec.get("event") == "lease":
                faults.check("replica.lease")
        except faults.InjectedCrash:
            raise
        except Exception:
            self.health.incr("dispatcher_lease_journal_failures")

    # -- membership journal ------------------------------------------------

    def _member_journal(self, rec: dict):
        """fsync'd append of a join/leave — same tolerance contract as
        the lease journal: IO errors keep the in-memory fleet authoritative,
        counted on dispatcher_member_journal_failures."""
        if self._member_journal_path is None:
            return
        try:
            with open(self._member_journal_path, "a",
                      encoding="utf-8") as f:
                f.write(json.dumps(rec, sort_keys=True) + "\n")
                f.flush()
                os.fsync(f.fileno())
        except Exception:
            self.health.incr("dispatcher_member_journal_failures")

    def _replay_members(self):
        """Reconstruct the fleet from ``dispatcher.members.jsonl``: last
        join/leave per replica id wins. A restored member re-dials its
        announced url and gets ONE fresh TTL window — it either
        re-announces (it survived the dispatcher restart) or the next
        sweep deregisters it. Statically-registered ids are never
        shadowed by the journal."""
        try:
            with open(self._member_journal_path, "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            return
        live: dict[str, dict] = {}
        lines = 0
        for line in raw.split(b"\n"):
            if not line.strip():
                continue
            lines += 1
            try:
                rec = json.loads(line)
            except ValueError:
                continue        # torn tail (crash mid-append)
            ev = rec.get("event")
            if ev == "join" and rec.get("replica"):
                live[rec["replica"]] = rec
            elif ev == "leave":
                live.pop(rec.get("replica"), None)
        for rid, rec in live.items():
            url = rec.get("url")
            if not url or any(r.replica_id == rid for r in self.replicas):
                continue
            try:
                from .rpc_client import ProverClient
                caps = ReplicaCapabilities.coerce(rec.get("capabilities")) \
                    or ReplicaCapabilities(url=url)
                self.register(HttpReplica(rid, ProverClient(url),
                                          capabilities=caps), dynamic=True)
                self.health.incr("dispatcher_members_replayed")
            except Exception:
                continue        # malformed record: membership is best-effort
        if lines > len(live):
            self._compact_members(live)

    def _compact_members(self, live: dict):
        """Rewrite the member journal to its replay fixpoint — one join
        per live member — with the lease-compaction idiom: staged
        sidecar, fsync, atomic replace; IO failures keep the full
        history (dispatcher_member_compact_failures)."""
        tmp = self._member_journal_path + ".compact"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                for rid in sorted(live):
                    f.write(json.dumps(live[rid], sort_keys=True) + "\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._member_journal_path)
            try:
                dfd = os.open(
                    os.path.dirname(self._member_journal_path) or ".",
                    os.O_RDONLY)
                try:
                    os.fsync(dfd)
                finally:
                    os.close(dfd)
            except OSError:
                pass
            self.health.incr("dispatcher_member_compactions")
        except Exception:
            self.health.incr("dispatcher_member_compact_failures")

    # -- routing -----------------------------------------------------------

    def _healthy_cached(self, replica: Replica) -> bool:
        now = self._clock()
        cached = self._health_cache.get(replica.replica_id)
        if cached is not None and now - cached[0] < self.health_ttl_s:
            return cached[1]
        try:
            ok = bool(replica.healthy())
        except faults.InjectedCrash:
            raise
        except Exception:
            ok = False
        self._health_cache[replica.replica_id] = (now, ok)
        return ok

    def _method_k(self, method: str) -> int | None:
        """Circuit-size hint for max-k placement: an explicit
        ``method_k`` entry wins, else the verify_state's own k knobs
        (the dispatcher head is configured like its replicas)."""
        if method in self.method_k:
            return self.method_k[method]
        vs = self.verify_state
        if vs is None:
            return None
        if getattr(vs, "compress", False):
            k = _agg_k(getattr(vs, "k_agg", None), method)
        elif "Committee" in method or "Aggregation" in method:
            k = getattr(vs, "k_committee", None)
        else:
            k = getattr(vs, "k_step", None)
        return k if isinstance(k, int) else None

    def _eligible(self, method: str) -> tuple[set, bool]:
        """Capability-aware eligible set. Returns
        ``(eligible_ids, constrained)`` — constrained=False means the
        fleet advertises nothing to distinguish on for this method and
        routing degenerates to plain rendezvous."""
        with self._lock:
            replicas = list(self.replicas)
        eligible = {r.replica_id for r in replicas}
        constrained = False
        if "Aggregation" in method:
            # the big compression prove wants a mesh or the biggest box
            meshy = {r.replica_id for r in replicas
                     if r.caps is not None and r.caps.mesh_shape}
            mems = [(r.caps.memory_mb, r.replica_id) for r in replicas
                    if r.caps is not None and r.caps.memory_mb is not None]
            big = set()
            if mems:
                top = max(mb for mb, _ in mems)
                big = {rid for mb, rid in mems if mb == top}
            if meshy or big:
                eligible &= meshy | big
                constrained = True
        k = self._method_k(method)
        if k is not None:
            # only replicas DECLARING a too-small max_k are ruled out;
            # an undeclared max_k constrains nothing
            small = {r.replica_id for r in replicas
                     if r.caps is not None and r.caps.max_k is not None
                     and r.caps.max_k < k}
            if small:
                eligible -= small
                constrained = True
        return eligible, constrained

    def _route(self, method: str, digest: str, excluded) -> Replica | None:
        """Rendezvous hashing: stable per-digest replica ranking with no
        shared routing state — the same witness always prefers the same
        replica, and losing a replica only moves its own keys. With
        capability constraints the eligible set ranks first; dispatching
        from the remainder is a visible fallback
        (``dispatcher_placement_fallbacks``)."""
        ranked = sorted(self.replicas, key=lambda r: hashlib.sha256(
            f"{digest}|{r.replica_id}".encode()).hexdigest())
        eligible, constrained = self._eligible(method)
        if constrained:
            tiers = [[r for r in ranked if r.replica_id in eligible],
                     [r for r in ranked if r.replica_id not in eligible]]
        else:
            tiers = [ranked]
        for tier_i, pool in enumerate(tiers):
            for replica in pool:
                rid = replica.replica_id
                if rid in excluded or not replica.supports(method):
                    continue
                try:
                    self._breakers[rid].admit()
                except BreakerOpen:
                    self.health.incr("dispatcher_breaker_skips")
                    continue
                if not self._healthy_cached(replica):
                    self.health.incr("dispatcher_replica_unhealthy")
                    continue
                if tier_i == 1:
                    self.health.incr("dispatcher_placement_fallbacks")
                return replica
        return None

    # -- lease lifecycle ---------------------------------------------------

    def _grant(self, digest: str, rid: str, takeover: bool):
        with self._lock:
            self._active[digest] = rid
            self._stats[rid] = st = self._stats.get(
                rid, {"dispatched": 0, "failures": 0})
            st["dispatched"] += 1
        self.health.incr("dispatcher_jobs_dispatched")
        if takeover:
            self.health.incr("dispatcher_lease_takeovers")
        obs_manifest.record_event("replica_lease", replica=rid,
                                  takeover=bool(takeover))
        self._journal({"event": "lease", "digest": digest, "replica": rid,
                       "lease_s": self.lease_s, "takeover": bool(takeover),
                       "ts": time.time()})

    def _release(self, digest: str, rid: str, outcome: str):
        with self._lock:
            self._active.pop(digest, None)
            if outcome != "done" and rid in self._stats:
                self._stats[rid]["failures"] += 1
        self._journal({"event": "release", "digest": digest, "replica": rid,
                       "outcome": outcome, "ts": time.time()})

    def _exclude(self, digest: str, rid: str):
        with self._lock:
            self._excluded.setdefault(digest, set()).add(rid)
            while len(self._excluded) > _MAX_EXCLUDED_DIGESTS:
                self._excluded.pop(next(iter(self._excluded)))

    def _run_leased(self, replica: Replica, method: str, params: dict,
                    heartbeat):
        """Run one prove under a lease. Returns (outcome, result, exc):
        outcome is "ok", "error" (replica raised), "crashed" (replica
        thread died signalling nothing — InjectedCrash semantics), or
        "expired" (heartbeat stopped renewing; thread disowned)."""
        lease = {"expires": self._clock() + self.lease_s}

        def renew():
            lease["expires"] = self._clock() + self.lease_s
            if heartbeat is not None:
                heartbeat()

        done = threading.Event()
        box: dict = {}

        def work():
            try:
                box["result"] = replica.prove(method, params, heartbeat=renew)
            except faults.InjectedCrash:
                # a dead replica writes nothing and renews nothing: no
                # done.set() (deliberately NOT try/finally) — the main
                # loop sees a dead thread and takes the lease back
                return
            except BaseException as exc:    # noqa: BLE001 — relayed below
                box["exc"] = exc
            done.set()

        t = threading.Thread(target=work, daemon=True,
                             name=f"replica-{replica.replica_id}")
        t.start()
        while True:
            if done.wait(self.poll_s):
                if "exc" in box:
                    return "error", None, box["exc"]
                return "ok", box["result"], None
            if heartbeat is not None:
                heartbeat()     # supervising IS progress (queue-level stall
                                # detection defers to lease expiry here)
            if not t.is_alive():
                if done.is_set():   # finished in the wait/is_alive window
                    continue
                return "crashed", None, None
            if self._clock() >= lease["expires"]:
                self.health.incr("dispatcher_lease_expired")
                return "expired", None, None    # thread disowned

    # -- dispatch ----------------------------------------------------------

    def __call__(self, method: str, params: dict, heartbeat=None) -> dict:
        return self.dispatch(method, params, heartbeat=heartbeat)

    def dispatch(self, method: str, params: dict, heartbeat=None) -> dict:
        from .jobs import witness_digest
        self.sweep_members()
        digest = witness_digest(method, params)
        with self._lock:
            excluded = set(self._excluded.get(digest, ()))
            lease_failed = digest in self._takeover_due
            self._takeover_due.discard(digest)
        tried: set[str] = set()
        sdc_from: str | None = None
        last_exc: BaseException | None = None
        while True:
            replica = self._route(method, digest, excluded | tried)
            if replica is None:
                self.health.incr("dispatcher_no_replica")
                err = NoReplicaAvailable(
                    f"no replica available for {method} (digest "
                    f"{digest[:12]}…, {len(tried)} failed this dispatch, "
                    f"{len(excluded)} excluded, "
                    f"{len(self.replicas)} registered)")
                raise err from last_exc
            rid = replica.replica_id
            self._grant(digest, rid, takeover=lease_failed)
            lease_failed = False
            outcome, result, exc = self._run_leased(
                replica, method, params, heartbeat)
            br = self._breakers[rid]

            if outcome == "ok":
                br.record(True)
                verified = True
                if self.verify_state is not None:
                    from . import selfverify
                    verified = selfverify.cross_verify(
                        self.verify_state, method, result,
                        health=self.health)
                if verified:
                    self._release(digest, rid, "done")
                    with self._lock:
                        self._excluded.pop(digest, None)
                    if sdc_from is not None:
                        obs_manifest.record_event(
                            "sdc_reroute", from_replica=sdc_from,
                            to_replica=rid)
                    return result
                # SDC: this replica's host produced bytes its own
                # verifier liked but ours rejects — quarantine, stop
                # trusting the host for this job, re-prove elsewhere
                self._quarantine_result(result)
                br.record(False)
                self._release(digest, rid, "sdc")
                self._exclude(digest, rid)
                tried.add(rid)
                self.health.incr("dispatcher_sdc_rerouted")
                if sdc_from is not None:
                    # two hosts produced unverifiable proofs: that's not
                    # an SDC, the job is bad — same terminal error as the
                    # single-host path
                    from .selfverify import ProofVerifyFailed, proof_kind
                    raise ProofVerifyFailed(proof_kind(method))
                sdc_from = rid
                continue

            br.record(False)
            self.health.incr("dispatcher_replica_failures")
            self._release(digest, rid, outcome)
            if outcome == "error" and not _is_infra_error(exc):
                raise exc       # deterministic prover error: unchanged
            self._exclude(digest, rid)
            tried.add(rid)
            last_exc = exc
            lease_failed = True     # next grant is a takeover

    def _quarantine_result(self, result):
        store = getattr(getattr(self._queue, "store", None),
                        "quarantine_bytes", None)
        if store is None:
            return
        try:
            from .selfverify import decode_result
            proof, _ = decode_result(result)
            store(proof, suffix=".proof")
        except Exception:
            pass    # quarantine is best-effort; the reroute is the fix

    # -- introspection -----------------------------------------------------

    def snapshot(self) -> dict:
        """Per-replica state for /healthz and the Prometheus gauges —
        including each member's capability record and announce-heartbeat
        age. Snapshotting also runs the liveness sweep, so a
        scraped-but-idle dispatcher still expires silent members."""
        self.sweep_members()
        now = self._clock()
        with self._lock:
            reps = []
            for r in self.replicas:
                rid = r.replica_id
                cached = self._health_cache.get(rid)
                st = self._stats.get(rid, {"dispatched": 0, "failures": 0})
                hb = self._heartbeats.get(rid)
                reps.append({
                    "replica_id": rid,
                    "breaker": self._breakers[rid].snapshot(),
                    "healthy": None if cached is None else bool(cached[1]),
                    "active_leases": sum(
                        1 for v in self._active.values() if v == rid),
                    "dispatched": st["dispatched"],
                    "failures": st["failures"],
                    "dynamic": rid in self._dynamic,
                    "capabilities": (None if r.caps is None
                                     else r.caps.to_dict()),
                    "url": None if r.caps is None else r.caps.url,
                    "last_heartbeat_age_s": (None if hb is None
                                             else round(now - hb, 3)),
                })
            return {"replicas": reps, "lease_s": self.lease_s,
                    "ttl_s": self.ttl_s,
                    "members": len(self.replicas),
                    "dynamic_members": len(self._dynamic),
                    "active_leases": len(self._active),
                    "excluded_digests": len(self._excluded)}
