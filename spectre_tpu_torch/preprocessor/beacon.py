"""Resilient Beacon-chain REST client (stdlib urllib; no external deps; the
port's copy of `spectre_tpu/preprocessor/beacon.py`).

Reference parity: the `beacon-api-client` usage in `preprocessor/src/lib.rs`:
light-client endpoints for finality updates, committee updates and bootstrap.
Network egress may be unavailable in dev environments; everything above this
client consumes plain dicts, so tests inject fixtures instead.

Resilience: upstream beacon nodes hiccup constantly under
load — a client that gives up on the first transient error starves the
prover. Every GET therefore runs under:

* **retry with exponential backoff + full jitter** — transient failures
  (HTTP 5xx/429, connection errors, timeouts) retry up to
  `SPECTRE_BEACON_RETRIES` times with `delay = U(0, min(max, base*2^i))`
  (full jitter decorrelates a retrying fleet); non-transient HTTP 4xx
  raise immediately.
* **Retry-After honor** — a 429/503 carrying Retry-After waits at least
  that long (seconds form; HTTP-date form falls back to the backoff).
* **per-attempt vs total deadline split** — each attempt gets at most
  `timeout` (per-attempt) but the whole call never exceeds
  `SPECTRE_BEACON_TOTAL_TIMEOUT`; the last attempt's socket timeout is
  clipped to the remaining budget.
* **circuit breaker** — `SPECTRE_BEACON_CB_THRESHOLD` consecutive
  failures trip the breaker OPEN: calls fail fast (CircuitBreakerOpen)
  without touching the network for `SPECTRE_BEACON_CB_COOLDOWN` seconds,
  then HALF-OPEN admits one trial request — success closes the breaker,
  failure re-opens it for another cooldown.

Retries/trips/half-opens are counted on utils.health (HEALTH) and the
fault-injection site `beacon.fetch` (utils/faults) fires before each
attempt, so every path above is deterministically testable in CI.

The breaker state machine is ``utils/breaker.CircuitBreaker`` (the
dispatcher reuses it per prover replica); this client keeps its public
surface on top. Beside it:
:class:`BeaconQuorum` — an N-client pool that only acts on a finalized
head at least ``quorum`` beacons agree on, demoting a lone dissenting
(lying or forked) beacon behind its own breaker so it cannot stall or
fork the follower chain (``beacon_quorum_dissent`` counts it).
"""

from __future__ import annotations

import json
import os
import random
import time
import urllib.error
import urllib.request

from ..utils import faults
from ..utils.breaker import BreakerOpen, CircuitBreaker
from ..utils.health import HEALTH


class CircuitBreakerOpen(RuntimeError):
    """Failing fast: the breaker is open (upstream considered down)."""


class QuorumNotReached(RuntimeError):
    """The beacon pool could not assemble `quorum` matching finalized
    heads — no single answer is trustworthy enough to act on."""


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    return float(v) if v else default


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v else default


def _is_transient(exc: BaseException) -> bool:
    if isinstance(exc, urllib.error.HTTPError):
        return exc.code >= 500 or exc.code == 429
    return isinstance(exc, (urllib.error.URLError, TimeoutError,
                            ConnectionError, OSError))


def _retry_after_seconds(exc: BaseException) -> float | None:
    """Seconds-form Retry-After from a 429/503 response, if present."""
    hdrs = getattr(exc, "headers", None)
    if hdrs is None:
        return None
    ra = hdrs.get("Retry-After")
    if ra is None:
        return None
    try:
        return max(0.0, float(ra))
    except ValueError:
        return None     # HTTP-date form: fall back to computed backoff


# live-client registry for readiness reporting: GET /healthz consults the
# breaker state of every BeaconClient this process created (weak refs — a
# dropped client leaves the registry; no lifecycle coupling to the service)
import weakref

_CLIENTS: "weakref.WeakSet" = weakref.WeakSet()


# numeric codes for the Prometheus exporter (a gauge can't carry a
# string; alerting rules compare against these)
BREAKER_STATE_CODES = {"closed": 0, "half-open": 1, "open": 2}


def breaker_snapshot() -> list[dict]:
    """Breaker state of every live BeaconClient, for /healthz readiness:
    an OPEN breaker means the upstream beacon is considered down and the
    service cannot make proving progress that needs fresh chain data —
    the readiness probe turns 503."""
    return [{"base_url": c.base_url, "state": c.breaker_state,
             "state_code": BREAKER_STATE_CODES.get(c.breaker_state, -1),
             "consecutive_failures": c._consecutive_failures}
            for c in list(_CLIENTS)]


class BeaconClient:
    def __init__(self, base_url: str, timeout: float = 30.0,
                 retries: int | None = None,
                 backoff_base: float | None = None,
                 backoff_max: float | None = None,
                 total_timeout: float | None = None,
                 breaker_threshold: int | None = None,
                 breaker_cooldown: float | None = None,
                 health=HEALTH, sleep=time.sleep, rng=random.random):
        """`timeout` is PER-ATTEMPT; `total_timeout` caps the whole
        retried call. `sleep`/`rng` are injectable for deterministic
        tests (rng() in [0,1) scales the full-jitter backoff)."""
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.retries = retries if retries is not None \
            else _env_int("SPECTRE_BEACON_RETRIES", 4)
        self.backoff_base = backoff_base if backoff_base is not None \
            else _env_float("SPECTRE_BEACON_BACKOFF_BASE", 0.25)
        self.backoff_max = backoff_max if backoff_max is not None \
            else _env_float("SPECTRE_BEACON_BACKOFF_MAX", 8.0)
        self.total_timeout = total_timeout if total_timeout is not None \
            else _env_float("SPECTRE_BEACON_TOTAL_TIMEOUT", 120.0)
        self.breaker_threshold = breaker_threshold \
            if breaker_threshold is not None \
            else _env_int("SPECTRE_BEACON_CB_THRESHOLD", 5)
        self.breaker_cooldown = breaker_cooldown \
            if breaker_cooldown is not None \
            else _env_float("SPECTRE_BEACON_CB_COOLDOWN", 30.0)
        self.health = health
        self._sleep = sleep
        self._rng = rng
        # breaker state machine shared with the dispatcher (utils/breaker)
        self._breaker = CircuitBreaker(
            threshold=self.breaker_threshold,
            cooldown=self.breaker_cooldown,
            health=health, counter_prefix="beacon_breaker")
        _CLIENTS.add(self)     # readiness registry (breaker_snapshot)

    # -- circuit breaker ---------------------------------------------------

    @property
    def breaker_state(self) -> str:
        return self._breaker.state

    @property
    def _consecutive_failures(self) -> int:
        return self._breaker.consecutive_failures

    def _breaker_admit(self):
        try:
            self._breaker.admit()
        except BreakerOpen:
            raise CircuitBreakerOpen(
                f"beacon circuit breaker open for another "
                f"{self._breaker.remaining():.1f}s after "
                f"{self._consecutive_failures} consecutive failures") \
                from None

    def _breaker_record(self, ok: bool):
        self._breaker.record(ok)

    def demote(self) -> None:
        """Penalize this beacon without a network call: a quorum
        dissent (divergent finalized head) counts as a failure, so a
        persistently lying/forked beacon trips its own breaker and
        drops out of the pool until cooldown."""
        self._breaker.record(False)
        self.health.incr("beacon_demoted")

    # -- retried GET -------------------------------------------------------

    def _get(self, path: str) -> dict:
        # spanned: beacon IO becomes a real `beacon/fetch`
        # child under job/preprocess in getTrace (and the phase
        # histogram) instead of unattributed converter time; the span
        # covers the FULL retry loop, annotated with path + attempts
        from ..observability import tracing
        from ..utils.profiling import phase
        with phase("beacon/fetch"):
            tracing.annotate(path=path)
            return self._get_retrying(path)

    def _get_retrying(self, path: str) -> dict:
        self._breaker_admit()
        url = self.base_url + path
        deadline = time.time() + self.total_timeout
        attempt = 0
        while True:
            remain = deadline - time.time()
            if remain <= 0:
                self._breaker_record(False)
                raise TimeoutError(
                    f"beacon GET {path}: total deadline "
                    f"({self.total_timeout}s) exceeded after "
                    f"{attempt} attempts")
            try:
                faults.check("beacon.fetch")
                req = urllib.request.Request(
                    url, headers={"Accept": "application/json"})
                with urllib.request.urlopen(
                        req, timeout=min(self.timeout, remain)) as resp:
                    data = json.load(resp)
                self._breaker_record(True)
                return data
            except faults.InjectedCrash:
                raise
            except Exception as exc:
                self._breaker_record(False)
                if not _is_transient(exc):
                    raise
                if self.breaker_state == "open":
                    # tripped mid-call: stop hammering a dead upstream
                    raise CircuitBreakerOpen(
                        f"beacon circuit breaker tripped during GET {path} "
                        f"({self._consecutive_failures} consecutive "
                        f"failures)") from exc
                if attempt >= self.retries:
                    raise
                delay = min(self.backoff_max,
                            self.backoff_base * (2 ** attempt)) * self._rng()
                ra = _retry_after_seconds(exc)
                if ra is not None:
                    delay = max(delay, ra)
                delay = min(delay, max(0.0, deadline - time.time()))
                self.health.incr("beacon_retries")
                self._sleep(delay)
                attempt += 1

    # -- endpoints ---------------------------------------------------------

    def finality_update(self) -> dict:
        return self._get("/eth/v1/beacon/light_client/finality_update")["data"]

    def committee_updates(self, period: int, count: int = 1) -> list[dict]:
        data = self._get(f"/eth/v1/beacon/light_client/updates"
                         f"?start_period={period}&count={count}")
        return [d["data"] for d in data] if isinstance(data, list) else [data["data"]]

    def bootstrap(self, block_root: str) -> dict:
        return self._get(f"/eth/v1/beacon/light_client/bootstrap/{block_root}")["data"]

    def head_block_root(self) -> str:
        return self._get("/eth/v1/beacon/blocks/head/root")["data"]["root"]

    def sync_period(self, spec, slot: int) -> int:
        return spec.sync_period(slot)


class BeaconQuorum:
    """N-beacon pool requiring `quorum` agreement on the finalized head.

    The follower's head tracker polls one beacon today; a lying (or
    long-forked) beacon can stall the chain or feed it a head the
    committee chain will never verify against. The quorum pool polls
    every non-breaker-open client, groups their finalized headers by
    canonical JSON, and only returns a head at least ``quorum`` beacons
    agree on. A dissenting minority is demoted behind each client's own
    breaker (``beacon_quorum_dissent``), so one bad beacon degrades to
    harmless noise instead of a fork.

    Drop-in for :class:`BeaconClient` where the follower consumes it:
    `finality_update` / `committee_updates` / `bootstrap` /
    `head_block_root` / `sync_period` are provided; the non-quorum
    endpoints simply fail over through healthy clients in order.
    """

    def __init__(self, clients, quorum: int | None = None, health=HEALTH):
        if not clients:
            raise ValueError("BeaconQuorum needs at least one BeaconClient")
        self.clients = list(clients)
        self.quorum = min(len(self.clients),
                          quorum if quorum is not None
                          else _env_int("SPECTRE_BEACON_QUORUM", 2))
        self.health = health

    # -- quorum head -------------------------------------------------------

    @staticmethod
    def _head_key(update: dict) -> str:
        hdr = update.get("finalized_header", update)
        return json.dumps(hdr, sort_keys=True, separators=(",", ":"))

    def finality_update(self) -> dict:
        """Finalized head at least `quorum` beacons agree on.

        Breaker-open clients are skipped; per-client fetch errors are
        tolerated (counted on ``beacon_quorum_errors``) as long as a
        quorum remains. Raises :class:`QuorumNotReached` otherwise."""
        votes: dict[str, list] = {}   # head key -> [(client, update), ...]
        errors = 0
        for c in self.clients:
            if c.breaker_state == "open":
                continue
            try:
                upd = c.finality_update()
            except faults.InjectedCrash:
                raise
            except Exception:
                errors += 1
                self.health.incr("beacon_quorum_errors")
                continue
            votes.setdefault(self._head_key(upd), []).append((c, upd))
        if not votes:
            self.health.incr("beacon_quorum_failures")
            raise QuorumNotReached(
                f"no beacon answered ({errors} errors, "
                f"{len(self.clients)} clients)")
        best_key = max(votes, key=lambda k: len(votes[k]))
        if len(votes[best_key]) < self.quorum:
            self.health.incr("beacon_quorum_failures")
            raise QuorumNotReached(
                f"finalized heads split {sorted(len(v) for v in votes.values())} "
                f"across {len(votes)} answers; need {self.quorum} matching")
        for key, members in votes.items():
            if key == best_key:
                continue
            for c, _ in members:
                c.demote()
                self.health.incr("beacon_quorum_dissent")
        return votes[best_key][0][1]

    # -- failover passthrough ---------------------------------------------

    def _any(self, fn_name: str, *args, **kw):
        last_exc: Exception | None = None
        for c in self.clients:
            if c.breaker_state == "open":
                continue
            try:
                return getattr(c, fn_name)(*args, **kw)
            except faults.InjectedCrash:
                raise
            except Exception as exc:
                last_exc = exc
                self.health.incr("beacon_quorum_errors")
        raise last_exc if last_exc is not None else CircuitBreakerOpen(
            f"all {len(self.clients)} beacon breakers open")

    def committee_updates(self, period: int, count: int = 1) -> list[dict]:
        return self._any("committee_updates", period, count)

    def bootstrap(self, block_root: str) -> dict:
        return self._any("bootstrap", block_root)

    def head_block_root(self) -> str:
        return self._any("head_block_root")

    def sync_period(self, spec, slot: int) -> int:
        return spec.sync_period(slot)
