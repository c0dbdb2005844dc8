"""Background artifact scrubber (the port's copy of
`spectre_tpu/prover_service/scrubber.py`).

Replay verifies an artifact when a RESTART happens to read it; the wire
verifies it when a CLIENT happens to fetch it. Disk rot in between goes
unnoticed until the worst moment. The scrubber closes that gap: a
supervised background thread incrementally re-hashes every
``results/<sha256>.bin`` and ``<sha256>.manifest.json`` against its
content address,

* **quarantining** mismatches exactly like replay does
  (``ArtifactStore._quarantine`` -> ``results/quarantine/``,
  ``artifacts_quarantined`` + ``artifacts_scrub_corrupt``), and
* **expiring** orphans — hash-clean files whose ``(digest, suffix)`` no
  longer appears in any journaled job (journal compaction dropped the
  job, a crash landed between artifact write and journal append, or an
  operator pruned the journal). Deletion is age-gated
  (``SPECTRE_SCRUB_MIN_AGE_S``, default 60 s) so a file an in-flight
  worker wrote moments before its journal record lands is never
  reaped. Counted on ``artifacts_expired``; JobQueue._recover runs one
  pass after every journal compaction.

One pass is exposed as ``Scrubber.scrub()`` (the ``scrubNow`` RPC and
``python -m spectre_tpu_torch.prover_service scrub`` CLI call it directly);
the periodic thread (``SPECTRE_SCRUB_INTERVAL_S``, default 300 s, 0
disables) follows the worker-supervisor discipline: injectable
clock/interval, exceptions counted (``artifacts_scrub_errors``) and
never fatal, shutdown via the queue's stop event.

**IO-pressure pacing:** a pass
re-hashes every byte in ``results/``, so on a box where that takes
longer than ``SPECTRE_SCRUB_BUDGET_S`` (default 30 s — a proxy for IO
pressure: a healthy store scans in seconds) the next wait is STRETCHED
by the overrun ratio (capped at 8x) instead of immediately grinding the
disk again. Each stretched wait counts on ``scrub_passes_deferred``.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time

from ..utils.health import HEALTH

INTERVAL_ENV = "SPECTRE_SCRUB_INTERVAL_S"
INTERVAL_DEFAULT_S = 300.0
MIN_AGE_ENV = "SPECTRE_SCRUB_MIN_AGE_S"
MIN_AGE_DEFAULT_S = 60.0
BUDGET_ENV = "SPECTRE_SCRUB_BUDGET_S"
BUDGET_DEFAULT_S = 30.0
MAX_STRETCH = 8.0

_HEX = frozenset("0123456789abcdef")
_CHUNK = 1 << 20


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def parse_name(name: str):
    """``<64-hex><suffix>`` -> (digest, suffix); None for anything else
    (quarantine/ dir, ``.tmp`` staging files, strangers)."""
    if len(name) <= 64 or name.endswith(".tmp"):
        return None
    digest, suffix = name[:64], name[64:]
    if not suffix.startswith(".") or not _HEX.issuperset(digest):
        return None
    return digest, suffix


def _hash_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(_CHUNK):
            h.update(chunk)
    return h.hexdigest()


class Scrubber:
    """`live_artifacts` is a zero-arg callable returning the set of
    ``(digest, suffix)`` pairs some journaled job still references —
    everything else that hashes clean is an expirable orphan."""

    def __init__(self, store, live_artifacts, health=HEALTH,
                 min_age_s: float | None = None, clock=time.time,
                 budget_s: float | None = None):
        self.store = store
        self.live_artifacts = live_artifacts
        self.health = health
        self.min_age_s = (min_age_s if min_age_s is not None
                          else _env_float(MIN_AGE_ENV, MIN_AGE_DEFAULT_S))
        self.budget_s = (budget_s if budget_s is not None
                         else _env_float(BUDGET_ENV, BUDGET_DEFAULT_S))
        self.last_pass_s = 0.0
        self._clock = clock
        self._thread: threading.Thread | None = None

    def scrub(self) -> dict:
        """One full pass; returns {"scanned","corrupt","expired","skipped"}."""
        started = self._clock()
        try:
            return self._scrub(started)
        finally:
            self.last_pass_s = max(0.0, self._clock() - started)

    def _scrub(self, now: float) -> dict:
        summary = {"scanned": 0, "corrupt": 0, "expired": 0, "skipped": 0}
        try:
            names = sorted(os.listdir(self.store.dir))
        except OSError:
            return summary
        live = set(self.live_artifacts())
        for name in names:
            parsed = parse_name(name)
            path = os.path.join(self.store.dir, name)
            if parsed is None:
                if os.path.isfile(path):
                    summary["skipped"] += 1
                continue
            digest, suffix = parsed
            try:
                actual = _hash_file(path)
            except OSError:
                summary["skipped"] += 1   # vanished mid-pass (racing reader)
                continue
            summary["scanned"] += 1
            self.health.incr("artifacts_scrubbed")
            if actual != digest:
                self.store._quarantine(path)
                summary["corrupt"] += 1
                self.health.incr("artifacts_scrub_corrupt")
                continue
            if (digest, suffix) not in live:
                try:
                    if now - os.path.getmtime(path) < self.min_age_s:
                        continue      # too fresh: may be a not-yet-journaled
                    os.unlink(path)   # write racing this pass
                except OSError:
                    continue
                summary["expired"] += 1
                self.health.incr("artifacts_expired")
        return summary

    # -- periodic thread ----------------------------------------------------

    def start(self, interval_s: float | None, stop_event: threading.Event):
        """Spawn the periodic pass; interval<=0 disables (scrubNow / the
        CLI still work). Exceptions inside a pass are counted and
        swallowed — the scrubber must never take the queue down."""
        if interval_s is None:
            interval_s = _env_float(INTERVAL_ENV, INTERVAL_DEFAULT_S)
        if interval_s <= 0:
            return None
        self._thread = threading.Thread(
            target=self._loop, args=(interval_s, stop_event),
            daemon=True, name="prover-artifact-scrubber")
        self._thread.start()
        return self._thread

    def next_interval(self, interval_s: float) -> float:
        """IO-pressure pacing: when the last pass blew its wall-clock
        budget, stretch the next wait by the overrun ratio (capped at
        ``MAX_STRETCH``) and count the deferral. A within-budget pass
        keeps the configured cadence."""
        if self.budget_s <= 0 or self.last_pass_s <= self.budget_s:
            return interval_s
        stretch = min(MAX_STRETCH, self.last_pass_s / self.budget_s)
        self.health.incr("scrub_passes_deferred")
        return interval_s * stretch

    def _loop(self, interval_s: float, stop_event: threading.Event):
        wait = interval_s
        while not stop_event.wait(wait):
            try:
                self.scrub()
            except Exception:
                self.health.incr("artifacts_scrub_errors")
            wait = self.next_interval(interval_s)
