"""Supervised follower daemon: tracker + scheduler + store (the port's copy
of `spectre_tpu/follower/daemon.py`).

One :class:`Follower` closes the loop from beacon RPC to served
light-client updates:

    beacon poll -> work items -> JobQueue -> verified proofs -> UpdateStore

``run_once()`` is one cycle; ``run(stop_event)`` is the supervised loop
(``SPECTRE_FOLLOW_POLL_S``, exceptions counted, never fatal — the
scrubber/worker-supervisor discipline). A beacon outage degrades the
follower to BACKFILL mode: polls fail (``follower_beacon_errors``
counts, ``degraded`` flips), but the scheduler keeps pumping —
in-flight proofs finish and land in the store, and the backlog drains.
When the beacon recovers, fresh polls re-derive the missed work and
``spectre_follower_head_lag_slots`` returns to 0.

Followers register in a process-level weak registry so the Prometheus
exporter can pull the lag gauges (`spectre_follower_head_lag_slots`,
`spectre_follower_periods_behind`, `spectre_follower_scheduler_backlog`)
without holding them alive — the beacon-client breaker-snapshot pattern.
"""

from __future__ import annotations

import os
import threading
import time
import weakref

from ..utils.health import HEALTH
from .scheduler import ProofScheduler
from .tracker import HeadTracker
from .updates import UpdateStore

POLL_ENV = "SPECTRE_FOLLOW_POLL_S"
POLL_DEFAULT_S = 12.0

_FOLLOWERS: "weakref.WeakSet[Follower]" = weakref.WeakSet()


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def follower_snapshot() -> list[dict]:
    """Snapshots of every live follower (the /metrics pull source)."""
    return [f.snapshot() for f in list(_FOLLOWERS)]


class Follower:
    """`jobs` is the (already constructed) JobQueue the proofs flow
    through; `store` the UpdateStore (built here from `directory` when
    not passed). The store's live-artifact set is registered with the
    queue so the scrubber never expires a stored update as an orphan."""

    def __init__(self, spec, beacon, jobs, store: UpdateStore | None = None,
                 directory: str | None = None, pubkeys=None, domain=None,
                 backfill: int | None = None, health=HEALTH,
                 clock=time.monotonic, cadence_periods: int | None = None,
                 publisher=None):
        if store is None:
            if directory is None:
                raise ValueError("Follower needs a store or a directory")
            store = UpdateStore(directory, health=health)
        self.spec = spec
        self.jobs = jobs
        self.store = store
        self.health = health
        self.tracker = HeadTracker(beacon, spec, store, pubkeys=pubkeys,
                                   domain=domain, backfill=backfill,
                                   health=health)
        self.scheduler = ProofScheduler(jobs, store, health=health,
                                        clock=clock,
                                        cadence_periods=cadence_periods,
                                        publisher=publisher)
        self.degraded = False
        self.cycles = 0
        add = getattr(jobs, "add_live_provider", None)
        if add is not None:
            add(store.live_artifacts)
        _FOLLOWERS.add(self)

    # -- one cycle ---------------------------------------------------------

    def run_once(self) -> dict:
        """Poll -> offer -> pump. Beacon failures (outage, open breaker)
        degrade to backfill: the pump still runs so in-flight proofs
        land and retries/backoffs advance."""
        items = []
        try:
            items = self.tracker.poll()
            self.degraded = False
        except Exception:
            self.health.incr("follower_beacon_errors")
            self.degraded = True
        self.scheduler.offer(items)
        summary = self.scheduler.pump()
        self.cycles += 1
        return summary

    # -- supervised loop ---------------------------------------------------

    def run(self, stop_event: threading.Event,
            poll_s: float | None = None):
        """Blocking follower loop; a cycle that blows up is counted
        (``follower_cycle_errors``) and never fatal."""
        if poll_s is None:
            poll_s = _env_float(POLL_ENV, POLL_DEFAULT_S)
        while True:
            try:
                self.run_once()
            except Exception:
                self.health.incr("follower_cycle_errors")
            if stop_event.wait(poll_s):
                return

    def start(self, stop_event: threading.Event,
              poll_s: float | None = None) -> threading.Thread:
        t = threading.Thread(target=self.run, args=(stop_event, poll_s),
                             daemon=True, name="spectre-follower")
        t.start()
        return t

    # -- introspection -----------------------------------------------------

    def snapshot(self) -> dict:
        snap = self.store.snapshot()
        snap.update({
            "store": os.path.basename(os.path.abspath(self.store.dir)),
            "head_lag_slots": self.tracker.head_lag_slots,
            "periods_behind": self.tracker.periods_behind,
            "scheduler_backlog": self.scheduler.backlog,
            "last_finalized_slot": self.tracker.last_finalized_slot,
            "chain_ok": self.store.verify_chain(),
            "degraded": self.degraded,
            "cycles": self.cycles,
            "agg_cadence_periods": self.scheduler.cadence_periods,
        })
        return snap
