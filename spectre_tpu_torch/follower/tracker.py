"""Head tracker: beacon polling -> typed work items (the port's copy
of `spectre_tpu/follower/tracker.py`).

Polls the retrying/breaker-aware BeaconClient (or any object with the
same ``finality_update()`` / ``committee_updates(period)`` surface — the
tests use a fixture-backed fake) for the latest finality update, detects
sync-committee period boundaries from the spec's epoch math
(``spec.sync_period``), and emits typed work items:

* :class:`CommitteeUpdateDue` — one per period missing from the
  verified update store anywhere between the chain anchor and the
  current period (bounded per poll by ``SPECTRE_FOLLOW_BACKFILL``) —
  holes below the chain tip (e.g. a quarantined mid-chain record) are
  re-emitted, not just the gap above the tip. A missed rotation strands
  the update chain, so these always sort ahead of steps.
* :class:`StepDue` — the newest finalized header not yet covered by a
  stored step proof.

Dedup across restarts is structural: the UpdateStore is the persistent
record of what is already proved, so a restarted tracker re-derives
exactly the missing work; in-flight duplicates are absorbed by the job
queue's witness-digest dedup.
"""

from __future__ import annotations

import dataclasses
import os

from ..prover_service.rpc import (RPC_METHOD_AGG, RPC_METHOD_COMMITTEE,
                                  RPC_METHOD_STEP)
from ..utils.health import HEALTH
from ..utils.profiling import phase

BACKFILL_ENV = "SPECTRE_FOLLOW_BACKFILL"
BACKFILL_DEFAULT = 8


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


@dataclasses.dataclass(frozen=True)
class StepDue:
    """A finalized header awaiting a step proof."""
    slot: int
    params: dict            # genEvmProof_SyncStepCompressed RPC params

    @property
    def method(self) -> str:
        return RPC_METHOD_STEP

    def key(self):
        return ("step", self.slot)


@dataclasses.dataclass(frozen=True)
class CommitteeUpdateDue:
    """A sync-committee period boundary awaiting a rotation proof."""
    period: int
    params: dict            # genEvmProof_CommitteeUpdateCompressed params

    @property
    def method(self) -> str:
        return RPC_METHOD_COMMITTEE

    def key(self):
        return ("committee", self.period)


@dataclasses.dataclass(frozen=True)
class AggregationDue:
    """A cadence window of sealed committee periods awaiting the
    aggregation/compression proof. Emitted by the scheduler
    (not the tracker): the window is derived purely from the update
    store, so no beacon access is involved. `period` is the window END
    (the dedup key via ``store.has_aggregate``); `start_period` opens
    the window; `params` carries the stored chain records the replica
    re-links and re-verifies host-side."""
    period: int
    start_period: int
    params: dict            # genEvmProof_AggregationCadence RPC params

    @property
    def method(self) -> str:
        return RPC_METHOD_AGG

    def key(self):
        return ("aggregation", self.period)


def _unwrap(payload):
    """Beacon REST responses wrap the update in {"data": ...}; fixtures
    may hand the update dict directly."""
    if isinstance(payload, dict) and "data" in payload:
        return payload["data"]
    return payload


class HeadTracker:
    """`pubkeys` supplies the compressed committee pubkeys the step
    witness needs (a static list, or a callable ``period -> list``);
    `domain` is the sync-committee signing domain (0x-hex or bytes).
    Without both, step proving is disabled and the tracker follows the
    committee chain only."""

    def __init__(self, beacon, spec, store, pubkeys=None, domain=None,
                 backfill: int | None = None, health=HEALTH):
        self.beacon = beacon
        self.spec = spec
        self.store = store
        self._pubkeys = pubkeys
        if isinstance(domain, bytes):
            domain = "0x" + domain.hex()
        self._domain = domain
        self.backfill = (backfill if backfill is not None
                         else _env_int(BACKFILL_ENV, BACKFILL_DEFAULT))
        self.health = health
        self.last_finalized_slot: int | None = None
        self._first_seen_period: int | None = None
        self._first_seen_slot: int | None = None

    @property
    def steps_enabled(self) -> bool:
        return self._pubkeys is not None and self._domain is not None

    def _pubkeys_for(self, period: int):
        return self._pubkeys(period) if callable(self._pubkeys) \
            else self._pubkeys

    # -- lag gauges --------------------------------------------------------

    @property
    def head_lag_slots(self) -> int:
        """Slots between the newest finalized header seen and the newest
        step proof stored (the empty store counts from the first slot
        this tracker ever observed — it is not behind on history that
        predates its trust anchor)."""
        if self.last_finalized_slot is None:
            return 0
        latest = self.store.latest_step_slot()
        if latest is None:
            latest = self._first_seen_slot or self.last_finalized_slot
        return max(0, self.last_finalized_slot - latest)

    @property
    def periods_behind(self) -> int:
        """Periods between the current period and the verified chain
        tip (an empty store anchors at the first period observed)."""
        if self.last_finalized_slot is None:
            return 0
        current = self.spec.sync_period(self.last_finalized_slot)
        tip = self.store.tip_period()
        if tip is None:
            tip = (self._first_seen_period or current) - 1
        return max(0, current - tip)

    # -- polling -----------------------------------------------------------

    def poll(self) -> list:
        """One beacon poll -> the currently-missing work items
        (committee updates first). Beacon errors propagate — the daemon
        counts them and degrades to draining in-flight work."""
        with phase("follower/poll"):
            update = _unwrap(self.beacon.finality_update())
            fin_slot = int(update["finalized_header"]["slot"])
            self.last_finalized_slot = fin_slot
            period = self.spec.sync_period(fin_slot)
            if self._first_seen_period is None:
                self._first_seen_period = period
                self._first_seen_slot = fin_slot
            self.health.incr("follower_polls")

            items: list = []
            # scan from the chain ANCHOR, not the tip: a hole below the
            # tip (a quarantined mid-chain record, a crash that left
            # later periods stored) must be re-emitted — starting at
            # tip+1 would shadow it forever while verify_chain() stays
            # false with nothing re-proving the gap
            anchor = self.store.anchor_period()
            start = (self._first_seen_period if anchor is None
                     else min(anchor, self._first_seen_period))
            missing = [p for p in range(start, period + 1)
                       if not self.store.has_committee(p)]
            for p in missing[:self.backfill]:
                committee_update = self._fetch_committee_update(p)
                if committee_update is not None:
                    items.append(CommitteeUpdateDue(
                        p, {"light_client_update": committee_update}))
            if len(missing) > self.backfill:
                self.health.incr("follower_backfill_deferred")

            if self.steps_enabled and not self.store.has_step(fin_slot):
                items.append(StepDue(fin_slot, {
                    "light_client_finality_update": update,
                    "pubkeys": self._pubkeys_for(period),
                    "domain": self._domain,
                }))
            return items

    def _fetch_committee_update(self, period: int):
        updates = self.beacon.committee_updates(period)
        if not updates:
            return None
        return _unwrap(updates[0])
