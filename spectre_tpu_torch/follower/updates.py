"""Verified update store: the follower's durable output (the port's copy
of `spectre_tpu/follower/updates.py`).

A content-addressed, journal-backed chain of light-client updates:
``{period -> committee-update proof, slot -> step proof}``. Records ride
the existing :class:`~spectre_tpu_torch.utils.artifacts.ArtifactStore`
(``results/<sha256>.update.json``, atomic tmp+fsync+rename, read-side
re-verification + quarantine) plus an append-only fsync'd JSONL journal
(``follower.updates.jsonl``, the JobJournal idiom) holding one metadata
record per stored update.

Integrity contract:

* a record is appended only AFTER the job queue marked the proof
  ``done`` — and every done proof already passed the verify-before-serve
  gate (prover_service/selfverify.py), so nothing unverified can enter
  the chain;
* each committee record carries its own ``committee_poseidon`` (the
  chain-linking commitment the compressed circuit exposes at
  ``instances[12]``) and ``prev_poseidon`` — the predecessor period's
  commitment — so the stored chain is checkable without re-reading any
  proof bytes (:meth:`verify_chain`);
* crash replay re-verifies the chain TIP: the tip artifact is re-read
  (content-hash checked by the store) and its poseidon cross-checked
  against the journal record; a corrupt tip is quarantined and dropped
  so the follower re-proves it instead of serving rot;
* a record whose artifact fails verification at READ time
  (:meth:`get_committee` / :meth:`get_step`) is dropped the same way —
  the tracker sees the period as missing again and the scheduler
  re-proves it (witness-digest dedup makes that a cheap cache hit when
  the original job is still journaled).

Fault sites: artifact bytes go through ``artifact.write`` /
``artifact.read`` (diskfull, corrupt, ...); the journal append is its
own site ``follower.journal`` so the drills can fill the disk under the
chain record specifically.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import OrderedDict

from ..utils import faults
from ..utils.artifacts import ArtifactCorrupt, ArtifactStore
from ..utils.health import HEALTH

JOURNAL_NAME = "follower.updates.jsonl"
UPDATE_SUFFIX = ".update.json"
JOURNAL_FAULT_SITE = "follower.journal"

# in-RAM record-cache bound: a years-long follower
# accumulates tens of thousands of periods; the full journal records
# stay on disk and only this many stay hot in RAM per map
CACHE_PERIODS_ENV = "SPECTRE_UPDATE_CACHE_PERIODS"
DEFAULT_CACHE_PERIODS = 1024


class _JournalMap:
    """Bounded dict façade over journal-backed records.

    The full index (key -> (journal byte offset, artifact digest)) is
    tiny and stays resident — membership, iteration, len, max/min and
    the scrubber keep-set never load a record. Full records live in an
    LRU capped at `cache` entries; a miss seeks the journal to the
    record's offset and re-parses that one line
    (``follower_update_cache_evictions`` / reload failures are counted,
    a reloaded line that no longer parses or no longer matches its key
    is bit rot: the index entry is dropped so the follower re-proves).

    NOT thread-safe on its own — every access happens under the owning
    UpdateStore's lock, exactly like the plain dicts it replaces."""

    def __init__(self, path: str, kind: str, key_field: str,
                 cache: int, health=HEALTH):
        self._path = path
        self._kind = kind
        self._key_field = key_field
        self._cache = max(1, int(cache))
        self._health = health
        self._index: dict[int, tuple] = {}      # key -> (offset, digest)
        self._lru: "OrderedDict[int, dict]" = OrderedDict()

    # -- dict façade (what UpdateStore + tests use) ------------------------

    def __contains__(self, key) -> bool:
        return key in self._index

    def __iter__(self):
        return iter(self._index)

    def __len__(self) -> int:
        return len(self._index)

    def __getitem__(self, key) -> dict:
        rec = self._lru.get(key)
        if rec is not None:
            self._lru.move_to_end(key)
            return rec
        if key not in self._index:
            raise KeyError(key)
        rec = self._reload(key)
        if rec is None:
            # the journal line rotted underneath the index: drop the
            # entry (the tracker re-emits the period, the scheduler
            # re-proves it — same contract as read-time invalidation)
            del self._index[key]
            self._health.incr("follower_journal_reload_failures")
            raise KeyError(key)
        self._insert(key, rec)
        return rec

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    def __delitem__(self, key):
        del self._index[key]
        self._lru.pop(key, None)

    def keys(self):
        return self._index.keys()

    # -- journal-backed side ----------------------------------------------

    def put(self, key, rec: dict, offset: int):
        self._index[key] = (offset, rec.get("digest"))
        self._insert(key, rec)

    def digests(self) -> set:
        """Artifact digests of every indexed record — no record loads."""
        return {d for _, d in self._index.values() if d}

    def _insert(self, key, rec: dict):
        self._lru[key] = rec
        self._lru.move_to_end(key)
        while len(self._lru) > self._cache:
            self._lru.popitem(last=False)
            self._health.incr("follower_update_cache_evictions")

    def _reload(self, key) -> dict | None:
        offset, _digest = self._index[key]
        try:
            with open(self._path, "rb") as f:
                f.seek(offset)
                rec = json.loads(f.readline())
        except (OSError, ValueError):
            return None
        try:
            if rec.get("kind") != self._kind \
                    or int(rec[self._key_field]) != key:
                return None
        except (KeyError, TypeError, ValueError):
            return None
        return rec


class ChainOrderError(RuntimeError):
    """Appending this committee record would break the chain: its
    predecessor period is not stored (and it is not the trust anchor),
    so the prev_poseidon link cannot be recorded. The caller must store
    the predecessor first (the scheduler gates collection on this)."""


def _canonical(result: dict) -> bytes:
    return json.dumps(result, sort_keys=True,
                      separators=(",", ":")).encode()


class UpdateStore:
    """Thread-safe; one instance per follower, sharing the params dir
    (and therefore the ``results/`` artifact namespace) with the job
    queue — register :meth:`live_artifacts` with the queue's scrubber
    keep-set so stored updates are never expired as orphans."""

    def __init__(self, directory: str, health=HEALTH,
                 cache_periods: int | None = None):
        os.makedirs(directory, exist_ok=True)
        self.dir = directory
        self.health = health
        self.store = ArtifactStore(directory, health=health)
        self.path = os.path.join(directory, JOURNAL_NAME)
        self._lock = threading.RLock()
        if cache_periods is None:
            cache_periods = int(os.environ.get(CACHE_PERIODS_ENV)
                                or DEFAULT_CACHE_PERIODS)
        # period -> record / slot -> record, bounded: the
        # resident index is offsets+digests only, full records LRU-cache
        self._committee = _JournalMap(self.path, "committee", "period",
                                      cache_periods, health=health)
        self._steps = _JournalMap(self.path, "step", "slot",
                                  cache_periods, health=health)
        # period -> aggregation record: keyed by the
        # window's END period, so has_aggregate(boundary) is the
        # scheduler's restart-safe "already published" dedup check
        self._aggregates = _JournalMap(self.path, "aggregate", "period",
                                       cache_periods, health=health)
        # lowest committee period ever journaled — the chain's trust
        # anchor. Survives in-memory invalidations (a dropped record is
        # re-proved, not forgotten) so the tracker can re-derive holes
        # anywhere in [anchor, head], not just above the tip.
        self._anchor: int | None = None
        # append observers;
        # called OUTSIDE the lock after each successful append
        self._observers: list = []
        self._replay()

    # -- journal -----------------------------------------------------------

    def _append(self, record: dict) -> int:
        """Append one record; returns its byte offset in the journal
        (the _JournalMap index key for cache-miss reloads)."""
        faults.check(JOURNAL_FAULT_SITE)
        line = json.dumps(record, sort_keys=True,
                          separators=(",", ":")) + "\n"
        with open(self.path, "a") as f:
            f.seek(0, os.SEEK_END)
            offset = f.tell()
            f.write(line)
            f.flush()
            os.fsync(f.fileno())
        return offset

    def _replay(self):
        """Rebuild the maps from the journal (last record per key wins;
        a torn tail from a crash mid-append is tolerated), then
        re-verify the chain tip before trusting it. Only the LAST line
        may be torn — an unparseable line mid-file is bit rot, not a
        crash footprint, so it is skipped and counted
        (``follower_journal_corrupt_lines``) instead of silently
        discarding every valid record after it."""
        if not os.path.exists(self.path):
            return
        with open(self.path, "rb") as f:
            raw = f.read()
        entries, pos = [], 0
        for chunk in raw.split(b"\n"):
            entries.append((pos, chunk))
            pos += len(chunk) + 1
        if entries and not entries[-1][1].strip():
            entries.pop()       # trailing empty chunk: file ends with \n
        for i, (offset, line) in enumerate(entries):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                if i == len(entries) - 1:
                    break          # torn tail: everything before is good
                self.health.incr("follower_journal_corrupt_lines")
                continue
            if rec.get("kind") == "committee":
                period = int(rec["period"])
                self._committee.put(period, rec, offset)
                if self._anchor is None or period < self._anchor:
                    self._anchor = period
            elif rec.get("kind") == "step":
                self._steps.put(int(rec["slot"]), rec, offset)
            elif rec.get("kind") == "aggregate":
                self._aggregates.put(int(rec["period"]), rec, offset)
        if self._committee or self._steps or self._aggregates:
            self.health.incr("follower_journal_replays")
        self._verify_tip()

    def _verify_tip(self):
        """Crash-replay integrity: re-read the committee chain tip's
        artifact and cross-check its poseidon against the journal
        record; drop (the artifact is already quarantined by the store)
        anything that fails so the follower re-proves it."""
        tip = self.tip_period()
        if tip is None:
            return
        try:
            rec = self._committee[tip]
        except KeyError:        # reload failed: already dropped + counted
            self.health.incr("follower_chain_tip_invalid")
            return
        try:
            result = json.loads(self.store.read(rec["digest"],
                                                UPDATE_SUFFIX))
            ok = result.get("committee_poseidon") == \
                rec.get("committee_poseidon")
        except (ArtifactCorrupt, OSError, ValueError):
            ok = False
        prev = self._committee.get(tip - 1)
        if ok and prev is not None:
            ok = rec.get("prev_poseidon") == prev.get("committee_poseidon")
        if not ok:
            del self._committee[tip]
            self.health.incr("follower_chain_tip_invalid")

    # -- append ------------------------------------------------------------

    def append_committee(self, period: int, result: dict,
                         job_id: str | None = None,
                         manifest_digest: str | None = None) -> dict:
        """Store a done committee-update proof for `period`. The journal
        record links to the predecessor period's poseidon commitment
        (None for the trust anchor — the first record of the chain).
        Raises OSError (e.g. ENOSPC) when the store or journal cannot
        persist it (the caller retries on the next cycle) and
        :class:`ChainOrderError` when the append would record a broken
        link: appends must land in period order, so a record whose
        predecessor is neither stored nor the trust anchor is refused
        instead of being written with ``prev_poseidon=None`` — an
        out-of-order completion must wait for its predecessor."""
        period = int(period)
        with self._lock:
            prev = self._committee.get(period - 1)
            if prev is None and self._committee and period != self._anchor:
                # no predecessor and not the trust anchor being
                # re-proved after invalidation: recording this now would
                # journal a dangling prev_poseidon=None link that a
                # later predecessor append could never heal — the
                # out-of-order completion must wait (the scheduler
                # gates collection on this)
                raise ChainOrderError(
                    f"committee period {period} out of order: period "
                    f"{period - 1} is not stored and {period} is not the "
                    f"chain anchor ({self._anchor})")
            digest = self.store.write(_canonical(result),
                                      suffix=UPDATE_SUFFIX)
            rec = {
                "kind": "committee",
                "period": period,
                "digest": digest,
                "committee_poseidon": result.get("committee_poseidon"),
                "prev_poseidon": (prev or {}).get("committee_poseidon"),
                "job_id": job_id,
                "manifest_digest": manifest_digest,
                "ts": time.time(),
            }
            offset = self._append(rec)
            self._committee.put(period, rec, offset)
            if self._anchor is None or period < self._anchor:
                self._anchor = period
        self.health.incr("follower_updates_stored")
        self._notify("committee", period)
        return rec

    def append_step(self, slot: int, result: dict,
                    job_id: str | None = None,
                    manifest_digest: str | None = None) -> dict:
        slot = int(slot)
        with self._lock:
            digest = self.store.write(_canonical(result),
                                      suffix=UPDATE_SUFFIX)
            rec = {"kind": "step", "slot": slot, "digest": digest,
                   "job_id": job_id, "manifest_digest": manifest_digest,
                   "ts": time.time()}
            offset = self._append(rec)
            self._steps.put(slot, rec, offset)
        self.health.incr("follower_steps_stored")
        self._notify("step", slot)
        return rec

    def append_aggregate(self, period: int, result: dict,
                         start_period: int | None = None,
                         job_id: str | None = None,
                         manifest_digest: str | None = None) -> dict:
        """Store a published aggregation proof for the cadence window
        ending at `period`. No chain-order gate: each window
        stands alone (the underlying committee chain already links it),
        so the only invariant is one record per boundary period — the
        scheduler's restart-safe dedup key."""
        period = int(period)
        with self._lock:
            digest = self.store.write(_canonical(result),
                                      suffix=UPDATE_SUFFIX)
            rec = {"kind": "aggregate", "period": period,
                   "start_period": (None if start_period is None
                                    else int(start_period)),
                   "digest": digest,
                   "committee_poseidon": result.get("committee_poseidon"),
                   "job_id": job_id, "manifest_digest": manifest_digest,
                   "ts": time.time()}
            offset = self._append(rec)
            self._aggregates.put(period, rec, offset)
        self.health.incr("follower_aggregates_stored")
        self._notify("aggregate", period)
        return rec

    # -- read (serving path: O(artifact read), no prover involved) ---------

    def _load(self, rec: dict) -> dict | None:
        try:
            result = json.loads(self.store.read(rec["digest"],
                                                UPDATE_SUFFIX))
        except (ArtifactCorrupt, OSError, ValueError):
            return None
        out = {k: rec[k] for k in ("kind", "digest", "job_id",
                                   "manifest_digest") if k in rec}
        if rec["kind"] == "committee":
            out["period"] = rec["period"]
            out["prev_poseidon"] = rec.get("prev_poseidon")
        elif rec["kind"] == "aggregate":
            out["period"] = rec["period"]
            out["start_period"] = rec.get("start_period")
        else:
            out["slot"] = rec["slot"]
        out["result"] = result
        return out

    def get_committee(self, period: int) -> dict | None:
        with self._lock:
            rec = self._committee.get(int(period))
            if rec is None:
                return None
            out = self._load(rec)
            if out is None:
                # quarantined by the store's read-side check: drop the
                # record so the tracker re-emits the period and the
                # scheduler re-proves it
                del self._committee[int(period)]
                self.health.incr("follower_updates_invalidated")
            return out

    def get_step(self, slot: int) -> dict | None:
        with self._lock:
            rec = self._steps.get(int(slot))
            if rec is None:
                return None
            out = self._load(rec)
            if out is None:
                del self._steps[int(slot)]
                self.health.incr("follower_updates_invalidated")
            return out

    def get_aggregate(self, period: int) -> dict | None:
        with self._lock:
            rec = self._aggregates.get(int(period))
            if rec is None:
                return None
            out = self._load(rec)
            if out is None:
                del self._aggregates[int(period)]
                self.health.incr("follower_updates_invalidated")
            return out

    def range_committee(self, start_period: int, count: int):
        """(found records, missing periods) over [start, start+count)."""
        updates, missing = [], []
        for p in range(int(start_period), int(start_period) + int(count)):
            rec = self.get_committee(p)
            if rec is None:
                missing.append(p)
            else:
                updates.append(rec)
        return updates, missing

    # -- observers ----------------------

    def add_append_observer(self, fn) -> None:
        """Register ``fn(kind, key)`` to run after every successful
        append (outside the store lock). Idempotent per callable."""
        with self._lock:
            if fn not in self._observers:
                self._observers.append(fn)

    def _notify(self, kind: str, key: int) -> None:
        with self._lock:
            observers = list(self._observers)
        for fn in observers:
            try:
                fn(kind, key)
            except Exception:
                # an observer (pack build, metrics) must never break
                # the proving append path
                self.health.incr("follower_observer_failures")

    # -- chain queries -----------------------------------------------------

    def has_committee(self, period: int) -> bool:
        with self._lock:
            return int(period) in self._committee

    def has_step(self, slot: int) -> bool:
        with self._lock:
            return int(slot) in self._steps

    def has_aggregate(self, period: int) -> bool:
        with self._lock:
            return int(period) in self._aggregates

    def latest_aggregate_period(self) -> int | None:
        with self._lock:
            return max(self._aggregates) if self._aggregates else None

    def tip_period(self) -> int | None:
        with self._lock:
            return max(self._committee) if self._committee else None

    def committee_digest(self, period: int) -> str | None:
        """Metadata-only content digest for a stored committee period —
        the gateway's ETag source. Never touches the artifact, so a
        conditional-request (304) path costs one dict lookup."""
        with self._lock:
            rec = self._committee.get(int(period))
            return None if rec is None else rec.get("digest")

    def is_sealed(self, period: int) -> bool:
        """A period is *sealed* once it is stored AND strictly below the
        chain tip: its successor's prev_poseidon pins it, so the record
        can never change — the gateway serves it as immutable."""
        with self._lock:
            period = int(period)
            if period not in self._committee or not self._committee:
                return False
            return period < max(self._committee)

    def anchor_period(self) -> int | None:
        """The chain's trust anchor: the lowest committee period ever
        journaled. Unlike :meth:`tip_period` this does NOT move when a
        record is invalidated at read time, so the tracker can derive
        missing work over the whole [anchor, head] span — a hole below
        the tip (a quarantined mid-chain record, a crash between
        out-of-order completions) is re-emitted instead of being
        shadowed by the tip."""
        with self._lock:
            if self._anchor is not None:
                return self._anchor
            return min(self._committee) if self._committee else None

    def latest_step_slot(self) -> int | None:
        with self._lock:
            return max(self._steps) if self._steps else None

    def verify_chain(self) -> bool:
        """The stored committee chain is unbroken: contiguous periods,
        each record's prev_poseidon matching its predecessor's
        commitment (metadata-only — artifact bytes are verified by the
        content-addressed store at read time)."""
        with self._lock:
            if not self._committee:
                return True
            periods = sorted(self._committee)
            if periods != list(range(periods[0], periods[-1] + 1)):
                return False
            for p in periods[1:]:
                cur = self._committee.get(p)
                prev = self._committee.get(p - 1)
                if cur is None or prev is None:     # rotted under the index
                    return False
                if cur.get("prev_poseidon") != prev.get("committee_poseidon"):
                    return False
            return True

    def live_artifacts(self) -> set:
        """(digest, suffix) keep-set for the artifact scrubber: stored
        updates must never be expired as journal orphans. Reads the
        resident index only — no record loads, regardless of chain
        length."""
        with self._lock:
            digs = self._committee.digests() | self._steps.digests() \
                | self._aggregates.digests()
        return {(d, UPDATE_SUFFIX) for d in digs}

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "committees": len(self._committee),
                "steps": len(self._steps),
                "aggregates": len(self._aggregates),
                "tip_period": max(self._committee) if self._committee
                else None,
                "latest_step_slot": max(self._steps) if self._steps
                else None,
                "latest_aggregate_period": max(self._aggregates)
                if self._aggregates else None,
            }
