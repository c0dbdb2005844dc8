"""Content-addressed update-range packs (the port's copy
of `spectre_tpu/gateway/packs.py`).

Once a sync-committee period is *sealed* — finalized and strictly below
the chain tip — its light-client update is immutable: the proof bytes
are content-addressed and the chain link to its predecessor can never
change. The pack builder exploits that by pre-encoding every sealed
period's wire response ONCE into a pack artifact, so serving a billion
``getUpdateRange``-shaped reads is a pack-slice copy instead of K
journal-backed ``UpdateStore`` reads + K JSON encodes per request.

Pack layout (length-prefixed canonical encoding + digest index)::

    MAGIC "SPKPACK1" | u32 index_len | index JSON | body

    index = {"start": s, "count": n, "tail": bool,
             "entries": [{"period": p, "etag": <artifact sha256>,
                          "offset": o, "length": l}, ...]}

``offset`` is relative to the body; each body slice is the *exact*
canonical response body the gateway serves for ``/v1/update/<period>``
(pinned byte-identical to a direct ``UpdateStore`` read in tests), so a
range response is assembled by slice concatenation.

Durability: packs ride :class:`~spectre_tpu_torch.utils.artifacts.ArtifactStore`
(atomic write, read-side re-hash + quarantine) under the shared
``results/`` namespace with suffix ``.pack.bin``; the ``start ->
digest`` mapping is an append-only fsync'd JSONL
(``gateway.packs.jsonl``, last record per start wins) and is REBUILT
from the update store on journal replay — a lost or corrupt pack is a
rebuild, never data loss, because the updates themselves remain in the
verified chain. :meth:`live_artifacts` feeds the job-queue scrubber's
keep-set so compaction/orphan-expiry never reap a referenced pack.

Two pack classes:

* **full packs** — every ``SPECTRE_PACK_PERIODS`` consecutive periods
  from the chain anchor, built once when the whole range seals, then
  immutable forever;
* **one tail pack** — the sealed remainder between the last full range
  and the tip, rebuilt as the tip advances so EVERY sealed period is
  always pack-covered (the acceptance drill's "zero store fallbacks for
  sealed traffic" depends on this). A superseded tail pack drops out of
  the live set and is expired by the scrubber like any orphan.

Fault site ``gateway.pack_write`` covers the pack artifact write; a
failed build is counted (``gateway_pack_build_failures``) and retried
on the next seal event — serving degrades to the update store, it never
breaks.
"""

from __future__ import annotations

import json
import os
import struct
import threading

from ..utils import faults
from ..utils.artifacts import ArtifactCorrupt
from ..utils.health import HEALTH

PACK_MAGIC = b"SPKPACK1"
PACK_SUFFIX = ".pack.bin"
PACKS_JOURNAL_NAME = "gateway.packs.jsonl"
PACK_FAULT_SITE = "gateway.pack_write"

PACK_PERIODS_ENV = "SPECTRE_PACK_PERIODS"
DEFAULT_PACK_PERIODS = 8


def canonical_update_body(rec: dict) -> bytes:
    """THE wire encoding of one stored update record: canonical JSON
    (sorted keys, no whitespace). Pack slices and direct store reads
    both serve exactly these bytes — byte-identity is pinned in
    tests/test_gateway.py."""
    return json.dumps(rec, sort_keys=True, separators=(",", ":")).encode()


def encode_pack(start: int, entries: list[tuple[int, str, bytes]],
                tail: bool) -> bytes:
    """`entries` is [(period, etag, body_bytes), ...] in period order."""
    body = b"".join(b for _, _, b in entries)
    index_entries, offset = [], 0
    for period, etag, data in entries:
        index_entries.append({"period": period, "etag": etag,
                              "offset": offset, "length": len(data)})
        offset += len(data)
    index = json.dumps({"start": start, "count": len(entries),
                        "tail": bool(tail), "entries": index_entries},
                       sort_keys=True, separators=(",", ":")).encode()
    return PACK_MAGIC + struct.pack(">I", len(index)) + index + body


def decode_pack(data: bytes) -> tuple[dict, int]:
    """Returns (index dict, body base offset). Raises ValueError on a
    malformed pack (the caller treats it like corruption: drop+rebuild)."""
    if data[:len(PACK_MAGIC)] != PACK_MAGIC:
        raise ValueError("bad pack magic")
    hdr = len(PACK_MAGIC)
    (index_len,) = struct.unpack(">I", data[hdr:hdr + 4])
    index = json.loads(data[hdr + 4:hdr + 4 + index_len])
    return index, hdr + 4 + index_len


class PackBuilder:
    """Seals ranges of the given :class:`UpdateStore` into pack
    artifacts. Thread-safe; one instance per gateway."""

    def __init__(self, store, pack_periods: int | None = None,
                 health=HEALTH):
        if pack_periods is None:
            pack_periods = int(os.environ.get(PACK_PERIODS_ENV)
                               or DEFAULT_PACK_PERIODS)
        self.store = store                  # UpdateStore
        self.artifacts = store.store        # shared ArtifactStore
        self.pack_periods = max(1, int(pack_periods))
        self.health = health
        self._lock = threading.RLock()
        # start -> {"start", "count", "digest", "tail"}
        self._packs: dict[int, dict] = {}
        self._journal_path = os.path.join(store.dir, PACKS_JOURNAL_NAME)
        self._replay()

    # -- journal -----------------------------------------------------------

    def _replay(self):
        """Last record per start wins; a mapping whose artifact no
        longer exists on disk is dropped (ensure_packs rebuilds it from
        the update store — the journal is an index, not the source of
        truth). Torn tails parse-fail and are skipped, JobJournal-style."""
        try:
            with open(self._journal_path, "rb") as f:
                raw = f.read()
        except OSError:
            return
        for line in raw.split(b"\n"):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue                    # torn tail
            try:
                start = int(rec["start"])
            except (KeyError, TypeError, ValueError):
                continue
            self._packs[start] = {"start": start,
                                  "count": int(rec.get("count", 0)),
                                  "digest": rec.get("digest"),
                                  "tail": bool(rec.get("tail"))}
        for start in list(self._packs):
            meta = self._packs[start]
            if not meta["digest"] or not self.artifacts.exists(
                    meta["digest"], PACK_SUFFIX):
                del self._packs[start]
                self.health.incr("gateway_pack_replay_dropped")

    def _journal_append(self, rec: dict):
        """Best-effort fsync'd append: pack writes are content-addressed
        and idempotent, so a lost index record costs one rebuild, never
        correctness."""
        try:
            with open(self._journal_path, "a", encoding="utf-8") as f:
                f.write(json.dumps(rec, sort_keys=True,
                                   separators=(",", ":")) + "\n")
                f.flush()
                os.fsync(f.fileno())
        except OSError:
            self.health.incr("gateway_pack_journal_failures")

    # -- sealing -----------------------------------------------------------

    def _alignment(self) -> int | None:
        return self.store.anchor_period()

    def range_start(self, period: int) -> int | None:
        """The aligned full-range start covering `period` (anchor-based:
        the first pack starts exactly at the chain's trust anchor)."""
        anchor = self._alignment()
        if anchor is None or period < anchor:
            return None
        n = self.pack_periods
        return anchor + ((period - anchor) // n) * n

    def ensure_packs(self) -> int:
        """Build every missing sealed pack (full ranges + the tail);
        returns how many packs were built. Called from the store's
        append hook and once at gateway construction (journal replay
        recovery). Build failures are counted and retried on the next
        call — never raised into the appending follower."""
        anchor = self._alignment()
        tip = self.store.tip_period()
        if anchor is None or tip is None:
            return 0
        built = 0
        n = self.pack_periods
        with self._lock:
            start = anchor
            while start + n <= tip:         # full ranges: all members sealed
                meta = self._packs.get(start)
                if meta is None or meta["tail"]:
                    if self._build(start, n, tail=False):
                        built += 1
                start += n
            # the sealed remainder [start, tip): rebuilt as the tip moves
            count = tip - start
            if count > 0:
                meta = self._packs.get(start)
                if meta is None or meta["count"] != count:
                    if self._build(start, count, tail=True):
                        built += 1
        return built

    def _build(self, start: int, count: int, tail: bool) -> bool:
        entries = []
        for period in range(start, start + count):
            rec = self.store.get_committee(period)
            if rec is None:
                # a hole (invalidated mid-chain record being re-proved):
                # this range can't seal yet — retry on a later append
                return False
            entries.append((period, rec["digest"],
                            canonical_update_body(rec)))
        data = encode_pack(start, entries, tail)
        try:
            digest = self.artifacts.write(data, suffix=PACK_SUFFIX,
                                          fault_site=PACK_FAULT_SITE)
        except faults.InjectedCrash:
            raise
        except Exception:
            self.health.incr("gateway_pack_build_failures")
            return False
        self._packs[start] = {"start": start, "count": count,
                              "digest": digest, "tail": tail}
        self._journal_append({"start": start, "count": count,
                              "digest": digest, "tail": tail})
        self.health.incr("gateway_packs_built")
        return True

    # -- lookup / read -----------------------------------------------------

    def pack_for(self, period: int) -> dict | None:
        """Pack metadata covering `period`, or None when unpacked."""
        period = int(period)
        with self._lock:
            start = self.range_start(period)
            if start is None:
                return None
            meta = self._packs.get(start)
            if meta is not None and start + meta["count"] > period:
                return dict(meta)
        return None

    def read_pack(self, meta: dict) -> tuple[dict, bytes] | None:
        """Load + verify a pack's bytes; returns (slices, raw) where
        `slices` maps period -> (etag, offset, length) with offsets into
        `raw`. Corruption (the artifact store quarantines the file) or a
        malformed payload drops the mapping and triggers an immediate
        rebuild — the next request serves fresh pack bytes."""
        try:
            raw = self.artifacts.read(meta["digest"], PACK_SUFFIX)
            index, base = decode_pack(raw)
            slices = {int(e["period"]): (e["etag"], base + int(e["offset"]),
                                         int(e["length"]))
                      for e in index["entries"]}
            return slices, raw
        except (ArtifactCorrupt, OSError, ValueError, KeyError):
            self.health.incr("gateway_pack_corrupt")
            with self._lock:
                cur = self._packs.get(meta["start"])
                if cur is not None and cur["digest"] == meta["digest"]:
                    del self._packs[meta["start"]]
            self.ensure_packs()             # rebuild from the update store
            return None

    def live_artifacts(self) -> set:
        """(digest, suffix) keep-set for the artifact scrubber: current
        packs are never expired as orphans (superseded tail packs drop
        out and get reaped — that is the intended lifecycle)."""
        with self._lock:
            return {(m["digest"], PACK_SUFFIX)
                    for m in self._packs.values() if m["digest"]}

    def snapshot(self) -> dict:
        with self._lock:
            return {"packs": len(self._packs),
                    "pack_periods": self.pack_periods,
                    "packed_through": max(
                        (m["start"] + m["count"] for m in
                         self._packs.values()), default=None)}
