"""Cacheable HTTP read plane for light-client updates (the port's copy
of `spectre_tpu/gateway/serving.py`).

The paper's production story is one aggregated proof amortized over
millions of light clients; the scarce resource is the *prove* path, so
the *read* path must be engineered to never touch it. Stored updates
are content-addressed and immutable once their period is sealed —
exactly the workload HTTP caching was built for. This module serves

* ``GET /v1/update/<period>``  — one committee update,
* ``GET /v1/updates?start=..&count=..`` — a contiguous range,
* ``GET /v1/bootstrap`` — trust anchor + tip for a cold client,

with real HTTP cache semantics so ANY stock CDN, reverse proxy or
browser cache can absorb the fan-out:

* ``ETag`` = the update's content digest (the artifact sha256 the
  journal already records) — stable across restarts by construction;
* ``If-None-Match`` -> ``304 Not Modified`` with no body assembly
  beyond a metadata lookup (no artifact read, no pack slice);
* ``Cache-Control: public, immutable, max-age=31536000`` for *sealed*
  periods (finalized, strictly below the chain tip — they can never
  change) vs ``public, max-age=<SPECTRE_GATEWAY_HEAD_TTL_S>`` for the
  head period and anything derived from the tip.

Behind the headers, sealed bodies come from pre-built update-range
packs (gateway/packs.py) held in a byte-budgeted hot cache
(gateway/cache.py, ``SPECTRE_GATEWAY_CACHE_MB``): a range response is a
pack-slice concatenation, not K ``UpdateStore`` reads + K JSON encodes.
A sealed request that has to fall back to the update store (pack build
failed, hole being re-proved) is counted on
``gateway_store_fallbacks`` — the acceptance drill pins that counter to
ZERO for sealed traffic. All ``gateway_*`` counters ride
``HEALTH.snapshot()`` into ``/healthz`` and ``/metrics`` with zero
exporter changes.

Framework-free on purpose: :meth:`Gateway.handle` returns ``(status,
headers, body)`` tuples, so ``prover_service/rpc.py`` mounts it on the
existing ``ThreadingHTTPServer``, the load generator drives it
in-process with zero HTTP overhead, and tests assert on exact bytes.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
import weakref
from urllib.parse import parse_qs, urlsplit

from ..observability.metrics import REGISTRY
from ..utils.health import HEALTH
from .cache import GatewayCache
from .packs import PackBuilder, canonical_update_body

HEAD_TTL_ENV = "SPECTRE_GATEWAY_HEAD_TTL_S"
DEFAULT_HEAD_TTL_S = 12
SEALED_MAX_AGE = 31536000          # one year: "immutable" has no expiry
RANGE_COUNT_CAP = 128              # parity with getUpdateRange

# read-plane latency: sub-millisecond cache/pack hits up through the
# store-fallback and cold-pack-load tail (grafana: "Gateway" row p99)
REQUEST_LATENCY = REGISTRY.histogram(
    "spectre_gateway_request_seconds",
    "Gateway read-plane latency per handled /v1 request (seconds)",
    (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
     0.05, 0.1, 0.25, 1.0))

CONTENT_TYPE = "application/json"

# live gateways for prom gauges (follower_snapshot pattern)
_GATEWAYS: "weakref.WeakSet" = weakref.WeakSet()


def gateway_snapshot() -> list[dict]:
    return [g.snapshot() for g in list(_GATEWAYS)]


def _quote(etag: str) -> str:
    return f'"{etag}"'


def _etag_matches(if_none_match: str | None, etag: str) -> bool:
    if not if_none_match:
        return False
    if if_none_match.strip() == "*":
        return True
    quoted = _quote(etag)
    for candidate in if_none_match.split(","):
        candidate = candidate.strip()
        if candidate.startswith("W/"):
            candidate = candidate[2:]
        if candidate == quoted or candidate == etag:
            return True
    return False


class Gateway:
    """One gateway per served :class:`UpdateStore`."""

    def __init__(self, store, pack_periods: int | None = None,
                 cache_mb: float | None = None,
                 head_ttl_s: float | None = None, health=HEALTH):
        self.store = store
        self.health = health
        if head_ttl_s is None:
            head_ttl_s = float(os.environ.get(HEAD_TTL_ENV)
                               or DEFAULT_HEAD_TTL_S)
        self.head_ttl_s = max(0, int(head_ttl_s))
        self.cache = GatewayCache(cache_mb, health=health)
        self.packs = PackBuilder(store, pack_periods, health=health)
        # pack-seal hook: every committee append re-checks sealing, so
        # packs exist BEFORE the first client asks for the range
        store.add_append_observer(self._on_append)
        self.packs.ensure_packs()      # journal-replay recovery build
        _GATEWAYS.add(self)

    def _on_append(self, kind: str, key: int) -> None:
        if kind == "committee":
            self.packs.ensure_packs()

    def live_artifacts(self) -> set:
        """Forward the pack keep-set (register with the job queue's
        scrubber alongside the store's own provider)."""
        return self.packs.live_artifacts()

    # -- body assembly -----------------------------------------------------

    def _pack_loaded(self, meta: dict):
        key = ("pack", meta["digest"])
        loaded = self.cache.get(key)
        if loaded is not None:
            return loaded
        loaded = self.packs.read_pack(meta)
        if loaded is not None:
            self.cache.put(key, loaded, len(loaded[1]))
        return loaded

    def _sealed_body(self, period: int):
        """(etag, bytes) for a sealed period — pack slice (hot path) or
        counted store fallback. None when the period is missing."""
        meta = self.packs.pack_for(period)
        if meta is None:
            # maybe the pack was never built (write fault): retry now
            self.packs.ensure_packs()
            meta = self.packs.pack_for(period)
        loaded = self._pack_loaded(meta) if meta is not None else None
        if loaded is None and meta is not None:
            # read_pack dropped + rebuilt a corrupt pack: one more try
            meta = self.packs.pack_for(period)
            loaded = self._pack_loaded(meta) if meta is not None else None
        if loaded is not None:
            slices, raw = loaded
            ent = slices.get(period)
            if ent is not None:
                etag, off, length = ent
                self.health.incr("gateway_pack_hits")
                return etag, raw[off:off + length]
        rec = self.store.get_committee(period)
        if rec is None:
            return None
        self.health.incr("gateway_store_fallbacks")
        return rec["digest"], canonical_update_body(rec)

    def _head_body(self, period: int):
        """The head (tip) period: a plain store read — it is the one
        period that may still change, so it is never packed and never a
        'fallback'."""
        rec = self.store.get_committee(period)
        if rec is None:
            return None
        return rec["digest"], canonical_update_body(rec)

    def _body_for(self, period: int, tip: int):
        if period < tip:
            return self._sealed_body(period), True
        return self._head_body(period), False

    # -- responses ---------------------------------------------------------

    def _cache_control(self, sealed: bool) -> str:
        if sealed:
            return f"public, immutable, max-age={SEALED_MAX_AGE}"
        return f"public, max-age={self.head_ttl_s}"

    def _not_found(self, message: str):
        body = json.dumps({"error": message}, sort_keys=True,
                          separators=(",", ":")).encode()
        return 404, {"Cache-Control": "no-store",
                     "Content-Type": CONTENT_TYPE}, body

    def _reply(self, etag: str, sealed: bool, if_none_match: str | None,
               body_fn):
        headers = {"ETag": _quote(etag),
                   "Cache-Control": self._cache_control(sealed),
                   "Content-Type": CONTENT_TYPE}
        if _etag_matches(if_none_match, etag):
            self.health.incr("gateway_304s")
            return 304, headers, b""
        body = body_fn()
        if body is None:
            return self._not_found("update invalidated; re-proving")
        return 200, headers, body

    def update(self, period: int, if_none_match: str | None = None):
        """GET /v1/update/<period>"""
        self.health.incr("gateway_requests")
        period = int(period)
        tip = self.store.tip_period()
        if tip is None or not self.store.has_committee(period):
            return self._not_found(
                f"no verified update for period {period} (not yet "
                f"proved, or invalidated and re-proving)")
        # metadata-only ETag: a 304 never reads an artifact or a pack
        etag = self.store.committee_digest(period)
        if etag is None:
            return self._not_found(
                f"no verified update for period {period}")
        sealed = period < tip

        def body():
            got, _ = self._body_for(period, tip)
            return None if got is None else got[1]

        return self._reply(etag, sealed, if_none_match, body)

    def updates(self, start: int, count: int = 1,
                if_none_match: str | None = None):
        """GET /v1/updates?start=..&count=.. — canonical JSON
        ``{"missing": [...], "updates": [...]}`` assembled from pack
        slices (byte-identical to encoding direct store reads)."""
        self.health.incr("gateway_requests")
        start, count = int(start), min(int(count), RANGE_COUNT_CAP)
        if count < 1:
            return self._not_found("count must be >= 1")
        tip = self.store.tip_period()
        if tip is None:
            return self._not_found("no verified updates stored yet")
        found, missing = [], []
        for p in range(start, start + count):
            digest = self.store.committee_digest(p)
            if digest is None:
                missing.append(p)
            else:
                found.append((p, digest))
        # range ETag: derived from member content digests + the missing
        # set — stable across restarts, changes exactly when content does
        etag = hashlib.sha256(
            ("|".join(f"{p}:{d}" for p, d in found)
             + "//" + ",".join(map(str, missing))).encode()).hexdigest()
        sealed = not missing and bool(found) \
            and max(p for p, _ in found) < tip

        def body():
            parts = []
            for p, _ in found:
                got, _sealed = self._body_for(p, tip)
                if got is None:
                    return None      # invalidated mid-assembly: rare race
                parts.append(got[1])
            return (b'{"missing":' + json.dumps(missing).encode()
                    + b',"updates":[' + b",".join(parts) + b"]}")

        return self._reply(etag, sealed, if_none_match, body)

    def bootstrap(self, if_none_match: str | None = None):
        """GET /v1/bootstrap — the trust anchor update + tip pointer a
        cold client needs before walking ranges. Tip-derived, so head
        (short-TTL) cache semantics even though the anchor is sealed."""
        self.health.incr("gateway_requests")
        anchor = self.store.anchor_period()
        tip = self.store.tip_period()
        if anchor is None or tip is None \
                or not self.store.has_committee(anchor):
            return self._not_found("no verified chain anchor stored yet")
        anchor_digest = self.store.committee_digest(anchor)
        if anchor_digest is None:
            return self._not_found("no verified chain anchor stored yet")
        etag = hashlib.sha256(
            f"{anchor}|{tip}|{anchor_digest}".encode()).hexdigest()

        def body():
            got, _sealed = self._body_for(anchor, tip)
            if got is None:
                return None
            return (b'{"anchor_period":' + str(anchor).encode()
                    + b',"tip_period":' + str(tip).encode()
                    + b',"update":' + got[1] + b"}")

        return self._reply(etag, False, if_none_match, body)

    # -- HTTP plumbing -----------------------------------------------------

    def handle_http(self, raw_path: str, headers=None):
        """Route one GET. `headers` is any mapping with .get (the
        BaseHTTPRequestHandler headers object qualifies). Returns
        (status, headers dict, body bytes); unknown /v1 paths are 404."""
        t0 = time.perf_counter()
        try:
            return self._route(raw_path, headers)
        finally:
            REQUEST_LATENCY.observe(time.perf_counter() - t0)

    def _route(self, raw_path: str, headers=None):
        parts = urlsplit(raw_path)
        inm = headers.get("If-None-Match") if headers is not None else None
        path = parts.path.rstrip("/")
        try:
            if path.startswith("/v1/update/"):
                return self.update(int(path.rsplit("/", 1)[1]),
                                   if_none_match=inm)
            if path == "/v1/updates":
                q = parse_qs(parts.query)
                return self.updates(int(q["start"][0]),
                                    int(q.get("count", ["1"])[0]),
                                    if_none_match=inm)
            if path == "/v1/bootstrap":
                return self.bootstrap(if_none_match=inm)
        except (KeyError, ValueError, IndexError):
            body = json.dumps({"error": "bad request"}).encode()
            return 400, {"Cache-Control": "no-store",
                         "Content-Type": CONTENT_TYPE}, body
        return self._not_found(f"unknown path {path}")

    def snapshot(self) -> dict:
        snap = {"store": getattr(self.store, "dir", ""),
                "head_ttl_s": self.head_ttl_s,
                "cache": self.cache.stats()}
        snap.update(self.packs.snapshot())
        return snap
