"""Light-client load drill (the port's copy
of `spectre_tpu/loadgen/drill.py`).

Replays a configurable simulated client population against a serving
gateway and reports what a CDN operator would ask: latency percentiles,
requests/s, the 304 ratio, and the gateway's own counters
(pack hits / cache evictions / store fallbacks). The traffic model is
the paper's serving story in miniature:

* **population** — ``clients`` simulated light clients (default 10^6
  from the CLI). Each client keeps a small
  client-side digest cache (the ETag of every response it has seen) and
  sends ``If-None-Match`` on revisits — exactly what
  ``rpc_client.ProverClient.get_update_cached`` does for real clients.
* **periods** — Zipf-distributed over the stored chain (rank 1 = the
  newest period): real light clients overwhelmingly pull the recent
  tail, with a long tail of cold bootstrappers walking history.
* **mix** — bootstrap / range / single-update traffic in configurable
  proportions (defaults: 5% bootstrap, 25% range, 70% single).
* **faults** — arm ``SPECTRE_FAULT_PLAN`` before the run and the drill
  doubles as a chaos exercise (the tests' acceptance drill runs with
  ``gateway.pack_write:ioerror`` + a torn journal tail active).

Targets are duck-typed: :class:`InProcessTarget` drives a
:class:`~spectre_tpu_torch.gateway.Gateway` directly (zero HTTP
overhead), :class:`HttpTarget` drives a live
server's ``/v1/*`` routes over urllib. Everything is stdlib; no numpy
on the request path.
"""

from __future__ import annotations

import bisect
import random
import threading
import time
import urllib.error
import urllib.request

DEFAULT_MIX = {"bootstrap": 0.05, "range": 0.25, "single": 0.70}
DEFAULT_ZIPF_S = 1.1


class ZipfSampler:
    """Zipf over ranks 1..n via inverse-CDF + bisect (stdlib only)."""

    def __init__(self, n: int, s: float = DEFAULT_ZIPF_S):
        self.n = max(1, int(n))
        weights, total = [], 0.0
        for rank in range(1, self.n + 1):
            total += 1.0 / (rank ** s)
            weights.append(total)
        self._cdf = [w / total for w in weights]

    def sample(self, rng: random.Random) -> int:
        """0-based rank: 0 is the hottest."""
        return bisect.bisect_left(self._cdf, rng.random())


class InProcessTarget:
    """Drives a Gateway object directly, in process."""

    def __init__(self, gateway):
        self.gateway = gateway

    def get(self, path: str, if_none_match: str | None = None):
        """(status, etag) — the drill only needs cache-validation data."""
        status, headers, _body = self.gateway.handle_http(
            path, {"If-None-Match": if_none_match} if if_none_match
            else None)
        return status, headers.get("ETag")


class HttpTarget:
    """Drives a live server's /v1/* routes (the CLI's default)."""

    def __init__(self, base_url: str, timeout: float = 10.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    def get(self, path: str, if_none_match: str | None = None):
        req = urllib.request.Request(self.base_url + path)
        if if_none_match:
            req.add_header("If-None-Match", if_none_match)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                resp.read()
                return resp.status, resp.headers.get("ETag")
        except urllib.error.HTTPError as exc:
            exc.read()
            return exc.code, exc.headers.get("ETag")


def _percentile(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[idx]


class _Worker:
    """One drill shard: its own RNG stream + per-client etag caches
    (lazily created — only clients that actually fire allocate one)."""

    def __init__(self, target, periods: list[int], tip: int,
                 zipf: ZipfSampler, mix: dict, clients: int,
                 requests: int, range_count: int, seed: int):
        self.target = target
        self.periods = periods       # newest first (Zipf rank order)
        self.tip = tip
        self.zipf = zipf
        self.mix = mix
        self.clients = clients
        self.requests = requests
        self.range_count = range_count
        self.rng = random.Random(seed)
        self.etags: dict[int, dict] = {}    # client -> {path: etag}
        self.latencies: list[float] = []
        self.statuses: dict[int, int] = {}
        self.sealed_requests = 0
        self.sealed_304s = 0
        self.sent_inm = 0

    def _pick_path(self) -> tuple[str, bool]:
        """(request path, whole request is sealed-period traffic)."""
        r = self.rng.random()
        period = self.periods[self.zipf.sample(self.rng)]
        if r < self.mix["bootstrap"]:
            return "/v1/bootstrap", False
        if r < self.mix["bootstrap"] + self.mix["range"]:
            count = self.rng.randint(1, self.range_count)
            start = max(self.periods[-1], period - count + 1)
            count = min(count, self.tip - start + 1)
            sealed = start + count - 1 < self.tip
            return f"/v1/updates?start={start}&count={count}", sealed
        return f"/v1/update/{period}", period < self.tip

    def run(self):
        for _ in range(self.requests):
            client = self.rng.randrange(self.clients)
            path, sealed = self._pick_path()
            cache = self.etags.get(client)
            inm = cache.get(path) if cache else None
            if inm:
                self.sent_inm += 1
            t0 = time.perf_counter()
            status, etag = self.target.get(path, if_none_match=inm)
            self.latencies.append(time.perf_counter() - t0)
            self.statuses[status] = self.statuses.get(status, 0) + 1
            if sealed:
                self.sealed_requests += 1
                if status == 304:
                    self.sealed_304s += 1
            if etag and status in (200, 304):
                if cache is None:
                    cache = self.etags.setdefault(client, {})
                cache[path] = etag
        return self


def run_drill(target, periods: list[int], tip: int,
              clients: int = 10_000, requests: int | None = None,
              zipf_s: float = DEFAULT_ZIPF_S, mix: dict | None = None,
              range_count: int = 8, threads: int = 1,
              seed: int = 0, health=None) -> dict:
    """Run the drill; returns the report dict (latency percentiles in
    ms, rps, status mix, sealed-traffic accounting, and — when `health`
    is passed — the gateway counter deltas over the run).

    `periods` must be newest-first (Zipf rank 0 = hottest = newest);
    `requests` defaults to 2 per client so revisits exercise the
    If-None-Match -> 304 path.
    """
    if not periods:
        raise ValueError("run_drill needs a non-empty period list")
    mix = dict(DEFAULT_MIX if mix is None else mix)
    total = sum(mix.values())
    mix = {k: v / total for k, v in mix.items()}
    if requests is None:
        requests = 2 * clients
    zipf = ZipfSampler(len(periods), zipf_s)
    before = dict(health.snapshot()["counters"]) if health else {}
    threads = max(1, int(threads))
    share, rem = divmod(requests, threads)
    workers = [_Worker(target, periods, tip, zipf, mix, clients,
                       share + (1 if i < rem else 0), range_count,
                       seed + i) for i in range(threads)]
    t0 = time.perf_counter()
    if threads == 1:
        workers[0].run()
    else:
        ts = [threading.Thread(target=w.run) for w in workers]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    elapsed = time.perf_counter() - t0

    lat = sorted(x for w in workers for x in w.latencies)
    statuses: dict[int, int] = {}
    for w in workers:
        for s, c in w.statuses.items():
            statuses[s] = statuses.get(s, 0) + c
    n304 = statuses.get(304, 0)
    report = {
        "clients": clients,
        "requests": requests,
        "threads": threads,
        "elapsed_s": round(elapsed, 4),
        "rps": round(requests / elapsed, 1) if elapsed > 0 else 0.0,
        "latency_ms": {
            "p50": round(_percentile(lat, 0.50) * 1e3, 4),
            "p90": round(_percentile(lat, 0.90) * 1e3, 4),
            "p99": round(_percentile(lat, 0.99) * 1e3, 4),
            "max": round((lat[-1] if lat else 0.0) * 1e3, 4),
        },
        "statuses": {str(k): v for k, v in sorted(statuses.items())},
        "ratio_304": round(n304 / requests, 4) if requests else 0.0,
        "if_none_match_sent": sum(w.sent_inm for w in workers),
        "sealed_requests": sum(w.sealed_requests for w in workers),
        "sealed_304s": sum(w.sealed_304s for w in workers),
    }
    if health is not None:
        after = health.snapshot()["counters"]
        report["gateway_counters"] = {
            k: after.get(k, 0) - before.get(k, 0)
            for k in sorted(set(after) | set(before))
            if k.startswith("gateway_")}
    return report
