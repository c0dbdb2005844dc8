"""Typed JSON-RPC client (the port's copy of
`spectre_tpu/prover_service/rpc_client.py`; reference parity:
`prover/src/rpc_client.rs:39-93`). It speaks the reference's wire, so it
drives either package's server.

Requests carry a timeout and retry once on a connection reset (a service
restarting under a rolling deploy); an `error` member in the response raises a typed
`RpcError(code, message)`. The async job API (`submitProof_*` /
`getProofStatus` / `getProofResult`) sits beside the blocking reference
methods, with a `wait_for_proof` poll helper and `health` probes.

A load-shedding server answers `-32001 service overloaded` / HTTP 429
with `Retry-After`: submits and polls honor the server's `retry_after_s`
hint with capped jitter in one bounded retry loop (`overload_retries`,
default 2); an exhausted loop surfaces the typed `RpcError` with
`.retry_after` set. `wait_for_proof` threads one overall deadline
(computed once from the injectable `clock`) through per-poll HTTP
timeouts, overload backoffs and poll sleeps. `sleep`/`rng`/`clock` are
injectable so the backoff paths test deterministically.

A proof farm has many frontends: the client takes a list of endpoints, a
connection-reset retry rotates to the next one, and once the rotation is
spent it asks the endpoints' `health` for the dispatcher's membership and
adopts replicas it does not know yet. The follower's stored updates are
read with `get_light_client_update` / `get_update_range` /
`follower_status`, and through the gateway's cacheable `GET /v1/*` routes
with the ETag-revalidating `get_update_cached` /
`get_update_range_cached` / `get_bootstrap_cached`.
"""

from __future__ import annotations

import http.client
import json
import random
import time
import urllib.error
import urllib.request
from collections import OrderedDict
from urllib.parse import urlsplit, urlunsplit

from .rpc import (RPC_METHOD_COMMITTEE, RPC_METHOD_COMMITTEE_SUBMIT,
                  RPC_METHOD_STEP, RPC_METHOD_STEP_SUBMIT,
                  SERVICE_OVERLOADED, UPDATE_UNAVAILABLE)


class RpcError(RuntimeError):
    """A JSON-RPC error response (code + message, as sent by the server).
    `retry_after` carries the server's backoff hint (seconds) on a
    `-32001 service overloaded` shed, else None. `replica_id` names the
    replica that served the error, when the server stamps one (a farm's
    servers do; None otherwise)."""

    def __init__(self, code: int, message: str,
                 retry_after: float | None = None,
                 replica_id: str | None = None):
        super().__init__(f"rpc error {code}: {message}"
                         + (f" [replica {replica_id}]" if replica_id else ""))
        self.code = code
        self.message = message
        self.retry_after = retry_after
        self.replica_id = replica_id


def _is_conn_reset(exc: BaseException) -> bool:
    if isinstance(exc, (ConnectionResetError, ConnectionRefusedError,
                        http.client.RemoteDisconnected)):
        return True
    reason = getattr(exc, "reason", None)
    return isinstance(reason, (ConnectionResetError, ConnectionRefusedError))


class ProverClient:
    def __init__(self, url, timeout: float = 3600.0,
                 conn_retries: int = 1, overload_retries: int = 2,
                 retry_after_cap: float = 30.0,
                 sleep=time.sleep, rng=random.random, clock=time.time):
        """`url`: the server's JSON-RPC endpoint (http://host:port/rpc), or
        a list of them (a proof farm's frontends). Calls go to the current
        endpoint; a connection-reset retry rotates to the next one first,
        so the retry lands on a different replica instead of the one that
        just dropped the connection."""
        self.urls = [url] if isinstance(url, str) else list(url)
        if not self.urls:
            raise ValueError("ProverClient needs at least one URL")
        self._url_index = 0
        self.timeout = timeout
        self.conn_retries = conn_retries
        self.overload_retries = overload_retries
        self.retry_after_cap = retry_after_cap
        self._sleep = sleep
        self._rng = rng
        self._clock = clock
        self._id = 0
        # the gateway's conditional-request cache: path -> (etag, decoded
        # body), a bounded LRU; a 304 re-serves the cached decode without
        # downloading the proof bytes again
        self._etag_cache: "OrderedDict[str, tuple]" = OrderedDict()
        self.etag_cache_max = 256
        self.cache_304s = 0          # revalidated-not-modified responses
        self.endpoint_refreshes = 0  # membership-driven rotations grown

    @property
    def url(self) -> str:
        """Current endpoint (rotates on connection-reset retries)."""
        return self.urls[self._url_index % len(self.urls)]

    @url.setter
    def url(self, value: str):
        self.urls = [value]
        self._url_index = 0

    def _rotate_url(self):
        if len(self.urls) > 1:
            self._url_index = (self._url_index + 1) % len(self.urls)

    def _refresh_endpoints(self) -> bool:
        """Membership-driven endpoint discovery: when the conn-reset
        rotation has exhausted every configured URL, ask each endpoint's
        `health` RPC for the dispatcher membership and adopt replica URLs
        this client does not know yet. One-shot direct POSTs (no retry
        recursion). Returns True when the rotation grew, with the current
        endpoint pointed at the first new URL."""
        for base in list(self.urls):
            self._id += 1
            body = json.dumps({"jsonrpc": "2.0", "method": "health",
                               "params": {}, "id": self._id}).encode()
            req = urllib.request.Request(
                base, data=body, headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=min(self.timeout, 10.0)) as resp:
                    data = json.load(resp)
            except Exception:
                continue
            replicas = ((data.get("result") or {}).get("dispatcher")
                        or {}).get("replicas") or []
            fresh = [r.get("url") for r in replicas
                     if isinstance(r, dict) and r.get("url")
                     and r["url"] not in self.urls]
            if fresh:
                first = len(self.urls)
                self.urls.extend(dict.fromkeys(fresh))
                self._url_index = first
                self.endpoint_refreshes += 1
                return True
        return False

    def _raise_rpc_error(self, data: dict, headers=None):
        err = (data or {}).get("error") or {}
        retry_after = None
        if err.get("code") == SERVICE_OVERLOADED:
            retry_after = (err.get("data") or {}).get("retry_after_s")
            if retry_after is None and headers is not None:
                try:
                    retry_after = float(headers.get("Retry-After"))
                except (TypeError, ValueError):
                    pass
        data_field = err.get("data")
        replica_id = data_field.get("replica_id") \
            if isinstance(data_field, dict) else None
        raise RpcError(err.get("code", -32603),
                       err.get("message", "unknown error"),
                       retry_after=retry_after, replica_id=replica_id)

    def _call(self, method: str, params: dict, timeout: float | None = None):
        self._id += 1
        body = json.dumps({"jsonrpc": "2.0", "method": method,
                           "params": params, "id": self._id}).encode()
        attempt = 0
        refreshed = False
        while True:
            req = urllib.request.Request(
                self.url, data=body,
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(
                        req, timeout=timeout or self.timeout) as resp:
                    data = json.load(resp)
                break
            except urllib.error.HTTPError as exc:
                # HTTP 429 load shed: the body still carries the JSON-RPC
                # -32001 envelope; surface it typed, with the Retry-After
                if exc.code == 429:
                    try:
                        data = json.load(exc)
                    except ValueError:
                        data = {}
                    self._raise_rpc_error(data, headers=exc.headers)
                raise
            except Exception as exc:
                if _is_conn_reset(exc):
                    if attempt < self.conn_retries:
                        # prefer a different replica: the endpoint that
                        # reset us is the one most likely mid-restart
                        self._rotate_url()
                        attempt += 1
                        continue
                    if not refreshed and self._refresh_endpoints():
                        # rotation exhausted: refresh the endpoint list
                        # from the dispatcher's membership once before
                        # failing; the adopted URLs get their own budget
                        refreshed = True
                        attempt = 0
                        continue
                raise
        if "error" in data:
            self._raise_rpc_error(data)
        return data["result"]

    def _call_shedding(self, method: str, params: dict,
                       timeout: float | None = None,
                       deadline: float | None = None):
        """`_call` plus the ONE bounded overload-retry loop: a -32001/429
        shed sleeps the server's retry_after_s (capped, with jitter so a
        shed fleet doesn't re-stampede) up to `overload_retries` times,
        then surfaces the typed RpcError (with .retry_after) to the
        caller. `deadline` (absolute, `clock()` domain) caps the retry
        sleeps: a backoff that would overshoot it surfaces the RpcError
        immediately instead — the caller's overall deadline wins."""
        for attempt in range(self.overload_retries + 1):
            try:
                return self._call(method, params, timeout=timeout)
            except RpcError as exc:
                if exc.code != SERVICE_OVERLOADED \
                        or attempt >= self.overload_retries:
                    raise
                base = exc.retry_after if exc.retry_after is not None else 1.0
                delay = min(self.retry_after_cap, base) \
                    * (1.0 + 0.25 * self._rng())
                if deadline is not None \
                        and self._clock() + delay > deadline:
                    raise
                self._sleep(delay)

    def ping(self) -> str:
        return self._call("ping", {}, timeout=min(self.timeout, 30.0))

    # -- blocking reference methods ---------------------------------------

    def gen_evm_proof_sync_step_compressed(self, finality_update: dict,
                                           pubkeys: list, domain: str):
        return self._call(RPC_METHOD_STEP, {
            "light_client_finality_update": finality_update,
            "pubkeys": pubkeys,
            "domain": domain,
        })

    def gen_evm_proof_committee_update_compressed(self, update: dict):
        return self._call(RPC_METHOD_COMMITTEE, {"light_client_update": update})

    # -- async job API -----------------------------------------------------

    def submit_sync_step(self, finality_update: dict, pubkeys: list,
                         domain: str, job_timeout: float | None = None,
                         deadline_s: float | None = None) -> str:
        params = {"light_client_finality_update": finality_update,
                  "pubkeys": pubkeys, "domain": domain}
        if job_timeout is not None:
            params["timeout"] = job_timeout
        if deadline_s is not None:
            params["deadline_s"] = deadline_s
        return self._call_shedding(RPC_METHOD_STEP_SUBMIT, params,
                                   timeout=min(self.timeout, 60.0))["job_id"]

    def submit_committee_update(self, update: dict,
                                job_timeout: float | None = None,
                                deadline_s: float | None = None) -> str:
        params = {"light_client_update": update}
        if job_timeout is not None:
            params["timeout"] = job_timeout
        if deadline_s is not None:
            params["deadline_s"] = deadline_s
        return self._call_shedding(RPC_METHOD_COMMITTEE_SUBMIT, params,
                                   timeout=min(self.timeout, 60.0))["job_id"]

    def proof_status(self, job_id: str) -> dict:
        return self._call("getProofStatus", {"job_id": job_id},
                          timeout=min(self.timeout, 30.0))

    def proof_result(self, job_id: str) -> dict:
        return self._call("getProofResult", {"job_id": job_id},
                          timeout=min(self.timeout, 30.0))

    def cancel_proof(self, job_id: str) -> bool:
        return self._call("cancelProof", {"job_id": job_id},
                          timeout=min(self.timeout, 30.0))["cancelled"]

    def wait_for_proof(self, job_id: str, poll: float = 1.0,
                       timeout: float | None = None) -> dict:
        """Poll getProofStatus until terminal, then return the result.
        Raises RpcError on a failed job and TimeoutError past `timeout`.

        One overall deadline, computed once from the injected clock,
        bounds the whole wait — every per-poll HTTP timeout, every
        overload-retry sleep inside `_call_shedding`, and every poll
        sleep is clamped to the time remaining, so a slow or shedding
        server cannot stretch the wait past `timeout`."""
        deadline = (None if timeout is None
                    else self._clock() + timeout)
        last_status = "unknown"
        while True:
            remaining = None
            if deadline is not None:
                remaining = deadline - self._clock()
                if remaining <= 0:
                    raise TimeoutError(f"job {job_id} still {last_status} "
                                       f"after {timeout}s")
            call_timeout = min(self.timeout, 30.0)
            if remaining is not None:
                call_timeout = min(call_timeout, max(remaining, 0.1))
            # polls ride the same bounded overload-retry loop as submits,
            # but the deadline caps its backoff sleeps too
            st = self._call_shedding("getProofStatus", {"job_id": job_id},
                                     timeout=call_timeout, deadline=deadline)
            last_status = st["status"]
            if st["status"] in ("done", "failed", "cancelled"):
                result_timeout = min(self.timeout, 30.0)
                if deadline is not None:
                    result_timeout = min(
                        result_timeout,
                        max(deadline - self._clock(), 0.1))
                return self._call("getProofResult", {"job_id": job_id},
                                  timeout=result_timeout)
            delay = poll
            if deadline is not None:
                delay = min(delay, max(deadline - self._clock(), 0.0))
            self._sleep(delay)

    def health(self) -> dict:
        return self._call("health", {}, timeout=min(self.timeout, 30.0))

    # -- observability ------------------------------------------------------

    def get_trace(self, job_id: str) -> dict:
        """Chrome trace-event JSON for a completed job (trace id = job
        id). Raises RpcError -32002 while the job is still live, -32004
        for unknown jobs / traces past the retention ring."""
        return self._call("getTrace", {"job_id": job_id},
                          timeout=min(self.timeout, 30.0))

    def get_manifest(self, job_id: str) -> dict:
        """Provenance manifest for a terminal job: timestamps with the
        queue-wait/prove split, the MSM mode + env knobs, degrade/fault
        events, table-LRU deltas, kernel builds and launches (the
        reference's server: compile events), phase seconds, peak RSS and
        the result digest. Raises RpcError -32002
        while the job is live, -32004 for unknown jobs, -32006 when the
        manifest degraded to absent (the result itself is unaffected)."""
        return self._call("getProofManifest", {"job_id": job_id},
                          timeout=min(self.timeout, 30.0))

    # -- follower / light-client updates -----------------------------------

    def get_light_client_update(self, period: int | None = None,
                                slot: int | None = None) -> dict:
        """Stored verified update: a committee update by `period` or a
        step proof by `slot`, served from the follower's update store (a
        hit never touches the prover). Raises RpcError -32007 when the
        update is not (yet) proved."""
        params: dict = {}
        if period is not None:
            params["period"] = period
        if slot is not None:
            params["slot"] = slot
        return self._call("getLightClientUpdate", params,
                          timeout=min(self.timeout, 30.0))

    def get_update_range(self, start_period: int, count: int = 1) -> dict:
        """Contiguous committee updates starting at `start_period`:
        {"updates": [...], "missing": [periods]} (count capped at 128)."""
        return self._call("getUpdateRange",
                          {"start_period": start_period, "count": count},
                          timeout=min(self.timeout, 30.0))

    def follower_status(self) -> dict:
        """Follower snapshot: head lag, periods behind, scheduler backlog,
        chain health (`chain_ok`), stored counts."""
        return self._call("followerStatus", {}, timeout=min(self.timeout, 30.0))

    # -- the gateway's read plane ------------------------------------------

    def _gateway_url(self, path: str, query: str = "") -> str:
        parts = urlsplit(self.url)
        return urlunsplit((parts.scheme, parts.netloc, path, query, ""))

    def _cached_get(self, path: str, query: str = "") -> dict:
        """Conditional GET against the gateway's /v1/* routes: sends
        If-None-Match from the client-side digest cache, honors 304 by
        re-serving the cached decode. A 404 surfaces as the same typed
        -32007 `update unavailable` the RPC method raises."""
        key = path + ("?" + query if query else "")
        cached = self._etag_cache.get(key)
        req = urllib.request.Request(self._gateway_url(path, query))
        if cached is not None:
            req.add_header("If-None-Match", cached[0])
        try:
            with urllib.request.urlopen(req, timeout=min(self.timeout, 30.0)) as resp:
                body = json.load(resp)
                etag = resp.headers.get("ETag")
        except urllib.error.HTTPError as exc:
            if exc.code == 304 and cached is not None:
                exc.read()
                self.cache_304s += 1
                self._etag_cache.move_to_end(key)
                return cached[1]
            if exc.code == 404:
                try:
                    message = json.load(exc).get("error", "not found")
                except ValueError:
                    message = "not found"
                raise RpcError(UPDATE_UNAVAILABLE, message)
            raise
        if etag:
            self._etag_cache[key] = (etag, body)
            self._etag_cache.move_to_end(key)
            while len(self._etag_cache) > self.etag_cache_max:
                self._etag_cache.popitem(last=False)
        return body

    def get_update_cached(self, period: int) -> dict:
        """One committee update via the cacheable gateway route
        (GET /v1/update/<period>): ETag-revalidated from the client-side
        digest cache, so a sealed update is downloaded at most once per
        client. Needs a server with a gateway; raises RpcError -32007 when
        the update is not (yet) proved."""
        return self._cached_get(f"/v1/update/{int(period)}")

    def get_update_range_cached(self, start_period: int, count: int = 1) -> dict:
        """Range variant of :meth:`get_update_cached`
        (GET /v1/updates?start=..&count=..): {"updates": [...],
        "missing": [...]} like get_update_range."""
        return self._cached_get("/v1/updates", f"start={int(start_period)}&count={int(count)}")

    def get_bootstrap_cached(self) -> dict:
        """Cold-start document (GET /v1/bootstrap): trust anchor update +
        tip period, short-TTL cached."""
        return self._cached_get("/v1/bootstrap")

    def metrics_text(self) -> str:
        """Raw GET /metrics body (Prometheus text exposition 0.0.4) from
        the same host as the RPC endpoint."""
        parts = urlsplit(self.url)
        url = urlunsplit((parts.scheme, parts.netloc, "/metrics", "", ""))
        with urllib.request.urlopen(
                url, timeout=min(self.timeout, 30.0)) as resp:
            return resp.read().decode()

    def healthz(self) -> tuple[int, dict]:
        """GET /healthz: (HTTP status, body); 503 until the server is ready
        (closed beacon breakers, a passing self-check)."""
        parts = urlsplit(self.url)
        url = urlunsplit((parts.scheme, parts.netloc, "/healthz", "", ""))
        try:
            with urllib.request.urlopen(url, timeout=min(self.timeout, 30.0)) as resp:
                return resp.status, json.load(resp)
        except urllib.error.HTTPError as exc:
            return exc.code, json.load(exc)
