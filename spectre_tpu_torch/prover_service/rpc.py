"""JSON-RPC 2.0 server, stdlib http.server (the port's copy of
`spectre_tpu/prover_service/rpc.py`; method names, error codes and result
fields are the reference's: they are the wire).

Reference parity: `prover/src/rpc.rs` + `rpc_api.rs:8-36` — POST /rpc with
methods `genEvmProof_SyncStepCompressed` and
`genEvmProof_CommitteeUpdateCompressed`; responses carry proof + instances
+ calldata; the committee variant also the committee's Poseidon commitment
(`rpc.rs:106`).

* **Async job API** — `submitProof_SyncStepCompressed` /
  `submitProof_CommitteeUpdateCompressed` return a job id immediately;
  `getProofStatus` / `getProofResult` poll it; `cancelProof` cancels.
  The blocking `genEvmProof_*` methods run on top of the same queue
  (submit + wait), so every proof flows through the crash-safe journal
  and the dedup-by-witness-digest path (prover_service/jobs.py).
* **Error taxonomy** — malformed JSON is `-32700 parse error`, non-dict /
  missing-`jsonrpc` bodies are `-32600 invalid request`, unknown methods
  `-32601`, missing params `-32602`, witness rejection `-32000`, and
  unexpected internal errors `-32603 internal error` with a sanitized
  (exception-class-only) message. The port's chips and preprocessor raise
  ValueError where the reference asserts: both are witness rejections.
* **Health** — the `health` RPC method and GET `/healthz` surface the
  ServiceHealth counters plus queue stats; readiness (200) needs closed
  beacon breakers and a passing prove+verify self-check on the device.
* **Observability** — GET `/metrics` serves Prometheus text
  (observability/prom.py); `getTrace` returns a completed job's span tree
  as Chrome trace-event JSON; `getProofManifest` a terminal job's
  provenance manifest, re-verified through the artifact store on every
  read (`-32006 manifest unavailable` when absent or corrupt).
* **Output integrity** — every prove is verified host-side before its job
  goes `done` (selfverify.verified_prove; twice-failed proofs surface as
  `-32005 proof failed self-verification`); `scrubNow` runs one
  artifact-scrubber pass.
* **Follower serving** — `getLightClientUpdate` (by period or slot),
  `getUpdateRange` and `followerStatus` serve pre-proved light-client
  updates out of the follower's verified update store: a hit is one
  content-verified artifact read, never a job, the prover semaphore or the
  device. A missing or invalidated update answers `-32007 update
  unavailable` while the follower (re-)proves it; without a follower the
  three answer `-32601`. With a gateway, `GET /v1/*` serves the same store
  as cacheable HTTP (gateway/serving.py).
* **Proof farm** — with a `Dispatcher` (prover_service/dispatcher.py) the
  queue's runner routes proves to replicas; `registerReplica` takes their
  announces, `/healthz` and `health` gain a `dispatcher` section, and
  every error names the serving `replica_id` in its `data`. A replica
  server announces itself to a head (`announce=`).
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..preprocessor.rotation import rotation_args_from_update
from ..preprocessor.step import step_args_from_finality_update
from ..utils.health import HEALTH
from ..utils.profiling import phase
from .calldata import encode_calldata
from .jobs import ServiceOverloaded, ensure_jobs
from .selfverify import verified_prove
from .state import ProverState

RPC_METHOD_STEP = "genEvmProof_SyncStepCompressed"
RPC_METHOD_COMMITTEE = "genEvmProof_CommitteeUpdateCompressed"
RPC_METHOD_STEP_SUBMIT = "submitProof_SyncStepCompressed"
RPC_METHOD_COMMITTEE_SUBMIT = "submitProof_CommitteeUpdateCompressed"
# aggregation cadence: one job per cadence window of sealed periods —
# re-verifies the stored chain and emits the window tip's EVM-verifiable
# aggregate for contract publication
RPC_METHOD_AGG = "genEvmProof_AggregationCadence"
RPC_METHOD_AGG_SUBMIT = "submitProof_AggregationCadence"

# JSON-RPC 2.0 + implementation-defined codes (-32000..-32099 server errors)
PARSE_ERROR = -32700
INVALID_REQUEST = -32600
METHOD_NOT_FOUND = -32601
INVALID_PARAMS = -32602
INTERNAL_ERROR = -32603
WITNESS_REJECTED = -32000
SERVICE_OVERLOADED = -32001     # load shed: carries data.retry_after_s
JOB_NOT_DONE = -32002
JOB_NOT_FOUND = -32004
JOB_FAILED = -32005
MANIFEST_UNAVAILABLE = -32006   # terminal job, manifest absent/corrupt
UPDATE_UNAVAILABLE = -32007     # follower has no verified update (yet)


def _error(code, message, id_=None, data=None):
    err = {"code": code, "message": message}
    if data is not None:
        err["data"] = data
    return {"jsonrpc": "2.0", "error": err, "id": id_}


def run_proof_method(state, method: str, params: dict,
                     heartbeat=None) -> dict:
    """Prove one request. This is the job-queue runner: everything here runs
    in a worker thread, and the returned dict is the JSON-RPC `result`
    (JSON-serializable, journal-safe). `heartbeat` (optional zero-arg
    callback) is the worker's stall-detection stamp, invoked between
    prove phases."""
    if method == RPC_METHOD_STEP:
        spec = state.spec
        with phase("job/preprocess"):
            # the committee's pubkeys decompress on the state's device (K6)
            args = step_args_from_finality_update(
                params["light_client_finality_update"],
                params["pubkeys"],
                bytes.fromhex(params["domain"].removeprefix("0x")),
                spec, device=getattr(state, "device", None))
        # verify-before-serve: no proof reaches the journal or the wire
        # without passing the host-side verifier
        proof, instances = verified_prove(state, "step", args,
                                          heartbeat=heartbeat)
        return {
            "proof": "0x" + proof.hex(),
            "instances": [hex(v) for v in instances],
            "calldata": "0x" + encode_calldata(instances, proof).hex(),
        }
    if method == RPC_METHOD_COMMITTEE:
        with phase("job/preprocess"):
            args = rotation_args_from_update(
                params["light_client_update"], state.spec)
        proof, instances = verified_prove(state, "committee", args,
                                          heartbeat=heartbeat)
        # compressed layout: 12 accumulator limbs then app instances,
        # poseidon at [12] (reference: rpc.rs:106 `instances[0][12]`)
        pos_idx = 12 if getattr(state, "compress", False) else 0
        return {
            "proof": "0x" + proof.hex(),
            "instances": [hex(v) for v in instances],
            "calldata": "0x" + encode_calldata(instances, proof).hex(),
            "committee_poseidon": hex(instances[pos_idx]),
        }
    if method == RPC_METHOD_AGG:
        # aggregation cadence: the params carry the stored chain window
        # [start_period, period]. The job re-checks every Poseidon chain
        # link, re-verifies the window tip's compressed proof on this
        # host's keys, and returns the tip's EVM-verifiable artifact as the
        # publishable aggregate.
        with phase("job/aggregate"):
            chain = params["chain"]
            if not chain:
                raise ValueError("empty aggregation window")
            for prev, cur in zip(chain, chain[1:]):
                if int(cur["period"]) != int(prev["period"]) + 1:
                    raise ValueError(
                        f"aggregation window not contiguous at {cur['period']}")
                if cur.get("prev_poseidon") != prev.get("committee_poseidon"):
                    raise ValueError(f"chain link broken at period {cur['period']}")
            if heartbeat is not None:
                heartbeat()
            tip = chain[-1]
            if hasattr(state, "verify_proof"):
                from .selfverify import decode_result
                proof, instances = decode_result(tip)
                if not state.verify_proof("committee", proof, instances):
                    raise ValueError("aggregation window tip proof failed verification")
        return {
            "proof": tip["proof"],
            "instances": list(tip["instances"]),
            "calldata": tip.get("calldata"),
            "committee_poseidon": tip.get("committee_poseidon"),
            "start_period": int(params["start_period"]),
            "period": int(params["period"]),
            "aggregated": len(chain),
        }
    raise ValueError(f"unprovable method {method}")


# error payloads recorded by the job worker map back onto RPC codes when a
# blocking genEvmProof_* (or getProofResult) surfaces the failure; typed
# kinds keep their message, anything unexpected becomes a sanitized
# -32603 (exception class only — internals never leak to the wire). The
# port's chips and preprocessor reject a witness with ValueError where the
# reference asserts; AssertionError stays for journals the reference wrote.
_ERROR_KIND_CODES = {
    "AssertionError": (WITNESS_REJECTED, "witness rejected"),
    "ValueError": (WITNESS_REJECTED, "witness rejected"),
    "KeyError": (INVALID_PARAMS, "missing param"),
    "TimeoutError": (JOB_FAILED, "job failed"),
    "StalledWorker": (JOB_FAILED, "job failed"),
    "ArtifactCorrupt": (JOB_FAILED, "result artifact corrupt"),
    "ProofVerifyFailed": (JOB_FAILED, "proof failed self-verification"),
    "DeviceProveFailed": (JOB_FAILED, "job failed"),
}


def _job_error(job, id_):
    err = job.error or {"kind": "Unknown", "message": "job failed"}
    kind = err.get("kind")
    if kind in _ERROR_KIND_CODES:
        code, label = _ERROR_KIND_CODES[kind]
        return _error(code, f"{label}: {err.get('message', '')}", id_)
    HEALTH.incr("rpc_internal_errors")
    return _error(INTERNAL_ERROR, f"internal error ({kind})", id_)


def _handler(state: ProverState, jobs, follower=None, dispatcher=None,
             replica_id=None, gateway=None):
    """A request handler class bound to one state, its queue and the farm,
    follower and gateway it serves (each serve() gets its own, so servers
    in one process stay apart)."""
    return type("Handler", (_Handler,), {
        "state": state, "jobs": jobs, "follower": follower,
        "dispatcher": dispatcher, "replica_id": replica_id,
        "gateway": gateway})


class _Handler(BaseHTTPRequestHandler):
    state: ProverState = None  # bound by _handler()
    jobs = None
    follower = None            # the light-client follower daemon, if any
    dispatcher = None          # the proof-farm dispatcher, if any
    replica_id = None          # this server's id within a farm
    gateway = None             # the cacheable GET /v1/* read plane, if any

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _reply(self, resp: dict, status: int = 200, headers: dict = None):
        # every RPC error names the serving replica, so a client retrying
        # across endpoints can say which box failed (rpc_client surfaces
        # it as RpcError.replica_id)
        if self.replica_id is not None and isinstance(resp, dict) \
                and isinstance(resp.get("error"), dict):
            resp["error"].setdefault("data", {})
            if isinstance(resp["error"]["data"], dict):
                resp["error"]["data"].setdefault("replica_id", self.replica_id)
        body = json.dumps(resp).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path.startswith("/v1/"):
            # the gateway's read plane: content-addressed ETags,
            # If-None-Match -> 304, immutable cache headers on sealed
            # periods, so a stock CDN in front absorbs the fan-out
            if self.gateway is None:
                self.send_error(404, "gateway not mounted (serve with "
                                     "gateway=)")
                return
            status, headers, body = self.gateway.handle_http(self.path, self.headers)
            self.send_response(status)
            for k, v in headers.items():
                self.send_header(k, v)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            if body:
                self.wfile.write(body)
            return
        if self.path == "/metrics":
            # Prometheus scrape: text exposition 0.0.4 with exact counter
            # parity against /healthz (both read the same HEALTH.snapshot())
            from ..observability import prom
            body = prom.render(jobs=self.jobs).encode()
            self.send_response(200)
            self.send_header("Content-Type", prom.CONTENT_TYPE)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if self.path not in ("/healthz", "/health"):
            self.send_error(404)
            return
        from ..preprocessor.beacon import breaker_snapshot
        snap = HEALTH.snapshot()
        snap["jobs"] = self.jobs.stats() if self.jobs is not None else {}
        breakers = breaker_snapshot()
        snap["beacon_breakers"] = breakers
        # readiness: an open beacon circuit breaker means the upstream is
        # considered down — report 503 so orchestrators stop routing, with
        # the counters in the body for the operator (half-open admits a
        # trial request, so it is ready). A failing prove+verify
        # self-check gates readiness the same way: a box that cannot prove
        # correctly never reports ok.
        sc = getattr(self.state, "self_check", None)
        if sc is not None:
            snap["self_check"] = sc.snapshot()
        if self.dispatcher is not None:
            snap["dispatcher"] = self.dispatcher.snapshot()
        if any(b["state"] == "open" for b in breakers) \
                or (sc is not None and not snap["self_check"]["ok"]):
            snap["status"] = "degraded"
            self._reply(snap, status=503)
            return
        snap["status"] = "ok"
        self._reply(snap)

    def do_POST(self):
        if self.path not in ("/rpc", "/"):
            self.send_error(404)
            return
        # failure domain 1: transport + JSON parsing -> -32700
        try:
            length = int(self.headers.get("Content-Length", "0"))
            raw = self.rfile.read(length)
            req = json.loads(raw)
        except Exception as exc:
            self._reply(_error(PARSE_ERROR, f"parse error: {exc}"))
            return
        # failure domain 2: JSON-RPC envelope validation -> -32600
        if not isinstance(req, dict) or req.get("jsonrpc") != "2.0" \
                or not isinstance(req.get("method"), str):
            self._reply(_error(INVALID_REQUEST,
                               "invalid request: expected a JSON-RPC 2.0 "
                               "object with jsonrpc='2.0' and a method"))
            return
        # failure domain 3: dispatch — typed app errors keep their codes,
        # anything unexpected is a sanitized -32603 internal error
        id_ = req.get("id")
        try:
            resp = self._dispatch(req)
        except ServiceOverloaded as exc:
            # load shed: -32001 on the RPC envelope, 429 +
            # Retry-After on the transport — well-behaved clients back
            # off by retry_after_s instead of hammering a drowning box
            resp = _error(SERVICE_OVERLOADED,
                          f"service overloaded: {exc}", id_,
                          data={"retry_after_s": exc.retry_after_s})
            self._reply(resp, status=429,
                        headers={"Retry-After":
                                 str(max(1, int(exc.retry_after_s + 0.5)))})
            return
        except (ValueError, AssertionError) as exc:
            resp = _error(WITNESS_REJECTED, f"witness rejected: {exc}", id_)
        except KeyError as exc:
            resp = _error(INVALID_PARAMS, f"missing param: {exc}", id_)
        except Exception as exc:
            HEALTH.incr("rpc_internal_errors")
            resp = _error(INTERNAL_ERROR,
                          f"internal error ({type(exc).__name__})", id_)
        self._reply(resp)

    def _dispatch(self, req: dict) -> dict:
        id_ = req.get("id")
        method = req["method"]
        params = req.get("params") or {}
        if method in (RPC_METHOD_STEP, RPC_METHOD_COMMITTEE,
                      RPC_METHOD_AGG):
            # blocking reference semantics, implemented over the queue:
            # submit (dedup'd + journaled) then wait for the terminal state
            jid = self.jobs.submit(method, params)
            job = self.jobs.wait(jid)
            if job.status == "done":
                return {"jsonrpc": "2.0", "result": job.result, "id": id_}
            if job.status == "cancelled":
                return _error(JOB_FAILED, "job cancelled", id_)
            return _job_error(job, id_)
        if method in (RPC_METHOD_STEP_SUBMIT, RPC_METHOD_COMMITTEE_SUBMIT,
                      RPC_METHOD_AGG_SUBMIT):
            blocking = {RPC_METHOD_STEP_SUBMIT: RPC_METHOD_STEP,
                        RPC_METHOD_COMMITTEE_SUBMIT: RPC_METHOD_COMMITTEE,
                        RPC_METHOD_AGG_SUBMIT: RPC_METHOD_AGG}
            timeout = params.pop("timeout", None)
            # deadline propagation: the client's own deadline clamps the
            # per-job timeout — no worker burns on an unread result
            deadline_s = params.pop("deadline_s", None)
            jid = self.jobs.submit(blocking[method], params, timeout=timeout,
                                   deadline_s=deadline_s)
            st = self.jobs.status(jid)
            result = {"job_id": jid, "status": st["status"]}
        elif method == "getProofStatus":
            st = self.jobs.status(params["job_id"])
            if st is None:
                return _error(JOB_NOT_FOUND,
                              f"unknown job {params['job_id']}", id_)
            result = st
        elif method == "getProofResult":
            job = self.jobs.result(params["job_id"])
            if job is None:
                return _error(JOB_NOT_FOUND,
                              f"unknown job {params['job_id']}", id_)
            if job.status in ("queued", "running"):
                return _error(JOB_NOT_DONE,
                              f"job {job.id} is {job.status}", id_)
            if job.status != "done":
                return _job_error(job, id_)
            result = job.result
        elif method == "getProofManifest":
            jid = params["job_id"]
            job = self.jobs.result(jid)
            if job is None:
                return _error(JOB_NOT_FOUND, f"unknown job {jid}", id_)
            if job.status in ("queued", "running"):
                return _error(JOB_NOT_DONE,
                              f"job {jid} is {job.status}; no manifest "
                              f"yet", id_)
            man = self.jobs.manifest(jid)
            if man is None:
                # manifests degrade to absent (crashed worker, tolerated
                # write failure, quarantined corruption) — the result
                # itself is unaffected and still served
                return _error(MANIFEST_UNAVAILABLE,
                              f"manifest for job {jid} unavailable "
                              f"(never written, or failed verification)",
                              id_)
            result = man
        elif method == "cancelProof":
            result = {"cancelled": self.jobs.cancel(params["job_id"])}
        elif method == "getTrace":
            # per-job span tree as Chrome trace-event JSON; trace id = job id, retained for the last
            # SPECTRE_TRACE_KEEP completed jobs
            from ..observability import tracing
            jid = params["job_id"]
            tr = tracing.get_trace(jid)
            if tr is None:
                st = self.jobs.status(jid) if self.jobs else None
                if st is None:
                    return _error(JOB_NOT_FOUND, f"unknown job {jid}", id_)
                if st["status"] in ("queued", "running"):
                    return _error(JOB_NOT_DONE,
                                  f"job {jid} is {st['status']}; no trace "
                                  f"yet", id_)
                return _error(JOB_NOT_FOUND,
                              f"trace for job {jid} expired from the "
                              f"retention ring", id_)
            result = tracing.chrome_trace(tr)
        elif method in ("getLightClientUpdate", "getUpdateRange",
                        "followerStatus"):
            # the follower's serving path: pre-proved updates out of the
            # verified update store — one content-verified artifact read,
            # never a prover-semaphore acquisition or a device touch
            fol = self.follower
            if fol is None:
                return _error(METHOD_NOT_FOUND,
                              "follower not running (start with "
                              "`python -m spectre_tpu_torch.prover_service "
                              "follow`)", id_)
            if method == "followerStatus":
                result = fol.snapshot()
            elif method == "getUpdateRange":
                count = min(int(params.get("count", 1)), 128)
                updates, missing = fol.store.range_committee(
                    int(params["start_period"]), count)
                result = {"updates": updates, "missing": missing}
            else:
                if "period" in params:
                    rec = fol.store.get_committee(int(params["period"]))
                    what = f"period {params['period']}"
                elif "slot" in params:
                    rec = fol.store.get_step(int(params["slot"]))
                    what = f"slot {params['slot']}"
                else:
                    raise KeyError("period")
                if rec is None:
                    return _error(UPDATE_UNAVAILABLE,
                                  f"no verified update for {what} "
                                  f"(not yet proved, or invalidated and "
                                  f"re-proving)", id_)
                result = rec
        elif method == "scrubNow":
            # one synchronous artifact-scrubber pass: re-hash every
            # results/ file, quarantine rot, expire orphans
            result = self.jobs.scrub_now()
        elif method == "health":
            from ..preprocessor.beacon import breaker_snapshot
            result = HEALTH.snapshot()
            result["jobs"] = self.jobs.stats() if self.jobs else {}
            result["beacon_breakers"] = breaker_snapshot()
            sc = getattr(self.state, "self_check", None)
            if sc is not None:
                result["self_check"] = sc.snapshot()
            if self.dispatcher is not None:
                result["dispatcher"] = self.dispatcher.snapshot()
        elif method == "registerReplica":
            # farm membership: replicas announce themselves (and
            # heartbeat) here; the dispatcher journals joins and
            # TTL-expires the silent
            if self.dispatcher is None:
                return _error(METHOD_NOT_FOUND,
                              "not a dispatcher head (serve with a "
                              "Dispatcher to accept replica announces)", id_)
            result = self.dispatcher.register_remote(
                params["replica_id"], url=params.get("url"),
                capabilities=params.get("capabilities"))
        elif method == "ping":
            result = "pong"
        else:
            return _error(METHOD_NOT_FOUND, f"unknown method {method}", id_)
        return {"jsonrpc": "2.0", "result": result, "id": id_}


def _announce_loop(stop: threading.Event, head_url: str, payload: dict,
                   interval: float):
    """Replica-side membership announce: POST ``registerReplica`` to the
    dispatcher head — once immediately, then every `interval` seconds as the
    liveness heartbeat. Failures are tolerated and counted
    (``replica_announce_failures``); only a TTL of silence deregisters the
    replica, and the next successful announce re-joins it."""
    from ..utils import faults
    from .rpc_client import ProverClient
    client = ProverClient(head_url, timeout=10.0)
    while True:
        try:
            faults.check("replica.announce")
            client._call("registerReplica", payload, timeout=10.0)
            HEALTH.incr("replica_announces")
        except Exception:
            HEALTH.incr("replica_announce_failures")
        if stop.wait(interval):
            return


def serve(state: ProverState, host: str = "127.0.0.1", port: int = 3000,
          background: bool = False, journal_dir: str | None = None,
          job_timeout: float | None = None, follower=None, dispatcher=None,
          replica_id: str | None = None, gateway=None, announce=None,
          announce_interval: float | None = None,
          advertise_url: str | None = None, capabilities=None, **queue_kw):
    """`journal_dir` defaults to the state's params_dir (when set) — pass
    explicitly to place the crash-safe job journal elsewhere; `job_timeout`
    is the default per-job deadline for async submissions. `follower`
    (optional) serves getLightClientUpdate / getUpdateRange /
    followerStatus. `dispatcher` (optional) replaces the local-state queue
    runner with a proof-farm Dispatcher: the queue, dedup and journal are
    unchanged, only where proofs run moves. `replica_id` (default
    $SPECTRE_REPLICA_ID) names this server in a farm and is stamped into
    every RPC error's data. `gateway` mounts the cacheable GET /v1/* read
    plane: a Gateway, or True to build one over `follower`'s store.
    `announce` (default $SPECTRE_ANNOUNCE_URL) is a dispatcher head's URL
    this server announces itself to every `announce_interval` seconds
    ($SPECTRE_ANNOUNCE_INTERVAL_S), with its `capabilities` record
    (default: dispatcher.capability_record of the state) and
    `advertise_url` (default http://`host`:`port`, the bound port when
    port=0). Extra `queue_kw` (queue_depth, mem_watermark_mb,
    stall_timeout, scrub_interval, ...) reach the JobQueue's
    admission/supervision layer. With background=True the server runs in
    a daemon thread and is returned (stop it with `.shutdown()`,
    `._announce_stop.set()` when it announces, and `state.jobs.stop()`)."""
    jobs = ensure_jobs(state, journal_dir=journal_dir, default_timeout=job_timeout,
                       runner=dispatcher, **queue_kw)
    if replica_id is None:
        replica_id = os.environ.get("SPECTRE_REPLICA_ID") or None
    if gateway is True:
        if follower is None:
            raise ValueError("gateway=True requires a follower (the "
                             "gateway serves its update store)")
        from ..gateway import Gateway
        gateway = Gateway(follower.store)
    if gateway is not None and jobs is not None:
        # packs must survive the scrubber's orphan expiry as stored
        # updates do
        jobs.add_live_provider(gateway.live_artifacts)
    server = ThreadingHTTPServer((host, port), _handler(
        state, jobs, follower=follower, dispatcher=dispatcher,
        replica_id=replica_id, gateway=gateway))
    if announce is None:
        announce = os.environ.get("SPECTRE_ANNOUNCE_URL") or None
    if announce:
        from .dispatcher import ANNOUNCE_DEFAULT_S, ANNOUNCE_ENV, capability_record
        if announce_interval is None:
            try:
                announce_interval = float(os.environ.get(ANNOUNCE_ENV, ANNOUNCE_DEFAULT_S))
            except ValueError:
                announce_interval = ANNOUNCE_DEFAULT_S
        bound_port = server.server_address[1]
        own_url = advertise_url or f"http://{host}:{bound_port}"
        rid = replica_id or f"replica-{host}:{bound_port}"
        caps = capabilities if capabilities is not None \
            else capability_record(state, url=own_url)
        stop = threading.Event()
        threading.Thread(
            target=_announce_loop,
            args=(stop, announce, {"replica_id": rid, "url": own_url,
                                   "capabilities": caps}, announce_interval),
            daemon=True, name="spectre-announce").start()
        server._announce_stop = stop    # shutdown hook
    if background:
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        return server
    server.serve_forever()
