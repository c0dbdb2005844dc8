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
* The follower's methods (`getLightClientUpdate`, `getUpdateRange`,
  `followerStatus`) answer `-32601`, as the reference's server does when
  no follower is attached: the port has no follower yet.
"""

from __future__ import annotations

import json
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


def _handler(state: ProverState, jobs):
    """A request handler class bound to one state and its queue (each
    serve() gets its own, so servers in one process stay apart)."""
    return type("Handler", (_Handler,), {"state": state, "jobs": jobs})


class _Handler(BaseHTTPRequestHandler):
    state: ProverState = None  # bound by _handler()
    jobs = None

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _reply(self, resp: dict, status: int = 200, headers: dict = None):
        body = json.dumps(resp).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
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
            # the follower's serving methods: the port has no follower yet
            return _error(METHOD_NOT_FOUND,
                          "follower not running (the port serves no "
                          "follower yet)", id_)
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
        elif method == "ping":
            result = "pong"
        else:
            return _error(METHOD_NOT_FOUND, f"unknown method {method}", id_)
        return {"jsonrpc": "2.0", "result": result, "id": id_}


def serve(state: ProverState, host: str = "127.0.0.1", port: int = 3000,
          background: bool = False, journal_dir: str | None = None,
          job_timeout: float | None = None, **queue_kw):
    """`journal_dir` defaults to the state's params_dir (when set) — pass
    explicitly to place the crash-safe job journal elsewhere; `job_timeout`
    is the default per-job deadline for async submissions. Extra
    `queue_kw` (queue_depth, mem_watermark_mb, stall_timeout,
    scrub_interval, ...) reach the JobQueue's admission/supervision layer.
    With background=True the server runs in a daemon thread and is
    returned (stop it with `.shutdown()` and `state.jobs.stop()`)."""
    jobs = ensure_jobs(state, journal_dir=journal_dir, default_timeout=job_timeout,
                       **queue_kw)
    server = ThreadingHTTPServer((host, port), _handler(state, jobs))
    if background:
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        return server
    server.serve_forever()
