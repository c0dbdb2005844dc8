"""Per-job span trees, exportable as Chrome trace-event JSON (the port's
copy of `spectre_tpu/observability/tracing.py`).

`utils/profiling.phase(...)` is span-aware: while a trace is active on
the current thread, every `phase` becomes a child span of the enclosing
one, so the existing instrumentation in `plonk/prover.py`,
`ProverState.prove_*` and `run_proof_method` yields a full tree per job
with ZERO changes at the call sites. The JobQueue worker opens the
trace (`trace(job_id)`) around the runner call; prove runs on that
worker thread, so propagation is implicit (thread-local).

Finished traces land in a bounded in-memory ring (SPECTRE_TRACE_KEEP,
default 128) served by the `getTrace` RPC, and — when SPECTRE_TRACE_DIR
is set — in `<dir>/<trace_id>.trace.json` files in Chrome trace-event
format (load via chrome://tracing or https://ui.perfetto.dev). The file
sink is best-effort: a full disk never fails a prove.

No trace active => `span(...)` is a no-op; the tracer costs nothing on
untraced paths (a thread-local read and a None check).
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time

TRACE_DIR_ENV = "SPECTRE_TRACE_DIR"          # file sink (off when unset)
TRACE_KEEP_ENV = "SPECTRE_TRACE_KEEP"        # in-memory ring size
TRACE_KEEP_DEFAULT = 128


class Span:
    __slots__ = ("name", "t0", "t1", "children", "meta")

    def __init__(self, name: str, t0: float):
        self.name = name
        self.t0 = t0                 # perf_counter timestamps
        self.t1: float | None = None
        self.children: list[Span] = []
        self.meta: dict = {}

    def seconds(self) -> float | None:
        return None if self.t1 is None else self.t1 - self.t0


class Trace:
    """One span tree; trace id = job id (or a bench run label)."""

    def __init__(self, trace_id: str):
        self.trace_id = trace_id
        self.started_at = time.time()         # wall anchor for export
        self.perf0 = time.perf_counter()
        self.root = Span("job", self.perf0)
        self.finished_at: float | None = None

    def finish(self):
        if self.root.t1 is None:
            self.root.t1 = time.perf_counter()
        self.finished_at = time.time()


class _Local(threading.local):
    def __init__(self):
        self.trace: Trace | None = None
        self.stack: list[Span] = []


_local = _Local()
_LOCK = threading.Lock()
# finished traces, oldest-first (OrderedDict as a bounded ring)
_RECENT: "collections.OrderedDict[str, Trace]" = collections.OrderedDict()


def _keep() -> int:
    try:
        return max(1, int(os.environ.get(TRACE_KEEP_ENV,
                                         TRACE_KEEP_DEFAULT)))
    except ValueError:
        return TRACE_KEEP_DEFAULT


@contextlib.contextmanager
def trace(trace_id: str):
    """Open a trace on the current thread; on exit it is finished,
    registered for `getTrace`, and (optionally) written to the file
    sink. Nesting restores the previous trace (bench wraps sub-runs)."""
    prev_trace, prev_stack = _local.trace, _local.stack
    tr = Trace(trace_id)
    _local.trace, _local.stack = tr, [tr.root]
    try:
        yield tr
    finally:
        _local.trace, _local.stack = prev_trace, prev_stack
        tr.finish()
        _register(tr)
        _file_sink(tr)


def active() -> Trace | None:
    return _local.trace


@contextlib.contextmanager
def span(name: str):
    """Child span of the innermost open span; no-op without a trace."""
    tr = _local.trace
    if tr is None:
        yield None
        return
    s = Span(name, time.perf_counter())
    _local.stack[-1].children.append(s)
    _local.stack.append(s)
    try:
        yield s
    finally:
        s.t1 = time.perf_counter()
        if _local.stack and _local.stack[-1] is s:
            _local.stack.pop()


def current_span_name() -> str | None:
    """Name of the innermost open span on this thread, or None when no
    trace is active. The compile-telemetry listener uses this to label
    `spectre_compile_seconds{fn=}` with the phase that triggered the
    compile (e.g. `prove/commit_advice`)."""
    tr = _local.trace
    if tr is None or not _local.stack:
        return None
    return _local.stack[-1].name


def add_completed_span(name: str, seconds: float, **meta):
    """Append an already-finished child span (ending now) under the
    innermost open span; no-op without a trace. This is how events timed
    elsewhere — XLA compile durations reported by `jax.monitoring` —
    land in the tree as `compile/*` children of the phase that was open
    while they ran."""
    tr = _local.trace
    if tr is None or not _local.stack:
        return None
    t1 = time.perf_counter()
    s = Span(name, t1 - max(0.0, float(seconds)))
    s.t1 = t1
    if meta:
        s.meta.update(meta)
    _local.stack[-1].children.append(s)
    return s


def annotate(**kw):
    """Attach key/values to the innermost open span (exported as Chrome
    `args`) — e.g. the CPU-fallback path stamps its oom/compile kind."""
    tr = _local.trace
    if tr is not None and _local.stack:
        _local.stack[-1].meta.update(kw)


def get_trace(trace_id: str) -> Trace | None:
    with _LOCK:
        return _RECENT.get(trace_id)


def _register(tr: Trace):
    with _LOCK:
        _RECENT[tr.trace_id] = tr          # re-prove overwrites: last wins
        _RECENT.move_to_end(tr.trace_id)
        keep = _keep()
        while len(_RECENT) > keep:
            _RECENT.popitem(last=False)


def _file_sink(tr: Trace):
    d = os.environ.get(TRACE_DIR_ENV)
    if not d:
        return
    try:
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"{tr.trace_id}.trace.json")
        with open(path, "w") as f:
            json.dump(chrome_trace(tr), f)
    except OSError:
        pass                               # the sink never fails a prove


def chrome_trace(tr: Trace) -> dict:
    """Chrome trace-event JSON (the `traceEvents` object form): one "X"
    (complete) event per span, timestamps in microseconds anchored to
    the trace's wall-clock start."""
    pid = os.getpid()
    events = []

    def emit(s: Span):
        t1 = s.t1 if s.t1 is not None else s.t0
        events.append({
            "name": s.name, "ph": "X", "cat": "prove",
            "ts": round((tr.started_at + (s.t0 - tr.perf0)) * 1e6, 3),
            "dur": round((t1 - s.t0) * 1e6, 3),
            "pid": pid, "tid": 0,
            **({"args": dict(s.meta)} if s.meta else {}),
        })
        for c in s.children:
            emit(c)

    emit(tr.root)
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"trace_id": tr.trace_id}}


def phase_seconds(tr: Trace) -> dict[str, float]:
    """Total seconds per span name (root excluded) — the shared schema
    between production traces and bench.py's `phase_seconds` key."""
    out: dict[str, float] = {}

    def walk(s: Span):
        for c in s.children:
            if c.t1 is not None:
                out[c.name] = out.get(c.name, 0.0) + (c.t1 - c.t0)
            walk(c)

    walk(tr.root)
    return {k: round(v, 6) for k, v in sorted(out.items())}


def reset():
    """Test hook: drop all retained traces."""
    with _LOCK:
        _RECENT.clear()
