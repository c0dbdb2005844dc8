"""Kernel-build and launch telemetry: the port's counterpart of the
reference's jit-compile listener (`spectre_tpu/observability/compilelog.py`).

The reference listens to `jax.monitoring`'s compile events: XLA compiles
per traced shape, and a cache miss shows as compile seconds inside a
prove. Nothing in the port compiles per call. What it builds is its kernel
libraries, by `nvcc` (and the host C++ compiler) at first use
(`ops/kernel_lib.build_all`, `host_library`), and what it runs is counted
per kernel (`kernel_lib.KERNELS[...].launches`). `install()` registers one
build observer that fans each build into three sinks:

  1. `spectre_kernel_build_seconds{fn=}` (metrics.KERNEL_BUILD_SECONDS): fn
     is the innermost open `entry_point(...)`, else the innermost tracing
     span (`boot/step_pk`, `prove/...`), else "unattributed";
  2. a completed `build/<library>` child span in the active trace;
  3. the thread-local `capture(...)` collector that the JobQueue worker
     opens around the runner: the job's provenance manifest shows its
     builds (0 for a prove after boot) and its kernel launches.

Launches are attributed per entry point too: `entry_point(name)` adds the
launches made inside it (innermost wins) to `launches_by_entry()`. The
launch counters are process-wide, so a capture or an entry point sees every
thread's launches: exact for the service's one worker (concurrency 1), an
upper bound beside other proves.

The module reads the counters through `sys.modules`: a scrape or a manifest
never imports the kernel library itself.
"""

from __future__ import annotations

import contextlib
import sys
import threading

from . import metrics, tracing

KERNEL_LIB = "spectre_tpu_torch.ops.kernel_lib"
BUILD = "build"
LAUNCHES = "launches"
UNATTRIBUTED = "unattributed"

_LOCK = threading.Lock()
_installed = False
_by_entry: dict = {}


class _Local(threading.local):
    def __init__(self):
        self.events: list | None = None
        # innermost-wins stack of [name, counts at entry, nested launches]
        self.entry_points: list = []


_local = _Local()


def launch_counts() -> dict:
    """{kernel: launches} of the process (empty when the kernel library
    is not loaded)."""
    kl = sys.modules.get(KERNEL_LIB)
    return kl.launch_counts() if kl is not None else {}


def _delta(before: dict, after: dict) -> dict:
    """Launches between two snapshots; a counter reset in between reads
    as 0, never negative."""
    return {k: max(0, v - before.get(k, 0)) for k, v in after.items()}


@contextlib.contextmanager
def entry_point(name: str):
    """Attribute kernel builds and launches made inside this block to
    `name`. Nested entry points win innermost-first: an outer entry point
    keeps only the launches its inner ones did not take."""
    frame = [name, launch_counts(), {}]
    stack = _local.entry_points
    stack.append(frame)
    try:
        yield
    finally:
        stack.pop()
        total = _delta(frame[1], launch_counts())
        own = {k: v - frame[2].get(k, 0) for k, v in total.items()}
        with _LOCK:
            acc = _by_entry.setdefault(name, {})
            for k, v in own.items():
                if v:
                    acc[k] = acc.get(k, 0) + v
        if stack:
            nested = stack[-1][2]
            for k, v in total.items():
                nested[k] = nested.get(k, 0) + v


def current_entry_point() -> str | None:
    st = _local.entry_points
    return st[-1][0] if st else None


def launches_by_entry() -> dict:
    """{entry point: {kernel: launches}} since the process started (or the
    last reset_for_tests)."""
    with _LOCK:
        return {name: dict(counts) for name, counts in _by_entry.items()}


def _attribution() -> str:
    return current_entry_point() or tracing.current_span_name() or UNATTRIBUTED


def _on_build(library: str, seconds: float):
    # runs on the building thread, so the trace and collector of the job
    # that triggered the build are the active ones
    fn = _attribution()
    secs = round(float(seconds), 6)
    metrics.KERNEL_BUILD_SECONDS.labels(fn=fn).observe(secs)
    tracing.add_completed_span(f"build/{library}", seconds, fn=fn)
    sink = _local.events
    if sink is not None:
        sink.append({"event": BUILD, "library": library, "fn": fn, "seconds": secs})


def install() -> None:
    """Register the build observer with the kernel library (idempotent)."""
    global _installed
    with _LOCK:
        if not _installed:
            from ..ops import kernel_lib
            kernel_lib.BUILD_OBSERVERS.append(_on_build)
            _installed = True


@contextlib.contextmanager
def capture(into: list | None = None):
    """Collect this thread's kernel builds into `into` (or a fresh list)
    for the duration of the block, and at its end one `launches` event with
    the kernels launched meanwhile; yields the list. Nested captures shadow
    the outer one (one job, one manifest)."""
    sink = into if into is not None else []
    prev = _local.events
    _local.events = sink
    before = launch_counts()
    try:
        yield sink
    finally:
        _local.events = prev
        sink.append({"event": LAUNCHES, "counts": _delta(before, launch_counts())})


def summarize(events) -> dict:
    """Manifest-shape summary of captured events: `builds`/`seconds` count
    the kernel libraries built (0 on a prove after boot: every kernel it
    ran was built before it), `by_fn` the same seconds by triggering entry
    point or phase, `launches` the kernels launched, `events` the builds."""
    builds = [e for e in events if e["event"] == BUILD]
    by_fn: dict = {}
    for e in builds:
        slot = by_fn.setdefault(e["fn"], {"count": 0, "seconds": 0.0})
        slot["count"] += 1
        slot["seconds"] = round(slot["seconds"] + e["seconds"], 6)
    launches: dict = {}
    for e in events:
        if e["event"] == LAUNCHES:
            for k, v in e["counts"].items():
                launches[k] = launches.get(k, 0) + v
    return {
        "builds": len(builds),
        "seconds": round(sum(e["seconds"] for e in builds), 6),
        "by_fn": {k: by_fn[k] for k in sorted(by_fn)},
        "launches": {k: launches[k] for k in sorted(launches) if launches[k]},
        "events": builds,
    }


def reset_for_tests():
    """Forget the per-entry launch totals (the observer stays installed)."""
    with _LOCK:
        _by_entry.clear()
