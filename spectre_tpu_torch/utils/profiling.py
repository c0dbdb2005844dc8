"""Phase timers + structured logging for the prover pipeline (the port's
copy of `spectre_tpu/utils/profiling.py`).

Reference parity (SURVEY.md §5): ark-std `start_timer!/end_timer!` under the
`print-trace` feature + `RUST_LOG` env filtering. Here: `phase(...)` context
managers emit wall-clock per prover phase when SPECTRE_TRACE=1 (or via
logging at DEBUG), and a process-wide registry accumulates totals so services
can expose them (the JSON-RPC server reports them under `ping`-style
diagnostics).

Observability integration: every `phase` additionally

* becomes a child span of the active per-job trace
  (observability/tracing — no trace active => a no-op), so the existing
  call sites in plonk/prover.py yield full span trees for `getTrace`;
* feeds the `spectre_phase_seconds{phase=...}` histogram
  (observability/metrics).

The SPECTRE_METRICS JSONL sink is IO-error tolerant (a full disk or
revoked fd must never fail a prove — pinned via fault site
`metrics.write` in `make test-faults`); failures count on
ServiceHealth as `metrics_write_failures`.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from collections import defaultdict

from ..observability import metrics as _obs_metrics
from ..observability import tracing as _obs_tracing
from . import faults

log = logging.getLogger("spectre_tpu_torch")

_TOTALS: dict[str, float] = defaultdict(float)
_COUNTS: dict[str, int] = defaultdict(int)


def trace_enabled() -> bool:
    return os.environ.get("SPECTRE_TRACE", "") not in ("", "0")


def _metrics_path() -> str | None:
    return os.environ.get("SPECTRE_METRICS") or None


@contextlib.contextmanager
def phase(name: str):
    """Time a prover phase; nestable. SPECTRE_METRICS=<path> additionally
    appends one JSON line per phase ({"phase", "seconds", "ts"}) — the
    structured-metrics sink services/CI can scrape."""
    t0 = time.perf_counter()
    try:
        with _obs_tracing.span(name):
            yield
    finally:
        dt = time.perf_counter() - t0
        _TOTALS[name] += dt
        _COUNTS[name] += 1
        _obs_metrics.PHASE_SECONDS.labels(phase=name).observe(dt)
        if trace_enabled():
            print(f"[trace] {name}: {dt * 1000:.1f} ms", flush=True)
        mp = _metrics_path()
        if mp:
            try:
                faults.check("metrics.write")
                with open(mp, "a") as f:
                    f.write(json.dumps({"phase": name,
                                        "seconds": round(dt, 6),
                                        "ts": round(time.time(), 3)}) + "\n")
            except OSError:   # metrics must never break proving
                from .health import HEALTH
                HEALTH.incr("metrics_write_failures")
        log.debug("phase %s: %.1f ms", name, dt * 1000)


def totals() -> dict:
    return {k: {"seconds": round(v, 4), "count": _COUNTS[k]}
            for k, v in sorted(_TOTALS.items())}


def reset():
    _TOTALS.clear()
    _COUNTS.clear()
