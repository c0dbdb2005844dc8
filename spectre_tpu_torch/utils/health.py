"""ServiceHealth: thread-safe degradation/retry counters (the port's copy
of `spectre_tpu/utils/health.py`).

Every graceful-degradation path in the service (beacon retry/backoff,
circuit-breaker transitions, device-prove CPU fallback, fixed-base MSM
table-budget degrade, job-queue dedup/requeue, proof-farm dispatch:
`dispatcher_*` lease takeovers/breaker skips/SDC reroutes and
`beacon_quorum_*` dissent counting) increments a named counter here
instead of logging and forgetting. The prover service surfaces the
snapshot via the `health` RPC method and GET /healthz, and every counter
exports as `spectre_<name>_total` in /metrics — new counters need zero
exporter changes.

Dependency-free on purpose: ops/ kernels and the preprocessor increment
counters without pulling in the service layer.
"""

from __future__ import annotations

import threading
import time


class ServiceHealth:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, int] = {}
        self._gauges: dict[str, tuple[int, float]] = {}  # name -> (n, sum)
        self._started = time.time()

    def incr(self, name: str, n: int = 1) -> int:
        with self._lock:
            v = self._counters.get(name, 0) + n
            self._counters[name] = v
            return v

    def get(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def observe(self, name: str, value: float):
        """Record a sample for a running-mean gauge (e.g. prove latency —
        the admission controller derives retry_after_s from its mean)."""
        with self._lock:
            n, total = self._gauges.get(name, (0, 0.0))
            self._gauges[name] = (n + 1, total + float(value))

    def mean(self, name: str, default: float = 0.0) -> float:
        with self._lock:
            n, total = self._gauges.get(name, (0, 0.0))
            return total / n if n else default

    def snapshot(self) -> dict:
        with self._lock:
            snap = {"uptime_s": round(time.time() - self._started, 3),
                    "counters": dict(sorted(self._counters.items()))}
            if self._gauges:
                snap["means"] = {k: round(total / n, 6)
                                 for k, (n, total)
                                 in sorted(self._gauges.items()) if n}
            return snap

    def reset(self):
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._started = time.time()


# process-global default: the service, the beacon client and the MSM
# degrade path all meet on this instance unless a caller injects its own
HEALTH = ServiceHealth()
