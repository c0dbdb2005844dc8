"""Metric primitives: counters, gauges, fixed-bucket histograms (the port's
copy of `spectre_tpu/observability/metrics.py`), and the series the port
feeds: PHASE_SECONDS (`utils/profiling.phase`), PROVE_LATENCY and
QUEUE_WAIT (the job queue's worker), KERNEL_BUILD_SECONDS
(`observability/compilelog`, from the kernel builds of `ops/kernel_lib`).

ServiceHealth (utils/health.py) stays the single source of truth for
degradation counters. What lives here is the machinery it lacks:
*distributions* — the per-phase decomposition central to the
hardware-acceleration literature (zkSpeed/SZKP, PAPERS.md) needs latency
histograms per prover phase, not one running mean.

Buckets are fixed at construction (cumulative `le` semantics, implicit
+Inf overflow bucket) so exposition is allocation-free and quantile
estimation is a single cumulative scan. Everything is thread-safe.

Dependency-free on purpose (stdlib only): utils/profiling.py feeds
PHASE_SECONDS from inside `phase(...)`, which runs inside ops/ kernels
— no service-layer imports may sneak in here.
"""

from __future__ import annotations

import bisect
import threading

# default buckets: sub-second tiny-spec CPU proves up to multi-minute
# production compressed proofs
LATENCY_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
                   60.0, 120.0, 300.0, 600.0, 1800.0)

# queue wait (admission -> worker start): near-zero on an idle box, up
# to the admission controller's 600s retry_after cap (and beyond, when
# a replayed journal re-queues jobs across an outage)
QUEUE_WAIT_BUCKETS = (0.001, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
                      30.0, 60.0, 300.0, 600.0, 1800.0)

# kernel builds: a host C++ library in seconds, an nvcc library that
# includes nothing of PyTorch's in seconds to a minute
BUILD_BUCKETS = (0.1, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0)

# per-phase wall clock: phases span ~ms (transcript hashing) to minutes
# (quotient on a large k)
PHASE_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                 5.0, 10.0, 30.0, 60.0, 300.0)


class Counter:
    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.labels: dict[str, str] = {}
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1):
        with self._lock:
            self._value += n

    def value(self) -> int:
        with self._lock:
            return self._value

    def reset(self):
        with self._lock:
            self._value = 0


class Gauge:
    """Point-in-time value; `fn` makes it a pull gauge evaluated at
    scrape time (queue depth, RSS — values nobody should have to push)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "", fn=None):
        self.name = name
        self.help = help
        self.labels: dict[str, str] = {}
        self._fn = fn
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float):
        with self._lock:
            self._value = float(v)

    def value(self) -> float:
        if self._fn is not None:
            return self._fn()
        with self._lock:
            return self._value

    def reset(self):
        with self._lock:
            self._value = 0.0


class Histogram:
    """Fixed-bucket cumulative histogram (Prometheus `le` semantics).

    `quantile(q)` returns the upper bound of the bucket where the
    cumulative count crosses q — intentionally conservative (an
    over-estimate by at most one bucket width), which is the right bias
    for backoff hints: better to tell a shed client to wait slightly
    too long than to invite an immediate re-shed."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets=LATENCY_BUCKETS, labels=None):
        if not buckets:
            raise ValueError("histogram needs at least one finite bucket")
        self.name = name
        self.help = help
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self.labels = dict(labels or {})
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.buckets) + 1)   # [+Inf] overflow last
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float):
        v = float(v)
        with self._lock:
            self._counts[bisect.bisect_left(self.buckets, v)] += 1
            self._sum += v
            self._count += 1

    def quantile(self, q: float, default: float | None = None):
        """Bucket-resolution quantile; `default` when nothing observed.
        Values past the largest finite bucket clamp to that bound (the
        +Inf bucket has no upper edge to report)."""
        with self._lock:
            if self._count == 0:
                return default
            target = q * self._count
            cum = 0
            for i, le in enumerate(self.buckets):
                cum += self._counts[i]
                if cum >= target:
                    return le
            return self.buckets[-1]

    def snapshot(self) -> dict:
        """Cumulative view for exposition: [(le, cumulative_count)]
        including the +Inf bucket, plus sum and count."""
        with self._lock:
            out, cum = [], 0
            for i, le in enumerate(self.buckets):
                cum += self._counts[i]
                out.append((le, cum))
            out.append((float("inf"), cum + self._counts[-1]))
            return {"buckets": out, "sum": self._sum, "count": self._count}

    def reset(self):
        with self._lock:
            self._counts = [0] * (len(self.buckets) + 1)
            self._sum = 0.0
            self._count = 0


class HistogramVec:
    """Labelled histogram family (one child Histogram per label set)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets=LATENCY_BUCKETS, labelnames=("phase",)):
        self.name = name
        self.help = help
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: dict[tuple, Histogram] = {}

    def labels(self, **kw) -> Histogram:
        key = tuple(str(kw[ln]) for ln in self.labelnames)
        with self._lock:
            h = self._children.get(key)
            if h is None:
                h = Histogram(self.name, self.help, self.buckets,
                              labels=dict(zip(self.labelnames, key)))
                self._children[key] = h
            return h

    def children(self) -> list[Histogram]:
        with self._lock:
            return [self._children[k] for k in sorted(self._children)]

    def reset(self):
        with self._lock:
            self._children.clear()


class MetricsRegistry:
    """Name-keyed metric registry the exposition renderer iterates.
    Re-registering a name returns the existing metric (module reload /
    test-process reuse must not fork the series)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}

    def _get_or_add(self, name: str, make):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = make()
                self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_add(name, lambda: Counter(name, help))

    def gauge(self, name: str, help: str = "", fn=None) -> Gauge:
        return self._get_or_add(name, lambda: Gauge(name, help, fn=fn))

    def histogram(self, name: str, help: str = "",
                  buckets=LATENCY_BUCKETS) -> Histogram:
        return self._get_or_add(name, lambda: Histogram(name, help, buckets))

    def histogram_vec(self, name: str, help: str = "",
                      buckets=LATENCY_BUCKETS,
                      labelnames=("phase",)) -> HistogramVec:
        return self._get_or_add(
            name, lambda: HistogramVec(name, help, buckets, labelnames))

    def collect(self) -> list:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def reset(self):
        for m in self.collect():
            m.reset()


# process-global registry the /metrics endpoint renders
REGISTRY = MetricsRegistry()

# end-to-end prove latency (observed by the JobQueue worker on every
# completed job)
PROVE_LATENCY = REGISTRY.histogram(
    "spectre_prove_latency_seconds",
    "End-to-end prove latency per completed job (seconds)",
    LATENCY_BUCKETS)

# per-phase wall clock, fed by utils/profiling.phase — the production
# counterpart of bench.py's MSM/NTT phase decomposition
PHASE_SECONDS = REGISTRY.histogram_vec(
    "spectre_phase_seconds",
    "Wall-clock seconds per instrumented prover phase",
    PHASE_BUCKETS, ("phase",))


# admission -> worker-start wait, observed by the JobQueue worker with
# the same value the job's provenance manifest records as queue_wait_s
QUEUE_WAIT = REGISTRY.histogram(
    "spectre_queue_wait_seconds",
    "Seconds between job admission and worker start",
    QUEUE_WAIT_BUCKETS)

# seconds of each kernel library build (nvcc, or the host C++ compiler),
# attributed to the entry point that was open when it ran; fed by
# observability/compilelog. No observation after boot = every prove ran
# on libraries built before it (the port's counterpart of the reference's
# XLA compile series).
KERNEL_BUILD_SECONDS = REGISTRY.histogram_vec(
    "spectre_kernel_build_seconds",
    "Kernel library build seconds per triggering entry point",
    BUILD_BUCKETS, ("fn",))


def queue_latency_histogram() -> Histogram:
    """Fresh unregistered prove-latency histogram. Each JobQueue prices
    retry_after off its own instance (queue-local load); the registered
    PROVE_LATENCY aggregates process-wide for exposition."""
    return Histogram("prove_latency_seconds", buckets=LATENCY_BUCKETS)
