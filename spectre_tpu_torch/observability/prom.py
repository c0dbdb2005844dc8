"""Prometheus text exposition (format 0.0.4) for GET /metrics (the port's
copy of `spectre_tpu/observability/prom.py`).

The renderer bridges existing instrumentation rather than duplicating
it:

* every ServiceHealth counter becomes `spectre_<name>_total` — counter
  parity with `/healthz` is exact by construction (both read the same
  snapshot);
* ServiceHealth running means surface as `spectre_mean_<name>` gauges;
* JobQueue stats become per-status job gauges + worker/backlog gauges;
* beacon circuit breakers export a numeric state code per base_url;
* the MSM fixed-base table LRU exports hit/build/eviction/recompute
  counters and byte occupancy, `ops.msm.COUNTERS` become
  `spectre_msm_<name>_total`, and every kernel's launch counter
  (`ops/kernel_lib`) becomes `spectre_kernel_launches_total{kernel=}` —
  all read via `sys.modules`, so a scrape never imports the ops modules;
* registered metrics (prove latency, queue wait, per-phase and
  kernel-build histograms in observability/metrics.py) render as native
  histogram families.

No HTTP here: `prover_service/rpc.py` calls `render()` from its GET
handler."""

from __future__ import annotations

import sys

from ..utils.health import HEALTH
from . import metrics as _metrics
from .rss import rss_mb

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _fmt(v) -> str:
    if isinstance(v, bool):
        return str(int(v))
    if isinstance(v, int):
        return str(v)
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


def _fmt_le(le: float) -> str:
    if le == float("inf"):
        return "+Inf"
    return "%g" % le


def _esc(s: str) -> str:
    return (str(s).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _labels(d: dict) -> str:
    if not d:
        return ""
    inner = ",".join(f'{k}="{_esc(v)}"' for k, v in d.items())
    return "{" + inner + "}"


def _family(out: list, name: str, kind: str, help: str):
    out.append(f"# HELP {name} {help}")
    out.append(f"# TYPE {name} {kind}")


def _sample(out: list, name: str, labels: dict, v):
    out.append(f"{name}{_labels(labels)} {_fmt(v)}")


def _render_histogram(out: list, name: str, h) -> None:
    snap = h.snapshot()
    base = dict(h.labels)
    for le, cum in snap["buckets"]:
        lab = dict(base)
        lab["le"] = _fmt_le(le)
        _sample(out, f"{name}_bucket", lab, cum)
    _sample(out, f"{name}_sum", base, snap["sum"])
    _sample(out, f"{name}_count", base, snap["count"])


def _lru_stats() -> list[tuple[str, dict]]:
    """(cache_label, stats) of the MSM fixed-base table LRU when ops.msm is
    already imported (sys.modules only: a scrape of an idle service imports
    nothing)."""
    m = sys.modules.get("spectre_tpu_torch.ops.msm")
    if m is None:
        return []
    try:
        return [("msm", m.lru_stats())]
    except Exception:
        return []


def render(health=None, jobs=None, registry=None) -> str:
    """The full /metrics body. `health`/`jobs`/`registry` are injectable
    for tests; the service passes its JobQueue and defaults the rest."""
    health = HEALTH if health is None else health
    registry = _metrics.REGISTRY if registry is None else registry
    out: list[str] = []

    snap = health.snapshot()
    for name, v in snap["counters"].items():
        mn = f"spectre_{name}_total"
        _family(out, mn, "counter",
                f"ServiceHealth counter {name} (parity with /healthz)")
        _sample(out, mn, {}, int(v))
    _family(out, "spectre_uptime_seconds", "gauge",
            "Seconds since ServiceHealth start")
    _sample(out, "spectre_uptime_seconds", {}, snap["uptime_s"])
    for name, v in (snap.get("means") or {}).items():
        mn = f"spectre_mean_{name}"
        _family(out, mn, "gauge", f"ServiceHealth running mean of {name}")
        _sample(out, mn, {}, v)

    v = rss_mb()
    if v is not None:
        _family(out, "spectre_process_rss_mb", "gauge",
                "Process resident set size (MB, /proc/self/statm)")
        _sample(out, "spectre_process_rss_mb", {}, round(v, 1))

    if jobs is not None:
        st = jobs.stats()
        _family(out, "spectre_jobs", "gauge", "Jobs by status")
        for status in sorted(st.get("jobs", {})):
            _sample(out, "spectre_jobs", {"status": status},
                    st["jobs"][status])
        _family(out, "spectre_job_workers", "gauge",
                "Job worker pool size")
        _sample(out, "spectre_job_workers", {}, st.get("workers", 0))
        _family(out, "spectre_job_queue_depth_limit", "gauge",
                "Admission-control backlog bound (SPECTRE_JOB_QUEUE_DEPTH)")
        _sample(out, "spectre_job_queue_depth_limit", {},
                st.get("queue_depth", 0))
        _family(out, "spectre_job_retry_after_seconds", "gauge",
                "Current shed backoff hint (p90-priced)")
        _sample(out, "spectre_job_retry_after_seconds", {},
                jobs.retry_after_s())

    try:
        from ..preprocessor.beacon import (BREAKER_STATE_CODES,
                                           breaker_snapshot)
        breakers = breaker_snapshot()
    except Exception:
        breakers = []
    if breakers:
        _family(out, "spectre_beacon_breaker_state", "gauge",
                "Beacon circuit-breaker state (0=closed 1=half-open 2=open)")
        for b in breakers:
            _sample(out, "spectre_beacon_breaker_state",
                    {"base_url": b["base_url"]},
                    b.get("state_code",
                          BREAKER_STATE_CODES.get(b["state"], -1)))
        _family(out, "spectre_beacon_breaker_consecutive_failures", "gauge",
                "Consecutive beacon failures per client")
        for b in breakers:
            _sample(out, "spectre_beacon_breaker_consecutive_failures",
                    {"base_url": b["base_url"]}, b["consecutive_failures"])

    lru = _lru_stats()
    if lru:
        counter_keys = ("hits", "builds", "evictions", "recomputes")
        for key in counter_keys:
            mn = f"spectre_table_lru_{key}_total"
            _family(out, mn, "counter",
                    f"Derived-table LRU {key} (msm fixed-base tables)")
            for cache, st in lru:
                _sample(out, mn, {"cache": cache}, st.get(key, 0))
        for key, help_ in (("bytes", "Derived-table LRU occupancy (bytes)"),
                           ("budget_bytes",
                            "Derived-table LRU byte budget"),
                           ("entries", "Derived-table LRU entry count")):
            mn = f"spectre_table_lru_{key}"
            _family(out, mn, "gauge", help_)
            for cache, st in lru:
                _sample(out, mn, {"cache": cache}, st.get(key, 0))

    msm = sys.modules.get("spectre_tpu_torch.ops.msm")
    if msm is not None:
        for name, v in sorted(msm.COUNTERS.items()):
            mn = f"spectre_msm_{name}_total"
            _family(out, mn, "counter", f"ops.msm counter {name}")
            _sample(out, mn, {}, int(v))

    kl = sys.modules.get("spectre_tpu_torch.ops.kernel_lib")
    if kl is not None:
        _family(out, "spectre_kernel_launches_total", "counter",
                "Kernel launches since the process started (or the last "
                "reset of the launch counts)")
        for name, v in kl.launch_counts().items():
            _sample(out, "spectre_kernel_launches_total", {"kernel": name}, v)

    for m in registry.collect():
        _family(out, m.name, m.kind, m.help or m.name)
        if isinstance(m, _metrics.HistogramVec):
            for h in m.children():
                _render_histogram(out, m.name, h)
        elif isinstance(m, _metrics.Histogram):
            _render_histogram(out, m.name, m)
        else:
            _sample(out, m.name, getattr(m, "labels", {}), m.value())

    return "\n".join(out) + "\n"
