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
* the proof farm's replicas (`spectre_replica_*`,
  `spectre_dispatcher_members`), the followers' lag gauges
  (`spectre_follower_*`) and the gateways' pack and cache gauges
  (`spectre_gateway_*`), pulled from their weak registries;
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
    """(cache_label, stats) of each derived-table LRU whose module is
    already imported: the MSM's fixed-base tables, the NTT's twiddle,
    coset and DFT tables (sys.modules only: a scrape of an idle service
    imports nothing)."""
    items = []
    for cache in ("msm", "ntt"):
        m = sys.modules.get(f"spectre_tpu_torch.ops.{cache}")
        if m is None:
            continue
        try:
            items.append((cache, m.lru_stats()))
        except Exception:
            pass
    return items


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

    try:
        from ..prover_service.dispatcher import dispatcher_snapshot
        replicas = dispatcher_snapshot()
    except Exception:
        replicas = []
    if replicas:
        for key, kind, help_ in (
                ("breaker_state", "gauge",
                 "Replica circuit-breaker state "
                 "(0=closed 1=half-open 2=open)"),
                ("consecutive_failures", "gauge",
                 "Consecutive failures per prover replica"),
                ("active_leases", "gauge",
                 "Jobs currently leased to the replica"),
                ("healthy", "gauge",
                 "Last health-probe result (1=healthy 0=unhealthy; "
                 "absent until first probe)")):
            mn = f"spectre_replica_{key}"
            _family(out, mn, kind, help_)
            for r in replicas:
                if key == "breaker_state":
                    v = r["breaker"]["state_code"]
                elif key == "consecutive_failures":
                    v = r["breaker"]["consecutive_failures"]
                elif key == "healthy":
                    if r["healthy"] is None:
                        continue
                    v = int(r["healthy"])
                else:
                    v = r[key]
                _sample(out, mn, {"replica": r["replica_id"]}, v)
        _family(out, "spectre_replica_heartbeat_age_s", "gauge",
                "Seconds since the replica's last announce heartbeat "
                "(dynamic members only; past the TTL the member is "
                "demoted and deregistered)")
        for r in replicas:
            age = r.get("last_heartbeat_age_s")
            if age is not None:
                _sample(out, "spectre_replica_heartbeat_age_s",
                        {"replica": r["replica_id"]}, age)
        _family(out, "spectre_dispatcher_members", "gauge",
                "Proof-farm membership size by kind (total vs "
                "announce-registered dynamic members)")
        _sample(out, "spectre_dispatcher_members", {"kind": "total"},
                len(replicas))
        _sample(out, "spectre_dispatcher_members", {"kind": "dynamic"},
                sum(1 for r in replicas if r.get("dynamic")))

    try:
        from ..follower.daemon import follower_snapshot
        followers = follower_snapshot()
    except Exception:
        followers = []
    if followers:
        for key, help_ in (
                ("head_lag_slots",
                 "Slots between newest finalized header and newest "
                 "stored step proof"),
                ("periods_behind",
                 "Sync-committee periods between current period and the "
                 "verified update chain tip"),
                ("scheduler_backlog",
                 "Follower work items pending submit/collect")):
            mn = f"spectre_follower_{key}"
            _family(out, mn, "gauge", help_)
            for f in followers:
                _sample(out, mn, {"store": f.get("store", "")},
                        f.get(key, 0))

    try:
        from ..gateway.serving import gateway_snapshot
        gateways = gateway_snapshot()
    except Exception:
        gateways = []
    if gateways:
        for key, help_ in (
                ("packs", "Sealed update-range packs currently indexed"),
                ("pack_periods", "Periods per full pack "
                                 "(SPECTRE_PACK_PERIODS)"),
                ("cache_bytes", "Gateway hot-cache occupancy (bytes)"),
                ("cache_budget_bytes", "Gateway hot-cache byte budget "
                                       "(SPECTRE_GATEWAY_CACHE_MB)"),
                ("cache_entries", "Gateway hot-cache entry count"),
                ("cache_hits", "Gateway hot-cache lookup hits"),
                ("cache_misses", "Gateway hot-cache lookup misses")):
            mn = f"spectre_gateway_{key}"
            _family(out, mn, "gauge", help_)
            for g in gateways:
                cache = g.get("cache") or {}
                if key.startswith("cache_"):
                    v = cache.get(key[len("cache_"):], 0)
                else:
                    v = g.get(key) or 0
                _sample(out, mn, {"store": g.get("store", "")}, v)

    lru = _lru_stats()
    if lru:
        counter_keys = ("hits", "builds", "evictions", "recomputes")
        for key in counter_keys:
            mn = f"spectre_table_lru_{key}_total"
            _family(out, mn, "counter",
                    f"Derived-table LRU {key} (msm fixed-base, ntt tables)")
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
