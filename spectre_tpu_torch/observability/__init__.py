"""spectre_tpu_torch.observability — the port's copy of the telemetry
spine of `spectre_tpu/observability/`. Six pieces:

* :mod:`.metrics` — counters, gauges and fixed-bucket histograms: the
  prove-latency, queue-wait, per-phase and kernel-build histograms
  ServiceHealth's running means cannot express.
* :mod:`.prom` — Prometheus text exposition (0.0.4) over
  `HEALTH.snapshot()`, queue stats, breaker states, the MSM table LRU,
  the kernels' launch counters and the registered histograms; served as
  `GET /metrics` by prover_service/rpc.py.
* :mod:`.tracing` — per-job span trees, fed by `utils/profiling.phase`;
  Chrome trace-event export via the `getTrace` RPC.
* :mod:`.rss` — per-job peak-RSS attribution from /proc/self/statm.
* :mod:`.manifest` — per-proof provenance manifests: timestamps,
  modes/knobs, degrade and fault events, LRU deltas, kernel builds and
  launches, phase seconds, result digest; `getProofManifest` RPC and the
  `report` CLI.
* :mod:`.compilelog` — the kernel-build observer and per-entry-point
  launch attribution (the port's counterpart of the reference's
  jax.monitoring compile listener).

`utils/profiling.phase` feeds `.metrics`/`.tracing`, so nothing here may
import the service layer at module scope.
"""

from . import metrics, rss, tracing          # noqa: F401  (stdlib-only)
from . import compilelog, manifest, prom     # noqa: F401  (build on the above)

__all__ = ["compilelog", "manifest", "metrics", "prom", "rss", "tracing"]
