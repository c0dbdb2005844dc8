"""spectre_tpu_torch.observability — the port's copy of the telemetry spine
of `spectre_tpu/observability/`, so far its two stdlib-only pieces:

* :mod:`.metrics` — counters/gauges/fixed-bucket histograms; the
  per-phase histogram ServiceHealth's running means cannot express.
* :mod:`.tracing` — per-job span trees (trace id = job id) fed by
  `utils/profiling.phase`; Chrome trace-event export.

Import order matters downstream: utils/profiling.py imports
`.metrics`/`.tracing`, so nothing here may import the service layer at
module scope.
"""

from . import metrics, tracing          # noqa: F401  (stdlib-only)

__all__ = ["metrics", "tracing"]
