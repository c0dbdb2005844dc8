"""Per-proof provenance manifests ("what produced these bytes?"), the
port's copy of `spectre_tpu/observability/manifest.py`.

Every job emits one JSON manifest capturing:

* timestamps (submitted / admitted / started / finished) so queue wait
  is separable from prove time — `queue_wait_s` here is the same float
  observed into `spectre_queue_wait_seconds`;
* the resolved MSM mode, its fixed-base degrade counter, and the env
  knobs that shape a prove;
* every degrade / fault event that fired during the prove (fixed ->
  glv+signed, device failures, injected faults) via the thread-local
  `record_event` collector below;
* the MSM fixed-base table LRU's hit/build/eviction deltas;
* `kernels`, in the place of the reference's `compile`: the kernel
  libraries built during the job (observability/compilelog; a prove
  after boot shows `kernels.builds == 0`) and the kernels it launched;
* phase seconds from the job's span tree, peak RSS, result digest.

Manifests are artifacts, not journal payload: the JobQueue writes the
canonical JSON through `utils/artifacts.ArtifactStore` under suffix
`.manifest.json` (content-addressed, sha256-verified, quarantined on
rot) and the journal records only the digest. Retrieval:
`getProofManifest` RPC / `ProverClient.get_manifest` /
`python -m spectre_tpu_torch.observability report`.

The MSM mode and LRU stats are read through `sys.modules`: building a
manifest never imports the ops modules.
"""

from __future__ import annotations

import contextlib
import json
import sys
import threading

from ..utils import faults

SCHEMA = "spectre/proof-manifest/v1"
MANIFEST_SUFFIX = ".manifest.json"

# the env knobs that shape a prove; recorded even when unset (null) so
# two manifests always diff key-for-key
ENV_KNOBS = (
    "SPECTRE_MSM_MODE", "SPECTRE_NTT_MODE", "SPECTRE_NTT_KERNEL",
    "SPECTRE_MSM_WINDOW", "SPECTRE_MSM_TABLE_MB", "SPECTRE_NTT_TABLE_MB",
    "SPECTRE_FIELD_IMPL", "SPECTRE_JOB_QUEUE_DEPTH", "SPECTRE_MEM_WATERMARK_MB",
    "SPECTRE_SELF_VERIFY", "SPECTRE_FAULT_PLAN", "CUDA_VISIBLE_DEVICES",
)

MSM = "spectre_tpu_torch.ops.msm"
NTT = "spectre_tpu_torch.ops.ntt"


# -- per-job event collector (thread-local, like the kernel capture) -------

class _Local(threading.local):
    def __init__(self):
        self.events: list | None = None


_local = _Local()


def record_event(kind: str, **detail):
    """Append a degrade/fallback/fault event to the collecting job's
    manifest; free no-op when no job is collecting on this thread.
    Call sites: ops/msm.py (msm_fixed_degraded), prover_service/state.py
    (device_prove_failed), prover_service/selfverify.py (verify failures
    and the re-prove), utils/faults.py observer (every injected fault)."""
    sink = _local.events
    if sink is not None:
        sink.append({"kind": kind, **detail})


@contextlib.contextmanager
def collect_events(into: list | None = None):
    """Collect this thread's events into `into` (or a fresh list) for
    the duration of the block; yields the list."""
    sink = into if into is not None else []
    prev = _local.events
    _local.events = sink
    try:
        yield sink
    finally:
        _local.events = prev


def _on_fault(site: str, kind: str):
    record_event("fault", site=site, fault_kind=kind)


# every injected fault that fires while a job is collecting lands in
# that job's manifest (module import is idempotent => registered once)
faults.add_observer(_on_fault)


# -- environment / mode / cache snapshots ----------------------------------

def env_snapshot() -> dict:
    import os
    return {k: os.environ.get(k) for k in ENV_KNOBS}


def resolved_modes() -> dict:
    """The active MSM mode, the fixed-base degrade counter
    (`ops.msm.COUNTERS`) and the active NTT mode (`ops.ntt.ntt_mode()`),
    read through sys.modules: an ops module that was never loaded (a pure
    service-layer job) reads as None."""
    out: dict = {"msm": None, "msm_fixed_degraded": None, "ntt": None}
    msm = sys.modules.get(MSM)
    if msm is not None:
        try:
            out["msm"] = msm.msm_mode()
            out["msm_fixed_degraded"] = msm.COUNTERS["msm_fixed_degraded"]
        except Exception:
            pass
    ntt = sys.modules.get(NTT)
    if ntt is not None:
        try:
            out["ntt"] = ntt.ntt_mode()
        except Exception:
            pass
    return out


def lru_snapshot() -> dict:
    """Point-in-time stats of the MSM fixed-base table LRU and the NTT
    table LRU (`lru_stats()` of ops.msm and ops.ntt; None when the module
    is not loaded); `lru_delta` turns two of these into the per-job churn
    the manifest stores."""
    out: dict = {}
    for name, modname in (("msm", MSM), ("ntt", NTT)):
        stats = None
        mod = sys.modules.get(modname)
        if mod is not None:
            try:
                stats = mod.lru_stats()
            except Exception:
                pass
        out[name] = stats
    return out


_LRU_COUNTERS = ("hits", "builds", "evictions", "recomputes")


def lru_delta(before: dict | None, after: dict | None) -> dict:
    """Per-cache counter deltas across a job, plus the cache's final
    occupancy. A cache absent at either end reads as None."""
    out: dict = {}
    for name in ("msm", "ntt"):
        b = (before or {}).get(name)
        a = (after or {}).get(name)
        if a is None:
            out[name] = None
            continue
        b = b or {}
        d = {k: a.get(k, 0) - b.get(k, 0) for k in _LRU_COUNTERS}
        d["bytes"] = a.get("bytes", 0)
        d["entries"] = a.get("entries", 0)
        out[name] = d
    return out


# -- manifest construction --------------------------------------------------

def build(*, job_id: str, method: str, witness_digest: str | None = None,
          attempts: int = 0, submitted: float | None = None,
          admitted: float | None = None, started: float | None = None,
          finished: float | None = None, queue_wait_s: float | None = None,
          trace=None, kernel_events=(), events=(),
          lru_before: dict | None = None, lru_after: dict | None = None,
          peak_rss_mb: float | None = None,
          result_digest: str | None = None,
          error: str | None = None) -> dict:
    """Assemble the manifest dict. `trace` is an observability.tracing
    Trace (phase seconds are derived from the same tree `getTrace`
    serves, so the two agree by construction); `kernel_events` is the
    compilelog.capture output; `events` the collect_events output."""
    from . import compilelog, tracing
    prove_s = None
    if started is not None and finished is not None:
        prove_s = round(finished - started, 6)
    return {
        "schema": SCHEMA,
        "job_id": job_id,
        "method": method,
        "witness_digest": witness_digest,
        "attempts": attempts,
        "timestamps": {"submitted": submitted, "admitted": admitted,
                       "started": started, "finished": finished},
        "queue_wait_s": queue_wait_s,
        "prove_s": prove_s,
        "env": env_snapshot(),
        "modes": resolved_modes(),
        "events": list(events),
        "kernels": compilelog.summarize(kernel_events),
        "lru_delta": lru_delta(lru_before, lru_after),
        "phase_seconds": (tracing.phase_seconds(trace)
                          if trace is not None else {}),
        "peak_rss_mb": peak_rss_mb,
        "result_digest": result_digest,
        "error": error,
    }


def to_bytes(manifest: dict) -> bytes:
    """Canonical JSON encoding (sorted keys, tight separators) — the
    artifact digest is computed over exactly these bytes, so replay
    re-verification is byte-stable."""
    return (json.dumps(manifest, sort_keys=True,
                       separators=(",", ":")) + "\n").encode()


def from_bytes(data: bytes) -> dict:
    man = json.loads(data.decode())
    if not isinstance(man, dict) or man.get("schema") != SCHEMA:
        got = man.get("schema") if isinstance(man, dict) else type(man).__name__
        raise ValueError(f"not a {SCHEMA} manifest (got {got!r})")
    return man


# -- rendering (`python -m spectre_tpu_torch.observability report`) ---------

def _fmt_s(v) -> str:
    return "-" if v is None else f"{v:.3f}s"


def render(man: dict) -> str:
    """Human-readable phase/kernel/queue-wait breakdown."""
    lines = [
        f"manifest {man.get('job_id')}  method={man.get('method')}"
        f"  attempts={man.get('attempts')}",
        f"  result digest : {man.get('result_digest') or '-'}",
        f"  witness digest: {man.get('witness_digest') or '-'}",
    ]
    if man.get("error"):
        lines.append(f"  error         : {man['error']}")
    kern = man.get("kernels") or {}
    lines += [
        f"  queue wait    : {_fmt_s(man.get('queue_wait_s'))}"
        "   (admission -> worker start)",
        f"  prove         : {_fmt_s(man.get('prove_s'))}"
        f"   (peak RSS {man.get('peak_rss_mb') or '-'} MB)",
        f"  kernel builds : {_fmt_s(kern.get('seconds'))} across "
        f"{kern.get('builds', 0)} library build(s)",
    ]
    for fn, slot in (kern.get("by_fn") or {}).items():
        lines.append(f"      {fn:<28} {slot['seconds']:.3f}s"
                     f" x{slot['count']}")
    launches = kern.get("launches") or {}
    if launches:
        lines.append("  launches      : " + "  ".join(
            f"{k}={v}" for k, v in launches.items()))
    modes = man.get("modes") or {}
    lines.append(f"  modes         : msm={modes.get('msm') or '-'}"
                 f"  fixed degrades={modes.get('msm_fixed_degraded')}"
                 f"  ntt={modes.get('ntt') or '-'}")
    phases = man.get("phase_seconds") or {}
    if phases:
        lines.append("  phases:")
        for name, sec in sorted(phases.items(), key=lambda kv: -kv[1]):
            lines.append(f"      {name:<28} {sec:.3f}s")
    events = man.get("events") or []
    if events:
        lines.append("  events:")
        for ev in events:
            detail = ", ".join(f"{k}={v}" for k, v in ev.items()
                               if k != "kind")
            lines.append(f"      {ev.get('kind')}"
                         + (f" ({detail})" if detail else ""))
    lru = man.get("lru_delta") or {}
    for name in ("msm", "ntt"):
        d = lru.get(name)
        if d:
            lines.append(
                f"  lru[{name}]      : +{d.get('hits', 0)} hits"
                f"  +{d.get('builds', 0)} builds"
                f"  +{d.get('evictions', 0)} evictions"
                f"  +{d.get('recomputes', 0)} recomputes"
                f"  ({d.get('entries', 0)} entries resident)")
    return "\n".join(lines)


def diff(a: dict, b: dict) -> str:
    """Regression-triage diff of two manifests: wait/prove/kernel-build
    and per-phase deltas (b relative to a), plus mode/env knob changes."""
    lines = [f"diff {a.get('job_id')} -> {b.get('job_id')}"]

    def num(m, *path):
        cur = m
        for p in path:
            cur = (cur or {}).get(p)
        return cur if isinstance(cur, (int, float)) else 0.0

    for label, path in (("queue wait", ("queue_wait_s",)),
                        ("prove", ("prove_s",)),
                        ("builds", ("kernels", "seconds"))):
        va, vb = num(a, *path), num(b, *path)
        lines.append(f"  {label:<12}: {va:.3f}s -> {vb:.3f}s"
                     f"  ({vb - va:+.3f}s)")
    ca, cb = num(a, "kernels", "builds"), num(b, "kernels", "builds")
    if ca != cb:
        lines.append(f"  kernel builds: {int(ca)} -> {int(cb)}")
    pa = a.get("phase_seconds") or {}
    pb = b.get("phase_seconds") or {}
    deltas = [(name, pb.get(name, 0.0) - pa.get(name, 0.0))
              for name in sorted(set(pa) | set(pb))]
    moved = [(n, d) for n, d in deltas if abs(d) >= 0.0005]
    if moved:
        lines.append("  phases (delta):")
        for name, d in sorted(moved, key=lambda kv: -abs(kv[1])):
            lines.append(f"      {name:<28} {d:+.3f}s")
    for scope in ("modes", "env"):
        sa, sb = a.get(scope) or {}, b.get(scope) or {}
        for k in sorted(set(sa) | set(sb)):
            if sa.get(k) != sb.get(k):
                lines.append(f"  {scope}.{k}: {sa.get(k)!r} -> {sb.get(k)!r}")
    return "\n".join(lines)
