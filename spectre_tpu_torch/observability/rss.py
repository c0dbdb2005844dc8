"""Per-job peak-RSS attribution (the port's copy of
`spectre_tpu/observability/rss.py`).

The memory watermark (prover_service/jobs.py) sheds on process-wide
RSS — necessary but unattributable: when the box is near the watermark
the operator needs to know WHICH running job is the hog. RssSampler
polls the same psutil-free `/proc/self/statm` source on a small shared
daemon thread and keeps a running max per registered key (job id), so
every finished job record carries `peak_rss_mb` and a memory shed can
name the jobs it protected the box from.

Peak RSS is a process-wide number — concurrent jobs all see the same
high-water mark, so attribution is "RSS while this job ran", not an
isolated per-job footprint (that would need cgroup accounting). That is
still the operative signal: the job whose lifetime covers the spike is
the one to re-spec or re-schedule.

Lifecycle: the sampler thread starts lazily on the first `start()` and
EXITS when the last active key finishes — no leaked threads after job
completion. Off-Linux
(`rss_mb()` -> None) everything degrades to a no-op returning None.
"""

from __future__ import annotations

import os
import threading

SAMPLE_INTERVAL_ENV = "SPECTRE_RSS_SAMPLE_S"
SAMPLE_INTERVAL_DEFAULT_S = 0.2


def rss_mb() -> float | None:
    """Resident set size in MB via /proc/self/statm (no psutil). Returns
    None where procfs is unavailable (macOS CI etc.) — the memory
    watermark and the sampler then degrade to no-ops, never a crash."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") / (1024.0 * 1024.0)
    except (OSError, IndexError, ValueError):
        return None


class RssSampler:
    def __init__(self, interval_s: float | None = None):
        if interval_s is None:
            try:
                interval_s = float(os.environ.get(
                    SAMPLE_INTERVAL_ENV, SAMPLE_INTERVAL_DEFAULT_S))
            except ValueError:
                interval_s = SAMPLE_INTERVAL_DEFAULT_S
        self.interval_s = max(0.005, interval_s)
        self._lock = threading.Lock()
        self._peaks: dict[str, float] = {}     # active keys only
        self._thread: threading.Thread | None = None
        self._wake = threading.Event()

    def start(self, key: str):
        """Begin attributing RSS to `key`; takes an immediate sample so
        even a sub-interval job gets a real peak."""
        v = rss_mb()
        if v is None:
            return
        with self._lock:
            self._peaks[key] = max(self._peaks.get(key, 0.0), v)
            if self._thread is None:
                self._wake.clear()
                self._thread = threading.Thread(
                    target=self._run, daemon=True,
                    name="spectre-rss-sampler")
                self._thread.start()

    def peak(self, key: str) -> float | None:
        """Current running peak for an ACTIVE key (shed attribution
        reads this for still-running jobs)."""
        with self._lock:
            v = self._peaks.get(key)
        return None if v is None else round(v, 1)

    def finish(self, key: str) -> float | None:
        """Stop attributing to `key`, return its peak. A final sample is
        folded in first (a job shorter than the interval still reports)."""
        v = rss_mb()
        with self._lock:
            peak = self._peaks.pop(key, None)
            if peak is None:
                return None
            if v is not None:
                peak = max(peak, v)
            if not self._peaks:
                self._wake.set()              # sampler thread exits
        return round(peak, 1)

    def _run(self):
        while True:
            self._wake.wait(self.interval_s)
            with self._lock:
                if not self._peaks:
                    # last key finished: self-terminate (the "no leaked
                    # threads" contract); a later start() respawns
                    self._thread = None
                    return
                # a start() raced the wake: un-signal and keep sampling
                self._wake.clear()
                v = rss_mb()
                if v is not None:
                    for k in self._peaks:
                        if v > self._peaks[k]:
                            self._peaks[k] = v


# process-global sampler the JobQueue workers share (one thread no
# matter how many queues/jobs are live)
SAMPLER = RssSampler()
