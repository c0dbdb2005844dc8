"""Deterministic fault injection (SPECTRE_FAULT_PLAN) for resilience tests
(the port's copy of `spectre_tpu/utils/faults.py`).

Grammar::

    SPECTRE_FAULT_PLAN = entry[,entry...]
    entry              = site ":" kind [":" count]      (count defaults to 1)

e.g. ``SPECTRE_FAULT_PLAN=beacon.fetch:http503:3,backend.prove:oom`` arms
three injected HTTP 503s at the beacon-fetch boundary and one simulated
device OOM at the backend-prove boundary. Each armed entry fires ``count``
times (in plan order per site) and then disarms; un-named sites are
zero-cost no-ops.

Injection sites are registered in :data:`SITES` (site -> (module,
description)); render the table with ``render_site_table()`` or
``python -m spectre_tpu_torch.prover_service faults --list``. The README's
fault-site table is generated from that registry and pinned by a parity
test — extend SITES when threading a new ``faults.check(...)`` call.

Kinds and the exception they raise:

    raise       InjectedFault                (generic transient error)
    oom         InjectedFault, oom-classified by backend.is_device_oom
    compile     InjectedFault, classified by backend.is_compile_failure
    http503     urllib HTTPError 503 (Retry-After: 0)
    http429     urllib HTTPError 429 (Retry-After: 0.01)
    timeout     TimeoutError
    connreset   ConnectionResetError
    ioerror     OSError
    diskfull    OSError(errno.ENOSPC) — a full disk at a write site; the
                job must fail with a typed error (or degrade best-effort
                where the write is optional, e.g. manifests), never crash
                the worker or wedge the queue
    crash       InjectedCrash (BaseException: simulates a hard worker kill —
                deliberately NOT caught by ``except Exception`` recovery
                paths, so journal-replay tests exercise a real mid-prove
                death)
    corrupt     no exception — DATA corruption: ``mangle(site, data)``
                bit-flips one byte of the payload passing through the
                site (silent disk rot / a torn DMA, the failure mode
                end-to-end checksums exist for). ``check()`` ignores
                ``corrupt`` entries; only ``mangle()`` consumes them.

The registry is thread-safe and records every firing in ``fired`` so tests
assert exact retry counts. Tests arm plans programmatically via ``arm()``/
``install_plan()``; CI can arm whole scenarios through the environment.
"""

from __future__ import annotations

import io
import os
import threading

ENV_VAR = "SPECTRE_FAULT_PLAN"

KINDS = ("raise", "oom", "compile", "http503", "http429", "timeout",
         "connreset", "ioerror", "diskfull", "crash", "corrupt")

# Canonical site registry: site -> (module that calls check()/mangle(),
# what the fault injects into). The sites are the JAX package's, with its
# module paths moved to the port's; a site whose module the port has not
# ported yet stays registered, so that a plan written for either package
# parses the same. The README table and the
# `prover_service faults --list` CLI are both generated from this dict,
# so a new site added here shows up everywhere at once.
SITES = {
    "beacon.fetch": ("spectre_tpu_torch/preprocessor/beacon.py",
                     "every beacon REST GET attempt"),
    "srs.load": ("spectre_tpu_torch/plonk/srs.py", "SRS file read / setup"),
    "backend.prove": ("spectre_tpu_torch/prover_service/state.py",
                      "served prove entry (fails the job: no CPU retry)"),
    "journal.write": ("spectre_tpu_torch/prover_service/jobs.py",
                      "each fsync'd job-journal append"),
    "journal.compact": ("spectre_tpu_torch/prover_service/jobs.py",
                        "staged-sidecar swap window"),
    "artifact.write": ("spectre_tpu_torch/utils/artifacts.py", "result-file atomic write"),
    "artifact.read": ("spectre_tpu_torch/utils/artifacts.py", "result-file read + verify"),
    "metrics.write": ("spectre_tpu_torch/utils/profiling.py",
                      "SPECTRE_METRICS JSONL append (a broken metrics "
                      "sink must never fail a prove)"),
    "manifest.write": ("spectre_tpu_torch/prover_service/jobs.py",
                       "provenance-manifest artifact write (tolerated: "
                       "the job still finishes, the manifest degrades "
                       "to absent)"),
    "proof.bytes": ("spectre_tpu_torch/prover_service/selfverify.py",
                    "fresh proof bytes between prove and "
                    "verify-before-serve (kind `corrupt` is the silent "
                    "data corruption the self-verify layer catches)"),
    "follower.journal": ("spectre_tpu_torch/follower/updates.py",
                         "verified-update-store journal append (the "
                         "follower chain record behind each stored "
                         "light-client update)"),
    "replica.dispatch": ("spectre_tpu_torch/prover_service/dispatcher.py",
                         "replica-side prove entry under a dispatcher "
                         "lease (kind `crash` kills the replica "
                         "mid-prove: the lease dies unrenewed and the "
                         "job moves to a surviving replica)"),
    "replica.health": ("spectre_tpu_torch/prover_service/dispatcher.py",
                       "replica health probe during dispatch routing "
                       "(a failing probe marks the replica unhealthy; "
                       "it is skipped, not crashed)"),
    "replica.lease": ("spectre_tpu_torch/prover_service/dispatcher.py",
                      "lease-journal append, AFTER the record lands "
                      "(the post-append crash window restart replay "
                      "must cover; `ioerror` is tolerated — counted on "
                      "dispatcher_lease_journal_failures)"),
    "replica.lease_compact": ("spectre_tpu_torch/prover_service/dispatcher.py",
                              "lease-journal compaction, staged-sidecar "
                              "swap window (kind `crash` leaves the "
                              "original journal intact; replay must "
                              "still see every open lease)"),
    "gateway.pack_write": ("spectre_tpu_torch/gateway/packs.py",
                           "update-range pack artifact write (tolerated: "
                           "serving falls back to the update store, "
                           "counted on gateway_pack_build_failures, "
                           "rebuilt on the next seal event)"),
    "replica.register": ("spectre_tpu_torch/prover_service/dispatcher.py",
                         "dispatcher-side registerReplica admission "
                         "(`raise`/`timeout`/`connreset` surface to the "
                         "announcing replica as an RPC error; the fleet "
                         "is unchanged and the replica re-announces next "
                         "interval)"),
    "replica.announce": ("spectre_tpu_torch/prover_service/rpc.py",
                         "replica-side announce-loop POST to the "
                         "dispatcher head (tolerated: counted on "
                         "replica_announce_failures, the replica keeps "
                         "serving and retries next interval — only a "
                         "TTL of silence deregisters it)"),
}


def render_site_table() -> str:
    """Markdown table of every registered injection site (the single
    source the README section and the CLI listing are generated from)."""
    lines = ["| site | where | injects into |",
             "|------|-------|--------------|"]
    for site, (module, desc) in SITES.items():
        lines.append(f"| `{site}` | `{module}` | {desc} |")
    return "\n".join(lines)


class InjectedFault(Exception):
    """A deliberately injected transient failure."""

    def __init__(self, site: str, kind: str):
        super().__init__(f"injected fault at {site} ({kind})")
        self.site = site
        self.kind = kind


class InjectedCrash(BaseException):
    """Simulated hard kill (power loss / SIGKILL mid-prove).

    BaseException on purpose: the worker's ``except Exception`` failure
    handling must NOT see it — a crashed worker writes nothing, which is
    exactly the state journal replay has to recover from."""

    def __init__(self, site: str):
        super().__init__(f"injected crash at {site}")
        self.site = site


def _make_exc(site: str, kind: str) -> BaseException:
    if kind == "crash":
        return InjectedCrash(site)
    if kind in ("raise", "oom", "compile"):
        return InjectedFault(site, kind)
    if kind in ("http503", "http429"):
        import email.message
        import urllib.error
        hdrs = email.message.Message()
        hdrs["Retry-After"] = "0" if kind == "http503" else "0.01"
        code = 503 if kind == "http503" else 429
        return urllib.error.HTTPError(f"fault://{site}", code,
                                      f"injected {kind}", hdrs,
                                      io.BytesIO(b""))
    if kind == "timeout":
        return TimeoutError(f"injected timeout at {site}")
    if kind == "connreset":
        return ConnectionResetError(f"injected connection reset at {site}")
    if kind == "ioerror":
        return OSError(f"injected I/O error at {site}")
    if kind == "diskfull":
        import errno
        return OSError(errno.ENOSPC, f"injected ENOSPC (disk full) at {site}")
    raise ValueError(f"unknown fault kind {kind!r} (one of {KINDS})")


def parse_plan(text: str) -> list[list]:
    """Parse the SPECTRE_FAULT_PLAN grammar into [site, kind, remaining]
    entries (order-preserving; multiple entries per site fire in order)."""
    plan = []
    for raw in (text or "").split(","):
        raw = raw.strip()
        if not raw:
            continue
        parts = raw.split(":")
        if len(parts) == 2:
            site, kind, count = parts[0], parts[1], 1
        elif len(parts) == 3:
            site, kind, count = parts[0], parts[1], int(parts[2])
        else:
            raise ValueError(f"bad fault-plan entry {raw!r} "
                             f"(want site:kind[:count])")
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r} in {raw!r} "
                             f"(one of {KINDS})")
        if count < 1:
            raise ValueError(f"bad fault count in {raw!r}")
        plan.append([site, kind, count])
    return plan


class FaultRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._plan: list[list] = []
        self._env_seen: str | None = None
        self.fired: list[tuple[str, str]] = []
        self._observers: list = []

    def add_observer(self, fn):
        """Register `fn(site, kind)` to be called (outside the registry
        lock) every time a fault actually fires. Idempotent per callable;
        observers must never raise — the provenance-manifest event
        recorder uses this to stamp injected faults into the job record."""
        with self._lock:
            if fn not in self._observers:
                self._observers.append(fn)

    def _notify(self, site: str, kind: str):
        with self._lock:
            observers = list(self._observers)
        for fn in observers:
            try:
                fn(site, kind)
            except Exception:
                pass               # observers are best-effort by contract

    def install_plan(self, text: str):
        """Replace the active plan (also resets the fired log)."""
        plan = parse_plan(text)
        with self._lock:
            self._plan = plan
            self._env_seen = None          # explicit plan wins over env
            self.fired = []

    def arm(self, site: str, kind: str, count: int = 1):
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r}")
        with self._lock:
            self._plan.append([site, kind, count])

    def clear(self):
        with self._lock:
            self._plan = []
            self._env_seen = ""            # suppress env re-reads until changed
            self.fired = []

    def _sync_env_locked(self):
        env = os.environ.get(ENV_VAR, "")
        if env != (self._env_seen or ""):
            self._env_seen = env
            self._plan = parse_plan(env)
            self.fired = []

    def check(self, site: str):
        """Fire (raise) the next armed fault for `site`, if any.

        Zero-cost for unarmed sites beyond one dict-free list scan; the env
        plan is re-parsed only when SPECTRE_FAULT_PLAN changes."""
        with self._lock:
            if self._env_seen is not None or not self._plan:
                self._sync_env_locked()
            for entry in self._plan:
                if entry[0] == site and entry[2] > 0 \
                        and entry[1] != "corrupt":
                    entry[2] -= 1
                    self.fired.append((site, entry[1]))
                    exc = _make_exc(site, entry[1])
                    break
            else:
                return
        self._notify(site, entry[1])
        raise exc

    def mangle(self, site: str, data: bytes) -> bytes:
        """Consume an armed ``corrupt`` entry for `site` by bit-flipping
        one byte of `data` (silent corruption — no exception). Unarmed
        sites return the payload untouched."""
        with self._lock:
            if self._env_seen is not None or not self._plan:
                self._sync_env_locked()
            for entry in self._plan:
                if entry[0] == site and entry[2] > 0 \
                        and entry[1] == "corrupt":
                    entry[2] -= 1
                    self.fired.append((site, "corrupt"))
                    break
            else:
                return data
        self._notify(site, "corrupt")
        if not data:
            return data
        buf = bytearray(data)
        buf[len(buf) // 2] ^= 0x01
        return bytes(buf)

    def fired_count(self, site: str | None = None) -> int:
        with self._lock:
            if site is None:
                return len(self.fired)
            return sum(1 for s, _ in self.fired if s == site)

    def armed(self, site: str | None = None) -> int:
        """Remaining armed firings (for tests asserting exhaustion)."""
        with self._lock:
            return sum(e[2] for e in self._plan
                       if site is None or e[0] == site)


# process-global registry: injection sites call faults.check("<site>")
REGISTRY = FaultRegistry()
check = REGISTRY.check
mangle = REGISTRY.mangle
arm = REGISTRY.arm
clear = REGISTRY.clear
install_plan = REGISTRY.install_plan
fired_count = REGISTRY.fired_count
armed = REGISTRY.armed
add_observer = REGISTRY.add_observer
