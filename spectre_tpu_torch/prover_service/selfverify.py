"""Verify-before-serve: the output-integrity layer (the port's copy of
`spectre_tpu/prover_service/selfverify.py`).

A proof that fails on-chain verification is worse than no proof. Proving
is seconds to minutes of MSM/NTT arithmetic on the card (where silent data
corruption creeps in); verification is host-side pairing checks. This
module spends them on every fresh proof before the job queue marks it
``done``:

* ``verified_prove(state, kind, args)`` wraps ``ProverState.prove_*``: the
  fresh proof bytes pass through fault site ``proof.bytes`` (kind
  ``corrupt`` bit-flips them, the deterministic stand-in for SDC), then get
  verified host-side under a ``prove/self_verify`` span. A verify failure
  is classified as suspected silent data corruption: the suspect bytes are
  quarantined (``results/quarantine/``), the prove runs once more **on the
  state's own device**, the readiness self-check re-runs, and only a
  twice-failed job goes ``failed(ProofVerifyFailed)``. Nothing moves to
  the CPU: the reference retries on its CPU backend; the port keeps the
  device it was asked to prove on (a card that corrupts twice is a card to
  take out of service, and the self-check says so).
* ``SPECTRE_SELF_VERIFY=always|sampled:<p>|off`` (default ``always``)
  trades the verify cost away; ``off`` skips the span entirely. The
  sampling RNG is module-level (``RNG``) so tests inject sequences.
* ``SelfCheck`` proves and verifies a tiny cached K=6 circuit on the
  state's device: until it passes at startup (and after every SDC
  re-prove), ``GET /healthz`` reports 503 with ``self_check`` in the body.

Counters (ServiceHealth -> /healthz -> `spectre_*_total` in /metrics):
``proofs_verified``, ``proofs_verify_failed``, ``proofs_sdc_retried``,
``self_check_failures``.
"""

from __future__ import annotations

import functools
import inspect
import os
import random
import threading

from ..observability import manifest as obs_manifest
from ..observability import tracing
from ..utils import faults
from ..utils.health import HEALTH
from ..utils.profiling import phase

ENV_VAR = "SPECTRE_SELF_VERIFY"
PROOF_FAULT_SITE = "proof.bytes"

# sampling RNG for `sampled:<p>` mode — module-level so tests can inject
# a deterministic sequence (monkeypatch selfverify.RNG)
RNG = random.random


class ProofVerifyFailed(RuntimeError):
    """A fresh proof failed host-side verification twice (the prove and its
    re-prove on the same device): suspected silent data corruption; the
    bytes were quarantined, the job must fail rather than serve them."""

    def __init__(self, kind: str):
        super().__init__(
            f"{kind} proof failed self-verification after a re-prove on its "
            f"device (suspected silent data corruption); proof bytes "
            f"quarantined")
        self.kind = kind


def policy() -> tuple[str, float]:
    """Resolve SPECTRE_SELF_VERIFY into ('always'|'sampled'|'off', p).

    Unparseable values fail safe to 'always' — an operator typo must not
    silently disable the integrity layer."""
    raw = os.environ.get(ENV_VAR, "always").strip().lower()
    if raw in ("", "always"):
        return "always", 1.0
    if raw == "off":
        return "off", 0.0
    if raw.startswith("sampled:"):
        try:
            p = float(raw.split(":", 1)[1])
        except ValueError:
            return "always", 1.0
        return "sampled", min(max(p, 0.0), 1.0)
    return "always", 1.0


def _call_prove(fn, args, heartbeat=None):
    """Invoke a prove callable, passing heartbeat only if its signature
    accepts it (fakes and plain states stay callable)."""
    try:
        params = inspect.signature(fn).parameters
        var_kw = any(p.kind == p.VAR_KEYWORD for p in params.values())
    except (TypeError, ValueError):
        params, var_kw = {}, False
    if heartbeat is not None and ("heartbeat" in params or var_kw):
        return fn(args, heartbeat=heartbeat)
    return fn(args)


def _verify_once(state, kind: str, proof: bytes, instances, attempt: int,
                 health=HEALTH) -> bool:
    with phase("prove/self_verify"):
        try:
            ok = bool(state.verify_proof(kind, proof, instances))
        except Exception as exc:
            # a verifier blow-up on suspect bytes is a rejection (malformed
            # transcripts normally return False, but never serve on a crash)
            tracing.annotate(self_verify_error=f"{type(exc).__name__}")
            ok = False
    if ok:
        health.incr("proofs_verified")
    else:
        health.incr("proofs_verify_failed")
        tracing.annotate(self_verify_failed=attempt)
        obs_manifest.record_event("proof_verify_failed", proof_kind=kind,
                                  attempt=attempt)
    return ok


def _quarantine_proof(state, proof: bytes):
    """Best-effort: park the suspect bytes in the artifact store's
    quarantine dir (when the state is attached to a journaled queue)."""
    store = getattr(getattr(state, "jobs", None), "store", None)
    if store is None:
        return None
    try:
        return store.quarantine_bytes(proof)
    except Exception:
        return None


def _rerun_self_check(state):
    sc = getattr(state, "self_check", None)
    if sc is None:
        return
    try:
        sc.run()
    except Exception:
        pass                       # readiness probing must not fail the job


def verified_prove(state, kind: str, args, heartbeat=None, health=HEALTH):
    """Prove, then verify before serving. Returns (proof, instances).

    `kind` is "step" or "committee" (selects ``state.prove_<kind>`` and
    the verifying key inside ``state.verify_proof``). States without a
    ``verify_proof`` method (test fakes) skip verification entirely.
    """
    prove_fn = getattr(state, f"prove_{kind}")
    proof, instances = _call_prove(prove_fn, args, heartbeat=heartbeat)
    # SDC stand-in: armed `proof.bytes:corrupt` bit-flips the fresh bytes
    # here, between prove and verify
    proof = faults.mangle(PROOF_FAULT_SITE, proof)

    mode, p = policy()
    if mode == "off" or not hasattr(state, "verify_proof"):
        return proof, instances
    if mode == "sampled" and RNG() >= p:
        return proof, instances

    if _verify_once(state, kind, proof, instances, attempt=1, health=health):
        return proof, instances

    # suspected SDC: quarantine the suspect bytes, prove once more on the
    # same device, re-probe readiness
    _quarantine_proof(state, proof)
    health.incr("proofs_sdc_retried")
    device = str(getattr(state, "device", "unknown"))
    tracing.annotate(sdc_retry=device)
    obs_manifest.record_event("sdc_retry", proof_kind=kind, retry_device=device)
    proof, instances = _call_prove(prove_fn, args, heartbeat=heartbeat)
    proof = faults.mangle(PROOF_FAULT_SITE, proof)
    ok = _verify_once(state, kind, proof, instances, attempt=2, health=health)
    _rerun_self_check(state)
    if ok:
        return proof, instances
    _quarantine_proof(state, proof)
    raise ProofVerifyFailed(kind)


# -- cross-host verification ------------------------------------------------

def proof_kind(method: str) -> str:
    """Map an RPC prove method to its verifying-key kind."""
    if "Committee" in method or "Aggregation" in method:
        return "committee"
    return "step"


def decode_result(result: dict) -> tuple[bytes, list[int]]:
    """Decode a queue-runner result dict back into (proof, instances) —
    the inverse of run_proof_method's hex encoding."""
    proof = bytes.fromhex(result["proof"].removeprefix("0x"))
    instances = [int(h, 16) for h in result["instances"]]
    return proof, instances


def cross_verify(verify_state, method: str, result, health=HEALTH) -> bool:
    """Re-verify a proof produced by another host, on this host's keys.

    Returns True when the proof verifies (or verification is skipped:
    policy ``off``, sampled-out, no verifier on this state, or a result
    shape that isn't a proof); False means suspected SDC — the caller
    quarantines it and proves it elsewhere."""
    if (verify_state is None
            or not hasattr(verify_state, "verify_proof")
            or not isinstance(result, dict) or "proof" not in result):
        return True
    mode, p = policy()
    if mode == "off" or (mode == "sampled" and RNG() >= p):
        return True
    kind = proof_kind(method)
    try:
        proof, instances = decode_result(result)
    except (KeyError, ValueError):
        return True         # not a proof-shaped result; nothing to verify
    with phase("prove/cross_verify"):
        try:
            ok = bool(verify_state.verify_proof(kind, proof, instances))
        except Exception as exc:
            tracing.annotate(cross_verify_error=f"{type(exc).__name__}")
            ok = False
    if ok:
        health.incr("proofs_cross_verified")
    else:
        health.incr("proofs_cross_verify_failed")
        obs_manifest.record_event("cross_verify_failed", proof_kind=kind)
    return ok


# -- readiness self-check ---------------------------------------------------

@functools.lru_cache(maxsize=4)
def _tiny_setup(device: str = "cuda"):
    """Tiny K=6 gate+lookup+copy circuit, keyed on `device` (cached: keygen
    once per process and device); the reference's readiness circuit.

    out = x + x*y with a fixed-column constant, one lookup, and three copy
    constraints — small enough to prove in seconds, rich enough that a
    device silently miscomputing MSM/NTT cannot pass it."""
    from ..plonk.constraint_system import Assignment, CircuitConfig
    from ..plonk.keygen import keygen
    from ..plonk.srs import SRS

    k = 6
    cfg = CircuitConfig(k=k, num_advice=1, num_lookup_advice=1, num_fixed=1,
                        lookup_bits=4)
    n = cfg.n
    x_w, y_w = 7, 3
    out = x_w + x_w * y_w
    advice = [[0] * n]
    advice[0][0:5] = [x_w, x_w, y_w, out, 5]
    selectors = [[0] * n]
    selectors[0][0] = 1
    lookup = [[0] * n]
    lookup[0][0] = x_w
    fixed = [[0] * n]
    fixed[0][0] = 5
    copies = [
        ((cfg.col_instance(0), 0), (cfg.col_gate_advice(0), 3)),
        ((cfg.col_fixed(0), 0), (cfg.col_gate_advice(0), 4)),
        ((cfg.col_gate_advice(0), 0), (cfg.col_lookup_advice(0), 0)),
    ]
    srs = SRS.unsafe_setup(k, device=device)
    pk = keygen(srs, cfg, fixed, selectors, copies, device=device)
    asg = Assignment(cfg, advice, lookup, fixed, selectors, [[out]], copies)
    return pk, srs, asg, out


def _tiny_prove_verify(device: str = "cuda") -> bool:
    from ..plonk.prover import prove
    from ..plonk.verifier import verify
    pk, srs, asg, out = _tiny_setup(device)
    proof = prove(pk, srs, asg, device=device)
    return bool(verify(pk.vk, srs, [[out]], proof))


class SelfCheck:
    """Prove+verify the tiny cached circuit; gate readiness on the result.

    ``run()`` executes the injectable `runner` (default: the tiny circuit
    proved and verified on `device`, default CUDA) and records the
    outcome; ``GET /healthz`` returns 503 with ``snapshot()`` in the body
    until ``ok``. Re-run after every SDC re-prove, so that a device that
    has started flipping bits drops out of the ready pool."""

    def __init__(self, runner=None, health=HEALTH, device=None):
        self._lock = threading.Lock()
        dev = "cuda" if device is None else str(device)
        self._runner = runner if runner is not None \
            else functools.partial(_tiny_prove_verify, dev)
        self._health = health
        self.ok = False
        self.runs = 0
        self.last_error: str | None = None

    def run(self) -> bool:
        try:
            ok = bool(self._runner())
            err = None if ok else "tiny-circuit proof failed verification"
        except Exception as exc:
            ok, err = False, f"{type(exc).__name__}: {exc}"
        with self._lock:
            self.runs += 1
            self.ok = ok
            self.last_error = err
        if not ok:
            self._health.incr("self_check_failures")
        return ok

    def snapshot(self) -> dict:
        with self._lock:
            return {"ok": self.ok, "runs": self.runs,
                    "last_error": self.last_error}
