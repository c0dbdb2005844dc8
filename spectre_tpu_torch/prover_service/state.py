"""ProverState: SRS and proving keys made once at boot and kept hot (the
port's copy of `spectre_tpu/prover_service/state.py`).

Reference parity: `prover/src/prover.rs:43-117` (`ProverState::new`: the
SRS by degree, the step and committee keys created from default
witnesses) and the semaphore that caps concurrent proves
(`prover.rs:40`). `params_dir` holds the SRS files, the key cache
(`pk_cache=True`) and the async job journal (`jobs.ensure_jobs` attaches
the queue at serve time).

Every prove runs on the state's device (default CUDA). Nothing falls back
to the CPU: the reference retries a device OOM or a compile failure on its
CPU backend (`plonk/backend.py:664 prove_with_fallback`); here such a
prove fails its job (`DeviceProveFailed`, -32005 on the wire), counted on
`prove_device_failures_<kind>`. Fault site `backend.prove` fires at the
entry of every served prove.
"""

from __future__ import annotations

import contextlib
import threading
import time

from .. import device as D
from ..models import AggregationArgs, AggregationCircuit, CommitteeUpdateCircuit, StepCircuit
from ..observability import compilelog, tracing
from ..observability import manifest as obs_manifest
from ..ops import msm as MSM
from ..plonk.prover import PhaseTimer
from ..plonk.srs import SRS
from ..plonk.transcript import KeccakTranscript, PoseidonTranscript
from ..utils import faults
from ..utils.health import HEALTH
from ..utils.profiling import phase
from ..witness import default_committee_update_args, default_sync_step_args

KINDS = ("step", "committee")


class DeviceProveFailed(RuntimeError):
    """A prove failed on the device (out of memory, a kernel that does not
    build): the job fails; nothing retries it on the CPU."""

    def __init__(self, failure: str, exc: BaseException):
        super().__init__(f"device prove failed ({failure}): {type(exc).__name__}: {exc}")
        self.failure = failure


def device_failure(exc: BaseException) -> str | None:
    """'oom', 'compile' or the injected kind when `exc` is a failure of the
    device rather than of the witness; None otherwise."""
    if isinstance(exc, faults.InjectedFault) and exc.site == "backend.prove":
        return exc.kind
    text = str(exc).lower()
    if isinstance(exc, MemoryError) or (isinstance(exc, RuntimeError)
                                        and "out of memory" in text):
        return "oom"
    if isinstance(exc, RuntimeError) and "nvcc failed" in text:
        return "compile"
    return None


def _per_variant(k) -> dict:
    """An int (the reference's one k_agg) or {"step": k, "committee": k}."""
    if isinstance(k, int):
        return {kind: k for kind in KINDS}
    return {kind: int(k[kind]) for kind in KINDS}


class ProverState:
    # the circuits a state keys and proves (a subclass may name others)
    step_circuit = StepCircuit
    committee_circuit = CommitteeUpdateCircuit
    aggregation_circuit = AggregationCircuit

    def __init__(self, spec, k_step: int, k_committee: int, concurrency: int = 1,
                 device=None, params_dir: str | None = None, compress: bool = False,
                 k_agg=17, key_args: dict | None = None, pk_cache: bool = False,
                 self_check=None):
        """compress: the full two-stage flow (the app snark under Poseidon,
        verified in the aggregation circuit, whose proof is made under
        Keccak), the reference's `*Compressed` RPC semantics; boot then
        also keys both aggregation circuits from dummy app snarks
        (`cli.rs:241-280`). k_agg: the aggregation circuits' k, one int for
        both (the reference's) or one per variant, {"step": 21,
        "committee": 22} for the tracked testnet verifiers. key_args: the
        args each key is made from, {"step": ..., "committee": ...}, values
        or zero-arg callables (default: the default witnesses). pk_cache:
        load and write the keys in params_dir (AppCircuit.create_pk).
        self_check: the readiness check to run (default: the tiny circuit
        proved and verified on `device`)."""
        compilelog.install()
        self.spec = spec
        self.device = D.resolve(device)
        self.concurrency = concurrency
        self.semaphore = threading.Semaphore(concurrency)
        self.params_dir = params_dir      # also hosts the async job journal
        self.jobs = None                  # attached at serve time (jobs.ensure_jobs)
        self.compress = compress
        self.k_step, self.k_committee = k_step, k_committee
        self.k_agg = _per_variant(k_agg)
        self.boot_seconds: dict = {}
        key_args = dict(key_args or {})
        key_args.setdefault("step", lambda: default_sync_step_args(spec))
        key_args.setdefault("committee", lambda: default_committee_update_args(spec))

        self.srs = {}
        with self._boot("srs"):
            for k in sorted({k_step, k_committee}
                            | (set(self.k_agg.values()) if compress else set())):
                self.srs[k] = SRS.load_or_setup(k, params_dir, device=self.device)
        step, committee = self.step_circuit, self.committee_circuit
        with self._boot("step_pk"):
            self.step_pk = step.create_pk(
                self.srs[k_step], spec, k_step, key_args["step"], device=self.device,
                cache=pk_cache, cache_dir=params_dir)
        with self._boot("committee_pk"):
            self.committee_pk = committee.create_pk(
                self.srs[k_committee], spec, k_committee, key_args["committee"],
                device=self.device, cache=pk_cache, cache_dir=params_dir)
        self.step_agg = self.committee_agg = None
        self.step_agg_pk = self.committee_agg_pk = None
        if compress:
            self.step_agg = self.aggregation_circuit.variant(step.name)
            self.committee_agg = self.aggregation_circuit.variant(committee.name)
            # lazy thunks: a dummy inner proof is made only when the
            # aggregation key is not in the cache
            with self._boot("step_agg_pk"):
                self.step_agg_pk = self.step_agg.create_pk(
                    self.srs[self.k_agg["step"]], spec, self.k_agg["step"],
                    lambda: self._dummy_agg_args(step, self.step_pk, k_step,
                                                 default_sync_step_args(spec)),
                    device=self.device, cache=pk_cache, cache_dir=params_dir)
            with self._boot("committee_agg_pk"):
                self.committee_agg_pk = self.committee_agg.create_pk(
                    self.srs[self.k_agg["committee"]], spec, self.k_agg["committee"],
                    lambda: self._dummy_agg_args(committee, self.committee_pk, k_committee,
                                                 default_committee_update_args(spec)),
                    device=self.device, cache=pk_cache, cache_dir=params_dir)
        # readiness self-check: prove+verify a tiny circuit on this device
        # before the box reports ready — GET /healthz stays 503 until it
        # passes, and it re-runs after every SDC re-prove
        from .selfverify import SelfCheck
        self.self_check = self_check if self_check is not None \
            else SelfCheck(device=self.device)
        with self._boot("self_check"):
            self.self_check.run()

    @contextlib.contextmanager
    def _boot(self, name: str):
        """The boot step `name`: a phase span, an entry point of the kernel
        telemetry (its launches in compilelog.launches_by_entry()
        ["boot/<name>"]) and its seconds in boot_seconds."""
        t0 = time.perf_counter()
        with phase(f"boot/{name}"), compilelog.entry_point(f"boot/{name}"):
            yield
        self.boot_seconds[name] = time.perf_counter() - t0

    # -- the circuits of a kind ------------------------------------------------

    def _app(self, kind: str):
        if kind == "step":
            return self.step_circuit, self.step_pk, self.k_step
        if kind == "committee":
            return self.committee_circuit, self.committee_pk, self.k_committee
        raise ValueError(f"unknown proof kind {kind!r}")

    def _agg(self, kind: str):
        if kind == "step":
            return self.step_agg, self.step_agg_pk, self.k_agg["step"]
        return self.committee_agg, self.committee_agg_pk, self.k_agg["committee"]

    def _dummy_agg_args(self, circuit, pk, k, dummy_args):
        proof = circuit.prove(pk, self.srs[k], dummy_args, self.spec, device=self.device,
                              transcript=PoseidonTranscript())
        inst = circuit.get_instances(dummy_args, self.spec)
        return AggregationArgs(inner_vk=pk.vk, srs=self.srs[k], inner_instances=[inst],
                               proof=proof)

    # -- proving ---------------------------------------------------------------

    def _snark(self, circuit, pk, k: int, args, transcript=None, heartbeat=None) -> bytes:
        """One proof of `circuit` on the device: the witness, its layout at
        the key's shape, the prove, each its own span (the prover's phases
        as `snark/<phase>` children of `prove/snark`). `heartbeat` is
        stamped after the witness and after the layout: with the stamps at
        a prove's start and end, no gap spans more than one phase, so a
        dispatcher lease longer than the longest phase holds across a
        prove that takes minutes on the card (the reference stamps only at
        the start and end)."""
        hb = heartbeat or (lambda: None)
        with phase("prove/witness"):
            ctx = circuit.build_context(args, self.spec, self.device)
        hb()
        with phase("prove/layout"):
            ctx.layout(pk.vk.config)
        hb()
        timer = PhaseTimer(self.device)
        with phase("prove/snark"):
            proof = circuit.prove(pk, self.srs[k], args, self.spec, device=self.device,
                                  ctx=ctx, timer=timer, transcript=transcript)
            for name, secs in timer.seconds.items():
                tracing.add_completed_span(f"snark/{name}", secs)
        return proof

    def _compressed(self, circuit, pk, k: int, agg_cls, agg_pk, k_agg: int, args,
                    heartbeat=None):
        """The app snark under Poseidon, then the aggregation circuit
        verifying it, proved under Keccak. Returns (outer proof, the
        statement: 12 accumulator limbs, then the app instances)."""
        hb = heartbeat or (lambda: None)
        with phase("prove/app_snark"):
            app_proof = self._snark(circuit, pk, k, args, PoseidonTranscript(), hb)
        hb()              # phase boundary: app snark done, aggregation next
        inst = circuit.get_instances(args, self.spec)
        agg_args = AggregationArgs(inner_vk=pk.vk, srs=self.srs[k], inner_instances=[inst],
                                   proof=app_proof, heartbeat=hb)
        with phase("prove/aggregation"):
            # the aggregation's build (its witness) is minutes at the
            # testnet k: the args carry the heartbeat into it, stamped
            # between the in-circuit verifier's steps and the MSM's windows
            outer = self._snark(agg_cls, agg_pk, k_agg, agg_args, KeccakTranscript(), hb)
        hb()
        return outer, agg_cls.get_instances(agg_args, self.spec)

    def _release_idle_ext_caches(self, *active_pks):
        """Drop the MSM fixed-base tables and expanded bases of every SRS but
        those of the keys about to prove: the caches that outlive a prove
        in the port (the extended-domain cache lives for one prove) are
        gigabytes at the testnet degrees and would otherwise stack across
        circuit families."""
        keep = set()
        for kind in KINDS:
            _, pk, k = self._app(kind)
            if any(pk is a for a in active_pks):
                keep.add(self.srs[k].digest())
            _, agg_pk, k_agg = self._agg(kind)
            if agg_pk is not None and any(agg_pk is a for a in active_pks):
                keep.add(self.srs[k_agg].digest())
        MSM.release_tables(keep)

    def _prove(self, kind: str, args, heartbeat=None) -> tuple[bytes, list]:
        hb = heartbeat or (lambda: None)
        circuit, pk, k = self._app(kind)
        agg_cls, agg_pk, k_agg = self._agg(kind)
        with self.semaphore:
            hb()                     # phase: permit acquired, prove starts
            self._release_idle_ext_caches(pk, agg_pk)
            try:
                faults.check("backend.prove")
                if self.compress:
                    return self._compressed(circuit, pk, k, agg_cls, agg_pk, k_agg, args,
                                            heartbeat=hb)
                proof = self._snark(circuit, pk, k, args, heartbeat=hb)
            except Exception as exc:
                failure = device_failure(exc)
                if failure is None:
                    raise
                HEALTH.incr(f"prove_device_failures_{failure}")
                tracing.annotate(device_failure=failure)
                obs_manifest.record_event("device_prove_failed", failure_kind=failure,
                                          device=str(self.device))
                raise DeviceProveFailed(failure, exc) from exc
            hb()
        return proof, circuit.get_instances(args, self.spec)

    def prove_step(self, args, heartbeat=None) -> tuple[bytes, list]:
        """`heartbeat` (optional zero-arg callback, threaded in by the job
        queue's worker) is stamped between prove phases so the supervisor
        can tell a long legitimate prove from a hung worker."""
        return self._prove("step", args, heartbeat)

    def prove_committee(self, args, heartbeat=None) -> tuple[bytes, list]:
        return self._prove("committee", args, heartbeat)

    def verify_proof(self, kind: str, proof: bytes, instances: list) -> bool:
        """Host-side check of a fresh proof against the matching verifying
        key, the verify-before-serve of selfverify.verified_prove. `kind`
        is "step" or "committee"; `instances`, the flat public inputs the
        prove returned."""
        if self.compress:
            agg, agg_pk, k_agg = self._agg(kind)
            return bool(agg.verify(agg_pk.vk, self.srs[k_agg], instances, proof,
                                   device=self.device, transcript_cls=KeccakTranscript))
        circuit, pk, k = self._app(kind)
        return bool(circuit.verify(pk.vk, self.srs[k], instances, proof, device=self.device))
