"""The port's prover CLI (the port's copy of
`spectre_tpu/prover_service/cli.py`).

Reference parity: `prover/src/args.rs:32-170` + `cli.rs:35-242`:
  circuit {sync-step,committee-update}[-compressed]
          {setup,prove,verify,gen-verifier}  -- keys, proofs, the verifier
  rpc                                        -- serve the JSON-RPC API
                                                (a farm head or replica)
  follow                                     -- the light-client follower
  utils committee-poseidon                   -- deployment bootstrap values
plus `faults` (the fault-site registry) and `scrub` (one offline artifact
scrubber pass). `--device {cuda,cpu}` (default cuda) takes the place of the
reference's `--backend {cpu,tpu}`; `--spec {tiny,minimal,testnet,mainnet}`
selects the network (`main.rs:27-57`). Both may come before or after the
subcommand.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .. import spec as spec_mod


def _spec(name):
    return spec_mod.SPECS[name]


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m spectre_tpu_torch.prover_service")
    p.add_argument("--spec", default="minimal", choices=list(spec_mod.SPECS))
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where keys are made and proofs run (default cuda)")
    # the same two flags after the subcommand; unset there, they keep the
    # value given (or defaulted) before it
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--spec", default=argparse.SUPPRESS, choices=list(spec_mod.SPECS))
    common.add_argument("--device", default=argparse.SUPPRESS, choices=["cuda", "cpu"])
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("circuit", parents=[common], help="circuit lifecycle")
    c.add_argument("which", choices=["sync-step", "committee-update",
                                     "sync-step-compressed",
                                     "committee-update-compressed"])
    c.add_argument("action", choices=["setup", "prove", "verify", "gen-verifier"])
    c.add_argument("--k", type=int, default=17)
    c.add_argument("--compress", action="store_true",
                   help="the two-stage (aggregated) flow, as the -compressed names")
    c.add_argument("--k-agg", type=int, default=17,
                   help="aggregation circuit degree (compressed variants)")
    c.add_argument("--witness", help="witness JSON path (default: mock witness)")
    c.add_argument("--proof-out", default="proof.bin")
    c.add_argument("--proof-in")
    c.add_argument("--sol-out", help="Solidity output path "
                   "(default: build/<name>_<spec>_<k>_verifier.sol)")

    r = sub.add_parser("rpc", parents=[common], help="serve the JSON-RPC prover API")
    r.add_argument("--host", default="127.0.0.1")
    r.add_argument("--port", type=int, default=3000)
    r.add_argument("--k-step", type=int, default=17)
    r.add_argument("--k-committee", type=int, default=17)
    r.add_argument("--concurrency", type=int, default=1)
    r.add_argument("--compress", action="store_true",
                   help="serve two-stage (aggregated) EVM proofs")
    r.add_argument("--k-agg", type=int, default=17,
                   help="aggregation circuit degree of both variants")
    r.add_argument("--k-agg-step", type=int, default=None,
                   help="the step's aggregation degree (default --k-agg; 21 for "
                   "the tracked testnet verifier)")
    r.add_argument("--k-agg-committee", type=int, default=None,
                   help="the committee's aggregation degree (default --k-agg; 22 "
                   "for the tracked testnet verifier)")
    r.add_argument("--params-dir", help="SRS and key cache dir; also hosts the "
                   "crash-safe async job journal (jobs.journal.jsonl)")
    r.add_argument("--pk-cache", action="store_true",
                   help="load the keys from --params-dir when they are there, "
                   "else write them there after keygen")
    r.add_argument("--job-timeout", type=float, default=None,
                   help="default per-job deadline in seconds for async "
                   "submitProof_* jobs (default: none)")
    r.add_argument("--queue-depth", type=int, default=None,
                   help="admission-control backlog bound; a full queue "
                   "sheds submits with -32001/429 + Retry-After "
                   "(default: $SPECTRE_JOB_QUEUE_DEPTH or 64)")
    r.add_argument("--mem-watermark-mb", type=float, default=None,
                   help="shed new submissions once RSS exceeds this "
                   "(default: $SPECTRE_MEM_WATERMARK_MB; 0 disables)")
    r.add_argument("--worker-stall-s", type=float, default=None,
                   help="supervisor stall threshold: a worker whose "
                   "heartbeat is older than this is replaced and its job "
                   "failed (default: $SPECTRE_WORKER_STALL_S or 600)")
    r.add_argument("--trace-dir", default=None,
                   help="write each completed job's span tree as Chrome "
                   "trace-event JSON (<job_id>.trace.json) under this "
                   "directory (default: $SPECTRE_TRACE_DIR; unset disables "
                   "the file sink — getTrace still serves the in-memory ring)")
    r.add_argument("--replicas", default=None,
                   help="comma-separated prover replica URLs (default "
                   "$SPECTRE_REPLICAS): serve as a proof-farm dispatcher over "
                   "them; the local state only cross-verifies their proofs")
    r.add_argument("--replica-id", default=None,
                   help="this server's replica id within a farm (default "
                   "$SPECTRE_REPLICA_ID); stamped into RPC errors")
    r.add_argument("--lease-s", type=float, default=None,
                   help="dispatcher lease in seconds (default "
                   "$SPECTRE_REPLICA_LEASE_S or 120): a replica owns a job "
                   "only while its heartbeat renews within this window")
    r.add_argument("--announce-to", default=None,
                   help="dispatcher head URL to announce this replica to "
                   "(default $SPECTRE_ANNOUNCE_URL): joins the farm through "
                   "registerReplica with a capability record + heartbeat")
    r.add_argument("--announce-interval", type=float, default=None,
                   help="seconds between announce heartbeats (default "
                   "$SPECTRE_ANNOUNCE_INTERVAL_S or 15)")
    r.add_argument("--advertise-url", default=None,
                   help="URL the dispatcher dials back (default "
                   "http://<host>:<port> of this server; set behind a proxy)")
    r.add_argument("--ttl-s", type=float, default=None,
                   help="dispatcher-side heartbeat TTL of announced members "
                   "(default $SPECTRE_REPLICA_TTL_S or 60): a silent replica "
                   "is demoted through its breaker and deregistered")

    f = sub.add_parser("follow", parents=[common], help="run the light-client "
                       "follower: track the beacon head, prove steps and "
                       "committee updates, serve verified updates over the "
                       "RPC API")
    f.add_argument("--beacon-api", required=True,
                   help="Beacon REST base URL; a comma-separated list polls a "
                   "quorum (2-of-N agreement on the finalized head)")
    f.add_argument("--beacon-quorum", type=int, default=None,
                   help="matching finalized heads required (default "
                   "$SPECTRE_BEACON_QUORUM or 2, clamped to the pool size)")
    f.add_argument("--params-dir", required=True,
                   help="SRS and key dir; hosts the job journal and the "
                   "follower's verified update store (follower.updates.jsonl "
                   "+ results/)")
    f.add_argument("--host", default="127.0.0.1")
    f.add_argument("--port", type=int, default=3000)
    f.add_argument("--poll-s", type=float, default=None,
                   help="beacon poll cadence (default $SPECTRE_FOLLOW_POLL_S or 12)")
    f.add_argument("--backfill", type=int, default=None,
                   help="max committee-update periods queued per poll "
                   "(default $SPECTRE_FOLLOW_BACKFILL or 8)")
    f.add_argument("--domain", default=None,
                   help="sync-committee signing domain (hex); step proofs are "
                   "disabled without it")
    f.add_argument("--pubkeys-file", default=None,
                   help="JSON list of compressed pubkey hex strings of the "
                   "current committee; step proofs are disabled without it")
    f.add_argument("--k-step", type=int, default=17)
    f.add_argument("--k-committee", type=int, default=17)
    f.add_argument("--k-agg", type=int, default=17)
    f.add_argument("--concurrency", type=int, default=1)
    f.add_argument("--compress", action="store_true",
                   help="prove two-stage (aggregated) EVM proofs")
    f.add_argument("--pk-cache", action="store_true",
                   help="load the keys from --params-dir when they are there")
    f.add_argument("--job-timeout", type=float, default=None)
    f.add_argument("--queue-depth", type=int, default=None)
    f.add_argument("--gateway", action="store_true",
                   help="mount the cacheable GET /v1/* read plane: "
                   "content-addressed ETags, 304s, immutable cache headers "
                   "on sealed periods, update-range packs")
    f.add_argument("--pack-periods", type=int, default=None,
                   help="periods per sealed update pack (default "
                   "$SPECTRE_PACK_PERIODS or 8)")
    f.add_argument("--agg-cadence", type=int, default=None,
                   help="publish an EVM-verifiable aggregation proof every N "
                   "sealed committee periods (default "
                   "$SPECTRE_AGG_CADENCE_PERIODS or 0 = off)")
    f.add_argument("--gateway-cache-mb", type=float, default=None,
                   help="gateway hot-cache byte budget in MB (default "
                   "$SPECTRE_GATEWAY_CACHE_MB or 64)")

    u = sub.add_parser("utils", parents=[common], help="deployment utilities")
    u.add_argument("util", choices=["committee-poseidon"])
    u.add_argument("--beacon-api", help="Beacon REST base URL")

    fl = sub.add_parser("faults", help="fault-injection site registry")
    fl.add_argument("--list", action="store_true",
                    help="print the site table (markdown)")
    fl.add_argument("--json", action="store_true",
                    help="machine-readable sites + kinds")

    s = sub.add_parser("scrub", help="offline artifact scrub: re-hash every "
                       "results/ file against its content address, "
                       "quarantine rot, expire journal orphans")
    s.add_argument("--params-dir", required=True,
                   help="the dir hosting the job journal + results/ store")
    s.add_argument("--min-age-s", type=float, default=0.0,
                   help="only expire orphans older than this (default 0: "
                   "the service is assumed stopped; the in-service scrubber "
                   "defaults to $SPECTRE_SCRUB_MIN_AGE_S or 60)")
    return p


def main(argv=None):
    args = _parser().parse_args(argv)
    spec = _spec(args.spec)
    if args.cmd == "circuit":
        _circuit_cmd(args, spec)
    elif args.cmd == "rpc":
        _rpc_cmd(args, spec)
    elif args.cmd == "follow":
        _follow_cmd(args, spec)
    elif args.cmd == "utils":
        _utils_cmd(args, spec)
    elif args.cmd == "faults":
        _faults_cmd(args)
    elif args.cmd == "scrub":
        _scrub_cmd(args)


def _rpc_cmd(args, spec):
    from ..observability import compilelog
    from ..observability.tracing import TRACE_DIR_ENV
    from .rpc import serve
    from .state import ProverState

    # kernel-build telemetry before the first build: boot's builds land in
    # spectre_kernel_build_seconds, a served prove's manifest shows none
    compilelog.install()
    print(f"loading prover state (spec={spec.name}, device={args.device})...", flush=True)
    state = ProverState(spec, args.k_step, args.k_committee, args.concurrency, args.device,
                        params_dir=args.params_dir, compress=args.compress,
                        k_agg={"step": args.k_agg_step or args.k_agg,
                               "committee": args.k_agg_committee or args.k_agg},
                        pk_cache=args.pk_cache)
    print(f"serving on {args.host}:{args.port} (async jobs journaled under "
          f"{args.params_dir or 'params_dir unset: in-memory only'}); boot seconds "
          + json.dumps({k: round(v, 3) for k, v in state.boot_seconds.items()}), flush=True)
    if args.trace_dir is not None:
        os.environ[TRACE_DIR_ENV] = args.trace_dir
    queue_kw = {}
    if args.queue_depth is not None:
        queue_kw["queue_depth"] = args.queue_depth
    if args.mem_watermark_mb is not None:
        queue_kw["mem_watermark_mb"] = args.mem_watermark_mb
    if args.worker_stall_s is not None:
        queue_kw["stall_timeout"] = args.worker_stall_s
    dispatcher = None
    replicas_raw = args.replicas or os.environ.get("SPECTRE_REPLICAS")
    if replicas_raw or args.ttl_s is not None:
        # a proof-farm head: jobs route to the replicas (static ones from
        # --replicas, announced ones through registerReplica); the local
        # state only cross-verifies what they return
        from .dispatcher import Dispatcher, HttpReplica
        from .rpc_client import ProverClient
        urls = [u.strip() for u in (replicas_raw or "").split(",") if u.strip()]
        dispatcher = Dispatcher(
            replicas=[HttpReplica(url, ProverClient(url)) for url in urls],
            journal_dir=args.params_dir, lease_s=args.lease_s, ttl_s=args.ttl_s,
            verify_state=state)
        print(f"dispatching over {len(urls)} static replicas + announced ones "
              f"(lease {dispatcher.lease_s:g}s, heartbeat TTL "
              f"{dispatcher.ttl_s:g}s, cross-verify on)", flush=True)
    serve(state, args.host, args.port, job_timeout=args.job_timeout,
          dispatcher=dispatcher, replica_id=args.replica_id,
          announce=args.announce_to, announce_interval=args.announce_interval,
          advertise_url=args.advertise_url, **queue_kw)


def _follow_cmd(args, spec):
    """The follower: beacon head tracking and proof scheduling in the
    foreground, the RPC serving API (getLightClientUpdate, and the gateway
    with --gateway) in the background of the same process. Proves run on
    --device (default cuda)."""
    import threading

    from ..follower import Follower
    from ..observability import compilelog
    from ..preprocessor.beacon import BeaconClient, BeaconQuorum
    from .jobs import ensure_jobs
    from .rpc import serve
    from .state import ProverState

    compilelog.install()
    pubkeys = None
    if args.pubkeys_file:
        with open(args.pubkeys_file) as fh:
            pubkeys = json.load(fh)
    domain = args.domain
    if not (pubkeys and domain):
        print("step proofs disabled (need both --pubkeys-file and --domain); "
              "following committee updates only", flush=True)
    print(f"loading prover state (spec={spec.name}, device={args.device})...", flush=True)
    state = ProverState(spec, args.k_step, args.k_committee, args.concurrency, args.device,
                        params_dir=args.params_dir, compress=args.compress,
                        k_agg=args.k_agg, pk_cache=args.pk_cache)
    queue_kw = {}
    if args.queue_depth is not None:
        queue_kw["queue_depth"] = args.queue_depth
    jobs = ensure_jobs(state, journal_dir=args.params_dir,
                       default_timeout=args.job_timeout, **queue_kw)
    beacon_urls = [u.strip() for u in args.beacon_api.split(",") if u.strip()]
    if len(beacon_urls) > 1:
        # the follower acts only on a finalized head a quorum of beacons
        # agree on; a lone dissenting beacon is demoted behind its breaker
        beacon = BeaconQuorum([BeaconClient(u) for u in beacon_urls],
                              quorum=args.beacon_quorum)
        print(f"beacon quorum: {beacon.quorum}-of-{len(beacon_urls)}", flush=True)
    else:
        beacon = BeaconClient(beacon_urls[0])
    publisher = None
    if args.agg_cadence:
        # publish through the Spectre contract's model; an
        # EvmProofVerifier-backed contract gates it on the generated verifier
        from ..contracts.spectre import SpectreContract
        from ..follower.scheduler import AggregationPublisher
        publisher = AggregationPublisher(SpectreContract(spec, 0, 0))
        print(f"aggregation cadence: every {args.agg_cadence} sealed periods", flush=True)
    fol = Follower(spec, beacon, jobs, directory=args.params_dir, pubkeys=pubkeys,
                   domain=domain, backfill=args.backfill,
                   cadence_periods=args.agg_cadence, publisher=publisher)
    gateway = None
    if args.gateway:
        from ..gateway import Gateway
        gateway = Gateway(fol.store, pack_periods=args.pack_periods,
                          cache_mb=args.gateway_cache_mb)
        print(f"gateway mounted on /v1/* (pack_periods={gateway.packs.pack_periods}, "
              f"cache {gateway.cache.budget >> 20} MB)", flush=True)
    serve(state, args.host, args.port, background=True, journal_dir=args.params_dir,
          job_timeout=args.job_timeout, follower=fol, gateway=gateway, **queue_kw)
    print(f"following {args.beacon_api}; serving light-client updates on "
          f"{args.host}:{args.port}", flush=True)
    stop = threading.Event()
    try:
        fol.run(stop, poll_s=args.poll_s)
    except KeyboardInterrupt:
        stop.set()


def _faults_cmd(args):
    """Print the fault-site registry: `--list` is the markdown table;
    `--json` the raw registry for tooling."""
    from ..utils import faults
    if args.json:
        print(json.dumps({"sites": {k: {"module": m, "injects": d}
                                    for k, (m, d) in faults.SITES.items()},
                          "kinds": list(faults.KINDS)}, indent=2))
    else:
        print(faults.render_site_table())


def _scrub_cmd(args):
    """One offline scrubber pass: replay the journals (the job journal, and
    the follower's update store and the gateway's packs when the directory
    holds them) to learn which digests are live, then
    re-hash/quarantine/expire the store."""
    from ..observability.manifest import MANIFEST_SUFFIX
    from ..utils.artifacts import ArtifactStore
    from .jobs import JobJournal
    from .scrubber import Scrubber

    jobs = JobJournal(args.params_dir).replay()
    live = set()
    for job in jobs.values():
        if job.result_digest is not None:
            live.add((job.result_digest, ".bin"))
        if job.manifest_digest is not None:
            live.add((job.manifest_digest, MANIFEST_SUFFIX))
    # a follower's params dir keeps its verified updates (and the
    # gateway's update-range packs) in the same artifact store: replay
    # those journals too, or an offline pass expires the whole chain
    from ..follower.updates import JOURNAL_NAME, UpdateStore
    if os.path.exists(os.path.join(args.params_dir, JOURNAL_NAME)):
        from ..gateway.packs import PackBuilder
        ustore = UpdateStore(args.params_dir)
        live |= ustore.live_artifacts()
        live |= PackBuilder(ustore).live_artifacts()
    store = ArtifactStore(args.params_dir)
    summary = Scrubber(store, lambda: live, min_age_s=args.min_age_s).scrub()
    summary["live"] = len(live)
    print(json.dumps(summary))


def _circuit_cmd(args, spec):
    from ..models import CommitteeUpdateCircuit, StepCircuit
    from ..plonk.srs import SRS
    from ..witness import default_committee_update_args, default_sync_step_args

    compressed = args.compress or args.which.endswith("-compressed")
    base = args.which.removesuffix("-compressed")
    circuit = StepCircuit if base == "sync-step" else CommitteeUpdateCircuit
    default_args = (default_sync_step_args if base == "sync-step"
                    else default_committee_update_args)(spec)
    dev = args.device
    srs = SRS.load_or_setup(args.k, device=dev)
    pk = circuit.create_pk(srs, spec, args.k, default_args, device=dev, cache=True)

    if args.action == "setup" and not compressed:
        print(f"pk ready: {circuit.pk_path(spec, args.k)}")
        return

    witness_args = default_args
    if args.witness:
        with open(args.witness) as f:
            data = json.load(f)
        witness_args = _witness_from_json(base, data)

    if compressed:
        _compressed_circuit_cmd(args, spec, circuit, pk, srs, default_args, witness_args)
        return

    if args.action == "gen-verifier":
        # reference: `spectre-prover circuit ... gen-verifier`
        # (`util/circuit.rs:182-194`)
        from ..evm import gen_evm_verifier
        from ..models.app_circuit import BUILD_DIR
        n_inst = len(circuit.get_instances(default_args, spec))
        src = gen_evm_verifier(pk.vk, srs, num_instances=n_inst,
                               contract_name=f"Verifier_{circuit.name}")
        out = args.sol_out or os.path.join(
            BUILD_DIR, f"{circuit.name}_{spec.name}_{args.k}_verifier.sol")
        _write_text(out, src)
        print(json.dumps({"verifier": out, "bytes": len(src)}))
        return
    if args.action == "prove":
        proof = circuit.prove(pk, srs, witness_args, spec, device=dev)
        with open(args.proof_out, "wb") as f:
            f.write(proof)
        instances = circuit.get_instances(witness_args, spec)
        print(json.dumps({"proof": args.proof_out, "bytes": len(proof),
                          "instances": [hex(v) for v in instances]}))
    elif args.action == "verify":
        with open(args.proof_in or args.proof_out, "rb") as f:
            proof = f.read()
        instances = circuit.get_instances(witness_args, spec)
        ok = circuit.verify(pk.vk, srs, instances, proof, device=dev)
        print(json.dumps({"valid": bool(ok)}))
        sys.exit(0 if ok else 1)


def _write_text(path: str, text: str):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(text)


def _compressed_circuit_cmd(args, spec, circuit, pk, srs, default_args, witness_args):
    """Two-stage lifecycle (the reference's `sync-step-compressed` CLI
    paths): app snark (Poseidon transcript) -> aggregation circuit -> outer
    proof (Keccak for the EVM calldata path)."""
    from ..models import AggregationArgs, AggregationCircuit
    from ..plonk.srs import SRS
    from ..plonk.transcript import KeccakTranscript, PoseidonTranscript

    dev = args.device
    agg_cls = AggregationCircuit.variant(circuit.name)
    srs_agg = SRS.load_or_setup(args.k_agg, device=dev)

    def agg_args_for(wargs):
        proof = circuit.prove(pk, srs, wargs, spec, device=dev,
                              transcript=PoseidonTranscript())
        inst = circuit.get_instances(wargs, spec)
        return AggregationArgs(inner_vk=pk.vk, srs=srs, inner_instances=[inst], proof=proof)

    agg_pk = agg_cls.create_pk(srs_agg, spec, args.k_agg, lambda: agg_args_for(default_args),
                               device=dev, cache=True)
    if args.action == "setup":
        print(f"pk ready: {agg_cls.pk_path(spec, args.k_agg)}")
        return
    if args.action == "gen-verifier":
        from ..evm import gen_evm_verifier
        from ..models.app_circuit import BUILD_DIR
        # statement = 12 accumulator limbs + the app instances (no proving
        # needed to size it)
        n_inst = 12 + len(circuit.get_instances(default_args, spec))
        src = gen_evm_verifier(agg_pk.vk, srs_agg, num_instances=n_inst,
                               contract_name=f"Verifier_{agg_cls.name}", num_acc_limbs=12)
        out = args.sol_out or os.path.join(
            BUILD_DIR, f"{agg_cls.name}_{spec.name}_{args.k_agg}_verifier.sol")
        _write_text(out, src)
        print(json.dumps({"verifier": out, "bytes": len(src)}))
        return
    inst_path = args.proof_out + ".instances.json"
    if args.action == "prove":
        agg_args = agg_args_for(witness_args)
        proof = agg_cls.prove(agg_pk, srs_agg, agg_args, spec, device=dev,
                              transcript=KeccakTranscript())
        instances = AggregationCircuit.get_instances(agg_args, spec)
        with open(args.proof_out, "wb") as f:
            f.write(proof)
        # the statement binds the (blinded, non-reproducible) app proof:
        # persist it next to the outer proof for later verification
        with open(inst_path, "w") as f:
            json.dump({"instances": [hex(v) for v in instances]}, f)
        print(json.dumps({"proof": args.proof_out, "bytes": len(proof),
                          "instances": inst_path}))
    elif args.action == "verify":
        with open(args.proof_in or args.proof_out, "rb") as f:
            proof = f.read()
        with open((args.proof_in or args.proof_out) + ".instances.json") as f:
            instances = [int(v, 16) for v in json.load(f)["instances"]]
        ok = agg_cls.verify(agg_pk.vk, srs_agg, instances, proof, device=dev,
                            transcript_cls=KeccakTranscript)
        print(json.dumps({"valid": bool(ok)}))
        sys.exit(0 if ok else 1)


def _witness_from_json(which: str, data: dict):
    from ..preprocessor.rotation import rotation_args_from_update
    if which == "sync-step":
        raise SystemExit("sync-step witness JSON requires the update+pubkeys "
                         "format; use the rpc API or the preprocessor directly")
    return rotation_args_from_update(data, _spec(data.get("spec", "minimal")))


def _utils_cmd(args, spec):
    from ..fields import bls12_381 as bls
    from ..gadgets.poseidon_commit import committee_poseidon_from_uncompressed
    from .beacon_helpers import fetch_bootstrap_committee

    if not args.beacon_api:
        raise SystemExit("--beacon-api required")
    period, root, pubkeys = fetch_bootstrap_committee(args.beacon_api, spec)
    pts = [bls.g1_decompress(pk) for pk in pubkeys]
    commitment = committee_poseidon_from_uncompressed(pts)
    print(json.dumps({
        "sync_period": period,
        "committee_ssz_root": "0x" + root.hex(),
        "committee_poseidon": hex(commitment),
    }))


if __name__ == "__main__":
    main()
