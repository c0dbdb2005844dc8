#!/usr/bin/env python3
"""Where the time of one spectre_tpu_torch prove goes, on one CUDA GPU.

    python3 scripts/torch_prove_profile.py            # k = 21 (sync-step testnet shape)
    python3 scripts/torch_prove_profile.py --k 19
    python3 scripts/torch_prove_profile.py --circuit committee
    python3 scripts/torch_prove_profile.py --circuit step
    python3 scripts/torch_prove_profile.py --circuit aggregation
    python3 scripts/torch_prove_profile.py --circuit step-aggregation
    python3 scripts/torch_prove_profile.py --circuit committee --transcripts blake2b,poseidon
    python3 scripts/torch_prove_profile.py --circuit committee --transcript poseidon \
        --modes default,fourstep+matmul+mxu
    python3 scripts/torch_prove_profile.py --circuit step --sigma-merge   # host only

Builds the kernels, sets up the SRS and the key, proves once untraced
(per-phase seconds, peak device memory), then once more under
torch.profiler. The circuit is the seeded flex-gate witness at the pinned
shape of build/sync_step_testnet_21.pinning.json, or (--circuit committee)
the CommitteeUpdateCircuit at build/committee_update_testnet_18.pinning.json
(512 pubkeys, k=18, witness from default_committee_update_args), or
(--circuit step) the StepCircuit at the same k=21 pinning (512 pubkeys,
witness from default_sync_step_args), or (--circuit aggregation) stage 2:
the committee's stage-1 proof under the Poseidon transcript, aggregated at
build/aggregation_committee_update_testnet_22.pinning.json (k=22) and the
outer circuit proved under the Keccak transcript (its set-up seconds are
printed, and the outer proof must pass AggregationCircuit.verify), or
(--circuit step-aggregation) the same for the step's stage-1 proof at the
outer k that models.aggregation.outer_k, the reference flow's rule, gives (21: 11
advice, 2 lookup columns; the step's k=21 SRS). Prints the
device's busy and idle share of the traced prove, per-phase seconds, the
device time and launches of each of the port's kernels, the top device rows
by time, then the same as one JSON line. Exits non-zero without CUDA.
The MSMs run in the mode SPECTRE_MSM_MODE names (vanilla by default); under
fixed, the untraced prove builds the window table and the traced one
reuses it.

--transcripts a,b: before the traced prove, the same witness and key are
proved untraced under each named transcript, in the order given and then
reversed (a, b, b, a), and the mean seconds of each phase under each are
printed, so that two transcripts are compared within one run.

--modes a,b: the same witness, key and blinding seed proved untraced under
each named knob set ("default", a name of chip_smoke.py's MODES, such as
fourstep+matmul+mxu, or "mesh": the default knobs on a 2x2 ShardingPlan of
four virtual shards of the card, chip_smoke.py's mesh phase's plan), in
the order given and then reversed (a, b, b, a);
every proof must equal the first byte for byte. Prints the mean seconds of
each phase under each, each prove's phases and launches, and exits.
--transcript names the transcript of every prove (default blake2b; the
app circuits' stage-1 proofs are Poseidon's).

--sigma-merge: host only, no GPU needed. Keygen's copy-cycle merge of the
circuit's copies (flex, committee or step) in Python and in host C++: the
seconds of each and whether they give the same targets (then the sigma
columns, and with them the verifying key's digest, are the same). Prints one
JSON line; exits non-zero if the targets differ.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRANSCRIPTS = ("blake2b", "poseidon", "keccak")


def sigma_merge(args) -> int:
    """The host merge in Python and in C++ on the circuit's copies."""
    import numpy as np

    sys.path.insert(0, REPO)
    from spectre_tpu_torch import spec as SPEC
    from spectre_tpu_torch.plonk.constraint_system import sigma_targets

    t0 = time.perf_counter()
    if args.circuit == "flex":
        from spectre_tpu_torch.witness import config_from_pinning, flex_circuit
        cfg = config_from_pinning(os.path.join(REPO, "build", "sync_step_testnet_21.pinning.json"),
                                  args.k)
        copies = flex_circuit(cfg, seed=args.seed).copies
    else:
        from spectre_tpu_torch.models import CommitteeUpdateCircuit, StepCircuit
        from spectre_tpu_torch.witness import (default_committee_update_args,
                                               default_sync_step_args)
        circuit, k, make_args = {
            "committee": (CommitteeUpdateCircuit, 18, default_committee_update_args),
            "step": (StepCircuit, 21, default_sync_step_args)}[args.circuit]
        c_args = make_args(SPEC.TESTNET)
        ctx = circuit.build_context(c_args, SPEC.TESTNET, device="cpu")
        cfg = circuit.pinning(SPEC.TESTNET, k, ctx).config
        copies = ctx.assignment(cfg).copies
        del ctx
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    native = sigma_targets(cfg, copies, native=True)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = sigma_targets(cfg, copies)
    plain_s = time.perf_counter() - t0
    equal = all(np.array_equal(p, q) for p, q in zip(plain, native))
    print(json.dumps({"circuit": args.circuit, "k": cfg.k, "copies": len(copies),
                      "setup_s": setup_s, "plain_s": plain_s, "native_s": native_s,
                      "targets_equal": equal}), flush=True)
    return 0 if equal else 1


def compare_modes(torch, names: list, one_prove, dev, PhaseTimer, KL) -> int:
    """Untraced proves under each knob set of names, a, b, b, a, each
    proof held to the first; prints each prove and the mean seconds of
    each phase a knob set. Returns 1 if a proof differs."""
    sys.path.insert(0, REPO)
    import chip_smoke as C
    from spectre_tpu_torch.ops import msm as MSM, ntt as NTT
    from spectre_tpu_torch.parallel import make_mesh, plan_for_mesh
    from spectre_tpu_torch.plonk.backend import TorchBackend

    unknown = [m for m in names if m not in ("default", "mesh") and m not in C.MODES]
    if unknown:
        print(f"torch_prove_profile: unknown knob sets {unknown}", file=sys.stderr)
        return 2
    plan = plan_for_mesh(make_mesh(devices=[dev] * 4, data_axis=2))
    runs, first = {m: [] for m in names}, None
    for name in names + names[::-1]:
        MSM.clear_tables()
        NTT.clear_tables()
        plan.clear()
        torch.cuda.empty_cache()
        timer = PhaseTimer(dev)
        with C.knobs(C.MODES[name]["env"] if name in C.MODES else {}):
            torch.cuda.synchronize()
            KL.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            proof = one_prove(timer, backend=TorchBackend(dev, plan=plan)
                              if name == "mesh" else None)
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
            counts = {k: v for k, v in KL.launch_counts().items() if v}
        first = proof if first is None else first
        if proof != first:
            print(f"torch_prove_profile: the {name} proof differs from the first",
                  file=sys.stderr)
            return 1
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        runs[name].append(dict(timer.seconds, total=total, peak_gib=peak))
        print(f"{name}: prove {total:.3f} s, peak {peak:.1f} GiB; phases "
              + json.dumps({k: round(v, 3) for k, v in timer.seconds.items()})
              + "; launches " + json.dumps(counts), flush=True)
    means = {name: {key: sum(r[key] for r in rs) / len(rs) for key in rs[0]}
             for name, rs in runs.items()}
    print("modes, mean seconds a phase (order " + ",".join(names + names[::-1])
          + ", equal proofs): " + json.dumps({"modes": means, "runs": runs}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, default=None, help="rows of the flex circuit")
    ap.add_argument("--circuit", default="flex",
                    choices=("flex", "committee", "step", "aggregation", "step-aggregation"))
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--transcripts", default=None,
                    help="comma list of " + ",".join(TRANSCRIPTS)
                    + ": untraced proves under each, a, b, b, a")
    ap.add_argument("--transcript", default="blake2b", choices=TRANSCRIPTS,
                    help="the transcript of every prove")
    ap.add_argument("--modes", default=None,
                    help="comma list of knob sets (default, mesh or chip_smoke.py's MODES): "
                         "untraced proves under each, a, b, b, a, then exit")
    ap.add_argument("--sigma-merge", action="store_true",
                    help="host only: keygen's copy-cycle merge in Python and in C++")
    args = ap.parse_args(argv)
    compare = args.transcripts.split(",") if args.transcripts else []
    if any(t not in TRANSCRIPTS for t in compare):
        ap.error(f"--transcripts: expected names among {TRANSCRIPTS}")
    if args.sigma_merge:
        if args.circuit not in ("flex", "committee", "step"):
            ap.error("--sigma-merge: flex, committee or step")
        return sigma_merge(args)

    import torch
    if not torch.cuda.is_available():
        print("torch_prove_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from spectre_tpu_torch.fields import bn254
    from spectre_tpu_torch.ops import kernel_lib as KL, msm as MSM
    from spectre_tpu_torch.plonk.backend import TorchBackend
    from spectre_tpu_torch.plonk.keygen import keygen
    from spectre_tpu_torch.plonk.prover import PhaseTimer, prove
    from spectre_tpu_torch.plonk.srs import SRS
    from spectre_tpu_torch.witness import config_from_pinning, flex_circuit

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"gpu: {smi}", flush=True)
    KL.build_all()
    dev = torch.device("cuda")
    bk = TorchBackend(dev)
    from spectre_tpu_torch.plonk.transcript import Blake2bTranscript

    from spectre_tpu_torch.plonk import transcript as T

    transcript = {"blake2b": Blake2bTranscript, "poseidon": T.PoseidonTranscript,
                  "keccak": T.KeccakTranscript}[args.transcript]
    setup = {}
    if args.circuit in ("aggregation", "step-aggregation"):
        from spectre_tpu_torch import spec as SPEC
        from spectre_tpu_torch.models import CommitteeUpdateCircuit, StepCircuit
        from spectre_tpu_torch.models.aggregation import (AggregationArgs, AggregationCircuit,
                                                          outer_k)
        from spectre_tpu_torch.plonk.transcript import KeccakTranscript, PoseidonTranscript
        from spectre_tpu_torch.witness import (default_committee_update_args,
                                               default_sync_step_args)

        spec = SPEC.TESTNET
        inner, k_in, make_args = {
            "aggregation": (CommitteeUpdateCircuit, 18, default_committee_update_args),
            "step-aggregation": (StepCircuit, 21, default_sync_step_args)}[args.circuit]
        t0 = time.perf_counter()
        c_args = make_args(spec)
        ctx = inner.build_context(c_args, spec, device=dev)
        srs_in = SRS.load_or_setup(k_in, device=dev)
        pk_in = inner.create_pk(srs_in, spec, k_in, c_args, device=dev, ctx=ctx)
        r = random.Random(args.seed)
        proof_in = inner.prove(pk_in, srs_in, c_args, spec, device=dev, ctx=ctx,
                               transcript=PoseidonTranscript(),
                               blinding_rng=lambda: r.randrange(bn254.R))
        setup["inner_s"] = time.perf_counter() - t0
        agg_args = AggregationArgs(inner_vk=pk_in.vk, srs=srs_in,
                                   inner_instances=[inner.get_instances(c_args, spec)],
                                   proof=proof_in)
        del pk_in, ctx
        torch.cuda.empty_cache()
        circuit = AggregationCircuit.variant(inner.name)
        t0 = time.perf_counter()
        ctx = circuit.build_context(agg_args, spec, device=dev)
        setup["build_s"] = time.perf_counter() - t0
        # the committee's outer shape is pinned at k=22; the step's is sized
        # by the reference flow's rule
        k = 22 if inner is CommitteeUpdateCircuit else outer_k(ctx, circuit.default_lookup_bits)
        cfg = circuit.pinning(spec, k, ctx).config
        t0 = time.perf_counter()
        srs = srs_in if k == k_in else SRS.load_or_setup(k, device=dev)
        setup["srs_s"] = time.perf_counter() - t0
        ktimer = PhaseTimer(dev)
        t0 = time.perf_counter()
        pk = circuit.create_pk(srs, spec, cfg.k, agg_args, device=dev, ctx=ctx, timer=ktimer)
        setup["keygen_s"] = time.perf_counter() - t0
        setup["keygen_phases_s"] = ktimer.seconds
        instances = circuit.get_instances(agg_args, spec)
        asg = ctx.assignment(cfg)
        del ctx
        transcript = KeccakTranscript
        print("set-up (s): " + json.dumps(setup), flush=True)
    elif args.circuit in ("committee", "step"):
        from spectre_tpu_torch import spec as SPEC
        from spectre_tpu_torch.models import CommitteeUpdateCircuit, StepCircuit
        from spectre_tpu_torch.witness import (default_committee_update_args,
                                               default_sync_step_args)

        circuit, k, make_args = {
            "committee": (CommitteeUpdateCircuit, 18, default_committee_update_args),
            "step": (StepCircuit, 21, default_sync_step_args)}[args.circuit]
        c_args = make_args(SPEC.TESTNET)
        ctx = circuit.build_context(c_args, SPEC.TESTNET, device=dev)
        cfg = circuit.pinning(SPEC.TESTNET, k, ctx).config
        srs = SRS.load_or_setup(cfg.k, device=dev)
        pk = circuit.create_pk(srs, SPEC.TESTNET, cfg.k, c_args, device=dev, ctx=ctx)
        asg = ctx.assignment(cfg)
    else:
        cfg = config_from_pinning(os.path.join(REPO, "build", "sync_step_testnet_21.pinning.json"),
                                  args.k)
        fc = flex_circuit(cfg, seed=args.seed)
        srs = SRS.unsafe_setup(cfg.k, device=dev)
        pk = keygen(srs, cfg, fc.fixed, fc.selectors, fc.copies, bk)
        asg = fc.assignment

    def one_prove(timer, transcript_cls=transcript, backend=None):
        r = random.Random(args.seed)
        return prove(pk, srs, asg, backend or bk, timer=timer, transcript=transcript_cls(),
                     blinding_rng=lambda: r.randrange(bn254.R))

    if args.modes:
        return compare_modes(torch, args.modes.split(","), one_prove, dev, PhaseTimer, KL)

    if compare:
        classes = {"blake2b": T.Blake2bTranscript, "poseidon": T.PoseidonTranscript,
                   "keccak": T.KeccakTranscript}
        runs = {name: [] for name in compare}
        for name in compare + compare[::-1]:
            timer = PhaseTimer(dev)
            t0 = time.perf_counter()
            one_prove(timer, classes[name])
            runs[name].append(dict(timer.seconds, total=time.perf_counter() - t0))
        means = {name: {key: sum(r[key] for r in rs) / len(rs) for key in rs[0]}
                 for name, rs in runs.items()}
        print("transcripts, mean seconds a phase (order " + ",".join(compare + compare[::-1])
              + "): " + json.dumps({"transcripts": means, "runs": runs}), flush=True)

    timer = PhaseTimer(dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    proof = one_prove(timer)
    untraced = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    if args.circuit in ("aggregation", "step-aggregation"):
        if not circuit.verify(pk.vk, srs, instances, proof, device=dev,
                              transcript_cls=KeccakTranscript):
            print("torch_prove_profile: the outer proof does not verify", file=sys.stderr)
            return 1
        print(f"the outer proof ({len(proof)} bytes) passes AggregationCircuit.verify",
              flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_prove(PhaseTimer(dev))
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0

    # device-side events only (kernels and copies, ours through ctypes too):
    # the host ops that launched them carry the same time again
    rows = []
    busy_us = 0.0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = ev.self_device_time_total
        busy_us += dev_us
        rows.append((dev_us, ev.count, ev.key))
    rows.sort(reverse=True)
    # the port's own kernels, each whether or not it is among the top rows
    ours = {name: {"device_ms": sum(us for us, _, key in rows if info.symbol in key) / 1e3,
                   "count": sum(n for _, n, key in rows if info.symbol in key)}
            for name, info in KL.KERNELS.items()}
    out = {
        "gpu": smi, "circuit": args.circuit, "k": cfg.k, "msm_mode": MSM.msm_mode(),
        "prove_s_untraced": untraced,
        "prove_s_traced": traced, "peak_device_gib": peak_gib,
        "device_busy_s": busy_us / 1e6, "device_busy_share": busy_us / 1e6 / traced,
        "phases_s": timer.seconds, "setup_s": setup,
        "kernels": ours,
        "top": [{"device_ms": us / 1e3, "count": n, "name": name[:120]}
                for us, n, name in rows[:25]],
    }
    print(f"{args.circuit} k={cfg.k} msm mode {out['msm_mode']}: prove {untraced:.3f} s "
          f"untraced (peak device memory "
          f"{peak_gib:.1f} GiB), {traced:.3f} s traced; device busy {busy_us / 1e6:.3f} s "
          f"({100 * out['device_busy_share']:.1f}% of the traced prove)")
    print("phases (s): " + json.dumps({k: round(v, 3) for k, v in timer.seconds.items()}))
    for name, r in ours.items():
        print(f"  {r['device_ms']:10.1f} ms {r['count']:7d}  {name}")
    for r in out["top"]:
        print(f"  {r['device_ms']:10.1f} ms {r['count']:7d}  {r['name']}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
