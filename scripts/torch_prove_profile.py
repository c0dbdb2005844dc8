#!/usr/bin/env python3
"""Where the time of one spectre_tpu_torch prove goes, on one CUDA GPU.

    python3 scripts/torch_prove_profile.py            # k = 21 (sync-step testnet shape)
    python3 scripts/torch_prove_profile.py --k 19
    python3 scripts/torch_prove_profile.py --circuit committee
    python3 scripts/torch_prove_profile.py --circuit step

Builds the kernels, sets up the SRS and the key, proves once untraced
(per-phase seconds, peak device memory), then once more under
torch.profiler. The circuit is the seeded flex-gate witness at the pinned
shape of build/sync_step_testnet_21.pinning.json, or (--circuit committee)
the CommitteeUpdateCircuit at build/committee_update_testnet_18.pinning.json
(512 pubkeys, k=18, witness from default_committee_update_args), or
(--circuit step) the StepCircuit at the same k=21 pinning (512 pubkeys,
witness from default_sync_step_args). Prints the
device's busy and idle share of the traced prove, per-phase seconds, the
device time and launches of each of the port's kernels, the top device rows
by time, then the same as one JSON line. Exits non-zero without CUDA.
The MSMs run in the mode SPECTRE_MSM_MODE names (vanilla by default); under
fixed, the untraced prove builds the window table and the traced one
reuses it.
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, default=None, help="rows of the flex circuit")
    ap.add_argument("--circuit", choices=("flex", "committee", "step"), default="flex")
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)

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
    if args.circuit in ("committee", "step"):
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

    def one_prove(timer):
        r = random.Random(args.seed)
        return prove(pk, srs, asg, bk, timer=timer,
                     blinding_rng=lambda: r.randrange(bn254.R))

    timer = PhaseTimer(dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    one_prove(timer)
    untraced = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

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
        "phases_s": timer.seconds,
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
