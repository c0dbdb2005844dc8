#!/usr/bin/env python3
"""Where the time of one spectre_tpu_torch prove goes, on one CUDA GPU.

    python3 scripts/torch_prove_profile.py            # k = 21 (sync-step testnet shape)
    python3 scripts/torch_prove_profile.py --k 19

Builds the kernels, sets up the SRS and the key for the seeded flex-gate
witness at the pinned shape of build/sync_step_testnet_21.pinning.json,
proves once untraced (per-phase seconds), then once more under
torch.profiler. Prints the device's busy and idle share of the traced
prove, its device time by kernel, and per-phase seconds, then the same as
one JSON line. Exits non-zero without CUDA.
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
    ap.add_argument("--k", type=int, default=None)
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
    from spectre_tpu_torch.ops import kernel_lib as KL
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
    cfg = config_from_pinning(os.path.join(REPO, "build", "sync_step_testnet_21.pinning.json"),
                              args.k)
    fc = flex_circuit(cfg, seed=args.seed)
    bk = TorchBackend(dev)
    srs = SRS.unsafe_setup(cfg.k, device=dev)
    pk = keygen(srs, cfg, fc.fixed, fc.selectors, fc.copies, bk)

    def one_prove(timer):
        r = random.Random(args.seed)
        return prove(pk, srs, fc.assignment, bk, timer=timer,
                     blinding_rng=lambda: r.randrange(bn254.R))

    timer = PhaseTimer(dev)
    t0 = time.perf_counter()
    one_prove(timer)
    untraced = time.perf_counter() - t0

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
    out = {
        "gpu": smi, "k": cfg.k, "prove_s_untraced": untraced, "prove_s_traced": traced,
        "device_busy_s": busy_us / 1e6, "device_busy_share": busy_us / 1e6 / traced,
        "phases_s": timer.seconds,
        "top": [{"device_ms": us / 1e3, "count": n, "name": name[:120]}
                for us, n, name in rows[:25]],
    }
    print(f"prove {untraced:.3f} s untraced, {traced:.3f} s traced; device busy "
          f"{busy_us / 1e6:.3f} s ({100 * out['device_busy_share']:.1f}% of the traced prove)")
    print("phases (s): " + json.dumps({k: round(v, 3) for k, v in timer.seconds.items()}))
    for r in out["top"]:
        print(f"  {r['device_ms']:10.1f} ms {r['count']:7d}  {r['name']}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
