"""CLI entry: drive a live gateway (or a local update store, in
process) with a simulated light-client population (the port's copy
of `spectre_tpu/loadgen/__main__.py`).

    # a million clients against a running `follow --gateway` server
    python -m spectre_tpu_torch.loadgen --url http://127.0.0.1:3000 \
        --clients 1000000

    # in-process against a follower's params dir (no server needed)
    python -m spectre_tpu_torch.loadgen --store-dir /path/to/params

Arm SPECTRE_FAULT_PLAN before the run to make it a chaos drill.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m spectre_tpu_torch.loadgen")
    tgt = p.add_mutually_exclusive_group(required=True)
    tgt.add_argument("--url", help="base URL of a server with the "
                     "gateway mounted (follow --gateway)")
    tgt.add_argument("--store-dir", help="params dir holding a "
                     "follower update store: build a Gateway in-process "
                     "and drill it directly (no HTTP)")
    p.add_argument("--clients", type=int, default=1_000_000,
                   help="simulated client population (default 10^6)")
    p.add_argument("--requests", type=int, default=None,
                   help="total requests (default: 2 per client)")
    p.add_argument("--zipf-s", type=float, default=None,
                   help="Zipf exponent over periods, newest=hottest "
                   "(default 1.1)")
    p.add_argument("--range-count", type=int, default=8,
                   help="max periods per range request")
    p.add_argument("--threads", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    from .drill import DEFAULT_ZIPF_S, HttpTarget, InProcessTarget, run_drill

    health = None
    if args.url:
        target = HttpTarget(args.url)
        # discover the period span from the bootstrap route
        import urllib.request
        with urllib.request.urlopen(args.url.rstrip("/")
                                    + "/v1/bootstrap") as resp:
            boot = json.loads(resp.read())
        anchor, tip = boot["anchor_period"], boot["tip_period"]
    else:
        from ..follower.updates import UpdateStore
        from ..gateway import Gateway
        from ..utils.health import HEALTH
        store = UpdateStore(args.store_dir)
        anchor, tip = store.anchor_period(), store.tip_period()
        if anchor is None:
            sys.exit("store is empty: nothing to serve")
        target = InProcessTarget(Gateway(store))
        health = HEALTH
    periods = list(range(tip, anchor - 1, -1))   # newest first
    report = run_drill(
        target, periods, tip, clients=args.clients,
        requests=args.requests,
        zipf_s=DEFAULT_ZIPF_S if args.zipf_s is None else args.zipf_s,
        range_count=args.range_count, threads=args.threads,
        seed=args.seed, health=health)
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
