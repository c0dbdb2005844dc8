"""CLI: `python -m spectre_tpu_torch.analysis [--engine circuit] [--device cpu]
[--fail-on error]` (the port of `spectre_tpu/analysis/__main__.py`).

Runs the circuit soundness audit over the tiny-spec app circuits, subtracts
the checked-in `baseline.json` suppressions, prints the rest, and exits
non-zero when an unsuppressed finding reaches the --fail-on severity.
`--write-baseline` accepts the current active findings into the
suppression file. `--json PATH` writes the active and suppressed findings,
each pass's seconds and the number of circuits. `--engine kernel` and
`--engine trace` name the reference's jaxpr and JAX-trace-cache linters,
which have no port: they exit non-zero with one line saying so.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

NOT_PORTED = {
    "kernel": "the kernel engine lints jaxprs of JAX device ops, which the port does not "
              "have; it has no port",
    "trace": "the trace engine lints JAX trace caches, which the port does not have; it has "
             "no port",
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m spectre_tpu_torch.analysis",
        description="circuit soundness auditor")
    ap.add_argument("--engine", choices=("all", "circuit", "kernel", "trace"),
                    default="all", help="'all' is the circuit engine, the one the port has")
    ap.add_argument("--circuits", default="committee_update,sync_step,aggregation",
                    help="comma list of audit circuits, or 'none'")
    ap.add_argument("--device", default=None,
                    help="device of the builders' work (default: cuda; cpu runs the "
                         "plain versions)")
    ap.add_argument("--fail-on", choices=("error", "warning", "never"),
                    default="error", dest="fail_on")
    ap.add_argument("--baseline", default=None,
                    help="suppression file (default: packaged baseline.json)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="accept current active findings into the baseline")
    ap.add_argument("--json", default=None, help="write findings JSON here")
    ap.add_argument("-q", "--quiet", action="store_true")
    opts = ap.parse_args(argv)

    if opts.engine in NOT_PORTED:
        print(f"[analysis] --engine {opts.engine}: {NOT_PORTED[opts.engine]}",
              file=sys.stderr)
        return 2

    from .findings import (Severity, format_finding, load_baseline,
                           partition_findings, write_baseline)

    findings, passes, roots = [], [], {}
    t0 = time.time()
    if opts.circuits != "none":
        from .circuit_audit import audit_context
        from .circuits import AUDIT_CIRCUITS
        wanted = [c for c in opts.circuits.split(",") if c]
        roots["circuits"] = len(wanted)
        for cname in wanted:
            build = AUDIT_CIRCUITS.get(cname)
            if build is None:
                ap.error(f"unknown circuit {cname!r} (have: {', '.join(AUDIT_CIRCUITS)})")
            t = time.time()
            ctx, cfg, name = build(device=opts.device)
            fs = audit_context(ctx, cfg, name)
            findings += fs
            passes.append({"name": f"circuit {name}", "engine": "circuit",
                           "seconds": round(time.time() - t, 3), "findings": len(fs)})
            if not opts.quiet:
                print(f"[analysis] circuit {name}: {len(fs)} finding(s) "
                      f"({time.time() - t:.1f}s)", flush=True)

    baseline = load_baseline(opts.baseline)
    active, suppressed = partition_findings(findings, baseline)
    if opts.write_baseline and active:
        path = write_baseline(active, opts.baseline)
        print(f"[analysis] accepted {len(active)} finding(s) into {path}")
        suppressed += active
        active = []

    for f in active:
        print(format_finding(f))
    if not opts.quiet:
        for f in suppressed:
            print(format_finding(f, suppressed=True))
    if opts.json:
        with open(opts.json, "w") as fh:
            json.dump({"active": [f.to_dict() for f in active],
                       "suppressed": [f.to_dict() for f in suppressed],
                       "passes": passes, "roots": roots,
                       "seconds": round(time.time() - t0, 3)}, fh, indent=1)

    counts: dict = {}
    for f in active:
        counts[f.severity] = counts.get(f.severity, 0) + 1
    print(f"[analysis] {len(active)} active finding(s) "
          f"({', '.join(f'{v} {k}' for k, v in counts.items()) or 'clean'}), "
          f"{len(suppressed)} baselined, {time.time() - t0:.1f}s total")
    if opts.fail_on == "never":
        return 0
    bad = [f for f in active if Severity.at_least(f.severity, opts.fail_on)]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
