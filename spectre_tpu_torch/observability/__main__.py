"""`python -m spectre_tpu_torch.observability` — operator tooling (the
port's copy of `spectre_tpu/observability/__main__.py`).

Subcommands:

  report <job-id|manifest.json> [--diff <job-id|manifest.json>] [--url U]
      Render a proof provenance manifest (observability/manifest.py) as
      a phase/kernel-build/queue-wait breakdown. The target is either a path
      to a manifest JSON file (as stored in the artifact store /
      downloaded earlier) or a job id, fetched live over the
      `getProofManifest` RPC from --url. `--diff` renders the breakdown
      of the first manifest followed by a field-by-field regression
      diff against the second — the triage loop for "why did tonight's
      prove get slower".

  report BASELINE --diff CANDIDATE --ci [--max-prove-regress F]
                                        [--max-build-count-increase N]
      CI gate: exits 3 when the CANDIDATE manifest regresses prove_s
      beyond the fractional threshold (default 0.10 = +10%) or its
      kernels.builds grows beyond the allowed increase (default 0 — a
      kernel build in a steady-state prove means a library was not built
      at boot).

Rendering a manifest needs nothing of the prover: no kernel is built or
loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import manifest as man_mod

DEFAULT_URL = "http://127.0.0.1:3000/rpc"


def _load(target: str, url: str) -> dict:
    """A target that exists on disk is a manifest file; anything else is
    treated as a job id and fetched over RPC."""
    if os.path.exists(target):
        with open(target, "rb") as f:
            return man_mod.from_bytes(f.read())
    from ..prover_service.rpc_client import ProverClient
    return ProverClient(url).get_manifest(target)


def _ci_regressions(baseline: dict, candidate: dict,
                    max_prove_regress: float,
                    max_build_count_increase: int) -> list[str]:
    """The CI gate findings: target = baseline, --diff = candidate."""
    findings = []
    base_prove = baseline.get("prove_s")
    cand_prove = candidate.get("prove_s")
    if base_prove and cand_prove is not None:
        allowed = base_prove * (1.0 + max_prove_regress)
        if cand_prove > allowed:
            findings.append(
                f"prove_s regressed: {base_prove:.3f}s -> {cand_prove:.3f}s "
                f"(+{(cand_prove / base_prove - 1.0) * 100:.1f}%, "
                f"threshold +{max_prove_regress * 100:.0f}%)")
    base_cc = (baseline.get("kernels") or {}).get("builds", 0)
    cand_cc = (candidate.get("kernels") or {}).get("builds", 0)
    if cand_cc > base_cc + max_build_count_increase:
        findings.append(
            f"kernels.builds regressed: {base_cc} -> {cand_cc} "
            f"(allowed increase {max_build_count_increase})")
    return findings


def _cmd_report(args) -> int:
    if args.ci and args.diff is None:
        print("--ci requires --diff CANDIDATE (target is the baseline)",
              file=sys.stderr)
        return 2
    a = _load(args.target, args.url)
    print(man_mod.render(a))
    b = None
    if args.diff is not None:
        b = _load(args.diff, args.url)
        print()
        print(man_mod.diff(a, b))
    if args.json:
        print()
        print(json.dumps(a, indent=2, sort_keys=True))
    if args.ci:
        findings = _ci_regressions(a, b, args.max_prove_regress,
                                   args.max_build_count_increase)
        print()
        if findings:
            for f in findings:
                print(f"CI REGRESSION: {f}")
            return 3
        print("CI gate: ok (no prove_s / kernels.builds regression)")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m spectre_tpu_torch.observability")
    sub = p.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("report", help="render a proof provenance manifest")
    r.add_argument("target",
                   help="manifest JSON path, or a job id (fetched via RPC)")
    r.add_argument("--diff", default=None, metavar="OTHER",
                   help="second manifest (path or job id) to diff against")
    r.add_argument("--url", default=DEFAULT_URL,
                   help=f"prover RPC endpoint for job-id targets "
                        f"(default {DEFAULT_URL})")
    r.add_argument("--json", action="store_true",
                   help="also dump the raw manifest JSON")
    r.add_argument("--ci", action="store_true",
                   help="CI gate: exit 3 when --diff (the candidate) "
                   "regresses prove_s or kernels.builds beyond thresholds "
                   "vs the target (the baseline)")
    r.add_argument("--max-prove-regress", type=float, default=0.10,
                   help="allowed fractional prove_s increase "
                   "(default 0.10 = +10%%)")
    r.add_argument("--max-build-count-increase", type=int, default=0,
                   help="allowed kernels.builds increase (default 0)")
    args = p.parse_args(argv)
    if args.cmd == "report":
        return _cmd_report(args)
    return 2


if __name__ == "__main__":
    sys.exit(main())
