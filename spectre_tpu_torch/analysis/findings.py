"""Finding records and the checked-in suppression baseline (the port of
`spectre_tpu/analysis/findings.py`).

A finding is (engine, rule, severity, file, obj, message, key). The `key`
is the STABLE identity used for suppression — it names the rule, the
audited object, and a content detail (a count, an expression index, a
primitive name), so a baseline entry keeps matching across unrelated edits
but resurfaces the moment the underlying fact changes (e.g. the count of
unreferenced cells drifts). Severity gates the CLI exit code via
`--fail-on`.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass


class Severity:
    ERROR = "error"
    WARNING = "warning"
    INFO = "info"
    ORDER = {ERROR: 2, WARNING: 1, INFO: 0}

    @classmethod
    def at_least(cls, sev: str, threshold: str) -> bool:
        return cls.ORDER[sev] >= cls.ORDER[threshold]


@dataclass(frozen=True)
class Finding:
    engine: str      # "circuit" (the port's one engine)
    rule: str        # e.g. "CA-UNDERCONSTRAINED"
    severity: str    # Severity.*
    file: str        # repo-relative path of the audited source
    obj: str         # circuit/kernel/probe name (e.g. "committee_update:tiny")
    message: str
    key: str = ""    # stable suppression key; default derived from the rest

    def __post_init__(self):
        if not self.key:
            object.__setattr__(self, "key", f"{self.rule}:{self.obj}")

    def to_dict(self) -> dict:
        return {"engine": self.engine, "rule": self.rule,
                "severity": self.severity, "file": self.file,
                "obj": self.obj, "message": self.message, "key": self.key}


def format_finding(f: Finding, suppressed: bool = False) -> str:
    tag = " [baseline]" if suppressed else ""
    return f"{f.severity:7s} {f.rule:20s} {f.file} ({f.obj}): {f.message}{tag}"


BASELINE_PATH = os.path.join(os.path.dirname(__file__), "baseline.json")


def load_baseline(path: str | None = None) -> dict:
    """Suppression file: {"suppressions": [{"key": ..., "reason": ...}]}.
    Returns {key -> reason}; missing file = empty baseline."""
    path = path or BASELINE_PATH
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        data = json.load(f)
    return {e["key"]: e.get("reason", "") for e in data.get("suppressions", [])}


def write_baseline(findings: list, path: str | None = None,
                   reason: str = "accepted at baseline creation") -> str:
    """Accept the given findings: write (merge into) the suppression file."""
    path = path or BASELINE_PATH
    existing = load_baseline(path)
    for f in findings:
        existing.setdefault(f.key, f"{reason}: {f.message}")
    with open(path, "w") as fh:
        json.dump({"suppressions": [
            {"key": k, "reason": r} for k, r in sorted(existing.items())
        ]}, fh, indent=1)
        fh.write("\n")
    return path


def partition_findings(findings: list, baseline: dict):
    """-> (active, suppressed) preserving order."""
    active, suppressed = [], []
    for f in findings:
        (suppressed if f.key in baseline else active).append(f)
    return active, suppressed
