"""The circuit soundness auditor (the port of `spectre_tpu/analysis/`'s
circuit engine).

`circuit_audit` walks a builder Context and its CircuitConfig and reports
under-constrained advice cells, degree-budget violations, unbound lookup
tables, copy-constraint orphans, dead fixed and selector columns, and
row-level coverage holes over the physical assignment grid. Findings carry
stable keys; accepted ones live in the checked-in `baseline.json` (empty).

The reference's other two engines are not ported: `kernel_lint` traces
JAX device ops to jaxprs and `trace_lint` audits JAX jit caches, neither
of which the port has. CLI: `python -m spectre_tpu_torch.analysis
--engine circuit [--device cpu]`.
"""

from .findings import (Finding, Severity, load_baseline, write_baseline,  # noqa: F401
                       partition_findings, format_finding)
from .circuit_audit import audit_context, audit_rows, DegreeCtx  # noqa: F401

__all__ = [
    "Finding", "Severity", "load_baseline", "write_baseline",
    "partition_findings", "format_finding", "audit_context", "audit_rows",
    "DegreeCtx",
]
