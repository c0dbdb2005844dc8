"""Application circuits (the port's copy of the step and committee-update
parts of `spectre_tpu/models/`): written against the builder chips, proved by the
port's prover on its device."""

from .app_circuit import AppCircuit  # noqa: F401
from .committee_update import CommitteeUpdateCircuit  # noqa: F401
from .step import StepCircuit  # noqa: F401
