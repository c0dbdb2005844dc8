"""Application circuits (the port's copy of `spectre_tpu/models/`): the
step, the committee update and the aggregation, written against the
builder chips, proved by the port's prover on its device."""

from .aggregation import (AggregationArgs, AggregationCircuit,  # noqa: F401
                          Accumulator)
from .app_circuit import AppCircuit  # noqa: F401
from .committee_update import CommitteeUpdateCircuit  # noqa: F401
from .step import StepCircuit  # noqa: F401
