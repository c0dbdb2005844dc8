"""Witnesses for the port's circuits (the port's copy of the step and
committee-update parts of `spectre_tpu/witness/`, plus the seeded flex-gate
witness):

    types.py     the circuits' argument types and host SSZ helpers
    rotation.py  default_committee_update_args (mock-rooted, deterministic)
    step.py      default_sync_step_args (self-signed, mock-rooted)
    flex.py      a seeded flex-gate witness at a pinned shape
"""

from .flex import FlexCircuit, config_from_pinning, flex_circuit  # noqa: F401
from .rotation import default_committee_update_args  # noqa: F401
from .step import default_sync_step_args  # noqa: F401
from .types import BeaconBlockHeader, CommitteeUpdateArgs, SyncStepArgs  # noqa: F401
