"""Witnesses for the port's circuits (the port's copy of the committee-update
part of `spectre_tpu/witness/`, plus the seeded flex-gate witness):

    types.py     the circuits' argument types and host SSZ helpers
    rotation.py  default_committee_update_args (mock-rooted, deterministic)
    flex.py      a seeded flex-gate witness at a pinned shape
"""

from .flex import FlexCircuit, config_from_pinning, flex_circuit  # noqa: F401
from .rotation import default_committee_update_args  # noqa: F401
from .types import BeaconBlockHeader, CommitteeUpdateArgs  # noqa: F401
