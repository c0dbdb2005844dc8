"""Witness acquisition: Beacon-chain REST -> circuit witnesses (the port's
copy of `spectre_tpu/preprocessor/`).

Reference parity (SURVEY.md L4): `preprocessor/src/` — fetchers for
LightClientFinalityUpdate / LightClientUpdate / Bootstrap and converters to
SyncStepArgs / CommitteeUpdateArgs, with NATIVE verification of the merkle
branches and the aggregate signature before proving
(`step.rs:90-120`, `rotation.rs:105-118`).

    beacon.py        BeaconClient, BeaconQuorum (retries, breaker, faults)
    step.py          finality update -> SyncStepArgs (pubkeys through K6)
    rotation.py      committee update -> CommitteeUpdateArgs
    ssz.py           the Capella light-client containers, compute_domain
    snappy_codec.py  snappy raw blocks (the .ssz_snappy fixture files)
    spec_tests.py    the consensus-spec-test loader and fixture generator
"""

from .beacon import BeaconClient  # noqa: F401
from .step import step_args_from_finality_update  # noqa: F401
from .rotation import rotation_args_from_update  # noqa: F401
