"""Beacon helpers for the utils CLI (the port's copy of
`spectre_tpu/prover_service/beacon_helpers.py`).

Reference parity: `prover/src/utils.rs:18-66` (`committee-poseidon`
bootstrap: head block root -> light-client bootstrap -> committee pubkeys).
"""

from __future__ import annotations

from ..preprocessor.beacon import BeaconClient
from ..preprocessor.step import _bytes
from ..witness.types import CommitteeUpdateArgs


def fetch_bootstrap_committee(base_url: str, spec):
    client = BeaconClient(base_url)
    root = client.head_block_root()
    boot = client.bootstrap(root)
    committee = boot["current_sync_committee"]
    pubkeys = [_bytes(pk) for pk in committee["pubkeys"]]
    slot = int(boot["header"]["beacon"]["slot"]) if "beacon" in boot.get("header", {}) \
        else int(boot["header"]["slot"])
    period = spec.sync_period(slot)
    args = CommitteeUpdateArgs(pubkeys_compressed=pubkeys)
    return period, args.committee_pubkeys_root(), pubkeys
