"""Light-client follower subsystem (the port's copy of
`spectre_tpu/follower/`).

The reference Spectre is a coprocessor that *continuously follows* the
Altair light-client protocol rather than proving on request: track the
beacon head, prove a step per attested header, prove a committee update
at every sync-period boundary, keep an unbroken chain of verified
updates ready to serve. This package closes that loop over the existing
service layers:

    tracker.py    beacon polling -> typed StepDue/CommitteeUpdateDue items
    scheduler.py  work items -> JobQueue submissions (admission control,
                  witness-digest dedup, retry/backoff per -32001 hints)
    updates.py    verified update store: content-addressed, journal-backed
                  chain linked by committee poseidon commitments
    daemon.py     the supervised loop + /metrics snapshot registry

Serving rides the prover RPC server (`getLightClientUpdate`,
`getUpdateRange`, `followerStatus`) and a cache hit is one artifact
read — it never touches the device.
"""

from .daemon import Follower, follower_snapshot
from .scheduler import ProofScheduler
from .tracker import CommitteeUpdateDue, HeadTracker, StepDue
from .updates import ChainOrderError, UpdateStore

__all__ = ["Follower", "follower_snapshot", "ProofScheduler",
           "HeadTracker", "StepDue", "CommitteeUpdateDue", "UpdateStore",
           "ChainOrderError"]
