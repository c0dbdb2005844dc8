"""Circuit gadgets above the chips (the port's copy of the parts of
`spectre_tpu/gadgets/` the committee update uses): `ssz_merkle.rs`
(merkleization, branch verification) and `poseidon.rs` (the committee
commitment).
"""

from .ssz_merkle import merkleize_chunks, verify_merkle_proof  # noqa: F401
from .poseidon_commit import g1_array_poseidon  # noqa: F401
