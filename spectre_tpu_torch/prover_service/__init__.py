"""Prover service: CLI, JSON-RPC server and client, the prover state kept
hot on the device (the port's copy of `spectre_tpu/prover_service/`).

Reference parity (SURVEY.md L5): `prover/src/` — the clap CLI (`args.rs`,
`cli.rs`), the JSON-RPC server with its `genEvmProof_*` methods
(`rpc.rs`, `rpc_api.rs`), the boot-time `ProverState`
(`prover.rs:43-117`), the typed client (`rpc_client.rs`) and
`utils committee-poseidon` (`utils.rs`). Beside them: the async job queue
with its crash-safe journal (`jobs.py`), verify-before-serve
(`selfverify.py`), the artifact scrubber (`scrubber.py`) and EVM calldata
(`calldata.py`), and the proof farm (`dispatcher.py`: replicas, leases,
membership, cross-verification).
"""

from .calldata import decode_calldata, encode_calldata  # noqa: F401
