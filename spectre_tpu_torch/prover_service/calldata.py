"""EVM calldata encoding for generated proofs (the port's copy of
`spectre_tpu/prover_service/calldata.py`).

Reference parity: snark-verifier's `encode_calldata` (`rpc.rs:160-162`):
instances as 32-byte big-endian words followed by the raw proof bytes — the
layout the generated Solidity verifier expects.
"""

from __future__ import annotations


def encode_calldata(instances: list[int], proof: bytes) -> bytes:
    out = b"".join(int(v).to_bytes(32, "big") for v in instances)
    return out + proof


def decode_calldata(data: bytes, num_instances: int) -> tuple[list[int], bytes]:
    instances = [int.from_bytes(data[32 * i:32 * (i + 1)], "big")
                 for i in range(num_instances)]
    return instances, data[32 * num_instances:]
