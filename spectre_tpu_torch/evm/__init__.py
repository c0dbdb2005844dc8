"""EVM layer: Solidity verifier generation + calldata encoding.

Reference parity: snark-verifier's `gen_evm_verifier_shplonk` +
`encode_calldata` (`util/circuit.rs:182-218`, SURVEY.md L0/N11 and §2a
"Prover CLI gen-verifier").
"""

from .codegen import encode_calldata, gen_evm_verifier  # noqa: F401
from .gas import estimate_deployed_size, estimate_gas  # noqa: F401
