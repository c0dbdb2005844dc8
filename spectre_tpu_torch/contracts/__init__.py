"""On-chain layer: the Spectre light-client state machine + verifier interface.

Reference parity (SURVEY.md L6): the `Spectre.sol` contract (head tracking,
per-period committee poseidons, block/execution root maps) and
`contract-tests/` (protocol tests against MockVerifiers). `spectre.py` keeps
an executable Python model with the contract's storage layout and entry
points; `sol_gen.py` emits the Solidity contract itself, which
`evm/solc_spectre.py` compiles to bytecode for `evm/vm.py`.
"""

from .spectre import MockVerifier, NativeVerifier, SpectreContract  # noqa: F401
