"""The prover service's calldata encoding (the rest of the service stack is
not ported yet)."""

from .calldata import decode_calldata, encode_calldata  # noqa: F401
