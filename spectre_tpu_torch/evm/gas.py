"""Static gas + deployed-code-size estimation for generated verifiers (the
port's copy of `spectre_tpu/evm/gas.py`).

The reference prints `sol size` and estimates gas by executing its generated
Yul in revm (`prover/src/cli.rs:249-277`). No EVM or solc exists in this
offline environment, so this module derives both numbers STATICALLY from the
generated source's runtime structure, which — unlike source bytes — maps
predictably to bytecode: the verifier is a straight-line program of field
ops, keccaks, calldata loads, and precompile calls.

Gas model (post-Berlin mainnet schedule, EIP-150/1108/2028/2565/2929):
  mulmod / addmod          8 gas each + ~10 for operand plumbing
  keccak256 over N bytes   30 + 6*ceil(N/32) + abi.encodePacked copy (~3/word)
  ecMul  (0x07)            6,000 (EIP-1108) + 100 warm staticcall + abi glue
  ecAdd  (0x06)            150 + 100 + glue
  pairing(0x08), k pairs   45,000 + 34,000k + 100 + glue
  modexp (0x05) 32B inv    ~1,350 (EIP-2565: 16 * 255 / 3) + 100 + glue
  calldataload             3 each (proof slices / instance reads)
  intrinsic tx             21,000 + calldata (16/nonzero, 4/zero byte)
  memory expansion         3w + w^2/512 for the t[] scratch array

Deployed-size model (per-construct bytecode expansion, legacy codegen):
  PUSH32 literal           33 B        mulmod/addmod statement   ~18 B
  t[i] memory ref          ~8 B        proof/calldata slice      ~25 B
  helper fns + scaffold    ~2,200 B    other statement           ~30 B
The EIP-170 runtime limit is 24,576 B; `deployed_size_risk` states where the
estimate falls. Both estimators are calibrated to structure counts, not
source length, so comments/whitespace don't distort them.
"""

from __future__ import annotations

import re


def _count(pattern: str, src: str) -> int:
    return len(re.findall(pattern, src))


def analyze_verifier(sol_src: str) -> dict:
    """Structure counts of a generated verifier source (codegen.py shapes)."""
    body = sol_src
    return {
        "mulmod": _count(r"\bmulmod\(", body),
        "addmod": _count(r"\baddmod\(", body),
        "keccak": _count(r"\bkeccak256\(", body),
        "ecmul": _count(r"_ecMul\(", body),
        "ecadd": _count(r"_ecAdd\(", body),
        "pairing": _count(r"_pairing\(", body),
        "inv": _count(r"_inv\(", body),
        "calldata_slice": _count(r"proof\[\d+:\d+\]", body)
        + _count(r"instances\[\d+\]", body),
        "push32_literals": _count(r"0x[0-9a-fA-F]{48,64}", body),
        "statements": _count(r";\n", body),
        "tmp_slots": max([int(m) + 1 for m in
                          re.findall(r"t\[(\d+)\]", body)] or [0]),
    }


# average absorbed bytes per transcript keccak: the unrolled absorb chunks
# are point (64B) / scalar (32B) batches plus the 34B state||tag||ctr frame;
# generated verifiers average ~5 words
_KECCAK_AVG_WORDS = 5


def estimate_gas(sol_src: str, calldata: bytes | None = None) -> dict:
    """Static execution-gas estimate for one verify(...) call."""
    c = analyze_verifier(sol_src)
    field_ops = (c["mulmod"] + c["addmod"]) * (8 + 10)
    keccaks = c["keccak"] * (30 + 6 * _KECCAK_AVG_WORDS
                             + 3 * _KECCAK_AVG_WORDS)
    ecmul = c["ecmul"] * (6000 + 100 + 50)
    ecadd = c["ecadd"] * (150 + 100 + 50)
    # every _pairing call in the source checks the same 2-pair input shape
    # (lhs/G2_GEN, -W2/G2_TAU — codegen emits uint256[12])
    pairing = c["pairing"] * (45000 + 34000 * 2 + 100 + 100)
    inv = c["inv"] * (1350 + 100 + 50)
    calldata_reads = c["calldata_slice"] * 3
    w = c["tmp_slots"] + 64            # scratch + abi staging
    memory = 3 * w + w * w // 512
    execution = (field_ops + keccaks + ecmul + ecadd + pairing + inv
                 + calldata_reads + memory)
    out = {
        "counts": c,
        "gas_field_ops": field_ops,
        "gas_keccak": keccaks,
        "gas_precompiles": ecmul + ecadd + pairing + inv,
        "gas_memory": memory,
        "gas_execution": execution,
    }
    if calldata is not None:
        nz = sum(1 for b in calldata if b)
        intrinsic = 21000 + 16 * nz + 4 * (len(calldata) - nz)
        out["gas_intrinsic"] = intrinsic
        out["gas_total"] = execution + intrinsic
    return out


def estimate_deployed_size(sol_src: str) -> dict:
    """Deployed (runtime) bytecode size estimate + EIP-170 assessment."""
    c = analyze_verifier(sol_src)
    size = (33 * c["push32_literals"]
            + 18 * (c["mulmod"] + c["addmod"])
            + 8 * c["tmp_slots"]
            + 25 * c["calldata_slice"]
            + 30 * max(0, c["statements"] - c["mulmod"] - c["addmod"])
            + 2200)
    limit = 24576
    if size <= limit * 3 // 4:
        risk = "ok"
    elif size <= limit:
        risk = "tight"
    else:
        risk = "exceeds-eip170"
    return {
        "deployed_bytes_estimate": size,
        "eip170_limit": limit,
        "deployed_size_risk": risk,
        "note": "static per-construct model (see evm/gas.py header); "
                "the dominant term is PUSH32 literals x33B — large shapes "
                "must split the verifier or move constants to calldata",
    }
