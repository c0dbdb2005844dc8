"""Spectre.sol emission + executable interpretation (the port's copy of
`spectre_tpu/contracts/sol_gen.py`; the emitted text, its header line
naming `spectre_tpu.contracts.sol_gen` included, is the reference's byte
for byte, so both packages deploy the same contract).

Reference parity: the `Spectre` light-client contract (submodule
`ChainSafe/spectre-contracts`, absent from the snapshot; its ABI observed via
`contract-tests/tests/spectre.rs:56-79` — storage `head`,
`blockHeaderRoots[slot]`, `executionPayloadRoots[slot]`,
`syncCommitteePoseidons[period]`; entry points `step`/`rotate` gated by
pluggable verifier contracts) and the Solidity<->Rust input-commitment
equivalence test (`contract-tests/tests/step_input_encoding.rs:109-116`).

Same single-source philosophy as `evm/codegen.py`: `gen_spectre_sol` emits
the contract in a small regular Solidity subset, and `SolSpectre` EXECUTES
that emitted source (statement-level translation, sha256 precompile, mapping
storage, verifier objects injected for the IVerifier calls) — so the
protocol tests drive the actual contract text, not a hand-kept mirror.
"""

from __future__ import annotations

import hashlib
import re


def gen_spectre_sol(spec) -> str:
    """The light-client contract for one network spec (committee size and
    slots-per-period are compile-time constants, as in the reference's
    per-network deployments)."""
    return f"""\
// SPDX-License-Identifier: LGPL-3.0-only
// Generated by spectre_tpu.contracts.sol_gen for spec={spec.name}
pragma solidity ^0.8.19;

interface IVerifier {{
    function verify(uint256[] calldata instances, bytes calldata proof)
        external view returns (bool);
}}

contract Spectre {{
    uint256 public constant SLOTS_PER_PERIOD = {spec.slots_per_period};
    uint256 public constant SYNC_COMMITTEE_SIZE = {spec.sync_committee_size};

    uint256 public head;
    mapping(uint256 => bytes32) public blockHeaderRoots;
    mapping(uint256 => bytes32) public executionPayloadRoots;
    mapping(uint256 => uint256) public syncCommitteePoseidons;
    IVerifier public stepVerifier;
    IVerifier public rotateVerifier;

    struct SyncStepInput {{
        uint64 attestedSlot;
        uint64 finalizedSlot;
        uint64 participation;
        bytes32 finalizedHeaderRoot;
        bytes32 executionPayloadRoot;
    }}

    constructor(uint256 initialSyncPeriod, uint256 initialCommitteePoseidon,
                address stepVerifierAddr, address rotateVerifierAddr) {{
        syncCommitteePoseidons[initialSyncPeriod] = initialCommitteePoseidon;
        stepVerifier = IVerifier(stepVerifierAddr);
        rotateVerifier = IVerifier(rotateVerifierAddr);
    }}

    function toLittleEndian64(uint64 v) public pure returns (bytes8) {{
        uint64 r = 0;
        r = r | ((v & 0xFF) << 56);
        r = r | (((v >> 8) & 0xFF) << 48);
        r = r | (((v >> 16) & 0xFF) << 40);
        r = r | (((v >> 24) & 0xFF) << 32);
        r = r | (((v >> 32) & 0xFF) << 24);
        r = r | (((v >> 40) & 0xFF) << 16);
        r = r | (((v >> 48) & 0xFF) << 8);
        r = r | ((v >> 56) & 0xFF);
        return bytes8(r);
    }}

    function reverse256(uint256 v) public pure returns (uint256) {{
        uint256 r = 0;
        for (uint256 i = 0; i < 32; i++) {{
            r = (r << 8) | ((v >> (8 * i)) & 0xFF);
        }}
        return r;
    }}

    function toPublicInputsCommitment(SyncStepInput calldata input)
            public pure returns (uint256) {{
        bytes32 h = sha256(abi.encodePacked(
            toLittleEndian64(input.attestedSlot),
            toLittleEndian64(input.finalizedSlot),
            toLittleEndian64(input.participation),
            input.finalizedHeaderRoot,
            input.executionPayloadRoot));
        uint256 le = reverse256(uint256(h));
        return le & ((1 << 253) - 1);
    }}

    function applyStep(SyncStepInput calldata input) internal {{
        require(input.participation > 2 * SYNC_COMMITTEE_SIZE / 3,
                "insufficient participation");
        if (input.finalizedSlot > head) {{
            head = input.finalizedSlot;
        }}
        blockHeaderRoots[input.finalizedSlot] = input.finalizedHeaderRoot;
        executionPayloadRoots[input.finalizedSlot] = input.executionPayloadRoot;
    }}

    function applyRotation(uint256 finalizedSlot,
                           uint256 nextCommitteePoseidon,
                           uint256 headerRootLo,
                           uint256 headerRootHi) internal {{
        bytes32 root = blockHeaderRoots[finalizedSlot];
        require(root != bytes32(0), "unknown finalized header");
        uint256 lo = uint256(root) & ((1 << 128) - 1);
        uint256 hi = uint256(root) >> 128;
        require(lo == headerRootLo, "header root mismatch");
        require(hi == headerRootHi, "header root mismatch");
        uint256 nextPeriod = finalizedSlot / SLOTS_PER_PERIOD + 1;
        require(syncCommitteePoseidons[nextPeriod] == 0,
                "period already rotated");
        syncCommitteePoseidons[nextPeriod] = nextCommitteePoseidon;
    }}

    function step(SyncStepInput calldata input, bytes calldata proof)
            external {{
        uint256 period = input.attestedSlot / SLOTS_PER_PERIOD;
        uint256 poseidon = syncCommitteePoseidons[period];
        require(poseidon != 0, "no committee for period");
        uint256 commitment = toPublicInputsCommitment(input);
        uint256[] memory instances = new uint256[](2);
        instances[0] = commitment;
        instances[1] = poseidon;
        require(stepVerifier.verify(instances, proof), "step proof invalid");
        applyStep(input);
    }}

    function rotate(uint256 finalizedSlot, uint256 nextCommitteePoseidon,
                    uint256 headerRootLo, uint256 headerRootHi,
                    bytes calldata proof) external {{
        uint256[] memory instances = new uint256[](3);
        instances[0] = nextCommitteePoseidon;
        instances[1] = headerRootLo;
        instances[2] = headerRootHi;
        require(rotateVerifier.verify(instances, proof),
                "rotate proof invalid");
        applyRotation(finalizedSlot, nextCommitteePoseidon, headerRootLo,
                      headerRootHi);
    }}

    // Compressed-proof entry points: aggregation-circuit statements carry
    // the deferred KZG accumulator as 12 x 88-bit limbs AHEAD of the app
    // instances (snark-verifier LimbsEncoding<3,88>; models/aggregation.py
    // get_instances = acc.limbs() ++ inner instances). The reference's
    // production RPC serves these proofs (`rpc.rs:46-163`); its contracts
    // submodule is absent from the snapshot, so the relayer-supplied
    // accumulator parameter is this repo's own ABI design.
    function stepCompressed(SyncStepInput calldata input,
                            uint256[12] calldata accumulator,
                            bytes calldata proof) external {{
        uint256 period = input.attestedSlot / SLOTS_PER_PERIOD;
        uint256 poseidon = syncCommitteePoseidons[period];
        require(poseidon != 0, "no committee for period");
        uint256 commitment = toPublicInputsCommitment(input);
        uint256[] memory instances = new uint256[](14);
        for (uint256 i = 0; i < 12; i++) {{
            instances[i] = accumulator[i];
        }}
        instances[12] = commitment;
        instances[13] = poseidon;
        require(stepVerifier.verify(instances, proof), "step proof invalid");
        applyStep(input);
    }}

    function rotateCompressed(uint256 finalizedSlot,
                              uint256 nextCommitteePoseidon,
                              uint256 headerRootLo, uint256 headerRootHi,
                              uint256[12] calldata accumulator,
                              bytes calldata proof) external {{
        uint256[] memory instances = new uint256[](15);
        for (uint256 i = 0; i < 12; i++) {{
            instances[i] = accumulator[i];
        }}
        instances[12] = nextCommitteePoseidon;
        instances[13] = headerRootLo;
        instances[14] = headerRootHi;
        require(rotateVerifier.verify(instances, proof),
                "rotate proof invalid");
        applyRotation(finalizedSlot, nextCommitteePoseidon, headerRootLo,
                      headerRootHi);
    }}
}}
"""


# ---------------------------------------------------------------------------
# executable interpretation of the emitted source
# ---------------------------------------------------------------------------

U256 = (1 << 256) - 1


class SolRevert(AssertionError):
    pass


class SolSpectre:
    """Executes the EMITTED Spectre.sol: parses storage declarations and
    function bodies from the source text and interprets them statement by
    statement. bytes32 values are Python ints (big-endian interpretation);
    verifier objects provide `.verify(instances, proof) -> bool`."""

    def __init__(self, spec, initial_sync_period: int,
                 initial_committee_poseidon: int,
                 step_verifier, rotate_verifier, src: str | None = None):
        self.src = src or gen_spectre_sol(spec)
        self.consts = {
            m.group(1): int(m.group(2)) for m in re.finditer(
                r"uint256 public constant (\w+) = (\d+);", self.src)}
        self.storage: dict = {"head": 0}
        for m in re.finditer(r"mapping\(uint256 => \w+\) public (\w+);",
                             self.src):
            self.storage[m.group(1)] = {}
        self.verifiers = {"stepVerifier": step_verifier,
                          "rotateVerifier": rotate_verifier}
        self.functions = self._parse_functions(self.src)
        # static return types (bytesN width matters inside encodePacked)
        self.ret_types = {
            m.group(1): m.group(2) for m in re.finditer(
                r"function (\w+)\([^)]*\)[^{]*returns \((\w+)\)", self.src)}
        # constructor semantics
        self.storage["syncCommitteePoseidons"][initial_sync_period] = \
            initial_committee_poseidon
        self.struct_fields = re.findall(r"(?:uint64|bytes32) (\w+);", self.src)

    @staticmethod
    def _parse_functions(src: str) -> dict:
        out = {}
        for m in re.finditer(
                r"function (\w+)\(([^)]*)\)[^{]*\{\n(.*?)\n    \}", src,
                re.S):
            name, params, body = m.groups()
            pnames = []
            for p in params.split(","):
                p = p.strip()
                if p:
                    pnames.append(p.split()[-1])
            out[name] = (pnames, body)
        return out

    # -- expression evaluation -----------------------------------------
    def call(self, name: str, *args):
        pnames, body = self.functions[name]
        assert len(args) == len(pnames), f"{name}: arg count"
        env = dict(zip(pnames, args))
        return self._exec_block(body.split("\n"), env)

    def _exec_block(self, lines: list[str], env: dict):
        i = 0
        while i < len(lines):
            s = lines[i].strip()
            i += 1
            if not s or s.startswith("//"):
                continue
            if s == "}":
                continue
            # for loop (reverse256): for (uint256 i = 0; i < 32; i++) {
            m = re.match(r"for \(uint256 (\w+) = (\d+); \1 < (\d+); \1\+\+\) \{", s)
            if m:
                var, lo, hi = m.group(1), int(m.group(2)), int(m.group(3))
                inner = []
                while lines[i].strip() != "}":
                    inner.append(lines[i])
                    i += 1
                i += 1
                for v in range(lo, hi):
                    env[var] = v
                    self._exec_block(inner, env)
                continue
            # if block
            m = re.match(r"if \((.*)\) \{", s)
            if m:
                inner = []
                while lines[i].strip() != "}":
                    inner.append(lines[i])
                    i += 1
                i += 1
                if self._eval(m.group(1), env):
                    r = self._exec_block(inner, env)
                    if r is not None:
                        return r
                continue
            # multi-line statements: join until ';'
            while not s.endswith(";"):
                s += " " + lines[i].strip()
                i += 1
            s = s[:-1]
            r = self._stmt(s, env)
            if r is not None:
                return r
        return None

    def _stmt(self, s: str, env: dict):
        m = re.match(r"require\((.*), \"(.*)\"\)$", s, re.S)
        if m:
            if not self._eval(m.group(1), env):
                raise SolRevert(m.group(2))
            return None
        if s.startswith("return "):
            return self._eval(s[len("return "):], env)
        # bare internal call (applyStep/applyRotation protocol tails)
        m = re.match(r"(\w+)\((.*)\)$", s, re.S)
        if m and m.group(1) in self.functions:
            args = [self._eval(a, env)
                    for a in self._split_args(m.group(2))]
            self.call(m.group(1), *args)
            return None
        # declarations / assignments (incl. mapping writes)
        m = re.match(r"(?:uint256|bytes32|bytes8|uint64|uint256\[\] memory)"
                     r" (\w+) = (.*)$", s, re.S)
        if m:
            env[m.group(1)] = self._eval(m.group(2), env)
            return None
        m = re.match(r"(\w+)\[(.*?)\] = (.*)$", s)
        if m and m.group(1) in self.storage:
            self.storage[m.group(1)][self._eval(m.group(2), env)] = \
                self._eval(m.group(3), env)
            return None
        if m and isinstance(env.get(m.group(1)), list):
            env[m.group(1)][self._eval(m.group(2), env)] = \
                self._eval(m.group(3), env)
            return None
        m = re.match(r"(\w+) = (.*)$", s, re.S)
        if m:
            name, rhs = m.groups()
            if name in self.storage and not isinstance(
                    self.storage.get(name), dict):
                self.storage[name] = self._eval(rhs, env)
            else:
                env[name] = self._eval(rhs, env)
            return None
        raise ValueError(f"unhandled statement: {s!r}")

    def _eval(self, e: str, env: dict):
        e = e.strip()
        # verifier external calls
        m = re.match(r"(stepVerifier|rotateVerifier)\.verify\((\w+), (\w+)\)$", e)
        if m:
            return bool(self.verifiers[m.group(1)].verify(
                env[m.group(2)], env[m.group(3)]))
        # sha256(abi.encodePacked(...)) over the whole expression
        m = re.match(r"sha256\(abi\.encodePacked\((.*)\)\)$", e, re.S)
        if m:
            data = b""
            for part in self._split_args(m.group(1)):
                v = self._eval(part, env)
                # packed width from the expression's static type: calls to
                # bytes8-returning helpers pack 8 bytes, bytes32 packs 32
                width = 32
                cm = re.match(r"(\w+)\(", part.strip())
                if cm and self.ret_types.get(cm.group(1)) == "bytes8":
                    width = 8
                data += v if isinstance(v, bytes) else \
                    int(v).to_bytes(width, "big")
            return int.from_bytes(hashlib.sha256(data).digest(), "big")
        # internal function calls
        m = re.match(r"(\w+)\((.*)\)$", e, re.S)
        if m and m.group(1) in self.functions:
            args = [self._eval(a, env) for a in self._split_args(m.group(2))]
            return self.call(m.group(1), *args)
        # casts that are identity here (ints model both words and bytesN);
        # only when the cast's paren closes at the END (not `uint256(x) & y`)
        for cast in ("uint256", "bytes32", "bytes8", "uint64", "IVerifier"):
            if e.startswith(cast + "(") and e.endswith(")") and \
                    self._balanced(e[len(cast):]):
                inner = e[len(cast) + 1:-1]
                v = self._eval(inner, env)
                if cast == "uint64":
                    return int(v) & ((1 << 64) - 1)
                return v
        if e.startswith("new uint256[](") and e.endswith(")"):
            return [0] * int(e[len("new uint256[]("):-1])
        m = re.match(r"bytes32\((\d+)\)$", e)
        if m:
            return int(m.group(1))
        # struct field access: input.attestedSlot
        m = re.match(r"(\w+)\.(\w+)$", e)
        if m and isinstance(env.get(m.group(1)), dict):
            return env[m.group(1)][m.group(2)]
        # mapping/array index
        m = re.match(r"(\w+)\[(.*)\]$", e)
        if m:
            container = (self.storage.get(m.group(1))
                         if m.group(1) in self.storage else env.get(m.group(1)))
            idx = self._eval(m.group(2), env)
            if isinstance(container, dict):
                return container.get(idx, 0)
            return container[idx]
        if e in self.consts:
            return self.consts[e]
        if e in self.storage and not isinstance(self.storage[e], dict):
            return self.storage[e]
        if e in env:
            return env[e]
        if re.fullmatch(r"\d+", e):
            return int(e)
        if re.fullmatch(r"0x[0-9a-fA-F]+", e):
            return int(e, 16)
        # general arithmetic/comparison expression over the subset grammar:
        # rewrite identifiers/indices/calls recursively via tokens
        return self._eval_expr(e, env)

    _TOKEN = re.compile(r"\w+\[[^\]]*\]|\w+\(\w*\)|\w+\.\w+|0x[0-9a-fA-F]+"
                        r"|\w+|<<|>>|[()&|+*/%-]|==|!=|<=|>=|<|>")

    def _eval_expr(self, e: str, env: dict):
        # evaluate leaf tokens, then hand the arithmetic to Python (the
        # subset uses only |, &, <<, >>, +, -, *, /, comparisons, parens)
        def repl(m):
            t = m.group(0)
            if t in ("<<", ">>", "==", "!=", "<=", ">=", "<", ">") or \
                    t in "()&|+-*/%":
                return t
            if re.fullmatch(r"\d+", t):
                return t
            if re.fullmatch(r"0x[0-9a-fA-F]+", t):
                return str(int(t, 16))     # decimal-normalize for the guard
            return str(int(self._eval(t, env)))

        py = self._TOKEN.sub(repl, e)
        py = py.replace("/", "//")
        # after substitution only integer literals, operators, and parens may
        # remain — anything else (stray identifier from caller-supplied src)
        # must not reach eval; a raise (not assert) so -O cannot strip it
        if not re.fullmatch(r"[0-9\s()&|+*/%<>=!-]*", py):
            raise ValueError(f"non-arithmetic residue in expression: {py!r}")
        val = eval(py, {"__builtins__": {}}, {})  # noqa: S307 — token-filtered
        if isinstance(val, bool):
            return val
        return int(val) & U256

    @staticmethod
    def _balanced(s: str) -> bool:
        """True iff s is one (...) group: depth returns to 0 only at the end."""
        depth = 0
        for i, ch in enumerate(s):
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
                if depth == 0:
                    return i == len(s) - 1
        return False

    @staticmethod
    def _split_args(s: str) -> list[str]:
        out, depth, cur = [], 0, ""
        for ch in s:
            if ch == "," and depth == 0:
                out.append(cur)
                cur = ""
                continue
            if ch in "([":
                depth += 1
            if ch in ")]":
                depth -= 1
            cur += ch
        if cur.strip():
            out.append(cur)
        return out

    # -- python-facing helpers (same shapes as contracts.spectre model) --
    def step(self, inp, proof: bytes):
        sin = {"attestedSlot": inp.attested_slot,
               "finalizedSlot": inp.finalized_slot,
               "participation": inp.participation,
               "finalizedHeaderRoot": int.from_bytes(
                   inp.finalized_header_root, "big"),
               "executionPayloadRoot": int.from_bytes(
                   inp.execution_payload_root, "big")}
        return self.call("step", sin, proof)

    def rotate(self, finalized_slot: int, next_poseidon: int,
               lo: int, hi: int, proof: bytes):
        return self.call("rotate", finalized_slot, next_poseidon, lo, hi,
                         proof)

    def step_compressed(self, inp, accumulator: list, proof: bytes):
        sin = {"attestedSlot": inp.attested_slot,
               "finalizedSlot": inp.finalized_slot,
               "participation": inp.participation,
               "finalizedHeaderRoot": int.from_bytes(
                   inp.finalized_header_root, "big"),
               "executionPayloadRoot": int.from_bytes(
                   inp.execution_payload_root, "big")}
        return self.call("stepCompressed", sin, list(accumulator), proof)

    def rotate_compressed(self, finalized_slot: int, next_poseidon: int,
                          lo: int, hi: int, accumulator: list,
                          proof: bytes):
        return self.call("rotateCompressed", finalized_slot, next_poseidon,
                         lo, hi, list(accumulator), proof)

    @property
    def head(self) -> int:
        return self.storage["head"]
