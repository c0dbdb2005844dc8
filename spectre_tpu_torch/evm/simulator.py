"""Executable oracle for generated verifier contracts (NOT an EVM; the
port's copy of `spectre_tpu/evm/simulator.py`).

The generator emits a tiny, regular Solidity subset (uint256 locals,
addmod/mulmod, keccak over abi.encodePacked, calldata slices, the helper
functions backed by precompiles). This module translates that subset to
Python line-by-line and executes it with host BN254 ops standing in for the
precompiles — so tests can run the ACTUAL generated code against real
proofs and tampered ones. Solidity-compiler semantics (gas, memory) are out
of scope; arithmetic, transcript replay, offsets, and the pairing equation
are exactly what is exercised.

Reference-parity note: the reference tests its generated Yul with revm
(`evm_verify`, SURVEY.md N11); this simulator is the offline stand-in until
an EVM toolchain is available.
"""

from __future__ import annotations

import re

from ..fields import bn254
from ..plonk.transcript import keccak256 as _keccak

R = bn254.R
Q = bn254.P


class _U32(int):
    pass


class _Abi:
    @staticmethod
    def encodePacked(*args):
        out = b""
        for a in args:
            if isinstance(a, _U32):
                out += int(a).to_bytes(4, "big")
            elif isinstance(a, (bytes, bytearray)):
                out += bytes(a)
            else:
                raise TypeError(f"encodePacked: {type(a)}")
        return out


def _translate(body_lines: list[str]) -> str:
    py = []
    indent = 1
    for raw in body_lines:
        s = raw.strip()
        if not s or s.startswith("//"):
            continue
        if s == "{":
            continue
        if s == "}":
            if indent > 1:
                indent -= 1
            continue
        # for-loop over instances / eval canonicity
        m = re.match(r"for \(uint256 (\w+) = (\w+); \1 < instances\.length; "
                     r"\1\+\+\) \{", s)
        if m:
            py.append("    " * indent + f"for {m.group(1)} in range(len(instances)):")
            indent += 1
            continue
        m = re.match(r"for \(uint256 (\w+) = (\d+); \1 < (\d+); \1 \+= 32\) "
                     r"\{ (.*) \}", s)
        if m:
            var, lo, hi, inner = m.groups()
            py.append("    " * indent +
                      f"for {var} in range({lo}, {hi}, 32):")
            py.append("    " * (indent + 1) + _stmt(inner))
            continue
        if s.endswith("{") and s.startswith("for"):
            raise ValueError(f"unhandled loop: {s}")
        py.append("    " * indent + _stmt(s))
        # closing of one-line instance loop bodies is handled by '}' lines,
        # which only pop nested indents
        if s.endswith("{"):
            indent += 1
    return "\n".join(py)


def _stmt(s: str) -> str:
    s = s.rstrip()
    if s.endswith(";"):
        s = s[:-1]
    # declarations (typed-with-initializer first, then bare declarations)
    s = re.sub(r"uint256\[(\d+)\] memory (\w+) = ", r"\2 = ", s)
    s = re.sub(r"uint256\[(\d+)\] memory (\w+)$", r"\2 = [0] * \1", s)
    s = re.sub(r"^bytes32 (\w+) = ", r"\1 = ", s)
    s = re.sub(r"^bytes memory (\w+)$", r"\1 = b''", s)
    s = re.sub(r"^uint256 (\w+) = ", r"\1 = ", s)
    # casts and literals
    s = re.sub(r"(\w+)\.length", r"len(\1)", s)
    s = re.sub(r'hex"([0-9a-fA-F]+)"', r'bytes.fromhex("\1")', s)
    s = re.sub(r"uint32\((\d+)\)", r"_U32(\1)", s)
    # require
    m = re.match(r'require\((.*), "(.*)"\)$', s)
    if m:
        cond = m.group(1).replace("&&", "and")
        return f"assert {cond}, {m.group(2)!r}"
    # guard returns: if (!cond) { return false; }
    m = re.match(r"if \(!(.*)\) \{ return false; \}$", s)
    if m:
        cond = m.group(1).replace("&&", "and")
        return f"if not ({cond}): return False"
    s = s.replace("return false", "return False").replace(
        "return true", "return True")
    assert "uint256[" not in s, f"untranslated: {s}"
    return s


def _final_src(body: str) -> str:
    return body.replace("abi.encodePacked", "abi_encodePacked")


def run_verifier(sol_src: str, instances: list, proof: bytes) -> bool:
    """Execute the verify() body of a generated contract."""
    m = re.search(r"function verify\(.*?\{\n(.*)\n\s*\}\n\}", sol_src,
                  re.DOTALL)
    assert m, "verify body not found"
    body_lines = m.group(1).split("\n")
    consts = {}
    for name in ("R_MOD", "Q_MOD", "POW256"):
        cm = re.search(rf"constant {name} =\s*(0x[0-9a-fA-F]+)", sol_src)
        consts[name] = int(cm.group(1), 16)
    for name in ("INIT_STATE", "VK_DIGEST"):
        cm = re.search(rf"constant {name} =\s*(0x[0-9a-fA-F]+)", sol_src)
        consts[name] = bytes.fromhex(cm.group(1)[2:])

    g1 = bn254.g1_curve

    def to_pt(xy):
        x, y = int(xy[0]), int(xy[1])
        if x == 0 and y == 0:
            return None
        pt = (bn254.Fq(x), bn254.Fq(y))
        assert g1.is_on_curve(pt), "precompile: point not on curve"
        return pt

    def from_pt(pt):
        if pt is None:
            return [0, 0]
        return [int(pt[0]), int(pt[1])]

    env = {
        "instances": [int(v) for v in instances],
        "proof": bytes(proof),
        "abi_encodePacked": _Abi.encodePacked,
        "_U32": _U32,
        "keccak256": _keccak,
        "addmod": lambda a, b, m: (a + b) % m,
        "mulmod": lambda a, b, m: (a * b) % m,
        "uint256": lambda v: int.from_bytes(v, "big")
            if isinstance(v, (bytes, bytearray)) else int(v),
        "bytes32": lambda v: int(v).to_bytes(32, "big")
            if isinstance(v, int) else bytes(v),
        "_wide": lambda h: ((int.from_bytes(h, "big") % R)
                            * ((1 << 256) % R)
                            + int.from_bytes(_keccak(h), "big")) % R,
        "_pow": lambda b, e: pow(b, e, R),
        "_inv": lambda a: pow(a, -1, R),
        "_ecMul": lambda p, s: from_pt(g1.mul_unsafe(to_pt(p), s % R)),
        "_ecAdd": lambda p, q: from_pt(g1.add(to_pt(p), to_pt(q))),
        "_negPt": lambda p: [p[0], (Q - p[1]) % Q] if p != [0, 0] else p,
        "_pairing": lambda pin: bn254.pairing_check([
            (to_pt(pin[0:2]), _g2(pin[2:6])),
            (to_pt(pin[6:8]), _g2(pin[8:12])),
        ]),
    }
    env.update(consts)

    py_body = _final_src(_translate(body_lines))
    src = "def _verify():\n" + py_body + "\n"
    exec(src, env)
    try:
        return bool(env["_verify"]())
    except AssertionError:
        return False


def _g2(words):
    # precompile ordering: (x_c1, x_c0, y_c1, y_c0)
    return (bn254.Fq2([int(words[1]), int(words[0])]),
            bn254.Fq2([int(words[3]), int(words[2])]))
