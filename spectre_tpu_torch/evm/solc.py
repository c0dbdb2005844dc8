"""Compiler: generated-verifier Solidity subset -> EVM bytecode (the port's
copy of `spectre_tpu/evm/solc.py`: the same bytes for the same source).

The reference's generated Yul is compiled by solc and executed in revm
(SURVEY.md N11, `prover/src/cli.rs:249-277`). No solc exists offline, but
none is needed: `evm/codegen.py` emits a closed, regular Solidity subset —
uint256 locals and fixed arrays, addmod/mulmod, keccak over
`abi.encodePacked`, calldata slices, precompile-backed helpers, two loop
shapes, `require`, guard-returns. This module compiles exactly that subset
to real EVM bytecode (runtime + deploy init code), so the generated
verifiers get ACTUAL deployed-code sizes (EIP-170 is a measurement, not an
estimate) and ACTUAL metered gas when executed in `evm/vm.py`.

Semantics notes (all hold on codegen's output, asserted where cheap):
- arithmetic outside mulmod/addmod never over/underflows (operands are
  range-checked field values / shifted 88-bit limbs), so unchecked EVM
  ADD/SUB match Solidity 0.8's checked ops on the non-reverting domain;
- `&&` compiles to bitwise AND of 0/1 values (operands are effect-free
  comparisons, so short-circuit is unobservable);
- helper functions (`_inv`, `_pow`, `_wide`, `_ecMul`, `_ecAdd`, `_negPt`,
  `_pairing`) become internal subroutines performing real STATICCALLs to
  precompile addresses 0x5-0x8 — the same calls solc emits for them;
- one `bytes memory` variable (the instance absorb buffer) is supported,
  as an append-only region sized from the static instance count.

Layout: scratch 0x00, big-modulus constants cached in memory (R_MOD/Q_MOD
appear thousands of times; MLOAD costs 3 bytes vs PUSH32's 33), calldata
ABI pointers, the staticcall buffer, then named variables / the `t[]`
temp array / the absorb buffers, assigned by the assembler.
"""

from __future__ import annotations

import re

# ---- memory map (fixed region) ----
SCRATCH = 0x00
CONST_R = 0x40
CONST_Q = 0x60
INSTLEN = 0x80
INSTDATA = 0xA0
PROOFLEN = 0xC0
PROOFDATA = 0xE0
CUR = 0x100
CALLBUF = 0x120           # 384 B staticcall arg/ret area, ends 0x2a0
VARS_BASE = 0x2A0

OPS = {
    "STOP": 0x00, "ADD": 0x01, "MUL": 0x02, "SUB": 0x03, "DIV": 0x04,
    "MOD": 0x06, "ADDMOD": 0x08, "MULMOD": 0x09, "EXP": 0x0A,
    "LT": 0x10, "GT": 0x11, "EQ": 0x14, "ISZERO": 0x15, "AND": 0x16,
    "OR": 0x17, "XOR": 0x18, "NOT": 0x19, "BYTE": 0x1A, "SHL": 0x1B,
    "SHR": 0x1C, "SHA3": 0x20, "CALLVALUE": 0x34, "CALLDATALOAD": 0x35,
    "CALLDATASIZE": 0x36, "CALLDATACOPY": 0x37, "CODESIZE": 0x38,
    "CODECOPY": 0x39, "RETURNDATASIZE": 0x3D, "RETURNDATACOPY": 0x3E,
    "POP": 0x50, "MLOAD": 0x51, "MSTORE": 0x52, "MSTORE8": 0x53,
    "SLOAD": 0x54, "SSTORE": 0x55,
    "JUMP": 0x56, "JUMPI": 0x57, "PC": 0x58, "GAS": 0x5A,
    "JUMPDEST": 0x5B, "ADDRESS": 0x30, "CALLER": 0x33,
    "CALL": 0xF1, "RETURN": 0xF3, "STATICCALL": 0xFA, "REVERT": 0xFD,
}
for _i in range(16):
    OPS[f"DUP{_i + 1}"] = 0x80 + _i
    OPS[f"SWAP{_i + 1}"] = 0x90 + _i


# ======================================================================
# tokenizer / parser for the statement subset
# ======================================================================

_TOKEN_RE = re.compile(
    r'\s+|//[^\n]*'
    r'|hex"(?P<hex>[0-9a-fA-F]*)"'
    r'|"(?P<str>[^"]*)"'
    r'|(?P<num>0x[0-9a-fA-F]+|\d+)'
    r'|(?P<id>[A-Za-z_$]\w*)'
    r'|(?P<op><<|>>|\+\+|\+=|==|!=|&&|[-+*/!<>=&|(),;:\[\]{}.])')


def _tokenize(s: str):
    toks, pos = [], 0
    while pos < len(s):
        m = _TOKEN_RE.match(s, pos)
        if not m:
            raise SyntaxError(f"bad token at: {s[pos:pos + 30]!r}")
        pos = m.end()
        if m.group("hex") is not None:
            toks.append(("hex", bytes.fromhex(m.group("hex"))))
        elif m.group("str") is not None:
            toks.append(("str", m.group("str")))
        elif m.group("num") is not None:
            toks.append(("num", int(m.group("num"), 0)))
        elif m.group("id") is not None:
            toks.append(("id", m.group("id")))
        elif m.group("op") is not None:
            toks.append(("op", m.group("op")))
    return toks


class _Parser:
    def __init__(self, toks):
        self.toks = toks
        self.i = 0

    def peek(self, k=0):
        j = self.i + k
        return self.toks[j] if j < len(self.toks) else (None, None)

    def next(self):
        t = self.peek()
        self.i += 1
        return t

    def eat(self, kind, val=None):
        k, v = self.next()
        if k != kind or (val is not None and v != val):
            raise SyntaxError(f"expected {kind} {val}, got {k} {v}")
        return v

    def at(self, kind, val=None):
        k, v = self.peek()
        return k == kind and (val is None or v == val)

    # expression grammar (loosest to tightest): && > cmp > | > & > shift
    # > additive > multiplicative > unary > postfix > primary. The emitted
    # sources parenthesize every mixed-precedence site, so only relative
    # order within each chain matters.
    def expr(self):
        e = self.cmp()
        while self.at("op", "&&"):
            self.next()
            e = ("bin", "&&", e, self.cmp())
        return e

    def cmp(self):
        e = self.bitor()
        while self.at("op", "<") or self.at("op", "==") or \
                self.at("op", "!=") or self.at("op", ">"):
            op = self.next()[1]
            e = ("bin", op, e, self.bitor())
        return e

    def bitor(self):
        e = self.bitand()
        while self.at("op", "|"):
            self.next()
            e = ("bin", "|", e, self.bitand())
        return e

    def bitand(self):
        e = self.shift()
        while self.at("op", "&"):
            self.next()
            e = ("bin", "&", e, self.shift())
        return e

    def shift(self):
        e = self.add()
        while self.at("op", "<<") or self.at("op", ">>"):
            op = self.next()[1]
            e = ("bin", op, e, self.add())
        return e

    def add(self):
        e = self.mult()
        while self.at("op", "+") or self.at("op", "-"):
            op = self.next()[1]
            e = ("bin", op, e, self.mult())
        return e

    def mult(self):
        e = self.unary()
        while self.at("op", "*") or self.at("op", "/"):
            op = self.next()[1]
            e = ("bin", op, e, self.unary())
        return e

    def unary(self):
        if self.at("op", "!"):
            self.next()
            return ("not", self.unary())
        return self.postfix()

    def postfix(self):
        e = self.primary()
        while True:
            if self.at("op", "["):
                self.next()
                lo = self.expr()
                if self.at("op", ":"):
                    self.next()
                    hi = self.expr()
                    self.eat("op", "]")
                    e = ("slice", e, lo, hi)
                else:
                    self.eat("op", "]")
                    e = ("index", e, lo)
            elif self.at("op", "."):
                self.next()
                name = self.eat("id")
                if name == "length":
                    e = ("length", e)
                elif name == "encodePacked":  # abi.encodePacked(...)
                    self.eat("op", "(")
                    args = self._args()
                    e = ("packed", args)
                elif self.at("op", "("):      # method call: x.f(...)
                    self.next()
                    e = ("method", e, name, self._args())
                else:                         # struct member: x.f
                    e = ("member", e, name)
            else:
                return e

    def _args(self):
        args = []
        if not self.at("op", ")"):
            args.append(self.expr())
            while self.at("op", ","):
                self.next()
                args.append(self.expr())
        self.eat("op", ")")
        return args

    def primary(self):
        k, v = self.peek()
        if k == "num":
            self.next()
            return ("num", v)
        if k == "hex":
            self.next()
            return ("hexlit", v)
        if k == "op" and v == "(":
            self.next()
            e = self.expr()
            self.eat("op", ")")
            return e
        if k == "op" and v == "[":
            self.next()
            items = [self.expr()]
            while self.at("op", ","):
                self.next()
                items.append(self.expr())
            self.eat("op", "]")
            return ("arraylit", items)
        if k == "id":
            self.next()
            if self.at("op", "("):
                self.next()
                return ("call", v, self._args())
            return ("var", v)
        raise SyntaxError(f"unexpected {k} {v}")


# ======================================================================
# assembler
# ======================================================================

class Asm:
    """Instruction stream with symbolic labels and variable slots."""

    def __init__(self):
        self.items: list = []     # ("b", bytes)|("pushl", lbl)|("label", lbl)
        self._lbl = 0

    def op(self, *names):
        self.items.append(("b", bytes(OPS[n] for n in names)))

    def push(self, v: int):
        self.items.append(("b", _push_bytes(v)))

    def pushl(self, label: str):
        self.items.append(("pushl", label))

    def label(self, name: str):
        self.items.append(("label", name))
        self.op("JUMPDEST")

    def fresh_label(self, base: str) -> str:
        self._lbl += 1
        return f"{base}_{self._lbl}"

    def assemble(self) -> bytes:
        for width in (2, 3, 4):
            offs, size = {}, 0
            for it in self.items:
                if it[0] == "b":
                    size += len(it[1])
                elif it[0] == "pushl":
                    size += 1 + width
                else:
                    offs[it[1]] = size
            if size < (1 << (8 * width)):
                out = bytearray()
                for it in self.items:
                    if it[0] == "b":
                        out += it[1]
                    elif it[0] == "pushl":
                        out.append(0x5F + width)
                        out += offs[it[1]].to_bytes(width, "big")
                return bytes(out)
        raise AssertionError("code too large to assemble")


# ======================================================================
# compiler
# ======================================================================

class _Compiler:
    def __init__(self, consts: dict, num_instances: int):
        self.a = Asm()
        self.consts = consts
        self.num_instances = num_instances
        self.slots: dict[str, int] = {}   # name -> offset
        self.arrays: dict[str, int] = {}  # name -> length (slots)
        self.bytes_var: str | None = None
        self.next_off = VARS_BASE
        self.revert_msgs: dict[str, str] = {}   # msg -> label
        self.used_subs: set[str] = set()
        self.instbuf = None               # data offset for the bytes var

    # ---- slot management -------------------------------------------
    def slot(self, name: str, length: int = 1) -> int:
        if name not in self.slots:
            self.slots[name] = self.next_off
            self.next_off += 32 * length
            if length > 1:
                self.arrays[name] = length
        return self.slots[name]

    def is_array(self, name: str) -> bool:
        return name in self.arrays

    # ---- expression compilation ------------------------------------
    def const_word(self, name: str):
        """Emit a contract-level constant."""
        if name == "R_MOD":
            self.a.push(CONST_R)
            self.a.op("MLOAD")
        elif name == "Q_MOD":
            self.a.push(CONST_Q)
            self.a.op("MLOAD")
        else:
            v = self.consts[name]
            self.a.push(v if isinstance(v, int)
                        else int.from_bytes(v, "big"))

    def eval_scalar(self, e):
        """Compile e, leaving exactly one word on the stack."""
        a = self.a
        kind = e[0]
        if kind == "num":
            a.push(e[1])
        elif kind == "var":
            name = e[1]
            if name in self.consts or name in ("R_MOD", "Q_MOD"):
                self.const_word(name)
            elif self.is_array(name):
                raise SyntaxError(f"array {name} used as scalar")
            else:
                a.push(self.slot(name))
                a.op("MLOAD")
        elif kind == "bin":
            self.eval_bin(e)
        elif kind == "not":
            self.eval_scalar(e[1])
            a.op("ISZERO")
        elif kind == "length":
            base = e[1]
            assert base[0] == "var"
            if base[1] == "instances":
                a.push(INSTLEN)
            elif base[1] == "proof":
                a.push(PROOFLEN)
            elif base[1] == self.bytes_var:
                a.push(self.slot(self.bytes_var))
            else:
                raise SyntaxError(f"length of {base[1]}")
            a.op("MLOAD")
        elif kind == "index":
            self.eval_index(e)
        elif kind == "call":
            self.eval_call(e)
        elif kind == "slice":
            # bare slice in scalar context: 32-byte calldata word
            self.eval_slice_word(e)
        else:
            raise SyntaxError(f"scalar: {e}")

    def eval_bin(self, e):
        _, op, l, r = e
        a = self.a
        if op in ("+", "-", "*", "/", "&", "|"):
            # EVM binops pop (top, next) as (a, b) -> a op b
            self.eval_scalar(r)
            self.eval_scalar(l)
            a.op({"+": "ADD", "-": "SUB", "*": "MUL", "/": "DIV",
                  "&": "AND", "|": "OR"}[op])
        elif op in ("<<", ">>"):
            self.eval_scalar(l)          # value
            self.eval_scalar(r)          # shift (top)
            a.op("SHL" if op == "<<" else "SHR")
        elif op == "<":
            self.eval_scalar(r)
            self.eval_scalar(l)
            a.op("LT")
        elif op == ">":
            self.eval_scalar(r)
            self.eval_scalar(l)
            a.op("GT")
        elif op == "==":
            self.eval_scalar(l)
            self.eval_scalar(r)
            a.op("EQ")
        elif op == "!=":
            self.eval_scalar(l)
            self.eval_scalar(r)
            a.op("EQ", "ISZERO")
        elif op == "&&":
            self.eval_scalar(l)
            self.eval_scalar(r)
            a.op("AND")
        else:
            raise SyntaxError(f"binop {op}")

    def eval_index(self, e):
        _, base, idx = e
        a = self.a
        assert base[0] == "var"
        name = base[1]
        if name == "instances":
            self.eval_scalar(idx)
            a.push(5)
            a.op("SHL")
            a.push(INSTDATA)
            a.op("MLOAD", "ADD", "CALLDATALOAD")
        elif name == "proof":
            raise SyntaxError("proof must be sliced, not indexed")
        elif self.is_array(name):
            if idx[0] == "num":
                a.push(self.slot(name) + 32 * idx[1])
            else:
                self.eval_scalar(idx)
                a.push(5)
                a.op("SHL")
                a.push(self.slot(name))
                a.op("ADD")
            a.op("MLOAD")
        elif name == "t":
            raise SyntaxError("t[] must be declared before use")
        else:
            raise SyntaxError(f"index into {name}")

    def eval_slice_word(self, e):
        """proof[a:b] with b-a == 32 as a calldata word."""
        _, base, lo, hi = e
        assert base == ("var", "proof"), f"slice of {base}"
        if lo[0] == "num" and hi[0] == "num":
            assert hi[1] - lo[1] == 32, "scalar slice must be 32 bytes"
            self.a.push(PROOFDATA)
            self.a.op("MLOAD")
            if lo[1]:
                self.a.push(lo[1])
                self.a.op("ADD")
        else:
            # dynamic offset (eval-canonicity loop): hi must be lo+32
            self.eval_scalar(lo)
            self.a.push(PROOFDATA)
            self.a.op("MLOAD", "ADD")
        self.a.op("CALLDATALOAD")

    def eval_pair(self, e):
        """Compile a G1-point expression: two words, y on top."""
        a = self.a
        if e[0] == "arraylit":
            assert len(e[1]) == 2
            self.eval_scalar(e[1][0])
            self.eval_scalar(e[1][1])
        elif e[0] == "var" and self.is_array(e[1]):
            base = self.slot(e[1])
            a.push(base)
            a.op("MLOAD")
            a.push(base + 32)
            a.op("MLOAD")
        elif e[0] == "call" and e[1] in ("_ecMul", "_ecAdd", "_negPt"):
            self.eval_call(e)
        else:
            raise SyntaxError(f"pair: {e}")

    def call_sub(self, name: str, nargs_push):
        """Internal-call convention: [ret, args...] -> sub -> [rets...]."""
        a = self.a
        ret = a.fresh_label(f"ret_{name}")
        a.pushl(ret)
        nargs_push()
        a.pushl(f"sub_{name}")
        a.op("JUMP")
        a.label(ret)
        self.used_subs.add(name)

    def eval_call(self, e):
        _, fname, args = e
        a = self.a
        if fname in ("mulmod", "addmod"):
            self.eval_scalar(args[2])
            self.eval_scalar(args[1])
            self.eval_scalar(args[0])
            a.op("MULMOD" if fname == "mulmod" else "ADDMOD")
        elif fname in ("uint256", "bytes32"):
            self.eval_scalar(args[0])
        elif fname == "_inv":
            self.call_sub("inv", lambda: self.eval_scalar(args[0]))
        elif fname == "_pow":
            def push_args():
                self.eval_scalar(args[0])
                self.eval_scalar(args[1])
            self.call_sub("pow", push_args)
        elif fname == "_wide":
            self.call_sub("wide", lambda: self.eval_scalar(args[0]))
        elif fname == "_ecMul":
            def push_args():
                self.eval_pair(args[0])
                self.eval_scalar(args[1])
            self.call_sub("ecmul", push_args)
        elif fname == "_ecAdd":
            def push_args():
                self.eval_pair(args[0])
                self.eval_pair(args[1])
            self.call_sub("ecadd", push_args)
        elif fname == "_negPt":
            self.call_sub("negpt", lambda: self.eval_pair(args[0]))
        elif fname == "_pairing":
            assert args[0][0] == "var" and self.arrays.get(args[0][1]) == 12
            self.call_sub(
                "pairing", lambda: a.push(self.slot(args[0][1])))
        elif fname == "keccak256":
            assert args[0][0] == "packed"
            self.eval_packed_keccak(args[0][1])
        else:
            raise SyntaxError(f"call {fname}")

    # ---- abi.encodePacked staging ----------------------------------
    def _cur_load(self):
        self.a.push(CUR)
        self.a.op("MLOAD")

    def _cur_add(self, n: int):
        a = self.a
        a.push(CUR)
        a.op("MLOAD")
        a.push(n)
        a.op("ADD")
        a.push(CUR)
        a.op("MSTORE")

    def eval_packed_keccak(self, chunks):
        """keccak256(abi.encodePacked(...)) -> hash word on the stack."""
        a = self.a
        a.pushl("__absorb")          # runtime-resolved absorb base
        a.push(CUR)
        a.op("MSTORE")
        for ch in chunks:
            self.write_chunk(ch)
        # size = CUR - base ; SHA3(base, size)
        a.pushl("__absorb")
        a.push(CUR)
        a.op("MLOAD", "SUB")         # size = cur - base
        a.pushl("__absorb")
        a.op("SHA3")

    def write_chunk(self, ch):
        a = self.a
        if ch[0] == "hexlit":
            assert len(ch[1]) == 1, "only single-byte hex literals"
            a.push(ch[1][0])
            self._cur_load()
            a.op("MSTORE8")
            self._cur_add(1)
        elif ch[0] == "call" and ch[1] == "uint32":
            assert ch[2][0][0] == "num"
            a.push(ch[2][0][1] << 224)
            self._cur_load()
            a.op("MSTORE")
            self._cur_add(4)
        elif ch[0] == "slice":
            _, base, lo, hi = ch
            assert base == ("var", "proof")
            assert lo[0] == "num" and hi[0] == "num", "absorb slice static"
            size = hi[1] - lo[1]
            a.push(size)
            a.push(PROOFDATA)
            a.op("MLOAD")
            if lo[1]:
                a.push(lo[1])
                a.op("ADD")
            self._cur_load()
            a.op("CALLDATACOPY")
            self._cur_add(size)
        elif ch[0] == "var" and ch[1] == self.bytes_var:
            self.write_bytes_copy()
        else:
            # 32-byte word chunk (h, VK_DIGEST, bytes32(instances[i]), ...)
            self.eval_scalar(ch)
            self._cur_load()
            a.op("MSTORE")
            self._cur_add(32)

    def write_bytes_copy(self):
        """Append the bytes var to the absorb buffer (word-loop copy)."""
        a = self.a
        lenslot = self.slot(self.bytes_var)
        j = self.slot("__copy_j")
        loop = a.fresh_label("bcopy")
        done = a.fresh_label("bcopy_done")
        a.push(0)
        a.push(j)
        a.op("MSTORE")
        a.label(loop)
        # while j < len
        a.push(lenslot)
        a.op("MLOAD")
        a.push(j)
        a.op("MLOAD", "LT", "ISZERO")
        a.pushl(done)
        a.op("JUMPI")
        # mem[cur + j] = instbuf[j]
        a.push(j)
        a.op("MLOAD")
        a.pushl("__instbuf")
        a.op("ADD", "MLOAD")         # value
        a.push(j)
        a.op("MLOAD")
        self._cur_load()
        a.op("ADD", "MSTORE")
        # j += 32
        a.push(j)
        a.op("MLOAD")
        a.push(32)
        a.op("ADD")
        a.push(j)
        a.op("MSTORE")
        a.pushl(loop)
        a.op("JUMP")
        a.label(done)
        # cur += len (exact byte length)
        a.push(lenslot)
        a.op("MLOAD")
        a.push(CUR)
        a.op("MLOAD", "ADD")
        a.push(CUR)
        a.op("MSTORE")

    # ---- statements -------------------------------------------------
    def store_scalar(self, name: str):
        self.a.push(self.slot(name))
        self.a.op("MSTORE")

    def store_pair(self, name: str):
        base = self.slot(name, 2)
        self.a.push(base + 32)
        self.a.op("MSTORE")          # y (top)
        self.a.push(base)
        self.a.op("MSTORE")          # x

    def revert_label(self, msg: str) -> str:
        if msg not in self.revert_msgs:
            self.revert_msgs[msg] = f"rev_{len(self.revert_msgs)}"
        return self.revert_msgs[msg]

    def emit_require(self, cond, msg: str):
        self.eval_scalar(cond)
        self.a.op("ISZERO")
        self.a.pushl(self.revert_label(msg))
        self.a.op("JUMPI")

    def emit_revert_stubs(self):
        a = self.a
        for msg, lbl in self.revert_msgs.items():
            a.label(lbl)
            data = msg.encode()
            a.push(0x08C379A0)       # Error(string) selector (right-aligned)
            a.push(0)
            a.op("MSTORE")
            a.push(0x20)
            a.push(0x20)
            a.op("MSTORE")
            a.push(len(data))
            a.push(0x40)
            a.op("MSTORE")
            a.push(int.from_bytes(data.ljust(32, b"\x00"), "big"))
            a.push(0x60)
            a.op("MSTORE")
            a.push(0x64)             # 4 + 3*32
            a.push(0x1C)
            a.op("REVERT")

    def emit_return_bool_stubs(self):
        a = self.a
        a.label("ret_false")
        a.push(0)
        a.push(0)
        a.op("MSTORE")
        a.push(32)
        a.push(0)
        a.op("RETURN")

    # ---- subroutines -------------------------------------------------
    def _staticcall(self, addr: int, in_off: int, in_size: int,
                    out_off: int, out_size: int, fail_msg: str):
        a = self.a
        a.push(out_size)
        a.push(out_off)
        a.push(in_size)
        a.push(in_off)
        a.push(addr)
        a.op("GAS", "STATICCALL", "ISZERO")
        a.pushl(self.revert_label(fail_msg))
        a.op("JUMPI")

    def emit_subs(self):
        a = self.a
        R = self.consts["R_MOD"]
        if "inv" in self.used_subs or "pow" in self.used_subs:
            # inv(a) = pow(a, R-2); falls through into pow
            a.label("sub_inv")       # [ret, a]
            a.op("DUP1", "ISZERO")
            a.pushl(self.revert_label("inv(0)"))
            a.op("JUMPI")
            a.push(R - 2)            # [ret, a, e]
            a.label("sub_pow")       # [ret, base, e]
            a.push(CALLBUF + 128)
            a.op("MSTORE")           # e
            a.push(CALLBUF + 96)
            a.op("MSTORE")           # base
            a.push(32)
            a.push(CALLBUF)
            a.op("MSTORE")
            a.push(32)
            a.push(CALLBUF + 32)
            a.op("MSTORE")
            a.push(32)
            a.push(CALLBUF + 64)
            a.op("MSTORE")
            self.const_word("R_MOD")
            a.push(CALLBUF + 160)
            a.op("MSTORE")
            self._staticcall(5, CALLBUF, 192, CALLBUF, 32, "modexp")
            a.push(CALLBUF)
            a.op("MLOAD")            # [ret, r]
            a.op("SWAP1", "JUMP")
            self.used_subs.add("pow")
        if "wide" in self.used_subs:
            # wide(h) = addmod(mulmod(h % R, POW256, R), keccak(h) % R, R)
            a.label("sub_wide")      # [ret, h]
            a.op("DUP1")
            a.push(SCRATCH)
            a.op("MSTORE")
            self.const_word("R_MOD")
            a.op("SWAP1", "MOD")     # h % R
            a.push(self.consts["POW256"])
            self.const_word("R_MOD")
            a.op("SWAP2", "MULMOD")  # [ret, hi_term]
            self.const_word("R_MOD")
            a.op("SWAP1")            # [ret, R, hi]
            a.push(32)
            a.push(SCRATCH)
            a.op("SHA3")             # keccak(h)
            self.const_word("R_MOD")
            a.op("SWAP1", "MOD")     # lo % R
            a.op("ADDMOD")           # [ret, r]
            a.op("SWAP1", "JUMP")
        if "ecmul" in self.used_subs:
            a.label("sub_ecmul")     # [ret, px, py, s]
            a.push(CALLBUF + 64)
            a.op("MSTORE")
            a.push(CALLBUF + 32)
            a.op("MSTORE")
            a.push(CALLBUF)
            a.op("MSTORE")
            self._staticcall(7, CALLBUF, 96, CALLBUF, 64, "ecMul")
            a.push(CALLBUF)
            a.op("MLOAD")            # rx
            a.push(CALLBUF + 32)
            a.op("MLOAD")            # ry  [ret, rx, ry]
            a.op("SWAP1", "SWAP2", "JUMP")   # -> [rx, ry] (y on top)
        if "ecadd" in self.used_subs:
            a.label("sub_ecadd")     # [ret, px, py, qx, qy]
            a.push(CALLBUF + 96)
            a.op("MSTORE")
            a.push(CALLBUF + 64)
            a.op("MSTORE")
            a.push(CALLBUF + 32)
            a.op("MSTORE")
            a.push(CALLBUF)
            a.op("MSTORE")
            self._staticcall(6, CALLBUF, 128, CALLBUF, 64, "ecAdd")
            a.push(CALLBUF)
            a.op("MLOAD")
            a.push(CALLBUF + 32)
            a.op("MLOAD")
            a.op("SWAP1", "SWAP2", "JUMP")   # [ret,rx,ry] -> [rx,ry]
        if "negpt" in self.used_subs:
            a.label("sub_negpt")     # [ret, px, py]
            skip = a.fresh_label("neg_zero")
            a.op("DUP2", "DUP2", "OR", "ISZERO")
            a.pushl(skip)
            a.op("JUMPI")
            self.const_word("Q_MOD")
            a.op("SUB")              # py' = Q - py
            a.label(skip)
            a.op("SWAP1", "SWAP2", "JUMP")   # [ret,px,py] -> [px,py]
        if "pairing" in self.used_subs:
            a.label("sub_pairing")   # [ret, base]
            a.push(32)
            a.push(SCRATCH)
            a.push(384)
            a.op("DUP4")             # base (below the 3 pushed words)
            a.push(8)
            a.op("GAS", "STATICCALL", "ISZERO")
            a.pushl(self.revert_label("pairing"))
            a.op("JUMPI")
            a.op("POP")              # drop base
            a.push(SCRATCH)
            a.op("MLOAD")
            a.push(1)
            a.op("EQ", "SWAP1", "JUMP")


# ======================================================================
# statement-level compilation of the verify() body
# ======================================================================

def _parse_line(line: str):
    return _Parser(_tokenize(line))


def _compile_body(c: _Compiler, lines: list[str]):
    a = c.a
    blocks: list = []      # ("scope",) | ("loop", var, step, limit_expr,
    #                         start_lbl, end_lbl)
    i = 0
    while i < len(lines):
        s = lines[i].strip()
        i += 1
        if not s or s.startswith("//"):
            continue
        if s == "{":
            blocks.append(("scope",))
            continue
        if s == "}":
            blk = blocks.pop()
            if blk[0] == "loop":
                _, var, step, start, end = blk
                a.push(c.slot(var))
                a.op("MLOAD")
                a.push(step)
                a.op("ADD")
                a.push(c.slot(var))
                a.op("MSTORE")
                a.pushl(start)
                a.op("JUMP")
                a.label(end)
            continue

        # ---- for loops ----
        m = re.match(r"for \(uint256 (\w+) = (\w+); \1 < ([\w.]+); "
                     r"\1(\+\+|\s*\+= 32)\) \{( .* )?\}?$", s)
        if m:
            var, init, limit, stepw, inline = m.groups()
            step = 1 if stepw == "++" else 32
            a.push(int(init, 0))
            a.push(c.slot(var))
            a.op("MSTORE")
            start = a.fresh_label("loop")
            end = a.fresh_label("loop_end")
            a.label(start)
            if limit == "instances.length":
                a.push(INSTLEN)
                a.op("MLOAD")
            else:
                a.push(int(limit, 0))
            a.push(c.slot(var))
            a.op("MLOAD", "LT", "ISZERO")
            a.pushl(end)
            a.op("JUMPI")
            if inline is not None and inline.strip():
                _compile_stmt(c, inline.strip())
                a.push(c.slot(var))
                a.op("MLOAD")
                a.push(step)
                a.op("ADD")
                a.push(c.slot(var))
                a.op("MSTORE")
                a.pushl(start)
                a.op("JUMP")
                a.label(end)
            else:
                blocks.append(("loop", var, step, start, end))
            continue

        _compile_stmt(c, s)
    assert not blocks, "unbalanced blocks"


def _compile_stmt(c: _Compiler, s: str):
    a = c.a
    s = s.strip()
    if s.endswith(";"):
        s = s[:-1]

    # guard return: if (!cond) { return false; }
    m = re.match(r"if \(!(.*)\) \{ return false; \}$", s)
    if m:
        cond = _parse_line(m.group(1)).expr()
        c.eval_scalar(cond)
        a.op("ISZERO")
        a.pushl("ret_false")
        a.op("JUMPI")
        return
    # require(cond, "msg")
    m = re.match(r'require\((.*), "(.*)"\)$', s)
    if m:
        c.emit_require(_parse_line(m.group(1)).expr(), m.group(2))
        return
    # returns
    if s == "return false":
        a.pushl("ret_false")
        a.op("JUMP")
        return
    m = re.match(r"return (.*)$", s)
    if m:
        c.eval_scalar(_parse_line(m.group(1)).expr())
        a.push(0)
        a.op("MSTORE")
        a.push(32)
        a.push(0)
        a.op("RETURN")
        return

    # declarations
    m = re.match(r"uint256\[(\d+)\] memory (\w+) = (.*)$", s)
    if m:
        n, name, rhs = int(m.group(1)), m.group(2), m.group(3)
        assert n == 2, "only pair initializers"
        c.slot(name, 2)
        c.eval_pair(_parse_line(rhs).expr())
        c.store_pair(name)
        return
    m = re.match(r"uint256\[(\d+)\] memory (\w+)$", s)
    if m:
        n, name = int(m.group(1)), m.group(2)
        c.slot(name, n)
        return                        # fresh memory is zero
    m = re.match(r"bytes memory (\w+)$", s)
    if m:
        assert c.bytes_var is None, "one bytes var supported"
        c.bytes_var = m.group(1)
        c.slot(c.bytes_var)           # length slot (zero-init by fiat)
        a.push(0)
        a.push(c.slot(c.bytes_var))
        a.op("MSTORE")
        return
    m = re.match(r"(?:uint256|bytes32) (\w+) = (.*)$", s)
    if m:
        name, rhs = m.group(1), m.group(2)
        c.eval_scalar(_parse_line(rhs).expr())
        c.store_scalar(name)
        return

    # assignments
    m = re.match(r"(\w+)\[(\d+)\] = (.*)$", s)
    if m:
        name, idx, rhs = m.group(1), int(m.group(2)), m.group(3)
        c.eval_scalar(_parse_line(rhs).expr())
        a.push(c.slot(name) + 32 * idx)
        a.op("MSTORE")
        return
    m = re.match(r"(\w+) = (.*)$", s)
    if m:
        name, rhs = m.group(1), m.group(2)
        e = _parse_line(rhs).expr()
        if name == c.bytes_var:
            # instAbsorb = abi.encodePacked(instAbsorb, hex"53", word)
            assert e[0] == "packed" and e[1][0] == ("var", name) and \
                e[1][1][0] == "hexlit" and len(e[1][1][1]) == 1, \
                f"unsupported bytes append: {s}"
            lenslot = c.slot(name)
            a.push(e[1][1][1][0])
            a.push(lenslot)
            a.op("MLOAD")
            a.pushl("__instbuf")
            a.op("ADD", "MSTORE8")
            c.eval_scalar(e[1][2])
            a.push(lenslot)
            a.op("MLOAD")
            a.pushl("__instbuf")
            a.op("ADD")
            a.push(1)
            a.op("ADD", "MSTORE")
            a.push(lenslot)
            a.op("MLOAD")
            a.push(33)
            a.op("ADD")
            a.push(lenslot)
            a.op("MSTORE")
            return
        if c.is_array(name):
            c.eval_pair(e)
            c.store_pair(name)
        else:
            c.eval_scalar(e)
            c.store_scalar(name)
        return
    raise SyntaxError(f"unhandled statement: {s}")


# ======================================================================
# public API
# ======================================================================

def compile_verifier(sol_src: str):
    """Compile a generated verifier contract to EVM bytecode.

    Returns (runtime_code, init_code, meta) where meta carries the layout
    facts a caller may want to report."""
    consts = {}
    for name in ("R_MOD", "Q_MOD", "POW256"):
        m = re.search(rf"constant {name} =\s*(0x[0-9a-fA-F]+)", sol_src)
        consts[name] = int(m.group(1), 16)
    for name in ("INIT_STATE", "VK_DIGEST"):
        m = re.search(rf"constant {name} =\s*(0x[0-9a-fA-F]+)", sol_src)
        consts[name] = int(m.group(1), 16)

    m = re.search(r"function verify\(.*?\{\n(.*)\n\s*\}\n\}", sol_src,
                  re.DOTALL)
    assert m, "verify body not found"
    body_lines = m.group(1).split("\n")
    m = re.search(r"require\(instances\.length == (\d+)", sol_src)
    assert m, "instance count not found"
    num_instances = int(m.group(1))

    c = _Compiler(consts, num_instances)
    a = c.a

    # ---- dispatcher ----
    from ..plonk.transcript import keccak256
    selector = int.from_bytes(keccak256(b"verify(uint256[],bytes)")[:4],
                              "big")
    a.push(4)
    a.op("CALLDATASIZE", "LT")
    a.pushl(c.revert_label("bad selector"))
    a.op("JUMPI")
    a.push(0)
    a.op("CALLDATALOAD")
    a.push(224)
    a.op("SHR")
    a.push(selector)
    a.op("EQ", "ISZERO")
    a.pushl(c.revert_label("bad selector"))
    a.op("JUMPI")
    # cache big constants in memory
    a.push(consts["R_MOD"])
    a.push(CONST_R)
    a.op("MSTORE")
    a.push(consts["Q_MOD"])
    a.push(CONST_Q)
    a.op("MSTORE")
    # ABI decode: verify(uint256[] instances, bytes proof)
    a.push(4)
    a.op("CALLDATALOAD")
    a.push(4)
    a.op("ADD")                       # &instances.len
    a.op("DUP1", "CALLDATALOAD")
    a.push(INSTLEN)
    a.op("MSTORE")
    a.push(32)
    a.op("ADD")
    a.push(INSTDATA)
    a.op("MSTORE")
    a.push(36)
    a.op("CALLDATALOAD")
    a.push(4)
    a.op("ADD")                       # &proof.len
    a.op("DUP1", "CALLDATALOAD")
    a.push(PROOFLEN)
    a.op("MSTORE")
    a.push(32)
    a.op("ADD")
    a.push(PROOFDATA)
    a.op("MSTORE")

    _compile_body(c, body_lines)
    # verify() always returns explicitly; falling off the end is a bug
    a.pushl(c.revert_label("no return"))
    a.op("JUMP")
    c.emit_return_bool_stubs()
    c.emit_subs()
    c.emit_revert_stubs()

    # ---- place the dynamic regions and resolve their labels ----
    instbuf = c.next_off
    absorb = instbuf + 33 * num_instances + 64
    for idx, it in enumerate(a.items):
        if it[0] == "pushl" and it[1] == "__instbuf":
            a.items[idx] = ("b", _push_bytes(instbuf))
        elif it[0] == "pushl" and it[1] == "__absorb":
            a.items[idx] = ("b", _push_bytes(absorb))

    runtime = a.assemble()
    init = _init_code(runtime)
    meta = {
        "runtime_bytes": len(runtime),
        "init_bytes": len(init),
        "eip170_ok": len(runtime) <= 24576,
        "num_slots": (c.next_off - VARS_BASE) // 32,
        "num_instances": num_instances,
    }
    return runtime, init, meta


def _push_bytes(v: int) -> bytes:
    """PUSH0 / minimal-width PUSHn encoding (single source for Asm.push
    and the late-bound __instbuf/__absorb patches)."""
    if v == 0:
        return bytes([0x5F])
    data = v.to_bytes((v.bit_length() + 7) // 8, "big")
    return bytes([0x5F + len(data)]) + data


def _init_code(runtime: bytes) -> bytes:
    a = Asm()
    a.push(len(runtime))
    a.op("DUP1")
    a.pushl("rt")
    a.push(0)
    a.op("CODECOPY")
    a.push(0)
    a.op("RETURN")
    a.label("rt")
    head = a.assemble()
    # the label points at the JUMPDEST we appended; strip it and use its
    # offset as the runtime blob start
    return head[:-1] + runtime


def vm_verify(sol_src: str, instances: list, proof: bytes,
              gas_limit: int = 500_000_000, tamper_byte: int | None = None):
    """Compile + execute a generated verifier on the real EVM.

    Returns a dict: ok, gas_used (execution), gas_total (with intrinsic),
    runtime_bytes, eip170_ok, revert (decoded reason or None). With
    tamper_byte set, the same compiled bytecode is also run against the
    proof with that byte flipped and `tamper_rejected` is reported."""
    from . import codegen, vm
    runtime, init, meta = compile_verifier(sol_src)

    def run(pf: bytes):
        calldata = codegen.encode_calldata(instances, pf)
        ok, out, gas_used = vm.execute(runtime, calldata, gas_limit)
        result = bool(ok and len(out) >= 32
                      and int.from_bytes(out[-32:], "big"))
        return result, ok, out, gas_used, calldata

    result, ok, out, gas_used, calldata = run(proof)
    r = {
        "ok": result,
        "reverted": not ok,
        "revert": vm.revert_reason(out) if not ok else None,
        "gas_execution": gas_used,
        "gas_total": gas_used + vm.tx_intrinsic_gas(calldata),
        "runtime_bytes": meta["runtime_bytes"],
        "eip170_ok": meta["eip170_ok"],
    }
    if tamper_byte is not None:
        bad = bytearray(proof)
        bad[tamper_byte] ^= 1
        r["tamper_rejected"] = not run(bytes(bad))[0]
    return r
