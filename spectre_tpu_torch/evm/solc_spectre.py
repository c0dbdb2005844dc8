"""Compiler: the generated Spectre.sol protocol contract -> EVM bytecode
(the port's copy of `spectre_tpu/evm/solc_spectre.py`).

`contracts/sol_gen.py` emits the on-chain light-client protocol contract
(reference ABI observed in `contract-tests/tests/spectre.rs:56-110`; the
reference's own contracts submodule is empty). The statement interpreter
(`SolSpectre`) executes that source directly; this module compiles the
SAME source to real EVM bytecode so the protocol can run as deployed
contracts in `evm/vm.py`'s World — constructor, storage, mappings,
keccak-slot addressing, external STATICCALLs to the verifier contracts,
the sha256 precompile, and metered gas — mirroring the reference's
anvil-based contract tests end-to-end.

Subset semantics (hold on sol_gen's output, asserted where cheap):
- state variables take slots in declaration order; `mapping(uint256 => T)`
  values live at keccak256(key ++ slot) (Solidity storage layout);
- public state vars / constants get their implicit external getters;
- `uint64` fields never overflow 64 bits in the emitted code (byte masks
  and shifts only), so 256-bit EVM ops match checked Solidity arithmetic;
  calldata uint64 params are range-validated like solc's ABI decoder;
- `bytes8` values are carried low-aligned and shifted left at use sites
  (encodePacked emits 8 bytes; external returns are left-aligned);
- a failed external verifier call bubbles its revert data (solc 0.8
  behavior); a `false` return hits the surrounding require.
"""

from __future__ import annotations

import re

from .solc import OPS, Asm, _Parser, _tokenize  # noqa: F401 (shared infra)

# ---- memory map ----
SCRATCH = 0x00            # 0x00-0x5f: mapping-slot hashing, return staging
VARS_BASE = 0x100         # named locals / decoded params (assembler-fixed)
# memory arrays, the encodePacked absorb buffer and the external-call
# staging area are placed after the variable slots by the assembler
# (symbolic labels __arrays / __absorb / __callbuf).

_SELECTOR_TYPES = {"uint256": "uint256", "uint64": "uint64",
                   "bytes32": "bytes32", "bytes8": "bytes8",
                   "address": "address", "bytes": "bytes", "bool": "bool",
                   "uint256[12]": "uint256[12]"}


def _keccak(data: bytes) -> bytes:
    from ..plonk.transcript import keccak256
    return keccak256(data)


class _Fn:
    def __init__(self, name, params, returns, body_lines, external=True):
        self.name = name
        self.params = params          # [(type, location, name)]
        self.returns = returns        # type or None
        self.body = body_lines
        self.external = external

    def selector_sig(self, structs) -> str:
        parts = []
        for typ, _loc, _name in self.params:
            if typ in structs:
                parts.append("(" + ",".join(
                    f[0] for f in structs[typ]) + ")")
            else:
                parts.append(_SELECTOR_TYPES[typ])
        return f"{self.name}({','.join(parts)})"


class SpectreCompiler:
    def __init__(self, src: str):
        self.src = src
        self.a = Asm()
        self.slots: dict[str, int] = {}        # local var -> memory offset
        self.next_off = VARS_BASE
        self.arrays: dict[str, tuple] = {}     # memory arr -> (label_off, n)
        self.array_bytes = 0
        self.revert_msgs: dict[str, str] = {}
        self.constants: dict[str, int] = {}
        self.storage_vars: dict[str, dict] = {}  # name -> {slot, kind, type}
        self.structs: dict[str, list] = {}     # name -> [(type, name)]
        self.fns: dict[str, _Fn] = {}
        self.ctor: _Fn | None = None
        self.var_types: dict[str, str] = {}    # local name -> type
        self.struct_bases: dict[str, int] = {}  # struct param -> cd offset
        self.cd_arrays: dict[str, tuple] = {}  # fixed-array param -> (off, n)
        self.cur_fn: _Fn | None = None
        self._parse_contract()

    # ================= source-level parsing =================
    def _parse_contract(self):
        src = self.src
        for m in re.finditer(
                r"uint256 public constant (\w+) = (\d+);", src):
            self.constants[m.group(1)] = int(m.group(2))
        # state variables, in declaration order
        slot = 0
        body = src[src.index("contract Spectre"):]
        for line in body.split("\n"):
            s = line.strip()
            m = re.match(r"uint256 public (\w+);", s)
            if m:
                self.storage_vars[m.group(1)] = {
                    "slot": slot, "kind": "scalar", "type": "uint256"}
                slot += 1
                continue
            m = re.match(r"mapping\(uint256 => (\w+)\) public (\w+);", s)
            if m:
                self.storage_vars[m.group(2)] = {
                    "slot": slot, "kind": "mapping", "type": m.group(1)}
                slot += 1
                continue
            m = re.match(r"IVerifier public (\w+);", s)
            if m:
                self.storage_vars[m.group(1)] = {
                    "slot": slot, "kind": "scalar", "type": "address"}
                slot += 1
        # structs / constructor / functions: contract body only (the
        # IVerifier interface above declares verify() too)
        src = body
        for m in re.finditer(r"struct (\w+) \{([^}]*)\}", src):
            fields = []
            for fm in re.finditer(r"(\w+) (\w+);", m.group(2)):
                fields.append((fm.group(1), fm.group(2)))
            self.structs[m.group(1)] = fields
        # constructor
        m = re.search(r"constructor\(([^)]*)\)\s*\{(.*?)\n    \}", src,
                      re.DOTALL)
        assert m, "constructor not found"
        self.ctor = _Fn("constructor", self._parse_params(m.group(1)),
                        None, m.group(2).split("\n"))
        # functions
        for m in re.finditer(
                r"function (\w+)\(([^)]*)\)\s*\n?\s*"
                r"(external|public|internal)"
                r"[^{]*?(?:returns \((\w+)\))?\s*\{(.*?)\n    \}", src,
                re.DOTALL):
            name, params, vis, ret, body = m.groups()
            self.fns[name] = _Fn(name, self._parse_params(params), ret,
                                 body.split("\n"),
                                 external=vis != "internal")

    @staticmethod
    def _parse_params(s: str):
        params = []
        for part in s.split(","):
            part = part.strip()
            if not part:
                continue
            toks = part.split()
            if len(toks) == 2:
                typ, name = toks
                loc = "stack"
            else:
                typ, loc, name = toks
            params.append((typ, loc, name))
        return params

    # ================= low-level helpers =================
    def slot(self, name: str) -> int:
        if name not in self.slots:
            self.slots[name] = self.next_off
            self.next_off += 32
        return self.slots[name]

    def revert_label(self, msg: str) -> str:
        if msg not in self.revert_msgs:
            self.revert_msgs[msg] = f"rev_{len(self.revert_msgs)}"
        return self.revert_msgs[msg]

    def _fresh(self, base):
        return self.a.fresh_label(base)

    def _cur_load(self):
        self.a.push(self.slot("__cur"))
        self.a.op("MLOAD")

    def _cur_add(self, n: int):
        a = self.a
        a.push(self.slot("__cur"))
        a.op("MLOAD")
        a.push(n)
        a.op("ADD")
        a.push(self.slot("__cur"))
        a.op("MSTORE")

    # ================= expression typing =================
    def typ_of(self, e) -> str:
        k = e[0]
        if k == "num":
            return "uint256"
        if k == "var":
            n = e[1]
            if n in self.var_types:
                return self.var_types[n]
            if n in self.constants:
                return "uint256"
            if n in self.storage_vars:
                return self.storage_vars[n]["type"]
            return "uint256"
        if k == "member":
            sname = self.var_types.get(e[1][1], "")
            for ftyp, fname in self.structs.get(sname, []):
                if fname == e[2]:
                    return ftyp
            return "uint256"
        if k == "call":
            fname = e[1]
            if fname in self.fns:
                return self.fns[fname].returns or "uint256"
            if fname in ("uint256", "bytes32", "bytes8", "uint64",
                         "address"):
                return fname
            if fname == "sha256":
                return "bytes32"
            return "uint256"
        if k == "bin":
            return self.typ_of(e[2])
        return "uint256"

    # ================= expression compilation =================
    def eval(self, e):
        """Compile e to one stack word."""
        a = self.a
        k = e[0]
        if k == "num":
            a.push(e[1])
        elif k == "hexlit":
            a.push(int.from_bytes(e[1].ljust(32, b"\x00"), "big"))
        elif k == "var":
            self.eval_var(e[1])
        elif k == "member":
            self.eval_member(e)
        elif k == "bin":
            self.eval_bin(e)
        elif k == "not":
            self.eval(e[1])
            a.op("ISZERO")
        elif k == "index":
            self.eval_index(e)
        elif k == "call":
            self.eval_call(e)
        elif k == "method":
            self.eval_external_call(e)
        else:
            raise SyntaxError(f"expr: {e}")

    def eval_member(self, e):
        """struct field access: the struct param lives in calldata at a
        compile-time base offset (struct_bases, not a memory slot)."""
        _, base, field = e
        assert base[0] == "var"
        sname = self.var_types[base[1]]
        off = self.struct_bases[base[1]]
        for i, (_ftyp, fname) in enumerate(self.structs[sname]):
            if fname == field:
                self.a.push(off + 32 * i)
                self.a.op("CALLDATALOAD")
                return
        raise SyntaxError(f"no field {field} in {sname}")

    def eval_bin(self, e):
        _, op, l, r = e
        a = self.a
        if op in ("+", "-", "*", "/", "&", "|"):
            self.eval(r)
            self.eval(l)
            a.op({"+": "ADD", "-": "SUB", "*": "MUL", "/": "DIV",
                  "&": "AND", "|": "OR"}[op])
        elif op in ("<<", ">>"):
            self.eval(l)
            self.eval(r)
            a.op("SHL" if op == "<<" else "SHR")
        elif op in ("<", ">"):
            # both compile to LT; '>' swaps the operands instead
            self.eval(r if op == "<" else l)
            self.eval(l if op == "<" else r)
            a.op("LT")
        elif op == "==":
            self.eval(l)
            self.eval(r)
            a.op("EQ")
        elif op == "!=":
            self.eval(l)
            self.eval(r)
            a.op("EQ", "ISZERO")
        elif op == "&&":
            self.eval(l)
            self.eval(r)
            a.op("AND")
        else:
            raise SyntaxError(f"binop {op}")

    def eval_index(self, e):
        _, base, idx = e
        a = self.a
        assert base[0] == "var"
        name = base[1]
        if name in self.cd_arrays:             # fixed-size calldata array
            off, n = self.cd_arrays[name]
            if idx[0] == "num":
                assert idx[1] < n
                a.push(off + 32 * idx[1])
            else:
                self.eval(idx)
                a.push(5)
                a.op("SHL")
                a.push(off)
                a.op("ADD")
            a.op("CALLDATALOAD")
        elif name in self.arrays:
            lbl, n = self.arrays[name]
            if idx[0] == "num":
                assert idx[1] < n
                a.pushl("__arrays")
                a.push(lbl + 32 * (idx[1] + 1))
            else:
                self.eval(idx)
                a.push(5)
                a.op("SHL")
                a.pushl("__arrays")
                a.push(lbl + 32)
                a.op("ADD")          # [i*32, base+off]; shared ADD follows
            a.op("ADD", "MLOAD")
        elif name in self.storage_vars and \
                self.storage_vars[name]["kind"] == "mapping":
            self.mapping_slot(name, idx)
            a.op("SLOAD")
        else:
            raise SyntaxError(f"index into {name}")

    def mapping_slot(self, name: str, key_expr):
        """keccak256(key ++ slot) on the stack."""
        a = self.a
        self.eval(key_expr)
        a.push(SCRATCH)
        a.op("MSTORE")
        a.push(self.storage_vars[name]["slot"])
        a.push(SCRATCH + 32)
        a.op("MSTORE")
        a.push(64)
        a.push(SCRATCH)
        a.op("SHA3")

    def eval_call(self, e):
        _, fname, args = e
        a = self.a
        if fname in ("uint256", "uint64", "address", "bool", "IVerifier"):
            self.eval(args[0])
            if fname == "uint64" and self.typ_of(args[0]) == "bytes8":
                a.push(192)
                a.op("SHR")
            return
        if fname in ("bytes32", "bytes8"):
            self.eval(args[0])      # low-aligned carry (see module doc)
            return
        if fname == "sha256":
            assert args[0][0] == "packed"
            self.eval_packed_sha256(args[0][1])
            return
        if fname in self.fns:
            fn = self.fns[fname]
            ret = self._fresh(f"ret_{fname}")
            a.pushl(ret)
            for (ptyp, _loc, _pname), arg in zip(fn.params, args):
                if ptyp in self.structs:
                    # struct params compile to a fixed calldata base; the
                    # callee reads the caller's own calldata (both ABIs
                    # place the struct first) — nothing to pass
                    assert arg[0] == "var" and \
                        self.var_types.get(arg[1]) == ptyp
                else:
                    self.eval(arg)
            a.pushl(f"fn_{fname}")
            a.op("JUMP")
            a.label(ret)
            return
        raise SyntaxError(f"call {fname}")

    def eval_packed_sha256(self, chunks):
        """sha256(abi.encodePacked(...)) via precompile 0x2."""
        a = self.a
        a.pushl("__absorb")
        a.push(self.slot("__cur"))
        a.op("MSTORE")
        for ch in chunks:
            typ = self.typ_of(ch)
            self.eval(ch)
            if typ == "bytes8":
                a.push(192)
                a.op("SHL")          # left-align the 8 bytes
                self._cur_load()
                a.op("MSTORE")
                self._cur_add(8)
            else:                    # bytes32 / uint256 word
                self._cur_load()
                a.op("MSTORE")
                self._cur_add(32)
        # STATICCALL(gas, 0x2, absorb, cur - absorb, SCRATCH, 32)
        a.push(32)                   # retSize
        a.push(SCRATCH)              # retOff
        a.pushl("__absorb")
        a.push(self.slot("__cur"))
        a.op("MLOAD", "SUB")         # argSize = cur - absorb
        a.pushl("__absorb")          # argOff
        a.push(2)
        a.op("GAS", "STATICCALL", "ISZERO")
        a.pushl(self.revert_label("sha256"))
        a.op("JUMPI")
        a.push(SCRATCH)
        a.op("MLOAD")

    def eval_external_call(self, e):
        """stepVerifier.verify(instances, proof) -> bool word.

        Builds verify(uint256[],bytes) calldata in the __callbuf region;
        instances is a compile-time-length memory array, proof forwards
        this function's own bytes-calldata param."""
        _, target_node, mname, args = e
        assert mname == "verify" and len(args) == 2
        assert target_node[0] == "var"
        target = target_node[1]
        arr = args[0]
        assert arr[0] == "var" and arr[1] in self.arrays
        lbl, n = self.arrays[arr[1]]
        proof = args[1]
        assert proof[0] == "var"
        plen_slot = self.slot(f"__bytes_len_{proof[1]}")
        pdata_slot = self.slot(f"__bytes_data_{proof[1]}")
        a = self.a
        sel = int.from_bytes(_keccak(b"verify(uint256[],bytes)")[:4], "big")
        # header: selector ++ off_instances(64) ++ off_proof
        a.push(sel << 224)
        a.pushl("__callbuf")
        a.op("MSTORE")
        a.push(64)
        a.pushl("__callbuf")
        a.push(4)
        a.op("ADD", "MSTORE")
        a.push(64 + 32 + 32 * n)     # proof head offset (after instances)
        a.pushl("__callbuf")
        a.push(36)
        a.op("ADD", "MSTORE")
        # instances array: length + items copied from the memory array
        a.push(n)
        a.pushl("__callbuf")
        a.push(68)
        a.op("ADD", "MSTORE")
        for i in range(n):
            a.pushl("__arrays")
            a.push(lbl + 32 * (i + 1))
            a.op("ADD", "MLOAD")
            a.pushl("__callbuf")
            a.push(100 + 32 * i)
            a.op("ADD", "MSTORE")
        # proof: length word + calldata copy (padded to words)
        pbase = 100 + 32 * n
        a.push(plen_slot)
        a.op("MLOAD")
        a.pushl("__callbuf")
        a.push(pbase)
        a.op("ADD", "MSTORE")
        a.push(plen_slot)
        a.op("MLOAD")                # size
        a.push(pdata_slot)
        a.op("MLOAD")                # src (calldata offset)
        a.pushl("__callbuf")
        a.push(pbase + 32)
        a.op("ADD")                  # dst
        a.op("CALLDATACOPY")
        # total calldata size = pbase + 32 + ceil(len/32)*32
        a.push(plen_slot)
        a.op("MLOAD")
        a.push(31)
        a.op("ADD")
        a.push(0xFFFFFFE0)           # & ~31 (lengths < 2^32 in practice)
        a.op("AND")
        a.push(pbase + 32)
        a.op("ADD")                  # [insize]
        # STATICCALL(gas, addr, callbuf, insize, SCRATCH=0, 32):
        # stack must be [32, 0, insize, buf, addr, gas] bottom->top
        a.push(SCRATCH)              # == 0
        a.push(32)
        a.op("SWAP2")                # [32, 0, insize]
        a.pushl("__callbuf")
        self.eval_var(target)        # verifier address from storage
        a.op("GAS", "STATICCALL")
        # failure: bubble the callee's revert data (solc 0.8 behavior)
        ok_lbl = self._fresh("extok")
        a.op("DUP1")
        a.pushl(ok_lbl)
        a.op("JUMPI")
        a.op("RETURNDATASIZE")
        a.push(0)
        a.push(0)
        a.op("RETURNDATACOPY")
        a.op("RETURNDATASIZE")
        a.push(0)
        a.op("REVERT")
        a.label(ok_lbl)
        a.op("POP")                  # drop the success flag
        a.push(SCRATCH)
        a.op("MLOAD")                # bool word

    # ================= statements =================
    def lslot(self, name: str) -> int:
        """Function-scoped local slot (prefixed so nested internal calls
        cannot alias the caller's locals)."""
        return self.slot(f"{self.cur_fn.name}.{name}")

    def eval_var(self, name: str):
        a = self.a
        if name in self.var_types:              # function local / param
            a.push(self.lslot(name))
            a.op("MLOAD")
        elif name in self.constants:
            a.push(self.constants[name])
        elif name in self.storage_vars:
            sv = self.storage_vars[name]
            assert sv["kind"] == "scalar", f"{name} needs a key"
            a.push(sv["slot"])
            a.op("SLOAD")
        else:
            raise SyntaxError(f"unknown identifier {name}")

    def emit_require(self, cond, msg: str):
        self.eval(cond)
        self.a.op("ISZERO")
        self.a.pushl(self.revert_label(msg))
        self.a.op("JUMPI")

    def compile_stmt(self, s: str, blocks: list) -> bool:
        """Compile one statement line; returns True if handled as a block
        opener/closer."""
        a = self.a
        s = s.strip()
        if not s or s.startswith("//"):
            return True
        if s == "}":
            blk = blocks.pop()
            if blk[0] == "loop":
                _, var, start, end = blk
                a.push(self.lslot(var))
                a.op("MLOAD")
                a.push(1)
                a.op("ADD")
                a.push(self.lslot(var))
                a.op("MSTORE")
                a.pushl(start)
                a.op("JUMP")
                a.label(end)
            elif blk[0] == "if":
                a.label(blk[1])
            return True
        m = re.match(r"for \(uint256 (\w+) = (\d+); \1 < (\d+); \1\+\+\) \{$",
                     s)
        if m:
            var, init, limit = m.group(1), int(m.group(2)), int(m.group(3))
            self.var_types[var] = "uint256"
            a.push(init)
            a.push(self.lslot(var))
            a.op("MSTORE")
            start, end = self._fresh("loop"), self._fresh("loop_end")
            a.label(start)
            a.push(limit)
            a.push(self.lslot(var))
            a.op("MLOAD", "LT", "ISZERO")
            a.pushl(end)
            a.op("JUMPI")
            blocks.append(("loop", var, start, end))
            return True
        m = re.match(r"if \((.*)\) \{$", s)
        if m:
            end = self._fresh("if_end")
            self.eval(_Parser(_tokenize(m.group(1))).expr())
            a.op("ISZERO")
            a.pushl(end)
            a.op("JUMPI")
            blocks.append(("if", end))
            return True

        if s.endswith(";"):
            s = s[:-1]
        m = re.match(r'require\((.*), "(.*)"\)$', s, re.DOTALL)
        if m:
            self.emit_require(_Parser(_tokenize(m.group(1))).expr(),
                              m.group(2))
            return False
        m = re.match(r"return (.*)$", s, re.DOTALL)
        if m:
            # internal-call convention: [ret] -> push value, SWAP1, JUMP
            self.eval(_Parser(_tokenize(m.group(1))).expr())
            a.op("SWAP1", "JUMP")
            return False
        # declarations
        m = re.match(r"uint256\[\] memory (\w+) = new uint256\[\]\((\d+)\)$",
                     s)
        if m:
            name, n = m.group(1), int(m.group(2))
            self.arrays[name] = (self.array_bytes, n)
            self.var_types[name] = "uint256[]"
            a.push(n)
            a.pushl("__arrays")
            a.push(self.array_bytes)
            a.op("ADD", "MSTORE")    # length word
            self.array_bytes += 32 * (n + 1)
            return False
        m = re.match(r"(uint256|uint64|bytes32|bytes8) (\w+) = (.*)$", s,
                     re.DOTALL)
        if m:
            typ, name, rhs = m.groups()
            e = _Parser(_tokenize(rhs)).expr()
            self.var_types[name] = typ
            self.eval(e)
            a.push(self.lslot(name))
            a.op("MSTORE")
            return False
        # assignments
        m = re.match(r"(\w+)\[(.+?)\] = (.*)$", s, re.DOTALL)
        if m:
            name, key_src, rhs = m.groups()
            val = _Parser(_tokenize(rhs)).expr()
            if name in self.arrays:
                lbl, n = self.arrays[name]
                idx = _Parser(_tokenize(key_src)).expr()
                self.eval(val)
                if idx[0] == "num":
                    assert idx[1] < n
                    a.pushl("__arrays")
                    a.push(lbl + 32 * (idx[1] + 1))
                else:
                    self.eval(idx)
                    a.push(5)
                    a.op("SHL")
                    a.pushl("__arrays")
                    a.push(lbl + 32)
                    a.op("ADD")
                a.op("ADD", "MSTORE")
            else:
                sv = self.storage_vars[name]
                assert sv["kind"] == "mapping"
                self.eval(val)
                self.mapping_slot(name,
                                  _Parser(_tokenize(key_src)).expr())
                a.op("SSTORE")
            return False
        m = re.match(r"(\w+) = (.*)$", s, re.DOTALL)
        if m:
            name, rhs = m.groups()
            e = _Parser(_tokenize(rhs)).expr()
            self.eval(e)
            if name in self.var_types:
                a.push(self.lslot(name))
                a.op("MSTORE")
            else:
                sv = self.storage_vars[name]
                assert sv["kind"] == "scalar"
                a.push(sv["slot"])
                a.op("SSTORE")
            return False
        m = re.match(r"(\w+)\((.*)\)$", s, re.DOTALL)
        if m and m.group(1) in self.fns:       # bare internal call
            fn = self.fns[m.group(1)]
            self.eval_call(_Parser(_tokenize(s)).expr())
            if fn.returns is not None:
                a.op("POP")                    # discarded return value
            return False
        raise SyntaxError(f"unhandled statement: {s}")

    @staticmethod
    def _join_lines(lines: list) -> list:
        """Merge continuation lines until parens balance and the statement
        terminates (';', block opener '{', or a bare '}')."""
        out, buf, depth = [], "", 0
        for raw in lines:
            s = raw.strip()
            if not s or s.startswith("//"):
                continue
            buf = f"{buf} {s}".strip() if buf else s
            depth += s.count("(") - s.count(")")
            if depth == 0 and (buf.endswith(";") or buf.endswith("{")
                               or buf == "}"):
                out.append(buf)
                buf = ""
        assert not buf, f"dangling statement: {buf!r}"
        return out

    def compile_body(self, lines: list):
        blocks: list = []
        for stmt in self._join_lines(lines):
            self.compile_stmt(stmt, blocks)
        assert not blocks, "unbalanced blocks"

    # ================= functions =================
    def compile_fn(self, fn: _Fn):
        """Emit the function body as an internal subroutine fn_<name>.

        Convention: entry stack [ret, a1..an] (stack params only; struct
        and bytes params are calldata-resident). Exit: value fns leave the
        result via `return` statements; void fns fall through to JUMP."""
        a = self.a
        self.cur_fn = fn
        self.var_types = {}
        self.struct_bases = {}
        self.cd_arrays = {}
        a.label(f"fn_{fn.name}")
        stack_params = []
        cd_off = 4
        for typ, loc, name in fn.params:
            if typ in self.structs:
                assert cd_off == 4, "struct param must come first"
                self.struct_bases[name] = 4
                self.var_types[name] = typ
                cd_off += 32 * len(self.structs[typ])
            elif typ.endswith("]"):              # uint256[12] calldata
                n = int(typ[typ.index("[") + 1:-1])
                self.cd_arrays[name] = (cd_off, n)
                self.var_types[name] = typ
                cd_off += 32 * n
            elif typ == "bytes":
                self.var_types[name] = "bytes"   # len/data slots, stub-set
                cd_off += 32
            else:
                stack_params.append(name)
                self.var_types[name] = typ
                cd_off += 32
        for name in reversed(stack_params):      # last arg is on top
            a.push(self.lslot(name))
            a.op("MSTORE")
        self.compile_body(fn.body)
        if fn.returns is None:
            a.op("JUMP")                         # [ret] void return
        # value functions end via `return <expr>` statements

    def _abi_stub(self, fn: _Fn):
        """External entry: decode calldata, run the subroutine, encode."""
        a = self.a
        self.cur_fn = fn
        a.label(f"stub_{fn.name}")
        # head layout: structs inline their fields; bytes take one offset
        head_off = 4
        bytes_params = []
        scalar_loads = []
        for typ, _loc, name in fn.params:
            if typ in self.structs:
                # solc's ABI decoder validates narrow struct fields
                for i, (ftyp, _fn) in enumerate(self.structs[typ]):
                    if ftyp == "uint64":
                        a.push(head_off + 32 * i)
                        a.op("CALLDATALOAD")
                        a.push(64)
                        a.op("SHR")
                        a.pushl(self.revert_label("abi: uint64"))
                        a.op("JUMPI")
                head_off += 32 * len(self.structs[typ])
            elif typ.endswith("]"):              # fixed array: inline words
                head_off += 32 * int(typ[typ.index("[") + 1:-1])
            elif typ == "bytes":
                bytes_params.append((name, head_off))
                head_off += 32
            else:
                scalar_loads.append((typ, name, head_off))
                head_off += 32
        for name, off in bytes_params:
            a.push(off)
            a.op("CALLDATALOAD")
            a.push(4)
            a.op("ADD", "DUP1", "CALLDATALOAD")
            a.push(self.slot(f"__bytes_len_{name}"))
            a.op("MSTORE")
            a.push(32)
            a.op("ADD")
            a.push(self.slot(f"__bytes_data_{name}"))
            a.op("MSTORE")
        ret = self._fresh(f"stubret_{fn.name}")
        a.pushl(ret)
        for typ, name, off in scalar_loads:
            a.push(off)
            a.op("CALLDATALOAD")
            if typ == "uint64":                  # solc ABI decoder check
                a.op("DUP1")
                a.push(64)
                a.op("SHR")
                a.pushl(self.revert_label("abi: uint64"))
                a.op("JUMPI")
        a.pushl(f"fn_{fn.name}")
        a.op("JUMP")
        a.label(ret)
        if fn.returns is None:
            a.push(0)
            a.push(0)
            a.op("RETURN")
        else:
            if fn.returns == "bytes8":
                a.push(192)
                a.op("SHL")                      # ABI: left-aligned
            a.push(0)
            a.op("MSTORE")
            a.push(32)
            a.push(0)
            a.op("RETURN")

    def _getter_stub(self, name: str):
        a = self.a
        a.label(f"stub_get_{name}")
        if name in self.constants:
            a.push(self.constants[name])
        else:
            sv = self.storage_vars[name]
            if sv["kind"] == "scalar":
                a.push(sv["slot"])
                a.op("SLOAD")
            else:
                a.push(4)
                a.op("CALLDATALOAD")
                a.push(SCRATCH)
                a.op("MSTORE")
                a.push(sv["slot"])
                a.push(SCRATCH + 32)
                a.op("MSTORE")
                a.push(64)
                a.push(SCRATCH)
                a.op("SHA3", "SLOAD")
        a.push(0)
        a.op("MSTORE")
        a.push(32)
        a.push(0)
        a.op("RETURN")

    # ================= top level =================
    def _dispatcher(self, entries):
        """entries: [(sig, label)]"""
        a = self.a
        a.push(4)
        a.op("CALLDATASIZE", "LT")
        a.pushl(self.revert_label("bad selector"))
        a.op("JUMPI")
        a.push(0)
        a.op("CALLDATALOAD")
        a.push(224)
        a.op("SHR")
        for sig, label in entries:
            sel = int.from_bytes(_keccak(sig.encode())[:4], "big")
            a.op("DUP1")
            a.push(sel)
            a.op("EQ")
            a.pushl(label)
            a.op("JUMPI")
        a.pushl(self.revert_label("bad selector"))
        a.op("JUMP")

    def emit_revert_stubs(self):
        a = self.a
        for msg, lbl in self.revert_msgs.items():
            a.label(lbl)
            data = msg.encode()
            assert len(data) <= 32
            a.push(0x08C379A0)
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
            a.push(0x64)
            a.push(0x1C)
            a.op("REVERT")

    def _finalize(self, asm: Asm) -> bytes:
        """Place the dynamic regions and assemble."""
        arrays = self.next_off
        absorb = arrays + max(self.array_bytes, 32)
        callbuf = absorb + 256
        sub = {"__arrays": arrays, "__absorb": absorb, "__callbuf": callbuf}
        from .solc import _push_bytes
        for i, it in enumerate(asm.items):
            if it[0] == "pushl" and it[1] in sub:
                asm.items[i] = ("b", _push_bytes(sub[it[1]]))
        return asm.assemble()

    def compile(self):
        """Returns (runtime_code, init_code_without_args, meta)."""
        a = self.a
        entries = []
        for fn in self.fns.values():
            if fn.external:
                entries.append((fn.selector_sig(self.structs),
                                f"stub_{fn.name}"))
        for name in self.constants:
            entries.append((f"{name}()", f"stub_get_{name}"))
        for name, sv in self.storage_vars.items():
            sig = f"{name}()" if sv["kind"] == "scalar" \
                else f"{name}(uint256)"
            entries.append((sig, f"stub_get_{name}"))
        self._dispatcher(entries)
        for fn in self.fns.values():
            if fn.external:
                self._abi_stub(fn)
        for fn in self.fns.values():
            self.compile_fn(fn)
        for name in list(self.constants) + list(self.storage_vars):
            self._getter_stub(name)
        self.emit_revert_stubs()
        runtime = self._finalize(a)

        # ---- constructor / init code ----
        ia = Asm()
        self.a = ia
        self.cur_fn = self.ctor
        self.var_types = {}
        nargs = len(self.ctor.params)
        for i, (typ, _loc, name) in enumerate(self.ctor.params):
            self.var_types[name] = "address" if typ == "IVerifier" else typ
        ia.push(32 * nargs)
        ia.op("DUP1", "CODESIZE", "SUB")     # [size, argstart]
        ia.push(self.lslot(self.ctor.params[0][2]))
        ia.op("CODECOPY")                    # args -> param slots (contig.)
        # param slots must be contiguous in declaration order
        base = self.lslot(self.ctor.params[0][2])
        for i, (_t, _l, name) in enumerate(self.ctor.params):
            assert self.lslot(name) == base + 32 * i, \
                "constructor params must land contiguously"
        n_msgs_before = len(self.revert_msgs)
        self.compile_body(self.ctor.body)
        assert len(self.revert_msgs) == n_msgs_before, \
            "constructor reverts need stubs emitted before the rt label"
        ia.push(len(runtime))
        ia.op("DUP1")
        ia.pushl("rt")
        ia.push(0)
        ia.op("CODECOPY")
        ia.push(0)
        ia.op("RETURN")
        ia.label("rt")                       # MUST stay the last item
        head = self._finalize(ia)
        # strip the trailing JUMPDEST marking "rt"; the label's offset is
        # then exactly where the appended runtime blob starts
        init = head[:-1] + runtime
        meta = {"runtime_bytes": len(runtime), "init_bytes": len(init)}
        return runtime, init, meta


def compile_spectre(sol_src: str):
    """Compile a generated Spectre.sol; returns (runtime, init, meta)."""
    return SpectreCompiler(sol_src).compile()