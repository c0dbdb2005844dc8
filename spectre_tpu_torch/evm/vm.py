"""A real EVM: bytecode interpreter with mainnet gas metering + precompiles
(the port's copy of `spectre_tpu/evm/vm.py`).

Reference parity: the reference executes its generated Yul verifier inside
revm (`prover/src/cli.rs:249-277`, SURVEY.md N11) to report gas and code
size. This module is that executor, offline: a
stack-machine EVM sufficient for the verifier contracts this repo's own
compiler (`evm/solc.py`) emits — executed from BYTECODE, with the
post-Berlin/London gas schedule (EIP-150/1108/2028/2565/2929) metered per
opcode, real memory-expansion costs, and the BN254/keccak/modexp
precompiles backed by `fields/bn254`.

Scope: the opcode subset the compiled verifier and protocol contracts use
— storage (SLOAD/SSTORE with EIP-2929+2200 pricing and revert journaling),
CALL/STATICCALL between World-deployed contracts and precompiles, but no
CREATE family, no logs, no value transfers. Unknown opcodes raise —
execution of arbitrary mainnet contracts is a non-goal; metering realism on
OUR contracts is the goal. (Known simplification: SSTORE refunds for
clearing slots are tracked and capped per EIP-3529, but other refund
sources are not modeled.)

Gas notes:
- precompile addresses are warm by definition (EIP-2929) — STATICCALL to
  them costs 100 base + the precompile's own price;
- memory expansion: 3w + floor(w^2/512) charged on the high-water word;
- the 63/64 rule applies to the gas forwarded by STATICCALL;
- intrinsic transaction gas (21000 + calldata bytes) is accounted by
  `tx_intrinsic_gas` so callers can report an end-to-end number.
"""

from __future__ import annotations

from ..fields import bn254
from ..plonk.transcript import keccak256

R = bn254.R
Q = bn254.P
U256 = (1 << 256) - 1


class EvmError(Exception):
    """Abnormal halt (invalid op, stack underflow, bad jump, OOG)."""


class _Frame:
    __slots__ = ("stack", "mem", "gas", "code", "pc", "calldata",
                 "returndata", "jumpdests", "mem_words", "world", "address",
                 "caller", "static")

    def __init__(self, code: bytes, calldata: bytes, gas: int, world=None,
                 address: int = 0, caller: int = 0, static: bool = False,
                 jumpdests: set | None = None):
        self.code = code
        self.calldata = calldata
        self.gas = gas
        self.stack: list[int] = []
        self.mem = bytearray()
        self.mem_words = 0
        self.pc = 0
        self.returndata = b""
        self.jumpdests = _jumpdests(code) if jumpdests is None else jumpdests
        self.world = world
        self.address = address
        self.caller = caller
        self.static = static


def _jumpdests(code: bytes) -> set:
    dests = set()
    i = 0
    while i < len(code):
        op = code[i]
        if op == 0x5B:
            dests.add(i)
        if 0x60 <= op <= 0x7F:
            i += op - 0x5F
        i += 1
    return dests


# ---- gas schedule (post-London mainnet) ----
G_VERYLOW, G_LOW, G_MID, G_HIGH = 3, 5, 8, 10
G_BASE, G_JUMPDEST, G_SHA3, G_SHA3WORD, G_COPY = 2, 1, 30, 6, 3
G_WARMACCESS = 100

_GAS = {}
for _op in (0x01, 0x03, 0x10, 0x11, 0x12, 0x13, 0x14, 0x15, 0x16, 0x17,
            0x18, 0x19, 0x1A, 0x1B, 0x1C, 0x1D, 0x35, 0x51, 0x52, 0x53):
    _GAS[_op] = G_VERYLOW          # add/sub/cmp/bit/shift/calldataload/mem
for _op in (0x02, 0x04, 0x05, 0x06, 0x07, 0x0B):
    _GAS[_op] = G_LOW              # mul/div/mod/signextend
for _op in (0x08, 0x09, 0x56):
    _GAS[_op] = G_MID              # addmod/mulmod/jump
_GAS[0x57] = G_HIGH                # jumpi
for _op in (0x30, 0x32, 0x33, 0x34, 0x36, 0x38, 0x3A, 0x3D, 0x41, 0x42,
            0x43, 0x44, 0x45, 0x46, 0x48, 0x50, 0x58, 0x59, 0x5A):
    _GAS[_op] = G_BASE
_GAS[0x5B] = G_JUMPDEST
_GAS[0x5F] = G_BASE                # PUSH0


def _mem_gas(words: int) -> int:
    return 3 * words + words * words // 512


def _charge(fr: _Frame, amount: int):
    fr.gas -= amount
    if fr.gas < 0:
        raise EvmError("out of gas")


def _expand(fr: _Frame, offset: int, size: int):
    """Charge memory expansion and grow the backing buffer."""
    if size == 0:
        return
    if offset + size > (1 << 32):
        raise EvmError("memory offset too large")
    words = (offset + size + 31) // 32
    if words > fr.mem_words:
        _charge(fr, _mem_gas(words) - _mem_gas(fr.mem_words))
        fr.mem_words = words
    need = words * 32
    if len(fr.mem) < need:
        fr.mem.extend(b"\x00" * (need - len(fr.mem)))


def _g2(words):
    # precompile ordering: (x_c1, x_c0, y_c1, y_c0)
    return (bn254.Fq2([int(words[1]), int(words[0])]),
            bn254.Fq2([int(words[3]), int(words[2])]))


def _modexp_gas(bsize: int, esize: int, msize: int, ehead: int) -> int:
    """EIP-2565."""
    words = (max(bsize, msize) + 7) // 8
    mult = words * words
    if esize <= 32:
        iters = max(ehead.bit_length() - 1, 0)
    else:
        iters = 8 * (esize - 32) + max(ehead.bit_length() - 1, 0)
    iters = max(iters, 1)
    return max(200, mult * iters // 3)


def _precompile(addr: int, data: bytes, gas: int):
    """Returns (ok, returndata, gas_used); ok=False consumes all gas."""
    g1 = bn254.g1_curve

    if addr == 0x02:               # SHA-256
        import hashlib
        cost = 60 + 12 * ((len(data) + 31) // 32)
        if cost > gas:
            return False, b"", gas
        return True, hashlib.sha256(data).digest(), cost

    def word(i):
        return int.from_bytes(data[32 * i:32 * i + 32].ljust(32, b"\x00"),
                              "big")

    def to_pt(x, y):
        if x == 0 and y == 0:
            return None
        if x >= Q or y >= Q:
            raise ValueError("coordinate out of range")
        pt = (bn254.Fq(x), bn254.Fq(y))
        if not g1.is_on_curve(pt):
            raise ValueError("not on curve")
        return pt

    def from_pt(pt):
        if pt is None:
            return b"\x00" * 64
        return int(pt[0]).to_bytes(32, "big") + int(pt[1]).to_bytes(32, "big")

    if addr == 0x05:               # modexp (EIP-2565)
        bsize, esize, msize = word(0), word(1), word(2)
        if max(bsize, esize, msize) > 1024:
            return False, b"", gas
        body = data[96:].ljust(bsize + esize + msize, b"\x00")
        ehead = int.from_bytes(body[bsize:bsize + min(esize, 32)], "big")
        cost = _modexp_gas(bsize, esize, msize, ehead)
        if cost > gas:
            return False, b"", gas
        b = int.from_bytes(body[:bsize], "big")
        e = int.from_bytes(body[bsize:bsize + esize], "big")
        m = int.from_bytes(body[bsize + esize:bsize + esize + msize], "big")
        out = (pow(b, e, m) if m else 0).to_bytes(msize, "big") if msize \
            else b""
        return True, out, cost
    if addr == 0x06:               # bn254 ecAdd (EIP-1108: 150)
        if gas < 150:
            return False, b"", gas
        try:
            p = to_pt(word(0), word(1))
            q2 = to_pt(word(2), word(3))
        except ValueError:
            return False, b"", gas
        return True, from_pt(g1.add(p, q2)), 150
    if addr == 0x07:               # bn254 ecMul (EIP-1108: 6000)
        if gas < 6000:
            return False, b"", gas
        try:
            p = to_pt(word(0), word(1))
        except ValueError:
            return False, b"", gas
        return True, from_pt(g1.mul_unsafe(p, word(2) % R)), 6000
    if addr == 0x08:               # bn254 pairing (EIP-1108)
        if len(data) % 192:
            return False, b"", gas
        k = len(data) // 192
        cost = 45000 + 34000 * k
        if cost > gas:
            return False, b"", gas
        pairs = []
        for i in range(k):
            w = [word(6 * i + j) for j in range(6)]
            try:
                p = to_pt(w[0], w[1])
            except ValueError:
                return False, b"", gas
            if any(v >= Q for v in w[2:]):
                return False, b"", gas
            g2pt = _g2(w[2:]) if any(w[2:]) else None
            if g2pt is not None:
                g2c = bn254.g2_curve
                if not g2c.is_on_curve(g2pt):
                    return False, b"", gas
                # EIP-197 requires order-r subgroup membership for G2
                if g2c.mul_unsafe(g2pt, R) is not None:
                    return False, b"", gas
            if p is None or g2pt is None:
                continue           # infinity factors contribute 1
            pairs.append((p, g2pt))
        ok = bn254.pairing_check(pairs) if pairs else True
        return True, (1 if ok else 0).to_bytes(32, "big"), cost
    raise EvmError(f"unsupported precompile 0x{addr:x}")


def execute(code: bytes, calldata: bytes, gas: int = 30_000_000,
            world=None, address: int = 0, caller: int = 0,
            static: bool = False):
    """Run `code` as a message call. Returns (success, returndata, gas_used).

    success=False covers both REVERT (returndata = revert payload) and
    abnormal halts (returndata = b"", all gas consumed)."""
    fr = _Frame(code, calldata, gas, world=world, address=address,
                caller=caller, static=static)
    try:
        out = _run(fr)
        return True, out, gas - fr.gas
    except _Revert as rv:
        return False, rv.data, gas - fr.gas
    except EvmError:
        return False, b"", gas


class _Revert(Exception):
    def __init__(self, data: bytes):
        self.data = data


class _Return(Exception):
    def __init__(self, data: bytes):
        self.data = data


def _run(fr: _Frame) -> bytes:
    code = fr.code
    stack = fr.stack
    try:
        while fr.pc < len(code):
            op = code[fr.pc]
            fr.pc += 1
            base = _GAS.get(op)
            if base is not None:
                _charge(fr, base)
            if 0x60 <= op <= 0x7F:             # PUSH1..PUSH32
                n = op - 0x5F
                _charge(fr, G_VERYLOW)
                stack.append(
                    int.from_bytes(code[fr.pc:fr.pc + n].ljust(n, b"\x00"),
                                   "big"))
                fr.pc += n
            elif 0x80 <= op <= 0x8F:           # DUP1..DUP16
                _charge(fr, G_VERYLOW)
                stack.append(stack[-(op - 0x7F)])
            elif 0x90 <= op <= 0x9F:           # SWAP1..SWAP16
                _charge(fr, G_VERYLOW)
                n = op - 0x8F
                stack[-1], stack[-n - 1] = stack[-n - 1], stack[-1]
            elif op == 0x5F:                   # PUSH0
                stack.append(0)
            elif op == 0x01:                   # ADD
                stack.append((stack.pop() + stack.pop()) & U256)
            elif op == 0x02:                   # MUL
                stack.append((stack.pop() * stack.pop()) & U256)
            elif op == 0x03:                   # SUB
                a = stack.pop()
                stack.append((a - stack.pop()) & U256)
            elif op == 0x04:                   # DIV
                a, b = stack.pop(), stack.pop()
                stack.append(a // b if b else 0)
            elif op == 0x06:                   # MOD
                a, b = stack.pop(), stack.pop()
                stack.append(a % b if b else 0)
            elif op == 0x08:                   # ADDMOD
                a, b, m = stack.pop(), stack.pop(), stack.pop()
                stack.append((a + b) % m if m else 0)
            elif op == 0x09:                   # MULMOD
                a, b, m = stack.pop(), stack.pop(), stack.pop()
                stack.append((a * b) % m if m else 0)
            elif op == 0x0A:                   # EXP
                a, e = stack.pop(), stack.pop()
                _charge(fr, 10 + 50 * ((e.bit_length() + 7) // 8))
                stack.append(pow(a, e, 1 << 256))
            elif op == 0x10:                   # LT
                a, b = stack.pop(), stack.pop()
                stack.append(1 if a < b else 0)
            elif op == 0x11:                   # GT
                a, b = stack.pop(), stack.pop()
                stack.append(1 if a > b else 0)
            elif op == 0x14:                   # EQ
                stack.append(1 if stack.pop() == stack.pop() else 0)
            elif op == 0x15:                   # ISZERO
                stack.append(1 if stack.pop() == 0 else 0)
            elif op == 0x16:                   # AND
                stack.append(stack.pop() & stack.pop())
            elif op == 0x17:                   # OR
                stack.append(stack.pop() | stack.pop())
            elif op == 0x18:                   # XOR
                stack.append(stack.pop() ^ stack.pop())
            elif op == 0x19:                   # NOT
                stack.append(stack.pop() ^ U256)
            elif op == 0x1A:                   # BYTE
                i, x = stack.pop(), stack.pop()
                stack.append((x >> (8 * (31 - i))) & 0xFF if i < 32 else 0)
            elif op == 0x1B:                   # SHL
                s, v = stack.pop(), stack.pop()
                stack.append((v << s) & U256 if s < 256 else 0)
            elif op == 0x1C:                   # SHR
                s, v = stack.pop(), stack.pop()
                stack.append(v >> s if s < 256 else 0)
            elif op == 0x20:                   # SHA3
                off, size = stack.pop(), stack.pop()
                _charge(fr, G_SHA3 + G_SHA3WORD * ((size + 31) // 32))
                _expand(fr, off, size)
                stack.append(int.from_bytes(
                    keccak256(bytes(fr.mem[off:off + size])), "big"))
            elif op == 0x34:                   # CALLVALUE (always 0 here)
                stack.append(0)
            elif op == 0x35:                   # CALLDATALOAD
                off = stack.pop()
                stack.append(int.from_bytes(
                    fr.calldata[off:off + 32].ljust(32, b"\x00"), "big"))
            elif op == 0x36:                   # CALLDATASIZE
                stack.append(len(fr.calldata))
            elif op == 0x37:                   # CALLDATACOPY
                dst, src, size = stack.pop(), stack.pop(), stack.pop()
                _charge(fr, G_VERYLOW + G_COPY * ((size + 31) // 32))
                _expand(fr, dst, size)
                fr.mem[dst:dst + size] = \
                    fr.calldata[src:src + size].ljust(size, b"\x00")
            elif op == 0x38:                   # CODESIZE
                stack.append(len(code))
            elif op == 0x39:                   # CODECOPY
                dst, src, size = stack.pop(), stack.pop(), stack.pop()
                _charge(fr, G_VERYLOW + G_COPY * ((size + 31) // 32))
                _expand(fr, dst, size)
                fr.mem[dst:dst + size] = code[src:src + size].ljust(
                    size, b"\x00")
            elif op == 0x3D:                   # RETURNDATASIZE
                stack.append(len(fr.returndata))
            elif op == 0x3E:                   # RETURNDATACOPY
                dst, src, size = stack.pop(), stack.pop(), stack.pop()
                _charge(fr, G_VERYLOW + G_COPY * ((size + 31) // 32))
                if src + size > len(fr.returndata):
                    raise EvmError("returndatacopy out of bounds")
                _expand(fr, dst, size)
                fr.mem[dst:dst + size] = fr.returndata[src:src + size]
            elif op == 0x50:                   # POP
                stack.pop()
            elif op == 0x51:                   # MLOAD
                off = stack.pop()
                _expand(fr, off, 32)
                stack.append(int.from_bytes(fr.mem[off:off + 32], "big"))
            elif op == 0x52:                   # MSTORE
                off, val = stack.pop(), stack.pop()
                _expand(fr, off, 32)
                fr.mem[off:off + 32] = val.to_bytes(32, "big")
            elif op == 0x53:                   # MSTORE8
                off, val = stack.pop(), stack.pop()
                _expand(fr, off, 1)
                fr.mem[off] = val & 0xFF
            elif op == 0x56:                   # JUMP
                dst = stack.pop()
                if dst not in fr.jumpdests:
                    raise EvmError(f"bad jump dest {dst}")
                fr.pc = dst
            elif op == 0x57:                   # JUMPI
                dst, cond = stack.pop(), stack.pop()
                if cond:
                    if dst not in fr.jumpdests:
                        raise EvmError(f"bad jump dest {dst}")
                    fr.pc = dst
            elif op == 0x58:                   # PC
                stack.append(fr.pc - 1)
            elif op == 0x5A:                   # GAS
                stack.append(fr.gas)
            elif op == 0x5B:                   # JUMPDEST
                pass
            elif op in (0xFA, 0xF1):           # STATICCALL / CALL
                g, addr = stack.pop(), stack.pop()
                value = stack.pop() if op == 0xF1 else 0
                aoff, asize, roff, rsize = (stack.pop(), stack.pop(),
                                            stack.pop(), stack.pop())
                if value:
                    raise EvmError("value transfers unsupported")
                _expand(fr, aoff, asize)
                _expand(fr, roff, rsize)
                args = bytes(fr.mem[aoff:aoff + asize])
                if 1 <= addr <= 9:
                    _charge(fr, G_WARMACCESS)  # precompiles are always warm
                    avail = fr.gas - fr.gas // 64
                    sub_gas = min(g, avail)
                    ok, out, used = _precompile(addr, args, sub_gas)
                    _charge(fr, used if ok else sub_gas)
                elif fr.world is not None and addr in fr.world.contracts:
                    _charge(fr, fr.world.touch_address(addr))
                    avail = fr.gas - fr.gas // 64
                    sub_gas = min(g, avail)
                    ok, out, used = fr.world.message_call(
                        addr, args, sub_gas, caller=fr.address,
                        static=fr.static or op == 0xFA)
                    _charge(fr, used)
                else:
                    raise EvmError(f"call to unknown account {addr:#x}")
                fr.returndata = out
                # geth copies returndata into [roff, rsize) on success AND
                # on REVERT (exceptional halts return no data)
                n_copy = min(rsize, len(out))
                if n_copy:
                    fr.mem[roff:roff + n_copy] = out[:n_copy]
                stack.append(1 if ok else 0)
            elif op == 0x54:                   # SLOAD
                if fr.world is None:
                    raise EvmError("SLOAD without world state")
                key = stack.pop()
                _charge(fr, fr.world.touch_slot(fr.address, key))
                stack.append(
                    fr.world.contracts[fr.address].storage.get(key, 0))
            elif op == 0x55:                   # SSTORE (EIP-2200/2929/3529)
                if fr.world is None:
                    raise EvmError("SSTORE without world state")
                if fr.static:
                    raise EvmError("SSTORE in static context")
                key, val = stack.pop(), stack.pop()
                w = fr.world
                st = w.contracts[fr.address].storage
                cold = w.touch_slot(fr.address, key, base_charge=False)
                cur = st.get(key, 0)
                orig = w.tx_original(fr.address, key, cur)
                if val == cur:
                    cost = 100
                elif orig == cur:              # clean slot
                    cost = 20000 if orig == 0 else 2900
                    if orig != 0 and val == 0:
                        w.refund += 4800
                else:                          # dirty slot (EIP-3529 rules)
                    cost = 100
                    if orig != 0:
                        if cur == 0:           # un-clearing: revoke refund
                            w.refund -= 4800
                        elif val == 0:
                            w.refund += 4800
                    if val == orig:            # restored to original
                        w.refund += (20000 - 100) if orig == 0 \
                            else (2900 - 100)
                _charge(fr, cold + cost)
                if val:
                    st[key] = val
                else:
                    st.pop(key, None)
            elif op == 0x30:                   # ADDRESS
                stack.append(fr.address)
            elif op == 0x33:                   # CALLER
                stack.append(fr.caller)
            elif op == 0xF3:                   # RETURN
                off, size = stack.pop(), stack.pop()
                _expand(fr, off, size)
                raise _Return(bytes(fr.mem[off:off + size]))
            elif op == 0xFD:                   # REVERT
                off, size = stack.pop(), stack.pop()
                _expand(fr, off, size)
                raise _Revert(bytes(fr.mem[off:off + size]))
            elif op == 0x00:                   # STOP
                return b""
            else:
                raise EvmError(f"unsupported opcode 0x{op:02x} @ {fr.pc - 1}")
        return b""
    except _Return as r:
        return r.data
    except IndexError:
        raise EvmError("stack underflow")


def tx_intrinsic_gas(calldata: bytes) -> int:
    """21000 + EIP-2028 calldata pricing."""
    zeros = calldata.count(0)
    return 21000 + 4 * zeros + 16 * (len(calldata) - zeros)


def deploy(init_code: bytes, gas: int = 30_000_000):
    """Run standalone constructor code (no world state); returns
    (runtime_code, gas_used) with the 200/byte deposit (EIP-170 enforced).
    Storage-using constructors must deploy through World.deploy."""
    ok, runtime, used = execute(init_code, b"", gas)
    if not ok:
        raise EvmError("constructor reverted")
    return runtime, used + _enforce_code_deposit(runtime)


def revert_reason(returndata: bytes) -> str | None:
    """Decode Error(string) revert payloads."""
    if len(returndata) >= 68 and returndata[:4] == bytes.fromhex("08c379a0"):
        ln = int.from_bytes(returndata[36:68], "big")
        return returndata[68:68 + ln].decode("utf-8", "replace")
    return None


class Contract:
    __slots__ = ("code", "storage", "_jumpdests")

    def __init__(self, code: bytes):
        self.code = code
        self.storage: dict[int, int] = {}
        self._jumpdests = None

    def jumpdests(self) -> set:
        if self._jumpdests is None:
            self._jumpdests = _jumpdests(self.code)
        return self._jumpdests


def _enforce_code_deposit(runtime: bytes) -> int:
    """EIP-170 limit + EIP-3860-era 200/byte deposit gas."""
    if len(runtime) > 24576:
        raise EvmError(f"EIP-170: runtime code {len(runtime)} B > 24576 B")
    return 200 * len(runtime)


class World:
    """Minimal multi-contract chain state: deployed code + storage, the
    per-transaction EIP-2929 warm sets, EIP-2200 original-value tracking,
    and revert journaling. The stand-in for the reference's anvil node in
    contract tests (`contract-tests/tests/spectre.rs`)."""

    def __init__(self):
        self.contracts: dict[int, Contract] = {}
        self._next_addr = 0x1000
        self._warm_addrs: set[int] = set()
        self._warm_slots: set[tuple[int, int]] = set()
        self._tx_original: dict[tuple[int, int], int] = {}
        self.refund = 0

    # -- per-transaction accounting --
    def begin_tx(self):
        self._warm_addrs = set()
        self._warm_slots = set()
        self._tx_original = {}
        self.refund = 0

    def tx_original(self, addr: int, key: int, current: int) -> int:
        """Value of the slot at transaction start (EIP-2200)."""
        return self._tx_original.setdefault((addr, key), current)

    def touch_address(self, addr: int) -> int:
        if addr in self._warm_addrs:
            return G_WARMACCESS
        self._warm_addrs.add(addr)
        return 2600

    def touch_slot(self, addr: int, key: int,
                   base_charge: bool = True) -> int:
        """SLOAD price (base_charge=True): 2100 cold / 100 warm.
        SSTORE cold surcharge (base_charge=False): 2100 cold / 0 warm."""
        if (addr, key) in self._warm_slots:
            return G_WARMACCESS if base_charge else 0
        self._warm_slots.add((addr, key))
        return 2100

    # -- revert journaling: snapshot world-visible state per call frame --
    def _snapshot(self):
        return ({a: dict(c.storage) for a, c in self.contracts.items()},
                set(self._warm_addrs), set(self._warm_slots),
                dict(self._tx_original), self.refund)

    def _restore(self, snap):
        storages, warm_a, warm_s, orig, refund = snap
        for a, st in storages.items():
            self.contracts[a].storage = st
        self._warm_addrs = warm_a
        self._warm_slots = warm_s
        self._tx_original = orig
        self.refund = refund

    def deploy(self, init_code: bytes, ctor_args: bytes = b"",
               gas: int = 30_000_000,
               enforce_eip170: bool = True) -> tuple[int, int]:
        """Run constructor (args appended to init code, solc-style);
        registers the returned runtime. Returns (address, gas_used).

        enforce_eip170=False admits oversized runtimes a real chain would
        reject — for exercising verifiers whose measured size exceeds the
        limit (the measurement itself is the honest result; callers must
        record it)."""
        addr = self._next_addr
        self._next_addr += 1
        self.contracts[addr] = Contract(b"")   # storage visible to ctor
        self.begin_tx()
        ok, runtime, used = execute(init_code + ctor_args, b"", gas,
                                    world=self, address=addr)
        if not ok:
            del self.contracts[addr]
            raise EvmError(f"constructor reverted: "
                           f"{revert_reason(runtime) or runtime.hex()}")
        self.contracts[addr].code = runtime
        deposit = _enforce_code_deposit(runtime) if enforce_eip170 \
            else 200 * len(runtime)
        return addr, used + deposit

    def transact(self, to: int, calldata: bytes, gas: int = 30_000_000,
                 caller: int = 0xCA11E12):
        """Top-level transaction. Returns (ok, returndata,
        gas_incl_intrinsic); refunds applied per EIP-3529 (<= used/5)."""
        self.begin_tx()
        self._warm_addrs.add(to)
        ok, out, used = self.message_call(to, calldata, gas, caller=caller)
        total = used + tx_intrinsic_gas(calldata)
        if ok:
            # EIP-3529: the refund cap is gas_used/5 INCLUDING intrinsic
            total -= min(max(self.refund, 0), total // 5)
        return ok, out, total

    def call_view(self, to: int, calldata: bytes, gas: int = 30_000_000):
        """eth_call-style read; no intrinsic gas added."""
        self.begin_tx()
        self._warm_addrs.add(to)
        return self.message_call(to, calldata, gas, caller=0, static=True)

    def message_call(self, to: int, calldata: bytes, gas: int,
                     caller: int = 0, static: bool = False):
        """Nested message call with revert semantics: a failing frame's
        storage writes and access-set additions are rolled back."""
        c = self.contracts[to]
        snap = self._snapshot()
        fr = _Frame(c.code, calldata, gas, world=self, address=to,
                    caller=caller, static=static, jumpdests=c.jumpdests())
        try:
            out = _run(fr)
            return True, out, gas - fr.gas
        except _Revert as rv:
            self._restore(snap)
            return False, rv.data, gas - fr.gas
        except EvmError:
            self._restore(snap)
            return False, b"", gas
