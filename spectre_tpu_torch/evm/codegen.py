"""Solidity verifier generator for the Keccak-transcript SHPLONK verifier
(the port's copy of `spectre_tpu/evm/codegen.py`: the source it emits is
the reference's byte for byte, but for its second line, which names this
module as the generator).

Reference parity: snark-verifier's EVM verifier codegen
(`gen_evm_verifier_shplonk`, `util/circuit.rs:182-194`) — the reference
emits Yul from its PlonkVerifier; here the generator walks the SAME
verification program as plonk/verifier.py (transcript replay, identity
check at x via `all_expressions`, SHPLONK pairing check) and emits a
self-contained Solidity contract:

- the Fiat–Shamir transcript is unrolled: the absorb sequence between
  challenges is static for a fixed vk shape, so each challenge becomes one
  keccak over (state || absorbed-bytes || "C" || counter), exactly
  mirroring `transcript.KeccakTranscript`;
- the gate/permutation/lookup identity is emitted by running
  `all_expressions` with a code-emitting ctx (the same single-source trick
  the prover/verifier/mock share — the generated contract provably checks
  the same polynomial identity);
- the SHPLONK check uses the EVM BN254 precompiles (ecMul 0x7, ecAdd 0x6,
  pairing 0x8; modexp 0x5 for inversions), with [1]_2 / [tau]_2 embedded
  from the SRS.

Proof byte layout and challenge schedule match `plonk/verifier.py` line by
line; `encode_calldata` produces the `verify(uint256[],bytes)` ABI call.
"""

from __future__ import annotations

from ..fields import bn254
from ..plonk.expressions import all_expressions
from ..plonk.keygen import ROT_LAST, VerifyingKey
from ..plonk.srs import SRS
from ..plonk.transcript import keccak256

R = bn254.R
Q = bn254.P


class _Sym:
    """Symbolic transcript challenge: supports the `beta * dj % R` integer
    arithmetic all_expressions performs, emitting Solidity instead."""

    def __init__(self, expr: str):
        self.expr = expr

    def __mul__(self, k: int):
        return _Sym(f"mulmod({self.expr}, {hex(k % R)}, R_MOD)")

    def __mod__(self, _r: int):
        return self


def _sym_expr(s) -> str:
    return s.expr if isinstance(s, _Sym) else hex(int(s) % R)


class _Emit:
    def __init__(self):
        self.lines: list[str] = []
        self._tmp = 0

    def line(self, s: str):
        self.lines.append(s)

    def fresh(self) -> str:
        """Memory-array temporary slot: `t[i]`. Stack locals would blow the
        EVM's 16-slot reach in legacy solc codegen (hundreds of field-op
        temporaries); one memory array costs a single stack slot."""
        self._tmp += 1
        return f"t[{self._tmp - 1}]"

    @property
    def num_tmps(self) -> int:
        return self._tmp


class _SolCtx:
    """all_expressions ctx that EMITS Solidity mulmod/addmod statements.
    Values are Solidity expressions (variable names or literals)."""

    def __init__(self, em: _Emit, eval_var):
        self._em = em
        self._eval_var = eval_var   # (key, rot) -> solidity expr
        self.l0 = "l0"
        self.llast = "llast"
        self.lblind = "lblind"
        self.x_col = "x"

    def var(self, key, rot):
        return self._eval_var(key, rot)

    def _bin(self, op, a, b):
        v = self._em.fresh()
        self._em.line(f"{v} = {op}({a}, {b}, R_MOD);")
        return v

    def mul(self, a, b):
        return self._bin("mulmod", a, b)

    def add(self, a, b):
        return self._bin("addmod", a, b)

    def sub(self, a, b):
        v = self._em.fresh()
        self._em.line(f"{v} = addmod({a}, R_MOD - {b}, R_MOD);")
        return v

    def scale(self, a, s):
        return self._bin("mulmod", a, _sym_expr(s))

    def add_const(self, a, s):
        return self._bin("addmod", a, _sym_expr(s))

    def const(self, s):
        return hex(int(s) % R)


def _pt_words(pt):
    if pt is None:
        return (0, 0)
    return (int(pt[0]), int(pt[1]))


def gen_evm_verifier(vk: VerifyingKey, srs: SRS, num_instances: int,
                     contract_name: str = "SpectreVerifier",
                     num_acc_limbs: int = 0) -> str:
    """Solidity source for `function verify(uint256[] calldata instances,
    bytes calldata proof) external view returns (bool)`.

    num_acc_limbs=12 (aggregation circuits): the first 12 instances are the
    deferred KZG accumulator (lhs.x, lhs.y, rhs.x, rhs.y as 3 x 88-bit LE
    limbs, snark-verifier `LimbsEncoding<3, 88>` parity) and the contract
    ALSO performs the deferred pairing e(lhs, [tau]_2) == e(rhs, [1]_2) —
    without it a compressed proof wrapping an invalid inner proof would
    verify (mirrors `AggregationCircuit.verify`)."""
    cfg = vk.config
    dom = vk.domain
    n, u = cfg.n, cfg.usable_rows
    QMOD = int(bn254.P)
    assert cfg.num_instance == 1, \
        "EVM codegen supports a single instance column (flat uint256[] ABI)"

    # ---- static proof layout (the same plan verifier.py consumes) ----
    read_points, pre_bg, pre_y, pre_x = vk.commitment_plan()

    plan = vk.query_plan()
    evals_off = pre_x * 64
    w1_off = evals_off + len(plan) * 32
    w2_off = w1_off + 64
    proof_len = w2_off + 64
    point_off = {key: 64 * i for i, key in enumerate(read_points)}
    eval_off = {kr: evals_off + 32 * i for i, kr in enumerate(plan)}

    em = _Emit()
    L = em.line

    # ---- helpers to emit transcript squeezes ----
    def absorb_chunks(items):
        """items: ('pt', key) | ('scalar_eval', idx_offset) — returns the
        abi.encodePacked argument list for the absorbed byte run."""
        parts = []
        for kind, v in items:
            if kind == "pt":
                off = point_off[v]
                parts.append(f'hex"50", proof[{off}:{off + 64}]')
            elif kind == "evals":
                lo, hi = v
                for o in range(lo, hi, 32):
                    parts.append(f'hex"53", proof[{o}:{o + 32}]')
        return parts

    ctr = [0]

    def squeeze(var, parts):
        ctr[0] += 1
        packed = ", ".join(["h"] + parts + [f'hex"43", uint32({ctr[0]})'])
        L(f"h = keccak256(abi.encodePacked({packed}));")
        L(f"uint256 {var} = _wide(h);")

    # ---- body: transcript replay ----
    L("bytes32 h = INIT_STATE;")
    L(f"require(proof.length == {proof_len}, \"proof length\");")
    L(f"require(instances.length == {num_instances}, \"instances length\");")
    # vk digest + instances absorbed into the first squeeze's buffer
    pre_parts = ["VK_DIGEST"]
    L("bytes memory instAbsorb;")
    L("for (uint256 i = 0; i < instances.length; i++) {")
    L("    require(instances[i] < R_MOD, \"instance range\");")
    L("    instAbsorb = abi.encodePacked(instAbsorb, hex\"53\", "
      "bytes32(instances[i]));")
    L("}")
    pre_parts.append("instAbsorb")
    # on-curve checks are delegated to the EC precompiles (they reject
    # non-curve and non-canonical points on first use)
    pre_parts += absorb_chunks([("pt", k) for k in read_points[:pre_bg]])
    squeeze("beta", pre_parts)
    squeeze("gamma", [])   # consecutive squeeze, nothing absorbed between
    squeeze("y", absorb_chunks([("pt", k)
                                for k in read_points[pre_bg:pre_y]]))
    squeeze("x", absorb_chunks([("pt", k)
                                for k in read_points[pre_y:pre_x]]))

    # scalar eval canonicity
    L(f"for (uint256 o = {evals_off}; o < {w1_off}; o += 32) "
      "{ require(uint256(bytes32(proof[o:o+32])) < R_MOD, \"eval range\"); }")

    # ---- lagrange evals: l0, llast, lblind, instance rows ----
    L(f"uint256 xn = _pow(x, {n});")
    L("uint256 zx = addmod(xn, R_MOD - 1, R_MOD);")
    L(f"uint256 ninv = {hex(pow(n, -1, R))};")
    omega = dom.omega

    def lagrange_expr(row):
        wi = pow(omega, row, R)
        return (f"mulmod(mulmod(mulmod({hex(wi)}, zx, R_MOD), "
                f"_inv(addmod(x, R_MOD - {hex(wi)}, R_MOD)), R_MOD), "
                "ninv, R_MOD)")

    L(f"uint256 l0 = {lagrange_expr(0)};")
    L(f"uint256 llast = {lagrange_expr(cfg.last_row)};")
    L("uint256 lblind = 0;")
    for i in range(u + 1, n):
        L(f"lblind = addmod(lblind, {lagrange_expr(i)}, R_MOD);")

    # instance evaluations (public-input binding); wi tracked incrementally
    L("uint256 instEval = 0;")
    L("{")
    L("uint256 wi = 1;")
    L("for (uint256 i = 0; i < instances.length; i++) {")
    L("    uint256 li = mulmod(mulmod(mulmod(wi, zx, R_MOD), "
      "_inv(addmod(x, R_MOD - wi, R_MOD)), R_MOD), ninv, R_MOD);")
    L("    instEval = addmod(instEval, mulmod(instances[i], li, R_MOD), R_MOD);")
    L(f"    wi = mulmod(wi, {hex(omega)}, R_MOD);")
    L("}")
    L("}")

    # ---- identity check via all_expressions ----
    def eval_var(key, rot):
        kind = key[0]
        if kind == "inst":
            return "instEval"
        if (key, rot) in eval_off:
            o = eval_off[(key, rot)]
            return f"uint256(bytes32(proof[{o}:{o + 32}]))"
        raise KeyError((key, rot))

    ctx = _SolCtx(em, eval_var)
    exprs = all_expressions(cfg, ctx, _Sym("beta"), _Sym("gamma"))
    L("uint256 acc = 0;")
    for e in exprs:
        L(f"acc = addmod(mulmod(acc, y, R_MOD), {e}, R_MOD);")
    h0 = eval_var(("h", 0), 0)
    h1 = eval_var(("h", 1), 0)
    h2 = eval_var(("h", 2), 0)
    L(f"uint256 hAtX = addmod({h0}, mulmod(xn, addmod({h1}, "
      f"mulmod(xn, {h2}, R_MOD), R_MOD), R_MOD), R_MOD);")
    L("require(acc == mulmod(hAtX, zx, R_MOD), \"identity\");")

    # ---- SHPLONK ----
    squeeze("v", absorb_chunks([("evals", (evals_off, w1_off))]))
    squeeze("uch", [f'hex"50", proof[{w1_off}:{w1_off + 64}]'])
    # fixed commitments table (one source with the Python verifier)
    fixed_commits = vk.fixed_commitment_map()

    by_key: dict = {}
    for key, rot in plan:
        by_key.setdefault(key, []).append(rot)

    def rot_factor(rot):
        if rot == ROT_LAST:
            return pow(omega, cfg.last_row, R)
        if rot < 0:
            return pow(dom.omega_inv, -rot, R)
        return pow(omega, rot, R)

    all_rots = []
    for key, rots in by_key.items():
        for r in rots:
            if r not in all_rots:
                all_rots.append(r)
    # rotation point values p_r = x * omega^rot
    for i, rot in enumerate(all_rots):
        L(f"uint256 p{i} = mulmod(x, {hex(rot_factor(rot))}, R_MOD);")
    rot_var = {rot: f"p{i}" for i, rot in enumerate(all_rots)}

    L("uint256[2] memory F = [uint256(0), uint256(0)];")
    L("uint256 eScalar = 0;")
    L("uint256 vk_pow = 1;")
    for key, rots in by_key.items():
        # z_rest(u) = prod over rots NOT in this entry
        L("{")
        L("uint256 zRest = 1;")
        for rot in all_rots:
            if rot not in rots:
                L(f"zRest = mulmod(zRest, addmod(uch, R_MOD - {rot_var[rot]},"
                  " R_MOD), R_MOD);")
        L("uint256 w = mulmod(vk_pow, zRest, R_MOD);")
        # r(u): lagrange interpolation through the (p_rot, eval) pairs
        L("uint256 rU = 0;")
        for i, ri in enumerate(rots):
            num = "1"
            den = "1"
            for rj in rots:
                if rj == ri:
                    continue
                num = (f"mulmod({num}, addmod(uch, R_MOD - {rot_var[rj]}, "
                       "R_MOD), R_MOD)")
                den = (f"mulmod({den}, addmod({rot_var[ri]}, R_MOD - "
                       f"{rot_var[rj]}, R_MOD), R_MOD)")
            ev = eval_var(key, ri)
            L(f"rU = addmod(rU, mulmod(mulmod({ev}, {num}, R_MOD), "
          f"_inv({den}), R_MOD), R_MOD);")
        # commitment source
        if key in point_off:
            o = point_off[key]
            L(f"F = _ecAdd(F, _ecMul([uint256(bytes32(proof[{o}:{o + 32}])), "
              f"uint256(bytes32(proof[{o + 32}:{o + 64}]))], w));")
        else:
            cx, cy = _pt_words(fixed_commits[key])
            L(f"F = _ecAdd(F, _ecMul([{hex(cx)}, {hex(cy)}], w));")
        L("eScalar = addmod(eScalar, mulmod(w, rU, R_MOD), R_MOD);")
        L("vk_pow = mulmod(vk_pow, v, R_MOD);")
        L("}")
    # z_T(u)
    L("uint256 zT = 1;")
    for rot in all_rots:
        L(f"zT = mulmod(zT, addmod(uch, R_MOD - {rot_var[rot]}, R_MOD), "
          "R_MOD);")
    gx, gy = _pt_words(bn254.G1_GEN)
    L(f"F = _ecAdd(F, _ecMul([{hex(gx)}, {hex(gy)}], "
      "R_MOD - eScalar));")
    L(f"F = _ecAdd(F, _ecMul(_negPt([uint256(bytes32(proof[{w1_off}:"
      f"{w1_off + 32}])), uint256(bytes32(proof[{w1_off + 32}:"
      f"{w1_off + 64}]))]), zT));")
    L(f"uint256[2] memory W2 = [uint256(bytes32(proof[{w2_off}:"
      f"{w2_off + 32}])), uint256(bytes32(proof[{w2_off + 32}:"
      f"{w2_off + 64}]))];")
    L("uint256[2] memory lhs = _ecAdd(F, _ecMul(W2, uch));")
    # pairing: e(lhs, G2_GEN) * e(-W2, G2_TAU) == 1
    g2g = srs.g2_gen
    g2t = srs.g2_tau
    L("uint256[12] memory pin;")
    for i, val in enumerate(
            ["lhs[0]", "lhs[1]",
             hex(int(g2g[0].c[1])), hex(int(g2g[0].c[0])),
             hex(int(g2g[1].c[1])), hex(int(g2g[1].c[0]))]):
        L(f"pin[{i}] = {val};")
    L("uint256[2] memory negW2 = _negPt(W2);")
    for i, val in enumerate(
            ["negW2[0]", "negW2[1]",
             hex(int(g2t[0].c[1])), hex(int(g2t[0].c[0])),
             hex(int(g2t[1].c[1])), hex(int(g2t[1].c[0]))]):
        L(f"pin[{6 + i}] = {val};")
    if not num_acc_limbs:
        L("return _pairing(pin);")
    else:
        # --- deferred KZG accumulator pairing (aggregation statements) ---
        assert num_acc_limbs == 12, "accumulator layout is 12 x 88-bit limbs"
        # the pairing and accumulator-limb checks return false (not revert)
        # so both the plain and accumulator paths agree on how an invalid
        # final check reports; structural requires (lengths, canonicity)
        # still revert in both paths
        L("if (!_pairing(pin)) { return false; }")
        L("// deferred accumulator: e(accL, [tau]_2) * e(-accR, [1]_2) == 1")
        for c, name in enumerate(["aLx", "aLy", "aRx", "aRy"]):
            terms = " + ".join(
                f"(instances[{3 * c + i}] << {88 * i})" if i
                else f"instances[{3 * c}]"
                for i in range(3))
            # limb ranges so the shifted sum cannot wrap uint256 (top limb
            # < 2^80 since 80 + 176 = 256); the coord < Q check then pins
            # the canonical value
            L(f"if (!(instances[{3 * c}] < (1 << 88) && "
              f"instances[{3 * c + 1}] < (1 << 88) && "
              f"instances[{3 * c + 2}] < (1 << 80))) {{ return false; }}")
            L(f"uint256 {name} = {terms};")
            L(f"if (!({name} < Q_MOD)) {{ return false; }}")
        L("uint256[2] memory negAccR = _negPt([aRx, aRy]);")
        for i, val in enumerate(
                ["aLx", "aLy",
                 hex(int(g2t[0].c[1])), hex(int(g2t[0].c[0])),
                 hex(int(g2t[1].c[1])), hex(int(g2t[1].c[0]))]):
            L(f"pin[{i}] = {val};")
        for i, val in enumerate(
                ["negAccR[0]", "negAccR[1]",
                 hex(int(g2g[0].c[1])), hex(int(g2g[0].c[0])),
                 hex(int(g2g[1].c[1])), hex(int(g2g[1].c[0]))]):
            L(f"pin[{6 + i}] = {val};")
        L("return _pairing(pin);")

    # temp slots live in one memory array (stack-depth safety); declared first
    body_lines = ([f"uint256[{max(em.num_tmps, 1)}] memory t;"] + em.lines)
    body_src = "\n        ".join(body_lines)

    init_state = keccak256(b"spectre-tpu-transcript-v1")
    src = f"""// SPDX-License-Identifier: MIT
// Auto-generated by spectre_tpu_torch.evm.codegen — DO NOT EDIT.
// Verifier for circuit shape k={cfg.k} advice={cfg.num_advice} \
lookup={cfg.num_lookup_advice} fixed={cfg.num_fixed}
// NOTE: compile with `solc --via-ir` (field-op temporaries live in one
// memory array; ~20 named locals remain, beyond the legacy pipeline's
// comfortable stack reach for some shapes).
pragma solidity ^0.8.19;

contract {contract_name} {{
    uint256 internal constant R_MOD =
        {hex(R)};
    uint256 internal constant Q_MOD =
        {hex(QMOD)};
    bytes32 internal constant INIT_STATE =
        {"0x" + init_state.hex()};
    bytes32 internal constant VK_DIGEST =
        {"0x" + vk.digest().hex()};
    // 2^256 mod R (for folding the 64-byte squeeze into a scalar)
    uint256 internal constant POW256 = {hex((1 << 256) % R)};

    function _wide(bytes32 hi) internal pure returns (uint256) {{
        uint256 lo = uint256(keccak256(abi.encodePacked(hi)));
        return addmod(mulmod(uint256(hi) % R_MOD, POW256, R_MOD),
                      lo % R_MOD, R_MOD);
    }}

    function _pow(uint256 base, uint256 e) internal view returns (uint256 r) {{
        (bool ok, bytes memory out) = address(5).staticcall(abi.encode(
            uint256(32), uint256(32), uint256(32), base, e, R_MOD));
        require(ok, "modexp");
        r = abi.decode(out, (uint256));
    }}

    function _inv(uint256 a) internal view returns (uint256) {{
        require(a != 0, "inv(0)");
        return _pow(a, R_MOD - 2);
    }}

    function _ecMul(uint256[2] memory p, uint256 s)
            internal view returns (uint256[2] memory r) {{
        (bool ok, bytes memory out) = address(7).staticcall(
            abi.encode(p[0], p[1], s));
        require(ok, "ecMul");
        (r[0], r[1]) = abi.decode(out, (uint256, uint256));
    }}

    function _ecAdd(uint256[2] memory p, uint256[2] memory q)
            internal view returns (uint256[2] memory r) {{
        (bool ok, bytes memory out) = address(6).staticcall(
            abi.encode(p[0], p[1], q[0], q[1]));
        require(ok, "ecAdd");
        (r[0], r[1]) = abi.decode(out, (uint256, uint256));
    }}

    function _negPt(uint256[2] memory p)
            internal pure returns (uint256[2] memory) {{
        if (p[0] == 0 && p[1] == 0) return p;
        return [p[0], Q_MOD - p[1]];
    }}

    function _pairing(uint256[12] memory pin)
            internal view returns (bool) {{
        (bool ok, bytes memory out) = address(8).staticcall(abi.encode(
            pin[0], pin[1], pin[2], pin[3], pin[4], pin[5],
            pin[6], pin[7], pin[8], pin[9], pin[10], pin[11]));
        require(ok, "pairing");
        return abi.decode(out, (uint256)) == 1;
    }}

    function verify(uint256[] calldata instances, bytes calldata proof)
            external view returns (bool) {{
        {body_src}
    }}
}}
"""
    return src


def encode_calldata(instances: list, proof: bytes) -> bytes:
    """ABI call bytes for verify(uint256[],bytes) (reference:
    `encode_calldata` in snark-verifier, `rpc.rs:160-162`)."""
    sel = keccak256(b"verify(uint256[],bytes)")[:4]
    head = (64).to_bytes(32, "big")      # offset of instances
    inst_data = len(instances).to_bytes(32, "big") + b"".join(
        (int(v) % R).to_bytes(32, "big") for v in instances)
    proof_off = 64 + len(inst_data)
    head += proof_off.to_bytes(32, "big")
    proof_data = len(proof).to_bytes(32, "big") + proof
    if len(proof) % 32:
        proof_data += b"\x00" * (32 - len(proof) % 32)
    return sel + head + inst_data + proof_data
