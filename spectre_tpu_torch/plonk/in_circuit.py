"""The PLONK verifier as constraints: in-circuit SHPLONK proof verification
(the port's copy of `spectre_tpu/plonk/in_circuit.py`).

snark-verifier's `PlonkVerifier` over `Rc<Halo2Loader>`, the machinery under
`AggregationCircuit`: every scalar of the host verifier (`plonk/verifier.py`)
becomes a native-field cell, every proof commitment a non-native BN254-Fq
point with constrained limbs, the Fiat-Shamir transcript a Poseidon duplex
over cells, and the final pairing is not performed: its two G1 inputs are
returned as the KZG accumulator of the aggregation statement (the outer
verifier finishes it).

The same `all_expressions` the prover and the verifier use is evaluated
here over a `CellCtx`, so the in-circuit identity check combines exactly
the constraint set that was proven.
"""

from __future__ import annotations

from ..builder.context import AssignedValue, Context
from ..builder.fp_chip import EccChip, FpChip
from ..builder.msm_chip import MsmChip
from ..builder.range_chip import RangeChip
from ..builder.transcript_chip import TranscriptChip
from ..fields import bn254
from .expressions import all_expressions
from .keygen import ROT_LAST, VerifyingKey
from .srs import SRS
from .transcript import PoseidonTranscript

R = bn254.R
P = bn254.P


class _CellChal:
    """A challenge cell that supports the `beta * dj % R` integer arithmetic
    all_expressions performs: * emits a constant-mul gate, % is the
    identity."""

    def __init__(self, ctx: Context, gate, cell):
        self._ctx = ctx
        self._gate = gate
        self.cell = cell

    def __mul__(self, k: int):
        return _CellChal(self._ctx, self._gate, self._gate.mul(self._ctx, self.cell, k % R))

    def __mod__(self, _r: int):
        return self


def _chal_operand(s):
    return s.cell if isinstance(s, _CellChal) else s % R


class CellCtx:
    """all_expressions context over circuit cells; the challenges arrive as
    `_CellChal` wrappers."""

    def __init__(self, ctx: Context, gate, evals: dict, l0, llast, lblind, x):
        self._ctx = ctx
        self._gate = gate
        self._evals = evals
        self.l0 = l0
        self.llast = llast
        self.lblind = lblind
        self.x_col = x

    def var(self, key, rot):
        return self._evals[(key, rot)]

    def mul(self, a, b):
        return self._gate.mul(self._ctx, a, b)

    def add(self, a, b):
        return self._gate.add(self._ctx, a, b)

    def sub(self, a, b):
        return self._gate.sub(self._ctx, a, b)

    def scale(self, a, s):
        return self._gate.mul(self._ctx, a, _chal_operand(s))

    def add_const(self, a, s):
        return self._gate.add(self._ctx, a, _chal_operand(s))

    def const(self, s):
        return self._ctx.load_constant(s % R)


class VerifierChip:
    """Verifies one inner proof; returns the deferred-pairing accumulator."""

    def __init__(self, rng: RangeChip):
        self.rng = rng
        self.gate = rng.gate
        self.fq = FpChip(rng, modulus=P, num_limbs=3, limb_bits=88)
        self.ecc = EccChip(self.fq, b=3)
        self.msm = MsmChip(self.ecc)

    # -- scalar helpers ---------------------------------------------------
    def _div(self, ctx: Context, a, b) -> AssignedValue:
        """a / b with b != 0 enforced (a witnessed inverse, b * inv == 1)."""
        gate = self.gate
        bv = b.value if hasattr(b, "value") else b % R
        inv = ctx.load_witness(pow(bv, -1, R))
        ctx.constrain_constant(gate.mul(ctx, b, inv), 1)
        return gate.mul(ctx, a, inv)

    def _pow2k(self, ctx: Context, x, k: int) -> AssignedValue:
        out = x
        for _ in range(k):
            out = self.gate.mul(ctx, out, out)
        return out

    def _lagrange(self, ctx: Context, dom, zx, x, rows: list) -> dict:
        """L_i(x) = omega^i / n * (x^n - 1) / (x - omega^i) for each row."""
        gate = self.gate
        ninv = pow(dom.n, -1, R)
        out = {}
        for i in rows:
            wi = pow(dom.omega, i, R)
            den = gate.sub(ctx, x, wi)
            num = gate.mul(ctx, zx, wi * ninv % R)
            out[i] = self._div(ctx, num, den)
        return out

    # -- transcript-coupled readers --------------------------------------
    def _read_point(self, ctx: Context, tr, tchip):
        """Witness the next proof point: canonical 3 x 88 limbs a
        coordinate, constrained on the curve, the limbs absorbed (the
        in-circuit challenges depend on exactly these cells)."""
        pt = tr.read_point()
        x = self.fq.load(ctx, int(pt[0]))
        y = self.fq.load(ctx, int(pt[1]))
        self.fq.big.enforce_lt(ctx, x, P)
        self.fq.big.enforce_lt(ctx, y, P)
        self.ecc.constrain_on_curve(ctx, x, y)
        tchip.absorb_point_limbs(ctx, list(x.limbs) + list(y.limbs))
        return (x, y)

    def _read_scalar(self, ctx: Context, tr, tchip):
        cell = ctx.load_witness(tr.read_scalar())
        tchip.absorb([cell])
        return cell

    def _challenge(self, ctx: Context, tr, tchip):
        native = tr.challenge()
        cell = tchip.challenge(ctx)
        if cell.value != native:
            raise ValueError("in-circuit transcript diverged")
        return cell

    # -- the verifier -----------------------------------------------------
    def verify_proof(self, ctx: Context, vk: VerifyingKey, srs: SRS,
                     instance_cells: list, proof: bytes, heartbeat=None):
        """instance_cells: [[AssignedValue]], the inner proof's public
        inputs as cells (the caller exposes them in its own statement).
        Returns (acc_lhs, acc_rhs) point cells: the deferred pairing check
        e(acc_lhs, [tau]_2) == e(acc_rhs, [1]_2). `heartbeat` (a
        zero-argument callback) is stamped after the transcript, after the
        identity check, after the SHPLONK terms and inside the MSM (after
        each of its tables, windows and constant terms), so that no stretch
        of this minutes-long build goes unstamped; it changes no cell."""
        hb = heartbeat or (lambda: None)
        gate = self.gate
        cfg = vk.config
        dom = vk.domain
        n, u = cfg.n, cfg.usable_rows
        tr = PoseidonTranscript(proof)
        tchip = TranscriptChip()

        tr._absorb_bytes(vk.digest())
        tchip.absorb_constant_bytes(ctx, vk.digest())
        for col in instance_cells:
            if len(col) > u:
                raise ValueError("too many public inputs")
            for cell in col:
                tr.common_scalar(cell.value)
                tchip.absorb([cell])

        keys, pre_bg, pre_y, pre_x = vk.commitment_plan()
        commits = {}
        for key in keys[:pre_bg]:
            commits[key] = self._read_point(ctx, tr, tchip)
        beta = self._challenge(ctx, tr, tchip)
        gamma = self._challenge(ctx, tr, tchip)
        for key in keys[pre_bg:pre_y]:
            commits[key] = self._read_point(ctx, tr, tchip)
        y = self._challenge(ctx, tr, tchip)
        for key in keys[pre_y:pre_x]:
            commits[key] = self._read_point(ctx, tr, tchip)
        x = self._challenge(ctx, tr, tchip)

        plan = vk.query_plan()
        evals = {}
        for key, rot in plan:
            evals[(key, rot)] = self._read_scalar(ctx, tr, tchip)
        hb()

        # --- instance evaluations, computed in-circuit: the public-input
        # binding (these cells are the exposed instances) ---
        zx = gate.sub(ctx, self._pow2k(ctx, x, cfg.k), 1)  # x^n - 1
        for j in range(cfg.num_instance):
            rows = list(range(len(instance_cells[j])))
            lag = self._lagrange(ctx, dom, zx, x, rows)
            acc = ctx.load_constant(0)
            for i, cell in enumerate(instance_cells[j]):
                acc = gate.add(ctx, acc, gate.mul(ctx, cell, lag[i]))
            evals[(("inst", j), 0)] = acc

        # --- gate/permutation/lookup identity at x ---
        special = self._lagrange(ctx, dom, zx, x, [0, cfg.last_row] + list(range(u + 1, n)))
        l0 = special[0]
        llast = special[cfg.last_row]
        lblind = ctx.load_constant(0)
        for i in range(u + 1, n):
            lblind = gate.add(ctx, lblind, special[i])

        cctx = CellCtx(ctx, gate, evals, l0, llast, lblind, x)
        # materialize the stream: every expression's cells come before the
        # fold's mul_add cells, as in the reference (the cell order is the
        # layout, the pinning and the vk)
        exprs = list(all_expressions(cfg, cctx, _CellChal(ctx, gate, beta),
                                     _CellChal(ctx, gate, gamma)))
        acc = ctx.load_constant(0)
        for e in exprs:
            acc = gate.mul_add(ctx, acc, y, e)
        xn = gate.add(ctx, zx, 1)
        h01 = gate.mul(ctx, evals[(("h", 1), 0)], xn)
        xn2 = gate.mul(ctx, xn, xn)
        h_at_x = gate.add(ctx, gate.add(ctx, evals[(("h", 0), 0)], h01),
                          gate.mul(ctx, evals[(("h", 2), 0)], xn2))
        ctx.constrain_equal(acc, gate.mul(ctx, h_at_x, zx))
        hb()

        # --- SHPLONK (kzg.shplonk_accumulate over cells) ---
        v = self._challenge(ctx, tr, tchip)
        w1 = self._read_point(ctx, tr, tchip)
        uch = self._challenge(ctx, tr, tchip)
        w2 = self._read_point(ctx, tr, tchip)

        by_key: dict = {}
        for key, rot in plan:
            by_key.setdefault(key, []).append(rot)

        # rotation point cells: rot -> x * omega^rot
        rot_cells = {}
        all_rots = []
        for key, rots in by_key.items():
            for r_ in rots:
                if r_ not in rot_cells:
                    if r_ == ROT_LAST:
                        wpow = pow(dom.omega, cfg.last_row, R)
                    elif r_ < 0:
                        wpow = pow(dom.omega_inv, -r_, R)
                    else:
                        wpow = pow(dom.omega, r_, R)
                    rot_cells[r_] = gate.mul(ctx, x, wpow)
                    all_rots.append(r_)

        fixed_commits = vk.fixed_commitment_map()
        e_scalar = ctx.load_constant(0)
        vk_pow = ctx.load_constant(1)
        witness_pairs = []       # (point_cells, scalar_cell)
        constant_pairs = []      # (host_point, scalar_cell)
        for key, rots in by_key.items():
            # z_rest(u) over the complement rotation set
            z_rest = ctx.load_constant(1)
            for r_ in all_rots:
                if r_ not in rots:
                    z_rest = gate.mul(ctx, z_rest, gate.sub(ctx, uch, rot_cells[r_]))
            # r_k(u): the interpolation through (points, evals) at u
            if len(rots) == 1:
                r_u = evals[(key, rots[0])]
            else:
                r_u = ctx.load_constant(0)
                for rj in rots:
                    term = evals[(key, rj)]
                    num = ctx.load_constant(1)
                    den = ctx.load_constant(1)
                    for rk in rots:
                        if rk is rj or rk == rj:
                            continue
                        num = gate.mul(ctx, num, gate.sub(ctx, uch, rot_cells[rk]))
                        den = gate.mul(ctx, den, gate.sub(ctx, rot_cells[rj], rot_cells[rk]))
                    r_u = gate.add(ctx, r_u, gate.mul(ctx, term, self._div(ctx, num, den)))
            w = gate.mul(ctx, vk_pow, z_rest)
            e_scalar = gate.add(ctx, e_scalar, gate.mul(ctx, w, r_u))
            if key in commits:
                witness_pairs.append((commits[key], w))
            else:
                cpt = fixed_commits[key]
                if cpt is not None:   # infinity contributes nothing
                    constant_pairs.append((cpt, w))
            vk_pow = gate.mul(ctx, vk_pow, v)

        z_t_u = ctx.load_constant(1)
        for r_ in all_rots:
            z_t_u = gate.mul(ctx, z_t_u, gate.sub(ctx, uch, rot_cells[r_]))

        # F = sum w_k C_k - e_scalar G - z_t_u W1; acc_rhs = F + u W2
        witness_pairs.append((w1, gate.neg(ctx, z_t_u)))
        witness_pairs.append((w2, uch))
        constant_pairs.append((bn254.G1_GEN, gate.neg(ctx, e_scalar)))
        hb()
        acc_rhs = self.msm.msm(ctx, witness_pairs, constant_pairs, heartbeat=hb)

        tr.assert_consumed()
        return w2, acc_rhs

    def fold_accumulators(self, ctx: Context, accs: list):
        """RLC-fold N deferred-pairing accumulators into one, the
        challenges drawn from an in-circuit Poseidon transcript over the
        canonicalized accumulator points: the cell-for-cell mirror of
        `models.aggregation.accumulate`. Returns (lhs, rhs)."""
        tchip = TranscriptChip()
        cans = []
        for lhs, rhs in accs:
            clhs = tuple(self.fq.canonicalize(ctx, c) for c in lhs)
            crhs = tuple(self.fq.canonicalize(ctx, c) for c in rhs)
            cans.append((clhs, crhs))
            tchip.absorb_point_limbs(ctx, list(clhs[0].limbs) + list(clhs[1].limbs))
            tchip.absorb_point_limbs(ctx, list(crhs[0].limbs) + list(crhs[1].limbs))
        rs = [tchip.challenge(ctx) for _ in accs]
        lhs = self.msm.msm(ctx, [(cans[i][0], rs[i]) for i in range(len(accs))], [])
        rhs = self.msm.msm(ctx, [(cans[i][1], rs[i]) for i in range(len(accs))], [])
        return lhs, rhs

    @staticmethod
    def native_accumulator(vk: VerifyingKey, srs: SRS, instances: list, proof: bytes):
        """The host mirror returning the same accumulator (the test oracle
        and the witness cross-check): `verify_deferred` with the Poseidon
        transcript."""
        from ..models.aggregation import Accumulator
        from .verifier import verify_deferred
        acc = verify_deferred(vk, srs, instances, proof, transcript_cls=PoseidonTranscript)
        if acc is None:
            return None
        tau_side, one_side = acc
        return Accumulator(lhs=tau_side, rhs=one_side)
