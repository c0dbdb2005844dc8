"""In-circuit BLS12-381 pairing: multi-Miller loop + final exponentiation
(the port's copy of `spectre_tpu/builder/pairing_chip.py`).

halo2-ecc's `PairingChip` / `BlsSignatureChip` (`sync_step_circuit.rs:171`
`assert_valid_signature`, the largest constraint block of the StepCircuit).

Design notes (constraint count first):
- Affine Miller loop over the TWISTED coordinates with witnessed slopes
  (div_unsafe + the chord/tangent constraint); untwisting is folded into the
  line's w-slot placement: l = xi*y_P + (lam*x_T - y_T) w^3 - lam*x_P w^5
  (the xi scaling lies in Fq2 (a subfield), killed by the final
  exponentiation, so it is sound to fold).
- Lines are 3-sparse in the w-basis -> `Fp12Chip.mul_sparse_035` (18 Fq2
  products instead of 36).
- Final exponentiation: easy part (conj/inv, frobenius^2) then the hard part
  via the BLS12 chain for the 3x exponent identity
      3*(p^4 - p^2 + 1)/r = 3 + (x-1)^2 (x+p) (x^2 + p^2 - 1)
  (checked on the host; the 3x multiple is sound for an ==1 check since
  cubing is a bijection on the order-r roots of unity).
- Signature soundness: adds a psi-endomorphism G2 subgroup check
  (psi(Q) == [x]Q) on the assigned signature so low-order points cannot hit
  the T == +-Q degenerate chord cases mid-loop.
"""

from __future__ import annotations

from ..fields import bls12_381 as bls
from .context import Context
from .fp2_chip import Fp2Chip, G2Chip
from .fp12_chip import Fp12Chip

P = bls.P
ABS_X_BITS = bin(-bls.BLS_X)[2:]   # |x| = 0xd201000000010000, MSB first


class PairingChip:
    def __init__(self, fp12: Fp12Chip):
        self.fp12 = fp12
        self.fp2 = fp12.fp2
        self.lz = fp12.lazy
        self.g2 = G2Chip(self.fp2)

    # -- line construction ---------------------------------------------
    def _line(self, ctx: Context, lam, t_pt, p_pt) -> tuple:
        """Sparse line coefficients (c0, c3, c5) for the line of slope lam
        through T (twisted coords), evaluated at P = (x_p, y_p) in G1."""
        lz = self.lz
        x_t, y_t = t_pt
        x_p, y_p = p_pt
        c0 = (y_p, y_p)                               # xi * y_P = y_P(1 + u)
        c3 = lz.reduce(ctx, lz.sub(ctx, lz.mul(ctx, lam, x_t),
                                   lz.lift(ctx, y_t)))
        c5 = lz.reduce(ctx, lz.neg(ctx, lz.mul_by_fq_cell(ctx, lam, x_p)))
        return c0, c3, c5

    def _double_step(self, ctx: Context, t_pt) -> tuple:
        """(2T, tangent slope): 2·(λ·y) ≡ 3x² constrained lazily
        (G2Chip.double_core)."""
        return self.g2.double_core(ctx, t_pt)

    def _add_step(self, ctx: Context, t_pt, q_pt, strict: bool = True) -> tuple:
        """(T+Q, chord slope; G2Chip.add_core). strict constrains
        x_T != x_Q; pass False only where T is itself fully
        constraint-determined (e.g. deterministic ladders over a pinned
        input), where dx != 0 as witnessed values already pins the slope
        uniquely."""
        return self.g2.add_core(ctx, t_pt, q_pt, strict=strict)

    def _sparse_to_fp12(self, ctx: Context, c0, c3, c5) -> tuple:
        zero = self.fp2.load_constant(ctx, (0, 0))
        return (c0, zero, zero, c3, zero, c5)

    # -- Miller loop ----------------------------------------------------
    def multi_miller_loop(self, ctx: Context, pairs) -> tuple:
        """pairs: [(P, Q)] with P = (x, y) G1 CrtUints (from
        EccChip.load_point) and Q a G2 point (from G2Chip.load_point).
        Returns f (Fp12 element, conjugated for the negative x)."""
        fp12 = self.fp12
        ts = [q for (_p, q) in pairs]
        f = None
        for bit in ABS_X_BITS[1:]:
            if f is not None:
                f = fp12.square(ctx, f)
            for i, (p_pt, q_pt) in enumerate(pairs):
                t2, lam = self._double_step(ctx, ts[i])
                c0, c3, c5 = self._line(ctx, lam, ts[i], p_pt)
                if f is None:
                    f = self._sparse_to_fp12(ctx, c0, c3, c5)
                else:
                    f = fp12.mul_sparse_035(ctx, f, c0, c3, c5)
                ts[i] = t2
            if bit == "1":
                for i, (p_pt, q_pt) in enumerate(pairs):
                    t2, lam = self._add_step(ctx, ts[i], q_pt)
                    c0, c3, c5 = self._line(ctx, lam, ts[i], p_pt)
                    f = fp12.mul_sparse_035(ctx, f, c0, c3, c5)
                    ts[i] = t2
        # x < 0: f_{x} ~ conj(f_{|x|}) up to final-exp-killed factors
        return fp12.conjugate(ctx, f)

    # -- final exponentiation ------------------------------------------
    def final_exponentiation(self, ctx: Context, f) -> tuple:
        fp12 = self.fp12
        # easy: f^((p^6-1)(p^2+1))
        t = fp12.mul(ctx, fp12.conjugate(ctx, f), fp12.inverse(ctx, f))
        t = fp12.mul(ctx, fp12.frobenius(ctx, t, 2), t)

        # hard (3x multiple): 3 + (x-1)^2 (x+p) (x^2+p^2-1); t is now
        # cyclotomic so inverse == conjugate, x<0 folds into conjugates,
        # and every chain square uses Granger-Scott cyclotomic squaring
        def pow_x_minus_1(u):
            # u^(x-1) = conj(u^|x| * u)
            return fp12.conjugate(ctx, fp12.mul(
                ctx, fp12.pow_abs_x(ctx, u, cyclotomic=True), u))

        a = pow_x_minus_1(t)
        a = pow_x_minus_1(a)
        b = fp12.mul(ctx, fp12.conjugate(
                         ctx, fp12.pow_abs_x(ctx, a, cyclotomic=True)),
                     fp12.frobenius(ctx, a, 1))
        bx2 = fp12.pow_abs_x(ctx, fp12.pow_abs_x(ctx, b, cyclotomic=True),
                             cyclotomic=True)
        c2 = fp12.mul(ctx, fp12.mul(ctx, bx2, fp12.frobenius(ctx, b, 2)),
                      fp12.conjugate(ctx, b))
        t3 = fp12.mul(ctx, fp12.cyclotomic_square(ctx, t), t)
        return fp12.mul(ctx, c2, t3)

    def assert_pairing_product_one(self, ctx: Context, pairs):
        """Constrain prod e(P_i, Q_i) == 1 (the BLS verification shape:
        e(pk, H(m)) * e(-g1, sig) == 1)."""
        f = self.multi_miller_loop(ctx, pairs)
        res = self.final_exponentiation(ctx, f)
        self.fp12.assert_one(ctx, res)

    # -- psi endomorphism + subgroup check ------------------------------
    def g2_psi(self, ctx: Context, q_pt) -> tuple:
        cx, cy = bls.psi_constants()
        fp2, lz = self.fp2, self.lz
        x, y = q_pt
        px = lz.reduce(ctx, lz.mul_const(ctx, fp2.conjugate(ctx, x), cx))
        py = lz.reduce(ctx, lz.mul_const(ctx, fp2.conjugate(ctx, y), cy))
        return (px, py)

    def g2_scalar_mul(self, ctx: Context, q_pt, k: int,
                      strict: bool = True) -> tuple:
        """[k]Q (k > 0) by double-and-add over the lazy point steps.
        strict=False is sound ONLY when Q is itself fully
        constraint-determined (e.g. a hash-to-curve output): there the
        witnessed dx != 0 pins every slope. For prover-chosen Q (a
        signature) keep strict: a crafted low-order Q can hit T == +-Q
        mid-ladder and an unconstrained slope would forge the rest."""
        if k <= 0:
            raise ValueError("a positive scalar")
        t = q_pt
        for bit in bin(k)[3:]:
            t, _ = self._double_step(ctx, t)
            if bit == "1":
                t, _ = self._add_step(ctx, t, q_pt, strict=strict)
        return t

    def g2_scalar_mul_abs_x(self, ctx: Context, q_pt) -> tuple:
        """[|x|] Q for the subgroup check — STRICT (adversarial input)."""
        return self.g2_scalar_mul(ctx, q_pt, -bls.BLS_X, strict=True)

    def assert_g2_subgroup(self, ctx: Context, q_pt):
        """psi(Q) == [x]Q = -[|x|]Q — rejects points outside the r-order
        subgroup (soundness guard for the Miller loop's strict chords)."""
        fp2 = self.fp2
        psi_q = self.g2_psi(ctx, q_pt)
        t = self.g2_scalar_mul_abs_x(ctx, q_pt)
        neg_y = fp2.neg(ctx, t[1])
        fp2.assert_equal(ctx, psi_q[0], t[0])
        fp2.assert_equal(ctx, psi_q[1], neg_y)
