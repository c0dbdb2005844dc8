"""In-circuit mirror of the PoseidonTranscript: Fiat-Shamir as constraints
(the port's copy of `spectre_tpu/builder/transcript_chip.py`).

snark-verifier's `PoseidonTranscript<Rc<Halo2Loader>>`: the aggregation
circuit derives every challenge of the inner proof's transcript again as
circuit cells, so the verified statement is bound to the exact proof bytes.
Cell for cell the native `plonk.transcript.PoseidonTranscript`: the same
duplex schedule (pending elements flushed in RATE chunks, a counter element
before each squeeze) and the same point encoding (3 x 88-bit limbs a
coordinate, the cells the MSM operates on), so `challenge().value` equals
the native transcript's output.
"""

from __future__ import annotations

from ..fields import bn254
from .context import AssignedValue, Context
from .poseidon_chip import PoseidonChip

R = bn254.R


class TranscriptChip:
    def __init__(self, poseidon: PoseidonChip | None = None):
        from ..plonk.transcript import PoseidonTranscript as PT
        self.pos = poseidon or PoseidonChip(t=PT.T, rate=PT.RATE, r_f=PT.R_F, r_p=PT.R_P)
        self.gate = self.pos.gate
        self._state: list | None = None
        self._pending: list = []
        self._counter = 0

    def _ensure_state(self, ctx: Context):
        if self._state is None:
            self._state = [ctx.load_constant(0) for _ in range(self.pos.t)]

    # -- absorbs ----------------------------------------------------------
    def absorb(self, cells):
        """Queue field-element cells (instance values, eval scalars, point
        limbs, already range-checked by their producers)."""
        self._pending.extend(cells)

    def absorb_constant_bytes(self, ctx: Context, b: bytes):
        """Constants (the vk digest): 16-byte big-endian chunks, as the
        native side."""
        for off in range(0, len(b), 16):
            self._pending.append(ctx.load_constant(int.from_bytes(b[off:off + 16], "big")))

    def absorb_point_limbs(self, ctx: Context, xy_limbs: list):
        """6 limb cells (x lo->hi, y lo->hi), the transcript point encoding."""
        if len(xy_limbs) != 6:
            raise ValueError("a point is 6 limb cells")
        self._pending.extend(xy_limbs)

    # -- squeeze ----------------------------------------------------------
    def challenge(self, ctx: Context) -> AssignedValue:
        self._ensure_state(ctx)
        gate = self.gate
        self._counter += 1
        self._pending.append(ctx.load_constant(self._counter))
        state = self._state
        rate = self.pos.rate
        pend = self._pending
        for off in range(0, len(pend), rate):
            chunk = pend[off:off + rate]
            state = ([state[0]]
                     + [gate.add(ctx, state[1 + i], v) for i, v in enumerate(chunk)]
                     + state[1 + len(chunk):])
            state = self.pos.permute(ctx, state)
        self._pending = []
        self._state = state
        return state[1]
