"""In-circuit Poseidon sponge over the GateChip (the port's copy of
`spectre_tpu/builder/poseidon_chip.py`).

halo2-base's `PoseidonSponge` as the committee commitment uses it
(`poseidon.rs:42-95`); the parameters are ops.poseidon's (T=12, RATE=11,
R_F=8, R_P=65), so the circuit and the host sponge agree.
"""

from __future__ import annotations

from ..fields import bn254
from ..ops import poseidon as P
from .context import AssignedValue, Context
from .gate import GateChip

R = bn254.R


class PoseidonChip:
    def __init__(self, gate: GateChip | None = None,
                 t: int = P.T, rate: int = P.RATE,
                 r_f: int = P.R_F, r_p: int = P.R_P):
        self.gate = gate or GateChip()
        self.t, self.rate, self.r_f, self.r_p = t, rate, r_f, r_p
        self.rc, self.mds = P.constants(t, r_f, r_p)

    def permute(self, ctx: Context, state: list) -> list:
        """state: t AssignedValues -> t AssignedValues."""
        gate = self.gate
        if len(state) != self.t:
            raise ValueError(f"state of {self.t} cells")
        half = self.r_f // 2
        ri = 0

        def sbox(x):
            x2 = gate.mul(ctx, x, x)
            x4 = gate.mul(ctx, x2, x2)
            return gate.mul(ctx, x4, x)

        def mds_mul(s):
            return [gate.inner_product_const(ctx, s, self.mds[i])
                    for i in range(self.t)]

        s = state
        for _ in range(half):
            s = [gate.add(ctx, x, self.rc[ri * self.t + i]) for i, x in enumerate(s)]
            s = [sbox(x) for x in s]
            s = mds_mul(s)
            ri += 1
        for _ in range(self.r_p):
            s = [gate.add(ctx, x, self.rc[ri * self.t + i]) for i, x in enumerate(s)]
            s = [sbox(s[0])] + s[1:]
            s = mds_mul(s)
            ri += 1
        for _ in range(half):
            s = [gate.add(ctx, x, self.rc[ri * self.t + i]) for i, x in enumerate(s)]
            s = [sbox(x) for x in s]
            s = mds_mul(s)
            ri += 1
        return s

    def hash_values(self, ctx: Context, inputs: list) -> AssignedValue:
        """Sponge squeeze matching ops.poseidon.PoseidonSponge: absorb all
        inputs + trailing 1, permute per RATE chunk, output state[1]."""
        gate = self.gate
        state = [ctx.load_constant(0) for _ in range(self.t)]
        chunks = list(inputs) + [ctx.load_constant(1)]
        for off in range(0, len(chunks), self.rate):
            chunk = chunks[off:off + self.rate]
            state = ([state[0]]
                     + [gate.add(ctx, state[i + 1], v) for i, v in enumerate(chunk)]
                     + state[1 + len(chunk):])
            state = self.permute(ctx, state)
        return state[1]
