"""Poseidon permutation over BN254 Fr on the host (the port's copy of the
host part of `spectre_tpu/ops/poseidon.py`: the Grain LFSR, the constants,
`permute_native` and `PoseidonSponge`).

The spectre sponge shape (`lightclient-circuits/src/poseidon.rs:22-30`):
T=12, RATE=11, R_F=8, R_P=65, x^5 S-box. Round constants and the MDS matrix
follow the halo2-base / zcash-halo2 Grain procedure (`generate_constants` /
`generate_mds` with SECURE_MDS=0): rejection-sampled MSB-first round
constants; non-rejected LSB-first MDS xs/ys (batch-retried on duplicates);
Cauchy matrix 1/(x_i + y_j). The in-circuit sponge is
builder/poseidon_chip.py; the committee commitment is
gadgets/poseidon_commit.py.
"""

from __future__ import annotations

import functools

from ..fields import bn254

R = bn254.R

# spectre sponge shape (poseidon.rs:22-30)
T = 12
RATE = 11
R_F = 8
R_P = 65


class GrainLFSR:
    """80-bit Grain LFSR from the Poseidon reference parameter generator."""

    def __init__(self, field_bits: int, t: int, r_f: int, r_p: int,
                 field_type: int = 1, sbox: int = 0):
        bits = []
        bits += _to_bits(field_type, 2)
        bits += _to_bits(sbox, 4)
        bits += _to_bits(field_bits, 12)
        bits += _to_bits(t, 12)
        bits += _to_bits(r_f, 10)
        bits += _to_bits(r_p, 10)
        bits += [1] * 30
        assert len(bits) == 80
        self.state = bits
        for _ in range(160):
            self._next_bit()

    def _next_bit(self) -> int:
        s = self.state
        new = s[62] ^ s[51] ^ s[38] ^ s[23] ^ s[13] ^ s[0]
        self.state = s[1:] + [new]
        return new

    def next_filtered_bit(self) -> int:
        # von Neumann-style filtering: emit second bit of a pair iff first is 1
        while True:
            b1 = self._next_bit()
            b2 = self._next_bit()
            if b1:
                return b2

    def next_field_element(self, p: int, nbits: int) -> int:
        """Rejection-sampled element, bits MSB-first (used for round
        constants — matches the Poseidon reference generator and
        zcash-halo2/halo2-base `Grain::next_field_element`)."""
        while True:
            v = 0
            for _ in range(nbits):
                v = (v << 1) | self.next_filtered_bit()
            if v < p:
                return v

    def next_field_element_without_rejection(self, p: int, nbits: int) -> int:
        """Non-rejected element, bits packed LSB-first then wide-reduced
        (zcash-halo2/halo2-base `next_field_element_without_rejection`,
        used for the MDS xs/ys): bit i goes to byte i//8 bit i%8 of a
        64-byte little-endian buffer, interpreted mod p."""
        v = 0
        for i in range(nbits):
            v |= self.next_filtered_bit() << i
        return v % p


def _to_bits(v: int, n: int):
    return [(v >> (n - 1 - i)) & 1 for i in range(n)]


@functools.cache
def constants(t: int = T, r_f: int = R_F, r_p: int = R_P,
              secure_mds: int = 0):
    """(round_constants [(r_f + r_p) * t], mds [t][t]) over Fr.

    Generation follows halo2-base `OptimizedPoseidonSpec::new::<R_F,R_P,0>`
    (= zcash-halo2 `generate_constants` + `generate_mds`, the code path the
    reference instantiates in `poseidon.rs:79` via
    `PoseidonSponge::<F,T,RATE>::new::<R_F,R_P,0>`): round constants by
    MSB-first rejection sampling; MDS xs/ys by LSB-first non-rejected
    sampling, retried as a whole 2t batch until all 2t values are distinct,
    with `secure_mds` initial batches discarded (the reference uses 0);
    mds[i][j] = 1/(xs[i]+ys[j])."""
    nbits = R.bit_length()  # 254
    lfsr = GrainLFSR(nbits, t, r_f, r_p)
    rc = [lfsr.next_field_element(R, nbits) for _ in range((r_f + r_p) * t)]
    select = secure_mds
    while True:
        vals = [lfsr.next_field_element_without_rejection(R, nbits)
                for _ in range(2 * t)]
        if len(set(vals)) != 2 * t:
            continue
        if select != 0:
            select -= 1
            continue
        xs, ys = vals[:t], vals[t:]
        break
    mds = [[pow((xs[i] + ys[j]) % R, -1, R) for j in range(t)] for i in range(t)]
    return rc, mds


# ---------------------------------------------------------------------------
# native permutation (host ints) — used by witness gen / commitment mirror
# ---------------------------------------------------------------------------

def permute_native(state: list[int], t: int = T, r_f: int = R_F, r_p: int = R_P) -> list[int]:
    assert len(state) == t
    rc, mds = constants(t, r_f, r_p)
    s = [x % R for x in state]
    half = r_f // 2
    ri = 0

    def full_round(s, ri):
        s = [(x + rc[ri * t + i]) % R for i, x in enumerate(s)]
        s = [pow(x, 5, R) for x in s]
        return _mds_mul(s, mds), ri + 1

    def partial_round(s, ri):
        s = [(x + rc[ri * t + i]) % R for i, x in enumerate(s)]
        s[0] = pow(s[0], 5, R)
        return _mds_mul(s, mds), ri + 1

    for _ in range(half):
        s, ri = full_round(s, ri)
    for _ in range(r_p):
        s, ri = partial_round(s, ri)
    for _ in range(half):
        s, ri = full_round(s, ri)
    return s


def _mds_mul(s, mds):
    t = len(s)
    return [sum(mds[i][j] * s[j] for j in range(t)) % R for i in range(t)]


class PoseidonSponge:
    """Native sponge (absorb/squeeze), matching halo2-base's PoseidonSponge
    semantics: absorb buffers elements; squeeze pads with a single 1 then
    permutes chunks of RATE."""

    def __init__(self, t: int = T, rate: int = RATE, r_f: int = R_F, r_p: int = R_P):
        self.t, self.rate, self.r_f, self.r_p = t, rate, r_f, r_p
        self.state = [0] * t
        self.buf: list[int] = []

    def absorb(self, vals):
        self.buf.extend(int(v) % R for v in vals)

    def squeeze(self) -> int:
        chunks = self.buf + [1]
        self.buf = []
        for off in range(0, len(chunks), self.rate):
            chunk = chunks[off:off + self.rate]
            for i, v in enumerate(chunk):
                self.state[i + 1] = (self.state[i + 1] + v) % R
            self.state = permute_native(self.state, self.t, self.r_f, self.r_p)
        return self.state[1]
