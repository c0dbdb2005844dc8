"""A step-shaped inner circuit, shared by a CPU test and a GPU test.

The sync step's stage-1 proof has three lookup columns, one for each of the
tables nibble, nibble_op and range (its config: 16 advice, 3 lookup,
lookup_bits 18). The app circuit here sends cells to the same three tables
in the same way, through the nibble SHA-256 chip (a few of its word
operations) and a range check, and exposes two instances as the step does.
At k=10, the least k that holds the 512-row nibble_op table, its config has
3 lookup columns over nibble, nibble_op and range.

`tests/test_torch_step_aggregation.py` holds the port's proof of it, and the
`AggregationCircuit.variant("sync_step")` context over that proof, to the
reference's on the CPU; `tests/test_torch_cuda.py` keys and proves that
outer circuit on the card. `build` takes either package's chips; only
`port_inner` imports a package, the port, inside the function (the GPU
machine has no jax).
"""

import random

INNER_K, INNER_LOOKUP_BITS, INNER_SEED = 10, 8, 5
# the card test's outer circuit, auto-sized at OUTER_K
OUTER_K, OUTER_SEED = 17, 17
TABLES = ("nibble", "nibble_op", "range")
# BN254's scalar field order, the same in both packages
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617


class OuterSpec:
    """A spec with no tracked pinning: the outer shape is auto-sized from
    the context (never written to disk)."""
    name = "cputest"


def seeded(seed: int):
    r = random.Random(seed)
    return lambda: r.randrange(R)


def app(ctx, gate, rng, sha) -> None:
    """Words through the nibble SHA-256 chip (nibble and nibble_op lookups),
    their sum range-checked (range lookups), and two instances: the sum and
    maj of the words."""
    a, b, c = (sha.load_word(ctx, v) for v in (0x6A09E667, 0xBB67AE85, 0x3C6EF372))
    m = sha.maj(ctx, a, b, c)
    h = sha.ch(ctx, a, b, c)
    s = sha.mod_add(ctx, [m, h, sha.rotr(ctx, a, 7)])
    rng.range_check(ctx, s.cell, 32)
    ctx.expose_public(s.cell)
    ctx.expose_public(gate.add(ctx, m.cell, 1))


def build(ctx, gate_cls, range_cls, sha_cls):
    """The app on one package's builder; returns ctx."""
    gate = gate_cls()
    app(ctx, gate, range_cls(INNER_LOOKUP_BITS, gate), sha_cls(gate))
    return ctx


def port_inner(device):
    """The port's inner snark: (pk, srs, instances, proof), keyed at
    INNER_K and proved on `device` under the Poseidon transcript with
    blinding seed INNER_SEED."""
    from spectre_tpu_torch.builder import Context, GateChip, RangeChip
    from spectre_tpu_torch.builder.sha256_chip import Sha256Chip
    from spectre_tpu_torch.plonk.keygen import keygen
    from spectre_tpu_torch.plonk.prover import prove
    from spectre_tpu_torch.plonk.srs import SRS
    from spectre_tpu_torch.plonk.transcript import PoseidonTranscript

    ctx = build(Context(), GateChip, RangeChip, Sha256Chip)
    cfg = ctx.auto_config(k=INNER_K, lookup_bits=INNER_LOOKUP_BITS)
    asg = ctx.assignment(cfg)
    srs = SRS.unsafe_setup(INNER_K, device=device)
    pk = keygen(srs, cfg, asg.fixed, asg.selectors, asg.copies, device=device)
    proof = prove(pk, srs, asg, device=device, transcript=PoseidonTranscript(),
                  blinding_rng=seeded(INNER_SEED))
    return pk, srs, asg.instances, proof
