"""The outer circuit at k=17, shared by a CPU test and a GPU test.

The AggregationCircuit over the inner proof of `tests/test_aggregation.py`
(the k=10 app circuit, proved under the Poseidon transcript with blinding
seed 3), keyed at k=17 from the unsafe test SRS and proved under the Keccak
transcript with blinding seed 17.

The reference's outer vk digest, statement and proof bytes are recorded in
`tests/data/torch_agg_k17_keccak.json`, written by

    JAX_PLATFORMS=cpu python tests/_torch_agg_k17.py

(the JAX package on the CPU, a few minutes). `tests/test_torch_aggregation.py`
checks, as a `slow` test, that the reference still gives the record, and
`tests/test_torch_cuda.py` that the port's keygen and prove on the card give
it byte for byte. The port's own CPU path would run its ~200 MSMs at 2^17
through the plain K1, which takes hours.

Only `reference_outer` imports the JAX package, inside the function: the
GPU machine has no jax.
"""

import json
import os
import random
import time

RECORD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "torch_agg_k17_keccak.json")
INNER_K, INNER_SEED = 10, 3
OUTER_K, OUTER_SEED = 17, 17
# BN254's scalar field order, the same in both packages
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617


class OuterSpec:
    """A spec with no tracked pinning: the outer shape is auto-sized from
    the context at OUTER_K (never written to disk)."""
    name = "cputest"


def seeded(seed: int):
    r = random.Random(seed)
    return lambda: r.randrange(R)


def app(ctx, rng, which: int):
    """The two app circuits of tests/test_aggregation.py, on either
    package's builder."""
    g = rng.gate
    if which == 1:
        a, b = ctx.load_witness(1234), ctx.load_witness(5678)
        c = g.mul(ctx, a, b)
        rng.range_check(ctx, a, 16)
    else:
        a, b = ctx.load_witness(31), ctx.load_witness(64)
        c = g.add(ctx, g.mul(ctx, a, a), b)
        rng.range_check(ctx, c, 12)
    ctx.expose_public(c)


def port_outer(device):
    """The port's side: the inner proof on the CPU, the outer context on
    the host, keygen and the Keccak prove on `device`. Returns (circuit,
    pk, srs, statement, proof)."""
    from spectre_tpu_torch.builder.context import Context
    from spectre_tpu_torch.builder.range_chip import RangeChip
    from spectre_tpu_torch.models.aggregation import AggregationArgs, AggregationCircuit
    from spectre_tpu_torch.plonk.keygen import keygen
    from spectre_tpu_torch.plonk.prover import prove
    from spectre_tpu_torch.plonk.srs import SRS
    from spectre_tpu_torch.plonk.transcript import KeccakTranscript, PoseidonTranscript

    ctx = Context()
    app(ctx, RangeChip(lookup_bits=8), 1)
    cfg = ctx.auto_config(k=INNER_K, lookup_bits=8)
    asg = ctx.assignment(cfg)
    srs_in = SRS.unsafe_setup(INNER_K, device="cpu")
    pk_in = keygen(srs_in, cfg, asg.fixed, asg.selectors, asg.copies, device="cpu")
    proof_in = prove(pk_in, srs_in, asg, device="cpu", transcript=PoseidonTranscript(),
                     blinding_rng=seeded(INNER_SEED))
    args = AggregationArgs(inner_vk=pk_in.vk, srs=srs_in, inner_instances=asg.instances,
                           proof=proof_in)
    circuit, spec = AggregationCircuit, OuterSpec
    octx = circuit.build_context(args, spec, device=device)
    srs = SRS.unsafe_setup(OUTER_K, device=device)
    pk = circuit.create_pk(srs, spec, OUTER_K, args, device=device, ctx=octx)
    proof = circuit.prove(pk, srs, args, spec, device=device, ctx=octx,
                          transcript=KeccakTranscript(), blinding_rng=seeded(OUTER_SEED))
    return circuit, pk, srs, circuit.get_instances(args, spec), proof


def reference_outer() -> dict:
    """The reference's side on the CPU: its vk digest, statement and proof
    bytes, as the record holds them."""
    import gc

    from spectre_tpu.builder.context import Context
    from spectre_tpu.builder.range_chip import RangeChip
    from spectre_tpu.models.aggregation import AggregationArgs, AggregationCircuit
    from spectre_tpu.plonk import backend as B
    from spectre_tpu.plonk.keygen import keygen
    from spectre_tpu.plonk.prover import prove
    from spectre_tpu.plonk.srs import SRS
    from spectre_tpu.plonk.transcript import KeccakTranscript, PoseidonTranscript

    bk = B.get_backend("cpu")
    ctx = Context()
    app(ctx, RangeChip(lookup_bits=8), 1)
    cfg = ctx.auto_config(k=INNER_K, lookup_bits=8)
    asg = ctx.assignment(cfg)
    srs_in = SRS.unsafe_setup(INNER_K)
    pk_in = keygen(srs_in, cfg, asg.fixed, asg.selectors, asg.copies, bk)
    proof_in = prove(pk_in, srs_in, asg, bk, transcript=PoseidonTranscript(),
                     blinding_rng=seeded(INNER_SEED))
    args = AggregationArgs(inner_vk=pk_in.vk, srs=srs_in, inner_instances=asg.instances,
                           proof=proof_in)
    octx = AggregationCircuit.build_context(args, None)
    ocfg = octx.auto_config(k=OUTER_K, lookup_bits=AggregationCircuit.default_lookup_bits)
    oasg = octx.assignment(ocfg)
    stmt = [av.value for av in octx.instance_cells]
    del octx
    gc.collect()
    srs = SRS.unsafe_setup(OUTER_K)
    pk = keygen(srs, ocfg, oasg.fixed, oasg.selectors, oasg.copies, bk)
    proof = prove(pk, srs, oasg, bk, transcript=KeccakTranscript(),
                  blinding_rng=seeded(OUTER_SEED))
    return dict(k=OUTER_K, num_advice=ocfg.num_advice,
                num_lookup_advice=ocfg.num_lookup_advice, lookup_bits=ocfg.lookup_bits,
                vk_digest=pk.vk.digest().hex(), instances=[hex(v) for v in stmt],
                proof=proof.hex())


def read_record() -> dict:
    with open(RECORD) as f:
        return json.load(f)


if __name__ == "__main__":
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    t0 = time.perf_counter()
    record = reference_outer()
    os.makedirs(os.path.dirname(RECORD), exist_ok=True)
    with open(RECORD, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(f"wrote {RECORD} in {time.perf_counter() - t0:.1f} s")
