"""The reference's k=7 gate-and-lookup circuit (tests/test_ntt_modes.py
TestNttModeProofBytes), keyed and proved by the reference, keyed by the
port: the fixture of the port's NTT-mode and 8-bit-limb proof-byte tests."""

import random

from spectre_tpu.fields.bn254 import R


def k7_port_key():
    """The reference's k=7 gate-and-lookup circuit (tests/test_ntt_modes.py
    TestNttModeProofBytes), keyed and proved by the reference under seeded
    blinding, and keyed by the port (its vk digest the reference's): (port
    pk, port SRS, port assignment, the reference's proof, instances)."""
    from spectre_tpu.plonk import backend as RB
    from spectre_tpu.plonk.constraint_system import Assignment, CircuitConfig
    from spectre_tpu.plonk.keygen import keygen as ref_keygen
    from spectre_tpu.plonk.prover import prove as ref_prove
    from spectre_tpu.plonk.srs import SRS as RefSRS
    from spectre_tpu_torch import convert
    from spectre_tpu_torch.plonk.keygen import keygen
    from spectre_tpu_torch.plonk.srs import SRS

    k = 7
    cfg = CircuitConfig(k=k, num_advice=1, num_lookup_advice=1, num_fixed=1, lookup_bits=4)
    n = cfg.n
    x_w, y_w = 7, 3
    out = x_w + x_w * y_w
    advice = [[0] * n for _ in range(cfg.num_advice)]
    advice[0][0], advice[0][1], advice[0][2], advice[0][3] = x_w, x_w, y_w, out
    advice[0][4] = 5
    selectors = [[0] * n for _ in range(cfg.num_advice)]
    selectors[0][0] = 1
    lookup = [[0] * n for _ in range(cfg.num_lookup_advice)]
    lookup[0][0] = x_w
    fixed = [[0] * n for _ in range(cfg.num_fixed)]
    fixed[0][0] = 5
    copies = [
        ((cfg.col_instance(0), 0), (cfg.col_gate_advice(0), 3)),
        ((cfg.col_fixed(0), 0), (cfg.col_gate_advice(0), 4)),
        ((cfg.col_gate_advice(0), 0), (cfg.col_lookup_advice(0), 0)),
    ]
    rasg = Assignment(cfg, advice, lookup, fixed, selectors, [[out]], copies)
    rsrs = RefSRS.unsafe_setup(k)
    bk = RB.get_backend("cpu")
    rpk = ref_keygen(rsrs, cfg, fixed, selectors, copies, bk)
    rproof = ref_prove(rpk, rsrs, rasg, bk, blinding_rng=seeded_blinding())

    srs = SRS.unsafe_setup(k, device="cpu")
    asg = convert.assignment(rasg)
    pk = keygen(srs, asg.config, asg.fixed, asg.selectors, asg.copies, device="cpu")
    assert pk.vk.digest() == rpk.vk.digest()
    return pk, srs, asg, rproof, [[out]]


def seeded_blinding():
    r = random.Random(0x177E57)
    return lambda: r.randrange(R)
