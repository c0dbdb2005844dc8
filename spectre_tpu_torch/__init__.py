"""spectre_tpu_torch: the KZG/SHPLONK proves on an NVIDIA H100 and the EVM tail.

The PyTorch + CUDA port of the JAX package `spectre_tpu`, which stays in the
repository as the reference. Layout:

    fields/   exact host arithmetic (BN254 fields, curves, pairing; BLS12-381 G1)
    ops/      device arithmetic: Montgomery field ops, complete EC add, the
              Pippenger MSM (kernels K1/K2/K2b), NTTs (K3/K4), BLS12-381 Fq
              and pubkey decompression (K6); host SHA-256 and Poseidon
    csrc/     the CUDA C++ sources of the kernels (sm_90a)
    plonk/    SRS, keygen, prover, verifier of the PLONKish proof system,
              with the wide SHA-256 region
    builder/  the circuit builder: context, gate, range, SHA-256, Poseidon chips
    gadgets/  SSZ merkleization, multiproofs, the committee's Poseidon
              commitment
    preprocessor/  witness acquisition: the Beacon client, beacon data ->
              the circuits' args, SSZ, the consensus-spec-test loader
    witness/  the circuits' arguments; a seeded flex-gate witness; the
              reference's serde fixtures
    models/   the app circuits (CommitteeUpdateCircuit)
    utils/    pinning files, checksum sidecars, health counters, fault
              injection, the circuit breaker, phase timers
    observability/  histograms and per-job span trees
    evm/      the Solidity verifier generator, its bytecode compiler, a
              metered EVM, the simulator (host)
    contracts/  the Spectre light-client contract: Solidity, model
    prover_service/  calldata encoding
    convert.py  the reference's numpy/int objects -> the port's objects

Entry points take `device=` and default to "cuda"; with no GPU they raise
unless the caller asks for the CPU, where every kernel wrapper runs its
plain PyTorch version.
"""
