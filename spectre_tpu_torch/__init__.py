"""spectre_tpu_torch: the stage-1 KZG/SHPLONK prove on an NVIDIA H100.

The PyTorch + CUDA port of the JAX package `spectre_tpu`, which stays in the
repository as the reference. Layout:

    fields/   exact host arithmetic (BN254 fields, curves, pairing)
    ops/      device arithmetic: Montgomery field ops, complete EC add, the
              Pippenger MSM (kernels K1/K2), NTTs (kernels K3/K4)
    csrc/     the CUDA C++ sources of the four kernels (sm_90a)
    plonk/    SRS, keygen, prover, verifier of the PLONKish proof system
    convert.py  the reference's numpy/int objects -> the port's objects

Entry points take `device=` and default to "cuda"; with no GPU they raise
unless the caller asks for the CPU, where every kernel wrapper runs its
plain PyTorch version.
"""
