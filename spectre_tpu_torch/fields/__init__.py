"""Host-side exact arithmetic: prime fields, extension towers, curves, pairings.

Own copies of the JAX package's jax-free field modules: pure Python over
arbitrary-precision ints, the correctness oracle and the verifier-side math.
"""
