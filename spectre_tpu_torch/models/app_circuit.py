"""AppCircuit lifecycle: build -> pin -> keygen -> prove -> verify (the
port's copy of `spectre_tpu/models/app_circuit.py`).

The `AppCircuit` trait (`util/circuit.rs:86-239`): keygen from a default
witness at a pinned shape, proofs from the same pinning. Every entry point
takes `device` (default CUDA, which raises without a GPU unless the caller
passes "cpu"): keygen and prove run there; witness generation and the
verifier are host work.
"""

from __future__ import annotations

import gc
import os

from ..builder import Context
from ..device import resolve
from ..plonk.backend import TorchBackend
from ..plonk.keygen import ProvingKey, keygen
from ..plonk.prover import prove as plonk_prove
from ..plonk.srs import SRS
from ..plonk.verifier import verify as plonk_verify
from ..utils.pinning import Pinning

BUILD_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "build")


class AppCircuit:
    """Subclasses define name, default_lookup_bits, build(ctx, args, spec)
    -> the instance cells (already exposed), and get_instances(args, spec)
    -> the public inputs computed on the host."""

    name = "app"
    default_lookup_bits = 8

    @classmethod
    def build(cls, ctx: Context, args, spec):
        raise NotImplementedError

    @classmethod
    def get_instances(cls, args, spec) -> list:
        raise NotImplementedError

    @classmethod
    def build_context(cls, args, spec, device=None, **kwargs) -> Context:
        """Witness generation (on the host) with the cyclic GC paused: the
        builder holds no reference cycles, and collections over millions
        of cells cost more than the build."""
        resolve(device)
        ctx = Context()
        was_enabled = gc.isenabled()
        gc.disable()
        try:
            cls.build(ctx, args, spec, **kwargs)
        finally:
            if was_enabled:
                gc.enable()
        return ctx

    @classmethod
    def pinning_path(cls, spec, k: int) -> str:
        return os.path.join(BUILD_DIR, f"{cls.name}_{spec.name}_{k}.pinning.json")

    @classmethod
    def pinning(cls, spec, k: int, ctx: Context | None = None) -> Pinning:
        """The tracked pinning of (spec, k) if there is one, checked against
        ctx when given; otherwise, the shape auto-sized from ctx (never
        written to disk)."""
        path = cls.pinning_path(spec, k)
        if os.path.exists(path):
            pin = Pinning.read(path)
            if ctx is not None:
                pin.check(ctx, cls.default_lookup_bits)
            return pin
        if ctx is None:
            raise FileNotFoundError(path)
        cfg = ctx.auto_config(k=k, lookup_bits=cls.default_lookup_bits)
        return Pinning(cfg, ctx.column_starts(cfg)[1])

    @classmethod
    def create_pk(cls, srs: SRS, spec, k: int, dummy_args, device=None,
                  ctx: Context | None = None) -> ProvingKey:
        """Keygen from a default witness at the pinned shape. dummy_args
        may be a zero-arg callable; ctx, a context already built from it."""
        if ctx is None:
            ctx = cls.build_context(dummy_args() if callable(dummy_args) else dummy_args,
                                    spec, device)
        cfg = cls.pinning(spec, k, ctx).config
        asg = ctx.assignment(cfg)
        return keygen(srs, cfg, asg.fixed, asg.selectors, asg.copies,
                      TorchBackend(device))

    @classmethod
    def prove(cls, pk: ProvingKey, srs: SRS, args, spec, device=None,
              ctx: Context | None = None, blinding_rng=None, timer=None) -> bytes:
        """A Blake2b-transcript proof (the reference's default). ctx: a
        context already built from args; blinding_rng and timer as in
        plonk.prover.prove."""
        if ctx is None:
            ctx = cls.build_context(args, spec, device)
        asg = ctx.assignment(pk.vk.config)
        return plonk_prove(pk, srs, asg, TorchBackend(device),
                           blinding_rng=blinding_rng, timer=timer)

    @classmethod
    def verify(cls, vk, srs: SRS, instances, proof: bytes, device=None) -> bool:
        """The host verifier (transcript, identity at x, one pairing)."""
        resolve(device)
        return plonk_verify(vk, srs, [instances], proof)
