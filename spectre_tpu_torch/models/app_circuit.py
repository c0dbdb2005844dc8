"""AppCircuit lifecycle: build -> pin -> keygen -> prove -> verify (the
port's copy of `spectre_tpu/models/app_circuit.py`).

The `AppCircuit` trait (`util/circuit.rs:86-239`): keygen from a default
witness at a pinned shape, proofs from the same pinning. Every entry point
takes `device` (default CUDA, which raises without a GPU unless the caller
passes "cpu"): keygen and prove run there; witness generation and the
verifier are host work.
"""

from __future__ import annotations

import dataclasses
import gc
import os

import torch

from ..builder import Context
from ..device import resolve
from ..fields import bn254
from ..plonk.backend import TorchBackend
from ..plonk.keygen import ProvingKey, keygen
from ..plonk.mock import mock_prove
from ..plonk.prover import prove as plonk_prove
from ..plonk.srs import SRS
from ..plonk.transcript import Blake2bTranscript
from ..plonk.verifier import verify as plonk_verify
from ..utils import artifacts
from ..utils.pinning import Pinning

BUILD_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "build")

# the verifying key's commitments, held as int pairs in a key file (the
# field classes are made at run time and do not pickle)
_VK_POINT_LISTS = ("selector_commits", "fixed_commits", "sigma_commits", "table_commits",
                   "sha_selector_commits")


def _vk_points(vk, conv):
    fields = {f: [conv(p) for p in getattr(vk, f)] for f in _VK_POINT_LISTS
              if getattr(vk, f) is not None}
    if vk.sha_k_commit is not None:
        fields["sha_k_commit"] = conv(vk.sha_k_commit)
    return dataclasses.replace(vk, **fields)


def _as_ints(p):
    return None if p is None else (int(p[0]), int(p[1]))


def _as_fq(p):
    return None if p is None else (bn254.Fq(p[0]), bn254.Fq(p[1]))


def vk_to_ints(vk):
    """vk with its commitments as int pairs: picklable (a key file, another
    process); vk_from_ints rebuilds it."""
    return _vk_points(vk, _as_ints)


def vk_from_ints(vk):
    return _vk_points(vk, _as_fq)


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
    def pk_path(cls, spec, k: int, directory: str | None = None) -> str:
        return os.path.join(directory or BUILD_DIR, f"{cls.name}_{spec.name}_{k}.pk")

    @classmethod
    def create_pk(cls, srs: SRS, spec, k: int, dummy_args, device=None,
                  ctx: Context | None = None, timer=None, cache: bool = False,
                  cache_dir: str | None = None) -> ProvingKey:
        """Keygen from a default witness at the pinned shape. dummy_args
        may be a zero-arg callable (evaluated only when keygen runs); ctx,
        a context already built from it; timer, as in plonk.keygen.keygen.

        cache: the reference's disk cache (`util/circuit.rs:130-136`):
        `{name}_{spec}_{k}.pk` in cache_dir (default build/) is loaded onto
        `device` when it was written under this SRS, else the key is made
        and written there. Off by default: a testnet key is gigabytes."""
        path = cls.pk_path(spec, k, cache_dir)
        if cache and os.path.exists(path):
            saved = torch.load(path, map_location=resolve(device), weights_only=False)
            if saved["srs"] == srs.digest():
                pk = saved["pk"]
                return dataclasses.replace(pk, vk=vk_from_ints(pk.vk))
        if ctx is None:
            ctx = cls.build_context(dummy_args() if callable(dummy_args) else dummy_args,
                                    spec, device)
        cfg = cls.pinning(spec, k, ctx).config
        asg = ctx.assignment(cfg)
        pk = keygen(srs, cfg, asg.fixed, asg.selectors, asg.copies,
                    TorchBackend(device), timer=timer)
        if cache:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            torch.save({"srs": srs.digest(),
                        "pk": dataclasses.replace(pk, vk=vk_to_ints(pk.vk))}, tmp)
            os.replace(tmp, path)
            artifacts._fsync_dir(os.path.dirname(path))
        return pk

    @classmethod
    def mock(cls, args, spec, k: int, device=None) -> bool:
        """Build the witness, size the shape at k and check every gate,
        copy and lookup without proving (plonk.mock.mock_prove)."""
        ctx = cls.build_context(args, spec, device)
        was_enabled = gc.isenabled()
        gc.disable()     # the same no-cycles argument as build_context
        try:
            cfg = ctx.auto_config(k=k, lookup_bits=cls.default_lookup_bits)
            return mock_prove(cfg, ctx.assignment(cfg), device=device)
        finally:
            if was_enabled:
                gc.enable()

    @classmethod
    def prove(cls, pk: ProvingKey, srs: SRS, args, spec, device=None,
              ctx: Context | None = None, blinding_rng=None, timer=None,
              transcript=None) -> bytes:
        """transcript: None = Blake2b (the reference's default); pass
        PoseidonTranscript() for snarks bound for aggregation,
        KeccakTranscript() for the EVM path. ctx: a context already built
        from args; blinding_rng and timer as in plonk.prover.prove."""
        if ctx is None:
            ctx = cls.build_context(args, spec, device)
        asg = ctx.assignment(pk.vk.config)
        return plonk_prove(pk, srs, asg, TorchBackend(device), transcript=transcript,
                           blinding_rng=blinding_rng, timer=timer)

    @classmethod
    def verify(cls, vk, srs: SRS, instances, proof: bytes, device=None,
               transcript_cls=Blake2bTranscript) -> bool:
        """The host verifier (transcript, identity at x, one pairing)."""
        resolve(device)
        return plonk_verify(vk, srs, [instances], proof, transcript_cls=transcript_cls)
