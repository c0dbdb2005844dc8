"""The port's sharded quotient (spectre_tpu_torch/parallel/sharded_quotient.py)
on the CPU, against the JAX package's quotient on production inputs.

A K=6 gate+lookup prove of the JAX package runs once with its host
quotient hooked, so the blinds, grand products and challenges are the ones
a prover sees; its h coefficients are the oracle. The port's quotient runs
on the same inputs over 1x1, 2x1 and 4x2 plans of one CPU under both NTT
modes and must give the same u64 coefficients (the reference's identity
matrix, tests/test_quotient_sharded.py). Then the engine's rolls, its
eligibility gate, its kill switch and its visible degrades.
"""

import numpy as np
import pytest
import torch

from spectre_tpu_torch import convert
from spectre_tpu_torch.ops import field_ops as F
from spectre_tpu_torch.parallel import make_mesh, plan_for_mesh
from spectre_tpu_torch.parallel import sharded_quotient as SQ
from spectre_tpu_torch.plonk import prover as P
from spectre_tpu_torch.plonk.backend import TorchBackend
from spectre_tpu_torch.plonk.domain import Domain

SHAPES = {"1x1": (1, 1), "2x1": (2, 1), "4x2": (4, 2)}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads per test process: the tier-1 run has six workers
    on one machine, and timing-sensitive tests elsewhere share its cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _plan(shape: str):
    d, w = SHAPES[shape]
    return plan_for_mesh(make_mesh(devices=["cpu"] * (d * w), data_axis=d))


@pytest.fixture(scope="module")
def captured():
    """The JAX package's K=6 prove (n_ext = 256, Bailey 16 x 16: every plan
    of the matrix splits it) with its host quotient hooked: the quotient's
    inputs and its h coefficients."""
    import spectre_tpu.plonk.prover as RP
    from spectre_tpu.builder import RangeChip
    from spectre_tpu.builder.context import Context
    from spectre_tpu.plonk import backend as RB
    from spectre_tpu.plonk.keygen import keygen
    from spectre_tpu.plonk.srs import SRS
    from spectre_tpu.test_utils import seeded_blinding_rng

    ctx = Context()
    rng = RangeChip(lookup_bits=4)
    a, b = ctx.load_witness(5), ctx.load_witness(9)
    c = rng.gate.mul(ctx, a, b)
    rng.range_check(ctx, a, 4)
    ctx.expose_public(c)
    cfg = ctx.auto_config(k=6, lookup_bits=4)
    asg = ctx.assignment(cfg)
    srs = SRS.unsafe_setup(8)
    pk = keygen(srs, cfg, asg.fixed, asg.selectors, asg.copies, RB.CpuBackend())
    cap = {}
    orig = RP._quotient_host

    def hooked(cfg_, dom_, bk_, pk_, polys_, beta, gamma, y):
        h = orig(cfg_, dom_, bk_, pk_, polys_, beta, gamma, y)

        def fetch(key):
            kind, j = key
            if key in polys_:
                return polys_[key]
            if kind == "shk":
                return pk_.sha_k_poly
            return {"q": pk_.selector_polys, "fix": pk_.fixed_polys,
                    "sig": pk_.sigma_polys, "tab": pk_.table_polys,
                    "shq": pk_.sha_selector_polys}[kind][j]

        cap.update(cfg=cfg_, fetch=fetch, beta=beta, gamma=gamma, y=y, h=np.asarray(h))
        return h

    RP._quotient_host = hooked
    try:
        RP.prove(pk, srs, asg, RB.CpuBackend(), blinding_rng=seeded_blinding_rng())
    finally:
        RP._quotient_host = orig
    assert cap, "the prove never reached its quotient"
    return cap


def _port_quotient(cap, plan) -> np.ndarray:
    """The port's quotient of the captured inputs on a backend of `plan`:
    h as [4n, 4] u64 standard limbs."""
    cfg = convert.circuit_config(cap["cfg"])
    bk = TorchBackend("cpu", plan=plan)
    n = cfg.n

    def poly_for(key):
        arr = np.zeros((n, 4), np.uint64)
        src = np.asarray(cap["fetch"](key), dtype=np.uint64)
        arr[:src.shape[0]] = src
        return bk.from_std(arr)

    h = P._quotient(cfg, Domain(cfg.k), bk, poly_for, cap["beta"], cap["gamma"], cap["y"])
    return F.to_std(F.fr_ctx(), h)


@pytest.mark.parametrize("mode", ["radix2", "fourstep"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_identity_matrix_k6(captured, monkeypatch, shape, mode):
    monkeypatch.setenv("SPECTRE_SHARD_QUOTIENT_MIN_LOGN", "0")
    monkeypatch.setenv("SPECTRE_NTT_MODE", mode)
    plan = _plan(shape)
    plan.reset_stats()
    before = SQ.COUNTERS["quotient_sharded_degraded"]
    h = _port_quotient(captured, plan)
    assert np.array_equal(h, captured["h"]), f"h differs on {shape} / {mode}"
    assert SQ.COUNTERS["quotient_sharded_degraded"] == before
    assert plan.stats()["quotient"] == (1 if plan.n_devices > 1 else 0)


def test_mesh_quotient_frees_its_columns(captured, monkeypatch):
    """The sharded quotient drops its extended columns before the inverse
    and leaves no reference cycle holding one: with the garbage collector
    off, every column it cached is freed when it returns (on the card a
    second prove would otherwise find the first one's columns still
    there)."""
    import gc
    import weakref

    monkeypatch.setenv("SPECTRE_SHARD_QUOTIENT_MIN_LOGN", "0")
    refs, put = [], P._ExtCache.put

    def recording_put(self, key, t):
        refs.extend(weakref.ref(x) for x in t)
        return put(self, key, t)

    monkeypatch.setattr(P._ExtCache, "put", recording_put)
    gc.collect()
    gc.disable()
    try:
        h = _port_quotient(captured, _plan("2x1"))
        alive = sum(r() is not None for r in refs)
    finally:
        gc.enable()
    assert np.array_equal(h, captured["h"])
    assert refs and alive == 0


@pytest.mark.parametrize("shift", [4, 4 * 65, 0, 32, 255, 256 + 37])
def test_roll_by_any_static_shift(shift):
    """Rows 1 and 65 (4 extended steps each), and shifts that fill,
    straddle or wrap the blocks of 32 rows: equal to torch.roll, at most
    two block moves a shard."""
    m = 256
    plan = _plan("4x2")
    bk = TorchBackend("cpu", plan=plan)
    eng = SQ.MeshQuotientEngine(plan, bk, Domain(6))
    x = torch.arange(m * 4, dtype=torch.int64).reshape(m, 4)
    rolled = eng.roll(eng.shard_rows(x), shift)
    assert torch.equal(torch.cat(rolled), torch.roll(x, -shift, dims=0))


def test_roll_of_the_last_row(captured):
    cfg = convert.circuit_config(captured["cfg"])
    plan = _plan("2x1")
    eng = SQ.MeshQuotientEngine(plan, TorchBackend("cpu", plan=plan), Domain(cfg.k))
    x = torch.arange(eng.m * 4, dtype=torch.int64).reshape(eng.m, 4)
    got = torch.cat(eng.roll(eng.shard_rows(x), 4 * cfg.last_row))
    assert torch.equal(got, torch.roll(x, -4 * cfg.last_row, dims=0))


def test_eligibility_gate():
    m = 256
    assert not SQ.eligible(_plan("1x1"), m)
    assert SQ.eligible(_plan("2x1"), m) and SQ.eligible(_plan("4x2"), m)
    three = plan_for_mesh(make_mesh(devices=["cpu"] * 3, data_axis=3))
    assert not SQ.eligible(three, m)
    assert not SQ.eligible(_plan("4x2"), 8)     # Bailey 2 x 4: 8 shards do not split it


def test_gate_and_kill_switch_are_quiet(monkeypatch):
    bk = TorchBackend("cpu", plan=_plan("2x1"))
    dom = Domain(6)
    before = SQ.COUNTERS["quotient_sharded_degraded"]
    monkeypatch.delenv("SPECTRE_SHARD_QUOTIENT_MIN_LOGN", raising=False)
    assert SQ.mesh_engine(bk, dom) is None                 # 2^8 < 2^18
    monkeypatch.setenv("SPECTRE_SHARD_QUOTIENT_MIN_LOGN", "0")
    assert isinstance(SQ.mesh_engine(bk, dom), SQ.MeshQuotientEngine)
    monkeypatch.setenv("SPECTRE_QUOTIENT_SHARDED", "0")
    assert SQ.mesh_engine(bk, dom) is None
    assert SQ.mesh_engine(TorchBackend("cpu"), dom) is None
    assert SQ.COUNTERS["quotient_sharded_degraded"] == before


def test_ineligible_shape_degrades_visibly(monkeypatch):
    from spectre_tpu_torch.observability import manifest
    monkeypatch.setenv("SPECTRE_SHARD_QUOTIENT_MIN_LOGN", "0")
    three = plan_for_mesh(make_mesh(devices=["cpu"] * 3, data_axis=3))
    before = SQ.COUNTERS["quotient_sharded_degraded"]
    with manifest.collect_events() as events:
        assert SQ.mesh_engine(TorchBackend("cpu", plan=three), Domain(6)) is None
    assert SQ.COUNTERS["quotient_sharded_degraded"] == before + 1
    assert [e["kind"] for e in events] == ["quotient_sharded_degraded"]
    assert events[0]["reason"] == "ineligible_shape"


def test_mesh_failure_falls_back_visibly(captured, monkeypatch):
    """An exception inside the sharded engine: the quotient is proved on
    the backend's device, with the same coefficients, and the degrade is
    counted with its provenance event."""
    from spectre_tpu_torch.observability import manifest
    monkeypatch.setenv("SPECTRE_SHARD_QUOTIENT_MIN_LOGN", "0")

    def broken(*args, **kwargs):
        raise RuntimeError("shard lost")

    monkeypatch.setattr(SQ, "quotient", broken)
    before = SQ.COUNTERS["quotient_sharded_degraded"]
    with manifest.collect_events() as events:
        h = _port_quotient(captured, _plan("2x1"))
    assert np.array_equal(h, captured["h"])
    assert SQ.COUNTERS["quotient_sharded_degraded"] == before + 1
    assert events[0]["reason"] == "mesh_exception" and "shard lost" in events[0]["error"]
