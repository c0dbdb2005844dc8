"""The port's mesh prove path on the CPU (spectre_tpu_torch/parallel/):
mesh shapes and plans, the sharded MSM in every mode, the batched MSM, the
sharded NTT and a whole K=6 prove on plans of repeated CPU devices, bit for
bit against the JAX package's single-device outputs (which the JAX
package's own tests pin equal to its mesh outputs), and the fixed-base
table budget per physical device.

A plan over [cpu] * 8 is the port's counterpart of the reference's eight
virtual host devices: every shard runs its own plain kernels in turn.
"""

import random

import numpy as np
import pytest
import torch

from spectre_tpu.fields import bn254 as rbn
from spectre_tpu.ops import field_ops as RF, ntt as RN
from spectre_tpu.plonk import backend as RB
from spectre_tpu.plonk.prover import prove as ref_prove
from spectre_tpu.prover_service.selfverify import _tiny_setup as ref_tiny_setup
from spectre_tpu_torch import convert
from spectre_tpu_torch.fields import bn254
from spectre_tpu_torch.ops import ec, field_ops as F, limbs as L, msm as M
from spectre_tpu_torch.parallel import (MeshShapeError, current_plan, default_mesh,
                                        make_mesh, plan_for_mesh)
from spectre_tpu_torch.parallel import sharded_msm as SM
from spectre_tpu_torch.parallel.batch_msm import batch_msm_dp
from spectre_tpu_torch.parallel.mesh import local_devices
from spectre_tpu_torch.parallel.sharded_ntt import sharded_ntt
from spectre_tpu_torch.plonk.backend import TorchBackend
from spectre_tpu_torch.plonk.keygen import keygen
from spectre_tpu_torch.plonk.prover import prove
from spectre_tpu_torch.plonk.srs import SRS
from spectre_tpu_torch.plonk.verifier import verify

CPU8 = ["cpu"] * 8
SHAPES = {"4x2": (4, 2), "2x1": (2, 1), "1x1": (1, 1)}
GATES = ("SPECTRE_SHARD_MSM_MIN_LOGN", "SPECTRE_SHARD_NTT_MIN_LOGN",
         "SPECTRE_SHARD_QUOTIENT_MIN_LOGN")


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


def _rng(seed: int):
    r = random.Random(seed)
    return lambda: r.randrange(rbn.R)


# -- mesh shapes and plans (the cases of tests/test_mesh_plan.py) ---------------

class TestMeshShapeKnob:
    def test_default_is_full_mesh(self, monkeypatch):
        monkeypatch.delenv("SPECTRE_MESH_SHAPE", raising=False)
        assert default_mesh(CPU8).shape == {"data": 4, "win": 2}

    def test_explicit_shape(self, monkeypatch):
        monkeypatch.setenv("SPECTRE_MESH_SHAPE", "2x1")
        assert default_mesh(CPU8).shape == {"data": 2, "win": 1}

    def test_bare_int_means_data_axis(self, monkeypatch):
        monkeypatch.setenv("SPECTRE_MESH_SHAPE", "8")
        assert default_mesh(CPU8).shape == {"data": 8, "win": 1}

    def test_single_device_shape(self, monkeypatch):
        monkeypatch.setenv("SPECTRE_MESH_SHAPE", "1x1")
        assert plan_for_mesh(default_mesh(CPU8)).n_devices == 1

    def test_too_many_devices_is_typed_error(self, monkeypatch):
        monkeypatch.setenv("SPECTRE_MESH_SHAPE", "5x3")
        with pytest.raises(MeshShapeError, match="15 devices"):
            default_mesh(CPU8)

    def test_parse_garbage_is_typed_error(self, monkeypatch):
        monkeypatch.setenv("SPECTRE_MESH_SHAPE", "bogus")
        with pytest.raises(MeshShapeError):
            default_mesh(CPU8)

    def test_mesh_shape_error_is_value_error(self):
        assert issubclass(MeshShapeError, ValueError)

    def test_local_devices_of_this_box(self, monkeypatch):
        """Without a card the default device list is the CPU, one device:
        the default plan shards nothing, and a shape that needs more
        devices is refused."""
        assert local_devices("cpu") == [torch.device("cpu")]
        monkeypatch.delenv("SPECTRE_MESH_SHAPE", raising=False)
        assert current_plan(local_devices("cpu")).n_devices == 1
        assert TorchBackend("cpu").plan.n_devices == 1
        monkeypatch.setenv("SPECTRE_MESH_SHAPE", "2x1")
        with pytest.raises(MeshShapeError):
            TorchBackend("cpu").plan


    def test_backend_meshes_only_when_asked(self, monkeypatch):
        """With several devices of its kind, a backend given no plan still
        runs on its own device unless SPECTRE_MESH_SHAPE asks for a mesh."""
        from spectre_tpu_torch.plonk import backend as B
        monkeypatch.setattr(B, "local_devices", lambda kind: [torch.device(kind)] * 8)
        monkeypatch.delenv("SPECTRE_MESH_SHAPE", raising=False)
        assert TorchBackend("cpu").plan.n_devices == 1
        monkeypatch.setenv("SPECTRE_MESH_SHAPE", "4x2")
        assert TorchBackend("cpu").plan is plan_for_mesh(make_mesh(devices=CPU8, data_axis=4))


class TestPlanInterning:
    def test_same_mesh_same_plan(self):
        assert plan_for_mesh(make_mesh(devices=CPU8)) is plan_for_mesh(make_mesh(devices=CPU8))

    def test_current_plan_tracks_env(self, monkeypatch):
        monkeypatch.setenv("SPECTRE_MESH_SHAPE", "2x1")
        p2 = current_plan(CPU8)
        assert (p2.ndata, p2.nwin_shards) == (2, 1)
        monkeypatch.setenv("SPECTRE_MESH_SHAPE", "4x2")
        p8 = current_plan(CPU8)
        assert (p8.ndata, p8.nwin_shards) == (4, 2)
        assert p2 is not p8

    def test_pad_rows_and_windows(self):
        plan = _plan("4x2")
        assert plan.pad_rows(37) == 40
        assert plan.pad_rows(40) == 40
        assert plan.pad_windows(33) == 34

    def test_describe_shape(self):
        d = _plan("4x2").describe()
        assert d["n_devices"] == 8 and d["mesh"] == {"data": 4, "win": 2}

    def test_batch_mesh_is_cached_and_flat(self):
        plan = _plan("4x2")
        assert plan.batch_mesh is plan.batch_mesh
        assert plan.batch_mesh.shape == {"batch": 8}
        assert plan.physical_devices == [torch.device("cpu")]


# -- the sharded MSM ----------------------------------------------------------

def _want(logs, sc):
    """sum_i sc_i (logs_i G) by the JAX package's curve: (sum_i sc_i logs_i) G,
    one scalar multiplication (its MSM of a few hundred points takes tens
    of seconds in Python)."""
    w = rbn.g1_curve.mul(rbn.G1_GEN, sum(a * s for a, s in zip(logs, sc)) % rbn.R)
    return None if w is None else (int(w[0]), int(w[1]))


def _ref_msm(pts, sc):
    """The JAX package's single-device MSM of its CPU backend (its native
    Pippenger) on the same points and scalars, as affine ints."""
    lim = np.array([[int(p[i]) >> (64 * j) & (2 ** 64 - 1) for i in (0, 1) for j in range(4)]
                    for p in pts], dtype=np.uint64)
    got = RB.CpuBackend().msm(lim, L.ints_to_limbs(sc))
    return None if got is None else (int(got[0]), int(got[1]))


def _msm_case(n: int, seed: int):
    """n numpy-seeded points (a_i G, made by the JAX package) and scalars
    (0 and R - 1 among them) in both packages' forms, and their MSM, the
    JAX package's CPU backend's and the curve identity's in agreement."""
    rs = np.random.default_rng(seed)
    logs = [int(a) for a in rs.integers(1, 1 << 16, n)]
    pts = [rbn.g1_curve.mul(rbn.G1_GEN, a) for a in logs]
    sc = [int.from_bytes(rs.bytes(32), "little") % rbn.R for _ in range(n)]
    sc[0], sc[1] = 0, rbn.R - 1
    std = F.tensor_from_u64(L.ints_to_limbs(sc), "cpu")
    want = _ref_msm(pts, sc)
    assert want == _want(logs, sc)
    return pts, sc, ec.encode_points(pts, "cpu"), std, want, logs


_CASES: dict = {}


def _case(n: int):
    if n not in _CASES:
        _CASES[n] = _msm_case(n, n)
    return _CASES[n]


@pytest.mark.parametrize("n", [256, 253])
@pytest.mark.parametrize("mode", ["vanilla", "glv+signed", "fixed"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_sharded_msm_equals_the_reference(shape, mode, n):
    _, _, base, std, want, _ = _case(n)
    plan = _plan(shape)
    plan.reset_stats()
    degraded = M.COUNTERS["msm_fixed_degraded"]
    assert SM.sharded_msm(base, std, plan, mode=mode) == want
    assert M.COUNTERS["msm_fixed_degraded"] == degraded
    assert plan.stats()["sharded_msm"] == 1
    if plan.n_devices > 1:
        assert plan.stats()["bytes_exchanged"] > 0


@pytest.mark.slow
@pytest.mark.parametrize("n", [256, 253])
def test_sharded_msm_equals_the_jax_device_msm(n):
    """The same inputs through the JAX package's device MSM (its
    TpuBackend on the CPU, minutes of XLA compile)."""
    from spectre_tpu.native import host
    pts, sc, base, std, want, _ = _case(n)
    got = RB.TpuBackend().msm(host.points_to_limbs(pts), L.ints_to_limbs(sc))
    assert (int(got[0]), int(got[1])) == want
    assert SM.sharded_msm(base, std, _plan("4x2"), mode="glv+signed") == want


@pytest.mark.parametrize("mode", ["vanilla", "glv+signed"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_batch_msm_dp_equals_the_reference(shape, mode):
    """Five vectors of unequal length over one base: whole MSMs spread over
    the flat batch axis, no padding to the device count."""
    pts, sc, base, std, _, _ = _case(256)
    lens = [256, 40, 255, 1, 128]
    plan = _plan(shape)
    plan.reset_stats()
    got = batch_msm_dp(base, [std[:k] for k in lens], plan, mode=mode)
    assert got == [_ref_msm(pts[:k], sc[:k]) for k in lens]
    assert plan.stats()["batch_msm"] == 1


# -- the sharded NTT ----------------------------------------------------------

@pytest.mark.parametrize("logn", [8, 9])
@pytest.mark.parametrize("mode", ["radix2", "fourstep"])
def test_sharded_ntt_equals_the_reference(monkeypatch, mode, logn):
    """Forward NTTs on every plan, and the inverse with its 1/n table
    folded on the shards, against the JAX package's ops/ntt."""
    monkeypatch.setenv("SPECTRE_NTT_MODE", mode)
    r = random.Random(logn)
    vals = [r.randrange(rbn.R) for _ in range(1 << logn)]
    omega = rbn.fr_root_of_unity(logn)
    ctx = RF.fr_ctx()
    import jax.numpy as jnp
    want = np.asarray(RN.ntt(jnp.asarray(ctx.encode_np(vals)), omega))
    a = F.from_ints(F.fr_ctx(), vals, "cpu")
    for shape in SHAPES:
        plan = _plan(shape)
        got = sharded_ntt(a, omega, plan)
        assert np.array_equal(L.u64limbs_to_u16limbs(F.tensor_to_u64(got)), want), shape
    ninv = F.const(F.fr_ctx(), pow(1 << logn, -1, bn254.R), "cpu")
    back = sharded_ntt(got, pow(omega, -1, bn254.R), _plan("4x2"), post=ninv)
    assert torch.equal(back, a)


# -- a whole prove ------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    """The reference's K=6 readiness circuit, keyed and proved by the JAX
    package with seeded blinding, and keyed by the port."""
    rpk, rsrs, rasg, out = ref_tiny_setup()
    rproof = ref_prove(rpk, rsrs, rasg, RB.get_backend("cpu"), blinding_rng=_rng(0xC0FFEE))
    asg = convert.assignment(rasg)
    srs = SRS.unsafe_setup(6, device="cpu")
    pk = keygen(srs, asg.config, asg.fixed, asg.selectors, asg.copies, device="cpu")
    return pk, srs, asg, out, rproof


def test_mesh_prove_equals_the_reference_bytes(tiny, monkeypatch):
    """The gates lowered to 2^5: every commitment, NTT and the quotient of
    the K=6 prove shard over a 2x1 plan of one CPU; its bytes are the JAX
    package's under the same seeded blinding, and it verifies."""
    from spectre_tpu_torch.parallel import sharded_quotient as SQ
    pk, srs, asg, out, rproof = tiny
    for var in GATES:
        monkeypatch.setenv(var, "5")
    monkeypatch.setenv("SPECTRE_MSM_MODE", "vanilla")
    plan = _plan("2x1")
    plan.reset_stats()
    degraded = (M.COUNTERS["msm_fixed_degraded"], SQ.COUNTERS["quotient_sharded_degraded"])
    proof = prove(pk, srs, asg, TorchBackend("cpu", plan=plan), blinding_rng=_rng(0xC0FFEE))
    assert proof == rproof
    assert verify(pk.vk, srs, [[out]], proof)
    stats = plan.stats()
    for what in ("sharded_msm", "batch_msm", "sharded_ntt", "quotient"):
        assert stats[what] > 0, what
    assert degraded == (M.COUNTERS["msm_fixed_degraded"],
                        SQ.COUNTERS["quotient_sharded_degraded"])


@pytest.mark.slow
@pytest.mark.parametrize("shape", ["2x1", "4x2"])
@pytest.mark.parametrize("mode", ["glv+signed", "fixed"])
def test_mesh_prove_fixture_k13(monkeypatch, shape, mode):
    """The reference's k=13 mesh fixture: the prove on a plan equals the
    prove on one device (minutes on the CPU)."""
    from spectre_tpu_torch.test_utils import mesh_prove_fixture, seeded_blinding_rng
    srs, pk, asg = mesh_prove_fixture(device="cpu")
    one = prove(pk, srs, asg, device="cpu", blinding_rng=seeded_blinding_rng())
    monkeypatch.setenv("SPECTRE_SHARD_MSM_MIN_LOGN", "10")
    monkeypatch.setenv("SPECTRE_SHARD_NTT_MIN_LOGN", "10")
    monkeypatch.setenv("SPECTRE_MSM_MODE", mode)
    bk = TorchBackend("cpu", plan=_plan(shape))
    assert prove(pk, srs, asg, bk, blinding_rng=seeded_blinding_rng()) == one


# -- the fixed-base table budget ------------------------------------------------

class TestFixedMeshBudget:
    """The budget holds per physical device, summed over its shards."""

    def test_distinct_devices_afford_larger_tables(self, monkeypatch):
        plan = plan_for_mesh(make_mesh(devices=[torch.device("cpu"), torch.device("meta")]))
        c, nbits, n = 8, 127, 1 << 12
        total = SM._sharded_table_bytes(n, c, nbits, plan)
        monkeypatch.setattr(M.TABLES, "budget", total // 2)
        assert SM.fixed_fits_mesh(n, c, nbits, plan)
        assert not SM._degrade_fixed_mesh(n, c, nbits, plan)

    def test_four_shards_of_one_device_need_the_whole_table(self, monkeypatch):
        """Four virtual shards pass a per-shard check but need four shards'
        slices on their one device: the budget counts them summed, and a
        table that does not fit degrades visibly."""
        plan = plan_for_mesh(make_mesh(devices=["cpu"] * 4, data_axis=2))
        c, nbits, n = 8, 127, 1 << 12
        total = SM._sharded_table_bytes(n, c, nbits, plan)
        assert SM.device_table_bytes(n, c, nbits, plan) == {torch.device("cpu"): total}
        monkeypatch.setattr(M.TABLES, "budget", total // 2)
        assert not SM.fixed_fits_mesh(n, c, nbits, plan)
        before = M.COUNTERS["msm_fixed_degraded"]
        assert SM._degrade_fixed_mesh(n, c, nbits, plan)
        assert M.COUNTERS["msm_fixed_degraded"] == before + 1
        monkeypatch.setattr(M.TABLES, "budget", total)
        assert SM.fixed_fits_mesh(n, c, nbits, plan)

    def test_degraded_fixed_msm_keeps_the_point(self, monkeypatch):
        _, _, base, std, want, _ = _case(253)
        plan = _plan("2x1")
        monkeypatch.setattr(M.TABLES, "budget", 0)
        before = M.COUNTERS["msm_fixed_degraded"]
        assert SM.sharded_msm(base, std, plan, mode="fixed") == want
        assert M.COUNTERS["msm_fixed_degraded"] == before + 1
