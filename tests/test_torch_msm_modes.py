"""The port's MSM modes on the CPU: SPECTRE_MSM_MODE and SPECTRE_MSM_WINDOW
as the reference reads them, the reference's window tables, the fixed-base
table cache and its visible degrade, and seeded K=6 proofs under every mode
byte-identical to the vanilla proof (which tests/test_torch_plonk.py holds
equal to the reference's). Exact comparisons throughout.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectre_tpu.ops import msm as RM, msm_pallas as MP
from spectre_tpu_torch.fields import bn254
from spectre_tpu_torch.ops import ec, field_ops as F, msm as M, msm_kernels as MK


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads per test process: the tier-1 run has six workers
    on one machine, and timing-sensitive tests elsewhere share its cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


g1 = bn254.g1_curve


def _case(n: int, seed: int):
    r = random.Random(seed)
    pts = [g1.mul(bn254.G1_GEN, r.randrange(1, bn254.R)) for _ in range(n)]
    sc = [r.randrange(bn254.R) for _ in range(n)]
    return pts, sc, ec.encode_points(pts, "cpu"), F.from_ints(F.fr_ctx(), sc, "cpu")


class TestKnobs:
    def test_mode_from_env(self, monkeypatch):
        monkeypatch.delenv("SPECTRE_MSM_MODE", raising=False)
        assert M.msm_mode() == RM.msm_mode() == "vanilla"
        for mode in M.MSM_MODES:
            monkeypatch.setenv("SPECTRE_MSM_MODE", mode)
            assert M.msm_mode() == RM.msm_mode() == mode
        monkeypatch.setenv("SPECTRE_MSM_MODE", "bogus")
        with pytest.raises(ValueError):
            M.msm_mode()
        assert M.MSM_MODES == RM.MSM_MODES

    def test_window_tables_equal_reference(self, monkeypatch):
        monkeypatch.delenv("SPECTRE_MSM_WINDOW", raising=False)
        sizes = [1 << k for k in (3, 6, 7, 10, 12, 16, 17, 18, 21, 22)]
        for n in sizes:
            for signed in (False, True):
                assert M.default_window(n, signed) == RM.default_window(n, signed)
                assert M.default_window_pallas(n, signed) == RM.default_window_pallas(n, signed)
            assert M.default_window_fixed(n) == RM.default_window_fixed(n)
        # the step's commitments: 2^21 scalars, 2^22 expanded points
        assert M.default_window_pallas(1 << 22, signed=True) == 13
        assert M.num_windows(13, 126) == 10

    @pytest.mark.parametrize("v", ["9", "", "0", "14"])
    def test_window_override(self, monkeypatch, v):
        monkeypatch.setenv("SPECTRE_MSM_WINDOW", v)
        if v in ("0", "14"):
            with pytest.raises(ValueError):
                M.window_override()
            return
        assert M.window_override() == RM.window_override()
        for n in (1 << 6, 1 << 18):
            assert M.default_window_pallas(n, True) == RM.default_window_pallas(n, True)

    def test_override_keeps_the_point(self, monkeypatch):
        pts, sc, base, s = _case(12, 1)
        monkeypatch.setenv("SPECTRE_MSM_WINDOW", "3")
        assert M.msm_base(base, s, mode="glv+signed") == g1.msm(pts, sc)


class TestFixedTable:
    def test_cache_hit_and_key_separation(self):
        M.clear_tables()
        pts, sc, base, s = _case(8, 2)
        M.msm_base(base, s, mode="fixed", base_key="modes-a")
        builds, hits = M.TABLES.builds, M.TABLES.hits
        assert M.msm_base(base, s, mode="fixed", base_key="modes-a") == g1.msm(pts, sc)
        assert (M.TABLES.builds, M.TABLES.hits) == (builds, hits + 1)
        M.msm_base(base, s, mode="fixed", base_key="modes-b")
        assert M.TABLES.builds == builds + 1
        # an unnamed base is keyed by its storage and reused while it lives
        M.msm_batch(base, [s, s], mode="fixed")
        assert (M.TABLES.builds, M.TABLES.hits) == (builds + 2, hits + 2)
        M.clear_tables()
        assert M.lru_stats()["entries"] == 0

    def test_oversize_table_passes_through(self):
        tiny = M.TableLRU(1024)
        table = torch.zeros((4, 8, 24), dtype=torch.int32)
        assert tiny.put(("k",), None, table, table.numel() * 4) is table
        assert tiny.get(("k",)) is None

    def test_eviction_by_bytes(self):
        lru = M.TableLRU(1000)
        for i in range(3):
            lru.put(i, None, torch.zeros(1), 400)
        assert lru.get(0) is None and lru.get(2) is not None
        assert lru.stats()["evictions"] == 1 and lru.stats()["bytes"] == 800

    def test_over_budget_degrades_visibly(self, monkeypatch, capsys):
        """A table over the budget by itself: the call runs glv+signed (the
        same point), the degrade counter moves, no table is built, and the
        byte count is the reference's."""
        pts, sc, base, s = _case(8, 3)
        monkeypatch.setattr(M.TABLES, "budget", 64)
        before, builds = M.COUNTERS["msm_fixed_degraded"], M.TABLES.builds
        assert M.msm_base(base, s, mode="fixed", base_key="degrade") == g1.msm(pts, sc)
        assert M.COUNTERS["msm_fixed_degraded"] == before + 1
        assert M.TABLES.builds == builds
        assert "runs glv+signed" in capsys.readouterr().err
        for n, c in ((8, 8), (1 << 21, 13), (1 << 22, 13)):
            assert M.fixed_table_bytes(n, c, 126) == RM._fixed_table_bytes(n, c, 126)
        # the step's table: 7.5 GiB by the reference's count, 3.75 GiB here
        assert M.fixed_table_bytes(1 << 21, 13, 126) == 15 << 29
        assert M.fixed_table_device_bytes(1 << 21, 13, 126) == 15 << 28

    def test_budget_rule(self, monkeypatch):
        monkeypatch.setenv("SPECTRE_MSM_TABLE_MB", "100")
        assert M.table_budget_bytes() == RM._table_budget_bytes() == 100 << 20
        monkeypatch.delenv("SPECTRE_MSM_TABLE_MB")
        assert M.table_budget_bytes() == RM._table_budget_bytes()


@pytest.fixture(scope="module")
def k6():
    """A seeded K=6 flex circuit's SRS, key and vanilla proof on the CPU."""
    from spectre_tpu_torch.plonk.constraint_system import CircuitConfig
    from spectre_tpu_torch.plonk.keygen import keygen
    from spectre_tpu_torch.plonk.srs import SRS
    from spectre_tpu_torch.witness import flex_circuit

    cfg = CircuitConfig(k=6, num_advice=2, num_lookup_advice=1, num_fixed=1,
                        lookup_bits=4, lookup_tables=("range",))
    fc = flex_circuit(cfg, seed=1, num_copies=16)
    srs = SRS.unsafe_setup(6, device="cpu")
    pk = keygen(srs, cfg, fc.fixed, fc.selectors, fc.copies, device="cpu")
    return srs, pk, fc, _prove(srs, pk, fc)


def _prove(srs, pk, fc):
    from spectre_tpu_torch.plonk.prover import prove

    r = random.Random(7)
    return prove(pk, srs, fc.assignment, device="cpu",
                 blinding_rng=lambda: r.randrange(bn254.R))


@pytest.mark.parametrize("mode", ["glv", "glv+signed", "fixed"])
def test_k6_proof_bytes_equal_vanilla(k6, monkeypatch, mode):
    from spectre_tpu_torch.plonk.verifier import verify

    srs, pk, fc, vanilla = k6
    monkeypatch.setenv("SPECTRE_MSM_MODE", mode)
    degraded = M.COUNTERS["msm_fixed_degraded"]
    proof = _prove(srs, pk, fc)
    assert proof == vanilla
    assert verify(pk.vk, srs, fc.instances, proof)
    assert M.COUNTERS["msm_fixed_degraded"] == degraded
    if mode == "fixed":
        assert M.lru_stats()["entries"] >= 1
    M.clear_tables()


@pytest.mark.slow
def test_plain_fixed_form_matches_jitted_pallas_body():
    """The reference's kernel body with a table per window (P = nwin in
    `_k_bucket_accumulate`, ~40 s of XLA compile, hence slow as the
    reference marks it) and the plain fixed form agree after
    normalization."""
    nwin, n, c = 2, 6, 3
    nb = 1 << (c - 1)
    r = random.Random(9)
    host = [[g1.mul(bn254.G1_GEN, r.randrange(1, bn254.R)) for _ in range(n)]
            for _ in range(nwin)]
    soa = torch.stack([ec.aos32_to_soa16(ec.encode_points(h, "cpu")) for h in host])
    digs = np.array([[1, -2, 0, 2, 4, -1], [3, 3, -4, 0, 1, -2]], np.int32)
    negs = np.array([[0, 1, 0, 0, 1, 1]], np.int32)
    got = MK.bucket_sums_fixed_plain(soa, torch.from_numpy(digs), torch.from_numpy(negs), c)
    buckets = jnp.broadcast_to(MP.inf_soa(1)[:, :1][None], (nwin, MP.ROWS, nb))
    want = jax.jit(MP._k_bucket_accumulate)(
        jnp.asarray(soa.numpy().astype(np.uint32)), jnp.asarray(digs),
        jnp.asarray(negs.astype(np.uint32)), buckets)
    from spectre_tpu.ops import ec as REC
    for w in range(nwin):
        want_pts = REC.decode_points(MP.from_soa(jnp.asarray(want[w])))
        got_pts = ec.decode_points(ec.soa16_to_aos32(got[w]))
        assert [None if p is None else (int(p[0]), int(p[1])) for p in got_pts] == \
            [None if p is None else (int(p[0]), int(p[1])) for p in want_pts]
