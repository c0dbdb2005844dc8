"""The port's NTT modes on the CPU against the reference: SPECTRE_NTT_MODE
(radix2, fourstep) and SPECTRE_NTT_KERNEL (stages, matmul), the DFT matrix,
the budgeted table LRU, the knobs in the manifests and /metrics, and a
seeded k=7 proof under every variant, with and without the 8-bit-limb
product (SPECTRE_FIELD_IMPL=mxu), byte for byte the reference's.

Inputs are made with numpy from a seed; the port's [n, 4] int64 Montgomery
tensors are compared with the reference's [n, 16] uint32 limbs (the same
Montgomery values, radix 2^256). Every check is exact equality.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spectre_tpu.fields import bn254 as rbn
from spectre_tpu.ops import field_ops as RF, ntt as RN
from spectre_tpu_torch.ops import field_ops as F, limbs as L, msm as M, ntt as N

from _torch_k7_circuit import k7_port_key, seeded_blinding

R = rbn.R
VARIANTS = [("radix2", "stages"), ("fourstep", "stages"), ("fourstep", "matmul")]
COSET_G = 7


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads per test process: the tier-1 run has six workers
    on one machine, and timing-sensitive tests elsewhere share its cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _vals(count: int, seed: int) -> list[int]:
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2 ** 63, size=(count, 4), dtype=np.uint64)
    return [v % R for v in L.limbs_to_ints(words)]


def _message(fn) -> str:
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


def _port(vals, shape) -> torch.Tensor:
    return F.from_ints(F.fr_ctx(), vals, "cpu").reshape(shape + (4,))


def _ref(vals, shape):
    return jnp.asarray(RF.fr_ctx().encode_np(vals)).reshape(shape + (16,))


def _as16(t: torch.Tensor) -> np.ndarray:
    """The port's [..., 4] int64 as the reference's [..., 16] uint32 limbs."""
    u64 = F.tensor_to_u64(t)
    return L.u64limbs_to_u16limbs(u64.reshape(-1, 4)).reshape(u64.shape[:-1] + (16,))


FUNCS = {
    "ntt": (lambda a, w, m, k: N.ntt(a, w, mode=m, kernel=k),
            lambda a, w, m, k: RN.ntt(a, w, mode=m, kernel=k)),
    "intt": (lambda a, w, m, k: N.intt(a, w, mode=m, kernel=k),
             lambda a, w, m, k: RN.intt(a, w, mode=m, kernel=k)),
    "coset_lde": (lambda a, w, m, k: N.coset_lde(a, w, COSET_G, a.shape[-2], mode=m, kernel=k),
                  lambda a, w, m, k: RN.coset_ntt(a, w, COSET_G, mode=m, kernel=k)),
    "coset_ilde": (lambda a, w, m, k: N.coset_ilde(a, w, COSET_G, mode=m, kernel=k),
                   lambda a, w, m, k: RN.coset_intt(a, w, COSET_G, mode=m, kernel=k)),
}


@pytest.mark.parametrize("logn", range(2, 13))
def test_variants_equal_the_reference(logn):
    """Each port variant's ntt, intt, coset_lde (at full length) and
    coset_ilde of a [2, n] batch against the reference's ntt, intt,
    coset_ntt and coset_intt. The reference runs one variant per function,
    rotating with logn up to 2^8 and its matmul form above (its own tests
    pin its variants equal; the matmul form compiles fastest)."""
    n = 1 << logn
    w = rbn.fr_root_of_unity(logn)
    vals = _vals(2 * n, logn)
    a, ra = _port(vals, (2, n)), _ref(vals, (2, n))
    for i, (name, (port_fn, ref_fn)) in enumerate(FUNCS.items()):
        rm, rk = VARIANTS[(logn + i) % len(VARIANTS)] if logn <= 8 else VARIANTS[2]
        want = np.asarray(ref_fn(ra, w, rm, rk))
        for mode, kernel in VARIANTS:
            got = port_fn(a, w, mode, kernel)
            assert np.array_equal(_as16(got), want), (name, logn, mode, kernel, rm, rk)


def test_batched_equals_single_rows():
    logn = 6
    w = rbn.fr_root_of_unity(logn)
    vals = _vals(3 << logn, 99)
    stack = _port(vals, (3, 1 << logn))
    for mode, kernel in VARIANTS:
        many = N.ntt_many(stack, w, mode=mode, kernel=kernel)
        inv = N.intt_many(stack, w, mode=mode, kernel=kernel)
        for i in range(3):
            assert torch.equal(many[i], N.ntt(stack[i], w, mode=mode, kernel=kernel))
            assert torch.equal(inv[i], N.intt(stack[i], w, mode=mode, kernel=kernel))


@pytest.mark.parametrize("logn", [3, 6])
def test_dft_matrix_bytes_equal_the_reference(logn):
    w = rbn.fr_root_of_unity(logn)
    want = RN._dft_matrix8(logn, w)
    got = N._dft_matrix8(logn, w)
    assert got.dtype == torch.uint8 and got.shape == want.shape
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("logn,width", [(4, 1), (5, 4), (6, 8), (6, 16)])
def test_grouped_dft_matmul_equals_the_reference(logn, width):
    """The reference's two-level split of the i1 axis at a forced small
    group width, and the port's plain version ungrouped, on three rows."""
    n = 1 << logn
    w = rbn.fr_root_of_unity(logn)
    vals = _vals(3 * n, 7 * logn + width)
    want = np.asarray(RN._ntt_dft_matmul(_ref(vals, (3, n)), logn, w, group_width=width))
    x = _port(vals, (3, n))
    tables = N.Twiddles("cpu")
    assert np.array_equal(_as16(N._ntt_dft_matmul(x, logn, w, tables, group_width=width)), want)
    assert np.array_equal(_as16(N.dft_matmul(x, tables, w)), want)
    assert N._conv_group_width(logn) == RN._conv_group_width(logn)
    with pytest.raises(ValueError, match="does not divide"):
        N.dft_matmul_plain(x, tables.dft_matrix8(logn, w), group_width=3)


@pytest.mark.parametrize("logn", [1, 5, 6, 9, 10])
def test_factored_dft_equals_the_reference(logn):
    """K8's factored algorithm (one direct pass up to 2^6, then an n2-point
    pass over the stride-n1 columns with its twiddles and an n1-point pass),
    run by its plain replica from the tables the kernel reads (the DFT
    matrices in fragment order, the four-step's twiddle matrix): equal to
    the reference's direct `_ntt_dft_matmul` and to the dense plain version
    on 1-3 rows, odd log n included. The dense version contracts the
    reference's byte matrix, which its call has just built (the port's
    equals it byte for byte: test_dft_matrix_bytes_equal_the_reference)."""
    n = 1 << logn
    w = rbn.fr_root_of_unity(logn)
    rows = 1 + logn % 3
    vals = _vals(rows * n, 31 * logn)
    want = np.asarray(RN._ntt_dft_matmul(_ref(vals, (rows, n)), logn, w))
    x = _port(vals, (rows, n))
    tables = N.Twiddles("cpu")
    got = N.dft_factored_plain(x, tables, w)
    assert np.array_equal(_as16(got), want)
    dense = torch.from_numpy(np.asarray(RN._dft_matrix8(logn, w)))
    assert torch.equal(got, N.dft_matmul_plain(x, dense))
    plan = N.dft_plan(logn)
    assert [p.logl for p in plan] == ([logn] if logn <= 6 else [logn - logn // 2, logn // 2])
    frag = tables.dft_fragments(plan[0].logl, pow(w, n >> plan[0].logl, R))
    assert frag.dtype == torch.uint8 and frag.shape == (1 << plan[0].logl,
                                                        -(-(1 << plan[0].logl) // 16), 32, 16)


def test_coset_scale_equals_the_reference():
    logn = 5
    vals = _vals(1 << logn, 5)
    for inverse in (False, True):
        want = np.asarray(RN.coset_scale(_ref(vals, (1 << logn,)), COSET_G, inverse))
        got = N.coset_scale(_port(vals, (1 << logn,)), COSET_G, inverse)
        assert np.array_equal(_as16(got), want)


class TestKnobs:
    def test_env_dispatch_and_messages(self, monkeypatch):
        for var, fn, ref_fn, good in (("SPECTRE_NTT_MODE", N.ntt_mode, RN.ntt_mode, "fourstep"),
                                      ("SPECTRE_NTT_KERNEL", N.ntt_kernel, RN.ntt_kernel,
                                       "matmul")):
            monkeypatch.delenv(var, raising=False)
            assert fn() == ref_fn()
            monkeypatch.setenv(var, good)
            assert fn() == ref_fn() == good
            monkeypatch.setenv(var, "bogus")
            assert _message(fn) == _message(ref_fn) and "bogus" in _message(fn)
        assert N.NTT_MODES == RN.NTT_MODES and N.NTT_KERNELS == RN.NTT_KERNELS

    def test_resolution_rules_equal_the_reference(self, monkeypatch):
        monkeypatch.setenv("SPECTRE_NTT_MODE", "fourstep")
        monkeypatch.setenv("SPECTRE_NTT_KERNEL", "matmul")
        for logn in range(0, 5):
            for mode in (None, *N.NTT_MODES):
                assert N._resolve_mode(mode, logn) == RN._resolve_mode(mode, logn)
        for mode in N.NTT_MODES:
            for kernel in (None, *N.NTT_KERNELS):
                assert N._resolve_kernel(kernel, mode) == RN._resolve_kernel(kernel, mode)
        for bad in (lambda: N._resolve_mode("bogus", 4), lambda: N._resolve_kernel("x", "radix2")):
            with pytest.raises(ValueError, match="unknown NTT"):
                bad()
        assert N._MATMUL_MAX_LOGN == RN._MATMUL_MAX_LOGN == 12

    def test_env_reaches_the_entry_points(self, monkeypatch):
        """mode/kernel None read the knobs per call: a fourstep-matmul call
        launches the DFT body, a radix2 call never does."""
        calls = []
        real = N.dft_matmul
        monkeypatch.setattr(N, "dft_matmul",
                            lambda x, *tab: calls.append(x.shape) or real(x, *tab))
        a = _port(_vals(16, 3), (16,))
        w = rbn.fr_root_of_unity(4)
        monkeypatch.setenv("SPECTRE_NTT_MODE", "radix2")
        want = N.ntt(a, w)
        assert calls == []
        monkeypatch.setenv("SPECTRE_NTT_MODE", "fourstep")
        monkeypatch.setenv("SPECTRE_NTT_KERNEL", "matmul")
        assert torch.equal(N.ntt(a, w), want)
        assert calls == [(4, 4, 4), (4, 4, 4)]

    def test_matmul_cap_falls_back_to_stages(self, monkeypatch):
        """Past _MATMUL_MAX_LOGN the short transform takes K4's stages; the
        routing is the contract, so recorders stand in for the transforms."""
        dft, passes = [], []
        monkeypatch.setattr(N, "dft_matmul", lambda x, *tab: dft.append(x.shape[1]) or x)
        monkeypatch.setattr(N, "ntt_passes", lambda x, tw: passes.append(x.shape[1]) or x)
        monkeypatch.setattr(N.Twiddles, "dft_matrix8", lambda self, logn, omega: None)
        monkeypatch.setattr(N.Twiddles, "twiddles", lambda self, omega, n: None)
        tables = N.Twiddles("cpu")
        x = torch.zeros((1, 1 << 12, 4), dtype=torch.int64)
        assert N._short_transform(x, 12, 5, "matmul", tables) is x
        y = torch.zeros((1, 1 << 13, 4), dtype=torch.int64)
        assert N._short_transform(y, 13, 5, "matmul", tables) is y
        assert N._short_transform(x, 12, 5, "stages", tables) is x
        assert dft == [1 << 12] and passes == [1 << 13, 1 << 12]


class TestTableLRU:
    def test_budget_eviction_and_recompute(self, monkeypatch):
        lru = M.TableLRU(1 << 20, label="test ntt table", budget_var="SPECTRE_NTT_TABLE_MB")
        monkeypatch.setattr(N, "_TABLES", lru)
        tables = N.Twiddles("cpu")
        omega = rbn.fr_root_of_unity(14)
        t1 = tables.twiddles(omega, 1 << 14)                 # 256 KiB
        assert tables.twiddles(omega, 1 << 14) is t1 and lru.hits == 1
        assert lru.stats()["bytes"] == t1.numel() * 8
        tables.powers(7, 1 << 14)                            # 512 KiB
        tables.powers(5, 1 << 14)                            # 512 KiB: evicts
        assert lru.evictions >= 1 and lru.stats()["bytes"] <= 1 << 20
        t1b = tables.twiddles(omega, 1 << 14)                # rebuilt, same values
        assert t1b is not t1 and torch.equal(t1, t1b) and lru.recomputes >= 1

    def test_oversize_table_passes_through_uncached(self, monkeypatch):
        lru = M.TableLRU(1024, label="tiny", budget_var="X")
        monkeypatch.setattr(N, "_TABLES", lru)
        tables = N.Twiddles("cpu")
        tab = tables.powers(7, 1 << 10)                      # 32 KiB > 1 KiB
        assert tab.shape == (1 << 10, 4) and lru.stats()["bytes"] == 0
        b0 = lru.builds
        assert torch.equal(tables.powers(7, 1 << 10), tab) and lru.builds == b0 + 1

    def test_budget_rule(self, monkeypatch):
        monkeypatch.setenv("SPECTRE_NTT_TABLE_MB", "3")
        assert N._table_budget_bytes() == RN._table_budget_bytes() == 3 << 20
        monkeypatch.delenv("SPECTRE_NTT_TABLE_MB")
        assert N._table_budget_bytes() == RN._table_budget_bytes() <= 1 << 30

    def test_tables_equal_their_definitions(self):
        ctx = F.fr_ctx()
        omega = rbn.fr_root_of_unity(5)
        tables = N.Twiddles("cpu")
        mat = tables.twiddle_matrix(2, 3, omega)
        assert F.to_ints(ctx, mat) == [pow(omega, jr * kc, R) for jr in range(4)
                                       for kc in range(8)]
        post = tables.ilde_post(COSET_G, 8)
        assert F.to_ints(ctx, post) == [pow(8, -1, R) * pow(COSET_G, -i, R) % R
                                        for i in range(8)]


class TestObservability:
    def test_manifest_knobs_modes_and_lru(self, monkeypatch):
        from spectre_tpu_torch.observability import manifest
        for knob in ("SPECTRE_NTT_MODE", "SPECTRE_NTT_KERNEL", "SPECTRE_NTT_TABLE_MB",
                     "SPECTRE_FIELD_IMPL"):
            assert knob in manifest.ENV_KNOBS
        monkeypatch.setenv("SPECTRE_NTT_MODE", "fourstep")
        assert manifest.resolved_modes()["ntt"] == "fourstep"
        assert manifest.env_snapshot()["SPECTRE_NTT_MODE"] == "fourstep"
        before = manifest.lru_snapshot()
        assert before["ntt"] == N.lru_stats()
        N.Twiddles("cpu").powers(11, 1 << 6)
        N.Twiddles("cpu").powers(11, 1 << 6)
        delta = manifest.lru_delta(before, manifest.lru_snapshot())
        assert delta["ntt"]["hits"] >= 1 and delta["ntt"]["entries"] >= 1
        man = manifest.build(job_id="j", method="m", lru_before=before,
                             lru_after=manifest.lru_snapshot())
        assert man["modes"]["ntt"] == "fourstep" and man["lru_delta"]["ntt"] is not None
        text = manifest.render(man)
        assert "ntt=fourstep" in text and "lru[ntt]" in text

    def test_metrics_export_the_ntt_cache(self):
        from spectre_tpu_torch.observability import prom
        assert dict(prom._lru_stats())["ntt"] == N.lru_stats()
        text = prom.render()
        assert 'spectre_table_lru_hits_total{cache="ntt"}' in text
        assert 'spectre_table_lru_budget_bytes{cache="ntt"}' in text


@pytest.mark.parametrize("mode,kernel", VARIANTS)
def test_k7_proof_bytes_under_each_variant(k7_keyed, monkeypatch, mode, kernel):
    """The port's key of the reference's k=7 circuit (made under fourstep +
    matmul), proved under each NTT variant with the CIOS product: the
    reference's proof, byte for byte (tests/test_torch_field_mxu.py proves
    a key under each variant with the 8-bit-limb product)."""
    from spectre_tpu_torch.plonk.prover import prove

    pk, srs, asg, rproof, _ = k7_keyed
    assert not F.mxu_enabled()
    monkeypatch.setenv("SPECTRE_NTT_MODE", mode)
    monkeypatch.setenv("SPECTRE_NTT_KERNEL", kernel)
    assert prove(pk, srs, asg, device="cpu", blinding_rng=seeded_blinding()) == rproof


def test_k7_reference_proof_verifies_under_the_port_key(k7_keyed):
    from spectre_tpu_torch.plonk.verifier import verify

    pk, srs, _, rproof, instances = k7_keyed
    assert verify(pk.vk, srs, instances, rproof)


@pytest.fixture(scope="module")
def k7_keyed():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SPECTRE_NTT_MODE", "fourstep")
        mp.setenv("SPECTRE_NTT_KERNEL", "matmul")
        return k7_port_key()
