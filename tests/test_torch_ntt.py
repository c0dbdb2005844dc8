"""The port's NTT, iNTT and coset LDE (plain K4 and K3 on the CPU) against
the reference's CpuBackend, byte for byte, at k in {6, 10}; the plain
version with K4's pass structure at k in {6, 10, 13}, on a batch and at
small tile widths."""

import numpy as np
import pytest
import torch

from spectre_tpu.plonk.backend import CpuBackend
from spectre_tpu.plonk.domain import COSET_GEN as REF_COSET_GEN, Domain as RefDomain
from spectre_tpu_torch.fields import bn254
from spectre_tpu_torch.ops import field_ops as F, ntt as N
from spectre_tpu_torch.plonk.backend import TorchBackend
from spectre_tpu_torch.plonk.domain import COSET_GEN, Domain


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads per test process: the tier-1 run has six workers
    on one machine, and timing-sensitive tests elsewhere share its cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _poly(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2 ** 63, size=(n, 4), dtype=np.uint64)
    words[:, 3] &= np.uint64((1 << 61) - 1)                   # < 2^253 < r
    return words


@pytest.fixture(scope="module")
def bk():
    return TorchBackend("cpu")


@pytest.mark.parametrize("k", [6, 10])
class TestAgainstCpuBackend:
    def test_ntt_intt(self, bk, k):
        n = 1 << k
        a = _poly(n, k)
        w = bn254.fr_root_of_unity(k)
        got = F.to_std(bk.ctx, bk.ntt(bk.from_std(a), w))
        assert np.array_equal(got, CpuBackend().ntt(a, w))
        got_i = F.to_std(bk.ctx, bk.intt(bk.from_std(a), w))
        assert np.array_equal(got_i, CpuBackend().intt(a, w))

    def test_batched_equals_single(self, bk, k):
        n = 1 << k
        cols = [_poly(n, 100 + i) for i in range(3)]
        w = bn254.fr_root_of_unity(k)
        dev_cols = [bk.from_std(c) for c in cols]
        for c, m in zip(cols, bk.intt_many(dev_cols, w)):
            assert np.array_equal(F.to_std(bk.ctx, m), CpuBackend().intt(c, w))
        for c, m in zip(cols, bk.ntt_many(dev_cols, w)):
            assert np.array_equal(F.to_std(bk.ctx, m), CpuBackend().ntt(c, w))
        rdom = RefDomain(k)
        want = CpuBackend().coset_lde_many(cols, rdom.omega_ext, REF_COSET_GEN, rdom.n_ext)
        got = bk.coset_lde_many(dev_cols, rdom.omega_ext, COSET_GEN, rdom.n_ext)
        assert all(np.array_equal(F.to_std(bk.ctx, g), x) for g, x in zip(got, want))

    def test_coset_lde_and_back(self, bk, k):
        n = 1 << k
        a = _poly(n, 7 * k)
        dom, rdom = Domain(k), RefDomain(k)
        assert COSET_GEN == REF_COSET_GEN and dom.omega_ext == rdom.omega_ext
        ext = dom.coeff_to_extended(bk.from_std(a), bk)
        want = CpuBackend().coset_lde_many([a], rdom.omega_ext, REF_COSET_GEN, rdom.n_ext)[0]
        assert np.array_equal(F.to_std(bk.ctx, ext), want)
        back = F.to_std(bk.ctx, dom.extended_to_coeff(ext, bk))
        assert np.array_equal(back[:n], a) and not back[n:].any()


def test_stage_plain_in_place_matches_naive_dft():
    k = 4
    n = 1 << k
    ctx = F.fr_ctx()
    vals = [int(v) for v in np.random.default_rng(3).integers(0, 2 ** 62, n)]
    w = bn254.fr_root_of_unity(k)
    out = F.to_ints(ctx, N.ntt(F.from_ints(ctx, vals, "cpu"), w, N.Twiddles("cpu")))
    R = bn254.R
    assert out == [sum(v * pow(w, i * j, R) for j, v in enumerate(vals)) % R
                   for i in range(n)]


@pytest.mark.parametrize("k", [6, 10, 13])
def test_pass_structured_plain_against_cpu_backend(bk, k):
    """ntt_passes_plain (K4's tiles, rows, strides and twiddle indices) for
    the NTT, the iNTT and the coset LDE, against the reference; k = 13 is
    two passes with 8 and 16 columns per block, its extension two more."""
    n = 1 << k
    a = _poly(n, 11 * k)
    w = bn254.fr_root_of_unity(k)
    ctx = bk.ctx
    assert len(N.ntt_plan(k)) == (2 if k == 13 else 1)
    x = bk.from_std(a)[None]
    tw = bk.tables.twiddles(w, n)
    assert np.array_equal(F.to_std(ctx, N.ntt_passes_plain(x, tw)[0]), CpuBackend().ntt(a, w))
    winv = pow(w, -1, bn254.R)
    inv = F.mont_mul(ctx, N.ntt_passes_plain(x, bk.tables.twiddles(winv, n))[0],
                     F.const(ctx, pow(n, -1, bn254.R), "cpu"))
    assert np.array_equal(F.to_std(ctx, inv), CpuBackend().intt(a, w))
    rdom = RefDomain(k)
    ext = torch.zeros((1, rdom.n_ext, 4), dtype=torch.int64)
    ext[0, :n] = F.mont_mul(ctx, x[0], bk.tables.powers(COSET_GEN, n))
    got = N.ntt_passes_plain(ext, bk.tables.twiddles(rdom.omega_ext, rdom.n_ext))[0]
    want = CpuBackend().coset_lde_many([a], rdom.omega_ext, REF_COSET_GEN, rdom.n_ext)[0]
    assert np.array_equal(F.to_std(ctx, got), want)


def test_pass_structured_plain_batch_and_small_tiles(bk):
    """A batch of 3 at 2^9 through plans of 1, 2 and 3 passes: every plan
    gives the plain stage loop's bytes, and the batch rows the reference's."""
    k = 9
    n = 1 << k
    cols = [_poly(n, 200 + i) for i in range(3)]
    w = bn254.fr_root_of_unity(k)
    x = torch.stack([bk.from_std(c) for c in cols])
    tw = bk.tables.twiddles(w, n)
    want = N.ntt_stages_plain(x, tw, bk.tables)
    for c, row in zip(cols, want):
        assert np.array_equal(F.to_std(bk.ctx, row), CpuBackend().ntt(c, w))
    for tmax, tile_log, npass in ((11, 11, 1), (5, 6, 2), (3, 5, 3)):
        plan = N.ntt_plan(k, tmax, tile_log)
        assert len(plan) == npass
        assert torch.equal(N.ntt_passes_plain(x, tw, plan), want)
