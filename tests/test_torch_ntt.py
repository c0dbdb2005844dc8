"""The port's NTT, iNTT and coset LDE (plain K4 and K3 on the CPU) against
the reference's CpuBackend, byte for byte, at k in {6, 10}."""

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
