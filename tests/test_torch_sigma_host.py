"""Keygen's copy-cycle merge in host C++ (`csrc/sigma_host.cpp`) against
its plain version, the Python loop of `constraint_system.sigma_merge_plain`
(the reference's `build_sigma` loop), on seeded random copy sets: the same
successor of every cell, hence the same sigma columns and vk digest. The
source is compiled here with g++ as `tests/test_torch_csrc_host.py`
compiles the CUDA bodies; one test goes through the port's own loader.
The aggregation context's copies are checked in `test_torch_aggregation.py`.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest

from spectre_tpu.plonk.constraint_system import CircuitConfig as RefConfig
from spectre_tpu_torch import convert
from spectre_tpu_torch.ops import kernel_lib as KL
from spectre_tpu_torch.plonk import constraint_system as CS


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build the host routine")
    d = tmp_path_factory.mktemp("sigma_host")
    so = d / "sigma_host.so"
    subprocess.run([cxx, *KL.CXX_FLAGS, "-o", str(so), f"{KL.CSRC}/sigma_host.cpp"],
                   check=True, timeout=300)
    h = ctypes.CDLL(str(so))
    h.spt_sigma_merge.argtypes = KL.HOST_LIBRARIES["sigma_host"][1]["spt_sigma_merge"]
    h.spt_sigma_merge.restype = ctypes.c_int
    return h


@pytest.mark.parametrize("k,pairs,seed", [(1, 3, 0), (16, 40, 1), (1000, 700, 2),
                                          (1000, 5000, 3), (200_000, 300_000, 4)])
def test_native_merge_equals_plain(lib, k, pairs, seed):
    """Random pairs over k cells: few pairs (many singletons), dense pairs
    (one giant cycle and repeated pairs), self pairs included."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, k, pairs)
    b = rng.integers(0, k, pairs)
    b[::7] = a[::7]                       # a cell copied to itself
    want = CS.sigma_merge_plain(a, b, k)
    got = CS.sigma_merge_native(a, b, k, lib=lib)
    assert np.array_equal(got, want)
    # a permutation of the cells, each cycle closed
    assert np.array_equal(np.sort(got), np.arange(k))


def test_native_merge_on_chains_and_ties(lib):
    """Chains merged in both directions and equal-size cycles (the tie
    keeps the first cell's cycle)."""
    k = 64
    a = np.concatenate([np.arange(0, 31), np.arange(32, 63)[::-1], [0, 5, 40, 63]])
    b = np.concatenate([np.arange(1, 32), np.arange(33, 64)[::-1], [32, 40, 5, 0]])
    assert np.array_equal(CS.sigma_merge_native(a, b, k, lib=lib),
                          CS.sigma_merge_plain(a, b, k))
    assert np.array_equal(CS.sigma_merge_native(a[:0], b[:0], k, lib=lib), np.arange(k))
    with pytest.raises(RuntimeError, match="failed"):
        CS.sigma_merge_native(np.array([k]), np.array([0]), k, lib=lib)


@pytest.mark.parametrize("seed", [5, 6])
def test_sigma_targets_native_equal_plain(seed):
    """sigma_targets over a circuit's global (column, row) copies, through
    the port's loader (built into build/torch_kernels/ at first use)."""
    cfg = convert.circuit_config(RefConfig(k=9, num_advice=3, num_lookup_advice=1,
                                           num_fixed=1, lookup_bits=4))
    rng = np.random.default_rng(seed)
    m = 2000
    cols = rng.integers(0, cfg.num_perm_columns, (m, 2))
    rows = rng.integers(0, cfg.usable_rows, (m, 2))
    copies = np.stack([cols[:, 0], rows[:, 0], cols[:, 1], rows[:, 1]], axis=1)
    plain = CS.sigma_targets(cfg, copies)
    native = CS.sigma_targets(cfg, copies, native=True)
    assert all(np.array_equal(p, q) for p, q in zip(plain, native))
    assert KL.host_library("sigma_host") is KL.host_library("sigma_host")
