"""Build, load and count the port's CUDA kernels.

The sources live in `spectre_tpu_torch/csrc/`: `bn254.cuh` (the shared
field and curve arithmetic), `bucket.cuh` and `ntt.cuh` (the per-block
bodies of K1 and K4) and one `.cu` file per library with a plain C
interface. At first use each library is compiled by `nvcc` for `sm_90a` into
`build/torch_kernels/` at the repository root (a directory git ignores),
every source in its own `nvcc` process, all started together, and loaded
with ctypes. The file name carries a hash of the sources, so an edited
source is never served by a stale build.

Every kernel has a `KernelInfo` in `KERNELS`; its wrapper adds one to
`launches` where it launches the kernel and nowhere else, so a run can show
which kernels its path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from dataclasses import dataclass

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build",
                         "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_VP, _LONG, _INT = ctypes.c_void_p, ctypes.c_long, ctypes.c_int

# library -> (source file, {C function: argtypes})
LIBRARIES = {
    "msm_kernels": ("msm_kernels.cu", {
        "spt_padd": [_VP, _VP, _VP, _LONG, _VP],
        "spt_k1_count": [_VP, _LONG, _LONG, _INT, _LONG, _LONG, _VP, _VP],
        "spt_k1_scatter": [_VP, _VP, _LONG, _LONG, _INT, _LONG, _LONG, _VP, _VP,
                           _VP],
        "spt_k1_walk": [_VP, _VP, _VP, _INT, _LONG, _VP, _VP, _VP],
        "spt_k1_pieces": [_VP, _INT, _VP, _VP, _VP],
    }),
    "field_kernels": ("field_kernels.cu", {
        "spt_mont_mul": [_VP, _VP, _LONG, _VP, _LONG, _INT, _VP],
        "spt_ntt_pass": [_VP, _VP, _VP, _LONG, _INT, _INT, _INT, _INT, _VP],
    }),
}
HEADERS = ("bn254.cuh", "bucket.cuh", "ntt.cuh")


@dataclass
class KernelInfo:
    name: str
    source: str       # path in the repository
    replaces: str     # the TPU kernel it replaces, or what it adds
    launches: int = 0


_MSM_CU = "spectre_tpu_torch/csrc/msm_kernels.cu"
_K1_REPLACES = "spectre_tpu/ops/msm_pallas.py:399"

# K1 is four kernels behind one wrapper (ops/msm_kernels.py bucket_sums)
KERNELS = {
    "K1a_bucket_count": KernelInfo("K1a_bucket_count", _MSM_CU, _K1_REPLACES),
    "K1b_bucket_scatter": KernelInfo("K1b_bucket_scatter", _MSM_CU, _K1_REPLACES),
    "K1c_bucket_walk": KernelInfo("K1c_bucket_walk", _MSM_CU, _K1_REPLACES),
    "K1d_bucket_pieces": KernelInfo("K1d_bucket_pieces", _MSM_CU, _K1_REPLACES),
    "K2_padd": KernelInfo(
        "K2_padd", _MSM_CU, "spectre_tpu/ops/msm_pallas.py:222"),
    "K3_mont_mul": KernelInfo(
        "K3_mont_mul", "spectre_tpu_torch/csrc/field_kernels.cu",
        "spectre_tpu/ops/field_ops.py:136 (XLA, no Pallas kernel)"),
    "K4_ntt": KernelInfo(
        "K4_ntt", "spectre_tpu_torch/csrc/field_kernels.cu",
        "spectre_tpu/ops/ntt.py:460 (XLA, no Pallas kernel)"),
}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


_loaded: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _target(name: str) -> str:
    src, _ = LIBRARIES[name]
    h = hashlib.sha256()
    for f in (*HEADERS, src):
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:12]}.so")


def build_all() -> dict:
    """Compile every library that has no current build, one nvcc process
    per source, all running at once. Returns {library: .so path}. The
    compiler's report (registers, spills: -Xptxas -v) is kept beside each
    library as `<library>.log`."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name, (src, _) in LIBRARIES.items():
        out = _target(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        log = open(os.path.join(BUILD_DIR, f"{name}.log"), "w")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", CSRC, "-o", tmp,
               os.path.join(CSRC, src)]
        procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                       tmp, out, log)
    failed = []
    for name, (proc, tmp, out, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(name)
            continue
        os.replace(tmp, out)
    if failed:
        logs = "\n".join(open(os.path.join(BUILD_DIR, f"{n}.log")).read()
                         for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return {name: _target(name) for name in LIBRARIES}


def library(name: str):
    """The loaded ctypes library `name`, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(_target(name))
        for fn, argtypes in LIBRARIES[name][1].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_launch(rc: int, kernel: str) -> None:
    """Raise on a refused or failed launch (the launcher returns
    cudaGetLastError())."""
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {rc}")


def require(t: torch.Tensor, what: str, dtype, ndim: int | None = None,
            last: int | None = None) -> None:
    """Wrapper-side input check: dtype, rank, trailing size, contiguity."""
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{what}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if last is not None and t.shape[-1] != last:
        raise ValueError(f"{what}: expected last dim {last}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous")
