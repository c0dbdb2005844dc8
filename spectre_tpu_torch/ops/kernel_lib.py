"""Build, load and count the port's CUDA kernels.

The sources live in `spectre_tpu_torch/csrc/`: `bn254.cuh` (the shared
field and curve arithmetic), `bucket.cuh`, `aggregate.cuh` and `ntt.cuh`
(the per-block bodies of K1, K2b and K4), `field384.cuh` (BLS12-381 Fq and
K6's lane-group body) and one `.cu` file per library with a plain C
interface (K7 and K8, the tensor-core product and DFT, each in its own).
At first use each library is compiled by `nvcc` for `sm_90a` into
`build/torch_kernels/` at the repository root (a directory git ignores),
every source in its own `nvcc` process, all started together, and loaded
with ctypes. The file name carries a hash of the sources, so an edited
source is never served by a stale build.

Host routines that keygen needs in native code (`sigma_host.cpp`, the copy
permutation's cycle merge) are built the same way by the host C++ compiler
(`host_library`); they run on the CPU and are not kernels.

Every kernel has a `KernelInfo` in `KERNELS`; its wrapper adds one to
`launches` where it launches the kernel and nowhere else, so a run can show
which kernels its path went through. Every library this process builds is
reported to the callbacks in `BUILD_OBSERVERS` (`observability/compilelog`
registers one), so a service can show that a prove built nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
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
        "spt_k2b_aggregate": [_VP, _LONG, _INT, _VP, _VP, _VP, _VP],
        "spt_k1_count": [_VP, _LONG, _LONG, _INT, _LONG, _LONG, _VP, _VP],
        "spt_k1_scatter": [_VP, _VP, _LONG, _LONG, _INT, _LONG, _LONG, _VP, _VP,
                           _INT, _VP],
        "spt_k1_walk": [_VP, _VP, _VP, _INT, _LONG, _VP, _VP, _VP],
        "spt_k1_fixed_walk": [_VP, _VP, _VP, _INT, _LONG, _VP, _VP, _VP],
        "spt_k1_pieces": [_VP, _INT, _VP, _VP, _VP],
    }),
    "field_kernels": ("field_kernels.cu", {
        "spt_mont_mul": [_VP, _VP, _LONG, _VP, _LONG, _INT, _VP],
        "spt_ntt_pass": [_VP, _VP, _VP, _LONG, _INT, _INT, _INT, _INT, _VP],
    }),
    "field384_kernels": ("field384_kernels.cu", {
        "spt_g1_sqrt": [_VP, _VP, _VP, _LONG, _VP],
    }),
    "field_mxu_kernels": ("field_mxu_kernels.cu", {
        "spt_mont_mul_mxu": [_VP, _VP, _LONG, _VP, _LONG, _INT, _VP],
    }),
    "ntt_matmul_kernels": ("ntt_matmul_kernels.cu", {
        "spt_ntt_dft_pass": [_VP, _VP, _VP, _VP, _LONG, _INT, _INT, _LONG, _LONG, _LONG,
                             _LONG, _VP],
    }),
}
HEADERS = ("aggregate.cuh", "bn254.cuh", "bucket.cuh", "field384.cuh", "ntt.cuh")

# host library -> (source file, {C function: argtypes}), built by the host
# C++ compiler
HOST_LIBRARIES = {
    "sigma_host": ("sigma_host.cpp", {
        "spt_sigma_merge": [_VP, _VP, _LONG, _LONG, _VP],
    }),
}
CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]


@dataclass
class KernelInfo:
    name: str
    source: str       # path in the repository
    replaces: str     # the TPU kernel it replaces, or what it adds
    symbol: str       # the __global__ function, as a profiler names it
    launches: int = 0


_MSM_CU = "spectre_tpu_torch/csrc/msm_kernels.cu"
_FIELD_CU = "spectre_tpu_torch/csrc/field_kernels.cu"
_K1_REPLACES = "spectre_tpu/ops/msm_pallas.py:399"

# K1 is four kernels behind one wrapper (ops/msm_kernels.py bucket_sums). Its
# fixed-base form (bucket_sums_fixed) runs K1a and K1d as they are, its own
# scatter, K1_fixed, counted apart from the shared form's K1b, and its own
# walk over the normalised table, K1c_fixed_walk, apart from K1c.
KERNELS = {k.name: k for k in (
    KernelInfo("K1a_bucket_count", _MSM_CU, _K1_REPLACES, "k1_count_kernel"),
    KernelInfo("K1b_bucket_scatter", _MSM_CU, _K1_REPLACES, "k1_scatter_kernel"),
    KernelInfo("K1_fixed", _MSM_CU,
               "spectre_tpu/ops/msm_pallas.py:399 (fixed-base form, via "
               "_bucket_fixed_jit :460)", "k1_scatter_fixed_kernel"),
    KernelInfo("K1c_bucket_walk", _MSM_CU, _K1_REPLACES, "k1_walk_kernel"),
    KernelInfo("K1c_fixed_walk", _MSM_CU,
               "spectre_tpu/ops/msm_pallas.py:399 (fixed-base form, via "
               "_bucket_fixed_jit :460)", "k1_fixed_walk_kernel"),
    KernelInfo("K1d_bucket_pieces", _MSM_CU, _K1_REPLACES, "k1_pieces_kernel"),
    KernelInfo("K2_padd", _MSM_CU, "spectre_tpu/ops/msm_pallas.py:222", "padd_kernel"),
    KernelInfo("K2b_bucket_aggregate", _MSM_CU,
               "spectre_tpu/ops/msm_pallas.py:356 (XLA over K2, no Pallas kernel of its own)",
               "k2b_aggregate_kernel"),
    KernelInfo("K3_mont_mul", _FIELD_CU,
               "spectre_tpu/ops/field_ops.py:136 (XLA, no Pallas kernel)", "mont_mul_kernel"),
    KernelInfo("K4_ntt", _FIELD_CU,
               "spectre_tpu/ops/ntt.py:460 (XLA, no Pallas kernel)", "ntt_pass_kernel"),
    KernelInfo("K6_g1_decompress", "spectre_tpu_torch/csrc/field384_kernels.cu",
               "spectre_tpu/ops/field384.py:152 _decompress_fn (XLA, no Pallas kernel)",
               "g1_sqrt_kernel"),
    KernelInfo("K7_mont_mul_mxu", "spectre_tpu_torch/csrc/field_mxu_kernels.cu",
               "spectre_tpu/ops/field_mxu.py:145 mont_mul (XLA, no Pallas kernel)",
               "mont_mul_mxu_kernel"),
    KernelInfo("K8_ntt_dft_matmul", "spectre_tpu_torch/csrc/ntt_matmul_kernels.cu",
               "spectre_tpu/ops/ntt.py:366 _ntt_dft_matmul (XLA, no Pallas kernel)",
               "dft_pass_kernel"),
)}


# callbacks (library name, seconds) called after each library this process
# builds, on the building thread
BUILD_OBSERVERS: list = []


def _built(name: str, seconds: float) -> None:
    for fn in list(BUILD_OBSERVERS):
        fn(name, seconds)


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
    t0 = time.perf_counter()
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
        _built(name, time.perf_counter() - t0)
    if failed:
        logs = "\n".join(open(os.path.join(BUILD_DIR, f"{n}.log")).read()
                         for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return {name: _target(name) for name in LIBRARIES}


def ptxas_registers(log_path: str) -> dict:
    """{mangled kernel name: registers a thread} from a library's build log
    (`-Xptxas -v`)."""
    regs, entry = {}, None
    with open(log_path) as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = m.group(1)
            m = re.search(r"Used (\d+) registers", line)
            if m and entry:
                regs[entry] = int(m.group(1))
    return regs


def sass_opcodes(so_path: str) -> dict:
    """{mangled kernel name: {opcode: count}} of a built library, read with
    `cuobjdump -sass` (NOPs left out)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", so_path], capture_output=True, text=True,
                          check=True).stdout
    out, fn = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = {}
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and fn is not None and not m.group(1).startswith("NOP"):
            op = m.group(1)
            out[fn][op] = out[fn].get(op, 0) + 1
    return out


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


def _host_target(name: str) -> str:
    src, _ = HOST_LIBRARIES[name]
    h = hashlib.sha256()
    with open(os.path.join(CSRC, src), "rb") as fh:
        h.update(fh.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:12]}.so")


def host_library(name: str):
    """The loaded ctypes host library `name`, built by the host C++
    compiler on first use (`<library>.log` keeps its report). Raises if it
    cannot be built: there is no silent fallback."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    src, fns = HOST_LIBRARIES[name]
    out = _host_target(name)
    if not os.path.exists(out):
        cxx = shutil.which("c++") or shutil.which("g++")
        if cxx is None:
            raise RuntimeError(f"no host C++ compiler: {name} cannot be built")
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        log_path = os.path.join(BUILD_DIR, f"{name}.log")
        t0 = time.perf_counter()
        with open(log_path, "w") as log:
            rc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, os.path.join(CSRC, src)],
                                stdout=log, stderr=subprocess.STDOUT).returncode
        if rc != 0:
            with open(log_path) as log:
                raise RuntimeError(f"{cxx} failed for {name}:\n{log.read()}")
        os.replace(tmp, out)
        _built(name, time.perf_counter() - t0)
    lib = ctypes.CDLL(out)
    for fn, argtypes in fns.items():
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
