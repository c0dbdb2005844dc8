#!/usr/bin/env python3
"""Time variants of the port's CUDA kernels against the sources as they are.

    python3 scripts/torch_kernel_variants.py      # on a CUDA machine

Each variant is a copy of spectre_tpu_torch/csrc with one or two lines
edited (a launch bound, the walk's segment length or staging, the portable
add, sub and mont_mul in place of the PTX carry chains) or a Python-side
constant changed (the NTT's pass plan, the
K1 plan's points per block). All copies are built at once with the flags of
ops/kernel_lib.py into build/kernel_variants/, and each variant runs in
this one process on the same inputs: K1 at n = 2^21 (random and all-equal
scalars, checked against the sources' own result after normalization), K4
at 2^23 and [16, 2^21] (checked exactly), K2 at 2^21 pairs and K3 at 2^23.
Prints the card's name and power limit, then one JSON line per variant
with CUDA-event milliseconds. Exits non-zero without CUDA.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (name, nvcc flags, [(file, old text, new text)], {python constant: value})
VARIANTS = [
    ("as built", [], [], {}),
    ("K1 walk at 4 blocks an SM", [], [(
        "msm_kernels.cu", "__launch_bounds__(spt::K1_THREADS, 3)",
        "__launch_bounds__(spt::K1_THREADS, 4)")], {}),
    ("K1 walk slots filled by plain loads", [], [
        ("bucket.cuh", "#if defined(__CUDA_ARCH__)\n  const uint32_t dst", "#if 0\n  const uint32_t dst"),
        ("bucket.cuh", "#if defined(__CUDA_ARCH__)\n  if (pending)", "#if 0\n  if (pending)")], {}),
    ("K1 walk without its tree (timing only: its sums are wrong)", [], [(
        "msm_kernels.cu",
        "    if ((t & (2 * d - 1)) == 0) spt::k1_merge(&nodes[t], &nodes[t + d], out);\n",
        "")], {}),
    ("K1 segments of 16", [], [("bucket.cuh", "K1_SEG = 32", "K1_SEG = 16")], {}),
    ("K1 segments of 64", [], [("bucket.cuh", "K1_SEG = 32", "K1_SEG = 64")], {}),
    ("K1 plan blocks of 2^16 points", [], [], {"PLAN_POINTS": 1 << 16}),
    ("no PTX carry chains", [], [
        ("bn254.cuh", f"#if defined(__CUDA_ARCH__)\n  return {fn}_dev", f"#if 0\n  return {fn}_dev")
        for fn in ("add", "sub", "mont_mul")], {}),
    ("K4 plan tmax 11, tiles 2^11", [], [], {"TMAX": 11, "TILE_LOG": 11}),
    ("K4 plan tmax 11, tiles 2^10", [], [], {"TMAX": 11, "TILE_LOG": 10}),
    ("K4 plan tmax 12, tiles 2^12", [], [], {"TMAX": 12, "TILE_LOG": 12}),
    ("K4 512 threads", [], [("field_kernels.cu", "constexpr int kThreads = 256;",
                             "constexpr int kThreads = 512;")], {}),
]


def _build(KL, root: str) -> None:
    procs = []
    for i, (_, flags, edits, _) in enumerate(VARIANTS):
        d = os.path.join(root, str(i))
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(KL.CSRC, d)
        for f, old, new in edits:
            path = os.path.join(d, f)
            text = open(path).read()
            if old not in text:
                raise RuntimeError(f"variant {i}: {old!r} not in {f}")
            with open(path, "w") as fh:
                fh.write(text.replace(old, new))
        for lib in KL.LIBRARIES:
            cmd = [KL._nvcc(), *KL.NVCC_FLAGS, *flags, "-I", d, "-o",
                   os.path.join(d, f"{lib}.so"), os.path.join(d, f"{lib}.cu")]
            log = open(os.path.join(d, f"{lib}.log"), "w")
            procs.append((subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), log, cmd))
    for proc, log, cmd in procs:
        rc = proc.wait()
        log.close()
        if rc:
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}")


def _use(KL, d: str) -> None:
    for lib, (_, fns) in KL.LIBRARIES.items():
        h = ctypes.CDLL(os.path.join(d, f"{lib}.so"))
        for fn, argtypes in fns.items():
            getattr(h, fn).argtypes = argtypes
            getattr(h, fn).restype = ctypes.c_int
        KL._loaded[lib] = h


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from spectre_tpu_torch.fields import bn254
    from spectre_tpu_torch.ops import (ec, field_ops as F, kernel_lib as KL, msm as M,
                                       msm_kernels as MK, ntt as N)
    from spectre_tpu_torch.plonk.srs import g1_powers_device

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"gpu: {smi}", flush=True)
    root = os.path.join(os.path.dirname(KL.BUILD_DIR), "kernel_variants")
    _build(KL, root)
    dev = torch.device("cuda")
    fr = F.fr_ctx()
    gen = torch.Generator(device=dev).manual_seed(1)

    def rnd(n):
        x = torch.randint(-(1 << 63), (1 << 63) - 1, (n, 4), generator=gen,
                          dtype=torch.int64, device=dev)
        x[:, 3] &= (1 << 61) - 1
        return x

    def ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    n = 1 << 21
    pts = g1_powers_device(12345, n, dev)
    c = M.default_window_pallas(n)
    negs = torch.zeros((1, n), dtype=torch.int32, device=dev)
    digits = {k: M.signed_digit_stream(sc, c, M.num_windows(c))
              for k, sc in (("random", rnd(n)), ("all-equal", rnd(1).repeat(n, 1)))}
    tables = N.Twiddles(dev)
    x23 = F.to_mont(fr, rnd(1 << 23)).reshape(1, 1 << 23, 4)
    tw23 = tables.twiddles(bn254.fr_root_of_unity(23), 1 << 23)
    xb = F.to_mont(fr, rnd(16 << 21)).reshape(16, 1 << 21, 4)
    twb = tables.twiddles(bn254.fr_root_of_unity(21), 1 << 21)
    a2, b2 = pts, torch.roll(pts, 1, 0)
    ref_k1 = {k: ec.normalize_std(MK.bucket_sums_aos32(pts, d, negs, c)) for k, d in digits.items()}
    ref_k4 = N.ntt_passes(x23, tw23)
    consts = {"PLAN_POINTS": MK, "TMAX": N, "TILE_LOG": N}
    for i, (name, _, _, pyconst) in enumerate(VARIANTS):
        _use(KL, os.path.join(root, str(i)))
        saved = {k: getattr(consts[k], k) for k in pyconst}
        for k, v in pyconst.items():
            setattr(consts[k], k, v)
        plan = N.ntt_plan
        N.ntt_plan = lambda logn, f=plan: f(logn, N.TMAX, N.TILE_LOG)
        try:
            row = {"variant": name}
            for k, d in digits.items():
                same = torch.equal(ec.normalize_std(MK.bucket_sums_aos32(pts, d, negs, c)), ref_k1[k])
                row[f"K1 {k} ms"] = ms(lambda: MK.bucket_sums_aos32(pts, d, negs, c), 3)
                row[f"K1 {k} equal"] = bool(same)
            row["K4 2^23 equal"] = bool(torch.equal(N.ntt_passes(x23, tw23), ref_k4))
            row["K4 2^23 ms"] = ms(lambda: N.ntt_passes(x23, tw23), 5)
            row["K4 16x2^21 ms"] = ms(lambda: N.ntt_passes(xb, twb), 3)
            row["K4 passes 2^23"] = N.ntt_plan(23)
            row["K2 2^21 ms"] = ms(lambda: MK.padd_aos32(a2, b2), 5)
            row["K3 2^23 ms"] = ms(lambda: F.mont_mul(fr, x23.reshape(-1, 4), ref_k4.reshape(-1, 4)), 10)
        finally:
            N.ntt_plan = plan
            for k, v in saved.items():
                setattr(consts[k], k, v)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
