#!/usr/bin/env python3
"""Run spectre_tpu_torch's stage-1 prove on one CUDA GPU, and hold each of
its four kernels against its plain PyTorch version.

    python3 chip_smoke.py           # the sync-step testnet shape, k = 21
    python3 chip_smoke.py --k 19    # the same columns on fewer rows

Phases, each of which ends the run with a non-zero exit code if it fails:
  device   the GPU's name and power limit (nvidia-smi)
  build    nvcc builds the kernels from spectre_tpu_torch/csrc
  K2       complete addition, 2^16 point pairs plus P+P, P+(-P), inf+P and
           inf+inf: equal limb for limb; timed at 2^21 pairs
  K3       Montgomery product at 2^23 elements: equal; timed
  K4       one NTT stage at 2^23 rows: equal; timed
  K1       bucket sums at n = 2^21, c from default_window_pallas, for
           random, all-equal and all-zero scalars: equal after affine
           normalization; timed
  msm      the full MSM at n = 2^21 against the host sum of a 2^10 prefix,
           and linear in its scalars
  devices  a K=6 circuit proved on the GPU and on the CPU gives the same bytes
  slice    SRS -> keygen -> prove -> verify at the pinned shape of
           build/sync_step_testnet_21.pinning.json with a seeded flex-gate
           witness; launch counts of every kernel on that path must be > 0

It prints one JSON line of kernel records, then the device line
{"ok": true, "device": {...}} last. It imports neither jax nor spectre_tpu.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PINNING = os.path.join(REPO, "build", "sync_step_testnet_21.pinning.json")

# H100 SXM peaks (NVIDIA data sheet): HBM3 at
# 3.35 TB/s; 67 TFLOP/s of float32 FMA outside the tensor cores, i.e. 33.5 T
# FMA/s, of which the integer pipe issues 32-bit multiply-adds at half rate.
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 16.75e12
# 32-bit multiply-adds per 256-bit Montgomery product: 64 limb products of
# a*b and 64 of m*p, each a low and a high half, plus m itself
IMAD_PER_MONT = 257
IMAD_PER_PADD = 12 * IMAD_PER_MONT


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(nbytes: float, imads: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = imads / IMAD_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def time_ms(torch, fn, reps: int = 3) -> float:
    """Mean device time of fn() over reps runs after one warm-up (CUDA
    events around the whole batch)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def limb_err(F, got, want) -> int:
    """Largest absolute difference between two results, limb by limb over
    16-bit limbs (int32 SoA limbs as they are, int64 words split)."""
    if got.dtype.itemsize == 8:
        got, want = F.split16(got), F.split16(want)
    return int((got.long() - want.long()).abs().max().item()) if got.numel() else 0


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def random_fr(torch, n: int, gen, device):
    """n random values below 2^253 < r as [n, 4] int64 standard limbs."""
    x = torch.randint(-(1 << 63), (1 << 63) - 1, (n, 4), generator=gen,
                      dtype=torch.int64, device=device)
    x[:, 3] &= (1 << 61) - 1
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, default=None,
                    help="rows 2^k of the slice (default: the pinning's k)")
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from spectre_tpu_torch.fields import bn254
    from spectre_tpu_torch.ops import (ec, field_ops as F, kernel_lib as KL,
                                       msm as M, msm_kernels as MK, ntt as N)
    from spectre_tpu_torch.plonk.backend import TorchBackend
    from spectre_tpu_torch.plonk.constraint_system import CircuitConfig
    from spectre_tpu_torch.plonk.keygen import keygen
    from spectre_tpu_torch.plonk.prover import PhaseTimer, prove
    from spectre_tpu_torch.plonk.srs import SRS, g1_powers_device
    from spectre_tpu_torch.plonk.verifier import verify
    from spectre_tpu_torch.witness import config_from_pinning, flex_circuit

    dev = torch.device("cuda")
    fr, fq = F.fr_ctx(), F.fq_ctx()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    records = {}

    # --- device ------------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"gpu: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # --- build -------------------------------------------------------------
    t0 = time.perf_counter()
    KL.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for name in KL.LIBRARIES:
        with open(os.path.join(KL.BUILD_DIR, f"{name}.log")) as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {name}: {line.strip()}")

    # test points: tau'^i G on the card
    n_pts = 1 << 21
    t0 = time.perf_counter()
    pts = g1_powers_device(random.Random(args.seed).randrange(1, bn254.R), n_pts, dev)
    torch.cuda.synchronize()
    log(f"points: {n_pts} in {time.perf_counter() - t0:.2f} s")

    # --- K2 ------------------------------------------------------------------
    m = 1 << 16
    px, py, pz = ec.aos32_coords(pts[:m])
    neg = ec.coords_to_aos32(px, F.neg(fq, py), pz)
    inf = ec.inf_aos32(m, dev)
    lhs = torch.cat([pts[:m], pts[:m], pts[:m], inf, inf])
    rhs = torch.cat([pts[m:2 * m], pts[:m], neg, pts[:m], inf])
    lhs_soa, rhs_soa = ec.aos32_to_soa16(lhs), ec.aos32_to_soa16(rhs)
    got = MK.padd_soa(lhs_soa, rhs_soa)
    want = MK.padd_soa_plain(lhs_soa, rhs_soa)
    k2_err = limb_err(F, got, want)
    require(k2_err == 0, "K2 equals its plain version limb for limb")
    sample = ec.decode_points(ec.soa16_to_aos32(got[:, [0, m, 2 * m, 3 * m, 4 * m]]))
    p0 = ec.decode_points(lhs[:1])[0]
    require(sample[1] == bn254.g1_curve.double(p0) and sample[2] is None
            and sample[3] == p0 and sample[4] is None, "K2 edge cases")
    a2, b2 = pts, torch.roll(pts, 1, 0)
    k2_ms = time_ms(torch, lambda: MK.padd_aos32(a2, b2), reps=5)
    a2s, b2s = ec.aos32_to_soa16(a2), ec.aos32_to_soa16(b2)
    k2_plain = time_ms(torch, lambda: MK.padd_soa_plain(a2s, b2s), reps=1)
    del a2s, b2s
    bm, by = bound_ms(n_pts * 3 * 96, n_pts * IMAD_PER_PADD)
    records["K2_padd"] = dict(ms=k2_ms, plain_ms=k2_plain, bound_ms=bm, bound_by=by,
                              max_abs_err=k2_err, shape=f"{n_pts} pairs")
    log(f"K2: equal on {5 * m} pairs; {n_pts} pairs {k2_ms:.3f} ms "
        f"(plain {k2_plain:.1f} ms, bound {bm:.3f} ms by {by})")

    # --- K3 ------------------------------------------------------------------
    n3 = 1 << 23
    a3 = F.to_mont(fr, random_fr(torch, n3, gen, dev))
    b3 = F.to_mont(fr, random_fr(torch, n3, gen, dev))
    k3_err = limb_err(F, F.mont_mul(fr, a3, b3), F.mont_mul_plain(fr, a3, b3))
    require(k3_err == 0, "K3 equals its plain version")
    k3_ms = time_ms(torch, lambda: F.mont_mul(fr, a3, b3), reps=10)
    k3_plain = time_ms(torch, lambda: F.mont_mul_plain(fr, a3, b3), reps=1)
    bm, by = bound_ms(n3 * 3 * 32, n3 * IMAD_PER_MONT)
    records["K3_mont_mul"] = dict(ms=k3_ms, plain_ms=k3_plain, bound_ms=bm, bound_by=by,
                                  max_abs_err=k3_err, shape=f"{n3} elements")
    log(f"K3: equal; {n3} products {k3_ms:.3f} ms (plain {k3_plain:.1f} ms, "
        f"bound {bm:.3f} ms by {by})")

    # --- K4 ------------------------------------------------------------------
    tables = N.Twiddles(dev)
    omega = bn254.fr_root_of_unity(23)
    tw = tables.twiddles(omega, n3)
    half = 1 << 11
    x4 = a3.reshape(1, n3, 4)
    y_k, y_p = x4.clone(), x4.clone()
    N.ntt_stage(y_k, tw, half, n3 // (2 * half))
    N.ntt_stage_plain(y_p, tw, half, n3 // (2 * half))
    k4_err = limb_err(F, y_k, y_p)
    require(k4_err == 0, "K4 equals its plain version")
    k4_ms = time_ms(torch, lambda: N.ntt_stage(y_k, tw, half, n3 // (2 * half)), reps=10)
    k4_plain = time_ms(torch, lambda: N.ntt_stage_plain(y_p, tw, half, n3 // (2 * half)), reps=1)
    ntt_ms = time_ms(torch, lambda: N.ntt(x4, omega, tables), reps=3)
    bm, by = bound_ms(n3 * 2 * 32 + half * 32, (n3 // 2) * IMAD_PER_MONT)
    records["K4_ntt_stage"] = dict(ms=k4_ms, plain_ms=k4_plain, bound_ms=bm, bound_by=by,
                                   max_abs_err=k4_err, shape="one stage of 2^23 rows")
    log(f"K4: equal; stage at 2^23 rows {k4_ms:.3f} ms (plain {k4_plain:.1f} ms, "
        f"bound {bm:.3f} ms by {by}); full NTT 2^23 {ntt_ms:.2f} ms")
    del a3, b3, x4, y_k, y_p

    # --- K1 ------------------------------------------------------------------
    c = M.default_window_pallas(n_pts)
    nwin, nb = M.num_windows(c), 1 << (c - 1)
    soa = ec.aos32_to_soa16(pts)
    negs = torch.zeros((1, n_pts), dtype=torch.int32, device=dev)
    one_scalar = random_fr(torch, 1, gen, dev)
    cases = {
        "random": random_fr(torch, n_pts, gen, dev),
        "all-equal": one_scalar.repeat(n_pts, 1),
        "all-zero": torch.zeros((n_pts, 4), dtype=torch.int64, device=dev),
    }
    k1 = {}
    for name, sc in cases.items():
        digits = M.signed_digit_stream(sc, c, nwin)
        got = MK.bucket_sums(soa, digits, negs, c)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = MK.bucket_sums_plain(soa, digits, negs, c)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        norm_got = ec.normalize_std(ec.soa16_to_aos32(got.permute(1, 0, 2).reshape(48, -1)))
        norm_want = ec.normalize_std(ec.soa16_to_aos32(want.permute(1, 0, 2).reshape(48, -1)))
        err = limb_err(F, norm_got.reshape(-1, 4), norm_want.reshape(-1, 4))
        require(err == 0, f"K1 ({name}) equals its plain version after normalization")
        kms = time_ms(torch, lambda: MK.bucket_sums(soa, digits, negs, c), reps=2)
        nz = int((digits != 0).sum())
        buckets = int(torch.unique(digits[digits != 0].abs().to(torch.int64)
                                   + nb * torch.nonzero(digits != 0)[:, 0]).numel()) if nz else 0
        adds = max(nz - buckets, 0)
        nbytes = 192 * n_pts + 4 * nwin * n_pts + 4 * n_pts + 4 * nwin * 48 * nb
        bm, by = bound_ms(nbytes, adds * IMAD_PER_PADD)
        k1[name] = dict(ms=kms, plain_ms=plain_ms, bound_ms=bm, bound_by=by, adds=adds,
                        max_abs_err=err, limb_equal=bool(torch.equal(got, want)))
        log(f"K1 {name}: equal after normalization; {kms:.2f} ms (plain {plain_ms:.0f} ms, "
            f"bound {bm:.3f} ms by {by}, {adds} adds), c={c} nwin={nwin}")
    records["K1_bucket_accumulate"] = dict(
        shape=f"n=2^21 c={c} nwin={nwin}", cases=k1,
        max_abs_err=max(v["max_abs_err"] for v in k1.values()),
        **{key: k1["random"][key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")})
    del cases

    # --- msm -----------------------------------------------------------------
    sc = F.to_mont(fr, random_fr(torch, n_pts, gen, dev))
    pre = torch.zeros_like(sc)
    pre[:1024] = sc[:1024]
    rest = sc.clone()
    rest[:1024] = 0
    g1 = bn254.g1_curve
    t0 = time.perf_counter()
    full = M.msm(soa, sc)
    torch.cuda.synchronize()
    msm_s = time.perf_counter() - t0
    host_pts = ec.decode_points(pts[:1024])
    host = M.host_msm(host_pts, F.to_ints(fr, sc[:1024]))
    require(M.msm(soa, pre) == host, "MSM of a 2^10 prefix equals the host sum")
    require(g1.add(M.msm(soa, pre), M.msm(soa, rest)) == full, "MSM is linear")
    log(f"msm: n=2^21 {msm_s * 1e3:.1f} ms; prefix equals host sum; linear")
    del soa, sc, pre, rest, pts

    # --- devices: one circuit, GPU and CPU, same proof bytes ------------------
    small = CircuitConfig(k=6, num_advice=2, num_lookup_advice=1, num_fixed=1,
                          lookup_bits=4, lookup_tables=("range",))
    fc = flex_circuit(small, seed=args.seed, num_copies=16)
    proofs = {}
    for d in ("cuda", "cpu"):
        s6 = SRS.unsafe_setup(6, device=d)
        pk6 = keygen(s6, small, fc.fixed, fc.selectors, fc.copies, device=d)
        r = random.Random(args.seed)
        proofs[d] = prove(pk6, s6, fc.assignment, device=d,
                          blinding_rng=lambda: r.randrange(bn254.R))
    require(proofs["cuda"] == proofs["cpu"], "GPU and CPU proofs are byte-identical")
    log("devices: K=6 proof bytes equal on cuda and cpu")

    # --- slice ---------------------------------------------------------------
    cfg = config_from_pinning(PINNING, args.k)
    log(f"slice: k={cfg.k} advice={cfg.num_advice} lookup={cfg.num_lookup_advice} "
        f"tables={cfg.lookup_tables} fixed={cfg.num_fixed} lookup_bits={cfg.lookup_bits}")
    t0 = time.perf_counter()
    fc = flex_circuit(cfg, seed=args.seed)
    log(f"  witness: {time.perf_counter() - t0:.1f} s, {len(fc.copies)} copies")
    bk = TorchBackend(dev)
    KL.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    phases = {}
    t0 = time.perf_counter()
    srs = SRS.load_or_setup(cfg.k, device=dev)
    phases["srs"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pk = keygen(srs, cfg, fc.fixed, fc.selectors, fc.copies, bk)
    torch.cuda.synchronize()
    phases["keygen"] = time.perf_counter() - t0
    timer = PhaseTimer(dev)
    r = random.Random(args.seed)
    t0 = time.perf_counter()
    proof = prove(pk, srs, fc.assignment, bk, blinding_rng=lambda: r.randrange(bn254.R),
                  timer=timer)
    phases["prove"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ok = verify(pk.vk, srs, fc.instances, proof)
    phases["verify"] = time.perf_counter() - t0
    counts = KL.launch_counts()
    require(ok, "the proof verifies")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  phases (s): " + json.dumps({k: round(v, 3) for k, v in phases.items()}))
    log(f"  prove phases (s): " + json.dumps({k: round(v, 3) for k, v in timer.seconds.items()}))
    log(f"  proof {len(proof)} bytes, verified; peak device memory {peak:.1f} GiB")
    log(f"  launches: {json.dumps(counts)}")
    for name, cnt in counts.items():
        require(cnt > 0, f"{name} launched on the slice's path")

    kernels = []
    for name, info in KL.KERNELS.items():
        rec = records[name]
        kernels.append({
            "name": name, "route": "cuda", "source": info.source,
            "replaces": info.replaces, "launches": counts[name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None, "shape": rec["shape"],
            **({"cases": rec["cases"]} if "cases" in rec else {})})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
