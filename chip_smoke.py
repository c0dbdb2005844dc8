#!/usr/bin/env python3
"""Run spectre_tpu_torch's stage-1 prove on one CUDA GPU, and hold each of
its kernels against its plain PyTorch version.

    python3 chip_smoke.py           # both paths, full size
    python3 chip_smoke.py --k 19    # the flex slice on fewer rows

Phases, each of which ends the run with a non-zero exit code if it fails:
  device   the GPU's name and power limit (nvidia-smi)
  build    nvcc builds the kernels from spectre_tpu_torch/csrc; prints the
           SASS instruction count of one Montgomery product (cuobjdump on
           the probe kernel) and the registers a thread of K1c, K2 and K2b
  K2       complete addition, 2^16 point pairs plus P+P, P+(-P), inf+P and
           inf+inf: equal limb for limb; timed at 2^21 pairs
  K3       Montgomery product at 2^23 elements: equal; timed
  K4       the whole NTT (one launch per pass) at 2^23, at a [4, 2^21]
           batch and at 2^6: equal to the plain stage loop; timed at 2^23
           and at the advice commitments' batch, [16, 2^21]
  K1       bucket sums at n = 2^21, c from default_window_pallas, for
           random, all-equal and all-zero scalars: equal after affine
           normalization; the plan kernels K1a and K1b equal to their plain
           versions; the wrapper timed, and each of its four kernels under
           torch.profiler
  K2b      the weighted bucket aggregation at c from default_window_pallas
           (24 windows of 1024 buckets at n = 2^21), on random projective
           bucket sums and on K1's own output: equal limb for limb; timed
  msm      the full MSM at n = 2^21 against the host sum of a 2^10 prefix,
           and linear in its scalars
  devices  a K=6 circuit proved on the GPU and on the CPU gives the same bytes
  slice    SRS -> keygen -> prove -> verify at the pinned shape of
           build/sync_step_testnet_21.pinning.json with a seeded flex-gate
           witness; launch counts of every kernel on the prove's path
           must be > 0 (all but K2, which the prove does not launch: the
           slice runs it only to make the SRS, and not where the SRS is
           read from params/)
  committee-kernels
           K1 and K2b at n = 2^18 random scalars, K4 at [4, 2^18] and as a
           2^18 -> 2^20 coset LDE (the committee prove's geometry): equal to
           their plain versions; timed
  committee
           the CommitteeUpdateCircuit at build/committee_update_testnet_18
           .pinning.json (512 pubkeys, k=18, 2070 SHA slots): witness,
           keygen with the k=18 SRS cut from the k=21 one, prove, verify;
           the instances equal get_instances, a flipped instance fails; the
           prove's launch count of every kernel on its path must be > 0
  step     the StepCircuit at build/sync_step_testnet_21.pinning.json (512
           pubkeys, k=21, 16 advice, 3 lookup columns, lookup_bits 18):
           args, witness, Pinning.check against the tracked file, the k=21
           SRS of the slice, keygen, prove, verify; the instances equal
           get_instances, a flipped instance fails, args with a wrong
           signature fail the native pre-check; the prove's launch count of
           every kernel on its path must be > 0

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
COMMITTEE_K = 18
STEP_K = 21
# the kernels the stage-1 prove launches (K2 only makes the SRS)
PROVE_KERNELS = ("K1a_bucket_count", "K1b_bucket_scatter", "K1c_bucket_walk",
                 "K1d_bucket_pieces", "K2b_bucket_aggregate", "K3_mont_mul", "K4_ntt")

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


def ntt_bound_ms(batch: int, logn: int) -> tuple[float, str]:
    """K4's bound for a [batch, 2^logn] transform: one read and one write
    of the data plus the twiddle table, against the Montgomery products the
    kernel performs: one per radix-2 butterfly, 2^(logn-1) a stage, in every
    stage but stage 0, whose twist by one it skips (ntt.cuh)."""
    n = 1 << logn
    return bound_ms(batch * n * 2 * 32 + n // 2 * 32,
                    batch * (logn - 1) * (n // 2) * IMAD_PER_MONT)


def k2b_work(MK, nwin: int, nb: int) -> tuple[int, int]:
    """(complete adds K2b performs, its chain of dependent adds) for nwin
    windows of nb buckets (csrc/aggregate.cuh): a thread's walk of its L
    buckets, 2 (L - 1) adds, and log2 L doublings; at each tree level but
    the last 4 adds a merge (2 for W, 2 for D), 2 at the last. The chain is
    the walk, the doublings and 2 adds a level."""
    T, L = MK.aggregate_geometry(nb)
    levels = T.bit_length() - 1
    leaf = 2 * (L - 1) + (L.bit_length() - 1)
    tree = sum((T >> (k + 1)) * (4 if k + 1 < levels else 2) for k in range(levels))
    return nwin * (T * leaf + tree), leaf + 2 * levels


def k1_bounds(torch, MK, digits, bstart, n: int, nkeys: int, nblk: int) -> dict:
    """Per K1 kernel (bound ms, by, bytes, IMAD) for this run's digits:
    each input read once and each output written once; the adds are one
    per entry less one per nonempty bucket, those of the buckets that cross
    walk blocks split off to K1d."""
    nwin = digits.shape[0]
    b = bstart.to(torch.int64)
    E = int(b[-1])
    nonempty = b[1:] > b[:-1]
    first = b[:-1] // MK.K1_BLOCK_ENTRIES
    last = (b[1:] - 1) // MK.K1_BLOCK_ENTRIES
    multi = nonempty & (last > first)
    pieces = int(torch.where(multi, last - first + 1, 0).sum())
    d_adds = pieces - int(multi.sum())
    c_adds = E - int(nonempty.sum()) - d_adds
    sizes = {
        "K1a_bucket_count": (4 * nwin * n + 4 * nkeys * nblk, 0),
        "K1b_bucket_scatter": (4 * nwin * n + 4 * n + 4 * nkeys * nblk + 4 * E, 0),
        "K1c_bucket_walk": (4 * E + (96 * n if E else 0) + 4 * (nkeys + 1)
                            + 96 * int(nonempty.sum()), c_adds * IMAD_PER_PADD),
        "K1d_bucket_pieces": (96 * (pieces + nkeys) + 4 * (nkeys + 1), d_adds * IMAD_PER_PADD),
    }
    return {k: (*bound_ms(nb_, ops), nb_, ops) for k, (nb_, ops) in sizes.items()}


def normalized_buckets(ec, sums):
    """[nwin, 48, nb] bucket sums -> affine standard limbs, one row each."""
    return ec.normalize_std(ec.soa16_to_aos32(sums.permute(1, 0, 2).reshape(48, -1))).reshape(-1, 4)


def bucket_multiset_err(torch, got, want, bstart) -> int:
    """0 when every bucket holds the same entries in both sorted arrays
    (in any order), else the largest difference of the sorted (key, entry)
    codes."""
    E = int(bstart[-1])
    key = torch.bucketize(torch.arange(E, device=got.device), bstart[1:].long(), right=True)
    code = lambda e: torch.sort(key * (1 << 32) + (e[:E].long() & 0xFFFFFFFF)).values  # noqa: E731
    return int((code(got) - code(want)).abs().max()) if E else 0


def profile_kernels(torch, fn, names: dict, reps: int) -> dict:
    """Device ms per call of fn() of each kernel in names ({record:
    substring of its profiler name}), under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = {k: 0.0 for k in names}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        for k, sub in names.items():
            if sub in ev.key:
                us[k] += ev.self_device_time_total
    missing = [k for k, v in us.items() if v == 0]
    require(not missing, f"the profiler saw {missing} run")
    return {k: v / reps / 1e3 for k, v in us.items()}


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def random_fr(torch, n: int, gen, device):
    """n random values below 2^253 < r as [n, 4] int64 standard limbs."""
    x = torch.randint(-(1 << 63), (1 << 63) - 1, (n, 4), generator=gen,
                      dtype=torch.int64, device=device)
    x[:, 3] &= (1 << 61) - 1
    return x


def committee_kernels(torch, dev, gen, seed: int) -> dict:
    """K1, K2b and K4 against their plain versions at the committee prove's
    geometry (n = 2^18 commitments, the 2^18 -> 2^20 coset LDE), timed.
    Returns {kernel: record}."""
    from spectre_tpu_torch.fields import bn254
    from spectre_tpu_torch.ops import ec, field_ops as F, msm as M, msm_kernels as MK, ntt as N
    from spectre_tpu_torch.plonk.domain import COSET_GEN
    from spectre_tpu_torch.plonk.srs import g1_powers_device

    fr = F.fr_ctx()
    n = 1 << COMMITTEE_K
    out = {}
    pts = g1_powers_device(random.Random(seed + 1).randrange(1, bn254.R), n, dev)
    c = M.default_window_pallas(n)
    nwin, nb = M.num_windows(c), 1 << (c - 1)
    digits = M.signed_digit_stream(random_fr(torch, n, gen, dev), c, nwin)
    negs = torch.zeros((1, n), dtype=torch.int32, device=dev)
    soa = ec.aos32_to_soa16(pts)
    got = MK.bucket_sums(soa, digits, negs, c)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = MK.bucket_sums_plain(soa, digits, negs, c)
    torch.cuda.synchronize()
    k1_plain = (time.perf_counter() - t0) * 1e3
    err = limb_err(F, normalized_buckets(ec, got), normalized_buckets(ec, want))
    require(err == 0, "K1 equals its plain version at n = 2^18")
    _, bstart, _ = MK.bucket_plan_plain(digits, negs, c)
    bounds = k1_bounds(torch, MK, digits, bstart, n, nwin * nb, MK.plan_blocks(n)[1])
    k1_bound = bound_ms(sum(b[2] for b in bounds.values()), sum(b[3] for b in bounds.values()))
    k1_ms = time_ms(torch, lambda: MK.bucket_sums_aos32(pts, digits, negs, c), reps=5)
    out["K1"] = dict(ms=k1_ms, plain_ms=k1_plain, bound_ms=k1_bound[0], bound_by=k1_bound[1],
                     max_abs_err=err, shape=f"n=2^18 c={c} nwin={nwin}, random scalars")
    del got, want, soa

    sums = MK.bucket_sums_aos32(pts, digits, negs, c)
    err = limb_err(F, MK.aggregate_buckets_aos32(sums, nwin, nb),
                   MK.aggregate_buckets_plain(sums, nwin, nb))
    require(err == 0, "K2b equals its plain version at n = 2^18")
    need = nwin * 2 * (nb - 1)
    bm, by = bound_ms(nwin * nb * 96 + nwin * 96, need * IMAD_PER_PADD)
    out["K2b"] = dict(
        ms=time_ms(torch, lambda: MK.aggregate_buckets_aos32(sums, nwin, nb), reps=10),
        plain_ms=time_ms(torch, lambda: MK.aggregate_buckets_plain(sums, nwin, nb), reps=1),
        bound_ms=bm, bound_by=by, max_abs_err=err, shape=f"nwin={nwin} nb={nb} (c={c})")
    del sums, pts, digits

    tables = N.Twiddles(dev)
    logn = COMMITTEE_K
    x = F.to_mont(fr, random_fr(torch, 4 << logn, gen, dev)).reshape(4, 1 << logn, 4)
    tw = tables.twiddles(bn254.fr_root_of_unity(logn), 1 << logn)
    err_b = limb_err(F, N.ntt_passes(x, tw), N.ntt_stages_plain(x, tw, tables))
    require(err_b == 0, "K4 equals the plain NTT at [4, 2^18]")
    bb = ntt_bound_ms(4, logn)
    # the coset LDE of one 2^18 column onto 2^20 rows: K3 twists, K4 transforms
    coeffs = x[0]
    w_ext = bn254.fr_root_of_unity(logn + 2)
    lde = N.coset_lde(coeffs, w_ext, COSET_GEN, 4 << logn, tables)
    tw_ext = tables.twiddles(w_ext, 4 << logn)

    def lde_plain():
        padded = torch.zeros((1, 4 << logn, 4), dtype=torch.int64, device=dev)
        padded[0, :1 << logn] = F.mont_mul_plain(fr, coeffs, tables.powers(COSET_GEN, 1 << logn))
        return N.ntt_stages_plain(padded, tw_ext, tables)[0]

    err_l = limb_err(F, lde, lde_plain())
    require(err_l == 0, "the coset LDE (K3 + K4) equals its plain version at 2^18 -> 2^20")
    bl = ntt_bound_ms(1, logn + 2)
    out["K4"] = dict(
        ms=time_ms(torch, lambda: N.ntt_passes(x, tw), reps=10),
        plain_ms=time_ms(torch, lambda: N.ntt_stages_plain(x, tw, tables), reps=1),
        bound_ms=bb[0], bound_by=bb[1], max_abs_err=max(err_b, err_l),
        shape="[4, 2^18]",
        coset_lde_2e18_to_2e20=dict(
            ms=time_ms(torch, lambda: N.coset_lde(coeffs, w_ext, COSET_GEN, 4 << logn, tables),
                       reps=10),
            plain_ms=time_ms(torch, lde_plain, reps=1), bound_ms=bl[0], bound_by=bl[1]))
    log("committee-kernels: " + json.dumps(out))
    return out


def circuit_path(torch, dev, seed: int, circuit, k: int, make_args, shape,
                 describe, flip: int, check_args=None) -> dict:
    """One application circuit at its pinned testnet shape, through the
    entry points a user calls: args, witness, pinning (Pinning.check against
    the tracked file), SRS, keygen, prove, verify. shape(cfg, args) is the
    tuple the pinned shape must give, with describe as its name; flip, the
    instance flipped for the negative verify; check_args(spec), an extra
    check of the args. Returns the phase seconds, the prove's phases, peak
    memory and launch counts."""
    from spectre_tpu_torch import spec as SPEC
    from spectre_tpu_torch.fields import bn254
    from spectre_tpu_torch.ops import kernel_lib as KL
    from spectre_tpu_torch.plonk.prover import PhaseTimer
    from spectre_tpu_torch.plonk.srs import PARAMS_DIR, SRS

    spec, phases, name = SPEC.TESTNET, {}, circuit.name
    require(os.path.exists(circuit.pinning_path(spec, k)),
            f"the tracked {name} pinning file is present")
    t0 = time.perf_counter()
    args = make_args(spec)
    phases["args"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ctx = circuit.build_context(args, spec, device=dev)
    phases["witness"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cfg = circuit.pinning(spec, k, ctx).config
    phases["pinning"] = time.perf_counter() - t0
    require(shape(cfg, args), f"the pinned {name} shape ({describe})")
    log(f"{name}: {describe}, k={cfg.k} advice={cfg.num_advice} lookup={cfg.lookup_tables} "
        f"lookup_bits={cfg.lookup_bits} fixed={cfg.num_fixed} sha_slots={cfg.num_sha_slots}; "
        f"break points equal the pinning's; {json.dumps(ctx.stats())}")
    if check_args is not None:
        check_args(spec)
    cached = [j for j in range(k, 27)
              if os.path.exists(os.path.join(PARAMS_DIR, f"kzg_bn254_{j}.srs"))]
    t0 = time.perf_counter()
    srs = SRS.load_or_setup(k, device=dev)
    phases["srs"] = time.perf_counter() - t0
    log(f"  srs: k={srs.k}, " + (f"from the cached k={cached[0]} file" if cached
                                 else "set up on the card (no cached file)"))

    torch.cuda.synchronize()
    KL.reset_launch_counts()
    t0 = time.perf_counter()
    pk = circuit.create_pk(srs, spec, k, args, device=dev, ctx=ctx)
    torch.cuda.synchronize()
    phases["keygen"] = time.perf_counter() - t0
    keygen_counts = KL.launch_counts()

    timer = PhaseTimer(torch.device(dev))
    r = random.Random(seed)
    KL.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    proof = circuit.prove(pk, srs, args, spec, device=dev, ctx=ctx,
                          blinding_rng=lambda: r.randrange(bn254.R), timer=timer)
    phases["prove"] = time.perf_counter() - t0
    prove_counts = KL.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    instances = circuit.get_instances(args, spec)
    require(instances == [av.value for av in ctx.instance_cells],
            "the circuit's instances equal get_instances")
    t0 = time.perf_counter()
    ok = circuit.verify(pk.vk, srs, instances, proof, device=dev)
    phases["verify"] = time.perf_counter() - t0
    require(ok, f"the {name} proof verifies")
    flipped = list(instances)
    flipped[flip] ^= 1
    require(not circuit.verify(pk.vk, srs, flipped, proof, device=dev),
            "a flipped instance is rejected")
    for kernel in PROVE_KERNELS:
        require(prove_counts[kernel] > 0, f"{kernel} launched in the {name} prove")
    log(f"  phases (s): " + json.dumps({key: round(v, 3) for key, v in phases.items()}))
    log(f"  prove phases (s): " + json.dumps({key: round(v, 3)
                                             for key, v in timer.seconds.items()}))
    log(f"  proof {len(proof)} bytes, verified, flipped instance rejected; instances "
        f"{[hex(v) for v in instances]}; peak device memory {peak:.1f} GiB")
    log(f"  launches: keygen {json.dumps(keygen_counts)}, prove {json.dumps(prove_counts)}")
    return dict(phases=phases, prove_phases=timer.seconds, peak_gib=peak,
                keygen_launches=keygen_counts, prove_launches=prove_counts)


def committee_path(torch, dev, seed: int) -> dict:
    """The CommitteeUpdateCircuit at build/committee_update_testnet_18
    .pinning.json: 512 pubkeys, k=18, 22 advice columns, 2070 SHA slots."""
    from spectre_tpu_torch.models import CommitteeUpdateCircuit
    from spectre_tpu_torch.witness import default_committee_update_args

    return circuit_path(
        torch, dev, seed, CommitteeUpdateCircuit, COMMITTEE_K, default_committee_update_args,
        lambda cfg, a: (cfg.k, cfg.num_advice, cfg.num_sha_slots,
                        len(a.pubkeys_compressed)) == (COMMITTEE_K, 22, 2070, 512),
        "512 pubkeys, k=18, 22 advice, 2070 SHA slots", flip=0)


def step_path(torch, dev, seed: int) -> dict:
    """The StepCircuit at build/sync_step_testnet_21.pinning.json: 512
    pubkeys, k=21, 16 advice and 3 lookup columns, lookup_bits 18; args
    with a wrong signature must fail the native pre-check."""
    from spectre_tpu_torch.fields import bls12_381 as bls
    from spectre_tpu_torch.models import StepCircuit
    from spectre_tpu_torch.witness import default_sync_step_args

    def wrong_signature_refused(spec):
        bad = default_sync_step_args(spec)
        bad.signature_compressed = bls.g2_compress(bls.g2_curve.mul(bls.G2_GEN, 123))
        try:
            StepCircuit.build_context(bad, spec, device=dev)
            refused = False
        except ValueError as e:
            refused = "aggregate signature invalid" in str(e)
        require(refused, "args with a wrong signature fail the native pre-check")
        log("  a wrong signature fails the native pre-check")

    return circuit_path(
        torch, dev, seed, StepCircuit, STEP_K, default_sync_step_args,
        lambda cfg, a: (cfg.k, cfg.num_advice, cfg.num_lookup_advice, cfg.lookup_bits,
                        len(a.pubkeys_uncompressed)) == (STEP_K, 16, 3, 18, 512),
        "512 pubkeys, k=21, 16 advice, 3 lookup columns, lookup_bits 18", flip=1,
        check_args=wrong_signature_refused)


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
    # K1's four kernels and the name each has in a profiler trace
    k1_kernels = {k: v.symbol for k, v in KL.KERNELS.items() if k.startswith("K1")}
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
    sass = KL.sass_opcodes(KL._target("field_kernels"))
    probe = next(v for k, v in sass.items() if "mont_mul_probe_kernel" in k)
    regs = KL.ptxas_registers(os.path.join(KL.BUILD_DIR, "msm_kernels.log"))
    reg_of = {rec: next(v for k, v in regs.items() if KL.KERNELS[rec].symbol in k)
              for rec in ("K1c_bucket_walk", "K2_padd", "K2b_bucket_aggregate")}
    top = sorted(probe.items(), key=lambda kv: -kv[1])[:8]
    log(f"sass: one Montgomery product (probe kernel, its 16 loads and 8 stores "
        f"included) {sum(probe.values())} instructions, {dict(top)}; registers a thread "
        + json.dumps(reg_of))

    # test points: tau'^i G on the card
    n_pts = 1 << 21
    t0 = time.perf_counter()
    pts = g1_powers_device(random.Random(args.seed).randrange(1, bn254.R), n_pts, dev)
    torch.cuda.synchronize()
    log(f"points: {n_pts} in {time.perf_counter() - t0:.2f} s")

    # --- K2 ------------------------------------------------------------------
    KL.reset_launch_counts()
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
                              max_abs_err=k2_err, shape=f"{n_pts} pairs",
                              phase_launches=KL.launch_counts()["K2_padd"],
                              phase_launches_note="launches of K2's own phase; in the slice "
                                                  "K2 makes the SRS, the prove launches it 0 times")
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
    k4_err = 0
    for logn, batch in ((23, 1), (21, 4), (6, 1)):
        x4 = F.to_mont(fr, random_fr(torch, batch << logn, gen, dev)).reshape(batch, 1 << logn, 4)
        tw = tables.twiddles(bn254.fr_root_of_unity(logn), 1 << logn)
        err = limb_err(F, N.ntt_passes(x4, tw), N.ntt_stages_plain(x4, tw, tables))
        require(err == 0, f"K4 equals the plain NTT at [{batch}, 2^{logn}]")
        k4_err = max(k4_err, err)
    del x4
    x4 = a3.reshape(1, n3, 4)
    tw = tables.twiddles(bn254.fr_root_of_unity(23), n3)
    k4_ms = time_ms(torch, lambda: N.ntt_passes(x4, tw), reps=10)
    k4_plain = time_ms(torch, lambda: N.ntt_stages_plain(x4, tw, tables), reps=1)
    k4_bound = ntt_bound_ms(1, 23)
    xb = F.to_mont(fr, random_fr(torch, 16 << 21, gen, dev)).reshape(16, 1 << 21, 4)
    twb = tables.twiddles(bn254.fr_root_of_unity(21), 1 << 21)
    k4b_ms = time_ms(torch, lambda: N.ntt_passes(xb, twb), reps=5)
    k4b_bound = ntt_bound_ms(16, 21)
    del xb
    records["K4_ntt"] = dict(
        ms=k4_ms, plain_ms=k4_plain, bound_ms=k4_bound[0], bound_by=k4_bound[1],
        max_abs_err=k4_err, shape="2^23 (whole transform)",
        passes={"2^23": N.ntt_plan(23), "2^21": N.ntt_plan(21)},
        batch_16x2e21=dict(ms=k4b_ms, bound_ms=k4b_bound[0], bound_by=k4b_bound[1]))
    log(f"K4: equal at 2^23, [4, 2^21], 2^6; 2^23 {k4_ms:.3f} ms in {len(N.ntt_plan(23))} "
        f"passes (plain stage loop {k4_plain:.1f} ms, bound {k4_bound[0]:.3f} ms by "
        f"{k4_bound[1]}); [16, 2^21] {k4b_ms:.3f} ms (bound {k4b_bound[0]:.3f} ms by "
        f"{k4b_bound[1]})")
    del a3, b3, x4

    # --- K1 ------------------------------------------------------------------
    c = M.default_window_pallas(n_pts)
    nwin, nb = M.num_windows(c), 1 << (c - 1)
    nkeys = nwin * nb
    P, nblk = MK.plan_blocks(n_pts)
    soa = ec.aos32_to_soa16(pts)
    negs = torch.zeros((1, n_pts), dtype=torch.int32, device=dev)
    one_scalar = random_fr(torch, 1, gen, dev)
    cases = {
        "random": random_fr(torch, n_pts, gen, dev),
        "all-equal": one_scalar.repeat(n_pts, 1),
        "all-zero": torch.zeros((n_pts, 4), dtype=torch.int64, device=dev),
    }
    k1 = {}
    k1_errs = {name: 0 for name in k1_kernels}
    for name, sc in cases.items():
        digits = M.signed_digit_stream(sc, c, nwin)
        got = MK.bucket_sums(soa, digits, negs, c)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = MK.bucket_sums_plain(soa, digits, negs, c)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = limb_err(F, normalized_buckets(ec, got), normalized_buckets(ec, want))
        require(err == 0, f"K1 ({name}) equals its plain version after normalization")
        # the plan kernels against their plain versions
        counts, bstart, entries_plain = MK.bucket_plan_plain(digits, negs, c)
        got_counts, _, entries = MK.bucket_plan(digits, negs, c)
        e_err = bucket_multiset_err(torch, entries, entries_plain, bstart)
        require(torch.equal(got_counts, counts), f"K1a ({name}) equals its plain counts")
        require(e_err == 0, f"K1b ({name}) places each bucket's entries as the plain sort")
        k1_errs["K1c_bucket_walk"] = k1_errs["K1d_bucket_pieces"] = max(
            k1_errs["K1c_bucket_walk"], err)
        k1_errs["K1b_bucket_scatter"] = max(k1_errs["K1b_bucket_scatter"], e_err)
        wrapper_ms = time_ms(torch, lambda: MK.bucket_sums_aos32(pts, digits, negs, c), reps=3)
        sub_ms = profile_kernels(torch, lambda: MK.bucket_sums_aos32(pts, digits, negs, c),
                                 k1_kernels, reps=2)
        plain_sub = {
            "K1a_bucket_count": time_ms(torch, lambda: MK.bucket_counts_plain(digits, nb, P), reps=1),
            "K1b_bucket_scatter": time_ms(torch, lambda: MK.bucket_scatter_plain(digits, negs, nb),
                                          reps=1),
            "K1c_bucket_walk": time_ms(torch, lambda: MK.bucket_walk_plain(pts, entries_plain,
                                                                           bstart), reps=1)}
        # the plain walk sums each bucket whole: it covers K1c and K1d together,
        # and its time stands under K1c alone
        plain_sub["K1d_bucket_pieces"] = None
        bounds = k1_bounds(torch, MK, digits, bstart, n_pts, nkeys, nblk)
        total = bound_ms(sum(b[2] for b in bounds.values()), sum(b[3] for b in bounds.values()))
        if name == "random":
            k1_random_sums = MK.bucket_sums_aos32(pts, digits, negs, c)
            # the one library call of each plan kernel's function, on the
            # keys of these digits: K1a's histogram, K1b's stable sort
            w_idx, p_idx = torch.nonzero(digits, as_tuple=True)
            keys = w_idx * nb + digits[w_idx, p_idx].to(torch.int64).abs() - 1
            bins = keys * nblk + p_idx // P
            library = {
                "K1a_bucket_count": time_ms(
                    torch, lambda: torch.bincount(bins, minlength=nkeys * nblk), reps=3),
                "K1b_bucket_scatter": time_ms(
                    torch, lambda: torch.argsort(keys, stable=True), reps=3)}
            del w_idx, p_idx, keys, bins
        k1[name] = dict(ms=wrapper_ms, plain_ms=plain_ms, bound_ms=total[0], bound_by=total[1],
                        adds=int(bstart[-1]) - int((bstart[1:] > bstart[:-1]).sum()),
                        max_abs_err=err, kernels={
                            k: dict(ms=sub_ms[k], plain_ms=plain_sub[k], bound_ms=bounds[k][0],
                                    bound_by=bounds[k][1]) for k in k1_kernels})
        log(f"K1 {name}: equal after normalization; wrapper {wrapper_ms:.3f} ms (plain "
            f"{plain_ms:.0f} ms, bound {total[0]:.3f} ms by {total[1]}), c={c} nwin={nwin}; "
            + ", ".join(f"{k} {sub_ms[k]:.3f} ms (bound {bounds[k][0]:.3f})" for k in k1_kernels))
        del got, want, entries, entries_plain
    for k in k1_kernels:
        rnd = k1["random"]["kernels"][k]
        records[k] = dict(ms=rnd["ms"], plain_ms=rnd["plain_ms"], bound_ms=rnd["bound_ms"],
                          bound_by=rnd["bound_by"], max_abs_err=k1_errs[k],
                          shape=f"n=2^21 c={c} nwin={nwin}, random scalars",
                          cases={name: v["kernels"][k] for name, v in k1.items()})
    for k, call in (("K1a_bucket_count", "torch.bincount"),
                    ("K1b_bucket_scatter", "torch.argsort(stable=True)")):
        records[k]["library_ms"] = library[k]
        records[k]["library_call"] = f"{call} on the bucket keys of the random case's digits"
    records["K1d_bucket_pieces"]["plain_note"] = (
        "the plain walk covers K1c and K1d together: its time is K1c's plain_ms")
    records["K1c_bucket_walk"]["wrapper_cases"] = {
        name: {key: v[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "adds")}
        for name, v in k1.items()}
    del cases

    # --- K2b -------------------------------------------------------------------
    nrows = nwin * nb
    rnd_sums = MK.padd_aos32(pts[:nrows], pts[nrows:2 * nrows])    # Z != 1
    rnd_sums[::9] = ec.inf_aos32(1, dev)                           # empty buckets
    k2b_err = 0
    for what, sums in (("random", rnd_sums), ("K1 output", k1_random_sums)):
        err = limb_err(F, MK.aggregate_buckets_aos32(sums, nwin, nb),
                       MK.aggregate_buckets_plain(sums, nwin, nb))
        require(err == 0, f"K2b equals its plain version limb for limb ({what})")
        k2b_err = max(k2b_err, err)
    k2b_ms = time_ms(torch, lambda: MK.aggregate_buckets_aos32(rnd_sums, nwin, nb), reps=10)
    k2b_plain = time_ms(torch, lambda: MK.aggregate_buckets_plain(rnd_sums, nwin, nb), reps=1)
    # the function needs 2 (nb - 1) adds a window (running sums R += B_b,
    # T += R); the kernel's own adds and chain are reported beside the bound
    need = nwin * 2 * (nb - 1)
    adds, chain = k2b_work(MK, nwin, nb)
    bm, by = bound_ms(nrows * 96 + nwin * 96, need * IMAD_PER_PADD)
    T, L = MK.aggregate_geometry(nb)
    records["K2b_bucket_aggregate"] = dict(
        ms=k2b_ms, plain_ms=k2b_plain, bound_ms=bm, bound_by=by, max_abs_err=k2b_err,
        shape=f"nwin={nwin} nb={nb} (c={c}), {T} threads x {L} buckets a window",
        bound_adds=need, adds=adds, dependent_adds=chain)
    log(f"K2b: equal on random sums and on K1's output; {nwin} x {nb} buckets {k2b_ms:.3f} ms "
        f"(plain {k2b_plain:.1f} ms, bound {bm:.4f} ms by {by} from {need} adds; the kernel "
        f"makes {adds} adds, a chain of {chain} dependent adds)")
    del rnd_sums, k1_random_sums

    # --- msm -----------------------------------------------------------------
    sc = F.to_mont(fr, random_fr(torch, n_pts, gen, dev))
    pre = torch.zeros_like(sc)
    pre[:1024] = sc[:1024]
    rest = sc.clone()
    rest[:1024] = 0
    g1 = bn254.g1_curve
    t0 = time.perf_counter()
    full = M.msm_base(pts, sc)
    torch.cuda.synchronize()
    msm_s = time.perf_counter() - t0
    host_pts = ec.decode_points(pts[:1024])
    host = M.host_msm(host_pts, F.to_ints(fr, sc[:1024]))
    require(M.msm_base(pts, pre) == host, "MSM of a 2^10 prefix equals the host sum")
    require(g1.add(M.msm_base(pts, pre), M.msm_base(pts, rest)) == full, "MSM is linear")
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
    for name in PROVE_KERNELS:
        require(counts[name] > 0, f"{name} launched on the slice's path")
    del pk, proof, fc, srs, bk, timer
    torch.cuda.empty_cache()

    # --- committee-kernels, committee ------------------------------------------
    geometry = committee_kernels(torch, dev, gen, args.seed)
    for name, key in (("K1c_bucket_walk", "K1"), ("K2b_bucket_aggregate", "K2b"),
                      ("K4_ntt", "K4")):
        records[name]["committee_geometry"] = geometry[key]
    torch.cuda.empty_cache()
    committee = committee_path(torch, dev, args.seed)
    torch.cuda.empty_cache()
    step = step_path(torch, dev, args.seed)

    kernels = []
    for name, info in KL.KERNELS.items():
        rec = dict(records[name])
        kernels.append({
            "name": name, "route": "cuda", "source": info.source,
            "replaces": info.replaces, "launches": counts[name],
            "committee_launches": committee["prove_launches"][name],
            "committee_keygen_launches": committee["keygen_launches"][name],
            "step_launches": step["prove_launches"][name],
            "step_keygen_launches": step["keygen_launches"][name],
            **{key: rec.pop(key) for key in ("max_abs_err", "ms", "plain_ms",
                                             "bound_ms", "bound_by")},
            "library_ms": rec.pop("library_ms", None), **rec})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
