#!/usr/bin/env python3
"""Run spectre_tpu_torch's stage-1 and stage-2 proves on one CUDA GPU, and
hold each of its kernels against its plain PyTorch version.

    python3 chip_smoke.py           # every path, full size
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
  K1-fixed K1's fixed-base form at the step's geometry: 2^21 base points and
           random scalars, GLV-split on the card (2^22 expanded points, c=13,
           10 windows), the window table built by the port (K2 doublings, K3
           for phi): equal to its plain version (at full size) after affine
           normalization, its plan kernels to theirs; the wrapper, its plan
           and its walk timed beside the shared form on the same digits;
           the split's device time and launches, the table's seconds, bytes
           and launches; the cross-window K2 fold and K2b over one window of
           4096 buckets (equal to its plain version); the fixed and glv MSMs
           equal the vanilla MSM
  devices  a K=6 circuit proved on the GPU and on the CPU gives the same
           bytes, vanilla and under SPECTRE_MSM_MODE=fixed
  slice    SRS -> keygen -> prove -> verify at the pinned shape of
           build/sync_step_testnet_21.pinning.json with a seeded flex-gate
           witness; launch counts of every kernel on the prove's path
           must be > 0 (all but K2, which the prove does not launch: the
           slice runs it only to make the SRS, and not where the SRS is
           read from params/)
  committee-kernels
           K1 and K2b at n = 2^18 random scalars, K4 at [4, 2^18] and as a
           2^18 -> 2^20 coset LDE (the committee prove's geometry): equal to
           their plain versions, K1's plan kernels K1a and K1b to theirs;
           timed, each of K1's four kernels under torch.profiler
  committee
           the CommitteeUpdateCircuit at build/committee_update_testnet_18
           .pinning.json (512 pubkeys, k=18, 2070 SHA slots): witness,
           keygen with the k=18 SRS cut from the k=21 one, prove under the
           Poseidon transcript (the proof stage 2 takes), verify with it;
           the instances equal get_instances, a flipped instance fails; the
           prove's launch count of every kernel on its path must be > 0
  step     the StepCircuit at build/sync_step_testnet_21.pinning.json (512
           pubkeys, k=21, 16 advice, 3 lookup columns, lookup_bits 18):
           args, witness, Pinning.check against the tracked file, the k=21
           SRS of the slice, keygen, prove, verify; the instances equal
           get_instances, a flipped instance fails, args with a wrong
           signature fail the native pre-check; the prove's launch count of
           every kernel on its path must be > 0; then the same witness, key
           and blinding seed proved under SPECTRE_MSM_MODE=glv+signed and
           =fixed: each proof equal to the vanilla proof byte for byte and
           verified, the fixed form and K2 launched in the fixed prove, no
           fixed-base degrade
  aggregation-kernels
           the same at the outer prove's geometry: K1 and K2b at n = 2^22
           (c from default_window_pallas), K4 at [2, 2^22] and as the
           2^22 -> 2^24 coset LDE (its own pass plan and twiddle table)
  aggregation
           stage 2: AggregationArgs from the committee's Poseidon proof and
           vk; the AggregationCircuit witness (the in-circuit verifier) at
           build/aggregation_committee_update_testnet_22.pinning.json (k=22,
           16 advice, 2 lookup, lookup_bits 14), Pinning.check, its exposed
           cells equal get_instances (the 12 accumulator limbs, then the
           committee's instances); the k=22 SRS of the same tau; keygen (the
           sigma merge in host C++), the outer prove under the Keccak
           transcript, AggregationCircuit.verify with the deferred pairing,
           a flipped accumulator limb rejected; seconds, peak device and host
           memory and kernel launches of each phase. Then, recorded whichever
           way they come out and apart from the exit code: the port's
           verifiers on the tracked reference proofs
           build/committee_testnet_18_poseidon.proof and
           build/agg_committee_testnet_22_keccak.proof

It prints one JSON line of kernel records, then the device line
{"ok": true, "device": {...}} last. It imports neither jax nor spectre_tpu.
"""

from __future__ import annotations

import argparse
import contextlib
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
AGG_K = 22
# K1's shared-base form, and its fixed-base form (its own scatter, K1_fixed)
SHARED_K1 = ("K1a_bucket_count", "K1b_bucket_scatter", "K1c_bucket_walk",
             "K1d_bucket_pieces")
FIXED_K1 = ("K1a_bucket_count", "K1_fixed", "K1c_bucket_walk", "K1d_bucket_pieces")
# the kernels the stage-1 prove launches in each MSM mode: vanilla and
# glv+signed do not launch K2 (the slice runs it only to make the SRS), the
# fixed mode launches it for its window table and cross-window fold
PROVE_KERNELS = (*SHARED_K1, "K2b_bucket_aggregate", "K3_mont_mul", "K4_ntt")
MODE_KERNELS = {"vanilla": PROVE_KERNELS, "glv+signed": PROVE_KERNELS,
                "fixed": (*FIXED_K1, "K2_padd", "K2b_bucket_aggregate", "K3_mont_mul",
                          "K4_ntt")}
STEP_MODES = ("glv+signed", "fixed")

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


def k1_bounds(torch, MK, digits, bstart, n: int, nkeys: int, nblk: int,
              fixed: bool = False) -> dict:
    """Per K1 kernel (bound ms, by, bytes, IMAD) for this run's digits:
    each input read once and each output written once; the adds are one
    per entry less one per nonempty bucket, those of the buckets that cross
    walk blocks split off to K1d. The walk reads the points: the n of a
    shared base once each (96 n bytes), or, in the fixed-base form, the
    E distinct table rows its entries name (96 E bytes: each (window,
    point) has its own row)."""
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
    rows = E if fixed else (n if E else 0)
    sizes = {
        "K1a_bucket_count": (4 * nwin * n + 4 * nkeys * nblk, 0),
        "K1_fixed" if fixed else "K1b_bucket_scatter": (
            4 * nwin * n + 4 * n + 4 * nkeys * nblk + 4 * E, 0),
        "K1c_bucket_walk": (4 * E + 96 * rows + 4 * (nkeys + 1)
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
    substring of its profiler name}), under torch.profiler. The profiler
    now and then drops a kernel's events: a kernel it did not see is
    profiled again, up to three traces, before the phase fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    got = {}
    for _ in range(3):
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
        got.update({k: v / reps / 1e3 for k, v in us.items() if v and k not in got})
        if len(got) == len(names):
            return got
    require(False, f"the profiler saw {sorted(set(names) - set(got))} run")


def device_profile(torch, fn, reps: int = 2) -> tuple[float, float]:
    """(device ms, device operations) per call of fn() under torch.profiler:
    every kernel, copy and fill it puts on the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA]
    return (sum(ev.self_device_time_total for ev in evs) / reps / 1e3,
            sum(ev.count for ev in evs) / reps)


@contextlib.contextmanager
def msm_mode(mode: str):
    """SPECTRE_MSM_MODE=mode for the block's duration."""
    old = os.environ.get("SPECTRE_MSM_MODE")
    os.environ["SPECTRE_MSM_MODE"] = mode
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("SPECTRE_MSM_MODE")
        else:
            os.environ["SPECTRE_MSM_MODE"] = old


def resident(torch, top: int = 6) -> str:
    """The device memory allocated now, and the largest CUDA storages that
    live Python tensors still hold: MiB, shape, dtype and the types of the
    objects that refer to the tensor. A full collection runs first: a
    phase's objects left in reference cycles keep their device tensors
    until the cyclic GC next runs (the builders pause it while they
    build), and would count in the next phase's peak."""
    import gc
    import types
    gc.collect()
    seen, found = {}, []
    for obj in gc.get_objects():
        if isinstance(obj, torch.Tensor) and obj.device.type == "cuda":
            st = obj.untyped_storage()
            if st.data_ptr() not in seen:
                seen[st.data_ptr()] = st.nbytes()
                found.append(obj)
    found.sort(key=lambda t: -t.untyped_storage().nbytes())
    found = found[:top]
    desc = [f"{t.untyped_storage().nbytes() / 2 ** 20:.0f} MiB {tuple(t.shape)} "
            f"{str(t.dtype)[6:]} held by "
            + ",".join(sorted({type(r).__name__ for r in gc.get_referrers(t)
                               if r is not found and not isinstance(r, types.FrameType)}))
            for t in found]
    del found
    return (f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated, "
            f"{sum(seen.values()) / 2 ** 30:.2f} GiB in {len(seen)} live tensors; largest: "
            + "; ".join(desc))


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def random_fr(torch, n: int, gen, device):
    """n random values below 2^253 < r as [n, 4] int64 standard limbs."""
    x = torch.randint(-(1 << 63), (1 << 63) - 1, (n, 4), generator=gen,
                      dtype=torch.int64, device=device)
    x[:, 3] &= (1 << 61) - 1
    return x


def geometry_kernels(torch, dev, gen, seed: int, logn: int, batch: int) -> dict:
    """K1, K2b and K4 against their plain versions at one prove's geometry:
    K1 on n = 2^logn random scalars at the window that prove picks
    (default_window_pallas), its plan kernels K1a and K1b against theirs,
    each of its four kernels timed under torch.profiler; K2b on K1's
    buckets; K4 on a [batch, 2^logn] batch and as the 2^logn -> 2^(logn+2)
    coset LDE (K3 twists, K4 transforms). Returns {kernel: record}."""
    from spectre_tpu_torch.fields import bn254
    from spectre_tpu_torch.ops import (ec, field_ops as F, kernel_lib as KL, msm as M,
                                       msm_kernels as MK, ntt as N)
    from spectre_tpu_torch.plonk.domain import COSET_GEN
    from spectre_tpu_torch.plonk.srs import g1_powers_device

    fr = F.fr_ctx()
    n = 1 << logn
    out = {}
    pts = g1_powers_device(random.Random(seed + logn).randrange(1, bn254.R), n, dev)
    c = M.default_window_pallas(n)
    nwin, nb = M.num_windows(c), 1 << (c - 1)
    nblk = MK.plan_blocks(n)[1]
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
    require(err == 0, f"K1 equals its plain version at n = 2^{logn}")
    del got, want, soa
    counts, bstart, entries_plain = MK.bucket_plan_plain(digits, negs, c)
    got_counts, _, entries = MK.bucket_plan(digits, negs, c)
    require(torch.equal(got_counts, counts), f"K1a equals its plain counts at n = 2^{logn}")
    e_err = bucket_multiset_err(torch, entries, entries_plain, bstart)
    require(e_err == 0, f"K1b places each bucket's entries as the plain sort at n = 2^{logn}")
    del counts, got_counts, entries, entries_plain
    bounds = k1_bounds(torch, MK, digits, bstart, n, nwin * nb, nblk)
    k1_bound = bound_ms(sum(b[2] for b in bounds.values()), sum(b[3] for b in bounds.values()))
    k1_ms = time_ms(torch, lambda: MK.bucket_sums_aos32(pts, digits, negs, c), reps=5)
    sub_ms = profile_kernels(torch, lambda: MK.bucket_sums_aos32(pts, digits, negs, c),
                             {k: KL.KERNELS[k].symbol for k in SHARED_K1}, reps=2)
    out["K1"] = dict(ms=k1_ms, plain_ms=k1_plain, bound_ms=k1_bound[0], bound_by=k1_bound[1],
                     max_abs_err=max(err, e_err), entries=int(bstart[-1]),
                     shape=f"n=2^{logn} c={c} nwin={nwin}, random scalars",
                     kernels={k: dict(ms=sub_ms[k], bound_ms=bounds[k][0],
                                      bound_by=bounds[k][1]) for k in SHARED_K1})

    sums = MK.bucket_sums_aos32(pts, digits, negs, c)
    err = limb_err(F, MK.aggregate_buckets_aos32(sums, nwin, nb),
                   MK.aggregate_buckets_plain(sums, nwin, nb))
    require(err == 0, f"K2b equals its plain version at n = 2^{logn}")
    need = nwin * 2 * (nb - 1)
    bm, by = bound_ms(nwin * nb * 96 + nwin * 96, need * IMAD_PER_PADD)
    out["K2b"] = dict(
        ms=time_ms(torch, lambda: MK.aggregate_buckets_aos32(sums, nwin, nb), reps=10),
        plain_ms=time_ms(torch, lambda: MK.aggregate_buckets_plain(sums, nwin, nb), reps=1),
        bound_ms=bm, bound_by=by, max_abs_err=err, shape=f"nwin={nwin} nb={nb} (c={c})")
    del sums, pts, digits, negs, bstart
    torch.cuda.empty_cache()

    tables = N.Twiddles(dev)
    x = F.to_mont(fr, random_fr(torch, batch << logn, gen, dev)).reshape(batch, 1 << logn, 4)
    tw = tables.twiddles(bn254.fr_root_of_unity(logn), 1 << logn)
    err_b = limb_err(F, N.ntt_passes(x, tw), N.ntt_stages_plain(x, tw, tables))
    require(err_b == 0, f"K4 equals the plain NTT at [{batch}, 2^{logn}]")
    bb = ntt_bound_ms(batch, logn)
    coeffs = x[0]
    w_ext = bn254.fr_root_of_unity(logn + 2)
    lde = N.coset_lde(coeffs, w_ext, COSET_GEN, 4 << logn, tables)
    tw_ext = tables.twiddles(w_ext, 4 << logn)

    def lde_plain():
        padded = torch.zeros((1, 4 << logn, 4), dtype=torch.int64, device=dev)
        padded[0, :1 << logn] = F.mont_mul_plain(fr, coeffs, tables.powers(COSET_GEN, 1 << logn))
        return N.ntt_stages_plain(padded, tw_ext, tables)[0]

    err_l = limb_err(F, lde, lde_plain())
    require(err_l == 0, f"the coset LDE (K3 + K4) equals its plain version at "
                        f"2^{logn} -> 2^{logn + 2}")
    del lde
    bl = ntt_bound_ms(1, logn + 2)
    out["K4"] = dict(
        ms=time_ms(torch, lambda: N.ntt_passes(x, tw), reps=10),
        plain_ms=time_ms(torch, lambda: N.ntt_stages_plain(x, tw, tables), reps=1),
        bound_ms=bb[0], bound_by=bb[1], max_abs_err=max(err_b, err_l),
        shape=f"[{batch}, 2^{logn}]",
        passes={f"2^{logn}": N.ntt_plan(logn), f"2^{logn + 2}": N.ntt_plan(logn + 2)},
        **{f"coset_lde_2e{logn}_to_2e{logn + 2}": dict(
            ms=time_ms(torch, lambda: N.coset_lde(coeffs, w_ext, COSET_GEN, 4 << logn, tables),
                       reps=10),
            plain_ms=time_ms(torch, lde_plain, reps=1), bound_ms=bl[0], bound_by=bl[1])})
    del x, coeffs, tables, tw, tw_ext
    torch.cuda.empty_cache()
    return out


def k1_fixed_phase(torch, dev, gen, pts) -> dict:
    """K1's fixed-base form at the step's geometry: the 2^21 points of pts
    and random scalars, GLV-split on the card, their window table built by
    the port. Returns the K1_fixed record."""
    from spectre_tpu_torch.fields import bn254
    from spectre_tpu_torch.ops import ec, field_ops as F, glv, kernel_lib as KL, limbs as L
    from spectre_tpu_torch.ops import msm as M, msm_kernels as MK

    n = pts.shape[0]
    nbits = glv.glv_bits()
    c = M.default_window_pallas(2 * n, signed=True)
    nwin, nb = M.num_windows(c, nbits), 1 << (c - 1)
    N, nkeys = 2 * n, nwin * nb
    require((c, nwin, nbits) == (13, 10, 126), "the step's fixed-base geometry (c=13, 10 windows)")
    sc = random_fr(torch, n, gen, dev)

    # the GLV split on the card, against the host oracle on a prefix
    split_dev_ms, split_ops = device_profile(torch, lambda: M.glv_scalars(sc))
    split_ms = time_ms(torch, lambda: M.glv_scalars(sc), reps=3)
    mags, negs = M.glv_scalars(sc)
    ks = L.limbs_to_ints(F.tensor_to_u64(sc[:512]))
    a1, a2, n1, n2 = glv.decompose_batch(ks)
    got_mag = mags.cpu().numpy()
    got_neg = negs[0].cpu().numpy() != 0
    require((got_mag[:, :512].T == a1).all() and (got_mag[:, n:n + 512].T == a2).all()
            and (got_neg[:512] == n1).all() and (got_neg[n:n + 512] == n2).all(),
            "the GLV split on the card equals the host decomposition")
    digits = M.signed_digits(mags, c, nwin)
    del mags

    # the window table: c doublings a window through K2, phi by K3
    KL.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    table = M.build_window_table(pts, c, nwin)
    torch.cuda.synchronize()
    table_s = time.perf_counter() - t0
    table_launches = {k: v for k, v in KL.launch_counts().items() if v}
    g1 = bn254.g1_curve
    p0 = ec.decode_points(pts[:1])[0]
    corner = ec.decode_points(table[[0, 0, nwin - 1, nwin - 1], [0, n, 0, n]])
    shift = g1.mul(p0, 1 << (c * (nwin - 1)))
    require(corner == [p0, g1.mul(p0, glv.lam()), shift, g1.mul(shift, glv.lam())],
            "the window table's rows are 2^(c w) [P ; phi(P)]")
    table_bytes = table.numel() * table.element_size()
    require(table_bytes == M.fixed_table_device_bytes(n, c, nbits), "the table's bytes")

    # the kernel against its plain version, at full size
    got = MK.bucket_sums_fixed_aos32(table, digits, negs, c)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    counts, bstart, entries_plain = MK.bucket_plan_plain(digits, negs, c, fixed=True)
    want = MK.bucket_walk_plain(table.reshape(-1, 24), entries_plain, bstart)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = limb_err(F, ec.normalize_std(got), ec.normalize_std(want))
    require(err == 0, "K1's fixed form equals its plain version after normalization")
    got_counts, _, entries = MK.bucket_plan(digits, negs, c, fixed=True)
    e_err = bucket_multiset_err(torch, entries, entries_plain, bstart)
    require(torch.equal(got_counts, counts), "K1a (fixed form) equals its plain counts")
    require(e_err == 0, "K1_fixed places each bucket's entries as the plain sort")
    E = int(bstart[-1])
    require(int((entries[:E].long() & 0x7FFFFFFF).max()) >= (nwin - 1) * N,
            "the fixed form's entries reach the last window's rows")
    del want, entries, entries_plain, counts

    # the wrapper, and its plan (K1a, scan, K1_fixed) and walk (K1c, K1d)
    # apart, by CUDA events: on the H100 machine the profiler has dropped
    # this phase's kernels and given them half or twice their time
    rows = table.reshape(-1, 24)
    wrapper_ms = time_ms(torch, lambda: MK.bucket_sums_fixed_aos32(table, digits, negs, c),
                         reps=3)
    _, bstart_f, entries_f = MK.bucket_plan(digits, negs, c, fixed=True)
    plan_ms = time_ms(torch, lambda: MK.bucket_plan(digits, negs, c, fixed=True), reps=3)
    walk_ms = time_ms(torch, lambda: MK.bucket_walk(rows, entries_f, bstart_f), reps=3)
    del entries_f
    P, nblk = MK.plan_blocks(N)
    bounds = k1_bounds(torch, MK, digits, bstart, N, nkeys, nblk, fixed=True)
    total = bound_ms(sum(b[2] for b in bounds.values()), sum(b[3] for b in bounds.values()))
    w_idx, p_idx = torch.nonzero(digits, as_tuple=True)
    keys = w_idx * nb + digits[w_idx, p_idx].to(torch.int64).abs() - 1
    library = time_ms(torch, lambda: torch.argsort(keys, stable=True), reps=3)
    del w_idx, p_idx, keys
    # the glv mode's shared form on the same digits, over [P ; phi(P)]
    base2 = table[0]
    glv_ms = time_ms(torch, lambda: MK.bucket_sums_aos32(base2, digits, negs, c), reps=3)
    _, bstart_s, entries_s = MK.bucket_plan(digits, negs, c)
    glv_plan_ms = time_ms(torch, lambda: MK.bucket_plan(digits, negs, c), reps=3)
    glv_walk_ms = time_ms(torch, lambda: MK.bucket_walk(base2, entries_s, bstart_s), reps=3)
    del entries_s, bstart_s

    # the cross-window fold (K2) and K2b over one window of nb buckets
    fold_ms = time_ms(torch, lambda: MK.fold_windows_aos32(got, nwin, nb), reps=5)
    merged = MK.fold_windows_aos32(got, nwin, nb)
    k2b_err = limb_err(F, MK.aggregate_buckets_aos32(merged, 1, nb),
                       MK.aggregate_buckets_plain(merged, 1, nb))
    require(k2b_err == 0, "K2b over one window of 4096 buckets equals its plain version")
    k2b1_ms = time_ms(torch, lambda: MK.aggregate_buckets_aos32(merged, 1, nb), reps=10)
    adds, chain = k2b_work(MK, 1, nb)
    k2b1_bound = bound_ms(nb * 96 + 96, 2 * (nb - 1) * IMAD_PER_PADD)
    del got, merged, table, digits, base2, rows

    # the whole MSM per mode on these scalars: the same point
    scm = F.to_mont(F.fr_ctx(), sc)
    want_pt = M.msm_base(pts, scm, mode="vanilla")
    msm_s = {}
    for mode in ("glv+signed", "fixed"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pt = M.msm_base(pts, scm, mode=mode, base_key="chip-smoke-k1-fixed")
        msm_s[mode] = time.perf_counter() - t0
        require(pt == want_pt, f"the {mode} MSM equals the vanilla MSM at n = 2^21")
    M.clear_tables()
    torch.cuda.empty_cache()

    rec = dict(
        ms=wrapper_ms, plain_ms=plain_ms, bound_ms=total[0], bound_by=total[1],
        max_abs_err=max(err, e_err), library_ms=library,
        library_call="torch.argsort(stable=True) on the fixed form's bucket keys",
        shape=f"2^{n.bit_length() - 1} points GLV-expanded to N=2^{N.bit_length() - 1}, "
              f"c={c}, {nwin} windows, random scalars; the plain version at full size",
        note="the fixed-base form's four launches (K1a, the K1_fixed scatter, K1c, K1d) "
             "together; its launch count is the scatter's",
        entries=E, adds=E - int((bstart[1:] > bstart[:-1]).sum()),
        plan_ms=plan_ms, walk_ms=walk_ms,
        kernels={k: dict(bound_ms=bounds[k][0], bound_by=bounds[k][1]) for k in FIXED_K1},
        glv_shared_form=dict(ms=glv_ms, plan_ms=glv_plan_ms, walk_ms=glv_walk_ms),
        glv_split=dict(ms=split_ms, device_ms=split_dev_ms, device_ops=split_ops),
        table=dict(seconds=table_s, bytes=table_bytes,
                   reference_bytes=M.fixed_table_bytes(n, c, nbits),
                   budget_bytes=M.TABLES.budget, launches=table_launches),
        fold_ms=fold_ms,
        k2b_one_window=dict(ms=k2b1_ms, bound_ms=k2b1_bound[0], bound_by=k2b1_bound[1],
                            adds=adds, dependent_adds=chain, max_abs_err=k2b_err),
        msm_seconds=msm_s)
    log(f"K1-fixed: equal to its plain version at full size; wrapper {wrapper_ms:.3f} ms "
        f"(plain {plain_ms:.0f} ms, bound {total[0]:.3f} ms by {total[1]}), {E} entries; "
        f"plan (K1a, scan, K1_fixed) {plan_ms:.3f} ms, walk (K1c, K1d) {walk_ms:.3f} ms "
        f"(K1c bound {bounds['K1c_bucket_walk'][0]:.3f}); glv shared form on the same digits "
        f"{glv_ms:.3f} ms: plan {glv_plan_ms:.3f}, walk {glv_walk_ms:.3f}")
    log(f"  GLV split: {split_ms:.3f} ms ({split_dev_ms:.3f} ms of device time in "
        f"{split_ops:.0f} device operations); table {table_s:.3f} s, {table_bytes} bytes "
        f"(reference count {rec['table']['reference_bytes']}, budget {M.TABLES.budget}), "
        f"launches {json.dumps(table_launches)}; fold {fold_ms:.3f} ms; K2b one window "
        f"{k2b1_ms:.3f} ms (bound {k2b1_bound[0]:.4f}); MSM s {json.dumps(msm_s)}")
    return rec


def circuit_path(torch, dev, seed: int, circuit, k: int, make_args, shape,
                 describe, flip: int, check_args=None, modes=(), transcript_cls=None) -> dict:
    """One application circuit at its pinned testnet shape, through the
    entry points a user calls: args, witness, pinning (Pinning.check against
    the tracked file), SRS, keygen, prove, verify. shape(cfg, args) is the
    tuple the pinned shape must give, with describe as its name; flip, the
    instance flipped for the negative verify; check_args(spec), an extra
    check of the args; modes, the MSM modes whose proofs of the same
    witness, key and blinding seed must equal the vanilla proof;
    transcript_cls, the prove's and the verifier's transcript (default
    Blake2b). Returns the phase seconds, keygen's and the prove's phases,
    peak memory and launch counts, per mode the same of its prove, and the
    proof with its vk, SRS and instances."""
    from spectre_tpu_torch import spec as SPEC
    from spectre_tpu_torch.fields import bn254
    from spectre_tpu_torch.ops import kernel_lib as KL, msm as M
    from spectre_tpu_torch.plonk.prover import PhaseTimer
    from spectre_tpu_torch.plonk.srs import PARAMS_DIR, SRS
    from spectre_tpu_torch.plonk.transcript import Blake2bTranscript

    spec, phases, name = SPEC.TESTNET, {}, circuit.name
    transcript_cls = transcript_cls or Blake2bTranscript
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
    ktimer = PhaseTimer(torch.device(dev))
    t0 = time.perf_counter()
    pk = circuit.create_pk(srs, spec, k, args, device=dev, ctx=ctx, timer=ktimer)
    torch.cuda.synchronize()
    phases["keygen"] = time.perf_counter() - t0
    keygen_counts = KL.launch_counts()

    timer = PhaseTimer(torch.device(dev))
    r = random.Random(seed)
    KL.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    proof = circuit.prove(pk, srs, args, spec, device=dev, ctx=ctx,
                          blinding_rng=lambda: r.randrange(bn254.R), timer=timer,
                          transcript=transcript_cls())
    phases["prove"] = time.perf_counter() - t0
    prove_counts = KL.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    instances = circuit.get_instances(args, spec)
    require(instances == [av.value for av in ctx.instance_cells],
            "the circuit's instances equal get_instances")
    t0 = time.perf_counter()
    ok = circuit.verify(pk.vk, srs, instances, proof, device=dev,
                        transcript_cls=transcript_cls)
    phases["verify"] = time.perf_counter() - t0
    require(ok, f"the {name} proof verifies")
    flipped = list(instances)
    flipped[flip] ^= 1
    require(not circuit.verify(pk.vk, srs, flipped, proof, device=dev,
                               transcript_cls=transcript_cls),
            "a flipped instance is rejected")
    for kernel in PROVE_KERNELS:
        require(prove_counts[kernel] > 0, f"{kernel} launched in the {name} prove")
    log(f"  phases (s): " + json.dumps({key: round(v, 3) for key, v in phases.items()}))
    log(f"  keygen phases (s): " + json.dumps({key: round(v, 3)
                                              for key, v in ktimer.seconds.items()}))
    log(f"  prove phases (s): " + json.dumps({key: round(v, 3)
                                             for key, v in timer.seconds.items()}))
    log(f"  transcript {transcript_cls.__name__}; "
        f"vk digest {pk.vk.digest().hex()}")
    log(f"  proof {len(proof)} bytes, verified, flipped instance rejected; instances "
        f"{[hex(v) for v in instances]}; peak device memory {peak:.1f} GiB")
    log(f"  launches: keygen {json.dumps(keygen_counts)}, prove {json.dumps(prove_counts)}")

    by_mode = {}
    for mode in modes:
        M.clear_tables()
        torch.cuda.empty_cache()
        timer_m = PhaseTimer(torch.device(dev))
        r = random.Random(seed)
        degraded = M.COUNTERS["msm_fixed_degraded"]
        torch.cuda.synchronize()
        KL.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with msm_mode(mode):
            proof_m = circuit.prove(pk, srs, args, spec, device=dev, ctx=ctx,
                                    blinding_rng=lambda: r.randrange(bn254.R), timer=timer_m)
        torch.cuda.synchronize()
        prove_s = time.perf_counter() - t0
        counts_m = KL.launch_counts()
        peak_m = torch.cuda.max_memory_allocated() / 2 ** 30
        table_bytes = M.lru_stats()["bytes"]
        require(proof_m == proof, f"the {mode} {name} proof equals the vanilla proof byte for byte")
        require(circuit.verify(pk.vk, srs, instances, proof_m, device=dev),
                f"the {mode} {name} proof verifies")
        require(M.COUNTERS["msm_fixed_degraded"] == degraded,
                f"no fixed-base degrade in the {mode} prove")
        for kernel in MODE_KERNELS[mode]:
            require(counts_m[kernel] > 0, f"{kernel} launched in the {mode} {name} prove")
        log(f"  {mode}: prove {prove_s:.3f} s, equal to the vanilla proof, verified; phases "
            + json.dumps({key: round(v, 3) for key, v in timer_m.seconds.items()})
            + f"; peak {peak_m:.1f} GiB, tables {table_bytes} bytes; launches "
            + json.dumps({key: v for key, v in counts_m.items() if v}))
        by_mode[mode] = dict(prove_s=prove_s, prove_phases=timer_m.seconds, peak_gib=peak_m,
                             table_bytes=table_bytes, launches=counts_m)
    M.clear_tables()
    return dict(phases=phases, keygen_phases=ktimer.seconds, prove_phases=timer.seconds,
                peak_gib=peak, keygen_launches=keygen_counts, prove_launches=prove_counts,
                modes=by_mode, proof=proof, vk=pk.vk, srs=srs, instances=instances)


def committee_path(torch, dev, seed: int) -> dict:
    """The CommitteeUpdateCircuit at build/committee_update_testnet_18
    .pinning.json: 512 pubkeys, k=18, 22 advice columns, 2070 SHA slots,
    proved under the Poseidon transcript (the proof stage 2 aggregates)."""
    from spectre_tpu_torch.models import CommitteeUpdateCircuit
    from spectre_tpu_torch.plonk.transcript import PoseidonTranscript
    from spectre_tpu_torch.witness import default_committee_update_args

    return circuit_path(
        torch, dev, seed, CommitteeUpdateCircuit, COMMITTEE_K, default_committee_update_args,
        lambda cfg, a: (cfg.k, cfg.num_advice, cfg.num_sha_slots,
                        len(a.pubkeys_compressed)) == (COMMITTEE_K, 22, 2070, 512),
        "512 pubkeys, k=18, 22 advice, 2070 SHA slots", flip=0,
        transcript_cls=PoseidonTranscript)


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
        check_args=wrong_signature_refused, modes=STEP_MODES)


def measured(torch, phases: dict, name: str, fn):
    """Run fn() as the phase `name`: its seconds (device synchronized), the
    peak device memory in it, the host's peak RSS so far and the kernels it
    launched, into phases[name]. Returns fn's result."""
    import resource

    from spectre_tpu_torch.ops import kernel_lib as KL

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    KL.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    phases[name] = dict(
        s=time.perf_counter() - t0, peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        host_rss_gib=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20,
        launches={k: v for k, v in KL.launch_counts().items() if v})
    log(f"  {name}: {phases[name]['s']:.3f} s, peak {phases[name]['peak_gib']:.1f} GiB "
        f"(host RSS {phases[name]['host_rss_gib']:.1f} GiB), launches "
        + json.dumps(phases[name]["launches"]))
    return out


def tracked_proofs(committee: dict, circuit, vk, srs) -> dict:
    """The port's verifiers on the reference's tracked proofs: the
    committee's stage-1 proof under Poseidon with the port's committee vk,
    and the compressed proof under Keccak with its instances and the port's
    outer vk (AggregationCircuit.verify, pairing included). Either may fail
    only because the vk differs since a re-pin: the outcome, the port's vk
    digests and the digest the tracked verifier contract records are
    returned, and never change the exit code."""
    import re

    from spectre_tpu_torch.plonk.transcript import KeccakTranscript, PoseidonTranscript
    from spectre_tpu_torch.plonk.verifier import verify

    build = os.path.join(REPO, "build")
    out = {"committee_vk_digest": committee["vk"].digest().hex(),
           "outer_vk_digest": vk.digest().hex()}
    try:
        with open(os.path.join(build, "agg_committee_testnet_22_keccak.proof"), "rb") as f:
            agg_proof = f.read()
        with open(os.path.join(build, "agg_committee_testnet_22_keccak.proof.instances.json")) as f:
            agg_inst = [int(v, 16) for v in json.load(f)["instances"]]
        with open(os.path.join(build, "committee_testnet_18_poseidon.proof"), "rb") as f:
            com_proof = f.read()
        with open(os.path.join(build, "aggregation_committee_testnet_22_verifier.sol")) as f:
            m = re.search(r"VK_DIGEST =\s*(0x[0-9a-f]+)", f.read())
        out["tracked_outer_vk_digest"] = m.group(1)[2:] if m else None
        out["tracked_committee_instances_equal_ours"] = agg_inst[12:] == committee["instances"]
        out["committee_proof_verifies"] = verify(committee["vk"], committee["srs"],
                                                 [agg_inst[12:]], com_proof,
                                                 transcript_cls=PoseidonTranscript)
        out["outer_proof_verifies"] = circuit.verify(vk, srs, agg_inst, agg_proof,
                                                     transcript_cls=KeccakTranscript)
    except Exception as e:   # recorded, apart from the exit code
        out["error"] = f"{type(e).__name__}: {e}"
    return out


def aggregation_path(torch, dev, seed: int, committee: dict) -> dict:
    """Stage 2 of the committee: its Poseidon proof aggregated at the
    tracked k=22 pinning, the outer circuit proved under Keccak and checked
    by AggregationCircuit.verify (the deferred pairing included)."""
    from spectre_tpu_torch import spec as SPEC
    from spectre_tpu_torch.fields import bn254
    from spectre_tpu_torch.models.aggregation import (NUM_ACC_LIMBS, AggregationArgs,
                                                      AggregationCircuit)
    from spectre_tpu_torch.plonk.prover import PhaseTimer
    from spectre_tpu_torch.plonk.srs import SRS
    from spectre_tpu_torch.plonk.transcript import KeccakTranscript

    spec, phases = SPEC.TESTNET, {}
    circuit = AggregationCircuit.variant("committee_update")
    require(os.path.exists(circuit.pinning_path(spec, AGG_K)),
            "the tracked aggregation pinning file is present")
    # args: the inner snark, the committee phase's Poseidon proof
    phases["args"] = dict(s=committee["phases"]["prove"], peak_gib=committee["peak_gib"],
                          launches={k: v for k, v in committee["prove_launches"].items() if v})
    log(f"aggregation: the inner snark is the committee's stage-1 proof "
        f"({len(committee['proof'])} bytes, Poseidon)")
    log(f"  args (the inner proof): {phases['args']['s']:.3f} s, peak "
        f"{phases['args']['peak_gib']:.1f} GiB, launches " + json.dumps(phases["args"]["launches"]))
    args = AggregationArgs(inner_vk=committee["vk"], srs=committee["srs"],
                           inner_instances=[committee["instances"]], proof=committee["proof"])
    ctx = measured(torch, phases, "build",
                   lambda: circuit.build_context(args, spec, device=dev))
    cfg = measured(torch, phases, "pinning",
                   lambda: circuit.pinning(spec, AGG_K, ctx).config)
    require((cfg.k, cfg.num_advice, cfg.num_lookup_advice, cfg.lookup_bits, cfg.num_fixed,
             cfg.num_instance) == (AGG_K, 16, 2, 14, 1, 1),
            "the pinned aggregation shape (k=22, 16 advice, 2 lookup, lookup_bits 14, "
            "1 fixed, 1 instance)")
    log(f"  shape k={cfg.k} advice={cfg.num_advice} lookup={cfg.lookup_tables} "
        f"lookup_bits={cfg.lookup_bits}; break points equal the pinning's; "
        + json.dumps(ctx.stats()))
    instances = measured(torch, phases, "instances",
                         lambda: circuit.get_instances(args, spec))
    require(instances == [av.value for av in ctx.instance_cells],
            "the exposed cells equal get_instances")
    require(len(instances) == NUM_ACC_LIMBS + len(committee["instances"])
            and instances[NUM_ACC_LIMBS:] == committee["instances"],
            "the statement is the 12 accumulator limbs, then the committee's instances")
    srs = measured(torch, phases, "srs", lambda: SRS.load_or_setup(AGG_K, device=dev))
    require(srs.g2_tau == committee["srs"].g2_tau, "the k=22 SRS has the inner SRS's tau")
    ktimer = PhaseTimer(torch.device(dev))
    pk = measured(torch, phases, "keygen",
                  lambda: circuit.create_pk(srs, spec, AGG_K, args, device=dev, ctx=ctx,
                                            timer=ktimer))
    phases["keygen"]["phases"] = ktimer.seconds
    log("  keygen phases (s): " + json.dumps({k: round(v, 3) for k, v in ktimer.seconds.items()}))
    timer = PhaseTimer(torch.device(dev))
    r = random.Random(seed)
    proof = measured(torch, phases, "prove", lambda: circuit.prove(
        pk, srs, args, spec, device=dev, ctx=ctx, transcript=KeccakTranscript(),
        blinding_rng=lambda: r.randrange(bn254.R), timer=timer))
    phases["prove"]["phases"] = timer.seconds
    log("  prove phases (s): " + json.dumps({k: round(v, 3) for k, v in timer.seconds.items()}))
    del ctx
    ok = measured(torch, phases, "verify", lambda: circuit.verify(
        pk.vk, srs, instances, proof, device=dev, transcript_cls=KeccakTranscript))
    require(ok, "the outer proof passes AggregationCircuit.verify")
    bad = list(instances)
    bad[0] = (bad[0] + 1) % bn254.R
    require(not circuit.verify(pk.vk, srs, bad, proof, device=dev,
                               transcript_cls=KeccakTranscript),
            "a flipped accumulator limb is rejected")
    for kernel in PROVE_KERNELS:
        require(phases["prove"]["launches"].get(kernel, 0) > 0,
                f"{kernel} launched in the outer prove")
    log(f"  outer proof {len(proof)} bytes (Keccak), AggregationCircuit.verify accepts it, "
        f"a flipped accumulator limb is rejected; vk digest {pk.vk.digest().hex()}")
    tracked = tracked_proofs(committee, circuit, pk.vk, srs)
    log("  tracked reference proofs (apart from the exit code): " + json.dumps(tracked))
    return dict(phases=phases, tracked=tracked, proof_bytes=len(proof))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, default=None,
                    help="rows 2^k of the slice (default: the pinning's k)")
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

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
    k1_kernels = {k: KL.KERNELS[k].symbol for k in SHARED_K1}
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    records = {}

    # --- device ------------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"gpu: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    # the fixed-base table budget: the reference's rule (SPECTRE_MSM_TABLE_MB,
    # else min(8 GiB, a quarter of host RAM)) must hold the step's table
    need = M.fixed_table_bytes(1 << STEP_K, M.default_window_pallas(2 << STEP_K, signed=True),
                               126)
    if M.TABLES.budget < need:
        os.environ["SPECTRE_MSM_TABLE_MB"] = str(-(-need >> 20))
        M.TABLES.budget = M.table_budget_bytes()
        log(f"msm table budget: host RAM puts the rule under the step's table; "
            f"SPECTRE_MSM_TABLE_MB set to {os.environ['SPECTRE_MSM_TABLE_MB']}")
    log(f"msm table budget {M.TABLES.budget} bytes; the step's table {need} bytes by the "
        f"reference's count, {need // 2} in the port's layout")

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
    del soa, sc, pre, rest
    torch.cuda.empty_cache()

    # --- K1-fixed --------------------------------------------------------------
    records["K1_fixed"] = k1_fixed_phase(torch, dev, gen, pts)
    del pts

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
    for d in ("cuda", "cpu"):
        s6 = SRS.unsafe_setup(6, device=d)
        pk6 = keygen(s6, small, fc.fixed, fc.selectors, fc.copies, device=d)
        r = random.Random(args.seed)
        KL.reset_launch_counts()
        with msm_mode("fixed"):
            fixed_proof = prove(pk6, s6, fc.assignment, device=d,
                                blinding_rng=lambda: r.randrange(bn254.R))
        require(fixed_proof == proofs["cuda"], f"the fixed-mode K=6 proof on {d} equals "
                                               "the vanilla proof")
        if d == "cuda":
            require(KL.launch_counts()["K1_fixed"] > 0, "the fixed form launched at K=6")
    M.clear_tables()
    log("devices: K=6 proof bytes equal on cuda and cpu, vanilla and under "
        "SPECTRE_MSM_MODE=fixed")

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
    geometry = geometry_kernels(torch, dev, gen, args.seed, COMMITTEE_K, 4)
    log("committee-kernels: " + json.dumps(geometry))
    for name, key in (("K1c_bucket_walk", "K1"), ("K2b_bucket_aggregate", "K2b"),
                      ("K4_ntt", "K4")):
        records[name]["committee_geometry"] = geometry[key]
    log("resident before the committee: " + resident(torch))
    committee = committee_path(torch, dev, args.seed)
    torch.cuda.empty_cache()
    log("resident before the step: " + resident(torch))
    step = step_path(torch, dev, args.seed)
    torch.cuda.empty_cache()
    # --- aggregation-kernels, aggregation ----------------------------------------
    geometry = geometry_kernels(torch, dev, gen, args.seed, AGG_K, 2)
    log("aggregation-kernels: " + json.dumps(geometry))
    for name, key in (("K1c_bucket_walk", "K1"), ("K2b_bucket_aggregate", "K2b"),
                      ("K4_ntt", "K4")):
        records[name]["aggregation_geometry"] = geometry[key]
    log("resident before the aggregation: " + resident(torch))
    agg = aggregation_path(torch, dev, args.seed, committee)

    kernels = []
    for name, info in KL.KERNELS.items():
        rec = dict(records[name])
        by_mode = {mode: v["launches"][name] for mode, v in step["modes"].items()}
        kernels.append({
            "name": name, "route": "cuda", "source": info.source,
            "replaces": info.replaces,
            # the fixed form's path is the fixed-mode step prove
            "launches": by_mode["fixed"] if name == "K1_fixed" else counts[name],
            "step_launches_by_mode": by_mode,
            "committee_launches": committee["prove_launches"][name],
            "committee_keygen_launches": committee["keygen_launches"][name],
            "step_launches": step["prove_launches"][name],
            "step_keygen_launches": step["keygen_launches"][name],
            "aggregation_launches": agg["phases"]["prove"]["launches"].get(name, 0),
            "aggregation_keygen_launches": agg["phases"]["keygen"]["launches"].get(name, 0),
            **{key: rec.pop(key) for key in ("max_abs_err", "ms", "plain_ms",
                                             "bound_ms", "bound_by")},
            "library_ms": rec.pop("library_ms", None), **rec})
    log(f"smoke: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
