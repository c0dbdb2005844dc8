#!/usr/bin/env python3
"""Run spectre_tpu_torch's witness acquisition, its prover service and its
stage-1 and stage-2 proves on one CUDA GPU, and hold each of its kernels
against its plain PyTorch version.

    python3 chip_smoke.py           # every path, full size
    python3 chip_smoke.py --k 21    # the flex slice on the pinning's 2^21 rows

Phases, each of which ends the run with a non-zero exit code if it fails:
  device   the GPU's name and power limit (nvidia-smi)
  build    nvcc builds the kernels from spectre_tpu_torch/csrc; prints the
           SASS instruction count of one Montgomery product (cuobjdump on
           the probe kernel) and the registers a thread of K1c, K1c_fixed,
           K2, K2b and K6
  K2       complete addition, 2^16 point pairs plus P+P, P+(-P), inf+P and
           inf+inf: equal limb for limb; timed at 2^21 pairs
  K3       Montgomery product at 2^23 elements: equal; timed
  K4       the whole NTT (one launch per pass) at 2^23, at a [4, 2^21]
           batch and at 2^6: equal to the plain stage loop; timed at 2^23
           and at the advice commitments' batch, [16, 2^21]
  K7       the 8-bit-limb Montgomery product (its two constant-operand
           products on the tensor cores) at 2^23, 2^16 + 1 and 1 elements,
           Fr and Fq: equal to K3 and to its plain version (Fq's 2^23 on its
           2^18 prefix); timed at 2^23 beside K3
  K8       the factored DFT short transform on [4096, 2^6], [512, 2^9],
           [1024, 2^10], [64, 2^11] and [1024, 2^12] rows: equal to its
           plain version (the dense DFT matrix) and to K4 on the same rows;
           the four-step NTT with K4's stages at 2^20 and 2^24 and with K8
           at 2^20 and [16, 2^18], each equal to K4's radix-2 transform; all
           timed, and torch._int_mm on int8 stand-ins of the 2^20 leg's two
           passes, in both orientations
  K1       bucket sums at n = 2^21, c from default_window_pallas, for
           random, all-equal and all-zero scalars: equal after affine
           normalization on the 2^18 prefix, the committee's MSM size (the
           whole sums are held by the msm phase's host sum); the plan
           kernels K1a and K1b equal to their plain versions on the same
           inputs; the wrapper timed at 2^21, and each of its four kernels
           under torch.profiler (the whole plain K1's time on the prefix
           stands as K1c's plain time)
  K2b      the weighted bucket aggregation at c from default_window_pallas
           (24 windows of 1024 buckets at n = 2^21, 8 blocks a window), on
           random projective bucket sums and on K1's own output: equal limb
           for limb; timed
  msm      the full MSM at n = 2^21 over the test points tau^i G, against
           the host sum (sum s_i tau^i) G on a 2^10 prefix and whole, and
           linear in its scalars
  K1-fixed K1's fixed-base form at the step's geometry: 2^21 base points and
           random scalars, GLV-split on the card (2^22 expanded points, c=13,
           10 windows), the window table built by the port (K2 doublings,
           normalised to Z = 1 by one batch inversion, K3 for phi) and
           checked normalised: the fixed form (K1a, K1_fixed, the mixed walk
           K1c_fixed_walk, K1d) equal to its plain version (at full size)
           after affine normalization, its plan kernels to theirs; the
           wrapper, its plan and its walk timed beside the shared form on
           the same digits, the bound with the walk's adds counted as mixed
           and as complete adds; the split's device time and launches, the
           table's seconds (its normalisation apart), bytes and launches;
           the cross-window K2 fold and K2b over one window of 4096 buckets
           (64 blocks; equal to its plain version); the fixed and glv MSMs
           equal the vanilla MSM
  K6       BLS12-381 G1 decompression's square root at the committee's 512
           keys (seeded points, two negations, x = 0 with either sign) and at
           513 (a part-filled warp): equal to its plain version limb for limb
           and, through g1_decompress_batch, to the host's
           bls12_381.g1_decompress key for key; an x off the curve raises;
           K6, its plain version and the host loop timed at 512
  devices  a K=6 circuit proved on the GPU and on the CPU gives the same
           bytes, vanilla and under SPECTRE_MSM_MODE=fixed (the CPU side runs
           in the worker process from the start of the run)
  slice    SRS -> keygen -> prove -> verify at the shape of
           build/sync_step_testnet_21.pinning.json on 2^19 rows (--k sets
           them) with a seeded flex-gate witness; launch counts of every kernel on the
           prove's path must be > 0 (all but K2, which the prove does not
           launch: the slice runs it only to make the SRS)
  committee-kernels
           K1 and K2b at n = 2^18 random scalars, K4 at [4, 2^18] and as a
           2^18 -> 2^20 coset LDE (the committee prove's geometry): equal to
           their plain versions, K1's plan kernels K1a and K1b to theirs;
           timed, each of K1's four kernels under torch.profiler
  acquire  witness acquisition: a TESTNET light_client/sync fixture (512
           keys, a real aggregate signature; generate_spec_test in the worker
           process from the start of the run, into a temporary directory)
           served as Beacon-API JSON by an HTTP server on 127.0.0.1; the
           port's BeaconClient fetches the head root, the bootstrap, the
           finality update and the attested period's committee update;
           step_args_from_finality_update (its pubkeys through K6, its
           branches and signature checked natively) and
           rotation_args_from_update make the args, the domain from
           ssz.compute_domain over the fixture's genesis_validators_root;
           read_test_files_and_gen_witness gives the same args; the
           bootstrap's period and committee Poseidon
           (get_initial_sync_committee_poseidon) are the contract's genesis;
           the launch counts set to 0 before and read after: K6 launched
  boot     the prover service's ProverState(TESTNET, k_step=21,
           k_committee=18) on the card, its SRS set up in a temporary
           params_dir (no key file written): both keys made from the default
           args (made in the worker process; their witnesses checked against
           the tracked pinnings), the K=6 self-check proved and verified on
           the card; each key's keygen launches (compilelog's entry points)
  committee
           the CommitteeUpdateCircuit at build/committee_update_testnet_18
           .pinning.json (512 pubkeys, k=18, 2070 SHA slots) under the boot's
           key: the acquired rotation args' witness (Pinning.check), proved
           under the Poseidon transcript (the proof stage 2 takes) and
           verified under that key; the instances equal get_instances and
           differ from the default args', a flipped instance fails; the
           prove's launch count of every kernel on its path must be > 0;
           then the same witness, key and blinding seed proved under
           SPECTRE_NTT_MODE=fourstep, SPECTRE_NTT_KERNEL=matmul and
           SPECTRE_FIELD_IMPL=mxu (every transform's legs K8, every product
           K7): the proof equal to the first byte for byte and verified, K7
           and K8 launched, K3 and K4 not
  step     the StepCircuit at build/sync_step_testnet_21.pinning.json (512
           pubkeys, k=21, 16 advice, 3 lookup columns, lookup_bits 18) under
           the boot's key: the acquired step args' witness (Pinning.check),
           prove under the Poseidon transcript (the proof stage 2 takes),
           verify under that key; the instances equal get_instances,
           a flipped instance fails, a copy of the acquired args with a wrong
           signature fails the native pre-check; the prove's launch count of
           every kernel on its path must be > 0; then the same witness, key
           and blinding seed proved
           under SPECTRE_MSM_MODE=glv+signed and =fixed: each proof equal to
           the vanilla proof byte for byte and verified, the fixed form and
           K2 launched in the fixed prove (the fixed walk once a fixed-form
           MSM, K1c never), no fixed-base degrade
  mesh     the step's stage 1 again on a ShardingPlan of a 2x2 mesh (four
           virtual shards of cuda:0 on a one-card machine, the default mesh
           of the cards on a larger one): the step phase's witness, key and
           blinding seed, vanilla, under the Poseidon transcript, through
           TorchBackend(plan=): its MSMs of 2^21 points shard by rows and
           windows, the h commitments spread over the batch axis, its NTTs
           split by Bailey over the data axis, its quotient (2^23) runs
           row-sharded; the proof equals the step's byte for byte and
           verifies, plan.stats() counts sharded MSMs, batched MSMs, sharded
           NTTs and quotients, no degrade counter moves, K1, K2b, K3 and K4
           launch at least once a shard. Then the K=6 readiness circuit
           (prover_service.selfverify._tiny_setup) with the gates lowered to
           2^5, on 2x1 and 4x2 plans of cuda:0, under glv+signed and fixed:
           each proof equal to the unsharded one. One `mesh` line: the
           prove's seconds by phase beside the step phase's, its peak, the
           bytes exchanged and the launches
  service  rpc.serve over the boot's state (journal in the temporary
           directory; replica id "card", announcing itself to the farm's
           head), driven through the port's ProverClient with a request made
           from the acquire phase's Beacon-API JSON: /healthz 503 until a
           fresh self-check passes on the card, then 200; the blocking
           genEvmProof_SyncStepCompressed; the answer's instances equal
           get_instances of the acquired args, its proof verifies under the
           state's vk (a flipped instance does not), its calldata decodes
           back; a resubmit is a dedup hit (K1 not launched); a wrong
           signature answers -32000; the manifest shows its phases and 0
           kernel builds; /metrics counts the proof and exports the launch
           counters; one `service` line: boot seconds, the request's queue
           wait, preprocess, witness, layout, prove and verify seconds, peak
           device memory, launches of K1a-K1d, K2, K2b, K3, K4, K6. The
           server stays up for the farm
  farm     the proof farm, the follower, the gateway and loadgen over the
           service's server: a head server (rpc.serve with a Dispatcher, a
           Follower and the gateway, replica id "head") whose dispatcher
           fronts the service's server by two HttpReplicas, cross-verifies
           on the boot's state and holds a lease shorter than the committee
           prove; the service's server joins it by announce (the member
           journal's join). Under SPECTRE_FAULT_PLAN=replica.dispatch:crash:1
           the follower's first poll of the beacon JSON yields the
           committee update of its (finalized) period, proved on the card
           through the farm after exactly one lease takeover, and the step,
           a dedup hit on the service's server; both cross-verified at the
           head and stored. The stored committee update: instances equal
           get_instances of the acquired rotation args, it verifies under
           the state's vk (a flipped instance does not), its calldata decodes
           back, its Poseidon is the committee phase's, verify_chain() holds;
           GET /v1/update/<p> on the head: ETag the store's digest, body the
           canonical body, 304 on If-None-Match; a loadgen HttpTarget drill
           of 3,000 requests: 0 errors, no kernel launched; /metrics on the
           head has the dispatcher, replica, follower and gateway families;
           K1c launched as one committee prove. One `farm` line: the
           follower's poll, the committee job end to end at the head, the
           cross-verify and the drill's seconds, the takeovers, the longest
           gap between two lease renewals and between two of the prove's own
           heartbeats, the drill's p50/p99 and requests/s, the launches;
           the state and its keys are dropped after it
  step-aggregation
           stage 2 of the step (COMPRESSED["step"]): the step's Poseidon
           proof aggregated by AggregationCircuit.variant("sync_step"), whose
           shape no file pins: the reference flow's rule (outer_k) sizes it
           at k=21 (11 advice, 2 lookup, lookup_bits 14); its advice and
           lookup cells; the statement (12 accumulator limbs, then the
           step's 2 instances) equal to get_instances; the step's k=21 SRS;
           keygen, the outer prove under the Keccak transcript (5,600
           bytes), AggregationCircuit.verify, a flipped limb rejected; the
           outer vk digest equal to the tracked verifier's VK_DIGEST, and
           the port's verifiers accept the tracked step_testnet_21_poseidon
           .proof and agg_step_testnet_21_keccak.proof
  aggregation
           stage 2 of the committee (COMPRESSED["committee"]), the same
           checks at build/aggregation_committee_update_testnet_22.pinning
           .json (k=22, 16 advice, 2 lookup, lookup_bits 14; Pinning.check),
           with the k=22 SRS of the same tau; its outer context built in the
           worker process
  aggregation-kernels
           K1, K2b and K4 at the committee's outer prove's geometry: K1 and
           K2b at n = 2^22 (c from default_window_pallas; K1 held to its
           plain version on the 2^18 prefix, timed whole), K4 at [2, 2^22]
           and as the 2^22 -> 2^24 coset LDE (its own pass plan and twiddle
           table)
  evm      the EVM tail on each card's outer proof, the step's and the
           committee's (host code, run in the worker process beside the
           aggregation and aggregation-kernels phases and collected here):
           the Solidity verifier generated from the port's outer vk equals
           the tracked one of build/ but for its generator line, in the
           order today's codegen folds the identity
           check (streamed_order: the step's tracked verifier predates it),
           and its bytecode the source's (44,380 and 56,636 runtime bytes,
           the tracked verifiers'); the calldata; the simulator and the
           compiled verifier in the metered VM accept the proof (the tracked
           execution gas, the total within TOTAL_GAS_SLACK) and reject it
           with byte 41 flipped; the tracked proof in the VM gives its
           recorded gas and size. On chain, in the VM's World, Spectre
           constructed with the bootstrap's period and committee Poseidon:
           with the compiled step verifier it takes the card's step proof
           through stepCompressed (the StepInput of the acquired step args;
           the bootstrap's Poseidon is instances[13]) and reverts on the
           flipped proof; with a constant-true step verifier and the
           compiled committee verifier it takes one step to the committee's
           finalized header, then rotateCompressed with the card's committee
           proof stores instances[12] as the next period's committee, and the
           flipped proof reverts; the phase's seconds

Host jobs that need no card run in one worker process (spawned, no CUDA)
beside the card's phases: the devices phase's CPU proofs, the beacon data's
fixture, the committee's and the step's default args (the boot's key args),
the committee's outer build (the aggregation circuit's witness over the
committee's proof, started after the step phase and collected by the
aggregation phase) and the EVM checks.
Each phase's start is logged as "[elapsed s] phase", on the standard error
too; a crash prints the Python stacks there (faulthandler). It prints one
JSON line of kernel records, then the device line {"ok": true, "device":
{...}} last. It imports neither jax nor spectre_tpu.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import faulthandler
import gc
import io
import json
import multiprocessing
import os
import random
import subprocess
import sys
import tempfile
import time
import types

REPO = os.path.dirname(os.path.abspath(__file__))
PINNING = os.path.join(REPO, "build", "sync_step_testnet_21.pinning.json")
COMMITTEE_K = 18
STEP_K = 21
# the flex slice's rows: the step holds the pinned shape at k=21, and the
# kernel phases run at 2^21 and above
FLEX_K = 19
AGG_K = 22
# K1's shared-base form, and its fixed-base form (its own scatter, K1_fixed,
# and its own walk over the normalised table, K1c_fixed_walk)
SHARED_K1 = ("K1a_bucket_count", "K1b_bucket_scatter", "K1c_bucket_walk",
             "K1d_bucket_pieces")
FIXED_K1 = ("K1a_bucket_count", "K1_fixed", "K1c_fixed_walk", "K1d_bucket_pieces")
# kernels whose path is the fixed-mode step prove
FIXED_ONLY = ("K1_fixed", "K1c_fixed_walk")
# the kernels the stage-1 prove launches in each MSM mode: vanilla and
# glv+signed do not launch K2 (the slice runs it only to make the SRS), the
# fixed mode launches it for its window table and cross-window fold
PROVE_KERNELS = (*SHARED_K1, "K2b_bucket_aggregate", "K3_mont_mul", "K4_ntt")
# the knob sets a circuit's proof is repeated under (the same witness, key
# and blinding seed: equal bytes), by name: the environment each sets, the
# kernels its prove must launch and those it must not
MXU = "fourstep+matmul+mxu"
MODES = {
    "glv+signed": dict(env={"SPECTRE_MSM_MODE": "glv+signed"}, launched=PROVE_KERNELS,
                       absent=()),
    "fixed": dict(env={"SPECTRE_MSM_MODE": "fixed"},
                  launched=(*FIXED_K1, "K2_padd", "K2b_bucket_aggregate", "K3_mont_mul",
                            "K4_ntt"), absent=("K1b_bucket_scatter", "K1c_bucket_walk")),
    MXU: dict(env={"SPECTRE_NTT_MODE": "fourstep", "SPECTRE_NTT_KERNEL": "matmul",
                   "SPECTRE_FIELD_IMPL": "mxu"},
              launched=(*SHARED_K1, "K2b_bucket_aggregate", "K7_mont_mul_mxu",
                        "K8_ntt_dft_matmul"), absent=("K3_mont_mul", "K4_ntt")),
}
STEP_MODES = ("glv+signed", "fixed")
COMMITTEE_MODES = (MXU,)
# kernels whose path is the committee prove under the MXU knobs
MXU_ONLY = ("K7_mont_mul_mxu", "K8_ntt_dft_matmul")

# H100 SXM peaks (NVIDIA data sheet): HBM3 at
# 3.35 TB/s; 67 TFLOP/s of float32 FMA outside the tensor cores, i.e. 33.5 T
# FMA/s, of which the integer pipe issues 32-bit multiply-adds at half rate.
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 16.75e12
# the tensor cores' dense int8 rate, 1,979 T operations/s, a multiply-add
# counted as two
TC_U8_MAC_PER_S = 1979e12 / 2
# 32-bit multiply-adds per 256-bit Montgomery product: 64 limb products of
# a*b and 64 of m*p, each a low and a high half, plus m itself
IMAD_PER_MONT = 257
IMAD_PER_PADD = 12 * IMAD_PER_MONT
# the fixed walk's mixed add: 11 products
IMAD_PER_MADD = 11 * IMAD_PER_MONT
# a 384-bit Montgomery product (K6): 144 limb products of a*b and 144 of
# m*p, each a low and a high half, plus m, counted once as in IMAD_PER_MONT;
# a squaring needs 78 limb products of a*a (12 squares, 66 doubled cross
# products) in place of the 144
IMAD_PER_MONT384 = 4 * 144 + 1
IMAD_PER_SQR384 = 2 * 78 + 2 * 144 + 1
# the committee's pubkeys: K6's batch on the main path
COMMITTEE_KEYS = 512

# the kernels' times before their redesign in this tree (one NVIDIA H100 80GB
# HBM3 at 700 W, PERF.md's kernel table): K7 at 2^23 Fr, K8 on [1024, 2^10]
K7_MS_BEFORE = 0.912
K8_MS_BEFORE = 10.105
# 32-bit multiply-adds of K8's one REDC at 2^272 (eight 32-bit steps of 9
# and one of 16 bits): per output point and pass
IMAD_PER_REDC272 = 8 * 9 + 9


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(nbytes: float, imads: float, tc_macs: float = 0) -> tuple[float, str]:
    """The least time for the work: bytes at the memory rate, or the 32-bit
    multiply-adds at the integer rate, or the u8 multiply-adds at the
    tensor cores' rate, whichever is longest (the units run side by side)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(imads / IMAD_PER_S, tc_macs / TC_U8_MAC_PER_S) * 1e3
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


def timed_once(torch, fn):
    """(fn(), its ms): one run, the device synchronized on both sides. A
    plain version's comparison run is its timing too."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def window_chain(e: int) -> tuple[int, int, int]:
    """(squarings, multiplies, window) of the shortest sliding-window
    addition chain for x^e over windows of 1-8 bits: the odd powers up to
    the largest digit used (one squaring, then a multiply each), the first
    window's power as the start, then a squaring a bit and a multiply for
    each later window."""
    bits = bin(e)[2:]
    best = None
    for w in range(1, 9):
        i, zeros, windows, top = 0, 0, [], 1
        while i < len(bits):
            if bits[i] == "0":
                zeros, i = zeros + 1, i + 1
                continue
            j = min(i + w, len(bits))
            while bits[j - 1] == "0":
                j -= 1
            windows.append(j - i)
            top, i = max(top, int(bits[i:j], 2)), j
        counts = (zeros + sum(windows[1:]) + (top > 1), len(windows) - 1 + (top - 1) // 2, w)
        if best is None or counts[0] + counts[1] < best[0] + best[1]:
            best = counts
    return best


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
    windows of nb buckets over G blocks a window (csrc/aggregate.cuh): a
    thread's walk of its L buckets, 2 (L - 1) adds, and log2 L doublings;
    4 adds a merge (2 for W, 2 for D) at each level of a block's tree and of
    the window's merge over its G blocks, 2 on the window's last level. The
    chain is the walk, the doublings and 2 adds a level."""
    G, T, L = MK.aggregate_geometry(nwin, nb)
    lb, lg = T.bit_length() - 1, G.bit_length() - 1
    leaf = 2 * (L - 1) + (L.bit_length() - 1)
    block = sum((T >> (k + 1)) * (4 if k + 1 < lb or G > 1 else 2) for k in range(lb))
    merge = sum((G >> (k + 1)) * (4 if k + 1 < lg else 2) for k in range(lg))
    return nwin * (G * (T * leaf + block) + merge), leaf + 2 * (lb + lg)


def k1_bounds(torch, MK, digits, bstart, n: int, nkeys: int, nblk: int,
              fixed: bool = False) -> dict:
    """Per K1 kernel (bound ms, by, bytes, IMAD) for this run's digits:
    each input read once and each output written once; the adds are one
    per entry less one per nonempty bucket, those of the buckets that cross
    walk blocks split off to K1d. The walk reads the points: the n of a
    shared base once each (96 n bytes, complete adds), or, in the
    fixed-base form, X, Y and the Z word of the E distinct normalised table
    rows its entries name (68 E bytes: each (window, point) has its own
    row), added by the mixed formula (IMAD_PER_MADD)."""
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
    point_bytes = 68 * E if fixed else (96 * n if E else 0)
    sizes = {
        "K1a_bucket_count": (4 * nwin * n + 4 * nkeys * nblk, 0),
        "K1_fixed" if fixed else "K1b_bucket_scatter": (
            4 * nwin * n + 4 * n + 4 * nkeys * nblk + 4 * E, 0),
        "K1c_fixed_walk" if fixed else "K1c_bucket_walk": (
            4 * E + point_bytes + 4 * (nkeys + 1) + 96 * int(nonempty.sum()),
            c_adds * (IMAD_PER_MADD if fixed else IMAD_PER_PADD)),
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
    now and then drops a kernel's events, the first of a trace most of all:
    each trace opens with a throwaway launch, and a kernel it did not see
    is profiled again, up to five traces, before the phase fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    got = {}
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
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
def knobs(env: dict):
    """The environment knobs env (SPECTRE_MSM_MODE, SPECTRE_NTT_MODE,
    SPECTRE_NTT_KERNEL, SPECTRE_FIELD_IMPL) for the block's duration; the
    field product, which field_ops reads from the environment at import,
    follows SPECTRE_FIELD_IMPL through enable_mxu."""
    from spectre_tpu_torch.ops import field_ops as F

    old = {key: os.environ.get(key) for key in env}
    mxu = F.mxu_enabled()
    os.environ.update(env)
    if "SPECTRE_FIELD_IMPL" in env:
        F.enable_mxu(env["SPECTRE_FIELD_IMPL"] == "mxu")
    try:
        yield
    finally:
        for key, value in old.items():
            if value is None:
                os.environ.pop(key)
            else:
                os.environ[key] = value
        F.enable_mxu(mxu)


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


def tau_msm(scalars: list, tau: int):
    """sum_i s_i P_i over the test points P_i = tau^i G, as (sum_i s_i tau^i) G:
    the host sum in one scalar product (Horner's rule), which also checks
    the points."""
    from spectre_tpu_torch.fields import bn254

    acc = 0
    for s in reversed(scalars):
        acc = (acc * tau + s) % bn254.R
    return bn254.g1_curve.mul(bn254.G1_GEN, acc)


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
    on the first 2^COMMITTEE_K points and digits (the whole input at the
    committee's geometry; the plain K1 takes ~3 s at 2^18 and ~30 s at
    2^22), and its whole sums, reduced by K2b and combined over the
    windows, held to the host's tau-sum; each of its four kernels timed
    under torch.profiler at 2^logn; K2b on K1's buckets; K4 on a
    [batch, 2^logn] batch and as the 2^logn -> 2^(logn+2) coset LDE (K3
    twists, K4 transforms). Returns {kernel: record}."""
    from spectre_tpu_torch.fields import bn254
    from spectre_tpu_torch.ops import (ec, field_ops as F, kernel_lib as KL, limbs as L,
                                       msm as M, msm_kernels as MK, ntt as N)
    from spectre_tpu_torch.plonk.domain import COSET_GEN
    from spectre_tpu_torch.plonk.srs import g1_powers_device

    fr = F.fr_ctx()
    n = 1 << logn
    out = {}
    tau = random.Random(seed + logn).randrange(1, bn254.R)
    pts = g1_powers_device(tau, n, dev)
    c = M.default_window_pallas(n)
    nwin, nb = M.num_windows(c), 1 << (c - 1)
    nblk = MK.plan_blocks(n)[1]
    scalars = random_fr(torch, n, gen, dev)
    digits = M.signed_digit_stream(scalars, c, nwin)
    negs = torch.zeros((1, n), dtype=torch.int32, device=dev)
    m = min(n, 1 << COMMITTEE_K)
    compared = "whole" if m == n else f"n=2^{COMMITTEE_K} prefix"
    d_cmp, n_cmp = digits[:, :m].contiguous(), negs[:, :m].contiguous()
    soa = ec.aos32_to_soa16(pts[:m].contiguous())
    got = MK.bucket_sums(soa, d_cmp, n_cmp, c)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = MK.bucket_sums_plain(soa, d_cmp, n_cmp, c)
    torch.cuda.synchronize()
    k1_plain = (time.perf_counter() - t0) * 1e3
    err = limb_err(F, normalized_buckets(ec, got), normalized_buckets(ec, want))
    require(err == 0, f"K1 equals its plain version ({compared} of n = 2^{logn}, c={c})")
    k1_prefix_ms = time_ms(torch, lambda: MK.bucket_sums(soa, d_cmp, n_cmp, c), reps=3)
    del got, want, soa
    counts, bstart_cmp, entries_plain = MK.bucket_plan_plain(d_cmp, n_cmp, c)
    got_counts, _, entries = MK.bucket_plan(d_cmp, n_cmp, c)
    require(torch.equal(got_counts, counts), f"K1a equals its plain counts ({compared})")
    e_err = bucket_multiset_err(torch, entries, entries_plain, bstart_cmp)
    require(e_err == 0, f"K1b places each bucket's entries as the plain sort ({compared})")
    del counts, got_counts, entries, entries_plain, d_cmp, n_cmp, bstart_cmp
    # the bound counts the whole input's buckets
    _, bstart = MK.bucket_offsets(MK.bucket_counts_plain(digits, nb, MK.plan_blocks(n)[0]),
                                  nwin * nb, nblk)
    bounds = k1_bounds(torch, MK, digits, bstart, n, nwin * nb, nblk)
    k1_bound = bound_ms(sum(b[2] for b in bounds.values()), sum(b[3] for b in bounds.values()))
    k1_ms = time_ms(torch, lambda: MK.bucket_sums_aos32(pts, digits, negs, c), reps=5)
    sub_ms = profile_kernels(torch, lambda: MK.bucket_sums_aos32(pts, digits, negs, c),
                             {k: KL.KERNELS[k].symbol for k in SHARED_K1}, reps=2)
    # a plain time stands beside the kernel's at the same n
    plain = dict(plain_ms=k1_plain) if m == n else dict(prefix_ms=k1_prefix_ms,
                                                        prefix_plain_ms=k1_plain)
    out["K1"] = dict(ms=k1_ms, bound_ms=k1_bound[0], bound_by=k1_bound[1], **plain,
                     max_abs_err=max(err, e_err), entries=int(bstart[-1]),
                     shape=f"n=2^{logn} c={c} nwin={nwin}, random scalars",
                     compared=f"{compared}; the whole sum with the host's tau-sum",
                     kernels={k: dict(ms=sub_ms[k], bound_ms=bounds[k][0],
                                      bound_by=bounds[k][1]) for k in SHARED_K1})

    sums = MK.bucket_sums_aos32(pts, digits, negs, c)
    want, k2b_plain = timed_once(torch, lambda: MK.aggregate_buckets_plain(sums, nwin, nb))
    windows = MK.aggregate_buckets_aos32(sums, nwin, nb)
    err = limb_err(F, windows, want)
    require(err == 0, f"K2b equals its plain version at n = 2^{logn}")
    require(MK.combine_windows(windows, c)
            == tau_msm(L.limbs_to_ints(F.tensor_to_u64(scalars)), tau),
            f"K1's whole sums at n = 2^{logn}, weighted by K2b, equal the host's tau-sum")
    need = nwin * 2 * (nb - 1)
    bm, by = bound_ms(nwin * nb * 96 + nwin * 96, need * IMAD_PER_PADD)
    out["K2b"] = dict(
        ms=time_ms(torch, lambda: MK.aggregate_buckets_aos32(sums, nwin, nb), reps=10),
        plain_ms=k2b_plain, bound_ms=bm, bound_by=by, max_abs_err=err,
        shape=f"nwin={nwin} nb={nb} (c={c})")
    del sums, windows, want, pts, scalars, digits, negs, bstart
    torch.cuda.empty_cache()

    tables = N.Twiddles(dev)
    x = F.to_mont(fr, random_fr(torch, batch << logn, gen, dev)).reshape(batch, 1 << logn, 4)
    tw = tables.twiddles(bn254.fr_root_of_unity(logn), 1 << logn)
    want, k4_plain = timed_once(torch, lambda: N.ntt_stages_plain(x, tw, tables))
    err_b = limb_err(F, N.ntt_passes(x, tw), want)
    require(err_b == 0, f"K4 equals the plain NTT at [{batch}, 2^{logn}]")
    del want
    bb = ntt_bound_ms(batch, logn)
    coeffs = x[0]
    w_ext = bn254.fr_root_of_unity(logn + 2)
    lde = N.coset_lde(coeffs, w_ext, COSET_GEN, 4 << logn, tables)
    tw_ext = tables.twiddles(w_ext, 4 << logn)

    def lde_plain():
        padded = torch.zeros((1, 4 << logn, 4), dtype=torch.int64, device=dev)
        padded[0, :1 << logn] = F.mont_mul_plain(fr, coeffs, tables.powers(COSET_GEN, 1 << logn))
        return N.ntt_stages_plain(padded, tw_ext, tables)[0]

    want, lde_plain_ms = timed_once(torch, lde_plain)
    err_l = limb_err(F, lde, want)
    require(err_l == 0, f"the coset LDE (K3 + K4) equals its plain version at "
                        f"2^{logn} -> 2^{logn + 2}")
    del lde, want
    bl = ntt_bound_ms(1, logn + 2)
    out["K4"] = dict(
        ms=time_ms(torch, lambda: N.ntt_passes(x, tw), reps=10),
        plain_ms=k4_plain, bound_ms=bb[0], bound_by=bb[1], max_abs_err=max(err_b, err_l),
        shape=f"[{batch}, 2^{logn}]",
        passes={f"2^{logn}": N.ntt_plan(logn), f"2^{logn + 2}": N.ntt_plan(logn + 2)},
        **{f"coset_lde_2e{logn}_to_2e{logn + 2}": dict(
            ms=time_ms(torch, lambda: N.coset_lde(coeffs, w_ext, COSET_GEN, 4 << logn, tables),
                       reps=10),
            plain_ms=lde_plain_ms, bound_ms=bl[0], bound_by=bl[1])})
    del x, coeffs, tables, tw, tw_ext
    torch.cuda.empty_cache()
    return out


def mxu_product_phase(torch, dev, gen, k3_ms: float) -> dict:
    """K7, the 8-bit-limb Montgomery product, at 2^23, 2^16 + 1 and 1
    elements over Fr and Fq: equal to K3 limb for limb, and to its plain
    version (whole, but Fq's 2^23 on its 2^18 prefix), also with one b row;
    timed at 2^23 beside K3. Returns K7's record."""
    from spectre_tpu_torch.ops import field_mxu as MX, field_ops as F

    n_big = 1 << 23
    err, out = 0, {}
    for ctx in (F.fr_ctx(), F.fq_ctx()):
        for n in (n_big, (1 << 16) + 1, 1):
            r2 = F.const_raw(ctx.r2, dev)
            a = F.mont_mul_cios(ctx, random_fr(torch, n, gen, dev), r2)
            b = F.mont_mul_cios(ctx, random_fr(torch, n, gen, dev), r2)
            got = MX.mont_mul(ctx, a, b)
            e = limb_err(F, got, F.mont_mul_cios(ctx, a, b))
            m = n if n < n_big or ctx.field_id == F.FR_ID else 1 << 18
            want, plain_ms = timed_once(torch, lambda: MX.mont_mul_mxu_plain(ctx, a[:m], b[:m]))
            e = max(e, limb_err(F, got[:m], want))
            if n == (1 << 16) + 1:
                e = max(e, limb_err(F, MX.mont_mul(ctx, a, b[:1]),
                                    MX.mont_mul_mxu_plain(ctx, a, b[:1])))
            require(e == 0, f"K7 equals K3 and its plain version ({ctx.name}, {n} elements)")
            err = max(err, e)
            if n == n_big:
                out[ctx.name] = dict(ms=time_ms(torch, lambda: MX.mont_mul(ctx, a, b), reps=10),
                                     plain_ms=plain_ms, plain_elements=m)
            del a, b, got, want
    bm, by = bound_ms(n_big * 3 * 32, n_big * 128, n_big * 3 * 32 * 32)
    fr = out["bn254_fr"]
    log(f"K7: equal to K3 and to its plain version (Fr, Fq; 2^23, 2^16 + 1, 1); 2^23 Fr "
        f"{fr['ms']:.3f} ms (K3 {k3_ms:.3f} ms; plain {fr['plain_ms']:.1f} ms; bound {bm:.3f} "
        f"ms by {by}; before {K7_MS_BEFORE} ms), Fq {out['bn254_fq']['ms']:.3f} ms")
    return dict(ms=fr["ms"], plain_ms=fr["plain_ms"], bound_ms=bm, bound_by=by,
                max_abs_err=err, shape=f"{n_big} elements (Fr)", k3_ms=k3_ms,
                ms_before=K7_MS_BEFORE,
                fq_ms=out["bn254_fq"]["ms"],
                bound_note="bytes: two operands read and one written, 96 a product; "
                           "operations: 128 32-bit multiply-adds (t = a b) and 3,072 u8 "
                           "tensor-core multiply-adds (the two Toeplitz products) a product",
                library_call="none: no torch op computes a Montgomery product mod p")


def dft_work(rows: int, logn: int, N) -> tuple[int, int]:
    """(u8 tensor-core multiply-adds, 32-bit multiply-adds) that K8's
    factored transform on [rows, 2^logn] needs: for each pass of its plan,
    the 32 x 32 byte products of each (input, output) pair of every L-point
    DFT (what the kernel's Toeplitz form issues beyond that, its zeros and
    the m-tiles' padding, is not counted), one REDC a point, and the
    twiddle product a point of a twiddled pass."""
    n = 1 << logn
    tc = imads = 0
    for ps in N.dft_plan(logn):
        tc += rows * n * (1 << ps.logl) * 32 * 32
        imads += rows * n * (IMAD_PER_REDC272 + (IMAD_PER_MONT if ps.twiddled else 0))
    return tc, imads


def dft_phase(torch, dev, gen) -> dict:
    """K8, the factored DFT short transform: over [4096, 2^6], [512, 2^9]
    (the committee's 2^18 legs), [1024, 2^10] (its 2^20 legs), [64, 2^11]
    and [1024, 2^12] rows, each equal to its plain version (the dense byte
    matrix, whole) and to K4 on the same rows, all timed; the four-step
    transform (SPECTRE_NTT_MODE=fourstep) with K4's stages at 2^20 and 2^24
    and with K8 at 2^20 and [16, 2^18], each equal to K4's radix-2
    transform, all timed; torch._int_mm on int8 stand-ins of the committee
    leg's two passes (32 x 32 byte products a pair, the faster of two
    orientations) as the library yardstick. Returns K8's record."""
    from spectre_tpu_torch.fields import bn254
    from spectre_tpu_torch.ops import field_ops as F, ntt as N

    fr = F.fr_ctx()
    tables = N.Twiddles(dev)
    err, short = 0, {}
    for logn, rows in ((6, 4096), (9, 512), (10, 1024), (11, 64), (12, 1024)):
        n, w = 1 << logn, bn254.fr_root_of_unity(logn)
        x = F.to_mont(fr, random_fr(torch, rows * n, gen, dev)).reshape(rows, n, 4)
        w8 = tables.dft_matrix8(logn, w)
        tw = tables.twiddles(w, n)
        got = N.dft_matmul(x, tables, w)
        want, plain_ms = timed_once(torch, lambda: N.dft_matmul_plain(x, w8))
        e = max(limb_err(F, got, N.ntt_passes(x, tw)), limb_err(F, got, want))
        require(e == 0, f"K8 equals its plain version and K4 on [{rows}, 2^{logn}]")
        err = max(err, e)
        tc, imads = dft_work(rows, logn, N)
        bm, by = bound_ms(2 * rows * n * 32, imads, tc)
        dense_bm, _ = bound_ms(2 * rows * n * 32 + n * n * 32, 0, rows * 32 * 32 * n * n)
        short[f"[{rows}, 2^{logn}]"] = dict(
            ms=time_ms(torch, lambda: N.dft_matmul(x, tables, w), reps=3),
            k4_ms=time_ms(torch, lambda: N.ntt_passes(x, tw), reps=3),
            plain_ms=plain_ms, bound_ms=bm, bound_by=by, dense_bound_ms=dense_bm,
            passes=[p.logl for p in N.dft_plan(logn)])
        del x, got, want, w8
        N.clear_tables()
        torch.cuda.empty_cache()
    fourstep = {}
    for logn, batch, kernel in ((20, 1, "stages"), (24, 1, "stages"), (20, 1, "matmul"),
                                (18, 16, "matmul")):
        w = bn254.fr_root_of_unity(logn)
        x = F.to_mont(fr, random_fr(torch, batch << logn, gen, dev)).reshape(batch, 1 << logn, 4)
        want = N.ntt(x, w, tables, mode="radix2")
        e = limb_err(F, N.ntt(x, w, tables, mode="fourstep", kernel=kernel), want)
        require(e == 0, f"the four-step NTT ({kernel}) equals K4's radix-2 at "
                        f"[{batch}, 2^{logn}]")
        err = max(err, e)
        fourstep[f"{kernel} [{batch}, 2^{logn}]"] = dict(
            ms=time_ms(torch, lambda: N.ntt(x, w, tables, mode="fourstep", kernel=kernel),
                       reps=3),
            radix2_ms=time_ms(torch, lambda: N.ntt(x, w, tables, mode="radix2"), reps=3))
        del x, want
    # the committee leg's two passes as int8 GEMMs of the same work, 32 x 32
    # byte products a pair: [2^20, 1024] x [1024, 32] a pass, and its
    # transpose [32, 1024] x [1024, 2^20]; each second operand column-major,
    # the faster of the two orientations kept
    m8 = 1 << 20
    big = torch.randint(-128, 128, (m8, 1024), dtype=torch.int8, device=dev, generator=gen)
    small = torch.randint(-128, 128, (32, 1024), dtype=torch.int8, device=dev, generator=gen)
    orient = {
        "[2^20, 1024] x [1024, 32]": lambda: (torch._int_mm(big, small.t()),
                                              torch._int_mm(big, small.t())),
        "[32, 1024] x [1024, 2^20]": lambda: (torch._int_mm(small, big.t()),
                                              torch._int_mm(small, big.t()))}
    library = {k: time_ms(torch, fn, reps=3) for k, fn in orient.items()}
    lib_shape = min(library, key=library.get)
    library_ms = library[lib_shape]
    del big, small
    torch.cuda.empty_cache()
    leg = short["[1024, 2^10]"]
    log(f"K8: equal to its plain version and K4 on {list(short)}; the four-step NTT equal to "
        f"radix-2 on {list(fourstep)}; " + json.dumps({**short, **fourstep})
        + f"; torch._int_mm on the leg's two passes {json.dumps(library)} ms; before "
        f"{K8_MS_BEFORE} ms")
    return dict(ms=leg["ms"], plain_ms=leg["plain_ms"], bound_ms=leg["bound_ms"],
                bound_by=leg["bound_by"], max_abs_err=err, library_ms=library_ms,
                library_call=f"torch._int_mm twice, int8 stand-ins of the leg's two passes "
                             f"at 32 x 32 byte products a pair, {lib_shape} a pass (the faster "
                             f"orientation; no torch op computes the transform)",
                library_orientations_ms=library,
                ms_before=K8_MS_BEFORE, dense_bound_ms=leg["dense_bound_ms"],
                bound_note="operations: the factored form's byte products on the tensor "
                           "cores (2 x 32 x 32 x 32 u8 multiply-adds a point, 32 x 32 a pair "
                           "of a 32-point DFT), its REDCs and pass A's twiddle product on "
                           "the integer units; bytes: the rows read once and written once",
                shape="[1024, 2^10] (a 2^20 four-step leg)", k4_ms=leg["k4_ms"],
                short=short, fourstep=fourstep)


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

    # the window table: c doublings a window through K2, normalised (one
    # batch inversion), phi by K3
    KL.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    table = M.build_window_table(pts, c, nwin)
    torch.cuda.synchronize()
    table_s = time.perf_counter() - t0
    table_launches = {k: v for k, v in KL.launch_counts().items() if v}
    MK.check_normalised(table)
    require(int((table[:, :, 16:] != 0).any(dim=2).sum()) == nwin * N,
            "every row of the table is finite, Z = 1")
    # the normalisation alone, as the build runs it
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ec.normalize_mont(table[:, :n].reshape(-1, 24))
    torch.cuda.synchronize()
    normalise_s = time.perf_counter() - t0
    g1 = bn254.g1_curve
    p0 = ec.decode_points(pts[:1])[0]
    corner = ec.decode_points(table[[0, 0, nwin - 1, nwin - 1], [0, n, 0, n]])
    shift = g1.mul(p0, 1 << (c * (nwin - 1)))
    require(corner == [p0, g1.mul(p0, glv.lam()), shift, g1.mul(shift, glv.lam())],
            "the window table's rows are 2^(c w) [P ; phi(P)]")
    table_bytes = table.numel() * table.element_size()
    require(table_bytes == M.fixed_table_device_bytes(n, c, nbits), "the table's bytes")

    # the kernel against its plain version, at full size
    KL.reset_launch_counts()
    got = MK.bucket_sums_fixed_aos32(table, digits, negs, c)
    launched = KL.launch_counts()
    require(all(launched[k] == 1 for k in FIXED_K1) and launched["K1c_bucket_walk"] == 0,
            "the fixed form launches K1a, K1_fixed, K1c_fixed_walk and K1d once each")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    counts, bstart, entries_plain = MK.bucket_plan_plain(digits, negs, c, fixed=True)
    plan_plain_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    want = MK.bucket_walk_fixed_plain(table.reshape(-1, 24), entries_plain, bstart)
    torch.cuda.synchronize()
    walk_plain_ms = (time.perf_counter() - t0) * 1e3
    plain_ms = plan_plain_ms + walk_plain_ms
    err = limb_err(F, ec.normalize_std(got), ec.normalize_std(want))
    require(err == 0, "K1's fixed form (the mixed walk) equals its plain version after "
                      "normalization")
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
    walk_ms = time_ms(torch, lambda: MK.bucket_walk_fixed(rows, entries_f, bstart_f), reps=3)
    del entries_f
    P, nblk = MK.plan_blocks(N)
    bounds = k1_bounds(torch, MK, digits, bstart, N, nkeys, nblk, fixed=True)
    total = bound_ms(sum(b[2] for b in bounds.values()), sum(b[3] for b in bounds.values()))
    walk_bound = bound_ms(sum(bounds[k][2] for k in FIXED_K1[2:]),
                          sum(bounds[k][3] for k in FIXED_K1[2:]))
    # the yardstick of PR 6-8: the walk's adds counted as complete adds
    c_ops = bounds["K1c_fixed_walk"][3] // IMAD_PER_MADD * IMAD_PER_PADD
    total_complete = bound_ms(sum(b[2] for b in bounds.values()),
                              sum(b[3] for b in bounds.values())
                              - bounds["K1c_fixed_walk"][3] + c_ops)
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
    k2b1_plain = time_ms(torch, lambda: MK.aggregate_buckets_plain(merged, 1, nb), reps=1)
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

    G, T, L = MK.aggregate_geometry(1, nb)
    rec = dict(
        ms=wrapper_ms, plain_ms=plain_ms, bound_ms=total[0], bound_by=total[1],
        bound_ms_complete_add=total_complete[0], bound_by_complete_add=total_complete[1],
        max_abs_err=max(err, e_err), library_ms=library,
        library_call="torch.argsort(stable=True) on the fixed form's bucket keys",
        shape=f"2^{n.bit_length() - 1} points GLV-expanded to N=2^{N.bit_length() - 1}, "
              f"c={c}, {nwin} windows, random scalars; the plain version at full size",
        note="the fixed-base form's four launches (K1a, the K1_fixed scatter, K1c_fixed_walk, "
             "K1d) together; its launch count is the scatter's; bound_ms counts the walk's "
             "adds as mixed adds (11 products), bound_ms_complete_add as complete adds (12, "
             "the PR 6-8 yardstick)",
        entries=E, adds=E - int((bstart[1:] > bstart[:-1]).sum()),
        plan_ms=plan_ms, walk_ms=walk_ms, plan_plain_ms=plan_plain_ms,
        kernels={k: dict(bound_ms=bounds[k][0], bound_by=bounds[k][1]) for k in FIXED_K1},
        glv_shared_form=dict(ms=glv_ms, plan_ms=glv_plan_ms, walk_ms=glv_walk_ms),
        glv_split=dict(ms=split_ms, device_ms=split_dev_ms, device_ops=split_ops),
        table=dict(seconds=table_s, normalise_seconds=normalise_s, bytes=table_bytes,
                   reference_bytes=M.fixed_table_bytes(n, c, nbits),
                   budget_bytes=M.TABLES.budget, launches=table_launches),
        fold_ms=fold_ms,
        k2b_one_window=dict(ms=k2b1_ms, plain_ms=k2b1_plain, bound_ms=k2b1_bound[0],
                            bound_by=k2b1_bound[1], adds=adds, dependent_adds=chain,
                            geometry=dict(blocks_a_window=G, threads=T, buckets_a_thread=L),
                            max_abs_err=k2b_err),
        msm_seconds=msm_s)
    walk_rec = dict(
        ms=walk_ms, plain_ms=walk_plain_ms, bound_ms=walk_bound[0], bound_by=walk_bound[1],
        max_abs_err=err, library_ms=None,
        shape=rec["shape"], kernels={k: dict(bound_ms=bounds[k][0], bound_by=bounds[k][1])
                                     for k in FIXED_K1[2:]},
        note="the fixed walk's wrapper (bucket_walk_fixed: K1c_fixed_walk and K1d) by CUDA "
             "events; the plain fixed walk beside it; bound: mixed adds")
    log(f"K1-fixed: equal to its plain version at full size; wrapper {wrapper_ms:.3f} ms "
        f"(plain {plain_ms:.0f} ms, bound {total[0]:.3f} ms by {total[1]} with mixed adds, "
        f"{total_complete[0]:.3f} ms counted as complete adds), {E} entries; "
        f"plan (K1a, scan, K1_fixed) {plan_ms:.3f} ms, walk (K1c_fixed, K1d) {walk_ms:.3f} ms "
        f"(bound {walk_bound[0]:.3f}, plain {walk_plain_ms:.0f}); glv shared form on the same "
        f"digits {glv_ms:.3f} ms: plan {glv_plan_ms:.3f}, walk {glv_walk_ms:.3f}")
    log(f"  GLV split: {split_ms:.3f} ms ({split_dev_ms:.3f} ms of device time in "
        f"{split_ops:.0f} device operations); table {table_s:.3f} s (its normalisation "
        f"{normalise_s:.3f} s), {table_bytes} bytes "
        f"(reference count {rec['table']['reference_bytes']}, budget {M.TABLES.budget}), "
        f"launches {json.dumps(table_launches)}; fold {fold_ms:.3f} ms; K2b one window "
        f"{k2b1_ms:.3f} ms (G={G} T={T} L={L}, {chain} dependent adds; bound "
        f"{k2b1_bound[0]:.4f}); MSM s {json.dumps(msm_s)}")
    return rec, walk_rec


def k6_proofs(device: str, seed: int) -> dict:
    """The devices phase's K=6 flex circuit keyed and proved on `device`,
    vanilla and under SPECTRE_MSM_MODE=fixed, with the same blinding seed:
    the two proofs, the kernels the fixed prove launched and the seconds.
    On "cpu" it runs in the worker process, on four torch threads."""
    import torch

    from spectre_tpu_torch.fields import bn254
    from spectre_tpu_torch.ops import kernel_lib as KL, msm as M
    from spectre_tpu_torch.plonk.constraint_system import CircuitConfig
    from spectre_tpu_torch.plonk.keygen import keygen
    from spectre_tpu_torch.plonk.prover import prove
    from spectre_tpu_torch.plonk.srs import SRS
    from spectre_tpu_torch.witness import flex_circuit

    if device == "cpu":
        torch.set_num_threads(min(4, torch.get_num_threads()))
    t0 = time.perf_counter()
    small = CircuitConfig(k=6, num_advice=2, num_lookup_advice=1, num_fixed=1,
                          lookup_bits=4, lookup_tables=("range",))
    fc = flex_circuit(small, seed=seed, num_copies=16)
    s6 = SRS.unsafe_setup(6, device=device)
    pk6 = keygen(s6, small, fc.fixed, fc.selectors, fc.copies, device=device)
    proofs = {}
    for mode in ("vanilla", "fixed"):
        r = random.Random(seed)
        KL.reset_launch_counts()
        with knobs({"SPECTRE_MSM_MODE": mode}):
            proofs[mode] = prove(pk6, s6, fc.assignment, device=device,
                                 blinding_rng=lambda: r.randrange(bn254.R))
    M.clear_tables()
    return dict(proofs=proofs, fixed_launches=KL.launch_counts(),
                seconds=time.perf_counter() - t0)


def g1_decompress_phase(torch, dev, seed: int) -> dict:
    """K6 at the main path's shape, the committee's 512 keys: seeded points
    and two negations (both sign bits for one x), and x = 0 (on the curve,
    y = +-2) with either sign. K6 equals its plain version limb for limb
    (its comparison run is its plain time) and, through
    g1_decompress_batch, the host's one-key-at-a-time decompression (timed
    at 512); an x off the curve raises. At 513 keys, one more point, so that
    a warp is filled in part, the 512 rows stay as they were and the last is
    the square root of its x^3 + 4, the host's y up to sign. Returns K6's
    record."""
    from spectre_tpu_torch.fields import bls12_381 as bls
    from spectre_tpu_torch.ops import field384 as F384

    g1 = bls.g1_curve
    q = g1.mul(bls.G1_GEN, random.Random(seed).randrange(1, bls.R))
    pts = [q]
    while len(pts) < COMMITTEE_KEYS - 3:
        pts.append(g1.add(pts[-1], q))
    keys = [bls.g1_compress(p) for p in pts[:-1]]
    keys += [bls.g1_compress(g1.neg(p)) for p in pts[:2]]
    keys += [bytes([0x80]) + bytes(47), bytes([0xA0]) + bytes(47)]
    more = keys + [bls.g1_compress(pts[-1])]
    require(len(keys) == COMMITTEE_KEYS and {k[0] & 0x20 for k in keys} == {0, 0x20},
            "the keys carry both sign bits")
    ctx = F384.bls_fq_ctx()

    def xm_of(ks):
        return ctx.to_tensor([int.from_bytes(bytes([k[0] & 0x1F]) + k[1:], "big") for k in ks],
                             dev)

    xm = xm_of(keys)
    y, ok = F384.decompress_y(xm)
    (y_plain, ok_plain), plain_ms = timed_once(torch, lambda: F384.decompress_y_plain(xm))
    err = int((F384._limbs16(y) - F384._limbs16(y_plain)).abs().max())
    require(err == 0 and torch.equal(ok, ok_plain), "K6 equals its plain version limb for limb")
    require(bool(ok.all()), "every key's x is on the curve")
    # at 513 keys, so that a warp is filled in part: the first 512 rows as
    # at 512, the last the square root of that key's x^3 + 4 and the host's y
    y_more, ok_more = F384.decompress_y(xm_of(more))
    x_last, y_host = bls.g1_decompress(more[-1])
    y_last = ctx.to_ints(y_more[-1:])[0]
    require(torch.equal(y_more[:-1], y) and torch.equal(ok_more[:-1], ok)
            and int(ok_more[-1]) == 1
            and y_last == pow((int(x_last) ** 3 + 4) % ctx.p, ctx.sqrt_exp, ctx.p)
            and y_last in (int(y_host), ctx.p - int(y_host)),
            f"K6 at {len(more)} keys: the first {len(keys)} rows unchanged, the last the "
            "square root of its x^3 + 4 and the host's y up to sign")
    got = F384.g1_decompress_batch(keys, device=dev)
    t0 = time.perf_counter()
    host = [bls.g1_decompress(k) for k in keys]
    host_ms = (time.perf_counter() - t0) * 1e3
    require(got == [(int(x), int(y)) for x, y in host],
            "g1_decompress_batch on the card equals bls12_381.g1_decompress key for key")
    require(got[-2][0] == 0 and got[-2][1] in (2, ctx.p - 2) and got[-1][1] == ctx.p - got[-2][1],
            "x = 0 decompresses to y = +-2 by its sign bit")
    try:
        F384.g1_decompress_batch([bytes([0x80]) + (1).to_bytes(47, "big")], device=dev)
        refused = False
    except ValueError as e:
        refused = "not on curve" in str(e)
    require(refused, "an x off the curve (x = 1: 5 is no square) raises")
    k6_ms = time_ms(torch, lambda: F384.decompress_y(xm), reps=20)
    # the bound's work, which K6 runs too (the header's chain is
    # window_chain's, tests/test_torch_field384.py): x^3 (a squaring, a
    # multiply), the pow by the shortest window chain found, the check y^2
    # (a squaring)
    e = ctx.sqrt_exp
    chain_sq, chain_mul, window = window_chain(e)
    squarings, multiplies = 1 + chain_sq + 1, 1 + chain_mul
    kernel_products = squarings + multiplies
    n = len(keys)
    bm, by = bound_ms(n * (48 + 48 + 4),
                      n * (squarings * IMAD_PER_SQR384 + multiplies * IMAD_PER_MONT384))
    log(f"K6: equal to its plain version and to the host on {n} keys (both signs, x = 0), "
        f"and at {len(more)} keys to itself and the integer square root; an x off the curve "
        f"raises; {k6_ms:.3f} ms (plain {plain_ms:.1f} ms, "
        f"host loop {host_ms:.1f} ms; bound {bm:.4f} ms by {by}: {squarings} squarings and "
        f"{multiplies} multiplies a key, the pow by a {window}-bit window chain of "
        f"{chain_sq} + {chain_mul}; K6 runs these {kernel_products} products a key)")
    return dict(ms=k6_ms, plain_ms=plain_ms, bound_ms=bm, bound_by=by, max_abs_err=err,
                host_ms=host_ms, shape=f"{n} keys", bound_squarings_a_key=squarings,
                bound_multiplies_a_key=multiplies, chain=dict(
                    window=window, squarings=chain_sq, multiplies=chain_mul),
                library_note="no PyTorch call computes a square root mod p")


def beacon_routes(test_dir: str, spec) -> tuple[int, dict]:
    """A consensus-spec-test fixture as Beacon-API JSON: {path: body} of the
    head root, the bootstrap, the finality update (the flattened shape the
    preprocessor reads: plain headers, the execution payload root and
    branch at the top level, the bits in hex) and the committee update of
    the attested period (its finalized header is the step's attested
    header, its branch the chain's container-depth one), with that
    period. The same committee update also answers the period of the
    finalized header where that differs: the follower's tracker asks for
    the committee update of the finalized period."""
    from spectre_tpu_torch.preprocessor import spec_tests as ST, ssz

    boot = ST.load_snappy_ssz(os.path.join(test_dir, "bootstrap.ssz_snappy"),
                              ssz.light_client_bootstrap(spec))
    update = ST.valid_updates_from_test_path(test_dir, spec)[0]
    root = ST.read_meta(test_dir)["trusted_block_root"]
    exec_type = ssz.execution_payload_header(spec.bytes_per_logs_bloom, spec.max_extra_data_bytes)
    hx = lambda b: "0x" + bytes(b).hex()  # noqa: E731

    def header(h):
        return {"slot": str(h.slot), "proposer_index": str(h.proposer_index),
                "parent_root": hx(h.parent_root), "state_root": hx(h.state_root),
                "body_root": hx(h.body_root)}

    def committee(c):
        return {"pubkeys": [hx(pk) for pk in c.pubkeys], "aggregate_pubkey": hx(c.aggregate_pubkey)}

    agg = update.sync_aggregate
    period = spec.sync_period(update.attested_header.beacon.slot)
    fin_period = spec.sync_period(update.finalized_header.beacon.slot)
    routes = {
        "/eth/v1/beacon/blocks/head/root": {"data": {"root": root}},
        f"/eth/v1/beacon/light_client/bootstrap/{root}": {"data": {
            "header": {"beacon": header(boot.header.beacon)},
            "current_sync_committee": committee(boot.current_sync_committee),
            "current_sync_committee_branch": [hx(b) for b in boot.current_sync_committee_branch]}},
        "/eth/v1/beacon/light_client/finality_update": {"data": {
            "attested_header": header(update.attested_header.beacon),
            "finalized_header": header(update.finalized_header.beacon),
            "finality_branch": [hx(b) for b in update.finality_branch],
            "execution_payload_root": hx(exec_type.hash_tree_root(
                update.finalized_header.execution)),
            "execution_branch": [hx(b) for b in update.finalized_header.execution_branch],
            "sync_aggregate": {
                "sync_committee_bits": hx(ssz.Bitvector(spec.sync_committee_size).encode(
                    agg.sync_committee_bits)),
                "sync_committee_signature": hx(agg.sync_committee_signature)}}},
        f"/eth/v1/beacon/light_client/updates?start_period={period}&count=1": [{"data": {
            "finalized_header": header(update.attested_header.beacon),
            "next_sync_committee": committee(update.next_sync_committee),
            "next_sync_committee_branch": [hx(b) for b in update.next_sync_committee_branch]}}],
    }
    routes.setdefault(f"/eth/v1/beacon/light_client/updates?start_period={fin_period}&count=1",
                      routes[f"/eth/v1/beacon/light_client/updates?start_period={period}&count=1"])
    return period, routes


@contextlib.contextmanager
def beacon_server(routes: dict, answer=None):
    """A Beacon-API server on 127.0.0.1 (a free port) that answers GETs from
    routes, in a thread; yields its URL and is stopped on exit. answer, if
    given, sees each path first: a (status, headers) it returns is sent
    with an empty body in place of the route (a flaky beacon's 503)."""
    import threading
    from http.server import BaseHTTPRequestHandler, HTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            early = answer(self.path) if answer is not None else None
            if early is not None:
                status, headers = early
                self.send_response(status)
                for k, v in headers.items():
                    self.send_header(k, v)
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            body = routes.get(self.path)
            data = b"" if body is None else json.dumps(body).encode()
            self.send_response(404 if body is None else 200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *a):
            pass

    httpd = HTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_port}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join()


def acquire(torch, dev, fixture, test_dir: str) -> dict:
    """Witness acquisition on the fixture that `fixture` (a future: the
    worker process's generate_spec_test) writes into test_dir: the fixture
    served as Beacon-API JSON on 127.0.0.1, the port's BeaconClient fetches
    the head root, the bootstrap, the finality update and the committee
    updates of the attested period; step_args_from_finality_update (its
    pubkeys through K6) and rotation_args_from_update make the args, with
    the domain from ssz.compute_domain over the fixture's
    genesis_validators_root. The spec-test loader must give the same args,
    every branch verifies, and the bootstrap gives the contract's genesis
    (period, committee Poseidon). The launch counts are set to 0 before and
    read after: K6 must have run."""
    from spectre_tpu_torch import spec as SPEC
    from spectre_tpu_torch.ops import kernel_lib as KL
    from spectre_tpu_torch.preprocessor import (BeaconClient, rotation_args_from_update,
                                                spec_tests as ST, ssz,
                                                step_args_from_finality_update)

    spec, secs = SPEC.TESTNET, {}
    t0 = time.perf_counter()
    _, secs["fixture"] = fixture.result()
    secs["fixture_wait"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    period, routes = beacon_routes(test_dir, spec)
    gvr = bytes.fromhex(ST.read_meta(test_dir)["genesis_validators_root"][2:])
    domain = ssz.compute_domain(ssz.DOMAIN_SYNC_COMMITTEE, ST.CAPELLA_FORK_VERSION[spec.name], gvr)
    secs["serve_json"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    KL.reset_launch_counts()
    t_path = time.perf_counter()
    with beacon_server(routes) as url:
        client = BeaconClient(url, timeout=30.0)
        root = client.head_block_root()
        bootstrap = client.bootstrap(root)
        finality = client.finality_update()
        attested_period = client.sync_period(spec, int(finality["attested_header"]["slot"]))
        committee_update = client.committee_updates(attested_period)[0]
    secs["fetch"] = time.perf_counter() - t_path
    t0 = time.perf_counter()
    step_args = step_args_from_finality_update(
        finality, bootstrap["current_sync_committee"]["pubkeys"], domain, spec, device=dev)
    secs["step_args"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rotation_args = rotation_args_from_update(committee_update, spec)
    secs["rotation_args"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = ST.read_test_files_and_gen_witness(test_dir, spec, device=dev)
    secs["loader"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    genesis = ST.get_initial_sync_committee_poseidon(test_dir, spec, device=dev)
    secs["genesis"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    secs["path"] = time.perf_counter() - t_path
    launches = KL.launch_counts()
    require(attested_period == period and len(step_args.pubkeys_uncompressed) == COMMITTEE_KEYS,
            "the committee update of the attested period, 512 pubkeys")
    require(loaded == (step_args, rotation_args),
            "read_test_files_and_gen_witness gives the args fetched over HTTP")
    ST.verify_witness_branches(spec, step_args, rotation_args)
    require(rotation_args.finalized_header == step_args.attested_header
            and ST.update_has_finality(step_args),
            "the rotation's finalized header is the step's attested header; the update is final")
    require(genesis[0] == spec.sync_period(step_args.attested_header.slot),
            "the bootstrap's period is the attested slot's")
    require(launches["K6_g1_decompress"] == 3, "K6 launched once a decompression (the "
            "preprocessor, the loader, the bootstrap's Poseidon)")
    log(f"acquire: the fixture (seed-made in the worker process, {secs['fixture']:.1f} s) over "
        f"HTTP at {url}; args equal the loader's, branches verify, signature verified; "
        f"genesis period {genesis[0]}, committee Poseidon {hex(genesis[1])}; seconds "
        + json.dumps({k: round(v, 3) for k, v in secs.items()})
        + "; launches " + json.dumps({k: v for k, v in launches.items() if v}))
    return dict(step_args=step_args, rotation_args=rotation_args, genesis=genesis,
                seconds=secs, launches=launches, routes=routes, root=root, period=period,
                domain=domain)


def timed_call(fn, *args):
    """(fn(*args), its seconds): a job of the worker process."""
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


def circuit_path(torch, dev, seed: int, circuit, k: int, keyed: dict, prove_args, shape,
                 describe, flip: int, check_args=None, modes=(), transcript_cls=None) -> dict:
    """One application circuit at its pinned testnet shape, through the
    entry points a user calls, under the key the prover service's boot made
    (keyed: its pk, SRS, the default args it was made from and the boot's
    keygen launches; the boot checked the key's witness against the
    tracked pinning), proving what a light client serves: the witness of
    prove_args (acquired from beacon data), its pinning check, prove and
    verify under that key. shape(cfg, args) is the tuple the pinned shape
    must give, with describe as its name; flip, the instance flipped for
    the negative verify; check_args(spec, args), an extra check of
    prove_args; modes, the names of the knob sets (MODES) whose proofs of
    the same witness, key and blinding seed must equal the default one;
    transcript_cls, the
    prove's and the verifier's transcript (default Blake2b). Returns the
    phase seconds, the prove's phases, peak memory and launch counts, per
    mode the same of its prove, and the proof with its vk, SRS, instances
    and args."""
    from spectre_tpu_torch import spec as SPEC
    from spectre_tpu_torch.fields import bn254
    from spectre_tpu_torch.ops import kernel_lib as KL, msm as M, ntt as N
    from spectre_tpu_torch.plonk.prover import PhaseTimer
    from spectre_tpu_torch.plonk.transcript import Blake2bTranscript

    spec, phases, name = SPEC.TESTNET, {}, circuit.name
    transcript_cls = transcript_cls or Blake2bTranscript
    require(os.path.exists(circuit.pinning_path(spec, k)),
            f"the tracked {name} pinning file is present")
    pk, srs, key_args = keyed["pk"], keyed["srs"], keyed["args"]
    cfg = pk.vk.config
    require(cfg == circuit.pinning(spec, k).config and shape(cfg, key_args),
            f"the boot's {name} key has the pinned shape ({describe})")
    log(f"{name}: {describe}, k={cfg.k} advice={cfg.num_advice} lookup={cfg.lookup_tables} "
        f"lookup_bits={cfg.lookup_bits} fixed={cfg.num_fixed} sha_slots={cfg.num_sha_slots}; "
        f"keyed by the prover service's boot on the default args ({keyed['seconds']:.1f} s, "
        f"their witness checked against the pinning), the SRS k={srs.k} of its params_dir")
    keygen_counts = keyed["keygen_launches"]

    # the acquired args: their witness at the same pinning, under that key
    args = prove_args
    t0 = time.perf_counter()
    ctx = circuit.build_context(args, spec, device=dev)
    phases["witness"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    require(circuit.pinning(spec, k, ctx).config == cfg and shape(cfg, args),
            f"the acquired args' {name} witness has the pinned shape")
    phases["witness_pinning"] = time.perf_counter() - t0
    # its layout (memoized on the context; keygen laid out the key's), apart
    # from the prove's seconds
    t0 = time.perf_counter()
    ctx.layout(cfg)
    phases["layout"] = time.perf_counter() - t0
    key_instances = circuit.get_instances(key_args, spec)
    require(circuit.get_instances(args, spec) != key_instances,
            "the acquired args' instances differ from the default args'")
    log(f"  the acquired args' witness: {phases['witness']:.1f} s, break points equal the "
        f"pinning's; {json.dumps(ctx.stats())}")
    if check_args is not None:
        check_args(spec, args)

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
    log(f"  prove phases (s): " + json.dumps({key: round(v, 3)
                                             for key, v in timer.seconds.items()}))
    log(f"  transcript {transcript_cls.__name__}; "
        f"vk digest {pk.vk.digest().hex()}")
    log(f"  proof of the acquired args {len(proof)} bytes, verified under the key of the "
        f"default args, flipped instance rejected; instances {[hex(v) for v in instances]} "
        f"(the default args': {[hex(v) for v in key_instances]}); peak device memory "
        f"{peak:.1f} GiB")
    log(f"  launches: keygen {json.dumps(keygen_counts)}, prove {json.dumps(prove_counts)}")

    by_mode = {}
    for mode in modes:
        M.clear_tables()
        N.clear_tables()
        torch.cuda.empty_cache()
        timer_m = PhaseTimer(torch.device(dev))
        r = random.Random(seed)
        degraded = M.COUNTERS["msm_fixed_degraded"]
        torch.cuda.synchronize()
        KL.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with knobs(MODES[mode]["env"]):
            proof_m = circuit.prove(pk, srs, args, spec, device=dev, ctx=ctx,
                                    blinding_rng=lambda: r.randrange(bn254.R), timer=timer_m,
                                    transcript=transcript_cls())
            torch.cuda.synchronize()
            prove_s = time.perf_counter() - t0
            counts_m = KL.launch_counts()
            peak_m = torch.cuda.max_memory_allocated() / 2 ** 30
            table_bytes = {"msm": M.lru_stats()["bytes"], "ntt": N.lru_stats()["bytes"]}
            require(proof_m == proof,
                    f"the {mode} {name} proof equals the default proof byte for byte")
            require(circuit.verify(pk.vk, srs, instances, proof_m, device=dev,
                                   transcript_cls=transcript_cls),
                    f"the {mode} {name} proof verifies")
        require(M.COUNTERS["msm_fixed_degraded"] == degraded,
                f"no fixed-base degrade in the {mode} prove")
        for kernel in MODES[mode]["launched"]:
            require(counts_m[kernel] > 0, f"{kernel} launched in the {mode} {name} prove")
        for kernel in MODES[mode]["absent"]:
            require(counts_m[kernel] == 0, f"{kernel} not launched in the {mode} {name} prove")
        if mode == "fixed":
            require(counts_m["K1c_fixed_walk"] == counts_m["K1_fixed"],
                    f"the fixed walk launched once a fixed-form MSM in the {name} prove")
        log(f"  {mode}: prove {prove_s:.3f} s, equal to the default proof, verified; phases "
            + json.dumps({key: round(v, 3) for key, v in timer_m.seconds.items()})
            + f"; peak {peak_m:.1f} GiB, tables {json.dumps(table_bytes)} bytes; launches "
            + json.dumps({key: v for key, v in counts_m.items() if v}))
        by_mode[mode] = dict(prove_s=prove_s, prove_phases=timer_m.seconds, peak_gib=peak_m,
                             table_bytes=table_bytes, launches=counts_m)
    M.clear_tables()
    N.clear_tables()
    return dict(phases=phases, prove_phases=timer.seconds,
                peak_gib=peak, keygen_launches=keygen_counts, prove_launches=prove_counts,
                modes=by_mode, proof=proof, vk=pk.vk, srs=srs, instances=instances, args=args,
                key_instances=key_instances, ctx=ctx)


def committee_path(torch, dev, seed: int, keyed: dict, acquired) -> dict:
    """The CommitteeUpdateCircuit at build/committee_update_testnet_18
    .pinning.json: 512 pubkeys, k=18, 22 advice columns, 2070 SHA slots,
    under the boot's key (keyed), proving the acquired rotation args under
    the Poseidon transcript (the proof stage 2 aggregates)."""
    from spectre_tpu_torch.models import CommitteeUpdateCircuit
    from spectre_tpu_torch.plonk.transcript import PoseidonTranscript

    return circuit_path(
        torch, dev, seed, CommitteeUpdateCircuit, COMMITTEE_K, keyed,
        acquired["rotation_args"],
        lambda cfg, a: (cfg.k, cfg.num_advice, cfg.num_sha_slots,
                        len(a.pubkeys_compressed)) == (COMMITTEE_K, 22, 2070, 512),
        "512 pubkeys, k=18, 22 advice, 2070 SHA slots", flip=0, modes=COMMITTEE_MODES,
        transcript_cls=PoseidonTranscript)


def step_path(torch, dev, seed: int, keyed: dict, acquired) -> dict:
    """The StepCircuit at build/sync_step_testnet_21.pinning.json: 512
    pubkeys, k=21, 16 advice and 3 lookup columns, lookup_bits 18, under
    the boot's key (keyed), proving the acquired step args under the
    Poseidon transcript (the proof stage 2 aggregates); a copy of the
    acquired args with a wrong signature must fail the native pre-check."""
    from spectre_tpu_torch.fields import bls12_381 as bls
    from spectre_tpu_torch.models import StepCircuit
    from spectre_tpu_torch.plonk.transcript import PoseidonTranscript

    def wrong_signature_refused(spec, args):
        bad = dataclasses.replace(
            args, signature_compressed=bls.g2_compress(bls.g2_curve.mul(bls.G2_GEN, 123)))
        try:
            StepCircuit.build_context(bad, spec, device=dev)
            refused = False
        except ValueError as e:
            refused = "aggregate signature invalid" in str(e)
        require(refused, "args with a wrong signature fail the native pre-check")
        log("  a wrong signature fails the native pre-check")

    return circuit_path(
        torch, dev, seed, StepCircuit, STEP_K, keyed, acquired["step_args"],
        lambda cfg, a: (cfg.k, cfg.num_advice, cfg.num_lookup_advice, cfg.lookup_bits,
                        len(a.pubkeys_uncompressed)) == (STEP_K, 16, 3, 18, 512),
        "512 pubkeys, k=21, 16 advice, 3 lookup columns, lookup_bits 18", flip=1,
        check_args=wrong_signature_refused, modes=STEP_MODES, transcript_cls=PoseidonTranscript)


MESH_GATES = ("SPECTRE_SHARD_MSM_MIN_LOGN", "SPECTRE_SHARD_NTT_MIN_LOGN",
              "SPECTRE_SHARD_QUOTIENT_MIN_LOGN")
MESH_KERNELS = ("K1a_bucket_count", "K1b_bucket_scatter", "K1c_bucket_walk",
                "K1d_bucket_pieces", "K2b_bucket_aggregate", "K3_mont_mul", "K4_ntt")


def mesh_plan(torch):
    """(the 2x2 plan the mesh phase proves on, what it is): four virtual
    shards of cuda:0 on a one-card machine, else the default mesh of the
    cards."""
    from spectre_tpu_torch.parallel import default_mesh, make_mesh, plan_for_mesh

    if torch.cuda.device_count() == 1:
        dev = torch.device("cuda", 0)
        return (plan_for_mesh(make_mesh(devices=[dev] * 4, data_axis=2)),
                "four virtual shards of cuda:0 (one card)")
    return plan_for_mesh(default_mesh()), f"the default mesh of {torch.cuda.device_count()} cards"


def mesh_k6(torch, dev, seed: int) -> dict:
    """The K=6 readiness circuit with the mesh gates lowered to 2^5, proved
    on 2x1 and 4x2 plans of `dev` under glv+signed and fixed: {(shape,
    mode): proof equal to the unsharded proof}, and the unsharded proof's
    seconds."""
    from spectre_tpu_torch.fields import bn254
    from spectre_tpu_torch.ops import msm as M
    from spectre_tpu_torch.parallel import make_mesh, plan_for_mesh
    from spectre_tpu_torch.plonk.backend import TorchBackend
    from spectre_tpu_torch.plonk.prover import prove
    from spectre_tpu_torch.plonk.verifier import verify
    from spectre_tpu_torch.prover_service.selfverify import _tiny_setup

    pk, srs, asg, out = _tiny_setup(str(dev))
    r = random.Random(seed)
    one = prove(pk, srs, asg, device=dev, blinding_rng=lambda: r.randrange(bn254.R))
    equal = {}
    for shape in ((2, 1), (4, 2)):
        plan = plan_for_mesh(make_mesh(devices=[dev] * (shape[0] * shape[1]),
                                       data_axis=shape[0]))
        for mode in ("glv+signed", "fixed"):
            r = random.Random(seed)
            with knobs({"SPECTRE_MSM_MODE": mode, **{g: "5" for g in MESH_GATES}}):
                plan.reset_stats()
                proof = prove(pk, srs, asg, TorchBackend(dev, plan=plan),
                              blinding_rng=lambda: r.randrange(bn254.R))
                stats = plan.stats()
            require(stats["sharded_msm"] > 0 and stats["quotient"] > 0,
                    f"the K=6 prove on the {shape[0]}x{shape[1]} plan sharded")
            equal[f"{shape[0]}x{shape[1]}/{mode}"] = proof == one
            require(proof == one, f"the K=6 proof on a {shape[0]}x{shape[1]} plan under "
                                  f"{mode} equals the unsharded proof")
            require(verify(pk.vk, srs, [[out]], proof), "the K=6 mesh proof verifies")
        plan.clear()
    M.clear_tables()
    return equal


def mesh_path(torch, dev, seed: int, step: dict, keyed: dict) -> dict:
    """The step's stage 1 on the 2x2 plan (`mesh_plan`), under the step
    phase's key (keyed), witness and blinding seed: the proof must equal
    the step phase's vanilla proof. Then `mesh_k6`. Returns the prove's
    seconds and phases, its peak, the plan's stats and the launches."""
    from spectre_tpu_torch.fields import bn254
    from spectre_tpu_torch.models import StepCircuit
    from spectre_tpu_torch.ops import kernel_lib as KL, msm as M, ntt as N
    from spectre_tpu_torch.parallel import sharded_quotient as SQ
    from spectre_tpu_torch.plonk.backend import TorchBackend
    from spectre_tpu_torch.plonk.prover import PhaseTimer, prove
    from spectre_tpu_torch.plonk.transcript import PoseidonTranscript

    plan, how = mesh_plan(torch)
    pk, srs = keyed["pk"], keyed["srs"]
    ctx = step.pop("ctx")
    asg = ctx.assignment(pk.vk.config)
    del ctx
    log(f"mesh: plan {json.dumps(plan.describe()['mesh'])} over "
        f"{[str(d) for d in plan.mesh.flat]}: {how}")
    M.clear_tables()
    N.clear_tables()
    plan.reset_stats()
    degraded = (M.COUNTERS["msm_fixed_degraded"], SQ.COUNTERS["quotient_sharded_degraded"])
    timer = PhaseTimer(torch.device(dev))
    r = random.Random(seed)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    KL.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    proof = prove(pk, srs, asg, TorchBackend(dev, plan=plan), transcript=PoseidonTranscript(),
                  blinding_rng=lambda: r.randrange(bn254.R), timer=timer)
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t0
    counts = KL.launch_counts()
    stats = plan.stats()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del asg
    require(proof == step["proof"], "the step proof on the 2x2 plan equals the unsharded proof "
                                    "byte for byte")
    require(StepCircuit.verify(pk.vk, srs, step["instances"], proof, device=dev,
                               transcript_cls=PoseidonTranscript),
            "the step proof of the 2x2 plan verifies")
    for what in ("sharded_msm", "batch_msm", "sharded_ntt", "quotient"):
        require(stats[what] > 0, f"the mesh prove ran a {what}")
    require(degraded == (M.COUNTERS["msm_fixed_degraded"],
                         SQ.COUNTERS["quotient_sharded_degraded"]),
            "no degrade counter moved in the mesh prove")
    for name in MESH_KERNELS:
        require(counts[name] >= plan.n_devices, f"{name} launched on every shard")
    require(counts["K1c_bucket_walk"] >= stats["sharded_msm"] * plan.n_devices,
            "K1 launched on every shard of every sharded MSM")
    require(counts["K4_ntt"] >= stats["sharded_ntt"] * plan.ndata,
            "K4 launched on every data shard of every sharded NTT")
    plan.clear()
    M.clear_tables()
    N.clear_tables()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    k6 = mesh_k6(torch, dev, seed)
    k6_s = time.perf_counter() - t0
    unsharded = step["prove_phases"]
    log(f"  prove {prove_s:.3f} s on the plan, equal to the step's proof, verified; phases (s) "
        + json.dumps({key: [round(v, 3), round(unsharded.get(key, 0.0), 3)]
                      for key, v in timer.seconds.items()})
        + f" [mesh, unsharded]; unsharded prove {step['phases']['prove']:.3f} s; peak device "
          f"memory {peak:.1f} GiB (unsharded {step['peak_gib']:.1f}); plan stats "
        + json.dumps(stats))
    log(f"  launches: {json.dumps({k: v for k, v in counts.items() if v})}")
    log(f"  K=6 with the gates at 2^5 on {dev}: {json.dumps(k6)} ({k6_s:.1f} s)")
    return dict(prove_s=prove_s, prove_phases=timer.seconds, peak_gib=peak, stats=stats,
                launches=counts, k6=k6, k6_s=k6_s, how=how)


def boot_service(torch, dev, committee_args, step_args, params_dir: str) -> dict:
    """The prover service's state on the card at the testnet shapes:
    ProverState(TESTNET, k_step=21, k_committee=18, compress=False), its SRS
    set up in params_dir (a temporary directory; no key file is written),
    keyed on the default args the worker process made (committee_args and
    step_args: their futures), its tiny self-check proved and verified on
    the card. This is the keying of the committee and step phases. Returns
    the state, its boot seconds and each key's keygen launches."""
    from spectre_tpu_torch import spec as SPEC
    from spectre_tpu_torch.observability import compilelog
    from spectre_tpu_torch.ops import kernel_lib as KL
    from spectre_tpu_torch.prover_service.state import ProverState

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = ProverState(SPEC.TESTNET, STEP_K, COMMITTEE_K, device=dev, params_dir=params_dir,
                        key_args={"step": lambda: step_args.result()[0],
                                  "committee": lambda: committee_args.result()[0]})
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    by_entry = compilelog.launches_by_entry()
    keygen = {kind: {k: by_entry.get(f"boot/{kind}_pk", {}).get(k, 0) for k in KL.KERNELS}
              for kind in ("step", "committee")}
    check = state.self_check.snapshot()
    require(check["ok"], f"the self-check's K=6 circuit proved and verified on the card ({check})")
    require(not any(os.path.exists(c.pk_path(SPEC.TESTNET, k, params_dir))
                    for c, k in ((state.step_circuit, STEP_K),
                                 (state.committee_circuit, COMMITTEE_K))),
            "the boot wrote no key file")
    log(f"boot: ProverState on {state.device} in {seconds:.1f} s; "
        + json.dumps({k: round(v, 3) for k, v in state.boot_seconds.items()})
        + f"; self-check {check}; keygen launches step "
        + json.dumps({k: v for k, v in keygen["step"].items() if v}) + ", committee "
        + json.dumps({k: v for k, v in keygen["committee"].items() if v}))

    def keyed(kind: str, pk, k: int, args_from) -> dict:
        return dict(pk=pk, srs=state.srs[k], args=args_from.result()[0],
                    keygen_launches=keygen[kind], seconds=state.boot_seconds[f"{kind}_pk"])

    return dict(state=state, seconds=seconds,
                committee=keyed("committee", state.committee_pk, COMMITTEE_K, committee_args),
                step=keyed("step", state.step_pk, STEP_K, step_args))


SERVICE_KERNELS = (*SHARED_K1, "K2_padd", "K2b_bucket_aggregate", "K3_mont_mul", "K4_ntt",
                   "K6_g1_decompress")


def service_path(torch, dev, boot: dict, acquired: dict, journal_dir: str,
                 announce: str) -> dict:
    """The prover service on the card: rpc.serve over the boot's state (its
    journal in journal_dir, replica id "card", announcing itself every
    second to the farm head at `announce`, which comes up in the farm
    phase: the announces before it are refused and counted), a request made
    from the Beacon-API JSON the acquire phase served, sent through the
    port's ProverClient: the blocking genEvmProof_SyncStepCompressed (the
    finality update, the bootstrap's compressed pubkeys, the domain).
    /healthz answers 503 until a fresh self-check has passed on the card,
    then 200; the answer's instances equal get_instances of the acquired
    args, its proof verifies under the state's vk and a flipped instance
    does not, its calldata decodes back; a resubmit is a dedup hit (the
    same job id, K1 not launched); a step request with a wrong signature
    answers -32000; the job's manifest shows its phases and 0 kernel
    builds; /metrics exports the prove-latency histogram with count 1 and
    the kernels' launch counters. The launch counts are set to 0 before the
    request and read after. The server stays up (returned as "server") for
    the farm phase, which submits the committee update."""
    from spectre_tpu_torch import spec as SPEC
    from spectre_tpu_torch.fields import bls12_381 as bls
    from spectre_tpu_torch.models import StepCircuit
    from spectre_tpu_torch.ops import kernel_lib as KL
    from spectre_tpu_torch.prover_service import calldata, rpc, selfverify
    from spectre_tpu_torch.prover_service.rpc_client import ProverClient, RpcError

    spec, state, routes = SPEC.TESTNET, boot["state"], acquired["routes"]
    finality = routes["/eth/v1/beacon/light_client/finality_update"]["data"]
    bootstrap = routes[f"/eth/v1/beacon/light_client/bootstrap/{acquired['root']}"]["data"]
    pubkeys = bootstrap["current_sync_committee"]["pubkeys"]
    domain = "0x" + acquired["domain"].hex()
    want = StepCircuit.get_instances(acquired["step_args"], spec)

    server = rpc.serve(state, port=0, background=True, journal_dir=journal_dir,
                       scrub_interval=0, replica_id="card", announce=announce,
                       announce_interval=1.0)
    out = {"server": server}
    try:
        client = ProverClient(f"http://127.0.0.1:{server.server_address[1]}/rpc", timeout=900)
        out["client"] = client
        state.self_check = selfverify.SelfCheck(device=dev)
        status_before, _ = client.healthz()
        t0 = time.perf_counter()
        require(state.self_check.run(), "a fresh self-check passes on the card")
        out["self_check_s"] = time.perf_counter() - t0
        status_after, health = client.healthz()
        require((status_before, status_after) == (503, 200) and health["self_check"]["ok"],
                f"/healthz is 503 before the self-check, 200 after ({status_before}, "
                f"{status_after})")

        torch.cuda.synchronize()
        KL.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        step_res = client.gen_evm_proof_sync_step_compressed(finality, pubkeys, domain)
        out["step_request_s"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = KL.launch_counts()
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30

        proof, inst = selfverify.decode_result(step_res)
        require(inst == want, "the step answer's instances equal get_instances of the "
                              "acquired args")
        require(state.verify_proof("step", proof, inst), "the step proof verifies under the "
                                                         "state's vk")
        flipped = list(inst)
        flipped[0] ^= 1
        require(not state.verify_proof("step", proof, flipped),
                "the step proof with a flipped instance is rejected")
        require(calldata.decode_calldata(bytes.fromhex(step_res["calldata"][2:]), len(inst))
                == (inst, proof), "the step calldata decodes to the instances and proof")
        job = dict(proof_bytes=len(proof), instances=len(inst))

        # a resubmit of the same params: the same job, nothing proved again
        k1 = KL.launch_counts()["K1c_bucket_walk"]
        step_jid = client.submit_sync_step(finality, pubkeys, domain)
        status = client.proof_status(step_jid)
        require(status["status"] == "done" and client.proof_result(step_jid) == step_res
                and KL.launch_counts()["K1c_bucket_walk"] == k1,
                "a resubmit of the step's params is a dedup hit (its job, K1 not launched)")

        bad_sig = "0x" + bls.g2_compress(bls.g2_curve.mul(bls.G2_GEN, 123)).hex()
        bad = dict(finality, sync_aggregate=dict(finality["sync_aggregate"],
                                                 sync_committee_signature=bad_sig))
        try:
            client.gen_evm_proof_sync_step_compressed(bad, pubkeys, domain)
            rejected = None
        except RpcError as e:
            rejected = (e.code, e.message, e.replica_id)
        require(rejected == (rpc.WITNESS_REJECTED,
                             "witness rejected: aggregate signature does not verify", "card"),
                f"a wrong signature answers -32000 witness rejected, from replica card "
                f"({rejected})")
        launches_all = KL.launch_counts()

        man = client.get_manifest(step_jid)
        ph = man["phase_seconds"]
        require({"job/preprocess", "prove/witness", "prove/layout", "prove/snark",
                 "prove/self_verify"} <= set(ph) and man["kernels"]["builds"] == 0,
                "the step job's manifest shows its phases and 0 kernel builds")
        job.update(queue_wait_s=man["queue_wait_s"], prove_s=man["prove_s"],
                   preprocess_s=ph["job/preprocess"], witness_s=ph["prove/witness"],
                   layout_s=ph["prove/layout"], snark_s=ph["prove/snark"],
                   verify_s=ph["prove/self_verify"],
                   snark_phases={k[len("snark/"):]: v for k, v in ph.items()
                                 if k.startswith("snark/")},
                   launches=man["kernels"]["launches"])
        text = client.metrics_text()
        require("spectre_prove_latency_seconds_count 1" in text,
                "/metrics: the prove-latency histogram counts the proof")
        for name in SERVICE_KERNELS:
            require(f'spectre_kernel_launches_total{{kernel="{name}"}} {launches_all[name]}'
                    in text, f"/metrics exports {name}'s launch counter")
        for name in (*PROVE_KERNELS, "K6_g1_decompress"):
            require(launches[name] > 0, f"{name} launched by the service's request")
        out.update(jobs={"step": job}, launches=launches, step_result=step_res,
                   step_params={"light_client_finality_update": finality,
                                "pubkeys": pubkeys, "domain": domain})
    except BaseException:
        stop_server(server, state)
        raise
    line = {"boot_s": boot["seconds"], "boot": boot["state"].boot_seconds,
            **{k: v for k, v in out.items()
               if k not in ("server", "client", "step_params", "step_result")},
            "launches": {k: out["launches"][k] for k in SERVICE_KERNELS}}
    log("service: " + json.dumps(line))
    return out


def stop_server(server, state) -> None:
    """Shut a background rpc.serve server down: its announce loop, its HTTP
    thread and its queue's workers."""
    stop = getattr(server, "_announce_stop", None)
    if stop is not None:
        stop.set()
    server.shutdown()
    server.server_close()
    if getattr(state, "jobs", None) is not None:
        state.jobs.stop()


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


FARM_LEASE_S = 15.0
FARM_DRILL_REQUESTS = 3000


def farm_path(torch, dev, boot: dict, acquired: dict, committee: dict, service: dict,
              farm_dir: str, head_port: int, seed: int) -> dict:
    """The proof farm, the follower, the gateway and loadgen on the card,
    over the service phase's server (replica "card"): a head server
    (rpc.serve(head_state, dispatcher=d, follower=f, gateway=True,
    replica_id="head") on head_port) whose Dispatcher fronts the service's
    server by two HttpReplicas ("card-a", "card-b"), cross-verifies on the
    boot's state and holds a lease of FARM_LEASE_S, shorter than the
    committee prove and longer than any gap between two renewals. The
    service's server joins by announce (a join in the member journal).
    Under SPECTRE_FAULT_PLAN=replica.dispatch:crash:1 the Follower polls the
    beacon JSON (BeaconClient on beacon_server(routes), the bootstrap's
    pubkeys and the acquired domain): its first poll yields the committee
    update of its period and the step of the finalized slot; the committee
    proves on the card after exactly one lease takeover, the step is a
    dedup hit on the service's server (its params are the service phase's),
    and the head cross-verifies both before the follower stores them. The
    stored committee update is held as the service held its answers; the
    gateway serves it over HTTP (ETag the store's digest, body the
    canonical body, 304 on revalidation); a loadgen HttpTarget drill reads
    it with 0 errors and launches no kernel; /metrics on the head exports
    the dispatcher, replica, follower and gateway families. The launch
    counts are set to 0 before the follower's first poll and read when the
    chain is stored."""
    from spectre_tpu_torch import spec as SPEC
    from spectre_tpu_torch.follower import Follower
    from spectre_tpu_torch.gateway import canonical_update_body
    from spectre_tpu_torch.loadgen import HttpTarget, run_drill
    from spectre_tpu_torch.models import CommitteeUpdateCircuit
    from spectre_tpu_torch.ops import kernel_lib as KL
    from spectre_tpu_torch.preprocessor import BeaconClient
    from spectre_tpu_torch.prover_service import calldata, rpc, selfverify
    from spectre_tpu_torch.prover_service.dispatcher import Dispatcher, HttpReplica
    from spectre_tpu_torch.prover_service.jobs import ensure_jobs, witness_digest
    from spectre_tpu_torch.prover_service.rpc_client import ProverClient
    from spectre_tpu_torch.utils import faults
    from spectre_tpu_torch.utils.health import HEALTH

    spec, state, routes = SPEC.TESTNET, boot["state"], acquired["routes"]
    service_url = f"http://127.0.0.1:{service['server'].server_address[1]}"
    head_url = f"http://127.0.0.1:{head_port}"
    want = CommitteeUpdateCircuit.get_instances(acquired["rotation_args"], spec)
    secs, out = {}, {}

    class TimedReplica(HttpReplica):
        """An HttpReplica that records when its lease is renewed (each
        answered status poll renews it)."""
        renewals: list = []

        def prove(self, method, params, heartbeat=None):
            stamps = [time.perf_counter()]
            TimedReplica.renewals.append(stamps)

            def renew():
                stamps.append(time.perf_counter())
                if heartbeat is not None:
                    heartbeat()
            result = super().prove(method, params, heartbeat=renew)
            stamps.append(time.perf_counter())
            return result

    # the prove's own heartbeats (the state's phase boundaries), as a
    # LocalReplica's lease would see them
    phase_stamps: list = []
    orig_prove_committee = state.prove_committee

    def prove_committee(args, heartbeat=None):
        phase_stamps.append(time.perf_counter())

        def stamp():
            phase_stamps.append(time.perf_counter())
            if heartbeat is not None:
                heartbeat()
        try:
            return orig_prove_committee(args, heartbeat=stamp)
        finally:
            phase_stamps.append(time.perf_counter())

    state.prove_committee = prove_committee
    # the head's state is the boot state's attributes (its keys, device,
    # self-check) over a queue of its own: it proves nothing, its queue's
    # runner is the dispatcher, which cross-verifies on the boot's state
    head_state = types.SimpleNamespace(**{**vars(state), "jobs": None, "params_dir": farm_dir})
    d = Dispatcher([TimedReplica(rid, ProverClient(service_url + "/rpc", timeout=60),
                                 poll_s=0.5) for rid in ("card-a", "card-b")],
                   journal_dir=farm_dir, lease_s=FARM_LEASE_S, verify_state=state, poll_s=0.05)
    jobs = ensure_jobs(head_state, journal_dir=farm_dir, runner=d, scrub_interval=0)
    counters0 = dict(HEALTH.snapshot()["counters"])
    with beacon_server(routes) as beacon_url:
        fol = Follower(spec, BeaconClient(beacon_url, timeout=30.0), jobs, directory=farm_dir,
                       pubkeys=service["step_params"]["pubkeys"], domain=acquired["domain"])
        head = rpc.serve(head_state, port=head_port, background=True, follower=fol,
                         dispatcher=d, gateway=True, replica_id="head")
        try:
            hc = ProverClient(head_url + "/rpc", timeout=60)
            t0 = time.perf_counter()
            while d.snapshot()["members"] < 3:
                require(time.perf_counter() - t0 < 30, "the service's server joins the head by "
                                                       "announce within 30 s")
                time.sleep(0.1)
            secs["join_wait"] = time.perf_counter() - t0
            joined = {r["replica_id"]: r for r in d.snapshot()["replicas"]}["card"]
            require(joined["dynamic"] and joined["capabilities"]["device"] == "cuda"
                    and joined["capabilities"]["max_k"] == STEP_K,
                    f"the announced replica's capability record names cuda and max_k "
                    f"{STEP_K} ({joined['capabilities']})")

            os.environ[faults.ENV_VAR] = "replica.dispatch:crash:1"
            torch.cuda.synchronize()
            KL.reset_launch_counts()
            t_path = time.perf_counter()
            t0 = time.perf_counter()
            fol.run_once()
            secs["poll"] = time.perf_counter() - t0
            fin_slot = fol.tracker.last_finalized_slot
            period = spec.sync_period(fin_slot)
            items = {k: v["item"] for k, v in fol.scheduler._pending.items()}
            require(sorted(items) == [("committee", period), ("step", fin_slot)],
                    f"the first poll yields the committee update of period {period} and the "
                    f"step of slot {fin_slot} ({sorted(items)})")
            step_item = items[("step", fin_slot)]
            require(witness_digest(step_item.method, step_item.params)
                    == witness_digest(rpc.RPC_METHOD_STEP, service["step_params"]),
                    "the follower's step params are the service phase's (a dedup hit)")
            while not (fol.store.has_committee(period) and fol.store.has_step(fin_slot)):
                require(time.perf_counter() - t_path < 600, "the farm stores the committee "
                                                            "update and the step within 600 s")
                time.sleep(0.25)
                fol.run_once()
            torch.cuda.synchronize()
            secs["path"] = time.perf_counter() - t_path
            launches = KL.launch_counts()
            del os.environ[faults.ENV_VAR]
            fired = faults.fired_count("replica.dispatch")
            faults.clear()
            delta = {k: v - counters0.get(k, 0) for k, v in HEALTH.snapshot()["counters"].items()
                     if v != counters0.get(k, 0)}
            require(fired == 1 and delta.get("dispatcher_lease_takeovers") == 1,
                    f"one injected crash, exactly one lease takeover ({fired}, "
                    f"{delta.get('dispatcher_lease_takeovers')})")
            require(delta.get("proofs_cross_verified") == 2
                    and not delta.get("proofs_cross_verify_failed"),
                    "the head cross-verified the committee update and the step")
            require(not delta.get("dispatcher_lease_expired"), "no lease expired")
            require(launches["K1c_bucket_walk"] == committee["prove_launches"]["K1c_bucket_walk"],
                    f"K1c launched as one committee prove ({launches['K1c_bucket_walk']}, the "
                    f"committee phase's {committee['prove_launches']['K1c_bucket_walk']}): the "
                    f"replica proved once, the step was a dedup hit")
            for name in PROVE_KERNELS:
                require(launches[name] > 0, f"{name} launched by the farm's committee prove")

            # the stored committee update, held as the service held its answers
            rec = fol.store.get_committee(period)
            res = rec["result"]
            proof, inst = selfverify.decode_result(res)
            require(inst == want, "the stored committee update's instances equal "
                                  "get_instances of the acquired rotation args")
            require(state.verify_proof("committee", proof, inst),
                    "the stored committee proof verifies under the state's vk")
            flipped = list(inst)
            flipped[0] ^= 1
            require(not state.verify_proof("committee", proof, flipped),
                    "the stored committee proof with a flipped instance is rejected")
            require(calldata.decode_calldata(bytes.fromhex(res["calldata"][2:]), len(inst))
                    == (inst, proof), "the stored calldata decodes to the instances and proof")
            require(int(res["committee_poseidon"], 16) == committee["instances"][0]
                    != acquired["genesis"][1],
                    "committee_poseidon is the committee phase's (the next committee's)")
            require(fol.store.verify_chain(), "verify_chain() holds")
            require(fol.store.get_step(fin_slot)["result"] == service["step_result"],
                    "the stored step is the service phase's answer")
            update = routes[f"/eth/v1/beacon/light_client/updates?start_period={period}"
                            f"&count=1"][0]["data"]
            cjid = service["client"].submit_committee_update(update)
            man = service["client"].get_manifest(cjid)
            require({"job/preprocess", "prove/witness", "prove/layout", "prove/snark",
                     "prove/self_verify"} <= set(man["phase_seconds"])
                    and man["kernels"]["builds"] == 0,
                    "the replica's committee job (a dedup hit on resubmit) shows its phases "
                    "and 0 kernel builds")
            require("spectre_prove_latency_seconds_count 4"
                    in service["client"].metrics_text(),
                    "/metrics: the process-wide prove-latency histogram counts the service's "
                    "two proofs and the head's two jobs")
            head_job = jobs.result(rec["job_id"])
            secs["committee_job"] = head_job.finished_at - head_job.submitted_at
            hman = hc.get_manifest(rec["job_id"])
            secs["cross_verify"] = hman["phase_seconds"].get("prove/cross_verify")
            secs["replica_prove"] = man["prove_s"]
            require(secs["cross_verify"] is not None, "the head's manifest times the "
                                                      "cross-verify")

            # the journals: a crashed grant, the takeover, the member's join
            leases = [json.loads(x) for x in open(os.path.join(
                farm_dir, "dispatcher.leases.jsonl")).read().splitlines()]
            require([(r["event"], r.get("outcome"), r.get("takeover")) for r in leases[:4]]
                    == [("lease", None, False), ("release", "crashed", None),
                        ("lease", None, True), ("release", "done", None)],
                    "the lease journal: a grant, its crash, the takeover, done")
            members = [json.loads(x) for x in open(os.path.join(
                farm_dir, "dispatcher.members.jsonl")).read().splitlines()]
            require([(m["event"], m["replica"]) for m in members] == [("join", "card")],
                    "the member journal records the service's join")
            renewal_gaps = [b - a for st in TimedReplica.renewals for a, b in zip(st, st[1:])]
            phase_gaps = [b - a for a, b in zip(phase_stamps, phase_stamps[1:])]
            out.update(max_lease_gap_s=max(renewal_gaps), max_phase_gap_s=max(phase_gaps),
                       phase_gaps_s=phase_gaps)
            require(out["max_lease_gap_s"] < FARM_LEASE_S < secs["committee_job"],
                    f"the lease ({FARM_LEASE_S} s) is longer than any gap between two "
                    f"renewals ({out['max_lease_gap_s']:.2f} s) and shorter than the "
                    f"committee job ({secs['committee_job']:.1f} s)")

            # the gateway over HTTP
            import urllib.error
            import urllib.request
            with urllib.request.urlopen(f"{head_url}/v1/update/{period}", timeout=30) as r:
                etag, body = r.headers["ETag"], r.read()
            require(etag == '"' + fol.store.committee_digest(period) + '"',
                    "GET /v1/update/<p>: the ETag is the store's digest")
            require(body == canonical_update_body(fol.store.get_committee(period)),
                    "GET /v1/update/<p>: the body is the canonical body of the stored update")
            req = urllib.request.Request(f"{head_url}/v1/update/{period}",
                                         headers={"If-None-Match": etag})
            try:
                urllib.request.urlopen(req, timeout=30)
                revalidated = None
            except urllib.error.HTTPError as e:
                revalidated = (e.code, e.read())
            require(revalidated == (304, b""), f"If-None-Match gives 304 with an empty body "
                                               f"({revalidated})")

            # the drill: the read plane never touches the card
            before = KL.launch_counts()
            t0 = time.perf_counter()
            drill = run_drill(HttpTarget(head_url), periods=[period], tip=period,
                              clients=1000, requests=FARM_DRILL_REQUESTS, seed=seed, threads=2,
                              health=HEALTH)
            secs["drill"] = time.perf_counter() - t0
            moved = {k: KL.launch_counts()[k] - before[k] for k in PROVE_KERNELS}
            bad = {k: v for k, v in drill["statuses"].items() if k not in ("200", "304")}
            require(drill["requests"] == FARM_DRILL_REQUESTS and not bad,
                    f"the drill's {FARM_DRILL_REQUESTS} requests give 0 errors ({bad})")
            require(not any(moved.values()), f"no kernel launched during the drill ({moved})")

            text = hc.metrics_text()
            for family in ("spectre_dispatcher_members", "spectre_replica_",
                           "spectre_follower_", "spectre_gateway_"):
                require(family in text, f"/metrics on the head exports {family}*")
            out.update(launches=launches, drill=dict(
                p50_ms=drill["latency_ms"]["p50"], p99_ms=drill["latency_ms"]["p99"],
                rps=drill["rps"], statuses=drill["statuses"], ratio_304=drill["ratio_304"]),
                takeovers=delta.get("dispatcher_lease_takeovers"), period=period,
                slot=fin_slot, members=d.snapshot()["members"])
        finally:
            os.environ.pop(faults.ENV_VAR, None)
            faults.clear()
            state.prove_committee = orig_prove_committee
            stop_server(head, head_state)
    secs["phase"] = sum(v for k, v in secs.items() if k in ("join_wait", "path")) \
        + secs["drill"]
    out["seconds"] = secs
    line = {**{k: v for k, v in out.items() if k != "launches"}, "lease_s": FARM_LEASE_S,
            "launches": {k: out["launches"][k] for k in SERVICE_KERNELS}}
    log("farm: " + json.dumps(line))
    return out


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


# The compressed paths, genEvmProof_SyncStepCompressed and
# genEvmProof_CommitteeUpdateCompressed: the inner circuit's name, the outer
# circuit's shape (k, advice, lookup, lookup_bits, fixed, instance) and its
# context's advice and lookup cells, the verifier contract's name, and the
# reference's tracked fixtures in build/ (the inner Poseidon proof, the
# verifier source, the compressed proof with its instances) with what its
# records hold for the compressed proof: (gas_execution, gas_total, runtime
# bytes). The step's outer shape is pinned by no file: models.aggregation
# .outer_k sizes it.
COMPRESSED = {
    "step": dict(
        inner="sync_step", shape=(STEP_K, 11, 2, 14, 1, 1), cells=(22454006, 2197024),
        contract="Verifier_aggregation_sync_step", inner_proof="step_testnet_21_poseidon.proof",
        sol="aggregation_sync_step_testnet_21_verifier.sol",
        proof="agg_step_testnet_21_keccak.proof", evm=(944042, 1059110, 44380)),
    "committee": dict(
        inner="committee_update", shape=(AGG_K, 16, 2, 14, 1, 1), cells=(63690124, 6033491),
        contract="Verifier_aggregation_committee",
        inner_proof="committee_testnet_18_poseidon.proof",
        sol="aggregation_committee_testnet_22_verifier.sol",
        proof="agg_committee_testnet_22_keccak.proof", evm=(1142389, 1283113, 56636)),
}
REF_GENERATOR = "// Auto-generated by spectre_tpu.evm.codegen — DO NOT EDIT."
PORT_GENERATOR = "// Auto-generated by spectre_tpu_torch.evm.codegen — DO NOT EDIT."
TAMPER_BYTE = 41
# the card's proof costs the tracked proof's execution gas; its calldata's
# zero bytes, and so its intrinsic gas, differ
TOTAL_GAS_SLACK = 600
# the revert reasons of a rejected stepCompressed or rotateCompressed: the
# contract's own, or the verifier's, which the contract passes on
VERIFIER_REVERTS = ("step proof invalid", "rotate proof invalid", "identity", "eval range",
                    "ecMul", "ecAdd", "pairing")
STEP_C_SIG = "stepCompressed((uint64,uint64,uint64,bytes32,bytes32),uint256[12],bytes)"
ROTATE_C_SIG = "rotateCompressed(uint256,uint256,uint256,uint256,uint256[12],bytes)"


def tracked_path(name: str, key: str) -> str:
    return os.path.join(REPO, "build", COMPRESSED[name][key])


def read_tracked_evm(name: str) -> tuple[str, list, bytes]:
    """The tracked verifier source, compressed proof's instances and bytes."""
    with open(tracked_path(name, "sol")) as f:
        src = f.read()
    with open(tracked_path(name, "proof"), "rb") as f:
        pf = f.read()
    with open(tracked_path(name, "proof") + ".instances.json") as f:
        inst = [int(v, 16) for v in json.load(f)["instances"]]
    return src, inst, pf


def tracked_proofs(inner: dict, name: str, circuit, vk, srs) -> dict:
    """The port's verifiers on the reference's tracked proofs: the inner
    stage-1 proof under Poseidon with the port's inner vk (it verifies only
    if that vk is the reference's), and the compressed proof under Keccak
    with its instances and the port's outer vk (AggregationCircuit.verify,
    pairing included); beside them the port's vk digests and the digest
    the tracked verifier contract records."""
    import re

    from spectre_tpu_torch.models.aggregation import NUM_ACC_LIMBS
    from spectre_tpu_torch.plonk.transcript import KeccakTranscript, PoseidonTranscript
    from spectre_tpu_torch.plonk.verifier import verify

    sol, agg_inst, agg_proof = read_tracked_evm(name)
    with open(tracked_path(name, "inner_proof"), "rb") as f:
        inner_proof = f.read()
    m = re.search(r"VK_DIGEST =\s*(0x[0-9a-f]+)", sol)
    return {
        "inner_vk_digest": inner["vk"].digest().hex(), "outer_vk_digest": vk.digest().hex(),
        "tracked_outer_vk_digest": m.group(1)[2:] if m else None,
        "tracked_inner_instances_are_the_keys": agg_inst[NUM_ACC_LIMBS:] == inner["key_instances"],
        "inner_proof_verifies": verify(inner["vk"], inner["srs"], [agg_inst[NUM_ACC_LIMBS:]],
                                       inner_proof, transcript_cls=PoseidonTranscript),
        "outer_proof_verifies": circuit.verify(vk, srs, agg_inst, agg_proof,
                                               transcript_cls=KeccakTranscript)}


def outer_build(name: str, vk, vk_digest: bytes, instances: list, proof: bytes):
    """COMPRESSED[name]'s outer build, the aggregation circuit's witness
    over the inner proof: host code on one Python thread for minutes, so a
    job of the worker process, started as soon as the inner proof exists
    and run beside the card's next phases. The in-circuit verifier reads
    the inner vk (app_circuit.vk_to_ints's form, held to its digest),
    instances and proof, not the SRS's points. Returns (ctx, its
    seconds)."""
    from spectre_tpu_torch import spec as SPEC
    from spectre_tpu_torch.models.aggregation import AggregationArgs, AggregationCircuit
    from spectre_tpu_torch.models.app_circuit import vk_from_ints

    t0 = time.perf_counter()
    inner_vk = vk_from_ints(vk)
    require(inner_vk.digest() == vk_digest, "the verifying key crosses to the worker whole")
    circuit = AggregationCircuit.variant(COMPRESSED[name]["inner"])
    args = AggregationArgs(inner_vk=inner_vk, srs=None, inner_instances=[instances],
                           proof=proof)
    ctx = circuit.build_context(args, SPEC.TESTNET, device="cpu")
    return ctx, time.perf_counter() - t0


def aggregation_path(torch, dev, seed: int, inner: dict, name: str, prebuilt=None) -> dict:
    """Stage 2 of an inner circuit's Poseidon proof (COMPRESSED[name]): the
    outer circuit at its tracked pinning, or where none is tracked at the
    k outer_k gives, proved under Keccak and checked by
    AggregationCircuit.verify (the deferred pairing included); its vk and
    verifiers held to the reference's tracked fixtures. `prebuilt`, a
    future of outer_build in the worker process, gives the outer context in
    place of building it here; the phase "build" then holds the worker's
    seconds and "build_wait" the wait for it (its transfer included)."""
    from spectre_tpu_torch import spec as SPEC
    from spectre_tpu_torch.fields import bn254
    from spectre_tpu_torch.models.aggregation import (MAX_OUTER_ADVICE, NUM_ACC_LIMBS,
                                                      OUTER_K_RANGE, AggregationArgs,
                                                      AggregationCircuit, outer_k)
    from spectre_tpu_torch.plonk.prover import PhaseTimer
    from spectre_tpu_torch.plonk.srs import SRS
    from spectre_tpu_torch.plonk.transcript import KeccakTranscript

    spec, phases, entry = SPEC.TESTNET, {}, COMPRESSED[name]
    circuit = AggregationCircuit.variant(entry["inner"])
    k = entry["shape"][0]
    pinned = os.path.exists(circuit.pinning_path(spec, k))
    # args: the inner snark, the inner phase's Poseidon proof
    phases["args"] = dict(s=inner["phases"]["prove"], peak_gib=inner["peak_gib"],
                          launches={key: v for key, v in inner["prove_launches"].items() if v})
    log(f"{circuit.name}: the inner snark is the {entry['inner']} stage-1 proof "
        f"({len(inner['proof'])} bytes, Poseidon)")
    log(f"  args (the inner proof): {phases['args']['s']:.3f} s, peak "
        f"{phases['args']['peak_gib']:.1f} GiB, launches " + json.dumps(phases["args"]["launches"]))
    args = AggregationArgs(inner_vk=inner["vk"], srs=inner["srs"],
                           inner_instances=[inner["instances"]], proof=inner["proof"])
    if prebuilt is None:
        ctx = measured(torch, phases, "build",
                       lambda: circuit.build_context(args, spec, device=dev))
    else:
        ctx, build_s = measured(torch, phases, "build_wait", prebuilt.result)
        phases["build"] = dict(s=build_s, where="the worker process, beside the card's phases")
        log(f"  build: {build_s:.3f} s in the worker process")
    stats = ctx.stats()
    require((stats["advice_cells"], sum(stats["lookup_cells"].values())) == entry["cells"],
            f"the outer context's advice and lookup cells {entry['cells']}")
    if not pinned:
        got_k = outer_k(ctx, circuit.default_lookup_bits)
        require(got_k == k, f"the reference flow's rule sizes the outer circuit at k={k} "
                            f"(got {got_k})")
    cfg = measured(torch, phases, "pinning", lambda: circuit.pinning(spec, k, ctx).config)
    require((cfg.k, cfg.num_advice, cfg.num_lookup_advice, cfg.lookup_bits, cfg.num_fixed,
             cfg.num_instance) == entry["shape"],
            f"the outer shape (k, advice, lookup, lookup_bits, fixed, instance) = "
            f"{entry['shape']}")
    log(f"  shape k={cfg.k} advice={cfg.num_advice} lookup={cfg.lookup_tables} "
        f"lookup_bits={cfg.lookup_bits} fixed={cfg.num_fixed}; "
        + ("break points equal the tracked pinning's; " if pinned else
           f"no tracked pinning: sized by the reference flow's rule (k in "
           f"{OUTER_K_RANGE[0]}..{OUTER_K_RANGE[1] - 1}, <= {MAX_OUTER_ADVICE} advice); ")
        + json.dumps(stats))
    instances = measured(torch, phases, "instances",
                         lambda: circuit.get_instances(args, spec))
    require(instances == [av.value for av in ctx.instance_cells],
            "the exposed cells equal get_instances")
    require(len(instances) == NUM_ACC_LIMBS + len(inner["instances"])
            and instances[NUM_ACC_LIMBS:] == inner["instances"],
            f"the statement is the {NUM_ACC_LIMBS} accumulator limbs, then the inner instances")
    if inner["srs"].k == k:
        srs = inner["srs"]
    else:
        srs = measured(torch, phases, "srs", lambda: SRS.load_or_setup(k, device=dev))
    require(srs.g2_tau == inner["srs"].g2_tau, f"the k={k} SRS has the inner SRS's tau")
    ktimer = PhaseTimer(torch.device(dev))
    pk = measured(torch, phases, "keygen",
                  lambda: circuit.create_pk(srs, spec, k, args, device=dev, ctx=ctx,
                                            timer=ktimer))
    phases["keygen"]["phases"] = ktimer.seconds
    log("  keygen phases (s): " + json.dumps({key: round(v, 3)
                                              for key, v in ktimer.seconds.items()}))
    timer = PhaseTimer(torch.device(dev))
    r = random.Random(seed)
    proof = measured(torch, phases, "prove", lambda: circuit.prove(
        pk, srs, args, spec, device=dev, ctx=ctx, transcript=KeccakTranscript(),
        blinding_rng=lambda: r.randrange(bn254.R), timer=timer))
    phases["prove"]["phases"] = timer.seconds
    log("  prove phases (s): " + json.dumps({key: round(v, 3) for key, v in timer.seconds.items()}))
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
    tracked_len = os.path.getsize(tracked_path(name, "proof"))
    require(len(proof) == tracked_len, f"the outer proof is {tracked_len} bytes, as the "
                                       "tracked one")
    log(f"  outer proof {len(proof)} bytes (Keccak), AggregationCircuit.verify accepts it, "
        f"a flipped accumulator limb is rejected; vk digest {pk.vk.digest().hex()}")
    tracked = tracked_proofs(inner, name, circuit, pk.vk, srs)
    log("  tracked reference fixtures: " + json.dumps(tracked))
    # the inner vk first: the outer vk holds it, so a different inner vk
    # explains a different outer digest
    require(tracked["inner_proof_verifies"],
            f"the tracked {entry['inner_proof']} verifies under the port's inner vk")
    require(tracked["tracked_inner_instances_are_the_keys"],
            "the tracked compressed proof's inner instances are those of the default args, "
            "which key the inner circuit")
    require(tracked["outer_vk_digest"] == tracked["tracked_outer_vk_digest"],
            f"the outer vk digest equals the VK_DIGEST of build/{entry['sol']}")
    require(tracked["outer_proof_verifies"],
            f"the tracked {entry['proof']} passes AggregationCircuit.verify under the port's "
            "outer vk")
    return dict(phases=phases, tracked=tracked, proof_bytes=len(proof), vk=pk.vk, srs=srs,
                instances=instances, proof=proof)


def streamed_order(src: str) -> str:
    """A generated verifier's source with its identity check in the order
    of today's codegen. The reference's all_expressions became a generator
    (commit 8cc0140, "Stream the quotient constraint fold"), so codegen now
    emits each constraint's temporaries t[i] just before the line that folds
    it into acc; a verifier generated before that (the step's tracked one)
    has every temporary first, then `uint256 acc = 0;` and the fold. The
    temporaries are numbered in the order they are made either way, so
    moving each run of them down to the first fold line that names its last
    one gives today's source. A source already in that order is returned as
    it is."""
    import re

    lines = src.split("\n")
    start = next(i for i, ln in enumerate(lines) if ln.strip() == "uint256 acc = 0;")
    first = start
    while first > 0 and lines[first - 1].lstrip().startswith("t["):
        first -= 1
    pending, out = lines[first:start], lines[:first] + [lines[start]]
    rest = iter(range(start + 1, len(lines)))
    for i in rest:
        m = re.fullmatch(r"\s*acc = addmod\(mulmod\(acc, y, R_MOD\), t\[(\d+)\], R_MOD\);",
                         lines[i])
        if m is None and not lines[i].lstrip().startswith("acc = addmod("):
            out.extend(lines[i:])
            break
        while m and pending and int(pending[0].lstrip()[2:].split("]")[0]) <= int(m.group(1)):
            out.append(pending.pop(0))
        out.append(lines[i])
    if pending:
        raise ValueError("a temporary of the identity check is folded by no line")
    return "\n".join(out)


def tampered(proof: bytes, at: int = TAMPER_BYTE) -> bytes:
    bad = bytearray(proof)
    bad[at] ^= 1
    return bytes(bad)


def generated_verifier(agg: dict, name: str) -> tuple[str, float]:
    """The Solidity verifier generated from the port's outer vk of a
    compressed path (COMPRESSED[name]), and the seconds it took."""
    from spectre_tpu_torch.evm import gen_evm_verifier
    from spectre_tpu_torch.models.aggregation import NUM_ACC_LIMBS

    t0 = time.perf_counter()
    sol = gen_evm_verifier(agg["vk"], agg["srs"], num_instances=len(agg["instances"]),
                           contract_name=COMPRESSED[name]["contract"], num_acc_limbs=NUM_ACC_LIMBS)
    gen_s = time.perf_counter() - t0
    log(f"evm {name}: verifier generated from the port's outer vk in {gen_s:.3f} s, "
        f"{len(sol)} source bytes")
    return sol, gen_s


def evm_checks_apart(*args) -> tuple[dict, str]:
    """evm_checks(*args) in a worker process: (its result, what it logged).
    A failed check raises with the log so far."""
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            return evm_checks(*args), buf.getvalue()
    except Exception as e:
        raise RuntimeError(f"{buf.getvalue()}{type(e).__name__}: {e}") from None


def evm_checks(sol: str, instances: list, proof: bytes, name: str, inner_args,
               genesis: tuple) -> dict:
    """The checks of the evm phase on a generated verifier `sol` and one
    compressed proof with its instances (COMPRESSED[name]): the source
    against the tracked verifier, the bytecode against the tracked
    source's; calldata; the simulator and the metered VM accept the proof
    and reject it with a byte flipped; the tracked proof in the VM; then
    the Spectre contract on chain (step_on_chain or rotate_on_chain),
    constructed with genesis = (period, committee Poseidon) of the beacon
    data's bootstrap. Returns the seconds of each part and the numbers
    printed."""
    from spectre_tpu_torch.evm import encode_calldata
    from spectre_tpu_torch.evm.simulator import run_verifier
    from spectre_tpu_torch.evm.solc import compile_verifier, vm_verify
    from spectre_tpu_torch.plonk.transcript import keccak256
    from spectre_tpu_torch.prover_service import calldata as CD

    secs, nums, entry = {}, {}, COMPRESSED[name]
    g_exec, g_total, nbytes = entry["evm"]
    t_phase = time.perf_counter()

    # 1. the source and its bytecode against the tracked verifier, in the
    # order today's codegen emits its identity check
    t0 = time.perf_counter()
    tracked_src, tracked_inst, tracked_proof = read_tracked_evm(name)
    expected = streamed_order(tracked_src)
    if expected != tracked_src:
        log(f"  build/{entry['sol']} folds its identity check in the codegen's order of "
            "before commit 8cc0140 (every temporary first); held to it in today's order "
            "(streamed_order)")
    got, want = sol.split("\n"), expected.split("\n")
    diff = [i for i in range(max(len(got), len(want)))
            if (got[i] if i < len(got) else None) != (want[i] if i < len(want) else None)]
    first = next((i for i in diff if i != 1), None)
    if first is not None:
        log(f"  first line that differs from the tracked verifier: {first + 1}\n"
            f"    generated: {got[first] if first < len(got) else '<end>'}\n"
            f"    tracked:   {want[first] if first < len(want) else '<end>'}")
    require(diff == [1] and got[1] == PORT_GENERATOR and want[1] == REF_GENERATOR,
            f"the generated verifier equals build/{entry['sol']} (in today's order) but for "
            "its generator line")
    runtime, init, meta = compile_verifier(sol)
    t_runtime, t_init, _ = compile_verifier(expected)
    require(runtime == t_runtime and init == t_init,
            "its bytecode equals the tracked source's, compiled by the port")
    require(meta["runtime_bytes"] == nbytes, f"{nbytes} runtime bytes, the tracked verifier's")
    secs["source_and_bytecode"] = time.perf_counter() - t0
    log(f"  source equal to build/{entry['sol']} but for line 2; bytecode equal: "
        f"{meta['runtime_bytes']} runtime bytes, {meta['init_bytes']} init bytes, "
        f"eip170_ok {meta['eip170_ok']}")

    # 2. calldata, the simulator and the metered VM on the proof
    t0 = time.perf_counter()
    abi = encode_calldata(instances, proof)
    flat = CD.encode_calldata(instances, proof)
    require(len(abi) == 4 + 32 * (4 + len(instances)) + -(-len(proof) // 32) * 32
            and abi[:4] == keccak256(b"verify(uint256[],bytes)")[:4],
            "the ABI calldata's layout")
    require(CD.decode_calldata(flat, len(instances)) == (list(instances), proof),
            "the flat calldata decodes to the statement and the proof")
    secs["calldata"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sim_ok = run_verifier(sol, instances, proof)
    secs["simulator"] = time.perf_counter() - t0
    sim_bad = run_verifier(sol, instances, tampered(proof))
    require(sim_ok, "the simulator accepts the proof")
    require(not sim_bad, f"the simulator rejects it with byte {TAMPER_BYTE} flipped")
    t0 = time.perf_counter()
    r = vm_verify(sol, instances, proof, tamper_byte=TAMPER_BYTE)
    secs["vm"] = time.perf_counter() - t0
    require(r["ok"] and not r["reverted"], "the compiled verifier accepts the proof in the VM")
    require(r["tamper_rejected"], f"the VM rejects it with byte {TAMPER_BYTE} flipped")
    nums["proof"] = dict(calldata_bytes=len(abi), flat_calldata_bytes=len(flat),
                         gas_execution=r["gas_execution"], gas_total=r["gas_total"],
                         gas_total_minus_tracked=r["gas_total"] - g_total,
                         runtime_bytes=r["runtime_bytes"], eip170_ok=r["eip170_ok"],
                         calldata_zero_bytes=abi.count(0))
    log(f"  the proof: calldata {len(abi)} bytes ({len(flat)} flat); simulator accepts "
        f"({secs['simulator']:.3f} s), rejects byte {TAMPER_BYTE} flipped; VM accepts, "
        f"rejects the flip; gas_execution {r['gas_execution']}, gas_total {r['gas_total']} "
        f"({r['gas_total'] - g_total:+d} against the tracked proof's {g_total}), "
        f"runtime {r['runtime_bytes']} bytes, eip170_ok {r['eip170_ok']} ({secs['vm']:.3f} s)")
    require(r["gas_execution"] == g_exec, f"the VM's gas_execution is the tracked {g_exec}")
    require(abs(r["gas_total"] - g_total) <= TOTAL_GAS_SLACK,
            f"the VM's gas_total is within {TOTAL_GAS_SLACK} of the tracked {g_total}")

    # 3. the tracked reference proof in the port's VM
    t0 = time.perf_counter()
    rt = vm_verify(tracked_src, tracked_inst, tracked_proof, tamper_byte=TAMPER_BYTE)
    secs["tracked"] = time.perf_counter() - t0
    require(rt["ok"] and (rt["gas_execution"], rt["gas_total"], rt["runtime_bytes"])
            == (g_exec, g_total, nbytes),
            f"the tracked {name} proof: ok, gas {g_exec} / {g_total}, {nbytes} bytes")
    require(rt["tamper_rejected"], f"the tracked {name} proof with byte {TAMPER_BYTE} "
                                   "flipped is rejected")
    nums["tracked"] = {key: rt[key] for key in ("gas_execution", "gas_total", "runtime_bytes",
                                                "eip170_ok")}
    log(f"  tracked {name}: ok, gas {rt['gas_execution']} / {rt['gas_total']}, "
        f"{rt['runtime_bytes']} bytes, flip rejected ({secs['tracked']:.3f} s)")

    # 4. on chain
    t0 = time.perf_counter()
    on_chain = step_on_chain if name == "step" else rotate_on_chain
    nums["on_chain"] = on_chain(init, instances, proof, inner_args, genesis)
    secs["on_chain"] = time.perf_counter() - t0
    secs["phase"] = time.perf_counter() - t_phase
    return dict(seconds=secs, numbers=nums)


class Chain:
    """One VM World with the Spectre contract for the testnet spec deployed
    over two verifiers (init code), its first period and committee
    Poseidon."""

    def __init__(self, step_init: bytes, rotate_init: bytes, period: int, poseidon: int):
        from spectre_tpu_torch import spec as SPEC
        from spectre_tpu_torch.contracts.sol_gen import gen_spectre_sol
        from spectre_tpu_torch.evm import vm as V
        from spectre_tpu_torch.evm.solc_spectre import compile_spectre

        self.V = V
        self.world = V.World()
        step_v, self.step_deploy_gas = self.world.deploy(step_init, enforce_eip170=False)
        rotate_v, self.rotate_deploy_gas = self.world.deploy(rotate_init, enforce_eip170=False)
        _, spectre_init, meta = compile_spectre(gen_spectre_sol(SPEC.TESTNET))
        self.runtime_bytes = meta["runtime_bytes"]
        self.spectre, self.deploy_gas = self.world.deploy(
            spectre_init, words(period, poseidon, step_v, rotate_v))

    def view(self, sig: str, *args) -> int:
        ok, out, _ = self.world.call_view(self.spectre, selector(sig) + words(*args))
        require(ok, f"{sig} answers")
        return int.from_bytes(out, "big")

    def transact(self, sig: str, body: bytes) -> tuple[bool, str, int]:
        """(success, revert reason, gas) of one transaction."""
        ok, out, gas = self.world.transact(self.spectre, selector(sig) + body, gas=100_000_000)
        return ok, self.V.revert_reason(out), gas


def selector(sig: str) -> bytes:
    from spectre_tpu_torch.plonk.transcript import keccak256
    return keccak256(sig.encode())[:4]


def words(*vals) -> bytes:
    return b"".join(int(v).to_bytes(32, "big") for v in vals)


def padded(pf: bytes) -> bytes:
    """A bytes argument: its length, then its bytes padded to a word."""
    return len(pf).to_bytes(32, "big") + pf + b"\x00" * (-len(pf) % 32)


def step_on_chain(init: bytes, instances: list, proof: bytes, args, genesis: tuple) -> dict:
    """Spectre with the compiled step verifier, constructed as the
    reference's test-utils constructs it from the bootstrap: genesis =
    (its period, which is the attested slot's, and its committee's
    Poseidon, which is instances[13]). stepCompressed with the StepInput of
    the step's args (its commitment is instances[12]) reverts on the
    flipped proof, leaving head() where it was, and takes the card's proof:
    head() moves to the finalized slot and both roots are stored."""
    from spectre_tpu_torch import spec as SPEC
    from spectre_tpu_torch.contracts.spectre import StepInput
    from spectre_tpu_torch.models.aggregation import NUM_ACC_LIMBS

    spec = SPEC.TESTNET
    inp = StepInput(attested_slot=args.attested_header.slot,
                    finalized_slot=args.finalized_header.slot,
                    participation=sum(args.participation_bits),
                    finalized_header_root=args.finalized_header.hash_tree_root(),
                    execution_payload_root=args.execution_payload_root)
    require(inp.to_public_inputs_commitment() == instances[NUM_ACC_LIMBS],
            "the StepInput's public-input commitment is instances[12]")
    period, poseidon = genesis
    require(period == spec.sync_period(inp.attested_slot)
            and poseidon == instances[NUM_ACC_LIMBS + 1],
            "the bootstrap's period is the attested slot's and its committee Poseidon is "
            "instances[13]")
    chain = Chain(init, constant_verifier(False), period, poseidon)

    def step(pf: bytes):
        return chain.transact(STEP_C_SIG, words(
            inp.attested_slot, inp.finalized_slot, inp.participation)
            + inp.finalized_header_root + inp.execution_payload_root
            + words(*instances[:NUM_ACC_LIMBS]) + words(32 * 18) + padded(pf))

    ok_bad, reason, bad_gas = step(tampered(proof))
    require(not ok_bad and reason in VERIFIER_REVERTS,
            f"stepCompressed with byte {TAMPER_BYTE} flipped reverts (reason {reason!r})")
    require(chain.view("head()") == 0 and chain.view("blockHeaderRoots(uint256)",
                                                     inp.finalized_slot) == 0,
            "the reverted step moved no head and stored no root")
    ok, why, gas = step(proof)
    require(ok, f"stepCompressed accepts the proof ({why})")
    require(chain.view("head()") == inp.finalized_slot
            and chain.view("blockHeaderRoots(uint256)", inp.finalized_slot)
            == int.from_bytes(inp.finalized_header_root, "big")
            and chain.view("executionPayloadRoots(uint256)", inp.finalized_slot)
            == int.from_bytes(inp.execution_payload_root, "big"),
            "head() is the finalized slot, whose header and payload roots are stored")
    out = dict(spectre_runtime_bytes=chain.runtime_bytes, spectre_deploy_gas=chain.deploy_gas,
               verifier_deploy_gas=chain.step_deploy_gas, step_compressed_gas=gas,
               tampered_step_gas=bad_gas, tampered_revert=reason,
               finalized_slot=inp.finalized_slot)
    log(f"  on chain: Spectre {chain.runtime_bytes} runtime bytes with the compiled step "
        f"verifier (deploy gas {chain.step_deploy_gas}); stepCompressed gas {gas}, head() = "
        f"{inp.finalized_slot}; with byte {TAMPER_BYTE} flipped it reverts, reason "
        f"{reason!r}, gas {bad_gas}, head() unmoved")
    return out


def rotate_on_chain(init: bytes, instances: list, proof: bytes, args, genesis: tuple) -> dict:
    """Spectre with a constant-true step verifier and the compiled committee
    verifier, constructed with genesis = (period, committee Poseidon) of the
    bootstrap: one step to the committee's finalized header (the step's
    attested header), then rotateCompressed with the card's proof stores
    instances[12] as the next period's committee, and the flipped proof
    reverts."""
    from spectre_tpu_torch import spec as SPEC
    from spectre_tpu_torch.contracts.spectre import StepInput
    from spectre_tpu_torch.models.aggregation import NUM_ACC_LIMBS
    from spectre_tpu_torch.plonk.transcript import keccak256

    spec = SPEC.TESTNET
    header = args.finalized_header
    lo, hi = instances[13], instances[14]
    root = hi.to_bytes(16, "big") + lo.to_bytes(16, "big")
    require(root == header.hash_tree_root(), "instances[13:15] encode the committee's "
                                             "finalized header root")
    inp = StepInput(attested_slot=header.slot + 3, finalized_slot=header.slot,
                    participation=spec.sync_committee_size, finalized_header_root=root,
                    execution_payload_root=keccak256(b"execution payload root"))
    period, poseidon = genesis
    require(period == spec.sync_period(inp.attested_slot),
            "the bootstrap's period is the committee's finalized header's")
    chain = Chain(constant_verifier(True), init, period, poseidon)
    ok, why, step_gas = chain.transact(
        "step((uint64,uint64,uint64,bytes32,bytes32),bytes)",
        words(inp.attested_slot, inp.finalized_slot, inp.participation) + root
        + inp.execution_payload_root + words(192) + padded(b""))
    require(ok, f"the step transaction succeeds ({why})")
    require(chain.view("head()") == header.slot
            and chain.view("blockHeaderRoots(uint256)", header.slot)
            == int.from_bytes(root, "big"), "the step stored the finalized header root")

    def rotate(pf: bytes):
        return chain.transact(ROTATE_C_SIG, words(header.slot, instances[12], lo, hi)
                              + words(*instances[:NUM_ACC_LIMBS]) + words(32 * 17) + padded(pf))

    next_period = spec.sync_period(header.slot) + 1
    ok_bad, reason, bad_gas = rotate(tampered(proof))
    # a false verdict hits the contract's require; a verifier that reverts
    # has its reason bubbled through the contract (solc 0.8 behaviour)
    require(not ok_bad and reason in VERIFIER_REVERTS,
            f"rotateCompressed with byte {TAMPER_BYTE} flipped reverts (reason {reason!r})")
    require(chain.view("syncCommitteePoseidons(uint256)", next_period) == 0,
            "the reverted rotation stored nothing")
    ok, why, rotate_gas = rotate(proof)
    require(ok, f"rotateCompressed accepts the proof ({why})")
    require(chain.view("syncCommitteePoseidons(uint256)", next_period) == instances[12],
            "syncCommitteePoseidons(next period) reads instances[12]")
    out = dict(spectre_runtime_bytes=chain.runtime_bytes, spectre_deploy_gas=chain.deploy_gas,
               verifier_deploy_gas=chain.rotate_deploy_gas, step_gas=step_gas,
               rotate_compressed_gas=rotate_gas, tampered_rotate_gas=bad_gas,
               tampered_revert=reason, next_period=next_period)
    log(f"  on chain: Spectre {chain.runtime_bytes} runtime bytes (deploy gas "
        f"{chain.deploy_gas}), the committee verifier deployed with EIP-170 waived (deploy "
        f"gas {chain.rotate_deploy_gas}); step gas {step_gas}; rotateCompressed gas "
        f"{rotate_gas}, syncCommitteePoseidons({next_period}) = instances[12]; with byte "
        f"{TAMPER_BYTE} flipped it reverts, reason {reason!r}, gas {bad_gas}")
    return out


def constant_verifier(result: bool) -> bytes:
    """Init code of a verifier stub that returns a constant bool."""
    from spectre_tpu_torch.evm.solc import Asm, _init_code

    a = Asm()
    a.push(1 if result else 0)
    a.push(0)
    a.op("MSTORE")
    a.push(32)
    a.push(0)
    a.op("RETURN")
    return _init_code(a.assemble())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, default=FLEX_K,
                    help=f"rows 2^k of the flex slice (default {FLEX_K}; the pinning's is 21)")
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    # a crash (a signal, not an exception) prints every thread's Python stack
    faulthandler.enable()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    # host work that needs no card (the K=6 proofs on the CPU, the beacon
    # data's fixture, the default args, the EVM checks) runs in a second
    # process beside the card's; the fixture lives in a temporary directory
    with tempfile.TemporaryDirectory(prefix="spectre-beacon-") as fixture_dir, \
            tempfile.TemporaryDirectory(prefix="spectre-service-") as service_dir, \
            concurrent.futures.ProcessPoolExecutor(
                1, mp_context=multiprocessing.get_context("spawn")) as pool:
        return run(args, t_start, pool, fixture_dir, service_dir)


def run(args, t_start: float, pool, fixture_dir: str, service_dir: str) -> int:
    """The phases, in order; `pool` runs the host jobs, the beacon data's
    fixture is written into fixture_dir, the prover service's SRS files and
    job journal into service_dir."""
    import torch

    def mark(phase: str) -> None:
        # on both streams, so that the end of the standard error says which
        # phase a device-side assertion or a crash came in
        msg = f"[{time.perf_counter() - t_start:.1f} s] {phase}"
        log(msg)
        print(msg, file=sys.stderr, flush=True)

    from spectre_tpu_torch import spec as SPEC
    from spectre_tpu_torch.fields import bn254
    from spectre_tpu_torch.models.app_circuit import vk_to_ints
    from spectre_tpu_torch.ops import (ec, field_ops as F, kernel_lib as KL, limbs as L,
                                       msm as M, msm_kernels as MK, ntt as N)
    from spectre_tpu_torch.plonk.backend import TorchBackend
    from spectre_tpu_torch.plonk.keygen import keygen
    from spectre_tpu_torch.plonk.prover import PhaseTimer, prove
    from spectre_tpu_torch.plonk.srs import SRS, g1_powers_device
    from spectre_tpu_torch.plonk.verifier import verify
    from spectre_tpu_torch.preprocessor.spec_tests import generate_spec_test
    from spectre_tpu_torch.witness import (config_from_pinning, default_committee_update_args,
                                           default_sync_step_args, flex_circuit)

    # the worker's jobs, in the order the phases need them
    cpu_k6 = pool.submit(k6_proofs, "cpu", args.seed)
    fixture = pool.submit(timed_call, generate_spec_test, fixture_dir, SPEC.TESTNET, args.seed,
                          "sync", "cpu")
    committee_args = pool.submit(timed_call, default_committee_update_args, SPEC.TESTNET)
    step_args = pool.submit(timed_call, default_sync_step_args, SPEC.TESTNET)
    dev = torch.device("cuda")
    fr, fq = F.fr_ctx(), F.fq_ctx()
    # K1's four kernels and the name each has in a profiler trace
    k1_kernels = {k: KL.KERNELS[k].symbol for k in SHARED_K1}
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    records = {}

    # --- device ------------------------------------------------------------
    mark("device")
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
    mark("build")
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
    for lib in ("field384_kernels", "field_mxu_kernels", "ntt_matmul_kernels"):
        regs.update(KL.ptxas_registers(os.path.join(KL.BUILD_DIR, f"{lib}.log")))
    reg_of = {rec: next(v for k, v in regs.items() if KL.KERNELS[rec].symbol in k)
              for rec in ("K1c_bucket_walk", "K1c_fixed_walk", "K2_padd",
                          "K2b_bucket_aggregate", "K6_g1_decompress", "K7_mont_mul_mxu",
                          "K8_ntt_dft_matmul")}
    top = sorted(probe.items(), key=lambda kv: -kv[1])[:8]
    log(f"sass: one Montgomery product (probe kernel, its 16 loads and 8 stores "
        f"included) {sum(probe.values())} instructions, {dict(top)}; registers a thread "
        + json.dumps(reg_of))

    # test points: tau'^i G on the card
    n_pts = 1 << 21
    t0 = time.perf_counter()
    tau_pts = random.Random(args.seed).randrange(1, bn254.R)
    pts = g1_powers_device(tau_pts, n_pts, dev)
    torch.cuda.synchronize()
    log(f"points: {n_pts} in {time.perf_counter() - t0:.2f} s")

    # --- K2 ------------------------------------------------------------------
    mark("K2")
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
    mark("K3")
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
    mark("K4")
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

    # --- K7, K8 -------------------------------------------------------------
    mark("K7")
    records["K7_mont_mul_mxu"] = mxu_product_phase(torch, dev, gen, k3_ms)
    torch.cuda.empty_cache()
    mark("K8")
    records["K8_ntt_dft_matmul"] = dft_phase(torch, dev, gen)
    N.clear_tables()
    torch.cuda.empty_cache()

    # --- K1 ------------------------------------------------------------------
    mark("K1")
    c = M.default_window_pallas(n_pts)
    nwin, nb = M.num_windows(c), 1 << (c - 1)
    nkeys = nwin * nb
    P, nblk = MK.plan_blocks(n_pts)
    negs = torch.zeros((1, n_pts), dtype=torch.int32, device=dev)
    one_scalar = random_fr(torch, 1, gen, dev)
    cases = {
        "random": random_fr(torch, n_pts, gen, dev),
        "all-equal": one_scalar.repeat(n_pts, 1),
        "all-zero": torch.zeros((n_pts, 4), dtype=torch.int64, device=dev),
    }
    k1 = {}
    k1_errs = {name: 0 for name in k1_kernels}
    # the random case is held to the plain K1 on the whole input (its time
    # is K1c's plain_ms); the all-equal and all-zero cases on the 2^18
    # prefix, the committee's MSM size (a plain K1 is ~15 s a 2^21 case),
    # and their whole sums, weighted by K2b and combined over the windows,
    # to the host's: s (sum_i tau^i) G, a geometric series, and the point
    # at infinity (the random case's whole sum is held to the host's
    # tau-sum in the msm phase); the kernels are timed whole
    prefix = 1 << COMMITTEE_K
    geometric = (pow(tau_pts, n_pts, bn254.R) - 1) * pow(tau_pts - 1, -1, bn254.R) % bn254.R
    s_one = L.limbs_to_ints(F.tensor_to_u64(one_scalar))[0]
    host_sum = {"all-equal": bn254.g1_curve.mul(bn254.G1_GEN, s_one * geometric % bn254.R),
                "all-zero": None}
    for name, sc in cases.items():
        digits = M.signed_digit_stream(sc, c, nwin)
        m = n_pts if name == "random" else prefix
        compared = "whole" if m == n_pts else f"n=2^{COMMITTEE_K} prefix"
        soa_cmp = ec.aos32_to_soa16(pts[:m].contiguous())
        d_cmp, negs_cmp = digits[:, :m].contiguous(), negs[:, :m].contiguous()
        got = MK.bucket_sums(soa_cmp, d_cmp, negs_cmp, c)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = MK.bucket_sums_plain(soa_cmp, d_cmp, negs_cmp, c)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = limb_err(F, normalized_buckets(ec, got), normalized_buckets(ec, want))
        require(err == 0, f"K1 ({name}, {compared}) equals its plain version after "
                          f"normalization")
        prefix_ms = (None if m == n_pts else
                     time_ms(torch, lambda: MK.bucket_sums(soa_cmp, d_cmp, negs_cmp, c), reps=3))
        # the plan kernels against their plain versions
        counts, bstart_cmp, entries_plain = MK.bucket_plan_plain(d_cmp, negs_cmp, c)
        got_counts, _, entries = MK.bucket_plan(d_cmp, negs_cmp, c)
        e_err = bucket_multiset_err(torch, entries, entries_plain, bstart_cmp)
        require(torch.equal(got_counts, counts), f"K1a ({name}, {compared}) equals its plain "
                                                 f"counts")
        require(e_err == 0, f"K1b ({name}, {compared}) places each bucket's entries as the "
                            f"plain sort")
        del got, want, entries, entries_plain, counts, got_counts, bstart_cmp, soa_cmp
        if name in host_sum:
            whole = MK.combine_windows(MK.aggregate_buckets_aos32(
                MK.bucket_sums_aos32(pts, digits, negs, c), nwin, nb), c)
            require(whole == host_sum[name], f"K1 ({name}) at n = 2^21, weighted by K2b, "
                                             f"equals the host's sum")
        # the bound and the adds count the whole input's buckets
        _, bstart = MK.bucket_offsets(MK.bucket_counts_plain(digits, nb, P), nkeys, nblk)
        k1_errs["K1c_bucket_walk"] = k1_errs["K1d_bucket_pieces"] = max(
            k1_errs["K1c_bucket_walk"], err)
        k1_errs["K1b_bucket_scatter"] = max(k1_errs["K1b_bucket_scatter"], e_err)
        wrapper_ms = time_ms(torch, lambda: MK.bucket_sums_aos32(pts, digits, negs, c), reps=3)
        sub_ms = profile_kernels(torch, lambda: MK.bucket_sums_aos32(pts, digits, negs, c),
                                 k1_kernels, reps=2)
        # the plain walk sums each bucket whole: it covers K1c and K1d
        # together; the whole plain K1 (its plan included) stands under K1c
        # alone, where it ran on the whole input (a prefix's time stands
        # beside the kernel's on that prefix); the plain plan kernels are
        # timed whole
        plain_sub = {
            "K1a_bucket_count": time_ms(torch, lambda: MK.bucket_counts_plain(digits, nb, P), reps=1),
            "K1b_bucket_scatter": time_ms(torch, lambda: MK.bucket_scatter_plain(digits, negs, nb),
                                          reps=1),
            "K1c_bucket_walk": plain_ms if m == n_pts else None, "K1d_bucket_pieces": None}
        plain = dict(plain_ms=plain_ms) if m == n_pts else dict(prefix_ms=prefix_ms,
                                                                prefix_plain_ms=plain_ms)
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
        k1[name] = dict(ms=wrapper_ms, **plain, bound_ms=total[0], bound_by=total[1],
                        adds=int(bstart[-1]) - int((bstart[1:] > bstart[:-1]).sum()),
                        max_abs_err=err, compared=compared, kernels={
                            k: dict(ms=sub_ms[k], plain_ms=plain_sub[k], bound_ms=bounds[k][0],
                                    bound_by=bounds[k][1]) for k in k1_kernels})
        log(f"K1 {name}: equal after normalization ({compared})"
            + ("" if m == n_pts else "; its whole sum equals the host's")
            + f"; wrapper {wrapper_ms:.3f} ms (bound {total[0]:.3f} ms by {total[1]}; plain "
            + (f"{plain_ms:.0f} ms" if m == n_pts else
               f"{plain_ms:.0f} ms against the kernel's {prefix_ms:.3f} ms on the prefix")
            + f"), c={c} nwin={nwin}; "
            + ", ".join(f"{k} {sub_ms[k]:.3f} ms (bound {bounds[k][0]:.3f})" for k in k1_kernels))
        del d_cmp, negs_cmp
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
        "the plain walk covers K1c and K1d together: K1c's plain_ms is the whole plain K1's "
        "time, its plan included")
    records["K1c_bucket_walk"]["wrapper_cases"] = {
        name: {key: v[key] for key in ("ms", "plain_ms", "prefix_ms", "prefix_plain_ms",
                                       "bound_ms", "bound_by", "adds", "compared") if key in v}
        for name, v in k1.items()}
    del cases

    # --- K2b -------------------------------------------------------------------
    mark("K2b")
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
    G, T, L = MK.aggregate_geometry(nwin, nb)
    records["K2b_bucket_aggregate"] = dict(
        ms=k2b_ms, plain_ms=k2b_plain, bound_ms=bm, bound_by=by, max_abs_err=k2b_err,
        shape=f"nwin={nwin} nb={nb} (c={c}), {G} blocks a window of {T} threads x {L} "
              f"buckets",
        bound_adds=need, adds=adds, dependent_adds=chain)
    log(f"K2b: equal on random sums and on K1's output; {nwin} x {nb} buckets {k2b_ms:.3f} ms "
        f"(plain {k2b_plain:.1f} ms, bound {bm:.4f} ms by {by} from {need} adds; the kernel "
        f"makes {adds} adds, a chain of {chain} dependent adds)")
    del rnd_sums, k1_random_sums

    # --- msm -----------------------------------------------------------------
    mark("msm")
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
    s_ints = F.to_ints(fr, sc)
    require(M.msm_base(pts, pre) == tau_msm(s_ints[:1024], tau_pts),
            "MSM of a 2^10 prefix equals the host sum")
    require(full == tau_msm(s_ints, tau_pts), "MSM at 2^21 equals the host sum")
    require(g1.add(M.msm_base(pts, pre), M.msm_base(pts, rest)) == full, "MSM is linear")
    log(f"msm: n=2^21 {msm_s * 1e3:.1f} ms; equal to the host sum, on a 2^10 prefix and "
        f"whole; linear")
    del sc, pre, rest
    torch.cuda.empty_cache()

    # --- K1-fixed --------------------------------------------------------------
    mark("K1-fixed")
    records["K1_fixed"], records["K1c_fixed_walk"] = k1_fixed_phase(torch, dev, gen, pts)
    del pts

    # --- K6 --------------------------------------------------------------------
    mark("K6")
    records["K6_g1_decompress"] = g1_decompress_phase(torch, dev, args.seed)

    # --- devices: one circuit, GPU and CPU, same proof bytes ------------------
    mark("devices")
    gpu = k6_proofs("cuda", args.seed)
    require(gpu["proofs"]["fixed"] == gpu["proofs"]["vanilla"],
            "the fixed-mode K=6 proof on cuda equals the vanilla proof")
    require(all(gpu["fixed_launches"][k] > 0 for k in FIXED_ONLY),
            "the fixed form (its scatter and walk) launched at K=6")
    cpu = cpu_k6.result()
    require(cpu["proofs"]["vanilla"] == gpu["proofs"]["vanilla"],
            "GPU and CPU proofs are byte-identical")
    require(cpu["proofs"]["fixed"] == gpu["proofs"]["vanilla"],
            "the fixed-mode K=6 proof on cpu equals the vanilla proof")
    log(f"devices: K=6 proof bytes equal on cuda and cpu, vanilla and under "
        f"SPECTRE_MSM_MODE=fixed (cuda {gpu['seconds']:.1f} s; cpu {cpu['seconds']:.1f} s in "
        f"the worker process)")

    # --- slice ---------------------------------------------------------------
    mark("slice")
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
    mark("committee-kernels")
    geometry = geometry_kernels(torch, dev, gen, args.seed, COMMITTEE_K, 4)
    log("committee-kernels: " + json.dumps(geometry))
    for name, key in (("K1c_bucket_walk", "K1"), ("K2b_bucket_aggregate", "K2b"),
                      ("K4_ntt", "K4")):
        records[name]["committee_geometry"] = geometry[key]
    # --- acquire: beacon data -> the args the committee and the step prove ---
    mark("acquire")
    acquired = acquire(torch, dev, fixture, fixture_dir)
    # --- boot: the prover service's state keys both circuits ------------------
    mark("boot")
    boot = boot_service(torch, dev, committee_args, step_args,
                        os.path.join(service_dir, "params"))
    log("resident before the committee: " + resident(torch))
    mark("committee")
    committee = committee_path(torch, dev, args.seed, boot["committee"], acquired)
    del committee["ctx"]
    torch.cuda.empty_cache()
    log("resident before the step: " + resident(torch))
    mark("step")
    step = step_path(torch, dev, args.seed, boot["step"], acquired)
    torch.cuda.empty_cache()
    mark("mesh")
    mesh = mesh_path(torch, dev, args.seed, step, boot["step"])
    torch.cuda.empty_cache()
    # the committee's outer build (minutes of one Python thread) runs in the
    # worker process beside the service, farm and step-aggregation phases.
    # Started here, not after the committee phase: its result (gigabytes,
    # unpickled in this process under the GIL) then lands in the
    # step-aggregation's build, not in the farm's measured drill; and not
    # before the mesh phase, whose prove is held against the step phase's
    # under the same host load
    committee_build = pool.submit(outer_build, "committee", vk_to_ints(committee["vk"]),
                                  committee["vk"].digest(), committee["instances"],
                                  committee["proof"])
    # --- service: the state's keys serve requests over HTTP ------------------
    log("resident before the service: " + resident(torch))
    mark("service")
    head_port = free_port()
    service = service_path(torch, dev, boot, acquired, os.path.join(service_dir, "journal"),
                           announce=f"http://127.0.0.1:{head_port}")
    # --- farm: the proof farm, the follower, the gateway over the service ----
    try:
        log("resident before the farm: " + resident(torch))
        mark("farm")
        farm = farm_path(torch, dev, boot, acquired, committee, service,
                         os.path.join(service_dir, "farm"), head_port, args.seed)
    finally:
        stop_server(service["server"], boot["state"])
    # the keys leave the card with the state
    boot["state"].step_pk = boot["state"].committee_pk = None
    del boot
    gc.collect()
    torch.cuda.empty_cache()
    log("resident before the step's aggregation: " + resident(torch))
    mark("step-aggregation")
    step_agg = aggregation_path(torch, dev, args.seed, step, "step")
    torch.cuda.empty_cache()
    # the EVM checks are host work on the card's proofs: the worker process
    # runs them beside the next phases
    step_sol, step_gen_s = generated_verifier(step_agg, "step")
    step_evm = pool.submit(evm_checks_apart, step_sol, step_agg["instances"], step_agg["proof"],
                           "step", step["args"], acquired["genesis"])
    # --- aggregation, aggregation-kernels ----------------------------------------
    log("resident before the aggregation: " + resident(torch))
    mark("aggregation")
    agg = aggregation_path(torch, dev, args.seed, committee, "committee",
                           prebuilt=committee_build)
    committee_sol, committee_gen_s = generated_verifier(agg, "committee")
    committee_evm = pool.submit(evm_checks_apart, committee_sol, agg["instances"], agg["proof"],
                                "committee", committee["args"], acquired["genesis"])
    torch.cuda.empty_cache()
    mark("aggregation-kernels")
    geometry = geometry_kernels(torch, dev, gen, args.seed, AGG_K, 2)
    log("aggregation-kernels: " + json.dumps(geometry))
    for name, key in (("K1c_bucket_walk", "K1"), ("K2b_bucket_aggregate", "K2b"),
                      ("K4_ntt", "K4")):
        records[name]["aggregation_geometry"] = geometry[key]
    # --- evm -----------------------------------------------------------------------
    mark("evm")
    for name, job, gen_s in (("step", step_evm, step_gen_s),
                             ("committee", committee_evm, committee_gen_s)):
        evm, text = job.result()
        evm["seconds"]["generate"] = gen_s
        log(f"evm {name} (in the worker process):\n{text.rstrip()}\nevm {name}: "
            + json.dumps(evm))

    kernels = []
    for name, info in KL.KERNELS.items():
        rec = dict(records[name])
        by_mode = {mode: v["launches"][name] for mode, v in step["modes"].items()}
        committee_by_mode = {mode: v["launches"][name]
                             for mode, v in committee["modes"].items()}
        # the fixed form's path is the fixed-mode step prove, K6's the
        # acquisition, K7's and K8's the committee prove under the MXU
        # knobs, every other kernel's the slice
        launches = (by_mode["fixed"] if name in FIXED_ONLY else
                    committee_by_mode[MXU] if name in MXU_ONLY else
                    acquired["launches"][name] if name == "K6_g1_decompress" else counts[name])
        kernels.append({
            "name": name, "route": "cuda", "source": info.source,
            "replaces": info.replaces, "launches": launches,
            "acquire_launches": acquired["launches"][name],
            "step_launches_by_mode": by_mode,
            "committee_launches": committee["prove_launches"][name],
            "committee_launches_by_mode": committee_by_mode,
            "committee_keygen_launches": committee["keygen_launches"][name],
            "step_launches": step["prove_launches"][name],
            "mesh_launches": mesh["launches"][name],
            "step_keygen_launches": step["keygen_launches"][name],
            "service_launches": service["launches"][name],
            "farm_launches": farm["launches"][name],
            "step_aggregation_launches": step_agg["phases"]["prove"]["launches"].get(name, 0),
            "step_aggregation_keygen_launches":
                step_agg["phases"]["keygen"]["launches"].get(name, 0),
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
