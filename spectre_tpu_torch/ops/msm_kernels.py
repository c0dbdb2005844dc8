"""Kernels K1 (bucket accumulation), K2 (complete projective addition) and
K2b (weighted bucket aggregation) of the Pippenger MSM, each with its plain
PyTorch version, and the window combine.

K2 replaces `spectre_tpu/ops/msm_pallas.py::_padd_soa_call` (the
`pallas_call` at :222, kernel body `_k_padd`). CUDA: csrc/msm_kernels.cu
`padd_kernel`, one thread per point pair, 8 x 32-bit limbs with 64-bit
products, all intermediates in registers. Bound on the H100: integer
multiply issue. One add is 12 Montgomery products of 257 32-bit
multiply-adds each, against 288 bytes moved per pair (two 96-byte points in,
one out): 10.7 multiply-adds per byte, twice the card's 5 per byte (16.75
T/s over 3.35 TB/s). The design spends nothing on memory beyond one 96-byte
load per operand and one store.

K1 replaces `msm_pallas.py::_bucket_sums` (the `pallas_call` at :399,
kernel body `_k_bucket_accumulate`): Pippenger signed-digit bucket sums.
It computes what the Pallas kernel computes, not how: the TPU design keeps
every bucket resident in VMEM (0.8 MB and up, more than one H100 block's
227 KB of shared memory) and adds each point into all 2^(c-1) bucket
columns to keep one, O(n * 2^(c-1)) adds. Here four kernels on the card
(csrc/msm_kernels.cu, bodies and design in csrc/bucket.cuh) do one
complete add per nonzero digit: a counting sort of the (window, point)
pairs by bucket (K1a count into shared-memory histograms, a torch.cumsum,
K1b scatter), a walk of the sorted entries in equal segments per thread,
each next point copied into shared memory by cp.async while the current
one is added, with a segmented tree reduction in shared memory (K1c), and
a warp per bucket for the buckets that cross walk blocks (K1d). Every
thread has the same work whatever the digits, so all-equal scalars (one
bucket holding every point, common in witness columns) cost no more than
random ones. No host sync, no sort from a library. Bound: integer
multiply throughput, one complete add per nonzero digit less one per
bucket; the gathers of 96-byte points in bucket order are the memory side.

K1's fixed-base form replaces the same `pallas_call` with points
[nwin, 48, N] (`_bucket_fixed_jit` :460, `msm_bucket_fixed` :492): window w
reads its own table T[w] = 2^(c w) [P ; phi(P)]. The table is built once
per base, cached, and normalised when it is built (every finite row Z = 1,
ops/msm.py `build_window_table`). The form runs K1a and its own scatter
(K1_fixed, entries naming row w * N + i of the table flattened to
[nwin * N, 24]), then its own walk (K1c_fixed, csrc/bucket.cuh
`k1f_walk_thread`): K1c's segments, tree and root, but each entry stages
only the row's X and Y and is added by the mixed complete formula (11
products where the complete add has 12), then K1d. Bound: integer multiply throughput, one mixed add per
nonzero digit less one per bucket. The cross-window merge after it is a K2
tree (`fold_windows_aos32`).

K2b replaces `msm_pallas.py::_aggregate_buckets_soa` (:356, an XLA loop
over K2: per digit bit a pairwise tree over the buckets with that bit set,
then a double-and-add over the bits; 32 K2 launches, 270 K adds at c = 11).
It computes sum_b b * B_b per window in one launch (csrc/msm_kernels.cu,
bodies and design in csrc/aggregate.cuh): a window's buckets spread over G
blocks, each a weighted tree in shared memory leaving its slice's (W, D),
and the window's last block to finish merges the G pairs by the same rule,
~4 nb adds a window. Bound: integer multiply throughput for those adds;
what holds it from the bound is the chain of ~2 log2 nb dependent adds (20
at c = 11).

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises. `padd_soa_plain`, `bucket_sums_plain`,
`bucket_sums_fixed_plain`, `bucket_walk_fixed_plain` and
`aggregate_buckets_plain` run on any device, for the tests and
chip_smoke.py.
"""

from __future__ import annotations

import torch

from ..fields import bn254
from . import ec
from . import kernel_lib as KL

NL = ec.NL
ROWS = ec.ROWS


# ---------------------------------------------------------------------------
# SoA layout helpers (reference: msm_pallas.to_soa / from_soa)
# ---------------------------------------------------------------------------

def to_soa(points: torch.Tensor) -> torch.Tensor:
    """[..., 3, 16] AoS 16-bit limbs -> [48, N] SoA."""
    a = points.reshape(-1, 3, NL)
    return a.permute(1, 2, 0).reshape(ROWS, a.shape[0]).contiguous()


def from_soa(arr: torch.Tensor) -> torch.Tensor:
    """[48, N] SoA -> [N, 3, 16] AoS."""
    return arr.reshape(3, NL, -1).permute(2, 0, 1).contiguous()


# ---------------------------------------------------------------------------
# K2: complete addition
# ---------------------------------------------------------------------------

def padd_aos32(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """K2 on AoS32 points [N, 24] int32 (the kernels' own layout)."""
    if p.shape != q.shape or p.device != q.device:
        raise ValueError("padd: operands differ in shape or device")
    if not p.is_cuda:
        return ec.rows16_to_aos32(_padd_rows16(ec.aos32_to_rows16(p),
                                               ec.aos32_to_rows16(q)))
    KL.require(p, "padd p", torch.int32, ndim=2, last=24)
    KL.require(q, "padd q", torch.int32, ndim=2, last=24)
    out = torch.empty_like(p)
    lib = KL.library("msm_kernels")
    KL.KERNELS["K2_padd"].launches += 1
    with KL.on_device(p):
        rc = lib.spt_padd(p.data_ptr(), q.data_ptr(), out.data_ptr(), p.shape[0],
                          KL.stream_of(p))
    KL.check_launch(rc, "K2_padd")
    return out


def padd_soa(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Complete projective add on SoA batches [48, N] int32 (the public
    form of K2: the reference's `padd_soa`). Repacks to AoS32 around the
    kernel."""
    _check_soa(p, "padd_soa p")
    _check_soa(q, "padd_soa q")
    if not p.is_cuda:
        return padd_soa_plain(p, q)
    return ec.aos32_to_soa16(padd_aos32(ec.soa16_to_aos32(p),
                                        ec.soa16_to_aos32(q)))


def padd_soa_plain(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Plain version of K2 on SoA [48, N]."""
    return ec.padd16(p.to(torch.int64), q.to(torch.int64)).to(torch.int32)


def _padd_rows16(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return ec.padd16(p.t(), q.t()).t()


def _check_soa(t: torch.Tensor, what: str) -> None:
    if t.dim() != 2 or t.shape[0] != ROWS:
        raise ValueError(f"{what}: expected [48, N], got {tuple(t.shape)}")
    if t.dtype != torch.int32:
        raise TypeError(f"{what}: expected int32, got {t.dtype}")


# ---------------------------------------------------------------------------
# K1: bucket accumulation
# ---------------------------------------------------------------------------

# the walk's geometry, as in csrc/bucket.cuh
K1_SEG = 32
K1_THREADS = 128
K1_BLOCK_ENTRIES = K1_SEG * K1_THREADS
PLAN_POINTS = 1 << 14    # points per K1a / K1b block
MAX_C = 16               # a window's histogram must fit shared memory


def plan_blocks(n: int) -> tuple[int, int]:
    """(points per plan block, plan blocks per window)."""
    return PLAN_POINTS, max(1, -(-n // PLAN_POINTS))


def bucket_counts_plain(digits: torch.Tensor, nb: int, P: int) -> torch.Tensor:
    """Plain version of K1a: counts[(w * nb + |d| - 1) * nblk + i // P] =
    the number of points i of block i // P with digit d != 0 in window w,
    int32 [nwin * nb * nblk]."""
    nwin, n = digits.shape
    nblk = max(1, -(-n // P))
    w_idx, p_idx = torch.nonzero(digits, as_tuple=True)
    keys = w_idx * nb + digits[w_idx, p_idx].to(torch.int64).abs() - 1
    return torch.bincount(keys * nblk + p_idx // P,
                          minlength=nwin * nb * nblk).to(torch.int32)


def bucket_offsets(counts: torch.Tensor, nkeys: int, nblk: int):
    """The plan's scan, torch ops on any device: (offs, bstart). offs
    [nkeys * nblk] is the exclusive prefix sum of the counts, each plan
    block's first slot per key; bstart [nkeys + 1] the bucket boundaries in
    the sorted entries (bstart[nkeys] = E, the entry count), int32."""
    incl = torch.cumsum(counts, 0, dtype=torch.int32)
    offs = incl - counts
    bstart = torch.cat([offs.view(nkeys, nblk)[:, 0], incl[-1:]])
    return offs, bstart.contiguous()


def bucket_scatter_plain(digits: torch.Tensor, negs: torch.Tensor, nb: int,
                         stride: int = 0) -> torch.Tensor:
    """Plain version of K1b: the entries row | sign << 31 of the nonzero
    digits, row = w * stride + point (stride 0 for a shared base, n for the
    fixed-base form's window table), sorted by key w * nb + |d| - 1 (by
    point inside a key), in an int32 [nwin * n] whose first E slots are
    used."""
    nwin, n = digits.shape
    w_idx, p_idx = torch.nonzero(digits, as_tuple=True)
    d = digits[w_idx, p_idx].to(torch.int64)
    keys = w_idx * nb + d.abs() - 1
    sign = (d < 0) ^ (negs[0, p_idx] != 0)
    order = torch.argsort(keys, stable=True)
    e = (w_idx[order] * stride + p_idx[order]) | (sign[order].to(torch.int64) << 31)
    out = torch.zeros(nwin * n, dtype=torch.int32, device=digits.device)
    out[:e.shape[0]] = (e - ((e >> 31) << 32)).to(torch.int32)
    return out


def bucket_walk_plain(pts: torch.Tensor, entries: torch.Tensor,
                      bstart: torch.Tensor) -> torch.Tensor:
    """Plain version of K1c and K1d together: the sum of each bucket's
    sorted entries, AoS32 [nkeys, 24], empty buckets at infinity. Each
    bucket is cut into chunks of at most chunk_len(E) entries, the chunks
    are walked one entry per step across all chunks, and the chunk sums of
    a bucket are folded pairwise."""
    dev = pts.device
    nkeys = bstart.shape[0] - 1
    ckey, cstart, clen, size = _chunks(bstart)
    acc = ec.aos32_to_rows16(ec.inf_aos32(ckey.shape[0], dev))
    for j in range(size):
        act = torch.nonzero(clen > j, as_tuple=True)[0]
        if act.numel() == 0:
            break
        e = entries[cstart[act] + j].to(torch.int64)
        # only the gathered rows widen to 16-bit limbs: a fixed-base table
        # of 2^22 points x 10 windows would take 16 GB as int64 limbs
        pt = ec.cneg16(e < 0, ec.aos32_to_rows16(pts[e & 0x7FFFFFFF]).t())   # [48, A]
        acc[act] = ec.padd16(acc[act].t(), pt).t()
    sums, keys = _fold(acc, ckey, _padd_rows16)
    out = ec.inf_aos32(nkeys, dev)
    out[keys] = ec.rows16_to_aos32(sums)
    return out


def _chunks(bstart: torch.Tensor):
    """The plain walks' chunks: each bucket cut into chunks of at most
    chunk_len(E) entries. (chunk key, first entry, length, the chunk
    size)."""
    dev = bstart.device
    starts = bstart[:-1].to(torch.int64)
    counts = bstart[1:].to(torch.int64) - starts
    size = chunk_len(int(bstart[-1]))
    nch = (counts + size - 1) // size
    ckey = torch.repeat_interleave(torch.arange(starts.shape[0], device=dev), nch)
    rank = torch.arange(ckey.numel(), device=dev) - (torch.cumsum(nch, 0) - nch)[ckey]
    cstart = starts[ckey] + rank * size
    clen = torch.clamp(starts[ckey] + counts[ckey] - cstart, max=size)
    return ckey, cstart, clen, size


def chunk_len(entries: int) -> int:
    """Entries per chunk of the plain walk: 4 while there are at most ~2^20
    chunks, doubling up to 32 beyond that, so the walk has few steps and
    the fold few rounds at any size."""
    size = 4
    while size < 32 and entries > size << 20:
        size *= 2
    return size


def _fold(items: torch.Tensor, keys: torch.Tensor, padd):
    """Sum the rows of `items` that share a key (keys sorted): rounds of
    pairwise adds of neighbours (ranks 2i, 2i+1 inside each key's run),
    one `padd` call per round. Returns (sums, distinct keys)."""
    while items.shape[0] > 1:
        n = keys.shape[0]
        idx = torch.arange(n, device=keys.device)
        first = torch.ones(n, dtype=torch.bool, device=keys.device)
        first[1:] = keys[1:] != keys[:-1]
        start = torch.cummax(torch.where(first, idx, torch.zeros_like(idx)), 0).values
        even = ((idx - start) % 2) == 0
        has = torch.zeros(n, dtype=torch.bool, device=keys.device)
        has[:-1] = even[:-1] & (keys[1:] == keys[:-1])
        if not bool(has.any()):
            break
        left = torch.nonzero(even, as_tuple=True)[0]
        pair = torch.nonzero(has, as_tuple=True)[0]
        merged = items.clone()
        merged[pair] = padd(items[pair].contiguous(), items[pair + 1].contiguous())
        items, keys = merged[left], keys[left]
    return items, keys


def _check_bucket_inputs(points, digits, negs, c):
    _check_soa(points, "bucket points")
    if digits.dim() != 2 or digits.shape[1] != points.shape[1]:
        raise ValueError(f"digits: expected [nwin, {points.shape[1]}], "
                         f"got {tuple(digits.shape)}")
    if negs.shape != (1, points.shape[1]):
        raise ValueError(f"negs: expected [1, {points.shape[1]}], got {tuple(negs.shape)}")
    if digits.dtype != torch.int32 or negs.dtype != torch.int32:
        raise TypeError("digits and negs must be int32")
    if not (points.device == digits.device == negs.device):
        raise ValueError("bucket inputs on different devices")
    if not 1 <= c <= MAX_C:
        raise ValueError(f"window {c} outside [1, {MAX_C}]")
    if digits.numel() and int(digits.abs().max()) > 1 << (c - 1):
        raise ValueError(f"digits outside [-2^{c - 1}, 2^{c - 1}]")


def buckets_soa(sums_aos: torch.Tensor, nwin: int, nb: int) -> torch.Tensor:
    """[nwin * nb, 24] AoS32 -> [nwin, 48, nb] SoA16."""
    return ec.aos32_to_soa16(sums_aos).reshape(ROWS, nwin, nb).permute(1, 0, 2).contiguous()


def bucket_sums(points: torch.Tensor, digits: torch.Tensor, negs: torch.Tensor,
                c: int) -> torch.Tensor:
    """K1: signed-digit bucket sums, in the reference's layout.

    points [48, n] int32 SoA Montgomery; digits [nwin, n] int32 in
    [-2^(c-1)+1, 2^(c-1)]; negs [1, n] int32 0/1 per-point sign (the GLV
    sign of the reference; 0 in vanilla mode). For each (window, point)
    with digit d != 0 the point, negated if (d < 0) xor its sign, is added
    into bucket |d|. Returns [nwin, 48, 2^(c-1)] int32, column j = bucket
    j + 1, empty buckets at infinity. Checks its inputs (the digit range
    costs a host sync), then runs `bucket_sums_aos32`."""
    _check_bucket_inputs(points, digits, negs, c)
    sums = bucket_sums_aos32(ec.soa16_to_aos32(points), digits, negs, c)
    return buckets_soa(sums, digits.shape[0], 1 << (c - 1))


def bucket_sums_plain(points: torch.Tensor, digits: torch.Tensor,
                      negs: torch.Tensor, c: int) -> torch.Tensor:
    """Plain version of K1 in the reference's layout, on any device: the
    plain plan (bincount, scan, stable sort) and the plain walk."""
    _check_bucket_inputs(points, digits, negs, c)
    sums = _bucket_sums_aos32_plain(ec.soa16_to_aos32(points), digits, negs, c)
    return buckets_soa(sums, digits.shape[0], 1 << (c - 1))


def bucket_plan_plain(digits: torch.Tensor, negs: torch.Tensor, c: int,
                      fixed: bool = False):
    """Plain version of K1a, the scan and K1b (K1_fixed's scatter where
    `fixed`): (counts, bstart, entries), the entries in a stable sort by
    key. Any device."""
    nwin, n = digits.shape
    nb = 1 << (c - 1)
    P, nblk = plan_blocks(n)
    counts = bucket_counts_plain(digits, nb, P)
    _, bstart = bucket_offsets(counts, nwin * nb, nblk)
    return counts, bstart, bucket_scatter_plain(digits, negs, nb, n if fixed else 0)


def _bucket_sums_aos32_plain(pts, digits, negs, c):
    _, bstart, entries = bucket_plan_plain(digits, negs, c)
    return bucket_walk_plain(pts, entries, bstart)


def bucket_plan(digits: torch.Tensor, negs: torch.Tensor, c: int, fixed: bool = False):
    """The entries of the nonzero digits sorted by bucket key: (counts,
    bstart, entries) as `bucket_plan_plain` defines them (the order inside
    a bucket is free). K1a, the scan and K1b (K1_fixed's scatter where
    `fixed`) on a CUDA tensor; the plain version on a CPU tensor."""
    if not digits.is_cuda:
        return bucket_plan_plain(digits, negs, c, fixed)
    nwin, n = digits.shape
    nb = 1 << (c - 1)
    nkeys = nwin * nb
    P, nblk = plan_blocks(n)
    KL.require(digits, "digits", torch.int32, ndim=2)
    KL.require(negs, "negs", torch.int32, ndim=2)
    if negs.shape != (1, n) or negs.device != digits.device:
        raise ValueError("bucket plan: negs must be [1, n] beside the digits")
    if not 1 <= c <= MAX_C or nwin * n >= 1 << 31:
        raise ValueError(f"bucket plan: window {c} or size {nwin} x {n} out of range")
    dev, stream = digits.device, KL.stream_of(digits)
    lib = KL.library("msm_kernels")
    counts = torch.empty(nkeys * nblk, dtype=torch.int32, device=dev)
    KL.KERNELS["K1a_bucket_count"].launches += 1
    with KL.on_device(digits):
        KL.check_launch(lib.spt_k1_count(digits.data_ptr(), nwin, n, nb, P, nblk,
                                         counts.data_ptr(), stream), "K1a_bucket_count")
    offs, bstart = bucket_offsets(counts, nkeys, nblk)
    entries = torch.empty(max(nwin * n, 1), dtype=torch.int32, device=dev)
    scatter = "K1_fixed" if fixed else "K1b_bucket_scatter"
    KL.KERNELS[scatter].launches += 1
    with KL.on_device(digits):
        KL.check_launch(lib.spt_k1_scatter(digits.data_ptr(), negs.data_ptr(), nwin, n, nb,
                                           P, nblk, offs.data_ptr(), entries.data_ptr(),
                                           int(fixed), stream), scatter)
    return counts, bstart, entries


def bucket_walk(pts: torch.Tensor, entries: torch.Tensor, bstart: torch.Tensor) -> torch.Tensor:
    """Bucket sums of sorted entries (`bucket_plan`): AoS32 [nkeys, 24].
    K1c walk and K1d pieces on a CUDA tensor, with a grid sized for every
    slot of `entries` (the entry count E stays on the card); the plain walk
    on a CPU tensor."""
    if not pts.is_cuda:
        return bucket_walk_plain(pts, entries, bstart)
    KL.require(pts, "bucket points", torch.int32, ndim=2, last=24)
    KL.require(entries, "entries", torch.int32, ndim=1)
    KL.require(bstart, "bstart", torch.int32, ndim=1)
    if not (pts.device == entries.device == bstart.device):
        raise ValueError("bucket walk inputs on different devices")
    dev, stream = pts.device, KL.stream_of(pts)
    nkeys = bstart.shape[0] - 1
    max_entries = entries.shape[0]
    nwalk = -(-max_entries // K1_BLOCK_ENTRIES)
    lib = KL.library("msm_kernels")
    out = torch.empty((nkeys, 24), dtype=torch.int32, device=dev)
    pieces = torch.empty((max(2 * nwalk, 1), 24), dtype=torch.int32, device=dev)
    KL.KERNELS["K1c_bucket_walk"].launches += 1
    KL.KERNELS["K1d_bucket_pieces"].launches += 1
    with KL.on_device(pts):
        KL.check_launch(lib.spt_k1_walk(pts.data_ptr(), entries.data_ptr(), bstart.data_ptr(),
                                        nkeys, max_entries, out.data_ptr(), pieces.data_ptr(),
                                        stream), "K1c_bucket_walk")
        KL.check_launch(lib.spt_k1_pieces(bstart.data_ptr(), nkeys, pieces.data_ptr(),
                                          out.data_ptr(), stream), "K1d_bucket_pieces")
    return out


def bucket_walk_fixed_plain(table: torch.Tensor, entries: torch.Tensor,
                            bstart: torch.Tensor) -> torch.Tensor:
    """Plain version of the fixed walk (K1c_fixed and K1d) over a normalised
    table [nwin * N, 24] (finite rows Z = 1, rows at infinity Z = 0): the
    kernel's adds, as the kernel makes them. Each bucket is cut into chunks
    as `bucket_walk_plain` cuts it; a chunk starts from its first row (at
    infinity for a row at infinity) and adds each later row by the mixed
    formula (`ec.madd16`), skipping rows at infinity; the chunk sums of a
    bucket are folded by complete adds. AoS32 [nkeys, 24], empty buckets at
    infinity."""
    dev = table.device
    nkeys = bstart.shape[0] - 1
    ckey, cstart, clen, size = _chunks(bstart)
    acc = ec.aos32_to_rows16(ec.inf_aos32(ckey.shape[0], dev))
    for j in range(size):
        act = torch.nonzero(clen > j, as_tuple=True)[0]
        if act.numel() == 0:
            break
        e = entries[cstart[act] + j].to(torch.int64)
        rows = table[e & 0x7FFFFFFF]
        finite = rows[:, 16] != 0                      # the Z word
        pt = ec.cneg16(e < 0, ec.aos32_to_rows16(rows).t())    # [48, A]
        if j == 0:
            acc[act] = torch.where(finite[:, None], pt.t(), acc[act])
            continue
        summed = ec.madd16(acc[act].t(), pt[:32]).t()
        acc[act] = torch.where(finite[:, None], summed, acc[act])
    sums, keys = _fold(acc, ckey, _padd_rows16)
    out = ec.inf_aos32(nkeys, dev)
    out[keys] = ec.rows16_to_aos32(sums)
    return out


def bucket_walk_fixed(table: torch.Tensor, entries: torch.Tensor,
                      bstart: torch.Tensor) -> torch.Tensor:
    """Bucket sums of sorted entries over a normalised window table [nwin *
    N, 24] (`bucket_walk_fixed_plain` says what it must hold): AoS32
    [nkeys, 24]. K1c_fixed and K1d on a CUDA tensor, with a grid sized for
    every slot of `entries`; the plain version on a CPU tensor."""
    if not table.is_cuda:
        return bucket_walk_fixed_plain(table, entries, bstart)
    KL.require(table, "fixed table", torch.int32, ndim=2, last=24)
    KL.require(entries, "entries", torch.int32, ndim=1)
    KL.require(bstart, "bstart", torch.int32, ndim=1)
    if not (table.device == entries.device == bstart.device):
        raise ValueError("fixed walk inputs on different devices")
    dev, stream = table.device, KL.stream_of(table)
    nkeys = bstart.shape[0] - 1
    max_entries = entries.shape[0]
    nwalk = -(-max_entries // K1_BLOCK_ENTRIES)
    lib = KL.library("msm_kernels")
    out = torch.empty((nkeys, 24), dtype=torch.int32, device=dev)
    pieces = torch.empty((max(2 * nwalk, 1), 24), dtype=torch.int32, device=dev)
    KL.KERNELS["K1c_fixed_walk"].launches += 1
    KL.KERNELS["K1d_bucket_pieces"].launches += 1
    with KL.on_device(table):
        KL.check_launch(lib.spt_k1_fixed_walk(table.data_ptr(), entries.data_ptr(),
                                              bstart.data_ptr(), nkeys, max_entries,
                                              out.data_ptr(), pieces.data_ptr(), stream),
                        "K1c_fixed_walk")
        KL.check_launch(lib.spt_k1_pieces(bstart.data_ptr(), nkeys, pieces.data_ptr(),
                                          out.data_ptr(), stream), "K1d_bucket_pieces")
    return out


def bucket_sums_aos32(pts: torch.Tensor, digits: torch.Tensor, negs: torch.Tensor,
                      c: int) -> torch.Tensor:
    """K1 on the kernels' layout: points AoS32 [n, 24] -> bucket sums AoS32
    [nwin * 2^(c-1), 24], row w * 2^(c-1) + j = bucket j + 1 of window w.
    The digits must lie in [-2^(c-1), 2^(c-1)] (the MSM's recode makes them
    so; `bucket_sums` checks them). On a CUDA tensor K1a, the scan, K1b,
    K1c and K1d run with no host round trip; the plain version on a CPU
    tensor."""
    if pts.shape[0] != digits.shape[1]:
        raise ValueError("bucket sums: points and digits disagree on n")
    if not pts.is_cuda:
        return _bucket_sums_aos32_plain(pts, digits, negs, c)
    _, bstart, entries = bucket_plan(digits, negs, c)
    return bucket_walk(pts, entries, bstart)


# ---------------------------------------------------------------------------
# K1, fixed-base form
# ---------------------------------------------------------------------------

def _check_fixed_inputs(table, digits):
    """The fixed form's own checks on an AoS32 table [nwin, N, 24]."""
    if table.dim() != 3 or table.shape[2] != 24:
        raise ValueError(f"fixed table: expected [nwin, N, 24], got {tuple(table.shape)}")
    nwin, N = table.shape[0], table.shape[1]
    if digits.shape != (nwin, N):
        raise ValueError(f"digits: expected [{nwin}, {N}], got {tuple(digits.shape)}")
    if nwin * N >= 1 << 31:
        raise ValueError(f"fixed table of {nwin} x {N} rows: an entry holds a row below 2^31")


def bucket_sums_fixed_aos32(table: torch.Tensor, digits: torch.Tensor,
                            negs: torch.Tensor, c: int) -> torch.Tensor:
    """K1's fixed-base form (the reference's `_bucket_sums` with points
    [nwin, 48, N], driven by `_bucket_fixed_jit`): window w adds its own
    points table[w] (T[w] = 2^(c w) [P ; phi(P)]) into its buckets. table
    AoS32 [nwin, N, 24], normalised (every finite row Z = 1, a row at
    infinity Z = 0: `build_window_table` makes it so; `bucket_sums_fixed`
    checks it), digits [nwin, N] int32, negs [1, N] int32 -> bucket sums
    AoS32 [nwin * 2^(c-1), 24] as `bucket_sums_aos32` lays them out. On a
    CUDA tensor K1a, the scan, K1_fixed's scatter (entries w * N + i),
    K1c_fixed and K1d; the plain version on a CPU tensor."""
    _check_fixed_inputs(table, digits)
    rows = table.reshape(-1, 24)
    if not table.is_cuda:
        return _bucket_sums_fixed_aos32_plain(rows, digits, negs, c)
    _, bstart, entries = bucket_plan(digits, negs, c, fixed=True)
    return bucket_walk_fixed(rows, entries, bstart)


def _bucket_sums_fixed_aos32_plain(rows, digits, negs, c):
    _, bstart, entries = bucket_plan_plain(digits, negs, c, fixed=True)
    return bucket_walk_fixed_plain(rows, entries, bstart)


def check_normalised(table: torch.Tensor) -> None:
    """Raise unless every row of the AoS32 table [..., 24] has Z = 1 (the
    Montgomery one) or is infinity (X = 0, Z = 0): the fixed walk's
    precondition. A host sync."""
    rows = table.reshape(-1, 24)
    one = ec.inf_aos32(1, rows.device)[0, 8:16]
    z = rows[:, 16:]
    finite = (z == one).all(dim=1)
    inf = (z == 0).all(dim=1) & (rows[:, :8] == 0).all(dim=1)
    if not bool((finite | inf).all()):
        raise ValueError("fixed table: rows must be normalised (Z = 1, or infinity)")


def to_soa_windows(table: torch.Tensor) -> torch.Tensor:
    """AoS32 window tables [nwin, N, 24] -> [nwin, 48, N] SoA16 (the
    reference's `to_soa_windows` layout)."""
    return torch.stack([ec.aos32_to_soa16(t) for t in table])


def _fixed_soa_to_aos32(table, digits, negs, c):
    if table.dim() != 3:
        raise ValueError(f"fixed table: expected [nwin, 48, N], got {tuple(table.shape)}")
    _check_bucket_inputs(table[0], digits, negs, c)
    aos = torch.stack([ec.soa16_to_aos32(t) for t in table])
    _check_fixed_inputs(aos, digits)
    check_normalised(aos)
    return aos


def bucket_sums_fixed(table: torch.Tensor, digits: torch.Tensor, negs: torch.Tensor,
                      c: int) -> torch.Tensor:
    """K1's fixed-base form in the reference's layout: table [nwin, 48, N]
    int32 SoA window tables, normalised -> [nwin, 48, 2^(c-1)] bucket sums.
    Checks its inputs as `bucket_sums` does, and the table's normalisation,
    then runs `bucket_sums_fixed_aos32`."""
    aos = _fixed_soa_to_aos32(table, digits, negs, c)
    sums = bucket_sums_fixed_aos32(aos, digits, negs, c)
    return buckets_soa(sums, digits.shape[0], 1 << (c - 1))


def bucket_sums_fixed_plain(table: torch.Tensor, digits: torch.Tensor,
                            negs: torch.Tensor, c: int) -> torch.Tensor:
    """Plain version of K1's fixed-base form in the reference's layout, on
    any device: the plain plan with entries w * N + i, the plain fixed
    walk."""
    aos = _fixed_soa_to_aos32(table, digits, negs, c)
    sums = _bucket_sums_fixed_aos32_plain(aos.reshape(-1, 24), digits, negs, c)
    return buckets_soa(sums, digits.shape[0], 1 << (c - 1))


def fold_windows_aos32(sums: torch.Tensor, nwin: int, nb: int) -> torch.Tensor:
    """The fixed form's cross-window merge (msm_pallas.py:500-508): bucket
    b of every window summed, [nwin * nb, 24] -> [nb, 24], by a tree over
    the windows with one K2 launch a level (halves added pairwise, an odd
    last window carried)."""
    acc = sums.reshape(nwin, nb, 24)
    while acc.shape[0] > 1:
        k, half = acc.shape[0], acc.shape[0] // 2
        merged = padd_aos32(acc[:half].reshape(-1, 24).contiguous(),
                            acc[half:2 * half].reshape(-1, 24).contiguous())
        acc = torch.cat([merged.reshape(half, nb, 24), acc[2 * half:]])
    return acc.reshape(nb, 24)


# ---------------------------------------------------------------------------
# K2b: weighted bucket aggregation
# ---------------------------------------------------------------------------

K2B_THREADS = 128        # as in csrc/aggregate.cuh
K2B_FILL = 128

# per device: one ticket counter a window, zero between launches (K2b's last
# block of a window sets its counter back); K2b runs on the current stream
_K2B_TICKETS: dict = {}


def aggregate_geometry(nwin: int, nb: int) -> tuple[int, int, int]:
    """(blocks a window G, threads a block T, buckets a thread L) for nwin
    windows of nb buckets, a power of two (csrc/aggregate.cuh
    `k2b_geometry`): G doubles while nwin * G < K2B_FILL and (2G)^2 <= nb;
    a block's slice of S = nb / G buckets has T = min(128, S) threads."""
    if nb < 1 or nb & (nb - 1):
        raise ValueError(f"aggregate: {nb} buckets is not a power of two")
    G = 1
    while (2 * G) ** 2 <= nb and nwin * G < K2B_FILL:
        G *= 2
    S = nb // G
    T = min(K2B_THREADS, S)
    return G, T, S // T


def _tickets(nwin: int, device) -> torch.Tensor:
    t = _K2B_TICKETS.get(device)
    if t is None or t.shape[0] < nwin:
        t = torch.zeros(max(nwin, 64), dtype=torch.int32, device=device)
        _K2B_TICKETS[device] = t
    return t


def aggregate_buckets_aos32(sums: torch.Tensor, nwin: int, nb: int) -> torch.Tensor:
    """K2b: sum_{b=1}^{nb} b * B_b per window. sums AoS32 [nwin * nb, 24]
    as `bucket_sums_aos32` returns them (row w * nb + j = bucket j + 1 of
    window w) -> AoS32 [nwin, 24]. One launch of nwin * G blocks on a CUDA
    tensor; the plain version, which makes the same adds in the same order,
    on a CPU tensor."""
    G, _, _ = aggregate_geometry(nwin, nb)
    if sums.shape != (nwin * nb, 24):
        raise ValueError(f"aggregate: expected [{nwin * nb}, 24], got {tuple(sums.shape)}")
    if not sums.is_cuda:
        return aggregate_buckets_plain(sums, nwin, nb)
    KL.require(sums, "aggregate sums", torch.int32, ndim=2, last=24)
    out = torch.empty((nwin, 24), dtype=torch.int32, device=sums.device)
    pairs = torch.empty((max(nwin * G, 1), 48), dtype=torch.int32, device=sums.device)
    tickets = _tickets(nwin, sums.device)
    lib = KL.library("msm_kernels")
    KL.KERNELS["K2b_bucket_aggregate"].launches += 1
    with KL.on_device(sums):
        KL.check_launch(lib.spt_k2b_aggregate(sums.data_ptr(), nwin, nb, pairs.data_ptr(),
                                              tickets.data_ptr(), out.data_ptr(),
                                              KL.stream_of(sums)), "K2b_bucket_aggregate")
    return out


def aggregate_buckets_plain(sums: torch.Tensor, nwin: int, nb: int) -> torch.Tensor:
    """Plain version of K2b in torch ops through `ec.padd16`, any device,
    with the kernel's geometry (`aggregate_geometry`): each thread's run
    walked from the top (R += B, W += R), D = L * R, then each block's tree
    W_t = (W_t + W_{t+d}) + D_{t+d}, D_t = 2 (D_t + D_{t+d}), and, where a
    window spans G > 1 blocks, the same tree over the blocks' (W, D); all
    threads of all blocks at once. The kernel's adds in the kernel's order:
    the two agree limb for limb in projective form."""
    G, T, L = aggregate_geometry(nwin, nb)
    rows = ec.aos32_to_rows16(sums).reshape(nwin * G * T, L, ROWS)
    r = rows[:, L - 1]
    w = r
    for j in range(L - 2, -1, -1):
        r = _padd_rows16(r, rows[:, j])
        w = _padd_rows16(w, r)
    for _ in range(L.bit_length() - 1):
        r = _padd_rows16(r, r)
    W, D = _aggregate_tree(w.reshape(nwin * G, T, ROWS), r.reshape(nwin * G, T, ROWS),
                           last_d=G > 1)
    if G > 1:
        W, D = _aggregate_tree(W[:, 0].reshape(nwin, G, ROWS),
                               D[:, 0].reshape(nwin, G, ROWS), last_d=False)
    return ec.rows16_to_aos32(W[:, 0])


def _aggregate_tree(W: torch.Tensor, D: torch.Tensor, last_d: bool):
    """K2b's tree over the n nodes of each row of W, D [m, n, 48] (the
    block's threads, or a window's blocks); `last_d`: the last level's D is
    needed (a block's, for the window's merge)."""
    W, D = W.clone(), D.clone()
    m, n = W.shape[0], W.shape[1]
    d = 1
    while d < n:
        left = torch.arange(0, n, 2 * d, device=W.device)
        new_w = _padd_rows16(_padd_rows16(_flat(W[:, left]), _flat(W[:, left + d])),
                             _flat(D[:, left + d]))
        if 2 * d < n or last_d:
            s = _padd_rows16(_flat(D[:, left]), _flat(D[:, left + d]))
            D[:, left] = _padd_rows16(s, s).reshape(m, -1, ROWS)
        W[:, left] = new_w.reshape(m, -1, ROWS)
        d *= 2
    return W, D


def _flat(rows: torch.Tensor) -> torch.Tensor:
    return rows.reshape(-1, ROWS)


# ---------------------------------------------------------------------------
# window combine
# ---------------------------------------------------------------------------

def combine_windows(window_sums: torch.Tensor, c: int):
    """sum_w 2^(c w) W_w -> affine (Fq, Fq) | None. The AoS32 [nwin, 24]
    window sums cross to the host once and the c doublings and one add per
    window run there in exact affine arithmetic: 24 points, a few
    milliseconds, where the reference's device loop is a serial chain of
    264 one-point adds."""
    pts = ec.decode_points(window_sums)
    g1 = bn254.g1_curve
    acc = None
    for w in reversed(pts):
        for _ in range(c):
            acc = g1.double(acc)
        acc = g1.add(acc, w)
    return acc
