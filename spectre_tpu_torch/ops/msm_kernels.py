"""Kernels K1 (bucket accumulation) and K2 (complete projective addition)
of the Pippenger MSM, each with its plain PyTorch version; the weighted
bucket aggregation built on K2, and the window combine.

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
columns to keep one, O(n * 2^(c-1)) adds. Here the (window, point) pairs
are grouped by bucket first (a sort in torch ops, prep), then one thread
per chunk of at most `chunk_len` sorted entries of one bucket walks them with
the complete add into a partial sum in device memory (csrc/msm_kernels.cu
`bucket_chunk_kernel`), and K2 folds the partials of each bucket pairwise.
Chunking keeps a bucket that holds every point (all scalars equal, common
in witness columns) from serializing on one thread. Bound: integer multiply
issue, one complete add per nonzero digit; the gathers of 96-byte points in
bucket order are the memory side.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises. `padd_soa_plain` and `bucket_sums_plain`
run on any device, for the tests and chip_smoke.py.
"""

from __future__ import annotations

import torch

from ..fields import bn254
from . import ec
from . import kernel_lib as KL

NL = ec.NL
ROWS = ec.ROWS
MAX_CHUNK = 32      # most sorted entries one K1 thread walks


# ---------------------------------------------------------------------------
# SoA layout helpers (reference: msm_pallas.to_soa / from_soa / inf_soa)
# ---------------------------------------------------------------------------

def to_soa(points: torch.Tensor) -> torch.Tensor:
    """[..., 3, 16] AoS 16-bit limbs -> [48, N] SoA."""
    a = points.reshape(-1, 3, NL)
    return a.permute(1, 2, 0).reshape(ROWS, a.shape[0]).contiguous()


def from_soa(arr: torch.Tensor) -> torch.Tensor:
    """[48, N] SoA -> [N, 3, 16] AoS."""
    return arr.reshape(3, NL, -1).permute(2, 0, 1).contiguous()


def inf_soa(n: int, device) -> torch.Tensor:
    """Projective infinity (0:1:0) as [48, n]."""
    return ec.aos32_to_soa16(ec.inf_aos32(1, device)).repeat(1, n)


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

def chunk_len(entries: int) -> int:
    """Entries per K1 chunk: 4 while there are at most ~2^20 chunks (the
    walk then has few serial steps and the card still has 4x more threads
    than it holds at once), doubling up to MAX_CHUNK beyond that so the
    fold's extra adds stay a small fraction of the walk's."""
    size = 4
    while size < MAX_CHUNK and entries > size << 20:
        size *= 2
    return size


def _bucket_plan(digits: torch.Tensor, negs: torch.Tensor, nb: int):
    """Group the nonzero (window, point) digits by bucket and cut every
    bucket into chunks of at most `chunk_len(E)` entries.

    Returns (entries int32 [E] sorted by bucket key = w * nb + |d| - 1, each
    the point index with the sign bit set where the point enters negated;
    chunk_start int64 [C]; chunk_len int32 [C]; chunk_key int64 [C])."""
    nwin, n = digits.shape
    d = digits.to(torch.int64)
    nz = d != 0
    w_idx, p_idx = torch.nonzero(nz, as_tuple=True)
    dv = d[w_idx, p_idx]
    keys = w_idx * nb + dv.abs() - 1
    sign = (dv < 0) ^ (negs[0, p_idx] != 0)
    order = torch.argsort(keys, stable=True)
    keys = keys[order]
    entries = (p_idx[order] | (sign[order].to(torch.int64) << 31))
    entries = (entries - ((entries >> 31) << 32)).to(torch.int32)
    size = chunk_len(keys.shape[0])
    counts = torch.bincount(keys, minlength=nwin * nb)
    starts = torch.cumsum(counts, 0) - counts
    nch = (counts + size - 1) // size
    chunk_key = torch.repeat_interleave(torch.arange(nwin * nb, device=d.device), nch)
    first_chunk = torch.cumsum(nch, 0) - nch
    rank = torch.arange(chunk_key.numel(), device=d.device) - first_chunk[chunk_key]
    chunk_start = starts[chunk_key] + rank * size
    lens = torch.clamp(starts[chunk_key] + counts[chunk_key] - chunk_start,
                       max=size).to(torch.int32)
    return entries.contiguous(), chunk_start.contiguous(), lens.contiguous(), chunk_key


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


def _scatter_buckets(sums_aos: torch.Tensor, keys: torch.Tensor, nwin: int, nb: int):
    out = ec.inf_aos32(nwin * nb, sums_aos.device)
    out[keys] = sums_aos
    return ec.aos32_to_soa16(out).reshape(ROWS, nwin, nb).permute(1, 0, 2).contiguous()


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
    if digits.numel() and int(digits.abs().max()) > 1 << (c - 1):
        raise ValueError(f"digits outside [-2^{c - 1}, 2^{c - 1}]")


def bucket_sums(points: torch.Tensor, digits: torch.Tensor, negs: torch.Tensor,
                c: int) -> torch.Tensor:
    """K1: signed-digit bucket sums.

    points [48, n] int32 SoA Montgomery; digits [nwin, n] int32 in
    [-2^(c-1)+1, 2^(c-1)]; negs [1, n] int32 0/1 per-point sign (the GLV
    sign of the reference; 0 in vanilla mode). For each (window, point)
    with digit d != 0 the point, negated if (d < 0) xor its sign, is added
    into bucket |d|. Returns [nwin, 48, 2^(c-1)] int32, column j = bucket
    j + 1, empty buckets at infinity."""
    _check_bucket_inputs(points, digits, negs, c)
    if not points.is_cuda:
        return bucket_sums_plain(points, digits, negs, c)
    nwin, nb = digits.shape[0], 1 << (c - 1)
    entries, cstart, clen, ckey = _bucket_plan(digits, negs, nb)
    nchunks = ckey.shape[0]
    if nchunks == 0:
        return _scatter_buckets(ec.inf_aos32(0, points.device), ckey, nwin, nb)
    pts = ec.soa16_to_aos32(points)
    partials = torch.empty((nchunks, 24), dtype=torch.int32, device=points.device)
    lib = KL.library("msm_kernels")
    KL.KERNELS["K1_bucket_accumulate"].launches += 1
    rc = lib.spt_bucket_chunks(pts.data_ptr(), entries.data_ptr(), cstart.data_ptr(),
                               clen.data_ptr(), partials.data_ptr(), nchunks,
                               KL.stream_of(pts))
    KL.check_launch(rc, "K1_bucket_accumulate")
    sums, keys = _fold(partials, ckey, padd_aos32)
    return _scatter_buckets(sums, keys, nwin, nb)


def bucket_sums_plain(points: torch.Tensor, digits: torch.Tensor,
                      negs: torch.Tensor, c: int) -> torch.Tensor:
    """Plain version of K1, on any device: the same bucket plan, the chunk
    walks advanced one entry per step across all chunks, the same fold."""
    _check_bucket_inputs(points, digits, negs, c)
    nwin, nb = digits.shape[0], 1 << (c - 1)
    entries, cstart, clen, ckey = _bucket_plan(digits, negs, nb)
    dev = points.device
    rows = points.t().to(torch.int64)                         # [n, 48]
    acc = ec.aos32_to_rows16(ec.inf_aos32(ckey.shape[0], dev))
    for j in range(MAX_CHUNK):
        act = torch.nonzero(clen > j, as_tuple=True)[0]
        if act.numel() == 0:
            break
        e = entries[cstart[act] + j].to(torch.int64)
        pt = rows[e & 0x7FFFFFFF].t()                          # [48, A]
        pt = ec.cneg16(e < 0, pt)
        acc[act] = ec.padd16(acc[act].t(), pt).t()
    sums, keys = _fold(acc, ckey, _padd_rows16)
    return _scatter_buckets(ec.rows16_to_aos32(sums), keys, nwin, nb)


# ---------------------------------------------------------------------------
# weighted bucket aggregation and window combine (K2)
# ---------------------------------------------------------------------------

def _tree_sum(cur: torch.Tensor, padd) -> torch.Tensor:
    """[48, W, k] -> [48, W]: pairwise tree over the last axis."""
    while cur.shape[2] > 1:
        k = cur.shape[2]
        half = k // 2
        w = cur.shape[1]
        merged = padd(cur[:, :, :half].reshape(ROWS, w * half).contiguous(),
                      cur[:, :, half:2 * half].reshape(ROWS, w * half).contiguous()
                      ).reshape(ROWS, w, half)
        cur = torch.cat([merged, cur[:, :, 2 * half:]], dim=2) if k % 2 else merged
    return cur[:, :, 0]


def aggregate_buckets(bucket_sums_soa: torch.Tensor, c: int, padd=padd_soa) -> torch.Tensor:
    """sum_b b * B_b per window: [nwin, 48, nb] (column j = bucket j + 1)
    -> [48, nwin]. Bit decomposition as in the reference: for every digit
    bit j at once, a pairwise tree over the buckets whose weight has bit j
    set (one K2 call per level for all bits and windows), then a
    high-to-low double-and-add over the c bit sums."""
    nwin, _, nb = bucket_sums_soa.shape
    dev = bucket_sums_soa.device
    b = bucket_sums_soa.permute(1, 0, 2)                       # [48, nwin, nb]
    weights = torch.arange(1, nb + 1, device=dev)
    bits = torch.arange(c, device=dev)
    mask = ((weights[None, :] >> bits[:, None]) & 1).bool()    # [c, nb]
    inf1 = inf_soa(1, dev)[:, :, None, None]                   # [48, 1, 1, 1]
    sel = torch.where(mask[None, None], b[:, :, None, :], inf1)  # [48, nwin, c, nb]
    bit_sums = _tree_sum(sel.reshape(ROWS, nwin * c, nb), padd).reshape(ROWS, nwin, c)
    acc = inf_soa(nwin, dev)
    for j in range(c - 1, -1, -1):
        acc = padd(acc, acc)
        acc = padd(acc, bit_sums[:, :, j].contiguous())
    return acc


def combine_windows(window_sums: torch.Tensor, c: int):
    """sum_w 2^(c w) W_w -> affine (Fq, Fq) | None. [48, nwin] window sums
    cross to the host once and the c doublings and one add per window run
    there in exact affine arithmetic: 24 points, a few milliseconds, where
    the reference's device loop is a serial chain of 264 one-point adds."""
    pts = ec.decode_points(ec.soa16_to_aos32(window_sums))
    g1 = bn254.g1_curve
    acc = None
    for w in reversed(pts):
        for _ in range(c):
            acc = g1.double(acc)
        acc = g1.add(acc, w)
    return acc
