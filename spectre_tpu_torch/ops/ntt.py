"""NTTs over Fr on Montgomery tensors in three work shapes, and the coset
LDE / iLDE of the prover's extended domain (the port of
`spectre_tpu/ops/ntt.py`).

**Radix-2** (`_ntt_stages` :460 of the reference, XLA code there):
decimation in time on the bit-reversed input, log2(n) stages. On a CUDA
tensor the transform is kernel K4 (csrc/field_kernels.cu
`ntt_pass_kernel`, bodies in csrc/ntt.cuh): one launch per pass of up to
TMAX stages, each pass a block per tile of C x 2^t rows held in shared
memory, the first pass reading the input in natural order straight into
bit-reversed tile rows. A 2^21 or 2^23 transform is three passes over
memory; ceil(log2(n) / TMAX) in general. Tiles of 2^10 elements (32 KB:
six blocks an SM) ran faster on the H100 than 2^11 or 2^12
(scripts/torch_kernel_variants.py, PERF.md). Bound on the H100: integer
multiply throughput. A butterfly after stage 0 is one Montgomery product
(257 32-bit multiply-adds; stage 0 twists by one and skips it) against,
per pass, 2 x 32 bytes per element; with three passes and 23 stages the
products outweigh the bytes about three to one.

**Four-step** (SPECTRE_NTT_MODE=fourstep, the reference's Bailey split
`_ntt_fourstep` :491): x viewed as an Rr x Cc matrix (A[jr, jc] =
x[jc Rr + jr]), length-Cc row transforms, the omega^(jr kc) twiddle
product (`field_ops.mont_mul`: K3, or K7 under SPECTRE_FIELD_IMPL=mxu),
a transpose (a torch copy), length-Rr row transforms, a transpose back to
natural order. The row transforms' body is SPECTRE_NTT_KERNEL: `stages`
runs them on K4 as a batch of short transforms (split into launches of
at most MAX_BATCH rows, K4's grid), `matmul` as DFT matrix products in
the 8-bit-limb domain (the reference's `_ntt_dft_matmul` :366): kernel K8
(csrc/ntt_matmul_kernels.cu) for a CUDA tensor, `dft_matmul_plain` for a
CPU tensor. Lengths above 2^_MATMUL_MAX_LOGN take `stages`.

**DFT matmul** (K8): out[k] = REDC_272(sum_j W[j, k] x_j) with W[j, k] =
omega^(jk) 2^272 mod p (`_dft_matrix8`, [n, 32 n] bytes, the reference's
layout and bytes): the 32 x 32 byte products of each (point, limb pair)
are one u8 GEMM over the point axis, collapsed along i1 + i2 into 63
columns, carried, and reduced once at 2^272 (u < n p^2 / 2^272 + p < 2p
for n < 2^18), then one conditional subtract. That dense form is K8's
plain version (`dft_matmul_plain`). On the card K8 factors the leg
(`dft_plan`): n = n1 n2 with n1, n2 <= 64, n2-point DFTs over the stride-n1
columns times the twiddles omega^(j1 k2), then n1-point DFTs of the
contiguous results, each short DFT the same byte-column sum and one REDC
at 2^272, from the matrices of `dft_fragments` (the tensor cores'
fragment order) and the four-step's `_twiddle_matrix`; O(n (n1 + n2))
products where the dense form does O(n^2). `dft_factored_plain` repeats
its steps from the same tables. Every mode and form gives the same
canonical bytes.

The knobs are read per call (`ntt_mode`, `ntt_kernel`; an explicit
`mode=` / `kernel=` wins), with the reference's messages and resolution
rules (`_resolve_mode`, `_resolve_kernel`). The tables (stage twiddles,
bit-reversal indices, coset powers, the iLDE's folded table, the
four-step matrix and the DFT matrices) live in one byte-budgeted LRU on
the device (SPECTRE_NTT_TABLE_MB, else min(1 GiB, 10% of host RAM), the
reference's rule, over the port's own tensor bytes), the MSM's TableLRU;
`Twiddles` is a per-device view of it. Eviction costs a rebuild, never a
wrong value.

Plain versions, for CPU tensors and the tests: `ntt_passes_plain`
repeats K4's passes in torch ops (the same tiles, rows, strides and
twiddle indices), `ntt_stages_plain` is the stage loop (the plain NTT K4
is held against on the card), `dft_matmul_plain` is K8's (the GEMM in
float64, exact: every sum stays below n 255^2 < 2^53; the collapse, the
carries and the reduction in int64), `dft_factored_plain` K8's steps.

The coset/Montgomery folds of the reference's fused stage-0 tables
(`_fused_in_table` :239, `_fused_out_table` :265, `_vinv_in_table` :295)
become one table product each: the LDE multiplies the n input rows by
g^i before the transform, the iLDE multiplies by n^-1 g^-i after it, and
the quotient folds the vanishing inverse into one product before it.

Every tensor here is [..., n, 4] int64 Montgomery (field_ops); a batch of
polynomials is [B, n, 4] and transforms in one launch per pass.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from ..fields import bn254
from . import field_mxu as MX
from . import field_ops as F
from . import kernel_lib as KL
from .msm import TableLRU

R = bn254.R
TMAX = 10        # most stages one pass holds
TILE_LOG = 10    # log2 of the elements a block holds: 32 KB and a pad row
MAX_BATCH = 65535   # the kernel's grid y

NTT_MODES = ("radix2", "fourstep")
NTT_KERNELS = ("stages", "matmul")

# fourstep needs at least one row stage and one column stage
_FOURSTEP_MIN_LOGN = 2
# the longest short transform the matmul body takes (the reference's cap:
# one REDC at 2^272 reduces fully while n p < 2^272, and the reference's
# int32 columns stay exact through the group split up to n = 4096); fourstep
# legs are ~sqrt(n), so every extended domain up to 2^24 stays on it
_MATMUL_MAX_LOGN = 12
# the reduction radix of the matmul body: two bytes over 2^256, which the
# DFT matrix's entries carry, so the result is back in Montgomery form
_REDC_SHIFT = 272
_REDC_LIMBS = _REDC_SHIFT // 8               # 34
# t = sum_j W x_j < n p^2 < 2^520 at the cap: 66 limbs hold t and m p
_T_LIMBS = _REDC_LIMBS + 32                  # 66
# K8's short DFTs: at most 2^_DFT_MAX_LOGL points a pass (the matrix of 64
# points is 128 KiB of a block's shared memory), so a leg up to the cap is
# one pass or two
_DFT_MAX_LOGL = 6


def _conv_group_width(logn: int) -> int:
    """The reference's i1-axis group width of the two-level carry split
    (its int32 column budget): the largest W with W n <= 2^15, at most the
    whole 32-limb axis. The port's plain version sums columns in int64 and
    needs no split; it takes a `group_width` to run the reference's
    grouped form, value for value the same."""
    return 1 << min(5, max(0, 15 - logn))


def ntt_mode() -> str:
    """Active NTT mode from SPECTRE_NTT_MODE (default: radix2), read per
    call."""
    mode = os.environ.get("SPECTRE_NTT_MODE", "radix2")
    if mode not in NTT_MODES:
        raise ValueError(
            f"SPECTRE_NTT_MODE={mode!r}: expected one of {NTT_MODES}")
    return mode


def ntt_kernel() -> str:
    """Active short-transform body from SPECTRE_NTT_KERNEL (default:
    stages), read per call."""
    kern = os.environ.get("SPECTRE_NTT_KERNEL", "stages")
    if kern not in NTT_KERNELS:
        raise ValueError(
            f"SPECTRE_NTT_KERNEL={kern!r}: expected one of {NTT_KERNELS}")
    return kern


def _resolve_mode(mode: str | None, logn: int) -> str:
    m = mode if mode is not None else ntt_mode()
    if m not in NTT_MODES:
        raise ValueError(f"unknown NTT mode {m!r}")
    if m == "fourstep" and logn < _FOURSTEP_MIN_LOGN:
        return "radix2"              # nothing to split
    return m


def _resolve_kernel(kernel: str | None, mode: str) -> str:
    """The kernel knob selects the body of the four-step short transforms;
    radix2 has none, so it resolves to "stages" there."""
    k = kernel if kernel is not None else ntt_kernel()
    if k not in NTT_KERNELS:
        raise ValueError(f"unknown NTT kernel {k!r}")
    if mode != "fourstep":
        return "stages"
    return k


# ---------------------------------------------------------------------------
# budgeted tables (one LRU on the device, every entry rebuilt on a miss)
# ---------------------------------------------------------------------------

def _table_budget_bytes() -> int:
    """SPECTRE_NTT_TABLE_MB if set, else min(1 GiB, 10% of host RAM)."""
    mb = os.environ.get("SPECTRE_NTT_TABLE_MB")
    if mb is not None:
        return int(mb) << 20
    try:
        with open("/proc/meminfo") as f:
            total = int(f.readline().split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        return 1 << 30
    return min(1 << 30, int(total * 0.10))


_TABLES = TableLRU(_table_budget_bytes(), label="ntt twiddle/coset table",
                   budget_var="SPECTRE_NTT_TABLE_MB")


def lru_stats() -> dict:
    """The table cache's stats, for GET /metrics and the job manifests."""
    return _TABLES.stats()


def clear_tables() -> None:
    """Drop every cached table (their device memory)."""
    _TABLES.clear()


def _cached(key, build):
    hit = _TABLES.get(key)
    if hit is not None:
        return hit
    table = build()
    return _TABLES.put(key, None, table, table.numel() * table.element_size())


def _twiddle_matrix(logr: int, logc: int, omega: int, device) -> torch.Tensor:
    """[Rr Cc, 4] Montgomery table of omega^(jr kc), row jr of Cc entries:
    the four-step's inter-pass twiddles (the reference's `_twiddle_matrix`
    :204), built on the device by doubling the rows (rows [d, 2d) are rows
    [0, d) times omega^(d kc))."""
    device = torch.device(device)

    def build():
        ctx = F.fr_ctx()
        step = F.powers(ctx, omega, 1 << logc, device)        # omega^kc
        out = F.const(ctx, 1, device).repeat(1 << logc, 1)
        while out.shape[0] < 1 << (logr + logc):
            out = torch.cat([out, F.mont_mul(ctx, out, step)])
            step = F.mont_mul(ctx, step, step)
        return out

    return _cached(("mat", str(device), logr, logc, omega), build)


def _dft_fragments(logl: int, omega: int, device="cpu") -> torch.Tensor:
    """K8's matrix of the 2^logl-point DFT of root omega in the tensor
    cores' fragment order, uint8 [L, MT, 32, 16] (L = 2^logl, MT = ceil(L /
    16) m-tiles of output points): the 16 bytes lane 4 g + tq loads for
    k-step j (input point j) of m-tile mt are its A registers a_(hh + 2 h),
    each the byte-reversed word tq + 4 h of W[j, 16 mt + g + 8 hh] =
    omega^(jk) 2^272 mod p (zero past L), so that K index 4 tq + q + 16 h
    is byte 4 (tq + 4 h) + 3 - q of W (csrc/ntt_matmul_kernels.cu)."""
    device = torch.device(device)

    def build():
        ll = 1 << logl
        mt_all = -(-ll // 16)
        ctx = F.fr_ctx()
        w = F.mont_mul(ctx, _twiddle_matrix(logl, logl, omega, device),
                       F.const(ctx, 1 << 16, device))
        wb = torch.zeros((ll, 16 * mt_all, 32), dtype=torch.uint8, device=device)
        wb[:, :ll] = w.contiguous().view(torch.uint8).reshape(ll, ll, 32)
        row, byte = _fragment_index(mt_all, device)
        return wb.reshape(ll, -1)[:, row * 32 + byte].reshape(ll, mt_all, 32, 16).contiguous()

    return _cached(("dftf", str(device), logl, omega), build)


def _fragment_index(mt_all: int, device):
    """(row, byte), each [MT, 32, 4, 4] over (m-tile, lane, register,
    byte of it): the DFT matrix's output point and the byte of its entry
    that the fragment holds; K index kappa = 4 tq + q + 16 h reads byte
    4 (tq + 4 h) + 3 - q."""
    mt = torch.arange(mt_all, device=device)[:, None, None, None]
    lane = torch.arange(32, device=device)[None, :, None, None]
    reg = torch.arange(4, device=device)[None, None, :, None]
    q = torch.arange(4, device=device)[None, None, None, :]
    return torch.broadcast_tensors(16 * mt + (lane >> 2) + 8 * (reg & 1),
                                   4 * ((lane & 3) + 4 * (reg >> 1)) + 3 - q)


def _dft_matrix8(logn: int, omega: int, device="cpu") -> torch.Tensor:
    """The matmul body's DFT matrix, contraction-ready: W8[j, k 32 + i1] =
    byte i1 of (omega^(jk) 2^272 mod p), uint8 [n, 32 n] (the reference's
    `_dft_matrix8` :342, byte for byte): the Montgomery matrix of
    omega^(jk) times the Montgomery constant 2^16."""
    device = torch.device(device)

    def build():
        n = 1 << logn
        ctx = F.fr_ctx()
        w = F.mont_mul(ctx, _twiddle_matrix(logn, logn, omega, device),
                       F.const(ctx, 1 << 16, device))
        return w.contiguous().view(torch.uint8).reshape(n, n * 32)

    return _cached(("dft8", str(device), logn, omega), build)


class Twiddles:
    """The transform tables of one device (twiddles, bit-reversal
    indices, coset powers, the four-step and DFT matrices), held in the
    module's budgeted LRU; a backend owns one."""

    def __init__(self, device):
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:   # one key per card
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self._dev = str(device)

    def twiddles(self, omega: int, n: int) -> torch.Tensor:
        """[omega^0 .. omega^(n/2 - 1)] Montgomery."""
        return _cached(("tw", self._dev, omega, n),
                       lambda: F.powers(_fr(), omega, max(n // 2, 1), self.device))

    def bitrev(self, n: int) -> torch.Tensor:
        return _cached(("rev", self._dev, n),
                       lambda: _bitrev(torch.arange(n, device=self.device),
                                       n.bit_length() - 1))

    def powers(self, x: int, n: int) -> torch.Tensor:
        return _cached(("pow", self._dev, x, n),
                       lambda: F.powers(_fr(), x, n, self.device))

    def ilde_post(self, g: int, n: int) -> torch.Tensor:
        """[n, 4] Montgomery n^-1 g^-i: the iLDE's 1/n scale and coset
        unscale folded into one table."""
        ctx = _fr()
        return _cached(("ilde", self._dev, g, n), lambda: F.mont_mul(
            ctx, F.powers(ctx, pow(g, -1, ctx.p), n, self.device),
            F.const(ctx, pow(n, -1, ctx.p), self.device)))

    def twiddle_matrix(self, logr: int, logc: int, omega: int) -> torch.Tensor:
        return _twiddle_matrix(logr, logc, omega, self.device)

    def dft_matrix8(self, logn: int, omega: int) -> torch.Tensor:
        return _dft_matrix8(logn, omega, self.device)

    def dft_fragments(self, logl: int, omega: int) -> torch.Tensor:
        return _dft_fragments(logl, omega, self.device)


def _fr():
    return F.fr_ctx()


def _bitrev(idx: torch.Tensor, bits: int) -> torch.Tensor:
    rev = torch.zeros_like(idx)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


# ---------------------------------------------------------------------------
# the pass plan (shared by K4 and its pass-structured plain version)
# ---------------------------------------------------------------------------

def ntt_plan(logn: int, tmax: int = TMAX, tile_log: int = TILE_LOG) -> list:
    """The passes of a 2^logn transform as (s0, t, logc): stages s0 ..
    s0+t-1, tiles of 2^t rows, 2^logc columns per block. The stages are
    split as evenly as ceil(logn / tmax) passes allow; a block holds up to
    2^tile_log elements, and its columns are adjacent input columns (first
    pass) or adjacent low row bits (later passes, at most 2^s0 of them)."""
    if logn == 0:
        return []
    npass = -(-logn // tmax)
    base, extra = divmod(logn, npass)
    plan, s0 = [], 0
    for i in range(npass):
        t = base + (i < extra)
        room = logn - t if s0 == 0 else s0
        plan.append((s0, t, max(0, min(tile_log - t, room))))
        s0 += t
    return plan


def _pass_rows(logn: int, s0: int, t: int, logc: int, device):
    """(load, store, lo): the transform rows a pass's tiles read and write,
    each [nblk, C, T] in tile-row order after the load, and the low row bits
    lo [nblk, C] of each column (csrc/ntt.cuh `ntt_pass_load`/`_store`)."""
    n, T, C = 1 << logn, 1 << t, 1 << logc
    nblk = n // (T * C)
    blk = torch.arange(nblk, device=device)[:, None, None]
    c = torch.arange(C, device=device)[None, :, None]
    m = torch.arange(T, device=device)[None, None, :]
    if s0 == 0:
        o = (blk << logc) + c
        load = o + (_bitrev(m, t) << (logn - t))
        store = (_bitrev(o, logn - t) << t) + m
        lo = torch.zeros((nblk, C), dtype=torch.int64, device=device)
        return load, store, lo
    lgbits = s0 - logc
    hi, lg = blk >> lgbits, blk & ((1 << lgbits) - 1)
    rows = (hi << (s0 + t)) + (m << s0) + (lg << logc) + c
    return rows, rows, ((lg << logc) + c)[:, :, 0]


def _pass_plain(src: torch.Tensor, dst: torch.Tensor, tw: torch.Tensor,
                logn: int, s0: int, t: int, logc: int) -> None:
    """One pass in torch ops: gather the tiles, run stages s0 .. s0+t-1 on
    them (pairs (m0, m0 + 2^ls) of each column, twiddle index
    ((jl << s0) + lo) * n / 2^(s0+ls+1)), scatter them to dst."""
    ctx = _fr()
    b, n = src.shape[0], 1 << logn
    load, store, lo = _pass_rows(logn, s0, t, logc, src.device)
    nblk, C, T = load.shape
    tile = src.index_select(1, load.reshape(-1)).reshape(b, nblk, C, T, 4)
    for ls in range(t):
        h = 1 << ls
        v = tile.view(b, nblk, C, T // (2 * h), 2, h, 4)
        jl = torch.arange(h, device=src.device)
        j = (jl[None, None, :] << s0) + lo[:, :, None]               # [nblk, C, h]
        w = tw.index_select(0, (j * (n >> (s0 + ls + 1))).reshape(-1))
        w = w.reshape(1, nblk, C, 1, h, 4).expand(b, nblk, C, T // (2 * h), h, 4)
        x = F.mont_mul_plain(ctx, v[:, :, :, :, 1].contiguous(),
                             w.contiguous().reshape(-1, 4))
        u = v[:, :, :, :, 0].clone()
        v[:, :, :, :, 0] = F.add(ctx, u, x)
        v[:, :, :, :, 1] = F.sub(ctx, u, x)
    dst.index_copy_(1, store.reshape(-1), tile.reshape(b, -1, 4))


def ntt_passes_plain(x: torch.Tensor, tw: torch.Tensor, plan=None) -> torch.Tensor:
    """Plain version of K4 with the kernel's pass structure: [B, n, 4] ->
    new [B, n, 4]. `plan` defaults to ntt_plan(log2 n)."""
    n = x.shape[1]
    logn = n.bit_length() - 1
    out = x.clone()
    for i, (s0, t, logc) in enumerate(ntt_plan(logn) if plan is None else plan):
        _pass_plain(x if i == 0 else out, out, tw, logn, s0, t, logc)
    return out


def ntt_stages_plain(x: torch.Tensor, tw: torch.Tensor, tables: Twiddles) -> torch.Tensor:
    """Plain NTT as a stage loop: [B, n, 4] -> new [B, n, 4] (a
    bit-reversal gather, then each stage over the whole batch at once)."""
    ctx = _fr()
    b, n, _ = x.shape
    y = x.index_select(1, tables.bitrev(n)).contiguous()
    half = 1
    while half < n:
        v = y.view(b, n // (2 * half), 2, half, 4)
        w = tw[::n // (2 * half)][:half].contiguous()
        t = F.mont_mul_plain(ctx, v[:, :, 1].contiguous(), w)
        u = v[:, :, 0].clone()
        v[:, :, 0] = F.add(ctx, u, t)
        v[:, :, 1] = F.sub(ctx, u, t)
        half *= 2
    return y


def ntt_passes(x: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """K4: the forward transform of a contiguous [B, n, 4] batch, one launch
    per pass of ntt_plan(log2 n) for each run of at most MAX_BATCH
    polynomials (the grid's y), into a new tensor. The pass-structured
    plain version for a CPU tensor."""
    n = x.shape[1]
    if not x.is_cuda:
        return ntt_passes_plain(x, tw)
    KL.require(x, "ntt x", torch.int64, ndim=3, last=4)
    KL.require(tw, "ntt twiddles", torch.int64, ndim=2, last=4)
    if tw.device != x.device:
        raise ValueError("ntt: twiddles on another device")
    if tw.shape[0] < max(n // 2, 1):
        raise ValueError("ntt: twiddle table too short")
    out = torch.empty_like(x)
    plan = ntt_plan(n.bit_length() - 1)
    if not plan:
        out.copy_(x)
        return out
    lib = KL.library("field_kernels")
    for b0 in range(0, x.shape[0], MAX_BATCH):
        src0, dst = x[b0:b0 + MAX_BATCH], out[b0:b0 + MAX_BATCH]
        for i, (s0, t, logc) in enumerate(plan):
            src = src0 if i == 0 else dst
            KL.KERNELS["K4_ntt"].launches += 1
            rc = lib.spt_ntt_pass(src.data_ptr(), dst.data_ptr(), tw.data_ptr(),
                                  dst.shape[0], n.bit_length() - 1, s0, t, logc,
                                  KL.stream_of(x))
            KL.check_launch(rc, "K4_ntt")
    return out


# ---------------------------------------------------------------------------
# the DFT-matmul short transform: K8 and its plain version
# ---------------------------------------------------------------------------

def _matmul_consts():
    """(p' = -p^-1 mod 2^272 as 34 bytes, p as 32 bytes), int32."""
    p = F.fr_ctx().p
    pinv = (-pow(p, -1, 1 << _REDC_SHIFT)) % (1 << _REDC_SHIFT)
    return MX._bytes_of(pinv, _REDC_LIMBS), MX._bytes_of(p, MX.L8)


def dft_matmul_plain(x: torch.Tensor, w8: torch.Tensor,
                     group_width: int | None = None) -> torch.Tensor:
    """Plain version of K8: the DFT of each row of x [R, n, 4] against the
    byte matrix w8 [n, 32 n] (`_dft_matrix8`), natural order in and out.
    G[r, i2, (k, i1)] = sum_j x8[r, j, i2] w8[j, (k, i1)] contracts in
    float64 (exact: sums below n 255^2 < 2^53), in blocks of rows and
    points; the 32 x 32 products of each point collapse along i1 + i2 into
    63 int64 columns, carried into 66 bytes and reduced once at 2^272.
    `group_width` runs the reference's two-level split of the i1 axis
    (each group carried apart, then summed and carried again): the same
    values."""
    rows, n, _ = x.shape
    width = MX.L8 if group_width is None else group_width
    if width < 1 or MX.L8 % width:
        raise ValueError(f"group_width {width} does not divide {MX.L8}")
    ctx = F.fr_ctx()
    pinv8, p8 = _matmul_consts()
    x8 = MX._to8(x).transpose(1, 2).to(torch.float64)           # [R, i2, j]
    out = torch.empty_like(x)
    kb = min(n, (1 << 20) // n)      # points a block: a float64 slice of w8 <= 256 MiB
    rb = max(1, (1 << 14) // kb)     # rows a block: G of 2^24 entries
    for k0 in range(0, n, kb):
        wk = w8[:, k0 * MX.L8:(k0 + kb) * MX.L8].to(torch.float64)
        nk = wk.shape[1] // MX.L8
        for r0 in range(0, rows, rb):
            g = torch.matmul(x8[r0:r0 + rb], wk).to(torch.int64)   # [r, i2, (k, i1)]
            g = g.view(g.shape[0], MX.L8, nk, MX.L8).permute(0, 2, 3, 1)  # [r, k, i1, i2]
            t8 = None
            for lo in range(0, MX.L8, width):
                cols = torch.zeros(g.shape[:2] + (2 * MX.L8 - 1,), dtype=torch.int64,
                                   device=x.device)
                for i1 in range(lo, lo + width):
                    cols[..., i1:i1 + MX.L8] += g[:, :, i1]
                part = MX._carry8(cols, _T_LIMBS)
                t8 = part if t8 is None else t8 + part
            if width < MX.L8:
                t8 = MX._carry8(t8, _T_LIMBS)
            out[r0:r0 + rb, k0:k0 + nk] = MX.redc_columns(ctx, t8, pinv8, p8)
    return out


class DftPass(NamedTuple):
    """One launch of K8: the 2^logl-point DFTs of a row's 2^(logn - logl)
    vectors, point j of vector u of row r at r n + u bu_in + j s_in, output
    k at r n + u bu_out + k s_out, times omega^(u k) when twiddled."""
    logl: int
    bu_in: int
    s_in: int
    bu_out: int
    s_out: int
    twiddled: bool


def dft_plan(logn: int) -> list:
    """K8's passes for a leg of 2^logn points: one direct DFT up to
    2^_DFT_MAX_LOGL, else n = n1 n2 (n1 = 2^(logn // 2)): the n2-point DFTs
    of the stride-n1 columns times omega^(j1 k2), back into their slots,
    then the n1-point DFTs of each k2's n1 contiguous values into
    out[n2 k1 + k2]."""
    if logn <= _DFT_MAX_LOGL:
        return [DftPass(logn, 0, 1, 0, 1, False)]
    n1, n2 = 1 << (logn // 2), 1 << (logn - logn // 2)
    return [DftPass(logn - logn // 2, 1, n1, 1, n1, True),
            DftPass(logn // 2, n1, 1, 1, n2, False)]


def _pass_points(rows: int, logn: int, ps: DftPass, out: bool, device) -> torch.Tensor:
    """[rows 2^logu, L] flat point indices of a pass's vectors (inputs, or
    outputs when `out`)."""
    n, ll = 1 << logn, 1 << ps.logl
    r = torch.arange(rows, device=device)[:, None, None]
    u = torch.arange(n // ll, device=device)[None, :, None]
    j = torch.arange(ll, device=device)[None, None, :]
    idx = r * n + u * (ps.bu_out if out else ps.bu_in) + j * (ps.s_out if out else ps.s_in)
    return idx.reshape(-1, ll)


def dft_factored_plain(x: torch.Tensor, tables: Twiddles, omega: int) -> torch.Tensor:
    """K8's steps in torch ops, from the tables the kernel reads: for each
    pass of dft_plan, the DFT matrix read back out of its fragment order
    (`dft_fragments`) times the Toeplitz expansion of each vector's bytes
    (column c of point j, K index kappa: byte c - pi(kappa) of x_j), the 64
    byte columns carried and reduced once at 2^272, times the twiddle matrix
    where the pass is twiddled, scattered to the pass's outputs. The products
    run in float64 (exact: a column stays below 64 32 255^2 < 2^27)."""
    rows, n, _ = x.shape
    logn = n.bit_length() - 1
    ctx = F.fr_ctx()
    pinv8, p8 = _matmul_consts()
    kappa = torch.arange(MX.L8)
    pi = 4 * ((kappa % 16) // 4 + 4 * (kappa // 16)) + 3 - kappa % 4
    tidx = (torch.arange(2 * MX.L8)[None, :] - pi[:, None] + MX.L8).to(x.device)  # [32, 64]
    src = x
    for ps in dft_plan(logn):
        ll = 1 << ps.logl
        frag = tables.dft_fragments(ps.logl, pow(omega, n >> ps.logl, R))
        mt_all = frag.shape[1]
        row, byte = _fragment_index(mt_all, x.device)
        kap = (byte // 4 % 4) * 4 + 3 - byte % 4 + 16 * (byte // 16)   # kappa of each byte
        a = torch.zeros((16 * mt_all, MX.L8, ll), dtype=torch.float64, device=x.device)
        a[row, kap] = frag.reshape(ll, mt_all, 32, 4, 4).permute(1, 2, 3, 4, 0).double()
        a = a.permute(0, 2, 1).reshape(16 * mt_all, ll * MX.L8)[:ll]   # [k, (j, kappa)]
        xv = src.reshape(-1, 4)[_pass_points(rows, logn, ps, False, x.device)]   # [V, L, 4]
        y = torch.empty_like(xv)
        step = max(1, (1 << 22) // (ll * MX.L8 * 2 * MX.L8))
        for v0 in range(0, xv.shape[0], step):
            x8 = torch.nn.functional.pad(MX._to8(xv[v0:v0 + step]), (MX.L8, MX.L8))
            bt = x8[:, :, tidx].reshape(x8.shape[0], ll * MX.L8, 2 * MX.L8)
            cols = torch.matmul(a, bt.double()).to(torch.int64)      # [v, k, c]
            y[v0:v0 + step] = MX.redc_columns(ctx, MX._carry8(cols, _T_LIMBS), pinv8, p8)
        if ps.twiddled:
            y = F.mont_mul_plain(ctx, y, tables.twiddle_matrix(logn - ps.logl, ps.logl, omega))
        dst = torch.empty_like(x)
        dst.view(-1, 4)[_pass_points(rows, logn, ps, True, x.device).reshape(-1)] = \
            y.reshape(-1, 4)
        src = dst
    return src


def dft_matmul(x: torch.Tensor, tables: Twiddles, omega: int) -> torch.Tensor:
    """K8: the DFT of root omega (primitive n-th) of each row of a
    contiguous [R, n, 4] batch, into a new tensor: one launch a pass of
    dft_plan(log2 n), from the tables' `dft_fragments` and, for a twiddled
    pass, `twiddle_matrix`. The plain version (`dft_matmul_plain`, the dense
    byte matrix) for a CPU tensor."""
    rows, n, _ = x.shape
    logn = n.bit_length() - 1
    if not x.is_cuda:
        return dft_matmul_plain(x, tables.dft_matrix8(logn, omega))
    KL.require(x, "dft x", torch.int64, ndim=3, last=4)
    if n != 1 << logn or not 0 < logn <= _MATMUL_MAX_LOGN:
        raise ValueError(f"dft_matmul: length {n} is not 2^1 .. 2^{_MATMUL_MAX_LOGN}")
    if tables.device != x.device:
        raise ValueError(f"dft_matmul: tables on {tables.device} for rows on {x.device}")
    if x.data_ptr() % 16:
        raise ValueError("dft_matmul: rows not 16-byte aligned")
    if rows == 0:
        return torch.empty_like(x)
    lib = KL.library("ntt_matmul_kernels")
    src = x
    for ps in dft_plan(logn):
        dst = torch.empty_like(x)
        frag = tables.dft_fragments(ps.logl, pow(omega, n >> ps.logl, R))
        tw = tables.twiddle_matrix(logn - ps.logl, ps.logl, omega) if ps.twiddled else None
        KL.KERNELS["K8_ntt_dft_matmul"].launches += 1
        rc = lib.spt_ntt_dft_pass(src.data_ptr(), dst.data_ptr(), frag.data_ptr(),
                                  None if tw is None else tw.data_ptr(), rows, logn, ps.logl,
                                  ps.bu_in, ps.s_in, ps.bu_out, ps.s_out, KL.stream_of(x))
        KL.check_launch(rc, "K8_ntt_dft_matmul")
        src = dst
    return src


def _ntt_dft_matmul(a: torch.Tensor, logn: int, omega: int, tables: Twiddles,
                    group_width: int | None = None) -> torch.Tensor:
    """The DFT of each row of a [R, n, 4] batch in the 8-bit-limb domain
    (the reference's `_ntt_dft_matmul` :366, a direct DFT as one matrix
    product): K8's factored passes on the card, the plain dense product
    (optionally in the reference's groups) on the CPU."""
    if group_width is not None and not a.is_cuda:
        return dft_matmul_plain(a, tables.dft_matrix8(logn, omega), group_width)
    return dft_matmul(a, tables, omega)


def _short_transform(a: torch.Tensor, logn: int, omega: int, kernel: str,
                     tables: Twiddles) -> torch.Tensor:
    """The four-step's row transform body over a [R, n, 4] batch: K4's
    stages, or the DFT matmul; lengths past the matmul's cap take the
    stages."""
    if kernel == "matmul" and 0 < logn <= _MATMUL_MAX_LOGN:
        return _ntt_dft_matmul(a, logn, omega, tables)
    return ntt_passes(a, tables.twiddles(omega, 1 << logn))


def _ntt_fourstep(x: torch.Tensor, logn: int, omega: int, kernel: str,
                  tables: Twiddles) -> torch.Tensor:
    """The four-step (Bailey) NTT of a contiguous [B, n, 4] batch (the
    reference's `_ntt_fourstep` :491): A[jr, jc] = x[jc Rr + jr], length-Cc
    row transforms, the omega^(jr kc) product, a transpose, length-Rr row
    transforms, and the transpose to natural order."""
    ctx = _fr()
    b = x.shape[0]
    logr = logn // 2
    logc = logn - logr
    rr, cc = 1 << logr, 1 << logc
    a = x.view(b, cc, rr, 4).transpose(1, 2).contiguous().view(b * rr, cc, 4)
    y = _short_transform(a, logc, pow(omega, rr, R), kernel, tables)
    y = F.mont_mul(ctx, y, tables.twiddle_matrix(logr, logc, omega))
    y = y.view(b, rr, cc, 4).transpose(1, 2).contiguous().view(b * cc, rr, 4)
    y = _short_transform(y, logr, pow(omega, cc, R), kernel, tables)
    return y.view(b, cc, rr, 4).transpose(1, 2).contiguous().view(b, 1 << logn, 4)


def _ntt_nd(x: torch.Tensor, logn: int, omega: int, mode: str, kernel: str,
            tables: Twiddles) -> torch.Tensor:
    if mode == "fourstep":
        return _ntt_fourstep(x, logn, omega, kernel, tables)
    return ntt_passes(x, tables.twiddles(omega, 1 << logn))


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def _logn_of(a: torch.Tensor) -> int:
    n = a.shape[-2]
    if n & (n - 1):
        raise ValueError(f"ntt: size {n} is not a power of two")
    return n.bit_length() - 1


def ntt(a: torch.Tensor, omega: int, tables: Twiddles | None = None,
        mode: str | None = None, kernel: str | None = None) -> torch.Tensor:
    """Forward NTT along axis -2 of [..., n, 4]: out[i] = sum_j a[j] omega^(ij)
    (natural order in and out), every leading axis a batch. mode defaults
    to SPECTRE_NTT_MODE, kernel (the four-step's short-transform body) to
    SPECTRE_NTT_KERNEL. Returns a new tensor."""
    tables = tables or Twiddles(a.device)
    shape = a.shape
    logn = _logn_of(a)
    m = _resolve_mode(mode, logn)
    x = a.reshape(-1, 1 << logn, 4).contiguous()
    return _ntt_nd(x, logn, omega, m, _resolve_kernel(kernel, m), tables).reshape(shape)


def intt(a: torch.Tensor, omega: int, tables: Twiddles | None = None, post=None,
         mode: str | None = None, kernel: str | None = None) -> torch.Tensor:
    """Inverse NTT; the 1/n scale is one product, by `post` ([n, 4] or
    [1, 4] Montgomery) when given — the caller folds its own factor (the
    coset unscale of the iLDE) into that table."""
    n = a.shape[-2]
    ctx = _fr()
    out = ntt(a, pow(omega, -1, ctx.p), tables, mode, kernel)
    if post is None:
        post = F.const(ctx, pow(n, -1, ctx.p), a.device)
    return F.mont_mul(ctx, out, post)


# the reference's batched names: every entry point takes leading batch axes
ntt_many = ntt
intt_many = intt


def coset_scale(a: torch.Tensor, g: int, inverse: bool = False,
                tables: Twiddles | None = None) -> torch.Tensor:
    """a_i *= g^i (or g^-i) along axis -2, one product."""
    tables = tables or Twiddles(a.device)
    ctx = _fr()
    x = pow(g, -1, ctx.p) if inverse else g
    return F.mont_mul(ctx, a.contiguous(), tables.powers(x, a.shape[-2]))


def coset_lde(coeffs: torch.Tensor, omega_ext: int, g: int, n_ext: int,
              tables: Twiddles | None = None, mode: str | None = None,
              kernel: str | None = None) -> torch.Tensor:
    """Evaluate degree < m polynomials [..., m, 4] on the coset g<omega_ext>
    of size n_ext: scale coefficient i by g^i (one product over the m
    nonzero rows), zero-pad, NTT."""
    tables = tables or Twiddles(coeffs.device)
    m = coeffs.shape[-2]
    scaled = coset_scale(coeffs, g, tables=tables)
    padded = torch.zeros(coeffs.shape[:-2] + (n_ext, 4), dtype=torch.int64,
                         device=coeffs.device)
    padded[..., :m, :] = scaled
    return ntt(padded, omega_ext, tables, mode, kernel)


def coset_ilde(evals: torch.Tensor, omega_ext: int, g: int, tables: Twiddles | None = None,
               mode: str | None = None, kernel: str | None = None) -> torch.Tensor:
    """Inverse of coset_lde at full length: iNTT, then one product by the
    table n^-1 g^-i (the 1/n scale and the coset unscale folded)."""
    tables = tables or Twiddles(evals.device)
    post = tables.ilde_post(g, evals.shape[-2])
    return intt(evals, omega_ext, tables, post=post, mode=mode, kernel=kernel)
