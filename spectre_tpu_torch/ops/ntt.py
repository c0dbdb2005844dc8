"""Radix-2 NTTs over Fr on Montgomery tensors, and the coset LDE / iLDE of
the prover's extended domain.

The port of `spectre_tpu/ops/ntt.py`'s radix-2 path (`_ntt_stages` :460,
XLA code in the JAX package): decimation in time on the bit-reversed input,
log2(n) stages. On a CUDA tensor the transform is kernel K4
(csrc/field_kernels.cu `ntt_pass_kernel`, bodies in csrc/ntt.cuh): one
launch per pass of up to TMAX stages, each pass a block per tile of
C x 2^t rows held in shared memory, the first pass reading the input in
natural order straight into bit-reversed tile rows. A 2^21 or 2^23
transform is three passes over memory; ceil(log2(n) / TMAX) in general.
Tiles of 2^10 elements (32 KB: six blocks an SM) ran faster on the H100
than 2^11 or 2^12 (scripts/torch_kernel_variants.py, PERF.md).

Bound on the H100: integer multiply throughput. A butterfly after stage 0
is one Montgomery product (257 32-bit multiply-adds; stage 0 twists by one
and skips it) against, per pass, 2 x 32 bytes per element; with three
passes and 23 stages the products outweigh the bytes about three to one. The four-step and int8-matmul NTTs of the reference are
later work.

Plain versions, for CPU tensors and the tests: `ntt_passes_plain` repeats
the kernel's passes in torch ops (the same tiles, rows, strides and twiddle
indices), and `ntt_stages_plain` is the stage loop (a bit-reversal gather,
then one vectorized stage at a time), the plain NTT the kernel is held
against on the card.

The coset/Montgomery folds of the reference's fused stage-0 tables
(`_fused_in_table` :239, `_fused_out_table` :265, `_vinv_in_table` :295)
become one table product each: the LDE multiplies the n input rows by
g^i before the transform, the iLDE multiplies by n^-1 g^-i after it, and
the quotient folds the vanishing inverse into one product before it.

Every tensor here is [..., n, 4] int64 Montgomery (field_ops); a batch of
polynomials is [B, n, 4] and transforms in one launch per pass.
"""

from __future__ import annotations

import torch

from . import field_ops as F
from . import kernel_lib as KL

TMAX = 10        # most stages one pass holds
TILE_LOG = 10    # log2 of the elements a block holds: 32 KB and a pad row
MAX_BATCH = 65535   # the kernel's grid y


def _fr():
    return F.fr_ctx()


class Twiddles:
    """Per-device cache of the transform tables (twiddles, bit-reversal
    permutations, coset powers), owned by the backend that uses it."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._tw: dict = {}
        self._rev: dict = {}
        self._pow: dict = {}

    def twiddles(self, omega: int, n: int) -> torch.Tensor:
        """[omega^0 .. omega^(n/2 - 1)] Montgomery."""
        key = (omega, n)
        if key not in self._tw:
            self._tw[key] = F.powers(_fr(), omega, max(n // 2, 1), self.device)
        return self._tw[key]

    def bitrev(self, n: int) -> torch.Tensor:
        if n not in self._rev:
            self._rev[n] = _bitrev(torch.arange(n, device=self.device),
                                   n.bit_length() - 1)
        return self._rev[n]

    def powers(self, x: int, n: int) -> torch.Tensor:
        key = (x, n)
        if key not in self._pow:
            self._pow[key] = F.powers(_fr(), x, n, self.device)
        return self._pow[key]


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
    per pass of ntt_plan(log2 n), into a new tensor. The pass-structured
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
    if x.shape[0] > MAX_BATCH:
        raise ValueError(f"ntt: batch {x.shape[0]} above {MAX_BATCH}")
    out = torch.empty_like(x)
    plan = ntt_plan(n.bit_length() - 1)
    if not plan:
        out.copy_(x)
        return out
    lib = KL.library("field_kernels")
    for i, (s0, t, logc) in enumerate(plan):
        src = x if i == 0 else out
        KL.KERNELS["K4_ntt"].launches += 1
        rc = lib.spt_ntt_pass(src.data_ptr(), out.data_ptr(), tw.data_ptr(),
                              x.shape[0], n.bit_length() - 1, s0, t, logc,
                              KL.stream_of(x))
        KL.check_launch(rc, "K4_ntt")
    return out


def ntt(a: torch.Tensor, omega: int, tables: Twiddles) -> torch.Tensor:
    """Forward NTT along axis -2 of [..., n, 4]: out[i] = sum_j a[j] omega^(ij)
    (natural order in and out). Returns a new tensor."""
    shape = a.shape
    n = shape[-2]
    if n & (n - 1):
        raise ValueError(f"ntt: size {n} is not a power of two")
    x = a.reshape(-1, n, 4).contiguous()
    return ntt_passes(x, tables.twiddles(omega, n)).reshape(shape)


def intt(a: torch.Tensor, omega: int, tables: Twiddles, post=None) -> torch.Tensor:
    """Inverse NTT; the 1/n scale is one product, by `post` ([n, 4] or
    [1, 4] Montgomery) when given — the caller folds its own factor (the
    coset unscale of the iLDE) into that table."""
    n = a.shape[-2]
    ctx = _fr()
    out = ntt(a, pow(omega, -1, ctx.p), tables)
    if post is None:
        post = F.const(ctx, pow(n, -1, ctx.p), a.device)
    return F.mont_mul(ctx, out, post)


def coset_lde(coeffs: torch.Tensor, omega_ext: int, g: int, n_ext: int,
              tables: Twiddles) -> torch.Tensor:
    """Evaluate degree < m polynomials [..., m, 4] on the coset g<omega_ext>
    of size n_ext: scale coefficient i by g^i (one product over the m
    nonzero rows), zero-pad, NTT."""
    m = coeffs.shape[-2]
    ctx = _fr()
    scaled = F.mont_mul(ctx, coeffs.contiguous(), tables.powers(g, m))
    padded = torch.zeros(coeffs.shape[:-2] + (n_ext, 4), dtype=torch.int64,
                         device=coeffs.device)
    padded[..., :m, :] = scaled
    return ntt(padded, omega_ext, tables)


def coset_ilde(evals: torch.Tensor, omega_ext: int, g: int, tables: Twiddles) -> torch.Tensor:
    """Inverse of coset_lde at full length: iNTT, then one product by the
    table n^-1 g^-i (the 1/n scale and the coset unscale folded)."""
    n = evals.shape[-2]
    ctx = _fr()
    key = ("ilde", g, n)
    post = tables._pow.get(key)
    if post is None:
        post = F.mont_mul(ctx, tables.powers(pow(g, -1, ctx.p), n),
                          F.const(ctx, pow(n, -1, ctx.p), evals.device))
        tables._pow[key] = post
    return intt(evals, omega_ext, tables, post=post)
