"""Radix-2 NTTs over Fr on Montgomery tensors, and the coset LDE / iLDE of
the prover's extended domain.

The port of `spectre_tpu/ops/ntt.py`'s radix-2 path (`_ntt_stages` :460,
XLA code in the JAX package): a bit-reversal gather, then log2(n)
decimation-in-time stages. Each stage is kernel K4 on a CUDA tensor
(csrc/field_kernels.cu `ntt_stage_kernel`: one thread per butterfly, in
place, the twiddle and the Montgomery product in registers) and its plain
version on a CPU tensor. A stage reads and writes every element once and
does one Montgomery product per pair, 257 32-bit multiply-adds per 128
bytes: bound by memory on the H100. The four-step and int8-matmul NTTs of
the reference, which cut the passes over memory, are later work.

The coset/Montgomery folds of the reference's fused stage-0 tables
(`_fused_in_table` :239, `_fused_out_table` :265, `_vinv_in_table` :295)
become one table product each: the LDE multiplies the n input rows by
g^i before the transform, the iLDE multiplies by n^-1 g^-i after it, and
the quotient folds the vanishing inverse into one product before it.

Every tensor here is [..., n, 4] int64 Montgomery (field_ops); a batch of
polynomials is [B, n, 4] and transforms in one launch per stage.
"""

from __future__ import annotations

import torch

from . import field_ops as F
from . import kernel_lib as KL


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
            logn = n.bit_length() - 1
            idx = torch.arange(n, device=self.device)
            rev = torch.zeros_like(idx)
            for b in range(logn):
                rev |= ((idx >> b) & 1) << (logn - 1 - b)
            self._rev[n] = rev
        return self._rev[n]

    def powers(self, x: int, n: int) -> torch.Tensor:
        key = (x, n)
        if key not in self._pow:
            self._pow[key] = F.powers(_fr(), x, n, self.device)
        return self._pow[key]


def ntt_stage(a: torch.Tensor, tw: torch.Tensor, half: int, tw_stride: int) -> None:
    """K4, in place: one DIT stage over a contiguous [B, n, 4] batch: rows
    j and j + half of each block of 2*half rows become u + w v and u - w v,
    w = tw[j * tw_stride]. The plain version for a CPU tensor."""
    if not a.is_cuda:
        ntt_stage_plain(a, tw, half, tw_stride)
        return
    KL.require(a, "ntt a", torch.int64, ndim=3, last=4)
    KL.require(tw, "ntt twiddles", torch.int64, ndim=2, last=4)
    if tw.device != a.device:
        raise ValueError("ntt_stage: twiddles on another device")
    n = a.shape[1]
    if n & (n - 1) or half < 1 or n % (2 * half) or (half - 1) * tw_stride >= tw.shape[0]:
        raise ValueError("ntt_stage: bad stage geometry or twiddle table too short")
    lib = KL.library("field_kernels")
    KL.KERNELS["K4_ntt_stage"].launches += 1
    rc = lib.spt_ntt_stage(a.data_ptr(), tw.data_ptr(), a.shape[0], a.shape[1],
                           half, tw_stride, KL.stream_of(a))
    KL.check_launch(rc, "K4_ntt_stage")


def ntt_stage_plain(a: torch.Tensor, tw: torch.Tensor, half: int, tw_stride: int) -> None:
    """Plain version of K4 (in place, any device)."""
    ctx = _fr()
    b, n, _ = a.shape
    v = a.view(b, n // (2 * half), 2, half, 4)
    w = tw[::tw_stride][:half].contiguous()
    t = F.mont_mul_plain(ctx, v[:, :, 1].contiguous(), w)
    u = v[:, :, 0].clone()
    v[:, :, 0] = F.add(ctx, u, t)
    v[:, :, 1] = F.sub(ctx, u, t)


def ntt(a: torch.Tensor, omega: int, tables: Twiddles) -> torch.Tensor:
    """Forward NTT along axis -2 of [..., n, 4]: out[i] = sum_j a[j] omega^(ij)
    (natural order in and out). Returns a new tensor."""
    shape = a.shape
    n = shape[-2]
    if n & (n - 1):
        raise ValueError(f"ntt: size {n} is not a power of two")
    x = a.reshape(-1, n, 4).index_select(1, tables.bitrev(n)).contiguous()
    tw = tables.twiddles(omega, n)
    half = 1
    while half < n:
        ntt_stage(x, tw, half, n // (2 * half))
        half *= 2
    return x.reshape(shape)


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
