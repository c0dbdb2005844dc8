"""NTT sharded over a ShardingPlan's devices: the Bailey (four-step) split
with one all-to-all (the port of `spectre_tpu/parallel/sharded_ntt.py`).

    view x as A[jr, jc] = x[jc Rr + jr]              (Rr x Cc, Rr Cc = n)
    1. per-row NTT of length Cc, root omega^Rr        (rows sharded)
    2. A[jr, kc] *= omega^(jr kc)                     (K3, the four-step's
                                                       `ntt._twiddle_matrix`)
    3. transpose                                      (all-to-all of blocks)
    4. per-row NTT of length Rr, root omega^Cc        (local)

and X[kr Cc + kc] lands at out[kc, kr]. The short transforms are the
single-device ones (`ntt._ntt_nd`: K4's passes; K8 under SPECTRE_NTT_MODE=
fourstep with SPECTRE_NTT_KERNEL=matmul), their mode and kernel resolved
for their own length as the reference resolves them. An optional `post`
table ([n, 4] natural order, or one [1, 4] value) multiplies the result on
the shards before the gather: the 1/n and coset unscale of an inverse.
"""

from __future__ import annotations

import torch

from ..fields import bn254
from ..ops import field_ops as F, ntt as NTT
from .plan import ShardingPlan

R = bn254.R


def _local(x: torch.Tensor, logl: int, root: int, dev) -> torch.Tensor:
    """Length-2^logl NTTs of the rows of a contiguous [b, 2^logl, 4] batch on
    its device, as the single-device transform runs them."""
    mode = NTT._resolve_mode(None, logl)
    return NTT._ntt_nd(x, logl, root, mode, NTT._resolve_kernel(None, mode),
                       NTT.Twiddles(dev))


def bailey(a: torch.Tensor, omega: int, plan: ShardingPlan, devices: list,
           post: torch.Tensor | None = None) -> torch.Tensor:
    """The natural-order NTT of a [n, 4] Montgomery tensor (root omega)
    over `devices`, one shard each; the result on a's device, times `post`
    when given. The shard count must divide both Bailey dims
    (`plan.ntt_split`)."""
    n = a.shape[0]
    logn = n.bit_length() - 1
    if 1 << logn != n:
        raise ValueError(f"sharded ntt: size {n} is not a power of two")
    s = len(devices)
    logr, logc = plan.ntt_split(logn, s)
    rr, cc = 1 << logr, 1 << logc
    rl, cl = rr // s, cc // s
    ctx = F.fr_ctx()
    A = a.view(cc, rr, 4).transpose(0, 1)              # A[jr, jc]
    ys = []
    for i, dev in enumerate(devices):
        blk = plan.move(A[i * rl:(i + 1) * rl], -1, i, dev).contiguous()
        tw = NTT._twiddle_matrix(logr, logc, omega, dev)[i * rl * cc:(i + 1) * rl * cc]
        ys.append(F.mont_mul(ctx, _local(blk, logc, pow(omega, rr, R), dev), tw))
    if post is not None and post.shape[0] != 1:
        post = post.view(rr, cc, 4)
    outs = []
    for t, dev in enumerate(devices):
        y = torch.cat([plan.move(ys[i][:, t * cl:(t + 1) * cl], i, t, dev)
                       for i in range(s)])             # [rr, cl, 4]
        y = _local(y.transpose(0, 1).contiguous(), logr, pow(omega, cc, R), dev)
        if post is not None:
            p = post if post.shape[0] == 1 else post[:, t * cl:(t + 1) * cl].transpose(0, 1)
            y = F.mont_mul(ctx, y, plan.move(p, -1, t, dev).contiguous().view(-1, 4))
        outs.append(plan.move(y, t, -1, a.device))
    return torch.cat(outs).transpose(0, 1).reshape(n, 4).contiguous()


def sharded_ntt(a: torch.Tensor, omega: int, plan: ShardingPlan,
                post: torch.Tensor | None = None) -> torch.Tensor:
    """`ops.ntt.ntt(a, omega)` of a [n, 4] Montgomery tensor, rows over the
    plan's data axis; the same natural-order values."""
    plan.count("sharded_ntt")
    return bailey(a, omega, plan, plan.data_devices, post)
