"""One MSM sharded over a ShardingPlan's ("data", "win") mesh (the port of
`spectre_tpu/parallel/sharded_msm.py`).

Rows of the (GLV-expanded, padded) base go along "data", Pippenger windows
along "win". Shard (d, w) recodes the signed digits of its own rows, whole
scalars, so the carry never leaves the shard, and runs the single-device
kernels on its slice: K1 (`msm_kernels.bucket_sums_aos32`) on digits
[w0:w1, rows], then K2b per window. The data shards' partial window sums
fold by K2 (`padd_aos32`) onto shard (0, w), the windows gather onto the
caller's device, and the host combines them as the single-device MSM
does. Every shard's work is enqueued before the first result is read, so
shards on distinct cards overlap.

Fixed-base mode (`sharded_msm_fixed`): shard (d, w) holds the window table
T[w0:w1] of its own rows, built by K2 doublings where it is used and
normalised; K1's fixed form adds its digits over it, K2 folds its windows'
buckets, the shards' bucket sums fold by K2 and one K2b weighs them. The
table budget (SPECTRE_MSM_TABLE_MB, `ops.msm.TABLES.budget`) holds per
physical device, summed over the shards that share it: four shards of one
card need the whole table there.
"""

from __future__ import annotations

import sys

import torch

from ..ops import ec, glv, msm as MSM, msm_kernels as MK
from ..ops import field_ops as F
from .plan import ShardingPlan

# the reference's byte count of one table row (its [3, 16] uint32 point)
_REF_POINT_BYTES = 3 * 16 * 4


def _fold(parts: list, plan: ShardingPlan, srcs: list, dst: int, device) -> torch.Tensor:
    """Sum AoS32 partials [k, 24] of shards `srcs` onto shard `dst` by K2,
    a tree over the shards."""
    acc = [plan.move(p, s, dst, device) for p, s in zip(parts, srcs)]
    while len(acc) > 1:
        nxt = [MK.padd_aos32(acc[i], acc[i + 1]) for i in range(0, len(acc) - 1, 2)]
        if len(acc) % 2:
            nxt.append(acc[-1])
        acc = nxt
    return acc[0]


def _base_rows(points: torch.Tensor, m: int, expand: bool, base_key) -> torch.Tensor:
    pts = points[:m]
    return MSM.expanded_base(pts, base_key) if expand else pts


def shard_points(points: torch.Tensor, m: int, plan: ShardingPlan, expand: bool = False,
                 base_key=None) -> list:
    """The first m rows of an AoS32 base [N, 24] (with their endomorphism
    images when `expand`), padded with infinity to `plan.pad_rows` and
    placed per shard: grid[d][w] holds data shard d's rows on shard (d,
    w)'s device. Cached on the plan under base_key (the SRS digest); an
    unnamed base is named by its storage address and kept alive."""
    tag = base_key if base_key is not None else ("at", points.data_ptr(), points)
    key = (tag, str(points.device), int(m), bool(expand))

    def build():
        rows = _base_rows(points, m, expand, base_key)
        mp = plan.pad_rows(rows.shape[0])
        if mp > rows.shape[0]:
            rows = torch.cat([rows, ec.inf_aos32(mp - rows.shape[0], rows.device)])
        b = mp // plan.ndata
        return [[plan.move(rows[d * b:(d + 1) * b], -1, -1, plan.device(d, w))
                 for w in range(plan.nwin_shards)] for d in range(plan.ndata)]

    return plan.placed_base(key, build)


def _scalar_rows(scalars_std: torch.Tensor, mode: str):
    """(limbs [L, M] int64 16-bit, limb-major; signs [1, M] int32; nbits)
    of [m, 4] standard-form scalars: full scalars in vanilla mode, the GLV
    halves otherwise (split on the scalars' device before sharding)."""
    if mode == "vanilla":
        limbs = F.split16(scalars_std)
        return limbs, torch.zeros((1, limbs.shape[1]), dtype=torch.int32,
                                  device=limbs.device), MSM.SCALAR_BITS
    mags, negs = MSM.glv_scalars(scalars_std)
    return mags, negs, glv.glv_bits()


def _pad_cols(t: torch.Tensor, cols: int) -> torch.Tensor:
    if t.shape[1] == cols:
        return t
    pad = torch.zeros((t.shape[0], cols - t.shape[1]), dtype=t.dtype, device=t.device)
    return torch.cat([t, pad], dim=1)


def sharded_msm(points: torch.Tensor, scalars_std: torch.Tensor, plan: ShardingPlan,
                mode: str | None = None, c: int | None = None, base_key=None):
    """MSM of an AoS32 base [N, 24] (N >= m) against [m, 4] standard-form
    scalars over the plan's mesh -> affine (Fq, Fq) | None, the same group
    element as `ops.msm.msm_aos32`. mode defaults to SPECTRE_MSM_MODE;
    glv and glv+signed run the signed GLV halves; fixed runs
    `sharded_msm_fixed` unless its table exceeds the per-device budget."""
    mode = mode if mode is not None else MSM.msm_mode()
    if mode not in MSM.MSM_MODES:
        raise ValueError(f"unknown MSM mode {mode!r}")
    m = scalars_std.shape[0]
    if points.shape[0] < m:
        raise ValueError(f"sharded msm: {m} scalars over {points.shape[0]} points")
    expand = mode != "vanilla"
    mp = plan.pad_rows(2 * m if expand else m)
    if c is None:
        c = MSM.default_window_pallas(mp, signed=expand)
    limbs, negs, nbits = _scalar_rows(scalars_std, mode)
    if mode == "fixed" and not _degrade_fixed_mesh(mp, c, nbits, plan):
        return sharded_msm_fixed(points, m, limbs, negs, c, nbits, plan, base_key)
    grid = shard_points(points, m, plan, expand, base_key)
    limbs, negs = _pad_cols(limbs, mp), _pad_cols(negs, mp)
    nwin_p = plan.pad_windows(MSM.num_windows(c, nbits))
    nloc, b, nb = nwin_p // plan.nwin_shards, mp // plan.ndata, 1 << (c - 1)
    plan.count("sharded_msm")
    parts = [[None] * plan.nwin_shards for _ in range(plan.ndata)]
    for d in range(plan.ndata):
        for w in range(plan.nwin_shards):
            dev, sid = plan.device(d, w), d * plan.nwin_shards + w
            lim = plan.move(limbs[:, d * b:(d + 1) * b], -1, sid, dev)
            ng = plan.move(negs[:, d * b:(d + 1) * b], -1, sid, dev).contiguous()
            digits = MSM.signed_digits(lim, c, nwin_p)[w * nloc:(w + 1) * nloc].contiguous()
            sums = MK.bucket_sums_aos32(grid[d][w], digits, ng, c)
            parts[d][w] = (MK.aggregate_buckets_aos32(sums, nloc, nb), sid)
    windows = []
    for w in range(plan.nwin_shards):
        col = [parts[d][w] for d in range(plan.ndata)]
        folded = _fold([p for p, _ in col], plan, [s for _, s in col], w, plan.device(0, w))
        windows.append(plan.move(folded, w, -1, scalars_std.device))
    return MK.combine_windows(torch.cat(windows)[:MSM.num_windows(c, nbits)], c)


# ---------------------------------------------------------------------------
# fixed-base mode on the mesh
# ---------------------------------------------------------------------------

def _sharded_table_bytes(n_expanded: int, c: int, nbits: int, plan: ShardingPlan) -> int:
    """The reference's byte count of the whole mesh table [nwin_padded,
    n_expanded] (n_expanded: the expanded, row-padded point count)."""
    return plan.pad_windows(MSM.num_windows(c, nbits)) * n_expanded * _REF_POINT_BYTES


def device_table_bytes(n_expanded: int, c: int, nbits: int, plan: ShardingPlan) -> dict:
    """{device: bytes} of the shards' table slices, summed per physical
    device (the reference's byte count): each shard holds its windows over
    its rows."""
    per_shard = _sharded_table_bytes(n_expanded, c, nbits, plan) // plan.n_devices
    out: dict = {}
    for dev in plan.mesh.flat:
        out[dev] = out.get(dev, 0) + per_shard
    return out


def fixed_fits_mesh(n_expanded: int, c: int, nbits: int, plan: ShardingPlan) -> bool:
    """Whether every physical device's share of the sharded table fits the
    SPECTRE_MSM_TABLE_MB budget."""
    return max(device_table_bytes(n_expanded, c, nbits, plan).values()) <= MSM.TABLES.budget


def _degrade_fixed_mesh(n_expanded: int, c: int, nbits: int, plan: ShardingPlan) -> bool:
    """True (and counted in `msm_fixed_degraded`, with a manifest event
    and a line on stderr) when a device's share of the table busts the
    budget: the MSM then runs glv+signed on the mesh."""
    if fixed_fits_mesh(n_expanded, c, nbits, plan):
        return False
    need = max(device_table_bytes(n_expanded, c, nbits, plan).values())
    MSM.COUNTERS["msm_fixed_degraded"] += 1
    from ..observability.manifest import record_event
    record_event("msm_fixed_degraded", n=n_expanded, window=c, table_mb=need >> 20,
                 budget_mb=MSM.TABLES.budget >> 20, mesh=plan.describe()["mesh"])
    print(f"[msm] sharded fixed-base table of {n_expanded} rows at c={c} needs {need >> 20} MB "
          f"on one device, over the {MSM.TABLES.budget_var} budget "
          f"({MSM.TABLES.budget >> 20} MB): this MSM runs glv+signed on the mesh",
          file=sys.stderr, flush=True)
    return True


def sharded_fixed_table(points: torch.Tensor, m: int, c: int, nwin: int, plan: ShardingPlan,
                        base_key=None) -> list:
    """grid[d][w]: shard (d, w)'s table [nloc, rows, 24], slice i = 2^(c (w
    nloc + i)) times the expanded, padded rows of data shard d (infinity
    past nwin), normalised (Z = 1), built on the shard's device and cached
    on the plan. One doubling chain (K2) a physical device runs over the
    rows of every data shard it holds."""
    nwin_p = plan.pad_windows(nwin)
    tag = base_key if base_key is not None else ("at", points.data_ptr(), points)
    key = ("fixed", tag, str(points.device), int(m), int(c), int(nwin_p))
    hit = plan.tables.get(key)
    if hit is not None:
        return hit
    grid = shard_points(points, m, plan, True, base_key)
    nloc, b = nwin_p // plan.nwin_shards, grid[0][0].shape[0]
    tabs = [[None] * plan.nwin_shards for _ in range(plan.ndata)]
    by_dev: dict = {}
    for d in range(plan.ndata):
        for w in range(plan.nwin_shards):
            by_dev.setdefault(plan.device(d, w), []).append((d, w))
    for dev, shards in by_dev.items():
        rows_of = {d: grid[d][w] for d, w in shards}        # data shard -> its rows here
        ds = list(rows_of)
        for d, w in shards:
            tabs[d][w] = ec.inf_aos32(b, dev).repeat(nloc, 1, 1)
        cur = torch.cat([rows_of[d] for d in ds])
        top = min(nwin, max(w for _, w in shards) * nloc + nloc)
        for win in range(top):
            for d, w in shards:
                if w * nloc <= win < (w + 1) * nloc:
                    at = ds.index(d) * b
                    tabs[d][w][win - w * nloc] = cur[at:at + b]
            if win < top - 1:
                for _ in range(c):
                    cur = MK.padd_aos32(cur, cur)
        for d, w in shards:
            tabs[d][w] = ec.normalize_mont(tabs[d][w].reshape(-1, 24)).reshape(nloc, b, 24)
    if len(plan.tables) > 4:
        plan.tables.clear()
    plan.tables[key] = tabs
    return tabs


def sharded_msm_fixed(points: torch.Tensor, m: int, mags: torch.Tensor, negs: torch.Tensor,
                      c: int, nbits: int, plan: ShardingPlan, base_key=None):
    """Fixed-base MSM over the shards' window tables: GLV magnitudes [8,
    2m] and signs [1, 2m] -> affine (Fq, Fq) | None."""
    nwin = MSM.num_windows(c, nbits)
    tabs = sharded_fixed_table(points, m, c, nwin, plan, base_key)
    nwin_p = plan.pad_windows(nwin)
    nloc, nb = nwin_p // plan.nwin_shards, 1 << (c - 1)
    mp = plan.ndata * tabs[0][0].shape[1]
    mags, negs = _pad_cols(mags, mp), _pad_cols(negs, mp)
    b = mp // plan.ndata
    plan.count("sharded_msm")
    parts, srcs = [], []
    for d in range(plan.ndata):
        for w in range(plan.nwin_shards):
            dev, sid = plan.device(d, w), d * plan.nwin_shards + w
            lim = plan.move(mags[:, d * b:(d + 1) * b], -1, sid, dev)
            ng = plan.move(negs[:, d * b:(d + 1) * b], -1, sid, dev).contiguous()
            digits = MSM.signed_digits(lim, c, nwin_p)[w * nloc:(w + 1) * nloc].contiguous()
            sums = MK.bucket_sums_fixed_aos32(tabs[d][w], digits, ng, c)
            parts.append(MK.fold_windows_aos32(sums, nloc, nb))
            srcs.append(sid)
    merged = _fold(parts, plan, srcs, 0, plan.device(0, 0))
    out = MK.aggregate_buckets_aos32(merged, 1, nb)
    return ec.decode_points(plan.move(out, 0, -1, mags.device))[0]
