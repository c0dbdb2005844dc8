"""Batched MSM with the batch axis sharded over the plan's devices (the port
of `spectre_tpu/parallel/batch_msm.py`).

One commitment base, B scalar vectors (the columns of a proof, or of
several): each shard of the flat batch mesh runs whole single-device MSMs
(K1, K2b) for its slice of the batch. No exchange beyond the window sums;
the base is placed once per physical device, not once per shard, and the
vectors need no padding to the device count. Complements `sharded_msm`,
which splits one large MSM.
"""

from __future__ import annotations

import torch

from ..ops import msm as MSM, msm_kernels as MK
from .plan import ShardingPlan, current_plan


def replicated_base(points: torch.Tensor, m: int, plan: ShardingPlan, base_key=None) -> dict:
    """{device: the first m rows of the AoS32 base on it}, one copy per
    physical device, cached on the plan."""
    tag = base_key if base_key is not None else ("at", points.data_ptr(), points)
    key = ("replicated", tag, str(points.device), int(m))
    return plan.placed_base(key, lambda: {
        dev: plan.move(points[:m], -1, -1, dev) for dev in plan.physical_devices})


def batch_msm_dp(points: torch.Tensor, scalars_list: list, plan: ShardingPlan | None = None,
                 mode: str | None = None, c: int | None = None, base_key=None) -> list:
    """One MSM per scalar vector against one AoS32 base [N, 24]: vectors
    [m_i, 4] standard form, m_i <= N; their affine results in order. Shard
    i of the flat mesh takes vectors [i B / D, (i + 1) B / D). mode defaults
    to SPECTRE_MSM_MODE; fixed runs glv+signed here, as the reference's
    batched path does (a per-window table on every device would multiply
    its memory by the device count)."""
    plan = plan or current_plan()
    mode = mode if mode is not None else MSM.msm_mode()
    if mode not in MSM.MSM_MODES:
        raise ValueError(f"unknown MSM mode {mode!r}")
    if not scalars_list:
        return []
    mmax = max(s.shape[0] for s in scalars_list)
    if mmax > points.shape[0]:
        raise ValueError(f"batch msm: {mmax} scalars over {points.shape[0]} points")
    bases = replicated_base(points, mmax, plan, base_key)
    devs = plan.batch_devices
    b, d = len(scalars_list), len(devs)
    plan.count("batch_msm")
    pending = []
    for i, dev in enumerate(devs):
        for j in range(i * b // d, (i + 1) * b // d):
            s = plan.move(scalars_list[j], -1, i, dev)
            pts = bases[dev][:s.shape[0]]
            if mode == "vanilla":
                pending.append((MSM.vanilla_windows(pts, s, c), i))
            else:
                cj = c or MSM.default_window_pallas(2 * s.shape[0], signed=True)
                pending.append((MSM.glv_windows(pts, s, cj, base_key), i))
    return [MK.combine_windows(plan.move(sums, i, -1, points.device), cj)
            for (sums, cj), i in pending]

