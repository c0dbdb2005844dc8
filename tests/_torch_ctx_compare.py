"""Exact comparison of a port builder Context with a JAX-package one, stream
by stream, without laying either out (a laid-out assignment of millions of
Python ints costs gigabytes). The reference context is first reduced to a
snapshot in the port's encoding, so that its tuple-per-copy lists can be
freed before the port's context is built."""

from types import SimpleNamespace

import numpy as np

from spectre_tpu_torch.builder.context import LKP, shw_ref


def snapshot(rctx) -> SimpleNamespace:
    """The reference context's streams in the port's encoding: copy
    endpoints as int codes (lookup tables numbered in order of first use,
    as the port numbers them), gated 4-cell blocks by start index."""
    kinds: dict[str, int] = {}

    def code(stream, i):
        if stream == "adv":
            return i << 3
        if stream == "shwc":
            return shw_ref(*i)
        return (i << 3) | kinds.setdefault(stream[1], LKP + len(kinds))

    copies = np.fromiter((code(s, i) for pair in rctx.copies for s, i in pair),
                         dtype=np.int64, count=2 * len(rctx.copies))
    units = [(s, n) for s, n, gated in rctx.adv_units if gated]
    assert all(n == 4 for _, n in units)
    return SimpleNamespace(
        adv_values=rctx.adv_values, lkp_streams=rctx.lkp_streams, lkp_kinds=kinds,
        copies=copies, constants=rctx.constants,
        const_uses=np.array(rctx.const_uses, dtype=np.int64).reshape(-1),
        gated=np.array([s for s, _ in units], dtype=np.int64),
        instances=[(av.index, av.value) for av in rctx.instance_cells],
        sha_slots=rctx.sha_slots)


def gated_blocks(ctx) -> np.ndarray:
    """Start index of every gated 4-cell block of a port context."""
    g = np.array(ctx.gated, dtype=np.int64).reshape(-1, 2)
    nblk = g[:, 1] // 4
    first = np.repeat(g[:, 0] - 4 * (np.cumsum(nblk) - nblk), nblk)
    return first + 4 * np.arange(int(nblk.sum()), dtype=np.int64)


def assert_contexts_equal(ctx, ref) -> None:
    """Advice values, lookup streams per table, copy endpoints, constants,
    constant pins, gated blocks, instance cells and wide SHA slots equal
    exactly. ref: a reference Context or its snapshot."""
    if not isinstance(ref, SimpleNamespace):
        ref = snapshot(ref)
    assert len(ctx.adv_values) == len(ref.adv_values)
    assert ctx.adv_values == ref.adv_values
    assert ctx.lkp_streams.keys() == ref.lkp_streams.keys()
    for table, stream in ref.lkp_streams.items():
        assert ctx.lkp_streams[table] == stream, table
    assert ctx._lkp_kind == ref.lkp_kinds
    assert np.array_equal(np.array(ctx.copies, dtype=np.int64), ref.copies)
    assert ctx.constants == ref.constants
    assert np.array_equal(np.array(ctx.const_uses, dtype=np.int64), ref.const_uses)
    assert np.array_equal(gated_blocks(ctx), ref.gated)
    assert [(av.index, av.value) for av in ctx.instance_cells] == ref.instances
    assert len(ctx.sha_slots) == len(ref.sha_slots)
    for slot, rslot in zip(ctx.sha_slots, ref.sha_slots):
        assert np.array_equal(slot["bits"], rslot["bits"])
        assert np.array_equal(slot["words"], rslot["words"])
