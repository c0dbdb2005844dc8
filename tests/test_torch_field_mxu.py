"""The port's 8-bit-limb Montgomery product (ops/field_mxu.py: K7's plain
version on the CPU) against the reference's `field_mxu.mont_mul` and CIOS
`_mont_mul_cios`, its helpers against the reference's, the dispatch of
`field_ops.mont_mul` (SPECTRE_FIELD_IMPL=mxu at import, `enable_mxu`), and
a seeded k=7 proof under each NTT variant with the product on, byte for
byte the reference's.

Inputs are made with numpy from a seed; the port's [n, 4] int64 Montgomery
tensors are compared with the reference's [n, 16] uint32 limbs (the same
Montgomery values, radix 2^256). Every check is exact equality.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from spectre_tpu.ops import field_mxu as RMX, field_ops as RF
from spectre_tpu_torch.ops import field_mxu as MX, field_ops as F, limbs as L

from _torch_k7_circuit import k7_port_key, seeded_blinding

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = {"fr": (F.fr_ctx, RF.fr_ctx), "fq": (F.fq_ctx, RF.fq_ctx)}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads per test process: the tier-1 run has six workers
    on one machine, and timing-sensitive tests elsewhere share its cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _as16(t: torch.Tensor) -> np.ndarray:
    return L.u64limbs_to_u16limbs(F.tensor_to_u64(t).reshape(-1, 4))


def _operands(p: int, seed: int, count: int = 61):
    """Random values below p and the reference test's edge values."""
    rng = np.random.default_rng(seed)
    draw = lambda: [v % p for v in L.limbs_to_ints(                # noqa: E731
        rng.integers(0, 2 ** 63, size=(count, 4), dtype=np.uint64))]
    xs, ys = draw(), draw()
    xs += [0, 1, p - 1, p // 2, 2]
    ys += [p - 1, 0, p - 1, 2, p // 3]
    return xs, ys


@pytest.mark.parametrize("field", FIELDS)
def test_plain_equals_the_reference_mxu_and_cios(field):
    ctx, rctx = FIELDS[field][0](), FIELDS[field][1]()
    xs, ys = _operands(ctx.p, 3 if field == "fr" else 4)
    a, b = F.from_ints(ctx, xs, "cpu"), F.from_ints(ctx, ys, "cpu")
    ra, rb = rctx.encode_np(xs), rctx.encode_np(ys)
    got = MX.mont_mul_mxu_plain(ctx, a, b)
    assert np.array_equal(_as16(got), np.asarray(RMX.mont_mul(rctx, ra, rb)))
    assert np.array_equal(_as16(got), np.asarray(RF._mont_mul_cios(rctx, ra, rb)))
    assert torch.equal(got, F.mont_mul_cios(ctx, a, b))
    assert F.to_ints(ctx, got) == [x * y % ctx.p for x, y in zip(xs, ys)]
    # mont_mul on a CPU tensor is the plain version
    assert torch.equal(MX.mont_mul(ctx, a, b), got)


@pytest.mark.parametrize("field", FIELDS)
def test_plain_reads_b_as_the_cios_product_does(field):
    """b of one row scales, b of m rows repeats over a [B, m] batch."""
    ctx = FIELDS[field][0]()
    xs, ys = _operands(ctx.p, 9, count=59)
    a = F.from_ints(ctx, xs, "cpu").reshape(2, 32, 4)
    b = F.from_ints(ctx, ys[:32], "cpu")
    for bb in (b[:1], b):
        assert torch.equal(MX.mont_mul_mxu_plain(ctx, a, bb), F.mont_mul_cios(ctx, a, bb))
    with pytest.raises(ValueError, match="do not tile"):
        MX.mont_mul(ctx, a, b[:3])


def test_helpers_equal_the_reference():
    for la, lb, cols in ((32, 32, 64), (32, 32, 32), (34, 32, 66), (3, 5, 6)):
        assert np.array_equal(MX.conv_matrix(la, lb, cols), RMX.conv_matrix(la, lb, cols))
    ctx = F.fr_ctx()
    xs, ys = _operands(ctx.p, 5, count=11)
    rctx = RF.fr_ctx()
    a = F.from_ints(ctx, xs, "cpu")
    a8 = MX._to8(a)
    assert np.array_equal(a8.numpy(), np.asarray(RMX._to8(rctx.encode_np(xs))))
    assert torch.equal(MX._from8(a8), a)
    b8 = MX._to8(F.from_ints(ctx, ys, "cpu"))
    rb8 = np.asarray(RMX._to8(rctx.encode_np(ys)))
    for cols in (64, 32):
        want = np.asarray(RMX.mul_columns(np.asarray(a8.numpy(), np.int32), rb8, cols))
        assert np.array_equal(MX.mul_columns(a8, b8, cols).numpy(), want)
        assert np.array_equal(MX._carry8(MX.mul_columns(a8, b8, cols), cols).numpy(),
                              np.asarray(RMX._carry8(want, cols)))
    mc, rmc = MX._mxu_ctx("bn254_fq"), RMX._mxu_ctx("bn254_fq")
    assert np.array_equal(mc.p8, rmc.p8) and np.array_equal(mc.pinv8, rmc.pinv8)


def test_dispatch_follows_enable_mxu(monkeypatch):
    """field_ops.mont_mul routes through field_mxu.mont_mul after
    enable_mxu(True) and back after enable_mxu(False), read per call."""
    ctx = F.fr_ctx()
    a, b = F.from_ints(ctx, [3, 5], "cpu"), F.from_ints(ctx, [7, 11], "cpu")
    routed = []
    real = MX.mont_mul
    monkeypatch.setattr(MX, "mont_mul", lambda c, x, y: routed.append(1) or real(c, x, y))
    before = F.mxu_enabled()
    try:
        F.enable_mxu(True)
        assert F.to_ints(ctx, F.mont_mul(ctx, a, b)) == [21, 55] and routed
        F.enable_mxu(False)
        routed.clear()
        assert F.to_ints(ctx, F.mont_mul(ctx, a, b)) == [21, 55] and not routed
    finally:
        F.enable_mxu(before)


def test_env_at_import_enables_the_product():
    script = ("from spectre_tpu_torch.ops import field_mxu, field_ops as F\n"
              "print(F.mxu_enabled(), field_mxu.enabled())\n")
    for value, want in (("mxu", "True True"), ("cios", "False False")):
        env = dict(os.environ, PYTHONPATH=REPO, SPECTRE_FIELD_IMPL=value)
        out = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout.split("\n")[-2] == want


@pytest.fixture(scope="module")
def k7_keyed():
    return k7_port_key()


@pytest.mark.parametrize("mode,kernel", [("radix2", "stages"), ("fourstep", "stages"),
                                         ("fourstep", "matmul")])
def test_k7_proof_bytes_with_the_mxu_product(k7_keyed, monkeypatch, mode, kernel):
    """The port's key of the reference's k=7 circuit, proved under each NTT
    variant with every Montgomery product the 8-bit-limb one: the
    reference's proof, byte for byte."""
    from spectre_tpu_torch.plonk.prover import prove

    pk, srs, asg, rproof, _ = k7_keyed
    monkeypatch.setenv("SPECTRE_NTT_MODE", mode)
    monkeypatch.setenv("SPECTRE_NTT_KERNEL", kernel)
    before = F.mxu_enabled()
    calls = []
    real = MX.mont_mul_mxu_plain
    monkeypatch.setattr(MX, "mont_mul_mxu_plain",
                        lambda c, x, y: calls.append(1) or real(c, x, y))
    try:
        F.enable_mxu(True)
        proof = prove(pk, srs, asg, device="cpu", blinding_rng=seeded_blinding())
    finally:
        F.enable_mxu(before)
    assert calls and proof == rproof
