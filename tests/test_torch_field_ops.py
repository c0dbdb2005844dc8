"""spectre_tpu_torch.ops.field_ops against the JAX reference
spectre_tpu.ops.field_ops, on the CPU (the plain version of K3).

The same numpy-seeded values, plus 0, 1, p-1 and R mod p, go through both
packages; every comparison is exact (tolerance zero: integer arithmetic).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from spectre_tpu.ops import field_ops as RF
from spectre_tpu_torch.ops import field_ops as F
from spectre_tpu_torch.ops import limbs as L


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads per test process: the tier-1 run has six workers
    on one machine, and timing-sensitive tests elsewhere share its cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _values(p: int, seed: int, n: int = 61) -> list[int]:
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2 ** 63, size=(n, 4), dtype=np.uint64)
    rnd = [int.from_bytes(w.astype("<u8").tobytes(), "little") % p for w in words]
    return [0, 1, p - 1, (1 << 256) % p] + rnd


CTXS = [("fr", F.fr_ctx, RF.fr_ctx), ("fq", F.fq_ctx, RF.fq_ctx)]


@pytest.fixture(params=CTXS, ids=[c[0] for c in CTXS])
def ctxs(request):
    _, port, ref = request.param
    return port(), ref()


def _ref_arr(ref, vals):
    return jnp.asarray(ref.encode(vals))


def _ref_ints(ref, arr):
    return ref.decode(np.asarray(arr))


class TestAgainstReference:
    def test_constants(self, ctxs):
        port, ref = ctxs
        assert port.p == ref.p
        assert port.n0inv16 == int(ref.n0inv16)
        assert np.array_equal(port.one_mont, ref.one_mont)
        # the 32-bit constant of the CUDA kernels is derived, not the 16-bit one
        assert (port.n0inv32 * port.p) % (1 << 32) == (1 << 32) - 1

    def test_montgomery_form_is_the_reference_form(self, ctxs):
        port, ref = ctxs
        vals = _values(port.p, 1)
        got = F.tensor_to_u64(F.from_ints(port, vals, "cpu"))
        want = L.u16limbs_to_u64limbs(np.asarray(ref.encode(vals)))
        assert np.array_equal(got, want)

    @pytest.mark.parametrize("op", ["mul", "add", "sub"])
    def test_binary_ops(self, ctxs, op):
        port, ref = ctxs
        va, vb = _values(port.p, 2), _values(port.p, 3)[::-1]
        a, b = F.from_ints(port, va, "cpu"), F.from_ints(port, vb, "cpu")
        ra, rb = _ref_arr(ref, va), _ref_arr(ref, vb)
        port_fn = {"mul": F.mont_mul, "add": F.add, "sub": F.sub}[op]
        ref_fn = {"mul": RF.mont_mul, "add": RF.add, "sub": RF.sub}[op]
        got = F.to_ints(port, port_fn(port, a, b))
        want = _ref_ints(ref, jax.jit(lambda x, y: ref_fn(ref, x, y))(ra, rb))
        assert got == want

    def test_neg(self, ctxs):
        port, ref = ctxs
        va = _values(port.p, 4)
        got = F.to_ints(port, F.neg(port, F.from_ints(port, va, "cpu")))
        want = _ref_ints(ref, RF.neg(ref, _ref_arr(ref, va)))
        assert got == want

    def test_to_from_mont(self, ctxs):
        port, ref = ctxs
        va = _values(port.p, 5)
        std = torch.from_numpy(L.ints_to_limbs(va).view(np.int64))
        got = F.tensor_to_u64(F.to_mont(port, std))
        want = RF.to_mont(ref, jnp.asarray(L.ints_to_limbs16(va)))
        assert np.array_equal(got, L.u16limbs_to_u64limbs(np.asarray(want)))
        back = F.tensor_to_u64(F.from_mont(port, F.to_mont(port, std)))
        assert L.limbs_to_ints(back) == va

    def test_inv_batch_matches_fermat(self, ctxs):
        port, ref = ctxs
        va = _values(port.p, 6, n=29)
        got = F.to_ints(port, F.inv(port, F.from_ints(port, va, "cpu")))
        want = _ref_ints(ref, jax.jit(lambda x: RF.inv(ref, x))(_ref_arr(ref, va)))
        assert got == want                                    # inv(0) = 0 in both

    def test_mont_pow(self, ctxs):
        port, ref = ctxs
        va = _values(port.p, 7, n=5)
        got = F.to_ints(port, F.mont_pow(port, F.from_ints(port, va, "cpu"), 1234567))
        want = _ref_ints(ref, RF.mont_pow(ref, _ref_arr(ref, va), 1234567))
        assert got == want


class TestHostMath:
    def test_prefix_prod_and_powers(self):
        ctx = F.fr_ctx()
        va = _values(ctx.p, 8, n=40)
        got = F.to_ints(ctx, F.prefix_prod(ctx, F.from_ints(ctx, va, "cpu")))
        acc, want = 1, []
        for v in va:
            acc = acc * v % ctx.p
            want.append(acc)
        assert got == want
        assert F.to_ints(ctx, F.powers(ctx, 5, 37, "cpu")) == \
            [pow(5, i, ctx.p) for i in range(37)]

    def test_field_sum(self):
        ctx = F.fr_ctx()
        va = _values(ctx.p, 9, n=100)
        assert F.field_sum(ctx, F.from_ints(ctx, va, "cpu")) == [sum(va) % ctx.p]

    def test_broadcast_operand(self):
        ctx = F.fq_ctx()
        va = _values(ctx.p, 10, n=12)
        a = F.from_ints(ctx, va, "cpu")
        got = F.to_ints(ctx, F.mont_mul(ctx, a, F.const(ctx, 3, "cpu")))
        assert got == [3 * v % ctx.p for v in va]
        with pytest.raises(ValueError):
            F.mont_mul(ctx, a, F.from_ints(ctx, [1] * 5, "cpu"))
