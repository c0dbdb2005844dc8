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


# -- the 16-bit limb references against their limb-by-limb form --------------
#
# The plain versions that the kernels are held against (cond_sub16, add16,
# sub16, mont_mul16) run whole-tensor carry passes. The functions below are
# their limb-by-limb form: one borrow or carry a limb, as the CIOS product
# of the reference's `_mont_mul_cios` spells it out. Both must agree limb
# for limb on every input inside the contract (a < 2p for the conditional
# subtract, operands < p elsewhere), edge values, long carry chains and
# broadcast operands included.

def _carry16_limbwise(t):
    out, c = [], torch.zeros_like(t[0])
    for i in range(t.shape[0]):
        cur = t[i] + c
        out.append(cur & F.MASK16)
        c = cur >> 16
    return torch.stack(out), c


def _cond_sub16_limbwise(ctx, a):
    diff, borrow = [], torch.zeros_like(a[0])
    for i in range(F.NLIMBS):
        cur = a[i] - int(ctx.p_limbs[i]) - borrow
        diff.append(cur & F.MASK16)
        borrow = (cur < 0).to(torch.int64)
    return torch.where(borrow.bool(), a, torch.stack(diff))


def _add16_limbwise(ctx, a, b):
    return _cond_sub16_limbwise(ctx, _carry16_limbwise(a + b)[0])


def _sub16_limbwise(ctx, a, b):
    pb, borrow = [], torch.zeros_like(b[0])
    for i in range(F.NLIMBS):
        cur = int(ctx.p_limbs[i]) - b[i] - borrow
        pb.append(cur & F.MASK16)
        borrow = (cur < 0).to(torch.int64)
    return _add16_limbwise(ctx, a, torch.stack(pb))


def _mont_mul16_limbwise(ctx, a, b):
    p_col = torch.tensor([int(v) for v in ctx.p_limbs], dtype=torch.int64)
    p_col = p_col.reshape((F.NLIMBS,) + (1,) * (a.dim() - 1))
    t = torch.zeros((2 * F.NLIMBS + 1,) + tuple(a.shape[1:]), dtype=torch.int64)
    for i in range(F.NLIMBS):
        prod = a * b[i]
        t[i:i + F.NLIMBS] += prod & F.MASK16
        t[i + 1:i + F.NLIMBS + 1] += prod >> 16
        m = (t[i] * ctx.n0inv16) & F.MASK16
        q = p_col * m
        t[i:i + F.NLIMBS] += q & F.MASK16
        t[i + 1:i + F.NLIMBS + 1] += q >> 16
        t[i + 1] += t[i] >> 16
    return _cond_sub16_limbwise(ctx, _carry16_limbwise(t[F.NLIMBS:2 * F.NLIMBS])[0])


def _limbs16(vals) -> torch.Tensor:
    """[16, len(vals)] int64 16-bit limbs of integers < 2^256."""
    return torch.tensor([[(v >> (16 * i)) & 0xFFFF for v in vals] for i in range(F.NLIMBS)],
                        dtype=torch.int64)


def _edge_values(p: int) -> list:
    """Values < p that stress the carries: 0, 1, p - 1, p - 2^16, runs of
    0xFFFF limbs, lone high limbs."""
    cands = [0, 1, 2, p - 1, p - 2, p - (1 << 16), p >> 1, (1 << 16) - 1, 1 << 16]
    cands += [(1 << (16 * k)) - 1 for k in range(1, 16)]
    cands += [1 << (16 * k + 15) for k in range(15)]
    cands += [p - (1 << (16 * k)) for k in range(1, 15)]
    return [v for v in cands if 0 <= v < p]


@pytest.mark.parametrize("op", ["cond_sub16", "add16", "sub16", "mont_mul16"])
@pytest.mark.parametrize("field", ["fr", "fq"])
def test_limb_references_equal_limbwise_form(field, op):
    ctx = F.fr_ctx() if field == "fr" else F.fq_ctx()
    p = ctx.p
    edge = _edge_values(p)
    rnd = _values(p, 11, n=200)[4:]
    if op == "cond_sub16":
        # a < 2p: reduced and unreduced values, p itself and 2p - 1
        unreduced = [v + p for v in edge + rnd] + [p, 2 * p - 1]
        a = _limbs16(edge + rnd + [v for v in unreduced if v < 1 << 256])
        got, want = F.cond_sub16(ctx, a), _cond_sub16_limbwise(ctx, a)
        assert torch.equal(got, want)
        assert torch.equal(got, _limbs16([v % p for v in
                                          edge + rnd + [v for v in unreduced if v < 1 << 256]]))
        return
    # every pair of edge values, then seeded pairs
    xs = [x for x in edge for _ in edge] + rnd
    ys = [y for _ in edge for y in edge] + rnd[::-1]
    a, b = _limbs16(xs), _limbs16(ys)
    fn, ref = {"add16": (F.add16, _add16_limbwise), "sub16": (F.sub16, _sub16_limbwise),
               "mont_mul16": (F.mont_mul16, _mont_mul16_limbwise)}[op]
    assert torch.equal(fn(ctx, a, b), ref(ctx, a, b))
    # broadcast: a [16, 3, m] against b [16, 1, m]
    m = 17
    a3 = a[:, :3 * m].reshape(F.NLIMBS, 3, m)
    b1 = b[:, -m:].reshape(F.NLIMBS, 1, m)
    assert torch.equal(fn(ctx, a3, b1), ref(ctx, a3, b1))
