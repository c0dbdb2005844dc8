"""BLS12-381 Fq and batched G1 decompression (`spectre_tpu_torch/ops/field384.py`,
K6 in `csrc/field384_kernels.cu`) on the CPU, against the JAX package's
`spectre_tpu/ops/field384.py` and the host's `bls12_381.g1_decompress`.

The two packages lay the same Montgomery values out in different limbs (the
reference 24 x 16 bits, the port 6 x 64), so the plain versions are compared
value for value, exactly. K6's body (`csrc/field384.cuh`: a key spread over
a group of 8 lanes) is built for the host with g++, its lanes looped over,
and must equal the plain version limb for limb; the launch itself runs only
on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import ctypes
import re
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectre_tpu.fields import bls12_381 as rbls
from spectre_tpu.ops import field384 as RF
from spectre_tpu_torch.fields import bls12_381 as bls
from spectre_tpu_torch.ops import field384 as F, kernel_lib as KL, limbs as L


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads per test process: the tier-1 run has six workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


CTX = F.bls_fq_ctx()
P = CTX.p
R = 1 << 384
RINV = pow(R, -1, P)


def _values(seed: int, n: int) -> list[int]:
    """Edge values, then seeded random ones below p (numpy words)."""
    words = np.random.default_rng(seed).integers(0, 1 << 32, size=(n, 12), dtype=np.uint64)
    rnd = [sum(int(w) << (32 * i) for i, w in enumerate(row)) % P for row in words]
    return [0, 1, P - 1, CTX.r_mod_p, P - CTX.r_mod_p] + rnd


def _port(vals) -> torch.Tensor:
    return F.tensor_from_u64(L.ints_to_limbs(vals, F.NWORDS), "cpu")


def _port_ints(t) -> list[int]:
    return L.limbs_to_ints(F.tensor_to_u64(t))


def _ref(vals):
    return jnp.asarray(RF._ints_to_limbs(vals))


def _ref_ints(a) -> list[int]:
    return RF._limbs_to_ints(np.asarray(a))


def test_contexts_agree():
    rctx = RF.bls_fq_ctx()
    assert (CTX.p, CTX.n0inv16, CTX.r_mod_p) == (rctx.p, int(rctx.n0inv16), rctx.r_mod_p)
    assert CTX.decode(CTX.encode([5, P - 1])) == rctx.decode(rctx.encode_np([5, P - 1]))


def test_mont_mul_and_add_equal_the_reference():
    va, vb = _values(1, 59), list(reversed(_values(2, 59)))
    rctx = RF.bls_fq_ctx()
    got = _port_ints(F.mont_mul(CTX, _port(va), _port(vb)))
    assert got == _ref_ints(RF.mont_mul(rctx, _ref(va), _ref(vb)))
    assert got == [a * b * RINV % P for a, b in zip(va, vb)]
    got = _port_ints(F.add(CTX, _port(va), _port(vb)))
    assert got == _ref_ints(RF.add(rctx, _ref(va), _ref(vb)))
    assert got == [(a + b) % P for a, b in zip(va, vb)]
    # broadcasting one operand, as the reference does
    got = _port_ints(F.mont_mul(CTX, _port(va), _port(vb[:1])))
    assert got == [a * vb[0] * RINV % P for a in va]


@pytest.mark.parametrize("e", [1, 2, 3, 0xB5, (P + 1) // 4])
def test_mont_pow_equals_the_reference(e):
    va = _values(3, 11)
    rctx = RF.bls_fq_ctx()
    got = _port_ints(F.mont_pow(CTX, _port(va), e))
    assert got == _ref_ints(RF.mont_pow(rctx, _ref(va), e))
    assert got == [pow(a * RINV % P, e, P) * R % P for a in va]


def _keys() -> list[bytes]:
    """Eight keys: three points and their negations (both sign bits for one
    x), and x = 0, which is on the curve (y = +-2), with either sign."""
    r = np.random.default_rng(7)
    pts = [bls.g1_curve.mul(bls.G1_GEN, int(k)) for k in r.integers(1, 1 << 62, size=3)]
    keys = []
    for pt in pts:
        keys += [bls.g1_compress(pt), bls.g1_compress(bls.g1_curve.neg(pt))]
    zero = bytearray(48)
    zero[0] = 0x80
    keys.append(bytes(zero))
    zero[0] = 0xA0
    keys.append(bytes(zero))
    return keys


def test_batch_equals_the_reference_and_the_host():
    keys = _keys()
    got = F.g1_decompress_batch(keys, device="cpu")
    assert got == RF.g1_decompress_batch(keys)
    assert got == [(int(x), int(y)) for x, y in map(bls.g1_decompress, keys)]
    assert got == [(int(x), int(y)) for x, y in map(rbls.g1_decompress, keys)]
    assert {k[0] & 0x20 for k in keys} == {0, 0x20}
    assert got[6] == (0, 2) or got[6] == (0, P - 2)
    assert got[6][1] == P - got[7][1]
    assert F.g1_decompress_batch([], device="cpu") == []


def _malformed() -> dict:
    good = bls.g1_compress(bls.G1_GEN)
    x_p = bytearray(P.to_bytes(48, "big"))
    x_p[0] |= 0x80
    off = bytearray((1).to_bytes(48, "big"))      # 1 + 4 = 5 is no square mod p
    off[0] |= 0x80
    return {
        "uncompressed flag": bytes([good[0] & 0x7F]) + good[1:],
        "infinity": bytes([0xC0]) + b"\x00" * 47,
        "short": good[:47],
        "x not canonical": bytes(x_p),
        "x off the curve": bytes(off),
    }


@pytest.mark.parametrize("what", list(_malformed()))
def test_malformed_keys_raise_where_the_reference_does(what):
    bad = _malformed()[what]
    keys = [bls.g1_compress(bls.G1_GEN), bad]
    with pytest.raises(AssertionError):
        RF.g1_decompress_batch(keys)
    with pytest.raises(ValueError):
        F.g1_decompress_batch(keys, device="cpu")
    if what != "infinity":      # the host decodes the point at infinity
        with pytest.raises(ValueError):
            bls.g1_decompress(bad)


def test_plain_flags_an_x_off_the_curve():
    xm = CTX.to_tensor([1, 0, 5], "cpu")
    y, ok = F.decompress_y_plain(xm)
    assert ok.tolist() == [0, 1, 0 if bls.Fq(5 ** 3 + 4).sqrt() is None else 1]
    assert CTX.to_ints(y)[1] in (2, P - 2)


def test_decompress_y_takes_the_plain_version_on_the_cpu():
    """On a CPU tensor the wrapper runs the plain version and counts no
    launch of K6."""
    before = KL.KERNELS["K6_g1_decompress"].launches
    xm = CTX.to_tensor([0, 3], "cpu")
    y, ok = F.decompress_y(xm)
    y2, ok2 = F.decompress_y_plain(xm)
    assert torch.equal(y, y2) and torch.equal(ok, ok2)
    assert KL.KERNELS["K6_g1_decompress"].launches == before


HARNESS = r"""
#include "field384.cuh"
using namespace spt384;
using G = Group<HostLanes>;
static const G g;
// one value: its six digits over lanes 0 .. kLanes - 1 of a group, the
// lanes above zero
static G::U64 load(const uint64_t* w) {
  G::U64 r;
  for (int j = 0; j < kLanes; ++j) r[j] = w[j];
  return r;
}
// stores lanes 0 .. kLanes - 1; returns how many lanes above are not zero
static int store(uint64_t* w, const G::U64& v) {
  int dirty = 0;
  for (int j = 0; j < kLanes; ++j) w[j] = v[j];
  for (int j = kLanes; j < kGroup; ++j) dirty += v[j] != 0;
  return dirty;
}
extern "C" {
int h_mont_mul(const uint64_t* a, const uint64_t* b, uint64_t* out, long n) {
  int dirty = 0;
  for (long i = 0; i < n; ++i)
    dirty += store(out + 6 * i, g.canonical(g.mul(load(a + 6 * i), load(b + 6 * i))));
  return dirty;
}
int h_mont_sqr(const uint64_t* a, const uint64_t* b, uint64_t* out, long n) {
  int dirty = 0;
  for (long i = 0; i < n; ++i)
    dirty += store(out + 6 * i, g.canonical(g.sqr(load(a + 6 * i))));
  return dirty;
}
int h_add(const uint64_t* a, const uint64_t* b, uint64_t* out, long n) {
  int dirty = 0;
  for (long i = 0; i < n; ++i)
    dirty += store(out + 6 * i, g.add(load(a + 6 * i), load(b + 6 * i)));
  return dirty;
}
// K6's lane groups one after another
int h_decompress(const uint64_t* x, uint64_t* y, int32_t* ok, long n) {
  int dirty = 0;
  for (long i = 0; i < n; ++i) {
    G::U64 yd;
    ok[i] = g.decompress(load(x + 6 * i), yd);
    dirty += store(y + 6 * i, yd);
  }
  return dirty;
}
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build the header for the host")
    d = tmp_path_factory.mktemp("field384_host")
    src = d / "harness.cc"
    src.write_text(HARNESS)
    so = d / "harness.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-I", KL.CSRC,
                    "-o", str(so), str(src)], check=True, timeout=300)
    h = ctypes.CDLL(str(so))
    vp, lg = ctypes.c_void_p, ctypes.c_long
    for fn in (h.h_mont_mul, h.h_mont_sqr, h.h_add, h.h_decompress):
        fn.argtypes = [vp, vp, vp, lg]
        fn.restype = ctypes.c_int
    return h


HEADER = f"{KL.CSRC}/field384.cuh"


def _header_chain() -> tuple[int, int, list[tuple[int, int]]]:
    """(window table size, first power, [(squarings, digit)]) of the
    square-root chain baked into the header."""
    text = open(HEADER).read()
    table = int(re.search(r"kTable = (\d+);", text).group(1))
    first = int(re.search(r"kSqrtFirst = (\d+);", text).group(1))
    body = text[text.index("kSqrtChain[kSqrtSteps] = {"):]
    body = body[:body.index("}};") + 2]
    steps = [(int(a), int(b)) for a, b in re.findall(r"\{(\d+), (\d+)\}", body)]
    assert int(re.search(r"kSqrtSteps = (\d+);", text).group(1)) == len(steps)
    return table, first, steps


def test_header_constants_are_derived():
    text = open(HEADER).read()

    def words(name):      # the hex words of the array `name`
        body = text[text.index(f"{name}[kLanes] = {{"):]
        return [int(x, 16) for x in re.findall(r"(0x[0-9a-f]+)ull", body[:body.index("}")])]

    value = lambda ws: sum(w << (64 * i) for i, w in enumerate(ws))  # noqa: E731
    assert value(words("kP")) == P
    assert value(words("kFour")) == 4 * R % P
    np0 = int(re.search(r"kNp0 = (0x[0-9a-f]+)ull", text).group(1), 16)
    assert np0 == (-pow(P, -1, 1 << 64)) % (1 << 64)


def test_header_window_chain_computes_the_square_root_exponent():
    """The chain baked into the header raises x to (p + 1) / 4 mod p, with
    the squarings and multiplies that chip_smoke.window_chain counts for
    K6's bound: the table of odd powers (one squaring, a multiply an
    entry), then each step's squarings and multiply."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    table, first, steps = _header_chain()
    x = 0x1234567 * 0xFEDCBA98765 % P
    x2 = x * x % P
    powers = [x]
    for _ in range(table - 1):
        powers.append(powers[-1] * x2 % P)
    sq, mul = 1, table - 1
    acc = powers[first >> 1]
    for squarings, digit in steps:
        for _ in range(squarings):
            acc, sq = acc * acc % P, sq + 1
        if digit:
            assert digit & 1 and digit < 2 * table
            acc, mul = acc * powers[digit >> 1] % P, mul + 1
    assert acc == pow(x, CTX.sqrt_exp, P)
    squarings, multiplies, window = chip_smoke.window_chain(CTX.sqrt_exp)
    assert (sq, mul) == (squarings, multiplies) == (376, 81)
    assert 2 * table == 1 << window
    assert first & 1 and max(d for _, d in steps) < 2 * table


def test_header_product_and_add_equal_the_plain_version(lib):
    """The lane group's product, squaring and sum (lanes looped over on
    the host) equal the plain version limb for limb; lanes 6 and 7 stay 0."""
    va, vb = _values(4, 95), list(reversed(_values(5, 95)))
    a, b = _port(va), _port(vb)
    for fn, plain in ((lib.h_mont_mul, F.mont_mul), (lib.h_add, F.add),
                      (lib.h_mont_sqr, lambda ctx, a, b: F.mont_mul(ctx, a, a))):
        out = torch.empty_like(a)
        assert fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0]) == 0
        assert torch.equal(out, plain(CTX, a, b))


def test_header_carries_run_through_digits_of_ones(lib):
    """The one-bit carries that chain() resolves across lanes: a product
    by the Montgomery one whose result has zero digits above a small one
    (a lane's lazy carry makes the digit below overflow and the zero digit
    pass it on as all ones), and sums that carry through all-ones digits."""
    r = np.random.default_rng(9)
    vals = []
    for zeros in ((1, 2), (1, 2, 3, 4), (2, 3), (1,)):
        for _ in range(8):
            w = [int(x) for x in r.integers(0, 1 << 63, size=6)]
            for z in zeros:
                w[z] = 0
            vals.append(sum(x << (64 * i) for i, x in enumerate(w)) % P)
    a = _port(vals)
    one = _port([CTX.r_mod_p] * len(vals))
    out = torch.empty_like(a)
    assert lib.h_mont_mul(a.data_ptr(), one.data_ptr(), out.data_ptr(), len(vals)) == 0
    assert _port_ints(out) == vals
    assert torch.equal(out, F.mont_mul(CTX, a, one))
    ones = [(1 << 128) - 1, (1 << 320) - 1, P - 1, (1 << 64) - 1]
    a, b = _port(ones), _port([1, 1, 1, (1 << 64) + 1])
    assert lib.h_add(a.data_ptr(), b.data_ptr(), out.data_ptr(), len(ones)) == 0
    assert _port_ints(out[:len(ones)]) == [1 << 128, 1 << 320, 0, 1 << 65]


def test_header_decompression_equals_the_plain_version(lib):
    """K6's lane-group body on the eight keys' x (seeded points of both
    signs, x = 0 of both), two x off the curve (1 and p - 1) and seeded
    random x: y and the flag limb for limb as the plain version."""
    xs = [int.from_bytes(bytes([k[0] & 0x1F]) + k[1:], "big") for k in _keys()]
    xs += [1, P - 1] + _values(6, 14)[5:]
    xm = CTX.to_tensor(xs, "cpu")
    y = torch.empty_like(xm)
    ok = torch.empty(len(xs), dtype=torch.int32)
    assert lib.h_decompress(xm.data_ptr(), y.data_ptr(), ok.data_ptr(), len(xs)) == 0
    y_plain, ok_plain = F.decompress_y_plain(xm)
    assert torch.equal(y, y_plain) and torch.equal(ok, ok_plain)
    assert ok[:8].tolist() == [1] * 8 and ok[8] == 0


@pytest.mark.parametrize("e", [CTX.sqrt_exp, 1, 2, 0b1011, (1 << 64) - 1, 0xA5 << 40])
def test_k6_bound_chain_counts_a_chain_that_computes_the_power(e):
    """chip_smoke's K6 bound counts the squarings and multiplies of a
    sliding-window chain for x^e: running that chain gives x^e mod p with
    exactly those counts, and for (p + 1) / 4 it is shorter than the
    binary ladder (378 squarings, 228 multiplies)."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    squarings, multiplies, w = chip_smoke.window_chain(e)
    bits, i, digits = bin(e)[2:], 0, []
    while i < len(bits):
        j = i + 1 if bits[i] == "0" else min(i + w, len(bits))
        while bits[j - 1] == "0" and j - 1 > i:
            j -= 1
        digits.append((int(bits[i:j], 2), j - i))
        i = j
    x = 0x1234567 * 0xFEDCBA98765 % P
    table, sq, mul = {1: x}, 0, 0
    top = max(d for d, _ in digits)
    if top > 1:
        x2, sq = x * x % P, sq + 1
        for d in range(3, top + 1, 2):
            table[d], mul = table[d - 2] * x2 % P, mul + 1
    acc = table[digits[0][0]]
    for d, n in digits[1:]:
        for _ in range(n):
            acc, sq = acc * acc % P, sq + 1
        if d:
            acc, mul = acc * table[d] % P, mul + 1
    assert acc == pow(x, e, P)
    assert (sq, mul) == (squarings, multiplies)
    if e == CTX.sqrt_exp:
        assert sq + mul < (e.bit_length() - 1) + bin(e).count("1") - 1
