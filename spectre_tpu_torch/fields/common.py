"""Generic prime fields, polynomial extension fields, and short-Weierstrass curves.

Pure-Python, arbitrary-precision. This is the host oracle layer the device
kernels (spectre_tpu_torch.ops) are tested against, and the
math the proof *verifier* runs on (pairings are verifier-side and cold).

Reference parity: plays the role of `halo2curves-axiom` (host-side BN254 +
BLS12-381 arithmetic; SURVEY.md §2b N1/N5) — re-designed as a generic tower
rather than a port.
"""

from __future__ import annotations

import secrets


# ---------------------------------------------------------------------------
# modular helpers
# ---------------------------------------------------------------------------

def modinv(a: int, p: int) -> int:
    """Modular inverse via Fermat (p prime)."""
    a %= p
    if a == 0:
        raise ZeroDivisionError("inverse of 0")
    return pow(a, p - 2, p)


def legendre(a: int, p: int) -> int:
    """Legendre symbol: 1 if QR, -1 if non-residue, 0 if 0."""
    a %= p
    if a == 0:
        return 0
    ls = pow(a, (p - 1) // 2, p)
    return -1 if ls == p - 1 else 1


def tonelli_shanks(a: int, p: int) -> int | None:
    """Square root mod odd prime p, or None if a is a non-residue."""
    a %= p
    if a == 0:
        return 0
    if legendre(a, p) != 1:
        return None
    if p % 4 == 3:
        return pow(a, (p + 1) // 4, p)
    # factor p-1 = q * 2^s
    q, s = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    # find a non-residue z
    z = 2
    while legendre(z, p) != -1:
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
    while t != 1:
        # find least i with t^(2^i) == 1
        i, t2i = 0, t
        while t2i != 1:
            t2i = t2i * t2i % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c = i, b * b % p
        t, r = t * c % p, r * b % p
    return r


# ---------------------------------------------------------------------------
# prime field (int-backed, class-per-modulus via factory)
# ---------------------------------------------------------------------------

class PrimeField:
    """Base prime field element. Subclasses set `p` (via make_prime_field).

    Elements of *different* prime fields never mix silently: any binary op with
    an element of another field class raises TypeError (this codebase juggles
    four prime fields — BN254 Fq/Fr and BLS12-381 Fq/Fr — and a silent
    cross-field coercion produces wrong values, not errors).
    """

    __slots__ = ("n",)
    p: int = 0
    degree = 1  # tower degree over the base prime field

    def __init__(self, n):
        if isinstance(n, PrimeField):
            if type(n) is not type(self):
                raise TypeError(f"cannot build {type(self).__name__} from {type(n).__name__}")
            self.n = n.n
        else:
            self.n = int(n) % self.p

    def _val(self, o) -> int:
        if isinstance(o, PrimeField):
            if type(o) is not type(self):
                raise TypeError(f"field mismatch: {type(self).__name__} vs {type(o).__name__}")
            return o.n
        if isinstance(o, int):
            return o
        raise TypeError(f"cannot operate on {type(self).__name__} and {type(o).__name__}")

    # -- arithmetic --
    def __add__(self, o):
        return type(self)(self.n + self._val(o))

    __radd__ = __add__

    def __sub__(self, o):
        return type(self)(self.n - self._val(o))

    def __rsub__(self, o):
        return type(self)(self._val(o) - self.n)

    def __mul__(self, o):
        return type(self)(self.n * self._val(o))

    __rmul__ = __mul__

    def __neg__(self):
        return type(self)(-self.n)

    def __truediv__(self, o):
        return type(self)(self.n * modinv(self._val(o), self.p))

    def __rtruediv__(self, o):
        return type(self)(self._val(o) * modinv(self.n, self.p))

    def __pow__(self, e: int):
        if e < 0:
            return type(self)(pow(modinv(self.n, self.p), -e, self.p))
        return type(self)(pow(self.n, e, self.p))

    def inv(self):
        return type(self)(modinv(self.n, self.p))

    def sqrt(self):
        r = tonelli_shanks(self.n, self.p)
        return None if r is None else type(self)(r)

    def is_square(self) -> bool:
        return legendre(self.n, self.p) >= 0

    def sgn0(self) -> int:
        """RFC 9380 sgn0 for m=1: parity of the integer representative."""
        return self.n & 1

    # -- comparisons / misc --
    def __eq__(self, o):
        if isinstance(o, PrimeField):
            return type(o) is type(self) and self.n == o.n
        if isinstance(o, int):
            return self.n == o % self.p
        return NotImplemented

    def __hash__(self):
        return hash((self.p, self.n))

    def __int__(self):
        return self.n

    def __repr__(self):
        return f"{type(self).__name__}(0x{self.n:x})"

    @classmethod
    def zero(cls):
        return cls(0)

    @classmethod
    def one(cls):
        return cls(1)

    @classmethod
    def random(cls):
        return cls(secrets.randbelow(cls.p))


_field_cache: dict[tuple, type] = {}


def make_prime_field(p: int, name: str) -> type[PrimeField]:
    key = (p, name)
    if key not in _field_cache:
        _field_cache[key] = type(name, (PrimeField,), {"p": p})
    return _field_cache[key]


# ---------------------------------------------------------------------------
# polynomial extension fields  F_p[x] / (modulus)
# ---------------------------------------------------------------------------

class ExtField:
    """Element of F_p[x]/(f(x)), coeffs little-endian ints mod p.

    Subclasses (via make_ext_field) set: p, modulus_coeffs (list of ints c_i such
    that x^deg = -(c_0 + c_1 x + ... + c_{deg-1} x^{deg-1})), deg.
    """

    __slots__ = ("c",)
    p: int = 0
    deg: int = 0
    modulus_coeffs: tuple = ()

    def __init__(self, coeffs):
        p = self.p
        if isinstance(coeffs, ExtField):
            self.c = coeffs.c
            return
        c = [int(x) % p for x in coeffs]
        assert len(c) == self.deg, (len(c), self.deg)
        self.c = c

    # -- helpers --
    @classmethod
    def zero(cls):
        return cls([0] * cls.deg)

    @classmethod
    def one(cls):
        return cls([1] + [0] * (cls.deg - 1))

    @classmethod
    def from_base(cls, n: int):
        return cls([int(n)] + [0] * (cls.deg - 1))

    @classmethod
    def random(cls):
        return cls([secrets.randbelow(cls.p) for _ in range(cls.deg)])

    def _coerce(self, o):
        if isinstance(o, type(self)):
            return o
        if isinstance(o, int):
            return type(self).from_base(o)
        if isinstance(o, PrimeField):
            if o.p != self.p:
                raise TypeError(f"field mismatch: {type(self).__name__} vs {type(o).__name__}")
            return type(self).from_base(o.n)
        return NotImplemented

    # -- arithmetic --
    def __add__(self, o):
        o = self._coerce(o)
        if o is NotImplemented:
            return o
        p = self.p
        return type(self)([(a + b) % p for a, b in zip(self.c, o.c)])

    __radd__ = __add__

    def __sub__(self, o):
        o = self._coerce(o)
        if o is NotImplemented:
            return o
        p = self.p
        return type(self)([(a - b) % p for a, b in zip(self.c, o.c)])

    def __rsub__(self, o):
        return self._coerce(o) - self

    def __neg__(self):
        p = self.p
        return type(self)([(-a) % p for a in self.c])

    def __mul__(self, o):
        if isinstance(o, int):
            p = self.p
            return type(self)([a * o % p for a in self.c])
        if isinstance(o, PrimeField):
            p = self.p
            return type(self)([a * o.n % p for a in self.c])
        if not isinstance(o, type(self)):
            return NotImplemented
        p, deg = self.p, self.deg
        a, b = self.c, o.c
        # schoolbook product
        prod = [0] * (2 * deg - 1)
        for i, ai in enumerate(a):
            if ai:
                for j, bj in enumerate(b):
                    prod[i + j] += ai * bj
        # reduce by modulus: x^deg = -modulus_coeffs
        mc = self.modulus_coeffs
        for k in range(2 * deg - 2, deg - 1, -1):
            top = prod[k]
            if top:
                prod[k] = 0
                for i, m in enumerate(mc):
                    if m:
                        prod[k - deg + i] -= top * m
        return type(self)([x % p for x in prod[:deg]])

    __rmul__ = __mul__

    def __pow__(self, e: int):
        if e < 0:
            return self.inv() ** (-e)
        result = type(self).one()
        base = self
        while e:
            if e & 1:
                result = result * base
            base = base * base
            e >>= 1
        return result

    def inv(self):
        """Extended Euclid on polynomials over F_p."""
        p, deg = self.p, self.deg
        lm, hm = [1] + [0] * deg, [0] * (deg + 1)
        low = list(self.c) + [0]
        high = list(self.modulus_coeffs) + [1]
        while _poly_deg(low):
            r = _poly_divmod(high, low, p)
            nm = [(hm[i] - sum(r[j] * lm[i - j] for j in range(len(r)) if 0 <= i - j < len(lm))) % p
                  for i in range(deg + 1)]
            lm, low, hm, high = nm, _poly_sub_mul(high, low, r, p), lm, low
        linv = modinv(low[0], p)
        return type(self)([x * linv % p for x in lm[:deg]])

    def __truediv__(self, o):
        o = self._coerce(o)
        if o is NotImplemented:
            return o
        return self * o.inv()

    def __rtruediv__(self, o):
        return self._coerce(o) * self.inv()

    # -- comparisons / misc --
    def __eq__(self, o):
        o = self._coerce(o)
        if o is NotImplemented:
            return False
        return self.c == o.c

    def __hash__(self):
        return hash((self.p, tuple(self.c)))

    def is_zero(self):
        return all(x == 0 for x in self.c)

    def sgn0(self) -> int:
        """RFC 9380 sgn0 for extension fields (little-endian coefficient order)."""
        sign, zero = 0, 1
        for a in self.c:
            sign_i = a & 1
            zero_i = 1 if a == 0 else 0
            sign = sign | (zero & sign_i)
            zero = zero & zero_i
        return sign

    @classmethod
    def _nonresidue_candidates(cls):
        """Deterministic stream of candidate non-residues for sqrt."""
        for k in range(1, 64):
            coeffs = [0] * cls.deg
            coeffs[0] = k
            if cls.deg > 1:
                coeffs[1] = 1
            yield cls(coeffs)

    def frobenius(self):
        """x -> x^p (generic, via pow; subclasses may override with coeff tables)."""
        return self ** self.p

    def __repr__(self):
        return f"{type(self).__name__}({self.c})"

    def sqrt(self):
        """Square root via generic Tonelli–Shanks over the extension field."""
        q = self.p ** self.deg
        if self.is_zero():
            return self
        # Euler criterion
        if self ** ((q - 1) // 2) != type(self).one():
            return None
        if q % 4 == 3:
            return self ** ((q + 1) // 4)
        # Tonelli-Shanks in the extension group
        s, t = 0, q - 1
        while t % 2 == 0:
            s, t = s + 1, t // 2
        # find a non-residue, deterministically (reproducible across processes)
        z = None
        for cand in self._nonresidue_candidates():
            if not cand.is_zero() and cand ** ((q - 1) // 2) != type(self).one():
                z = cand
                break
        assert z is not None, "no quadratic non-residue found"
        m, c = s, z ** t
        u, r = self ** t, self ** ((t + 1) // 2)
        one = type(self).one()
        while u != one:
            i, u2i = 0, u
            while u2i != one:
                u2i = u2i * u2i
                i += 1
            b = c ** (1 << (m - i - 1))
            m, c = i, b * b
            u, r = u * c, r * b
        return r


def _poly_deg(c):
    for i in range(len(c) - 1, -1, -1):
        if c[i]:
            return i
    return 0


def _poly_divmod(a, b, p):
    """Quotient of polynomial a by b over F_p (coeff lists, little-endian)."""
    da, db = _poly_deg(a), _poly_deg(b)
    if da < db:
        return [0]
    a = list(a)
    q = [0] * (da - db + 1)
    binv = modinv(b[db], p)
    for i in range(da - db, -1, -1):
        coef = a[i + db] * binv % p
        q[i] = coef
        if coef:
            for j in range(db + 1):
                a[i + j] = (a[i + j] - coef * b[j]) % p
    return q


def _poly_sub_mul(a, b, q, p):
    """a - b*q over F_p, truncated to len(a)."""
    res = list(a)
    for i, qi in enumerate(q):
        if qi:
            for j, bj in enumerate(b):
                if bj and i + j < len(res):
                    res[i + j] = (res[i + j] - qi * bj) % p
    return res


def make_ext_field(p: int, modulus_coeffs, name: str, base_degree: int = 1) -> type[ExtField]:
    key = (p, tuple(int(c) for c in modulus_coeffs), name)
    if key not in _field_cache:
        _field_cache[key] = type(
            name,
            (ExtField,),
            {
                "p": p,
                "deg": len(modulus_coeffs),
                "modulus_coeffs": tuple(int(c) % p for c in modulus_coeffs),
            },
        )
    return _field_cache[key]


# ---------------------------------------------------------------------------
# short-Weierstrass curve group, generic over the coordinate field
# ---------------------------------------------------------------------------

class CurveGroup:
    """y^2 = x^3 + a*x + b over a field class F. Points are (x, y) or None (inf).

    Affine representation with exact arithmetic — this is the oracle/verifier
    path; the throughput path is jacobian limb arithmetic on device (ops.ec).
    """

    def __init__(self, F, a, b, order: int | None = None, cofactor: int | None = None):
        self.F = F
        self.a = a if not isinstance(a, int) else self._embed(F, a)
        self.b = b if not isinstance(b, int) else self._embed(F, b)
        self.order = order
        self.cofactor = cofactor

    @staticmethod
    def _embed(F, n):
        return F.from_base(n) if hasattr(F, "from_base") else F(n)

    def is_on_curve(self, pt) -> bool:
        if pt is None:
            return True
        x, y = pt
        return y * y == x * x * x + self.a * x + self.b

    def add(self, p1, p2):
        if p1 is None:
            return p2
        if p2 is None:
            return p1
        x1, y1 = p1
        x2, y2 = p2
        if x1 == x2:
            if y1 == y2:
                if y1 == y1 - y1:  # y == 0
                    return None
                lam = (x1 * x1 * 3 + self.a) / (y1 * 2)
            else:
                return None
        else:
            lam = (y2 - y1) / (x2 - x1)
        x3 = lam * lam - x1 - x2
        y3 = lam * (x1 - x3) - y1
        return (x3, y3)

    def double(self, p):
        return self.add(p, p)

    def neg(self, p):
        if p is None:
            return None
        return (p[0], -p[1])

    def mul(self, p, k: int):
        """Scalar mul for points in the prime-order subgroup (k reduced mod order)."""
        if self.order is not None:
            k %= self.order
        return self.mul_unsafe(p, k)

    def mul_unsafe(self, p, k: int):
        """Scalar mul WITHOUT reducing k — required for subgroup/cofactor ops."""
        if k < 0:
            return self.neg(self.mul_unsafe(p, -k))
        if k == 0 or p is None:
            return None
        result = None
        addend = p
        while k:
            if k & 1:
                result = self.add(result, addend)
            addend = self.double(addend)
            k >>= 1
        return result

    def in_subgroup(self, p) -> bool:
        """Prime-order subgroup membership: order * p == O (unreduced mul)."""
        assert self.order is not None
        return self.is_on_curve(p) and self.mul_unsafe(p, self.order) is None

    def msm(self, points, scalars):
        """Naive host MSM (oracle only — the real MSM is ops.msm)."""
        acc = None
        for p, s in zip(points, scalars):
            acc = self.add(acc, self.mul(p, int(s)))
        return acc

    def random_point(self, generator):
        k = secrets.randbelow(self.order or (1 << 128))
        return self.mul(generator, k)
